"""The readers of the program's own spans and counter on synthetic spans
and profiler events: host time of ``engine.assemble``, the copy's rate
from ``h2d_bytes``, the host time of ``executor.call``, and the device
time of the kernels launched inside ``executor.roll``; and their entries
in ``BENCHMARK.json``, found by name."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench_port.harness import cell, profile
from bench_port.tests.test_bench_port_readers import Ev

HERE = Path(__file__).resolve().parents[1]
READERS = HERE / "layer_metrics"


def _trace():
    """A 1000 ns window: a copy of 200 ns, a stencil kernel launched in
    ``executor.call`` before the roll, two roll kernels (overlapping)
    launched inside ``executor.roll``, and a cat kernel launched after
    it that the roll must not count."""
    return profile.from_events([
        Ev("bench.window", 0, 1000, mark=True),
        Ev("engine.assemble", 100, 320, mark=True),
        Ev("executor.call", 400, 700, mark=True),
        Ev("executor.roll", 500, 600, mark=True),
        Ev("cudaMemcpyAsync", 110, 115, corr=1),
        Ev("Memcpy HtoD (Pageable -> Device)", 120, 320, dev="cuda",
           corr=1),
        Ev("cudaLaunchKernel", 410, 412, corr=2),
        Ev("stencil_pipeline_kernel", 420, 520, dev="cuda", corr=2),
        Ev("cudaLaunchKernel", 510, 512, corr=3),
        Ev("CatArrayBatchedCopy", 530, 560, dev="cuda", corr=3),
        Ev("cudaLaunchKernel", 520, 522, corr=4),
        Ev("CatArrayBatchedCopy", 550, 570, dev="cuda", corr=4),
        Ev("cudaMemcpyAsync", 540, 541, corr=5),
        Ev("Memcpy DtoD (Device -> Device)", 575, 580, dev="cuda", corr=5),
        Ev("cudaLaunchKernel", 650, 652, corr=6),
        Ev("CatArrayBatchedCopy", 660, 690, dev="cuda", corr=6),
    ])


def _span(name, ts, dur, depth, **attrs):
    return SimpleNamespace(name=name, ts_ns=ts, dur_ns=dur, tid=1,
                           depth=depth, attrs=attrs)


SPANS = [
    _span("engine.step", 0, 800, 0, delivered=2),
    _span("engine.assemble", 100, 220, 1, h2d_bytes=600),
    _span("engine.execute", 390, 400, 1),
    _span("executor.call", 400, 300, 2),
    _span("executor.roll", 500, 100, 3),
    _span("engine.step", 900, 60, 0, delivered=1),
    _span("engine.assemble", 905, 30, 1, h2d_bytes=200),
    _span("engine.execute", 940, 15, 1),
    _span("executor.call", 941, 100, 2),
]


def _ctx(spans=SPANS, trace=None):
    return cell.Context(spans=spans, trace=trace, capacity=4,
                        frame_bytes=1000, peak_bytes_per_s=1e12, smem={})


def _read(name, ctx):
    return cell.load_module(READERS / f"{name}.py").read(ctx)


def test_assemble_time_a_served_frame():
    # (220 + 30) ns over 3 frames, in ms
    assert _read("assemble_ms_per_frame", _ctx()) == \
        pytest.approx(250e-6 / 3)


def test_the_copy_rate_is_the_bytes_handed_over_its_device_time():
    # 800 bytes in 200 ns of Memcpy HtoD: 4 GB/s
    assert _read("h2d_gbps", _ctx(trace=_trace())) == pytest.approx(4.0)


def test_launch_is_the_mean_executor_call():
    assert _read("launch_ms", _ctx()) == pytest.approx(200e-6)


def test_roll_counts_only_kernels_launched_inside_the_roll():
    tr = _trace()
    names = [k[0] for k in profile.kernels_launched_in(tr, "executor.roll")]
    assert names == ["CatArrayBatchedCopy"] * 2
    # the union 530-570 of the two roll kernels, over 3 frames, in ms
    assert _read("roll_ms_per_frame", _ctx(trace=tr)) == \
        pytest.approx(40e-6 / 3)


@pytest.mark.parametrize("name", ["assemble_ms_per_frame", "h2d_gbps",
                                  "launch_ms", "roll_ms_per_frame"])
def test_readers_with_no_spans_return_nothing(name):
    assert _read(name, _ctx(spans=[], trace=_trace())) is None


@pytest.mark.parametrize("name", ["h2d_gbps", "roll_ms_per_frame"])
def test_readers_with_no_trace_return_nothing(name):
    assert _read(name, _ctx()) is None


def test_spans_without_their_counter_or_kernels_return_nothing():
    # a program whose spans carry no h2d_bytes (the parent's) and a
    # trace with no roll (a spatial cell)
    bare = [_span(e.name, e.ts_ns, e.dur_ns, e.depth,
                  **{k: v for k, v in e.attrs.items() if k != "h2d_bytes"})
            for e in SPANS]
    assert _read("h2d_gbps", _ctx(spans=bare, trace=_trace())) is None
    tr = _trace()
    tr.marks[:] = [m for m in tr.marks if m[0] != "executor.roll"]
    assert _read("roll_ms_per_frame", _ctx(trace=tr)) is None
    # no copy on the device
    tr = _trace()
    tr.ops[:] = [o for o in tr.ops if not o[0].startswith("Memcpy HtoD")]
    assert _read("h2d_gbps", _ctx(trace=tr)) is None


NEW = {"assemble_ms_per_frame.tput": "spatial7-1080p.host",
       "assemble_ms_per_frame.tail": "video4-1080p.cams30",
       "h2d_gbps.tput": "spatial7-1080p.host",
       "h2d_gbps.tail": "video4-1080p.cams30",
       "launch_ms.tput": "spatial7-1080p.host",
       "launch_ms.tail": "video4-1080p.cams30",
       "roll_ms_per_frame.tail": "video4-1080p.cams30"}


def test_the_new_metrics_are_found_by_name_in_their_cells():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, where in NEW.items():
        m = entries[name]
        assert m["workloads"] == [where]
        assert m["moves"] == ("fps" if name.endswith(".tput")
                              else "latency_p95_ms")
        assert m in cell.metrics_of(bench, cells[where], "per_layer")
        for other in set(cells) - {where}:
            assert m not in cell.metrics_of(bench, cells[other],
                                            "per_layer")
        fam = name.split(".", 1)[0]
        assert callable(cell.load_module(READERS / f"{fam}.py").read)
