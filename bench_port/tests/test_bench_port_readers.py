"""The per-layer readers on synthetic spans and profiler events: the
union behind busy and idle time, the kernels counted inside
``engine.execute``, the roofline's bytes, a step's self time."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench_port.harness import cell, profile, spans


class Ev:
    """A stand-in for the profiler's raw event."""

    def __init__(self, name, start, end, dev="cpu", corr=0, mark=False):
        self._n, self._s, self._e = name, start, end
        self._d, self._c, self._m = dev, corr, mark

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return "DeviceType.CUDA" if self._d == "cuda" else "DeviceType.CPU"

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._m


def _trace():
    """A 1000 ns window: a copy, two kernels launched inside
    engine.execute (one overlapping the copy), one launched outside."""
    return profile.from_events([
        Ev("bench.window", 0, 1000, mark=True),
        Ev("engine.execute", 300, 690, mark=True),
        Ev("engine.execute", 310, 680, dev="cuda", mark=True),
        Ev("cudaMemcpyAsync", 90, 95, corr=1),
        Ev("Memcpy HtoD (Pageable -> Device)", 100, 400, dev="cuda", corr=1),
        Ev("cudaLaunchKernel", 310, 312, corr=2),
        Ev("stencil_pipeline_kernel", 350, 450, dev="cuda", corr=2),
        Ev("cuLaunchKernel", 320, 322, corr=3),
        Ev("cat_kernel", 500, 550, dev="cuda", corr=3),
        Ev("cudaLaunchKernel", 800, 801, corr=4),
        Ev("outside_kernel", 850, 900, dev="cuda", corr=4),
        Ev("late_kernel", 990, 1200, dev="cuda", corr=5),
        Ev("aten::copy_", 40, 420),
    ])


def test_union_merges_overlaps():
    assert profile.union([(5, 9), (0, 3), (2, 4), (9, 10)]) == \
        [(0, 4), (5, 10)]


def test_busy_is_the_union_clipped_to_the_window():
    tr = _trace()
    # 100-450, 500-550, 850-900, 990-1000
    assert profile.busy_s(tr) == pytest.approx(460e-9)
    assert profile.window_s(tr) == pytest.approx(1000e-9)
    assert profile.device_seconds(tr, "Memcpy HtoD") == pytest.approx(300e-9)


def test_kernels_inside_execute_whatever_their_names():
    names = [k[0] for k in profile.kernels_launched_in(_trace(),
                                                       "engine.execute")]
    assert names == ["stencil_pipeline_kernel", "cat_kernel"]


def test_a_kernel_without_its_launch_counts_where_it_ran():
    tr = _trace()
    tr.launched_at.pop(3)
    names = [k[0] for k in profile.kernels_launched_in(tr, "engine.execute")]
    assert names == ["stencil_pipeline_kernel", "cat_kernel"]
    tr.launched_at.pop(2)
    tr.device_marks[:] = []
    assert profile.kernels_launched_in(tr, "engine.execute") == []


def test_idle_gaps_name_what_the_host_was_doing():
    gaps = dict(profile.idle_gaps(_trace()))
    assert gaps["bench.window / aten::copy_"] == pytest.approx(100e-9)
    assert gaps["engine.execute"] == pytest.approx(50e-9)
    assert gaps["bench.window"] == pytest.approx(300e-9 + 90e-9)
    assert len(gaps) == 3
    assert sum(gaps.values()) == pytest.approx(1000e-9 - 460e-9)


def test_top_device_ops_by_time():
    top = profile.by_name(_trace(), n=2)
    assert top[0][0].startswith("Memcpy") and len(top) == 2


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        profile.from_events([Ev("k", 0, 1, dev="cuda")])


def _span(name, ts, dur, depth, **attrs):
    return SimpleNamespace(name=name, ts_ns=ts, dur_ns=dur, tid=1,
                           depth=depth, attrs=attrs)


SPANS = [
    _span("engine.step", 0, 100, 0, delivered=4),
    _span("engine.assemble", 10, 30, 1),
    _span("engine.execute", 50, 40, 1),
    _span("executor.call", 55, 30, 2),
    _span("engine.step", 200, 50, 0, delivered=1),
    _span("engine.execute", 210, 20, 1),
    _span("engine.execute", 232, 10, 1, reference=True),
]


def test_step_self_time_leaves_out_assembly_and_execution():
    assert spans.step_self_ns(SPANS) == [30, 20]
    assert spans.frames_served(SPANS) == 5
    assert spans.executor_calls(SPANS) == 2


READERS = Path(__file__).resolve().parents[1] / "layer_metrics"


def _ctx(trace=None, smem=None):
    return cell.Context(spans=SPANS, trace=trace, capacity=4,
                        frame_bytes=1000, peak_bytes_per_s=1e12,
                        smem=smem or {})


def _read(name, ctx):
    return cell.load_module(READERS / f"{name}.py").read(ctx)


def test_readers_on_synthetic_spans_and_events():
    ctx = _ctx(_trace(), {"a": 1024, "b": 3072})
    assert _read("engine_host_ms", ctx) == pytest.approx(25e-6)
    assert _read("batch_fill", ctx) == pytest.approx(5 / 2 / 4)
    assert _read("h2d_ms_per_frame", ctx) == pytest.approx(300e-6 / 5)
    assert _read("k1_smem_kib", ctx) == pytest.approx(2.0)
    # 5 frames of 1000 bytes at 1e12 B/s: 5 ns over 150 ns of kernels
    assert _read("k1_roofline", ctx) == pytest.approx(100 * 5 / 150)
    assert _read("device_idle_share", ctx) == pytest.approx(0.54)


@pytest.mark.parametrize("name", ["h2d_ms_per_frame", "k1_roofline",
                                  "device_idle_share", "k1_smem_kib"])
def test_readers_with_nothing_to_read_return_nothing(name):
    assert _read(name, _ctx()) is None


@pytest.mark.parametrize("server", ["frame_engine", "video_engine"])
def test_smem_is_what_the_engine_counted_for_the_batches_it_served(server):
    import numpy as np
    import torch

    from bench_port.harness import traffic
    config = {"frame_engine": "spatial7-1080p",
              "video_engine": "video4-1080p"}[server]
    cfg = cell.json.loads((READERS.parent / "configs"
                           / f"{config}.json").read_text())
    cfg = dict(cfg, height=12, width=20, pipelines=cfg["pipelines"][:2])
    srv = cell.load_module(READERS.parent / "servers" / f"{server}.py") \
        .Server(cfg, torch.device("cpu"))
    mix = {"pool_frames": 2}
    cls = traffic.spread(2, mix, cfg["pipelines"], 1)
    pool = [np.zeros((12, 20), np.float32)] * 2
    srv.warm_up(pool, cls)
    srv.open(cls)
    assert srv.served_smem() == {}
    for c in cls:
        assert srv.submit(c, 0, pool[0])
    while srv.pending:
        srv.step()
    got = srv.served_smem()
    assert set(got) == set(cfg["pipelines"])
    assert max(got.values()) == srv.engine.metrics.smem_high_water > 0
