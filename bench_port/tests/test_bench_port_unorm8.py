"""The unorm8 server, the device-resident loop and the readers of the
decode span, on the CPU.

The server's pool after ``warm_up``: each frame the decode of its 8-bit
twin, bit for bit, the twins over all of 0..255; both new cells run end
to end at a tiny size and check out; the ``resident`` loop offers
tensors on the server's device and counts as ``closed`` does; the two
readers of ``engine.unorm8`` on synthetic spans and profiler events, and
their entries in ``BENCHMARK.json``, found by name."""
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_port.harness import cell, frames, profile, traffic
from bench_port.loops import closed
from bench_port.tests.test_bench_port_readers import Ev

HERE = Path(__file__).resolve().parents[1]
READERS = HERE / "layer_metrics"
CPU = torch.device("cpu")


def _config(name, **kw):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    return dict(cfg, height=16, width=24, **kw)


def _module(kind, name):
    return cell.load_module(HERE / kind / f"{name}.py")


# ------------------------------------------------------------- server
def test_warm_up_rewrites_the_pool_to_its_twins_decode():
    cfg = _config("spatial7-4k-u8", pipelines=["harris-m", "unsharp-m"])
    cfg["engine"] = dict(cfg["engine"], tile_shape=[16, 24])
    mod = _module("servers", "frame_engine_unorm8")
    pool = frames.make_pool(10, 16, 24, 2 ** 40 + 9, CPU)
    before = [f.copy() for f in pool]
    srv = mod.Server(cfg, CPU)
    assert srv.engine.pixels == "unorm8"
    cls = closed.clients({"clients_per_pipeline": 1, "pool_frames": 10},
                         cfg["pipelines"], 3)
    srv.warm_up(pool, cls)
    twins = [srv._twin[id(f)] for f in pool]
    seen = set()
    for f, old, u in zip(pool, before, twins):
        assert u.dtype == np.uint8 and u.shape == f.shape
        assert np.array_equal(u, np.minimum(np.floor(old * 256), 255))
        want = u.astype(np.float32) / np.float32(255)
        assert np.array_equal(f.view(np.int32), want.view(np.int32))
        seen |= set(np.unique(u).tolist())
    assert seen == set(range(256))
    assert np.array_equal(mod.TABLE, np.arange(256, dtype=np.float32)
                          / np.float32(255))
    # the engine takes the twin of the pool frame it is given
    srv.open(cls)
    assert srv.submit(cls[0], 0, pool[3])
    (out,) = [o for _, _, o in srv.step()]
    from bench_port.reference import pipelines as reference
    want = reference.run(cls[0].pipeline, torch.from_numpy(pool[3])[None])
    assert torch.equal(out, want)


CELLS = {"spatial7-4k-u8.host": dict(pipelines=["canny-m", "xcorr-m"]),
         "spatial7-1080p.device": dict(pipelines=["harris-s", "denoise-m"])}


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_new_cells_run_and_check_out(name, trace):
    """Each new cell, as ``BENCHMARK.json`` has it, at 16x24 on the CPU."""
    bench, spec, config, mix = cell.load(name)
    config = dict(config, height=16, width=24, **CELLS[name])
    config["engine"] = dict(config["engine"], tile_shape=[16, 24])
    mix = dict(mix, pool_frames=6, check_per_pipeline=1)
    result, _ = cell.run(bench, spec, config, mix, 2 ** 33 + 5, 0.3, trace,
                         CPU, time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["checks"]["max_ulp"]["value"] == 0
    assert result["failed"] == 0 and result["attempted"] > 0
    got = set(result["metrics"])
    if trace:
        # the CPU has no device trace: only the program's own spans read
        assert {"assemble_ms_per_frame.u8", "engine_host_ms.dev",
                "launch_ms.dev"} & got
    else:
        assert got == {"fps", "setup_s"}


# --------------------------------------------------------------- loop
class _Echo:
    """A server that serves whatever it was offered at the next step."""

    def __init__(self):
        self.engine = SimpleNamespace(device=CPU)
        self.offered, self._pending = [], []

    def submit(self, client, k, frame):
        self.offered.append((client, k, frame))
        self._pending.append((client.index, k, torch.zeros(1)))
        return True

    def step(self):
        done, self._pending = self._pending, []
        return done

    @property
    def pending(self):
        return len(self._pending)


@pytest.mark.parametrize("loop", ["closed", "resident"])
def test_the_resident_loop_offers_device_tensors_and_counts_as_closed(loop):
    mix = json.loads((HERE / "traffic" / "device.json").read_text())
    assert mix["loop"] == "resident"
    mix = dict(mix, pool_frames=5)
    mod = _module("loops", loop)
    pool = frames.make_pool(5, 4, 6, 11, CPU)
    cls = mod.clients(mix, ["a", "b"], 11)
    assert cls == closed.clients(mix, ["a", "b"], 11)
    srv, kept, closes = _Echo(), [], []
    w = mod.run(srv, cls, mix, pool, 0.05, lambda *a: kept.append(a), 11,
                lambda: closes.append(1))
    assert closes == [1] and w.counted == len(w.delivered) == len(kept)
    assert w.offered == w.counted and w.counted > 0 and not w.missing
    for c, k, f in srv.offered:
        want = pool[traffic.frame_index(mix, c, k)]
        if loop == "closed":
            assert f is want
        else:
            assert isinstance(f, torch.Tensor) and f.device == CPU
            assert torch.equal(f, torch.from_numpy(want))
    for ci, ks in w.accepted.items():
        assert ks == list(range(len(ks)))


# ------------------------------------------------------------ readers
def _trace():
    """A 1000 ns window: a copy, two decode kernels launched inside
    ``engine.unorm8`` (overlapping, 150 ns of union), K1 launched in
    ``engine.execute``, which the decode must not count."""
    return profile.from_events([
        Ev("bench.window", 0, 1000, mark=True),
        Ev("engine.assemble", 100, 400, mark=True),
        Ev("engine.unorm8", 300, 390, mark=True),
        Ev("engine.execute", 400, 700, mark=True),
        Ev("cudaMemcpyAsync", 110, 115, corr=1),
        Ev("Memcpy HtoD (Pinned -> Device)", 120, 300, dev="cuda", corr=1),
        Ev("cudaLaunchKernel", 310, 312, corr=2),
        Ev("unorm8_decode_kernel", 320, 420, dev="cuda", corr=2),
        Ev("cudaLaunchKernel", 350, 352, corr=3),
        Ev("unorm8_decode_kernel", 400, 470, dev="cuda", corr=3),
        Ev("cudaLaunchKernel", 410, 412, corr=4),
        Ev("stencil_pipeline_kernel", 480, 600, dev="cuda", corr=4),
    ])


def _span(name, ts, dur, depth, **attrs):
    return SimpleNamespace(name=name, ts_ns=ts, dur_ns=dur, tid=1,
                           depth=depth, attrs=attrs)


SPANS = [
    _span("engine.step", 0, 800, 0, delivered=3),
    _span("engine.assemble", 100, 300, 1, h2d_bytes=300),
    _span("engine.unorm8", 300, 90, 2, n_frames=2, pixels=200),
    _span("engine.unorm8", 350, 20, 2, n_frames=1, pixels=100),
    _span("engine.execute", 400, 300, 1),
]


def _ctx(spans=SPANS, trace=None):
    return cell.Context(spans=spans, trace=trace, capacity=4,
                        frame_bytes=1000, peak_bytes_per_s=1e12, smem={})


def _read(name, ctx):
    return cell.load_module(READERS / f"{name}.py").read(ctx)


def test_the_decode_time_a_served_frame():
    # the union 320-470 of the two decode kernels, over 3 frames, in ms
    assert _read("unorm8_ms_per_frame", _ctx(trace=_trace())) == \
        pytest.approx(150e-6 / 3)


def test_the_decode_roofline_is_five_bytes_a_pixel_over_its_time():
    # 300 pixels x 5 B at 1e12 B/s: 1.5 ns over 150 ns of decode
    assert _read("unorm8_roofline", _ctx(trace=_trace())) == \
        pytest.approx(100 * 1.5 / 150)
    assert _module("layer_metrics", "unorm8_roofline").bytes_moved(300) \
        == 1500


@pytest.mark.parametrize("name", ["unorm8_ms_per_frame", "unorm8_roofline"])
def test_the_decode_readers_with_nothing_to_read_return_nothing(name):
    assert _read(name, _ctx()) is None                  # no trace
    assert _read(name, _ctx(spans=[], trace=_trace())) is None
    # the parent's program: no decode span, so no mark and no pixels
    tr = _trace()
    tr.marks[:] = [m for m in tr.marks if m[0] != "engine.unorm8"]
    bare = [e for e in SPANS if e.name != "engine.unorm8"]
    assert _read(name, _ctx(spans=bare, trace=tr)) is None


NEW = {"unorm8_ms_per_frame.u8": "spatial7-4k-u8.host",
       "unorm8_roofline.u8": "spatial7-4k-u8.host",
       "h2d_gbps.u8": "spatial7-4k-u8.host",
       "h2d_ms_per_frame.u8": "spatial7-4k-u8.host",
       "k1_roofline.u8": "spatial7-4k-u8.host",
       "assemble_ms_per_frame.u8": "spatial7-4k-u8.host",
       "device_idle_share.u8": "spatial7-4k-u8.host",
       "k1_roofline.dev": "spatial7-1080p.device",
       "engine_host_ms.dev": "spatial7-1080p.device",
       "launch_ms.dev": "spatial7-1080p.device",
       "device_idle_share.dev": "spatial7-1080p.device"}


def test_the_new_entries_are_found_by_name_in_their_cells():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert cells["spatial7-4k-u8.host"]["chips"] == 1
    assert cells["spatial7-1080p.device"]["chips"] == 1
    for name, where in NEW.items():
        m = entries[name]
        assert m["workloads"] == [where] and m["moves"] == "fps"
        assert m in cell.metrics_of(bench, cells[where], "per_layer")
        for other in set(cells) - {where}:
            assert m not in cell.metrics_of(bench, cells[other],
                                            "per_layer")
        fam = name.split(".", 1)[0]
        assert callable(cell.load_module(READERS / f"{fam}.py").read)
    for where in set(NEW.values()):
        e2e = {m["name"] for m in cell.metrics_of(bench, cells[where],
                                                  "end_to_end")}
        assert e2e == {"fps", "setup_s"}
