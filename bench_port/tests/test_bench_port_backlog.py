"""The backlog mix, the unorm8 video server and the roll's roofline, on
the CPU.

The ``backlog`` loop against a fake server: each stream's chunks offered
at once and only after the last of the previous one returned, due
instants at the offer, refusals offered again after the next step
without a stream skipping a frame, the window's close; the two new cells
found by name and run end to end at a small size, checking out, with
the bfloat16 control and the faults failing, and the float32 1080p
streams under the same mix, which have no cell; ``roll_roofline``'s reader
on synthetic spans and profiler events; the new entries in
``BENCHMARK.json``."""
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_port import control
from bench_port.harness import cell, frames, profile
from bench_port.reference import pipelines as reference
from bench_port.tests.test_bench_port_readers import Ev

HERE = Path(__file__).resolve().parents[1]
READERS = HERE / "layer_metrics"
CPU = torch.device("cpu")
CELLS = ("video4-4k-u8.backlog",)
# the float32 1080p streams under the backlog mix: no cell, since its
# runs spread wider than the bound allows (PERF.md section 7)
F32 = "video4-1080p.backlog"


def _module(kind, name):
    return cell.load_module(HERE / kind / f"{name}.py")


def _load(name):
    """``cell.load(name)``, or for :data:`F32` the same tuple built from
    the accepted ``video4-1080p`` config and the backlog mix."""
    if name != F32:
        return cell.load(name)
    bench, _, config, _ = cell.load("video4-1080p.cams30")
    spec = {"name": F32, "config": "video4-1080p", "traffic": "backlog",
            "chips": 1}
    return bench, spec, config, _mix()


def _mix():
    return json.loads((HERE / "traffic" / "backlog.json").read_text())


# ------------------------------------------------------------ discovery
def test_the_cells_config_server_loop_and_traffic_are_found_by_name():
    assert _mix() == {"loop": "backlog", "clients_per_pipeline": 2,
                      "chunk": 4, "pool_frames": 64,
                      "check_per_pipeline": 4}
    for name in CELLS + (F32,):
        bench, spec, config, mix = _load(name)
        assert spec["chips"] == 1 and spec["traffic"] == "backlog"
        assert mix == _mix()
        assert callable(_module("servers", config["server"]).Server)
        loop = _module("loops", mix["loop"])
        assert callable(loop.run)
        assert len(loop.clients(mix, config["pipelines"], 5)) == 8
    config = cell.load("video4-4k-u8.backlog")[2]
    assert config["server"] == "video_engine_unorm8"
    assert (config["height"], config["width"]) == (2160, 3840)
    assert config["dtype"] == "uint8" and config["pixels"] == "unorm8"
    assert config["engine"] == {"chunk": 4, "rows_per_step": 8,
                                "prefetch_depth": 1, "autotune": False}
    assert config["check"] == {"max_ulp": 0} and config["reduced"] == []
    assert sorted(config["pipelines"]) == sorted(reference.TEMPORAL)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["video4-4k-u8"]
    assert entry["source"] == config["source"] and entry["reduced"] == []
    assert {c["name"] for c in bench["workloads"]} >= set(CELLS)
    assert F32 not in {c["name"] for c in bench["workloads"]}


# ----------------------------------------------------------------- loop
class _Streams:
    """A fake video server: each step serves up to ``chunk`` frames of
    the stream whose oldest frame waited longest; refuses each (client,
    k) of ``refuse`` once."""

    def __init__(self, chunk, refuse=(), step_s=0.0):
        self.chunk, self.refuse, self.step_s = chunk, set(refuse), step_s
        self.engine = SimpleNamespace(device=CPU)
        self.log = []   # ("submit", client, k, ok), ("step", n, served)
        self.queues: dict = {}

    def submit(self, client, k, frame):
        if (client.index, k) in self.refuse:
            self.refuse.discard((client.index, k))
            self.log.append(("submit", client.index, k, False))
            return False
        self.log.append(("submit", client.index, k, True))
        self.queues.setdefault(client.index, []).append(
            (len(self.log), k, frame))
        return True

    def step(self):
        time.sleep(self.step_s)
        live = {c: q for c, q in self.queues.items() if q}
        if not live:
            self.log.append(("step", 0, []))
            return []
        c = min(live, key=lambda i: live[i][0][0])
        done, self.queues[c] = live[c][:self.chunk], live[c][self.chunk:]
        self.log.append(("step", len(done), [(c, k) for _, k, _ in done]))
        return [(c, k, torch.full((1,), float(k))) for _, k, _ in done]

    @property
    def pending(self):
        return sum(len(q) for q in self.queues.values())


def _run(srv, seconds=0.05, mix=None, n_pipes=2):
    mix = mix or dict(_mix(), pool_frames=7)
    loop = _module("loops", "backlog")
    pool = frames.make_pool(mix["pool_frames"], 2, 3, 11, CPU)
    cls = loop.clients(mix, ["a", "b"][:n_pipes], 11)
    kept, closes = [], []
    w = loop.run(srv, cls, mix, pool, seconds, lambda *a: kept.append(a),
                 11, lambda: closes.append(srv.pending))
    return w, cls, kept, closes, pool, mix


def test_each_stream_offers_its_next_chunk_once_the_last_returned():
    srv = _Streams(chunk=4)
    w, cls, kept, closes, pool, mix = _run(srv)
    assert len(cls) == 4 and closes == [w.backlog_end]
    # per client: k in order, in chunks of 4 offered one after the other
    # with no step between, each only after every frame of the one
    # before it was served
    served: dict = {c.index: set() for c in cls}
    for n, entry in enumerate(srv.log):
        if entry[0] == "step":
            for ci, k in entry[2]:
                served[ci].add(k)
            continue
        _, ci, k, ok = entry
        assert ok
        if k % 4:
            assert srv.log[n - 1] == ("submit", ci, k - 1, True), (ci, k)
        else:
            assert served[ci] >= set(range(k)), (ci, k)
    for ci in served:
        ks = [e[2] for e in srv.log if e[0] == "submit" and e[1] == ci]
        assert ks == list(range(len(ks))) and len(ks) % 4 == 0
    for c, k, out in kept:
        assert torch.equal(out, torch.full((1,), float(k)))
    for ci, ks in w.accepted.items():
        assert ks == list(range(len(ks)))
    assert w.offered == w.counted == len(w.delivered) == len(kept) > 0
    assert not w.missing and not w.refused


def test_the_frames_of_a_chunk_are_due_at_their_offer():
    srv = _Streams(chunk=4, step_s=0.002)
    w, *_ = _run(srv, seconds=0.06)
    by_chunk: dict = {}
    for ci, k, due, done in w.delivered:
        by_chunk.setdefault((ci, k // 4), set()).add(due)
        assert done >= due
    # the four frames of a chunk share one offer instant, and a stream's
    # next chunk is due no earlier than the return of its last one
    assert all(len(d) == 1 for d in by_chunk.values())
    done_of = {(ci, k): done for ci, k, _, done in w.delivered}
    for (ci, j), (due,) in by_chunk.items():
        if j:
            last = done_of.get((ci, 4 * j - 1))
            assert last is None or due >= last


def test_a_refused_frame_is_offered_again_and_the_stream_waits_behind_it():
    srv = _Streams(chunk=4, refuse=[(0, 2), (1, 5)])
    w, cls, kept, *_ = _run(srv)
    subs = [(e[1], e[2], e[3]) for e in srv.log if e[0] == "submit"]
    for ci, k in ((0, 2), (1, 5)):
        i = subs.index((ci, k, False))
        # nothing more of that stream until it is accepted, after a step
        later = [s for s in subs[i + 1:] if s[0] == ci]
        assert later[0] == (ci, k, True)
        j = [n for n, e in enumerate(srv.log)
             if e[0] == "submit" and e[1:] == (ci, k, False)][0]
        again = [n for n, e in enumerate(srv.log)
                 if e[0] == "submit" and e[1:] == (ci, k, True)][0]
        assert any(e[0] == "step" for e in srv.log[j:again])
    for ci, ks in w.accepted.items():
        assert ks == list(range(len(ks)))
    assert not w.missing and w.counted > 0


def test_the_window_closes_at_the_first_step_past_its_seconds():
    srv = _Streams(chunk=4, step_s=0.004)
    w, cls, kept, closes, *_ = _run(srv, seconds=0.05)
    assert 0.05 <= w.seconds < 0.05 + 0.1
    assert closes == [w.backlog_end]
    assert all(d[3] <= w.seconds for d in w.delivered)
    assert w.counted == len(w.delivered)
    # the frames in flight at the close were served, neither counted nor
    # kept
    assert srv.pending == 0
    assert len(kept) == w.counted


def test_a_failed_frame_is_missing():
    class Failing(_Streams):
        def step(self):
            return [(c, k, None if k == 6 else out)
                    for c, k, out in super().step()]
    w, *_ = _run(Failing(chunk=4), seconds=0.05, n_pipes=1)
    assert (0, 6) in w.missing or (1, 6) in w.missing
    assert all(k != 6 for _, k, _, _ in w.delivered)


# ------------------------------------------------------------- the cells
SMALL = {"video4-4k-u8.backlog": dict(pipelines=["tbackground-t",
                                                 "tmotion-t"]),
         "video4-1080p.backlog": dict(pipelines=["tdenoise-t",
                                                 "tunsharp-t"])}


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("name", CELLS + (F32,))
def test_the_new_cells_run_and_check_out(name, trace):
    """Each new cell, as ``BENCHMARK.json`` has it, and the float32
    streams under its mix, at 16x24 on the CPU."""
    bench, spec, config, mix = _load(name)
    config = dict(config, height=16, width=24, **SMALL[name])
    mix = dict(mix, pool_frames=12, check_per_pipeline=2)
    result, _ = cell.run(bench, spec, config, mix, 2 ** 33 + 7, 0.3, trace,
                         CPU, time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["checks"]["max_ulp"]["value"] == 0
    assert result["failed"] == 0 and result["attempted"] > 0
    got = set(result["metrics"])
    suffix = ".v8"
    if trace and name == F32:
        # no per-layer entry lists a cell the benchmark does not have
        assert got == set()
    elif trace:
        # the CPU has no device trace: only the program's own spans and
        # counters read
        assert got == {f"{m}{suffix}" for m in (
            "assemble_ms_per_frame", "launch_ms", "engine_host_ms",
            "batch_fill", "k1_smem_kib")}
        assert result["metrics"][f"batch_fill{suffix}"]["value"] == 1.0
    else:
        assert got == {"fps", "setup_s"}


def test_the_server_hands_over_twins_and_the_pool_holds_their_decode():
    cfg = dict(cell.load("video4-4k-u8.backlog")[2], height=16, width=24,
               pipelines=["tmotion-t"])
    srv = _module("servers", "video_engine_unorm8").Server(cfg, CPU)
    assert srv.engine.pixels == "unorm8" and srv.capacity == 4
    pool = frames.make_pool(6, 16, 24, 2 ** 40 + 3, CPU)
    before = [f.copy() for f in pool]
    cls = _module("loops", "backlog").clients(
        dict(_mix(), clients_per_pipeline=1, pool_frames=6),
        cfg["pipelines"], 3)
    srv.warm_up(pool, cls)
    for f, old in zip(pool, before):
        u = srv._twin[id(f)]
        assert u.dtype == np.uint8
        assert np.array_equal(u, np.minimum(np.floor(old * 256), 255))
        want = u.astype(np.float32) / np.float32(255)
        assert np.array_equal(f.view(np.int32), want.view(np.int32))
    srv.open(cls)
    for k in range(2):
        assert srv.submit(cls[0], k, pool[k])
    outs = []
    while srv.pending:
        outs += srv.step()
    assert [(c, k) for c, k, _ in outs] == [(0, 0), (0, 1)]
    want = reference.run("tmotion-t", torch.from_numpy(np.stack(pool[:2])))
    assert torch.equal(outs[1][2], want)


@pytest.fixture(scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("side", ["program", "control", "alter",
                                  "stale_state"])
def test_correct_holds_for_the_program_and_fails_otherwise(side,
                                                           _one_thread):
    """The 8-bit 4K cell's check at a small size: the program passes; the
    bfloat16 reference in the kernel's place, a changed output pixel and
    rings left unrolled each fail by far more than rounding."""
    bench, spec, config, mix = cell.load("video4-4k-u8.backlog")
    config = dict(config, height=20, width=36)
    mix = dict(mix, pool_frames=12, check_per_pipeline=2)
    r = control.run_side(side, bench, spec, config, mix, 2 ** 35 + 1, 0.3,
                         CPU)
    assert r["attempted"] > 0
    assert r["correct"] is (side == "program"), r
    if side != "program":
        assert r["checks"]["max_ulp"] > 2 ** 16


# --------------------------------------------------------------- reader
def _trace():
    """A 1000 ns window: K1 launched in ``executor.call``, two roll
    kernels (overlapping, 40 ns of union) launched inside
    ``executor.roll``, and a cat launched after it that the roll must
    not count."""
    return profile.from_events([
        Ev("bench.window", 0, 1000, mark=True),
        Ev("executor.call", 400, 700, mark=True),
        Ev("executor.roll", 500, 600, mark=True),
        Ev("cudaLaunchKernel", 410, 412, corr=2),
        Ev("stencil_pipeline_kernel", 420, 520, dev="cuda", corr=2),
        Ev("cudaLaunchKernel", 510, 512, corr=3),
        Ev("CatArrayBatchedCopy", 530, 560, dev="cuda", corr=3),
        Ev("cudaLaunchKernel", 520, 522, corr=4),
        Ev("CatArrayBatchedCopy", 550, 570, dev="cuda", corr=4),
        Ev("cudaLaunchKernel", 650, 652, corr=6),
        Ev("CatArrayBatchedCopy", 660, 690, dev="cuda", corr=6),
    ])


def _span(name, ts, dur, depth, **attrs):
    return SimpleNamespace(name=name, ts_ns=ts, dur_ns=dur, tid=1,
                           depth=depth, attrs=attrs)


SPANS = [
    _span("engine.step", 0, 800, 0, delivered=4),
    _span("executor.call", 400, 300, 2),
    # one pixel a frame: 2 x 3 ring frames x 4 B, then 2 x 1 x 4 B
    _span("executor.roll", 500, 100, 3, pipeline="tdenoise-t",
          roll_bytes=24),
    _span("executor.roll", 610, 10, 3, pipeline="tmotion-t", roll_bytes=8),
]


def _ctx(spans=SPANS, trace=None):
    return cell.Context(spans=spans, trace=trace, capacity=4,
                        frame_bytes=2 * 4, peak_bytes_per_s=1e9, smem={})


def _read(ctx):
    return _module("layer_metrics", "roll_roofline").read(ctx)


def test_the_roll_roofline_is_its_bytes_over_its_kernels_time():
    # 32 B at 1e9 B/s: 32 ns over the 40 ns of roll kernels
    assert _read(_ctx(trace=_trace())) == pytest.approx(100 * 32 / 40)
    # the bytes are the benchmark's, by pipeline: a program without the
    # counter reads the same
    bare = [_span(e.name, e.ts_ns, e.dur_ns, e.depth,
                  **{k: v for k, v in e.attrs.items() if k != "roll_bytes"})
            for e in SPANS]
    assert _read(_ctx(spans=bare, trace=_trace())) == pytest.approx(80.0)


def test_the_roll_roofline_with_nothing_to_read_returns_nothing():
    assert _read(_ctx()) is None                          # no trace
    assert _read(_ctx(spans=[], trace=_trace())) is None
    # rolls of pipelines the reference does not know
    alien = [_span(e.name, e.ts_ns, e.dur_ns, e.depth,
                   **dict(e.attrs, pipeline="user-t")) for e in SPANS]
    assert _read(_ctx(spans=alien, trace=_trace())) is None
    # a spatial cell: no roll in the trace
    tr = _trace()
    tr.marks[:] = [m for m in tr.marks if m[0] != "executor.roll"]
    assert _read(_ctx(trace=tr)) is None


@pytest.mark.parametrize("name", sorted(reference.DEPTH))
def test_the_bytes_a_roll_must_move_are_what_the_program_counts(name):
    """``bytes_moved`` from the reference's history depths equals the
    ``roll_bytes`` of the program's roll of one call."""
    from repro_torch.imaging import PlanCache
    from repro_torch.kernels.stencil_pipeline import init_frame_state
    from repro_torch.obs import trace as program_trace
    h, w = 6, 10
    ex = PlanCache(device="cpu").video_executor_for(name, h, w, chunk=4,
                                                    rows_per_step=8)
    x = torch.rand((4, h, w))
    program_trace.clear()
    program_trace.enable()
    try:
        ex({"in": x}, init_frame_state(ex.depths, h, w, "cpu"))
        (roll,) = [e for e in program_trace.events()
                   if e.name == "executor.roll"]
    finally:
        program_trace.disable()
        program_trace.clear()
    mod = _module("layer_metrics", "roll_roofline")
    assert roll.attrs["roll_bytes"] == mod.bytes_moved(
        reference.DEPTH[name] - 1, h * w)


# -------------------------------------------------------------- entries
FAMILIES = ["h2d_gbps", "h2d_ms_per_frame", "assemble_ms_per_frame",
            "k1_roofline", "k1_smem_kib", "roll_ms_per_frame",
            "roll_roofline", "launch_ms", "engine_host_ms", "batch_fill",
            "device_idle_share", "unorm8_ms_per_frame", "unorm8_roofline"]
NEW = {f"{f}.v8": "video4-4k-u8.backlog" for f in FAMILIES}


def test_the_new_entries_are_found_by_name_in_their_cells():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, where in NEW.items():
        m = entries[name]
        assert m["workloads"] == [where] and m["moves"] == "fps"
        assert m in cell.metrics_of(bench, cells[where], "per_layer")
        for other in set(cells) - {where}:
            assert m not in cell.metrics_of(bench, cells[other],
                                            "per_layer")
        fam = name.split(".", 1)[0]
        assert callable(cell.load_module(READERS / f"{fam}.py").read)
    for where in CELLS:
        got = {m["name"] for m in cell.metrics_of(bench, cells[where],
                                                  "per_layer")}
        assert got == {n for n, c in NEW.items() if c == where}
        e2e = {m["name"] for m in cell.metrics_of(bench, cells[where],
                                                  "end_to_end")}
        assert e2e == {"fps", "setup_s"}
