"""The port's spans on the profiler's timeline, and the host-to-device
bytes they carry.

While tracing is on and a ``torch.profiler`` records, every span of the
program is also a ``record_function`` annotation of the same name, so
the profiler's timeline says which layer the host was in. The spans that
hand host memory to the engine's device carry ``h2d_bytes``. All on the
CPU: the engines' plain versions take the same paths as on a card.
"""
import collections

import numpy as np
import pytest
import torch

from repro_torch._device import h2d_span, host_bytes
from repro_torch.core import algorithms
from repro_torch.imaging import FrameEngine, FrameRequest
from repro_torch.kernels import stencil_pipeline as sp
from repro_torch.obs import trace
from repro_torch.obs.trace import NULL_SPAN
from repro_torch.resilience import ResilienceConfig, RetryPolicy
from repro_torch.resilience.chaos import ChaosMonkey, install_chaos
from repro_torch.video import VideoEngine, VideoFrame

H, W = 12, 20
RNG = np.random.RandomState(11)


@pytest.fixture
def global_trace():
    """Enable the process-global tracer for a test; always restore."""
    trace.clear()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.clear()


def _frame(shape=(H, W)):
    return RNG.rand(*shape).astype(np.float32)


def _annotations(run) -> list[str]:
    """Names of the host user annotations a CPU profiler records while
    ``run()`` runs."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def _serve_frames(n=3, max_batch=4, pipeline="unsharp-m", **kw):
    eng = FrameEngine(max_batch=max_batch, device="cpu", **kw)
    return eng.run([FrameRequest(rid=i, pipeline=pipeline,
                                 frames={"in": _frame()})
                    for i in range(n)])


def _serve_stream(pipeline="tmotion-t", n=4, chunk=2, one_at_a_time=True):
    """Frames of one stream, stepped one at a time (the one-frame path)
    or in full chunks."""
    eng = VideoEngine(chunk=chunk, device="cpu")
    sid = eng.open_stream(pipeline, H, W)
    outs = []
    per_step = 1 if one_at_a_time else chunk
    for t in range(0, n, per_step):
        for _ in range(per_step):
            assert eng.submit(VideoFrame(sid, {"in": _frame()}))
        outs += eng.step()
    assert len(outs) == n
    return eng


def _by_name(name):
    return [e for e in trace.events() if e.name == name]


# ------------------------------------------------ spans as annotations
@pytest.mark.parametrize("engine", ["frame", "video"])
def test_every_span_is_a_profiler_annotation(global_trace, engine):
    run = _serve_frames if engine == "frame" else _serve_stream
    marks = _annotations(run)
    want = {"engine.step", "engine.assemble", "engine.execute",
            "executor.call"}
    if engine == "video":
        want.add("executor.roll")
    assert want <= set(marks)
    # one annotation per span, of every span the run recorded
    assert collections.Counter(marks) == collections.Counter(
        e.name for e in trace.events())


def test_tracing_off_enters_no_annotation():
    assert not trace.enabled()
    trace.clear()
    marks = _annotations(lambda: (_serve_frames(), _serve_stream()))
    assert marks == []
    assert trace.events() == []
    assert trace.span("engine.step") is NULL_SPAN
    assert h2d_span("engine.assemble", iter(()), torch.device("cpu")) \
        is NULL_SPAN


def test_tracing_without_a_profiler_records_the_same_spans(global_trace):
    _serve_stream()
    plain = [(e.name, e.depth, e.parent) for e in trace.events()]
    trace.clear()
    _annotations(_serve_stream)
    assert [(e.name, e.depth, e.parent) for e in trace.events()] == plain


# --------------------------------------------------------- h2d_bytes
def test_video_one_frame_path_assembles_under_the_step(global_trace):
    _serve_stream(n=3)
    steps = _by_name("engine.step")
    assembles = _by_name("engine.assemble")
    assert len(steps) == len(assembles) == 3
    assert all(e.attrs["n_frames"] == 1 for e in steps)
    for e in assembles:
        assert (e.parent, e.depth) == ("engine.step", 1)
        assert e.attrs["h2d_bytes"] == H * W * 4
    # the step assembles, then executes: the copy is out of the call
    for e in _by_name("engine.execute"):
        assert (e.parent, e.depth) == ("engine.step", 1)
    calls = _by_name("executor.call")
    assert len(calls) == 3
    assert all("h2d_bytes" not in e.attrs for e in calls)


def test_video_chunk_path_counts_every_frame_of_the_chunk(global_trace):
    _serve_stream(n=4, chunk=2, one_at_a_time=False)
    assembles = _by_name("engine.assemble")
    assert len(assembles) == 2
    assert all(e.attrs["h2d_bytes"] == 2 * H * W * 4 for e in assembles)
    assert all("h2d_bytes" not in e.attrs for e in _by_name("executor.call"))


@pytest.mark.parametrize("tile_shape", [(128, 128), (8, 16)])
def test_frame_engine_counts_frames_and_no_padding(global_trace,
                                                   tile_shape):
    done = _serve_frames(n=3, max_batch=4, tile_shape=tile_shape)
    assert len(done) == 3
    (asm,) = _by_name("engine.assemble")
    assert asm.parent == "engine.step"
    assert asm.attrs["h2d_bytes"] == 3 * H * W * 4
    calls = _by_name("executor.call")
    assert calls and all("h2d_bytes" not in e.attrs for e in calls)


def test_a_direct_caller_handing_host_arrays_is_counted(global_trace):
    dag = algorithms.ALGORITHMS["unsharp-m"]()
    ex = sp.make_executor(dag, H, W, batch=2, device="cpu")
    host = RNG.rand(2, H, W)                 # float64: counted as float32
    ex({"in": host})
    ex({"in": torch.as_tensor(host, dtype=torch.float32)})
    first, second = _by_name("executor.call")
    assert first.attrs["h2d_bytes"] == 2 * H * W * 4
    assert "h2d_bytes" not in second.attrs   # a CPU tensor stays put


def test_the_reference_rung_counts_what_it_moves(global_trace):
    eng = FrameEngine(max_batch=2, device="cpu", resilience=ResilienceConfig(
        breaker_failures=1,
        retry=RetryPolicy(max_attempts=2, base_delay_s=1e-4, seed=0)))
    install_chaos(eng.cache, ChaosMonkey(seed=0, compile=1.0))
    for i in range(2):
        assert eng.submit(FrameRequest(rid=i, pipeline="unsharp-m",
                                       frames={"in": _frame()}))
    assert [c.rung for c in eng.step()] == ["reference"] * 2
    (ref,) = [e for e in _by_name("engine.execute")
              if e.attrs.get("reference")]
    assert ref.attrs["h2d_bytes"] == 2 * H * W * 4


def test_host_bytes_counts_what_leaves_host_memory():
    cpu, card = torch.device("cpu"), torch.device("cuda")
    a = np.zeros((3, 5), np.float64)
    t = torch.zeros(3, 5)
    assert host_bytes([a], cpu) == host_bytes([a], card) == 60
    assert host_bytes([t], cpu) == 0
    assert host_bytes([t], card) == 60
    assert host_bytes([a, t, a], card) == 180
    assert host_bytes(iter(()), card) == 0


# ------------------------------------------------------------- roll
def test_the_state_roll_is_a_child_of_the_executor_call(global_trace):
    _serve_stream(n=3)
    rolls = _by_name("executor.roll")
    assert len(rolls) == 3
    assert all((e.parent, e.attrs["pipeline"]) == ("executor.call",
                                                   "tmotion-t")
               for e in rolls)
    calls = _by_name("executor.call")
    for roll, call in zip(rolls, calls):
        assert roll.depth == call.depth + 1
        assert call.ts_ns <= roll.ts_ns
        assert roll.ts_ns + roll.dur_ns <= call.ts_ns + call.dur_ns
