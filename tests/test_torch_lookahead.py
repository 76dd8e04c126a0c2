"""``FrameEngine``'s lookahead on the CPU: a step launches the next batch
before it waits for the oldest one in flight.

The lookahead is on only on a card in strict mode, for untiled batches.
The first half holds the engines that do without it to one batch per
``step()``, with the executor calls they always made: a CPU engine, a
resilient one, and tiled batches on an engine whose lookahead is on. The
second half turns the lookahead on in CPU engines (``_lookahead``; the
CPU computes a batch at its launch, so there is no event to wait for)
and holds its bookkeeping: launch order, ``pending``, the spans, the
failures, and the stager's slots (:class:`FakeStager`).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.imaging import FrameEngine, FrameRequest, plan_tile_grid
from repro_torch.kernels import stage_ahead
from repro_torch.kernels import stencil_pipeline as sp
from repro_torch.obs import trace
from repro_torch.resilience import FailedFrame, ResilienceConfig
from test_torch_stage_ahead import FakeStager

H, W = 12, 14
TILE = (24, 24)
BIG = (40, 48)                  # tiled at TILE
RNG = np.random.RandomState(34)


def _frame(h=H, w=W):
    return RNG.rand(h, w).astype(np.float32)


def _engine(lookahead=None, **kw):
    kw.setdefault("tile_shape", TILE)
    eng = FrameEngine(max_batch=kw.pop("max_batch", 4), device="cpu", **kw)
    if lookahead is not None:
        eng._lookahead = lookahead
    return eng


def _burst(spec):
    """Requests from ``spec``, (pipeline, frames, (h, w)) runs in
    submission order, rids from 0."""
    out = []
    for pipe, n, shape in spec:
        out += [FrameRequest(rid=len(out) + i, pipeline=pipe,
                             frames={"in": _frame(*shape)})
                for i in range(n)]
    return out


def _plain(eng, req):
    return sp.stencil_pipeline_plain(eng.cache.dag_for(req.pipeline),
                                     {"in": torch.from_numpy(req.frames["in"])})


def _steps(eng, reqs):
    """Submit ``reqs``, then step until idle, tracing. Returns the rids
    each step returned, ``pending`` after each step, the outputs by rid
    and the spans."""
    for r in reqs:
        assert eng.submit(r) is True
    trace.clear()
    trace.enable()
    try:
        groups, pending, outs = [], [], {}
        while True:
            res = eng.step()
            if not res:
                break
            groups.append([c.rid for c in res])
            pending.append(eng.pending)
            outs.update({c.rid: c.output if hasattr(c, "output") else c
                         for c in res})
        spans = trace.events()
    finally:
        trace.disable()
        trace.clear()
    return groups, pending, outs, spans


def _per_step(spans, name):
    """For each ``engine.step`` span in order, the spans named ``name``
    that lie inside it."""
    steps = [e for e in spans if e.name == "engine.step"]
    return [[e for e in spans if e.name == name
             and s.ts_ns <= e.ts_ns <= s.ts_ns + s.dur_ns] for s in steps]


# ------------------------------------------------- engines without lookahead
SPEC = [("unsharp-m", 4, (H, W)), ("xcorr-m", 4, (H, W)),
        ("unsharp-m", 3, (H, W))]
BATCHES = [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10]]
TILED_SPEC = [("unsharp-m", 3, BIG), ("xcorr-m", 2, BIG)]
TILED_BATCHES = [[0, 1, 2], [3, 4]]


@pytest.mark.parametrize("kind", ["cpu", "resilient", "tiled"])
def test_engines_without_the_lookahead_return_one_batch_a_step(kind):
    """A CPU engine, a resilient engine and tiled batches on an engine
    whose lookahead is on: each ``step()`` assembles, runs and returns
    one batch, nothing stays in flight, each batch makes the executor
    calls it always made (one untiled, one per ``max_batch`` tiles of each
    frame tiled) under one ``engine.execute`` span, and every output is
    the plain version's."""
    if kind == "tiled":
        eng, spec, batches = _engine(lookahead=True), TILED_SPEC, \
            TILED_BATCHES
    else:
        eng = _engine(resilience=ResilienceConfig()
                      if kind == "resilient" else None)
        spec, batches = SPEC, BATCHES
    assert eng._lookahead is (kind == "tiled")
    reqs = _burst(spec)
    groups, pending, outs, spans = _steps(eng, reqs)
    assert groups == batches
    total = len(reqs)
    assert pending == [total - sum(map(len, batches[:i + 1]))
                       for i in range(len(batches))]
    calls = [len(c) for c in _per_step(spans, "executor.call")]
    if kind == "tiled":
        def per_frame(pipe):
            grid = plan_tile_grid(eng.cache.dag_for(pipe), *BIG, *TILE)
            return math.ceil(grid.n_tiles / eng.max_batch)
        want = [len(b) * per_frame(reqs[b[0]].pipeline) for b in batches]
    else:
        want = [1] * len(batches)
    assert calls == want
    assert [len(e) for e in _per_step(spans, "engine.execute")] == \
        [1] * len(batches)
    steps = [e for e in spans if e.name == "engine.step"]
    assert [e.attrs["delivered"] for e in steps] == list(map(len, batches))
    assert all(e.attrs["launched_ahead"] == 0 for e in steps)
    for r in reqs:
        assert torch.equal(outs[r.rid], _plain(eng, r)), r.rid


# ------------------------------------------------------- with the lookahead
MIXED = [("unsharp-m", 4, (H, W)), ("xcorr-m", 3, (H, W)),
         ("unsharp-m", 2, (10, 12)), ("canny-m", 4, (H, W)),
         ("xcorr-m", 1, (10, 12))]


def test_the_lookahead_returns_batches_in_launch_order():
    """A burst of pipelines and shapes: the first step launches two
    batches and returns the first, every later step launches one and
    returns the one before it, the last one only waits; ``pending``
    counts the batch in flight; outputs and per-pipeline order equal an
    engine without the lookahead's."""
    reqs = _burst(MIXED)
    want_groups, _, want, _ = _steps(_engine(lookahead=False), reqs)
    eng = _engine(lookahead=True)
    groups, pending, outs, spans = _steps(eng, reqs)
    assert groups == want_groups == [[0, 1, 2, 3], [4, 5, 6], [7, 8],
                                     [9, 10, 11, 12], [13]]
    total = len(reqs)
    assert pending == [total - sum(map(len, groups[:i + 1]))
                       for i in range(len(groups))]
    assert not eng._inflight and eng.pending == 0
    for rid in want:
        assert torch.equal(outs[rid], want[rid]), rid
    steps = [e for e in spans if e.name == "engine.step"]
    assert [e.attrs["delivered"] for e in steps] == list(map(len, groups))
    assert [e.attrs["launched_ahead"] for e in steps] == \
        [0] + list(map(len, groups[1:]))
    # the batch a step launches is the next one; the wait for the one it
    # returns sits in that engine.execute span (the last step: alone)
    pipes = [reqs[g[0]].pipeline for g in groups]
    assert [e.attrs["pipeline"] for e in steps] == pipes
    calls = _per_step(spans, "executor.call")
    assert [[c.attrs["pipeline"] for c in s] for s in calls] == \
        [pipes[:2]] + [[p] for p in pipes[2:]] + [[]]
    execs = _per_step(spans, "engine.execute")
    assert [len(s) for s in execs] == [2, 1, 1, 1, 1]
    assert all(e.parent == "engine.step" for s in execs for e in s)


def test_run_drains_the_batch_in_flight():
    reqs = _burst(MIXED)
    eng = _engine(lookahead=True)
    res = eng.run(reqs)
    assert sorted(res) == [r.rid for r in reqs]
    assert eng.pending == 0 and not eng._inflight
    for r in reqs:
        assert torch.equal(res[r.rid], _plain(eng, r)), r.rid


def test_a_tiled_batch_waits_until_nothing_is_in_flight():
    """A tiled batch next in line: the step returns the batch in flight
    alone, and the next step runs the tiled batch as before."""
    reqs = _burst([("unsharp-m", 4, (H, W)), ("xcorr-m", 4, (H, W)),
                   ("unsharp-m", 1, BIG), ("xcorr-m", 2, (H, W))])
    eng = _engine(lookahead=True)
    groups, _, outs, spans = _steps(eng, reqs)
    assert groups == [[0, 1, 2, 3], [4, 5, 6, 7], [8], [9, 10]]
    steps = [e for e in spans if e.name == "engine.step"]
    assert [e.attrs["tiled"] for e in steps] == [False, False, True, False]
    assert [e.attrs["launched_ahead"] for e in steps] == [0, 4, 0, 0]
    for r in reqs:
        assert torch.equal(outs[r.rid], _plain(eng, r)), r.rid


def _failing(eng, monkeypatch, where, pipeline):
    """Make ``where`` ("executor", "hand_over" or "wait") raise for
    ``pipeline``'s batches."""
    if where == "executor":
        real = eng.cache.executor_for

        def executor_for(name, *a, **kw):
            ex = real(name, *a, **kw)
            if name != pipeline:
                return ex

            class Broken:
                smem_bytes = ex.smem_bytes

                def __call__(self, inputs):
                    raise RuntimeError("launch failed")
            return Broken()
        monkeypatch.setattr(eng.cache, "executor_for", executor_for)
    elif where == "hand_over":
        real = eng._hand_over

        def hand_over(name, reqs, slots):
            if name == pipeline:
                raise RuntimeError("hand-over failed")
            return real(name, reqs, slots)
        monkeypatch.setattr(eng, "_hand_over", hand_over)
    else:
        launched = []

        class Event:
            def __init__(self, name):
                self.name = name

            def synchronize(self):
                if self.name == pipeline:
                    raise RuntimeError("wait failed")

        real_launch = eng._launch

        def launch(b, wait):
            if b is not None:
                launched.append(b)
            real_launch(b, wait)
        monkeypatch.setattr(eng, "_launch", launch)
        monkeypatch.setattr(eng, "_record",
                            lambda: Event(launched[-1].name))


@pytest.mark.parametrize("where", ["executor", "hand_over", "wait"])
def test_a_failure_in_the_lookahead_fails_its_batch_only(monkeypatch, where):
    """The second batch, launched ahead, raises at its launch, its
    hand-over or its wait: its frames come back as FailedFrame results
    after the batch in flight's (at once, or at its wait), every other
    frame is served, and nothing is stranded."""
    reqs = _burst([("unsharp-m", 4, (H, W)), ("xcorr-m", 4, (H, W)),
                   ("unsharp-m", 4, (H, W))])
    eng = _engine(lookahead=True)
    _failing(eng, monkeypatch, where, "xcorr-m")
    for r in reqs:
        eng.submit(r)
    got = []
    while res := eng.step():
        got.append([(c.rid, isinstance(c, FailedFrame)) for c in res])
    if where == "wait":
        assert got == [[(i, False) for i in range(4)],
                       [(i, True) for i in range(4, 8)],
                       [(i, False) for i in range(8, 12)]]
    else:
        assert got == [[(i, False) for i in range(4)]
                       + [(i, True) for i in range(4, 8)],
                       [(i, False) for i in range(8, 12)]]
    assert eng.metrics.frames_failed == 4
    assert eng.pending == 0 and not eng._inflight


def test_a_first_batch_that_fails_leaves_the_next_in_flight(monkeypatch):
    reqs = _burst([("xcorr-m", 4, (H, W)), ("unsharp-m", 4, (H, W))])
    eng = _engine(lookahead=True)
    _failing(eng, monkeypatch, "executor", "xcorr-m")
    for r in reqs:
        eng.submit(r)
    first = eng.step()
    assert [(c.rid, isinstance(c, FailedFrame)) for c in first] == \
        [(i, True) for i in range(4)]
    assert eng.pending == 4 and len(eng._inflight) == 1
    assert [c.rid for c in eng.step()] == [4, 5, 6, 7]
    assert eng.step() == []


# ----------------------------------------------------------- the stager
@pytest.fixture
def fake(monkeypatch):
    FakeStager.made = []
    monkeypatch.setattr(stage_ahead, "Stager", FakeStager)
    monkeypatch.setattr(FrameEngine, "_stages_ahead", lambda self: True)
    yield FakeStager.made


def test_a_batch_in_flight_holds_no_slot_of_the_ring(fake):
    """Slots go back at the hand-over: with a batch in flight, every slot
    held is a queued frame's, so the ring keeps its ``2 * max_batch``
    slots for the frames behind it; outputs equal the plain version."""
    reqs = _burst([("unsharp-m", 4, (H, W)), ("xcorr-m", 4, (H, W)),
                   ("unsharp-m", 4, (H, W)), ("xcorr-m", 4, (H, W))])
    eng = _engine(lookahead=True)
    for r in reqs:
        eng.submit(r)
    (stager,) = fake
    served = {}
    while res := eng.step():
        served.update({c.rid: c.output for c in res})
        inflight = [r for b in eng._inflight for r in b.reqs]
        assert not any(id(r) in eng._ahead for r in inflight)
        queued = eng.pending - len(inflight)
        assert stager.out <= queued and stager.held <= queued
    assert sorted(served) == list(range(16))
    assert stager.out == 0 and eng._ahead == {}
    for r in reqs:
        assert torch.equal(served[r.rid], _plain(eng, r)), r.rid


def test_the_ring_is_not_remade_under_a_batch_in_flight(fake):
    """A larger frame admitted while a batch gathered from the ring is in
    flight goes by ``torch.as_tensor``; once that batch is returned, the
    next larger frame remakes the ring."""
    eng = _engine(lookahead=True)
    small = _burst([("unsharp-m", 4, (H, W)), ("xcorr-m", 4, (H, W))])
    for r in small:
        eng.submit(r)
    assert [c.rid for c in eng.step()] == [0, 1, 2, 3]
    (old,) = fake
    assert eng._inflight[0].stager is old and old.out == 0
    big = FrameRequest(rid=8, pipeline="unsharp-m",
                       frames={"in": _frame(20, 24)})
    eng.submit(big)
    assert id(big) not in eng._ahead and len(fake) == 1
    assert not old.closed
    assert [c.rid for c in eng.step()] == [4, 5, 6, 7]
    assert [c.rid for c in eng.step()] == [8]
    again = FrameRequest(rid=9, pipeline="unsharp-m",
                         frames={"in": _frame(20, 24)})
    eng.submit(again)
    assert len(fake) == 2 and old.closed and id(again) in eng._ahead
    assert [c.rid for c in eng.step()] == [9]
