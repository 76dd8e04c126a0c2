"""Staging ahead (``kernels/stage_ahead.py``, ``FrameEngine``'s stager),
without a card.

Two stand-ins. :class:`FakeStager` replaces the stager's threads in the
engine: it stages a ticket only when the test says so, so each path of
the hand-over (claimed ahead, waited for, taken back) is chosen, and the
engine runs on the CPU with admission told the host is busy on a card.
Every output is compared bit for bit with an engine that stages nothing.
Then the stager itself: its C++ (``csrc/stencil_pipeline.cu`` between
the ``stage ahead`` markers) compiled for the host over a fake of the
CUDA runtime calls it makes, whose streams run their copies lazily, only
when something waits for them, so a copy ordered by no event reads or
writes too late and shows. A copy from the host may read its source at
any time from its queueing to its run: the fake reads it at both, and
writes 0xFF bytes where they differ. Its "page-locked" and "device" slots
are CPU tensors.
"""
import ctypes
import gc
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.imaging import FrameEngine, FrameRequest
from repro_torch.imaging import engine as engine_module
from repro_torch.kernels import stage_ahead
from repro_torch.obs import trace
from repro_torch.resilience import Priority, ResilienceConfig, RetryPolicy
from repro_torch.video import VideoEngine

CSRC = Path(stage_ahead.__file__).resolve().parent / "csrc"
PIPE = "unsharp-m"
H, W = 12, 14
RNG = np.random.RandomState(32)


class FakeStager:
    """The stager's interface over plain tensors. ``auto``: a ticket is
    staged at ``put`` when a slot is free, and the oldest waiting one at
    each release; else only by :meth:`work` or a claim. :meth:`begin`
    marks tickets as being staged. A claim stages a ticket being staged,
    or pending with a slot free (:data:`WAITED`), and takes back a
    pending one with no slot free (:data:`TAKEN`), as the stager does."""
    made: list = []

    def __init__(self, device, slots, slot_bytes, threads=None):
        self.slots, self.slot_bytes = slots, slot_bytes
        self.auto = True
        self.queue, self.state, self.data = [], {}, {}
        self.frames, self.free = {}, list(range(slots))
        self.slot_of, self.next = {}, 1
        self.closed, self.max_held, self.claims = False, 0, []
        FakeStager.made.append(self)

    def put(self, frame, where):
        assert not self.closed
        addr, rows, row_bytes, pitch = where
        assert rows * row_bytes <= self.slot_bytes
        t, self.next = self.next, self.next + 1
        self.frames[t] = frame
        self.state[t] = "pending"
        self.queue.append(t)
        if self.auto:
            self.work()
        return t

    def work(self, n=None):
        while self.queue and self.free and (n is None or n > 0):
            t = self.queue.pop(0)
            self.slot_of[t] = self.free.pop(0)
            self.data[t] = torch.as_tensor(self.frames[t]).clone()
            self.state[t] = "issued"
            n = None if n is None else n - 1
        self.max_held = max(self.max_held, self.held)

    def begin(self, n):
        """The next ``n`` waiting tickets take slots and are being
        staged (their pixels are read when a claim waits for them)."""
        for t in self.queue[:n]:
            self.queue.remove(t)
            self.slot_of[t] = self.free.pop(0)
            self.state[t] = "staging"

    @property
    def held(self):
        return self.slots - len(self.free)

    def claim(self, tickets, dsts):
        out = []
        for t, d in zip(tickets, dsts):
            st = self.state.get(t)
            if st == "pending" and self.free:
                self.queue.remove(t)
                self.slot_of[t] = self.free.pop(0)
                st = "staging"
            if st == "staging":
                self.data[t] = torch.as_tensor(self.frames[t]).clone()
                self.state[t] = "issued"
                out.append(stage_ahead.WAITED)
            elif st == "issued":
                out.append(stage_ahead.AHEAD)
            else:
                if st == "pending":
                    self.queue.remove(t)
                    del self.state[t]
                out.append(stage_ahead.TAKEN)
            if out[-1] != stage_ahead.TAKEN:
                d.copy_(self.data[t])
        self.max_held = max(self.max_held, self.held)
        self.claims.append(out)
        return out

    def release(self, tickets):
        for t in tickets:
            st = self.state.pop(t, None)
            if st == "pending":
                self.queue.remove(t)
            elif st is not None:
                self.free.append(self.slot_of.pop(t))
                del self.data[t]
            self.frames.pop(t, None)
        if self.auto:
            self.work()

    def counts(self):
        return len(self.queue), self.held

    def close(self):
        self.closed = True

    @property
    def out(self):
        """Tickets not yet released."""
        return len(self.state)


@pytest.fixture
def fake(monkeypatch):
    """Admission on CPU engines sees a busy card; the stager is a
    :class:`FakeStager`. Yields the list of stagers made."""
    FakeStager.made = []
    monkeypatch.setattr(stage_ahead, "Stager", FakeStager)
    monkeypatch.setattr(FrameEngine, "_stages_ahead", lambda self: True)
    yield FakeStager.made


def _frames(n, h=H, w=W, dtype=np.float32):
    if dtype == np.uint8:
        return [RNG.randint(0, 256, (h, w)).astype(np.uint8)
                for _ in range(n)]
    return [RNG.rand(h, w).astype(dtype) for _ in range(n)]


def _reqs(frames, pipeline=PIPE, start=0):
    return [FrameRequest(rid=start + i, pipeline=pipeline, frames={"in": f})
            for i, f in enumerate(frames)]


def _engine(**kw):
    kw.setdefault("tile_shape", (16, 16))
    return FrameEngine(max_batch=kw.pop("max_batch", 2), device="cpu", **kw)


def _plain(frames, **kw):
    """Outputs of an engine with staging ahead off, by rid."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(FrameEngine, "_stages_ahead", lambda self: False)
        return _engine(**kw).run(_reqs(frames))


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _traced(fn):
    trace.clear()
    trace.enable()
    try:
        out = fn()
        return out, [e for e in trace.events()
                     if e.name == "engine.assemble"]
    finally:
        trace.disable()
        trace.clear()


# ---------------------------------------------------------------- who stages
def _case_host_float32(fake):
    eng = _engine()
    eng.submit(_reqs(_frames(1))[0])
    return 1


def _case_host_tensor(fake):
    eng = _engine()
    eng.submit(_reqs([torch.from_numpy(_frames(1)[0])])[0])
    return 1


def _case_strided_rows(fake):
    eng = _engine()
    base = _frames(1, H, 2 * W)[0]
    eng.submit(_reqs([base[:, 3:3 + W]])[0])        # rows with a pitch
    return 1


def _case_unorm8(fake):
    eng = _engine(pixels="unorm8")
    eng.submit(_reqs(_frames(1, dtype=np.uint8))[0])
    return 1


def _case_tiled(fake):
    eng = _engine()
    eng.submit(_reqs(_frames(1, 20, 24))[0])        # larger than the tile
    return 1


def _case_float64(fake):
    eng = _engine()
    eng.submit(_reqs(_frames(1, dtype=np.float64))[0])
    return 0


def _case_flipped(fake):
    eng = _engine()
    eng.submit(_reqs([_frames(1)[0][::-1]])[0])
    return 0


def _case_column_strided(fake):
    eng = _engine()
    eng.submit(_reqs([_frames(1, H, 2 * W)[0][:, ::2]])[0])
    return 0


def _case_device_resident(fake):
    """A frame on a device (the meta device stands in for the card)."""
    eng = _engine()
    req = _reqs([torch.empty((H, W), device="meta")])[0]
    eng._stage_ahead(req)
    return 0


WHO = {
    "host-float32": _case_host_float32,
    "host-cpu-tensor": _case_host_tensor,
    "strided-rows": _case_strided_rows,
    "unorm8": _case_unorm8,
    "tiled": _case_tiled,
    "float64": _case_float64,
    "flipped": _case_flipped,
    "column-strided": _case_column_strided,
    "device-resident": _case_device_resident,
}


@pytest.mark.parametrize("case", sorted(WHO))
def test_only_host_untiled_frames_of_the_engines_type_are_staged(fake, case):
    """Host frames of the engine's type whose rows the stager can read,
    tiled or not; nothing else."""
    want = WHO[case](fake)
    puts = sum(s.next - 1 for s in fake)
    assert puts == want


@pytest.mark.parametrize("where", ["idle-host", "cpu-engine"])
def test_an_idle_host_or_a_cpu_engine_stages_nothing(monkeypatch, where):
    """Unpatched admission: a CPU engine never stages; on a card, an idle
    host does not (the engine's run rule, ``FrameEngine._host_busy``)."""
    FakeStager.made = []
    monkeypatch.setattr(stage_ahead, "Stager", FakeStager)
    if where == "idle-host":
        monkeypatch.setattr(FrameEngine, "device",
                            property(lambda self: torch.device("cuda")))
        eng = _engine()
        assert not eng._host_busy()
        eng._stage_ahead(_reqs(_frames(1))[0])
    else:
        monkeypatch.setattr(FrameEngine, "WARM_S", float("inf"))
        eng = _engine()
        eng._run, eng._last_hand_over = FrameEngine.RUN, 0.0
        assert eng._host_busy()
        frames = _frames(3)
        _same(eng.run(_reqs(frames)), _plain(frames))
    assert FakeStager.made == []


def test_frames_in_the_stagers_hands_keep_admission_staging(monkeypatch):
    """On a card, admission stages ahead while the engine's run rule says
    the host is busy or the stager still holds frames of the engine; an
    idle host with nothing in its hands stages nothing."""
    FakeStager.made = []
    monkeypatch.setattr(stage_ahead, "Stager", FakeStager)
    monkeypatch.setattr(FrameEngine, "device",
                        property(lambda self: torch.device("cuda")))
    busy = {"now": True}
    monkeypatch.setattr(FrameEngine, "_host_busy",
                        lambda self: busy["now"])
    eng = _engine()
    reqs = _reqs(_frames(3))
    eng._stage_ahead(reqs[0])
    busy["now"] = False                    # a late step reset the rule
    eng._stage_ahead(reqs[1])
    (s,) = FakeStager.made
    assert s.next - 1 == 2
    eng._release(reqs[:2])
    eng._stage_ahead(reqs[2])              # nothing held: the rule alone
    assert s.next - 1 == 2 and eng._ahead == {}


def test_the_busy_rule_is_the_hand_overs(monkeypatch):
    """``_host_busy`` is true exactly when a hand-over begun now is the
    ``RUN + 1``-th or later of a run, as the engine's hand-over counts
    it."""
    monkeypatch.setattr(engine_module, "_now", lambda: 10.0)
    run_ = FrameEngine.RUN
    eng = _engine()
    for run, last, want in ((run_ - 1, 9.999, True), (run_ - 2, 9.999, False),
                            (run_ - 1, 9.99, False),
                            (run_ + 5, 9.9995, True)):
        eng._run, eng._last_hand_over = run, last
        assert eng._host_busy() == want
        eng._hand_over(PIPE, _reqs(_frames(1)), 2)
        assert (eng._run >= run_) == want
        assert eng._last_hand_over == 10.0


# ------------------------------------------------------------- the ring
@pytest.mark.parametrize("max_batch", [1, 2, 3])
def test_never_more_than_two_batches_are_held(fake, max_batch):
    frames = _frames(5 * max_batch + 1)
    eng = _engine(max_batch=max_batch)
    got = eng.run(_reqs(frames))
    _same(got, _plain(frames, max_batch=max_batch))
    (s,) = fake
    assert s.slots == 2 * max_batch and s.slot_bytes == 4 * H * W
    assert s.max_held == 2 * max_batch and s.out == 0
    assert eng._ahead == {}


def test_a_frame_with_no_slot_free_is_taken_back_and_staged_inline(fake):
    """The ring is full of another pipeline's frames when a batch claims
    a frame not yet started: it is taken back and handed over inline;
    the frame staged ahead beside it is claimed."""
    xs, ys = _frames(2), _frames(3)
    eng = _engine()
    eng.submit(_reqs(xs[:1])[0])
    for r in _reqs(ys, pipeline="canny-s", start=10):
        eng.submit(r)
    (s,) = fake
    assert s.held == 4
    s.auto = False
    eng.submit(_reqs(xs, start=0)[1])
    res, spans = _traced(eng.step)
    assert s.claims == [[stage_ahead.AHEAD, stage_ahead.TAKEN]]
    _same({r.rid: r.output for r in res}, _plain(xs))
    (sp,) = spans
    assert sp.attrs["ahead_bytes"] == 4 * H * W
    s.auto = True
    eng.run([])
    assert s.out == 0 and s.queue == []


def test_a_frame_not_started_with_a_slot_free_is_waited_for(fake):
    frames = _frames(2)
    eng = _engine()
    reqs = _reqs(frames)
    eng.submit(reqs[0])
    (s,) = fake
    s.auto = False
    eng.submit(reqs[1])
    res = eng.step()
    assert s.claims == [[stage_ahead.AHEAD, stage_ahead.WAITED]]
    _same({r.rid: r.output for r in res}, _plain(frames))
    assert s.out == 0


def test_a_frame_being_staged_is_waited_for(fake):
    frames = _frames(2)
    eng = _engine()
    reqs = _reqs(frames)
    eng.submit(reqs[0])
    (s,) = fake
    s.auto = False
    eng.submit(reqs[1])
    s.begin(1)
    res, spans = _traced(eng.step)
    assert s.claims == [[stage_ahead.AHEAD, stage_ahead.WAITED]]
    _same({r.rid: r.output for r in res}, _plain(frames))
    (sp,) = spans
    assert sp.attrs["ahead_bytes"] == 4 * H * W
    assert sp.attrs["pinned_bytes"] == 2 * 4 * H * W
    assert s.out == 0


def test_a_partial_batch_mixes_tickets_and_frames_without(fake):
    """A request admitted while the host was idle (no ticket) shares a
    batch with ones staged ahead; the idle slot is zero."""
    frames = _frames(3)
    eng = _engine(max_batch=4)
    reqs = _reqs(frames)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(FrameEngine, "_stages_ahead", lambda self: False)
        eng.submit(reqs[0])
    eng.submit(reqs[1])
    eng.submit(reqs[2])
    res = eng.step()
    (s,) = fake
    assert s.claims == [[stage_ahead.AHEAD, stage_ahead.AHEAD]]
    _same({r.rid: r.output for r in res}, _plain(frames, max_batch=4))


def test_the_ring_is_remade_for_a_larger_frame_once_it_is_free(fake):
    small, large = _frames(2, 8, 8), _frames(2, 12, 14)
    eng = _engine()
    eng.submit(_reqs(small)[0])
    (s0,) = fake
    s0.auto = False
    eng.submit(_reqs(large, start=10)[0])     # the small ring has a ticket
    assert len(fake) == 1 and s0.next == 2
    eng.submit(_reqs(small, start=20)[1])     # the ring takes no more
    assert len(fake) == 1 and s0.next == 2
    eng.step()
    assert s0.out == 0
    eng.submit(_reqs(large, start=30)[1])
    assert len(fake) == 2 and s0.closed
    assert fake[1].slot_bytes == 4 * 12 * 14 and fake[1].next == 2
    eng.run([])
    assert eng._ahead == {}


def test_a_tiled_request_is_staged_ahead_and_equals_the_plain_path(fake):
    """Frames larger than ``tile_shape`` on a busy card: staged ahead,
    claimed by the tiled rung's hand-over (one batch of the step's
    frames) and served bit for bit as by an engine that stages
    nothing."""
    frames = _frames(3, 20, 24)
    eng = _engine()
    got, spans = _traced(lambda: eng.run(_reqs(frames)))
    _same(got, _plain(frames))
    (s,) = fake
    assert s.next - 1 == 3 and s.slot_bytes == 4 * 20 * 24
    assert s.claims == [[stage_ahead.AHEAD] * 2, [stage_ahead.AHEAD]]
    assert [(sp.attrs["pinned_bytes"], sp.attrs["ahead_bytes"])
            for sp in spans] == [(2 * 4 * 20 * 24,) * 2, (4 * 20 * 24,) * 2]
    assert s.out == 0 and eng._ahead == {}


# ------------------------------------------------------- release on exit
def _raising_executor(eng, fails):
    """Make the engine's executors raise on their first ``fails`` calls."""
    calls = {"n": 0}
    real = eng.cache.executor_for

    def executor_for(*a, **kw):
        ex = real(*a, **kw)

        def call(inputs):
            calls["n"] += 1
            if calls["n"] <= fails:
                raise RuntimeError("injected executor fault")
            return ex(inputs)
        call.smem_bytes = ex.smem_bytes
        return call
    eng.cache.executor_for = executor_for
    return calls


def test_slots_are_released_on_delivery(fake):
    eng = _engine()
    frames = _frames(4)
    for r in _reqs(frames):
        eng.submit(r)
    (s,) = fake
    assert s.out == 4
    eng.step()
    assert s.out == 2
    eng.step()
    assert s.out == 0 and eng._ahead == {}


def test_slots_are_released_on_an_executor_exception(fake):
    eng = _engine()
    _raising_executor(eng, 1)
    for r in _reqs(_frames(2)):
        eng.submit(r)
    res = eng.step()
    assert [type(r).__name__ for r in res] == ["FailedFrame"] * 2
    (s,) = fake
    assert s.out == 0 and eng._ahead == {}


def test_a_ladder_retry_claims_the_same_slots_again(fake):
    frames = _frames(2)
    eng = _engine(resilience=ResilienceConfig(
        retry=RetryPolicy(max_attempts=2, base_delay_s=0.0)))
    calls = _raising_executor(eng, 1)
    for r in _reqs(frames):
        assert eng.submit(r) is True
    res = eng.step()
    (s,) = fake
    assert calls["n"] == 2
    assert s.claims == [[stage_ahead.AHEAD] * 2] * 2
    assert [r.rung for r in res] == ["default"] * 2
    _same({r.rid: r.output for r in res}, _plain(frames))
    assert s.out == 0 and eng._ahead == {}


def test_slots_are_released_when_the_ladder_ends_on_the_reference(fake):
    frames = _frames(2)
    eng = _engine(resilience=ResilienceConfig(
        retry=RetryPolicy(max_attempts=1, base_delay_s=0.0)))
    _raising_executor(eng, 10)
    for r in _reqs(frames):
        eng.submit(r)
    res = eng.step()
    (s,) = fake
    assert [r.rung for r in res] == ["reference"] * 2
    _same({r.rid: r.output for r in res}, _plain(frames))
    assert s.out == 0


def test_unorm8_reference_rung_claims_its_frames(fake):
    frames = _frames(2, dtype=np.uint8)
    eng = _engine(pixels="unorm8", resilience=ResilienceConfig(
        retry=RetryPolicy(max_attempts=1, base_delay_s=0.0)))
    _raising_executor(eng, 10)
    for r in _reqs(frames):
        eng.submit(r)
    res = eng.step()
    (s,) = fake
    assert s.claims[-1] == [stage_ahead.AHEAD] * 2
    with pytest.MonkeyPatch.context() as m:
        m.setattr(FrameEngine, "_stages_ahead", lambda self: False)
        want = _engine(pixels="unorm8").run(_reqs(frames))
    _same({r.rid: r.output for r in res}, want)
    assert s.out == 0


def test_slots_are_released_on_shed_and_expiry(fake):
    """Two low-priority residents fill the queue; a high-priority one
    sheds one of them, a second (already past its deadline) the other,
    and the step's sweep sheds it as expired: each leaves its slot."""
    eng = _engine(max_pending=2, resilience=ResilienceConfig(
        default_deadline_s=60.0))
    reqs = _reqs(_frames(4))
    for r in reqs[:2]:
        r.priority = Priority.LOW
        assert eng.submit(r) is True
    (s,) = fake
    assert s.out == 2
    reqs[2].priority = reqs[3].priority = Priority.HIGH
    reqs[3].deadline_s = -1.0
    for k, r in enumerate(reqs[2:]):
        assert eng.submit(r) is True
        assert eng.metrics.frames_shed == k + 1 and s.out == 2
    res = eng.step()
    assert sorted((type(r).__name__, r.rid) for r in res) == [
        ("CompletedFrame", 2), ("ShedFrame", 0), ("ShedFrame", 1),
        ("ShedFrame", 3)]
    assert s.out == 0 and eng._ahead == {}


# ------------------------------------------------------------- counters
def test_the_counters_nest_on_every_span(fake):
    """ahead_bytes <= pinned_bytes <= h2d_bytes on each ``engine.assemble``
    span, whichever way its frames went."""
    frames = _frames(9)
    eng = _engine(max_batch=3)

    def run():
        reqs = _reqs(frames)
        for r in reqs[:3]:
            eng.submit(r)
        (s,) = fake
        s.auto = False
        for r in reqs[3:]:
            eng.submit(r)
        s.work(2)
        s.begin(1)
        out = {r.rid: r.output for r in eng.step()}
        s.work(1)
        out.update({r.rid: r.output for r in eng.step()})
        s.auto = True
        out.update(eng.run([]))
        return out
    got, spans = _traced(run)
    _same(got, _plain(frames, max_batch=3))
    assert len(spans) == 3
    for sp in spans:
        a = sp.attrs
        assert 0 <= a["ahead_bytes"] <= a["pinned_bytes"] <= a["h2d_bytes"]
    assert spans[0].attrs["ahead_bytes"] == 3 * 4 * H * W


def test_device_frames_and_the_video_engine_never_touch_the_stager(
        monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("the stager was made")
    monkeypatch.setattr(stage_ahead, "Stager", boom)
    monkeypatch.setattr(FrameEngine, "_stages_ahead", lambda self: True)
    eng = _engine()
    eng._stage_ahead(_reqs([torch.empty((H, W), device="meta")])[0])
    veng = VideoEngine(chunk=2, device="cpu")
    sid = veng.open_stream("tdenoise-t", H, W)
    out = veng.run({sid: [{"in": f} for f in _frames(3)]})
    assert len(out[sid]) == 3


# ------------------------------------------------- the C++ on the host
_FAKE_CUDA = r"""
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>
typedef int cudaError_t;
enum { cudaSuccess = 0 };
enum cudaMemcpyKind { cudaMemcpyHostToDevice = 1,
                      cudaMemcpyDeviceToDevice = 3 };
enum { cudaStreamNonBlocking = 1, cudaEventDisableTiming = 2 };
struct FakeStream;
struct FakeOp { void* dst; const void* src; size_t n;
                FakeStream* ws; long long wpos; std::vector<char> at_queue; };
struct FakeStream { std::deque<FakeOp> q; long long done = 0, queued = 0; };
struct FakeEvent { FakeStream* s = nullptr; long long pos = 0; };
typedef FakeStream* cudaStream_t;
typedef FakeEvent* cudaEvent_t;
static std::recursive_mutex fake_mu;
static long long fake_copies = 0;
static void fake_flush(FakeStream* s, long long upto) {
  while (s->done < upto) {
    FakeOp op = s->q.front();
    s->q.pop_front();
    if (op.ws) fake_flush(op.ws, op.wpos);
    else if (op.at_queue.empty()) memcpy(op.dst, op.src, op.n);
    else if (memcmp(op.src, op.at_queue.data(), op.n) == 0)
      memcpy(op.dst, op.src, op.n);
    else memset(op.dst, 0xFF, op.n);
    ++s->done;
  }
}
static cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
static cudaError_t cudaSetDevice(int) { return 0; }
static cudaError_t cudaStreamCreateWithFlags(cudaStream_t* s, int) {
  *s = new FakeStream; return 0; }
static cudaError_t cudaStreamSynchronize(cudaStream_t s) {
  std::lock_guard<std::recursive_mutex> lk(fake_mu);
  fake_flush(s, s->queued); return 0; }
static cudaError_t cudaStreamDestroy(cudaStream_t s) {
  cudaStreamSynchronize(s); delete s; return 0; }
static cudaError_t cudaEventCreateWithFlags(cudaEvent_t* e, int) {
  *e = new FakeEvent; return 0; }
static cudaError_t cudaEventDestroy(cudaEvent_t e) { delete e; return 0; }
static cudaError_t cudaEventRecord(cudaEvent_t e, cudaStream_t s) {
  std::lock_guard<std::recursive_mutex> lk(fake_mu);
  e->s = s; e->pos = s->queued; return 0; }
static cudaError_t cudaEventSynchronize(cudaEvent_t e) {
  std::lock_guard<std::recursive_mutex> lk(fake_mu);
  if (e->s) fake_flush(e->s, e->pos);
  return 0; }
static cudaError_t cudaStreamWaitEvent(cudaStream_t s, cudaEvent_t e,
                                       unsigned) {
  std::lock_guard<std::recursive_mutex> lk(fake_mu);
  if (e->s) { s->q.push_back({nullptr, nullptr, 0, e->s, e->pos, {}});
              ++s->queued; }
  return 0; }
static cudaError_t cudaMemcpyAsync(void* dst, const void* src, size_t n,
                                   cudaMemcpyKind kind, cudaStream_t s) {
  std::lock_guard<std::recursive_mutex> lk(fake_mu);
  if (kind == cudaMemcpyDeviceToDevice) ++fake_copies;
  std::vector<char> at_queue;
  if (kind == cudaMemcpyHostToDevice)
    at_queue.assign(static_cast<const char*>(src),
                    static_cast<const char*>(src) + n);
  s->q.push_back({dst, src, n, nullptr, 0, std::move(at_queue)});
  ++s->queued; return 0; }
extern "C" const char* stencil_pipeline_error_string(int) {
  return "fake CUDA error"; }
extern "C" void* fake_stream() { return new FakeStream; }
extern "C" void fake_sync(void* s) {
  cudaStreamSynchronize(static_cast<cudaStream_t>(s)); }
extern "C" long long fake_gathers() { return fake_copies; }
"""

_HOST_LIBS: dict[str, ctypes.CDLL] = {}


def host_stager_library(tmp_path_factory, source: str | None = None):
    """The stager's section of ``csrc/stencil_pipeline.cu`` (or of
    ``source``) compiled for the host over :data:`_FAKE_CUDA`."""
    src = source if source is not None \
        else (CSRC / "stencil_pipeline.cu").read_text()
    lib = _HOST_LIBS.get(src)
    if lib is not None:
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    body = src[src.index("// ---- stage ahead: begin"):
               src.index("// ---- stage ahead: end")]
    d = tmp_path_factory.mktemp("host_stager")
    (d / "s.cpp").write_text(_FAKE_CUDA + body)
    subprocess.run([cxx, "-O1", "-std=c++17", "-pthread", "-shared", "-fPIC",
                    "-o", str(d / "s.so"), str(d / "s.cpp")], check=True,
                   capture_output=True)
    lib = _HOST_LIBS[src] = ctypes.CDLL(str(d / "s.so"))
    lib.fake_stream.restype = ctypes.c_void_p
    lib.fake_sync.argtypes = [ctypes.c_void_p]
    lib.fake_gathers.restype = ctypes.c_longlong
    return lib


@pytest.fixture
def host_stager(tmp_path_factory, monkeypatch):
    """``stage_ahead.Stager`` over the host build, its slots CPU tensors
    and its caller's stream a fake one. Yields (make, lib, stream)."""
    lib = host_stager_library(tmp_path_factory)
    stream = lib.fake_stream()
    monkeypatch.setattr(stage_ahead, "_library",
                        lambda: stage_ahead._bind(lib))
    monkeypatch.setattr(stage_ahead, "_ring", lambda device, slots, n: (
        torch.full((slots, n), 0xEE, dtype=torch.uint8),
        torch.full((slots, n), 0xDD, dtype=torch.uint8)))
    monkeypatch.setattr(stage_ahead, "_stream", lambda device: stream)
    monkeypatch.setattr(stage_ahead, "_index", lambda device: 0)

    def make(slots, slot_bytes, threads):
        return stage_ahead.Stager(torch.device("cpu"), slots, slot_bytes,
                                  threads)
    yield make, lib, stream


def _threads() -> int:
    return len(os.listdir("/proc/self/task"))


def _settle(stager, counts):
    """Wait (at most 10 s) until ``stager.counts()`` reads ``counts``."""
    t0 = time.perf_counter()
    while stager.counts() != counts:
        assert time.perf_counter() - t0 < 10, stager.counts()
        time.sleep(0.0005)


def _put_all(stager, frames):
    return [stager.put(f, stage_ahead.layout(f, torch.float32))
            for f in frames]


@pytest.mark.parametrize("threads", [1, 3, 7])
@pytest.mark.parametrize("slots", [2, 8])
@pytest.mark.parametrize("n,h,w", [(200, 37, 53), (48, 300, 480)],
                         ids=["one-chunk", "three-chunks"])
def test_host_stager_serves_every_frame_in_order(host_stager, threads,
                                                 slots, n, h, w):
    """``n`` frames of distinct pixels, some with a row pitch, through a
    ring of ``slots``: batches of four claimed, gathered on the lazy
    stream and released with no synchronise until the end; each output
    is its frame, byte for byte; no more than ``slots`` held. A 300x480
    frame is three of the team's chunks."""
    make, lib, stream = host_stager
    st = make(slots, 4 * h * w, threads)
    base = np.random.RandomState(7).rand(n, h, w + 3).astype(np.float32)
    frames = [base[i, :, :w] if i % 3 else
              np.ascontiguousarray(base[i, :, :w]) for i in range(n)]
    tickets = _put_all(st, frames)
    outs = torch.full((n // 4, 4, h, w), float("nan"))
    found, held = [], 0
    for b in range(n // 4):
        ids = tickets[4 * b:4 * b + 4]
        found += st.claim(ids, [outs[b, i] for i in range(4)])
        held = max(held, st.counts()[1])
        for i, s in enumerate(found[-4:]):
            if s == stage_ahead.TAKEN:
                outs[b, i].copy_(torch.from_numpy(frames[4 * b + i]))
        st.release(ids)
    lib.fake_sync(stream)
    assert held <= slots
    assert all(torch.equal(outs[b, i], torch.from_numpy(frames[4 * b + i]))
               for b in range(n // 4) for i in range(4))
    assert found.count(stage_ahead.TAKEN) < n
    assert st.counts() == (0, 0)
    st.close()


def test_host_stager_takes_back_and_claims_again(host_stager):
    """With both slots held, later tickets wait: claimed, they are taken
    back (then unknown); a held ticket is claimed again; releasing twice
    or an unknown ticket is harmless."""
    make, lib, stream = host_stager
    st = make(2, 4 * 16, 2)
    frames = [np.full((4, 4), k, np.float32) for k in range(4)]
    t = _put_all(st, frames)
    _settle(st, (2, 2))
    out = torch.zeros(4, 4, 4)
    claimed = (stage_ahead.AHEAD, stage_ahead.WAITED)    # the 2nd may be
    got = st.claim(t, list(out))                        # in the team's hands
    assert got[0] in claimed and got[1] in claimed
    assert got[2:] == [stage_ahead.TAKEN] * 2
    assert st.counts() == (0, 2)
    assert st.claim(t[:3], list(out[:3])) == [stage_ahead.AHEAD] * 2 \
        + [stage_ahead.TAKEN]
    lib.fake_sync(stream)
    assert [float(o[0, 0]) for o in out[:2]] == [0.0, 1.0]
    st.release(t)
    st.release(t + [12345])
    assert st.counts() == (0, 0)
    st.close()


def test_host_stager_gathers_neighbouring_slots_in_one_copy(host_stager):
    make, lib, stream = host_stager
    st = make(8, 4 * 6 * 5, 4)
    frames = [np.full((6, 5), k, np.float32) for k in range(8)]
    t = _put_all(st, frames)
    _settle(st, (0, 8))
    out = torch.zeros(8, 6, 5)
    before = lib.fake_gathers()
    st.claim(t[:4], list(out[:4]))
    assert lib.fake_gathers() - before == 1          # slots 0-3 as one
    st.claim([t[5], t[4]], [out[4], out[5]])
    assert lib.fake_gathers() - before == 3          # out of order: two
    lib.fake_sync(stream)
    assert [float(o[0, 0]) for o in out[:6]] == [0, 1, 2, 3, 5, 4]
    st.release(t)
    st.close()


def test_host_stager_threads_end_with_it(host_stager):
    make, lib, stream = host_stager
    gc.collect()
    before = _threads()
    st = make(4, 4 * 64, 5)
    assert _threads() >= before + 5
    _put_all(st, [np.ones((8, 8), np.float32)] * 6)
    del st
    gc.collect()
    assert _threads() == before


def test_host_stager_with_the_engine_path(host_stager, monkeypatch):
    """The real stager's C++ behind a CPU engine whose admission sees a
    busy card: every output equals the plain path."""
    make, lib, stream = host_stager
    monkeypatch.setattr(FrameEngine, "_stages_ahead", lambda self: True)
    orig = stage_ahead.Stager.claim

    def claim(self, tickets, dsts):         # the caller's stream, synced
        out = orig(self, tickets, dsts)
        lib.fake_sync(stream)
        return out
    monkeypatch.setattr(stage_ahead.Stager, "claim", claim)
    frames = _frames(11)
    eng = _engine(max_batch=3)
    got = eng.run(_reqs(frames))
    _same(got, _plain(frames, max_batch=3))
    assert eng._stager.counts() == (0, 0)
