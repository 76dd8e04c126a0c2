"""The hand-over of host frames to the card (``_device.hand_over``), on
the CPU.

The page-locked pair is replaced by two plain CPU tensors, so the slot
logic and the choice of path run as they do for a card: each case
compares what lands in the card's buffer with ``torch.as_tensor(...,
dtype=float32)``, bit for bit. CPU engines stage nothing: they keep
``torch.as_tensor``.
"""
import gc
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

from repro_torch import _device
from repro_torch._device import hand_over, stage_into
from repro_torch.imaging import FrameEngine, FrameRequest
from repro_torch.obs import trace
from repro_torch.video import VideoEngine

CARD = torch.device("cuda")          # a device object only: nothing runs
RNG = np.random.RandomState(29)


@pytest.fixture
def fake_card(monkeypatch):
    """Hand-overs to ``CARD`` staged, with plain CPU tensors as their
    buffer pair, poisoned with NaN so a slot left unwritten shows; the
    pageable path (after an idle host) on the CPU. Yields the buffers
    made, held by weak references."""
    made = []

    def pair(device, shape, dtype=torch.float32):
        bufs = (torch.full(shape, float("nan"), dtype=dtype),
                torch.full(shape, float("nan"), dtype=dtype))
        made.extend(weakref.ref(b) for b in bufs)
        return bufs
    stacked = _device._stacked
    monkeypatch.setattr(_device, "page_locked_pair", pair)
    monkeypatch.setattr(_device, "_stacked",
                        lambda fs, slots, device, dtype=torch.float32:
                        stacked(fs, slots, torch.device("cpu"), dtype))
    monkeypatch.setattr(_device, "WARM_S", float("inf"))
    monkeypatch.setattr(_device, "_last_hand_over", 0.0)
    monkeypatch.setattr(_device, "_run", _device.RUN)
    yield made


def _frames(n, h, w, dtype=np.float32):
    return [RNG.rand(h, w).astype(dtype) for _ in range(n)]


def _expected(frames, slots):
    ts = [torch.as_tensor(f.copy(), dtype=torch.float32) for f in frames]
    ts += [torch.zeros_like(ts[0])] * (slots - len(ts))
    return torch.stack(ts)


def _stage(frames, slots):
    h, w = np.shape(frames[0])
    host = torch.full((slots, h, w), float("nan"))
    dev = torch.full((slots, h, w), float("nan"))
    n = stage_into(frames, host, dev)
    return dev, n


def _full_batch(made):
    frames = _frames(3, 5, 7)
    dev, n = _stage(frames, 3)
    assert torch.equal(dev, _expected(frames, 3)) and n == 4 * 3 * 5 * 7


def _partial_batch(made):
    frames = _frames(2, 5, 7)
    dev, n = _stage(frames, 4)
    assert torch.equal(dev, _expected(frames, 4))
    assert not dev[2:].any() and n == 4 * 2 * 5 * 7


def _float64(made):
    # digits beyond float32's, so the conversion rounds
    frames = [RNG.rand(6, 9) * (1 + 1e-9) for _ in range(2)]
    dev, n = _stage(frames, 2)
    assert torch.equal(dev, _expected(frames, 2)) and n == 4 * 2 * 6 * 9


def _non_contiguous(made):
    """Strided views, and flipped frames (negative strides), by either
    path."""
    base = RNG.rand(12, 16).astype(np.float32)
    frames = [base[::2, 1::2], base[:8, :6].T[:6, :8], base[5::-1, :8],
              base[:6, 7::-1]]
    assert not any(f.flags.c_contiguous for f in frames)
    dev, _ = _stage(frames, 4)
    assert torch.equal(dev, _expected(frames, 4))
    staged = hand_over({"in": frames}, 5, CARD)["in"]
    assert torch.equal(staged, _expected(frames, 5))
    _device._last_hand_over = -float("inf")          # an idle host
    paged = hand_over({"in": frames}, 5, CARD)["in"]
    assert torch.equal(paged, _expected(frames, 5))


def _heights(h):
    """Partial batches and lone frames ``h`` rows high."""
    def case(made):
        for n, slots in ((2, 4), (3, 4), (1, 1)):
            frames = _frames(n, h, 5)
            got = hand_over({"in": frames}, slots, CARD)["in"]
            assert torch.equal(got, _expected(frames, slots))
        assert len(made) == 2 * 3
    return case


def _two_shapes_in_turn(made):
    a1, b, a2 = _frames(3, 5, 7), _frames(2, 6, 4), _frames(2, 5, 7)
    for frames in (a1, b, a2):
        got = hand_over({"in": frames}, 3, CARD)["in"]
        assert torch.equal(got, _expected(frames, 3))


def _many_shapes_retain_nothing(made):
    """Shape-diverse traffic keeps no buffer: the page-locked one dies
    with the call, the card's with the caller's last reference."""
    outs = [hand_over({"a": _frames(2, 3 + k, 4 + k),
                       "b": _frames(2, 3 + k, 4 + k)}, 3, CARD)
            for k in range(20)]
    gc.collect()
    host = made[0::2]
    assert len(made) == 2 * 2 * 20
    assert not any(r() is not None for r in host)
    del outs
    gc.collect()
    assert not any(r() is not None for r in made)


def _idle_host_goes_pageable(made):
    """A card's hand-over is staged only after ``RUN`` before it in a
    row, each begun within ``WARM_S`` of the previous one's end, whatever
    its path."""
    starts = [10.0, 10.001, 10.002, 10.003, 10.004, 10.005,
              10.5, 10.501, 10.502, 10.503, 10.5055, 10.506, 10.507, 10.508,
              10.509, 10.510]
    clock = iter(t for s in starts for t in (s, s))    # begin, end
    _device._now, now = lambda: next(clock), _device._now
    _device.WARM_S, _device._last_hand_over = 0.002, -float("inf")
    frames = [_frames(2, 4, 4) for _ in starts]
    try:
        got = [hand_over({"in": fs}, 3, CARD)["in"] for fs in frames]
    finally:
        _device._now = now
    assert all(torch.equal(g, _expected(fs, 3))
               for g, fs in zip(got, frames))
    # staged: the fifth and sixth of the first run; the last two of the
    # second, whose fifth began 2.5 ms after the one before it ended and
    # so began a run anew
    assert _device.RUN == 4 and len(made) == 2 * 4


def _spans_count_the_staged_bytes(made):
    trace.clear()
    trace.enable()
    try:
        hand_over({"a": _frames(3, 5, 7), "b": _frames(3, 5, 7, np.float64)},
                  4, CARD, pipeline="p")
        hand_over({"a": [torch.as_tensor(f) for f in _frames(2, 5, 7)]}, 2,
                  CARD, pipeline="p")
        _device._last_hand_over = -float("inf")      # an idle host
        hand_over({"a": _frames(1, 5, 7)}, 1, CARD, pipeline="p")
        hand_over({"a": _frames(1, 5, 7)}, 1, torch.device("cpu"),
                  pipeline="p")
        spans = [e for e in trace.events() if e.name == "engine.assemble"]
    finally:
        trace.disable()
        trace.clear()
    assert [(e.attrs["h2d_bytes"], e.attrs["pinned_bytes"]) for e in spans] \
        == [(4 * 6 * 35,) * 2, (4 * 2 * 35,) * 2, (4 * 35, 0), (4 * 35, 0)]
    assert all(e.attrs["pipeline"] == "p" for e in spans)


CASES = {
    "full-batch": _full_batch,
    "partial-batch-idle-slots-zero": _partial_batch,
    "float64": _float64,
    "non-contiguous": _non_contiguous,
    "heights-h1": _heights(1),
    "heights-h37": _heights(37),
    "heights-h1080": _heights(1080),
    "two-shapes-in-turn": _two_shapes_in_turn,
    "many-shapes-retain-nothing": _many_shapes_retain_nothing,
    "idle-host-goes-pageable": _idle_host_goes_pageable,
    "spans-pinned-equal-h2d": _spans_count_the_staged_bytes,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_staging(fake_card, case):
    CASES[case](fake_card)


def test_frames_of_another_shape_are_refused():
    with pytest.raises(ValueError, match="slots take"):
        _stage([np.zeros((5, 7)), np.zeros((1, 7))], 2)
    with pytest.raises(ValueError, match="exceeds 1 slots"):
        _stage(_frames(2, 5, 7), 1)
    with pytest.raises(ValueError, match="exceeds 1 slots"):
        hand_over({"in": _frames(2, 5, 7)}, 1, torch.device("cpu"))


def test_cpu_engines_stage_nothing(monkeypatch):
    """CPU engines keep ``torch.as_tensor``: no buffer, no staged byte,
    and a lone float32 frame is the caller's own memory. The video engine
    does not hand over through :func:`hand_over` (its spans carry no
    ``pinned_bytes``); the frame engine's two batches do."""
    def boom(*a, **kw):
        raise AssertionError("a CPU engine staged a frame")
    monkeypatch.setattr(_device, "stage_into", boom)
    monkeypatch.setattr(_device, "page_locked_pair", boom)
    monkeypatch.setattr(_device, "WARM_S", float("inf"))
    monkeypatch.setattr(_device, "_last_hand_over", 0.0)
    trace.clear()
    trace.enable()
    try:
        feng = FrameEngine(max_batch=3, tile_shape=(16, 16), device="cpu")
        res = feng.run([FrameRequest(rid=i, pipeline="unsharp-m",
                                     frames={"in": f})
                        for i, f in enumerate(_frames(2, 12, 14)
                                              + _frames(1, 20, 24))])
        veng = VideoEngine(chunk=2, device="cpu")
        sid = veng.open_stream("tdenoise-t", 12, 14)
        vres = veng.run({sid: [{"in": f} for f in _frames(3, 12, 14)]})
        spans = [e for e in trace.events() if e.name == "engine.assemble"]
    finally:
        trace.disable()
        trace.clear()
    assert len(res) == 3 and len(vres[sid]) == 3
    assert spans and all(e.attrs.get("pinned_bytes", 0) == 0
                         < e.attrs["h2d_bytes"] for e in spans)
    assert sum("pinned_bytes" in e.attrs for e in spans) == 2
    f = _frames(1, 6, 5)[0]
    assert hand_over({"in": [f]}, 1, torch.device("cpu"))["in"][0] \
        .data_ptr() == f.ctypes.data


def test_concurrent_hand_overs_never_share_buffers(fake_card):
    """More threads than cores hand frames over at once: each reads its
    own frames back unchanged, so no hand-over writes into buffers
    another still reads (a resilient engine's abandoned attempt runs on
    beside the next one)."""
    frames = _frames(16, 9, 11)
    errors = []

    def worker(k):
        try:
            for _ in range(50):
                mine = [frames[k], frames[k - 1]]
                got = hand_over({"in": mine}, 2, CARD)["in"]
                for _ in range(3):
                    if not torch.equal(got, _expected(mine, 2)):
                        errors.append(k)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(len(frames))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
