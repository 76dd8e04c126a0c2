"""The hand-over of host frames to the card (``imaging/hand_over.py``),
and ``FrameEngine``'s run rule, on the CPU.

A hand-over to ``CARD`` lands on the CPU: the claim's buffers are CPU
tensors poisoned with NaN (0xA5 for bytes), so a slot left unwritten
shows, and ``torch.as_tensor`` stacks on the CPU. Each case runs every
way a frame can go: by ``torch.as_tensor`` with no ticket, and with a
ticket of ``tests/test_torch_stage_ahead.py``'s ``FakeStager``, claimed
ahead, waited for, taken back, or beside frames without one; what lands
is compared with ``torch.as_tensor(..., dtype=float32)``, bit for bit.
CPU engines stage nothing: they keep ``torch.as_tensor``.
"""
import ast
import gc
import os
import subprocess
import sys
import threading
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.imaging import FrameEngine, FrameRequest
from repro_torch.imaging import engine as engine_module
from repro_torch.imaging import hand_over as ho
from repro_torch.imaging.hand_over import hand_over
from repro_torch.kernels import stage_ahead
from repro_torch.kernels.stage_ahead import AHEAD, TAKEN, WAITED
from repro_torch.obs import trace
from repro_torch.video import VideoEngine
from test_torch_stage_ahead import FakeStager

CARD = torch.device("cuda")          # a device object only: nothing runs
CPU = torch.device("cpu")
RNG = np.random.RandomState(29)
ROOT = Path(__file__).resolve().parents[1]
# how a batch's frames reach the card: no ticket, or tickets that the
# claim finds ahead, being staged, with no slot free (taken back), or on
# every other frame only
MODES = ("inline", "ahead", "waited", "taken", "mixed")
FOUND = {"ahead": AHEAD, "waited": WAITED, "taken": TAKEN, "mixed": AHEAD}


@pytest.fixture
def fake_card(monkeypatch):
    """Hand-overs to ``CARD`` on the CPU, their buffers poisoned. Yields
    the buffers made, held by weak references."""
    made = []
    empty, stacked = torch.empty, ho._stacked

    def poisoned(*shape, dtype=None, device=None, **kw):
        t = empty(*shape, dtype=dtype, **kw)
        t.fill_(float("nan") if t.is_floating_point() else 0xA5)
        made.append(weakref.ref(t))
        return t
    monkeypatch.setattr(torch, "empty", poisoned)
    monkeypatch.setattr(ho, "_stacked",
                        lambda fs, slots, device, dtype=torch.float32:
                        stacked(fs, slots, CPU, dtype))
    yield made


def _over(frames, slots, mode, pixels="float32", device=CARD, **attrs):
    """``hand_over`` of ``frames`` ({name: frames}) into ``slots`` slots,
    each frame the stager can read with a ticket as ``mode`` says; the
    tickets are released after. Returns (the tensors, what the claims
    found)."""
    if mode == "inline":
        return hand_over(frames, slots, device, pixels, **attrs), []
    dtype = torch.uint8 if pixels == "unorm8" else torch.float32
    nbytes = max(int(np.prod(np.shape(f))) for fs in frames.values()
                 for f in fs)
    st = FakeStager(device, 0 if mode == "taken" else slots * len(frames),
                    nbytes * dtype.itemsize)
    st.auto = mode in ("ahead", "mixed")
    tickets = {}
    for name, fs in frames.items():
        tickets[name] = []
        for i, f in enumerate(fs):
            where = stage_ahead.layout(f, dtype)
            skip = where is None or mode == "mixed" and i % 2
            tickets[name].append(None if skip else st.put(f, where))
    out = hand_over(frames, slots, device, pixels, (st, tickets), **attrs)
    issued = [t for ts in tickets.values() for t in ts if t is not None]
    st.release(issued)
    found = [s for c in st.claims for s in c]
    assert len(found) == len(issued) and set(found) <= {FOUND[mode]}
    return out, found


def _frames(n, h, w, dtype=np.float32):
    return [RNG.rand(h, w).astype(dtype) for _ in range(n)]


def _expected(frames, slots):
    ts = [torch.as_tensor(f.copy(), dtype=torch.float32) for f in frames]
    ts += [torch.zeros_like(ts[0])] * (slots - len(ts))
    return torch.stack(ts)


def _every_way(frames, slots):
    """``frames`` handed over every way, each equal to the expected
    batch."""
    for mode in MODES:
        got = _over({"in": frames}, slots, mode)[0]["in"]
        assert torch.equal(got, _expected(frames, slots)), mode


def _full_batch(made):
    _every_way(_frames(3, 5, 7), 3)


def _partial_batch(made):
    frames = _frames(2, 5, 7)
    for mode in MODES:
        got = _over({"in": frames}, 4, mode)[0]["in"]
        assert torch.equal(got, _expected(frames, 4)), mode
        assert not got[2:].any()


def _float64(made):
    """Frames of another type than float32 have no ticket (the stager
    copies bytes as they lie), so beside ticketed ones they are converted
    into their slots."""
    # digits beyond float32's, so the conversion rounds
    wide = [RNG.rand(6, 9) * (1 + 1e-9) for _ in range(2)]
    assert stage_ahead.layout(wide[0], torch.float32) is None
    _every_way(wide, 2)
    _every_way([wide[0], _frames(1, 6, 9)[0], wide[1]], 4)


def _non_contiguous(made):
    """Strided views and flipped frames (negative strides), which the
    stager cannot read, beside rows with a pitch, which it can."""
    base = RNG.rand(12, 16).astype(np.float32)
    frames = [base[::2, 1::2], base[:8, :6].T[:6, :8], base[5::-1, :8],
              base[:6, 7::-1], base[:6, 2:10]]
    assert not any(f.flags.c_contiguous for f in frames)
    assert [stage_ahead.layout(f, torch.float32) is not None
            for f in frames] == [False] * 4 + [True]
    _every_way(frames, 5)


def _heights(h):
    """Partial batches and lone frames ``h`` rows high; a claim makes one
    buffer, a hand-over with no ticket none."""
    def case(made):
        for n, slots in ((2, 4), (3, 4), (1, 1)):
            frames = _frames(n, h, 5)
            for mode in MODES:
                before = len(made)
                got = _over({"in": frames}, slots, mode)[0]["in"]
                assert torch.equal(got, _expected(frames, slots))
                assert len(made) - before == (mode != "inline")
    return case


def _two_shapes_in_turn(made):
    a1, b, a2 = _frames(3, 5, 7), _frames(2, 6, 4), _frames(2, 5, 7)
    for frames in (a1, b, a2):
        _every_way(frames, 3)


def _many_shapes_retain_nothing(made):
    """Shape-diverse traffic keeps nothing: every buffer and the caller's
    frames die with the caller's last reference."""
    for mode in MODES:
        frames = [(_frames(2, 3 + k, 4 + k), _frames(2, 3 + k, 4 + k))
                  for k in range(20)]
        outs = [_over({"a": a, "b": b}, 3, mode)[0] for a, b in frames]
        refs = [weakref.ref(t) for o in outs for t in o.values()] \
            + [weakref.ref(f) for ab in frames for fs in ab for f in fs]
        del outs, frames
        gc.collect()
        assert not any(r() is not None for r in refs + made), mode


def _idle_host_goes_pageable(made):
    """The engine's host is busy, so admission would stage ahead, only
    for a hand-over after ``RUN`` in a row, each begun within ``WARM_S``
    of the previous one's end: on the engine's clock, faked here."""
    starts = [10.0, 10.001, 10.002, 10.003, 10.004, 10.005,
              10.5, 10.501, 10.502, 10.503, 10.5055, 10.506, 10.507, 10.508,
              10.509, 10.510]
    clock = {"t": 0.0}
    eng = FrameEngine(max_batch=3, device="cpu")
    busy = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(engine_module, "_now", lambda: clock["t"])
        for s in starts:
            clock["t"] = s
            busy.append(eng._host_busy())
            frames = _frames(2, 4, 4)
            got = eng._hand_over("unsharp-m", [
                FrameRequest(rid=i, pipeline="unsharp-m", frames={"in": f})
                for i, f in enumerate(frames)], 3)["in"]
            assert torch.equal(got, _expected(frames, 3))
    # busy: the fifth and sixth of the first run; the last two of the
    # second, whose fifth began 2.5 ms after the one before it ended and
    # so began a run anew
    assert FrameEngine.RUN == 4 and FrameEngine.WARM_S == 0.002
    assert [i for i, b in enumerate(busy) if b] == [4, 5, 14, 15]
    assert not eng._stages_ahead()               # a CPU engine: never


def _spans_count_the_claimed_bytes(made):
    """``pinned_bytes`` is the bytes the claims found staged,
    ``ahead_bytes`` those found ahead; a float64 input, a CPU tensor
    input and a hand-over to the CPU the same by every way."""
    per = 4 * 5 * 7
    for mode in MODES:
        trace.clear()
        trace.enable()
        try:
            _over({"a": _frames(3, 5, 7), "b": _frames(3, 5, 7, np.float64)},
                  4, mode, pipeline="p")
            _over({"a": [torch.as_tensor(f) for f in _frames(2, 5, 7)]}, 2,
                  mode, pipeline="p")
            hand_over({"a": _frames(1, 5, 7)}, 1, CPU, pipeline="p")
            spans = [e for e in trace.events()
                     if e.name == "engine.assemble"]
        finally:
            trace.disable()
            trace.clear()
        claimed = {"inline": (0, 0), "ahead": (3, 2), "waited": (3, 2),
                   "taken": (0, 0), "mixed": (2, 1)}[mode]
        early = claimed if mode in ("ahead", "mixed") else (0, 0)
        assert [(e.attrs["h2d_bytes"], e.attrs["pinned_bytes"],
                 e.attrs["ahead_bytes"]) for e in spans] == [
            (6 * per, claimed[0] * per, early[0] * per),
            (2 * per, claimed[1] * per, early[1] * per),
            (per, 0, 0)], mode
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
    "spans-pinned-equal-h2d": _spans_count_the_claimed_bytes,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_staging(fake_card, case):
    CASES[case](fake_card)


def test_frames_of_another_shape_are_refused(fake_card):
    """Before any claim: a frame of another shape than its input's first
    (a claim would copy its bytes into a slot of the first's size), or
    more frames than slots."""
    for mode in MODES:
        with pytest.raises(ValueError, match="slots take"):
            _over({"in": _frames(1, 5, 7) + _frames(1, 1, 7)}, 2, mode)
        with pytest.raises(ValueError, match="exceeds 1 slots"):
            _over({"in": _frames(2, 5, 7)}, 1, mode)
    with pytest.raises(ValueError, match="exceeds 1 slots"):
        hand_over({"in": _frames(2, 5, 7)}, 1, CPU)


def test_cpu_engines_stage_nothing(monkeypatch):
    """CPU engines keep ``torch.as_tensor`` though their host is busy: no
    stager, no staged byte, and a lone float32 frame is the caller's own
    memory. The video engine does not hand over through
    :func:`hand_over` (its spans carry no ``pinned_bytes``); the frame
    engine's two batches do."""
    def boom(*a, **kw):
        raise AssertionError("a CPU engine made a stager")
    monkeypatch.setattr(stage_ahead, "Stager", boom)
    monkeypatch.setattr(FrameEngine, "WARM_S", float("inf"))
    trace.clear()
    trace.enable()
    try:
        feng = FrameEngine(max_batch=3, tile_shape=(16, 16), device="cpu")
        feng._run, feng._last_hand_over = FrameEngine.RUN, 0.0
        assert feng._host_busy() and not feng._stages_ahead()
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
    assert hand_over({"in": [f]}, 1, CPU)["in"][0].data_ptr() \
        == f.ctypes.data


def test_concurrent_hand_overs_never_share_buffers(fake_card):
    """More threads than cores hand frames over at once, each with
    stager tickets of its own or none: each reads its own frames back
    unchanged, so no hand-over writes into buffers another still reads
    (a resilient engine's abandoned attempt runs on beside the next
    one)."""
    frames = _frames(16, 9, 11)
    errors = []

    def worker(k):
        try:
            for i in range(50):
                mine = [frames[k], frames[k - 1]]
                got = _over({"in": mine}, 2, MODES[(k + i) % len(MODES)]
                            )[0]["in"]
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


def test_two_engines_keep_separate_busy_rules(monkeypatch):
    """One engine's hand-overs make its own host busy, not another's:
    the rule is each engine's, with no state shared in the process."""
    clock = {"t": 5.0}
    monkeypatch.setattr(engine_module, "_now", lambda: clock["t"])
    a, b = (FrameEngine(max_batch=2, device="cpu") for _ in range(2))

    def over(eng):
        frames = _frames(1, 4, 4)
        eng._hand_over("unsharp-m", [FrameRequest(
            rid=0, pipeline="unsharp-m", frames={"in": frames[0]})], 2)
    for k in range(FrameEngine.RUN):
        clock["t"] += 0.001
        over(a)
    assert a._host_busy() and not b._host_busy()
    over(b)                      # the fifth of a's run, were it shared
    assert a._host_busy() and not b._host_busy()
    assert (a._run, b._run) == (FrameEngine.RUN - 1, 0)


def test_the_device_module_loads_no_kernels_or_imaging():
    """``_device.py`` is the layer below the kernels and the engines:
    importing it loads no module of ``repro_torch.kernels`` or
    ``repro_torch.imaging``, and it names none, not even lazily."""
    code = ("import sys, repro_torch._device; print(sorted(m for m in "
            "sys.modules if m.startswith(('repro_torch.kernels', "
            "'repro_torch.imaging'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.stdout.strip() == "[]"
    tree = ast.parse((ROOT / "src/repro_torch/_device.py").read_text())
    named = [n.module if isinstance(n, ast.ImportFrom) else a.name
             for n in ast.walk(tree) if isinstance(n, (ast.Import,
                                                      ast.ImportFrom))
             for a in n.names]
    assert named and not any("kernels" in m or "imaging" in m
                             for m in named if m)
