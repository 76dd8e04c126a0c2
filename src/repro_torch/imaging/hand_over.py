"""The hand-over of :class:`~repro_torch.imaging.FrameEngine`'s frames to
its device (:func:`hand_over`): a batch's frames staged ahead by the
engine's :class:`~repro_torch.kernels.stage_ahead.Stager` are claimed on
the card, every other frame goes by ``torch.as_tensor``."""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch._device import h2d_span
from repro_torch.kernels import unorm8
from repro_torch.kernels.stage_ahead import AHEAD, TAKEN
from repro_torch.obs import trace


def _readable(frame):
    """``frame``, a numpy view with a negative stride (a flipped frame,
    which ``torch.as_tensor`` refuses) copied into C order first."""
    if isinstance(frame, np.ndarray) and any(s < 0 for s in frame.strides):
        return np.ascontiguousarray(frame)
    return frame


def _stacked(frames: Sequence, slots: int, device: torch.device,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``frames`` by ``torch.as_tensor`` as one (slots, h, w) ``dtype``
    tensor, idle slots zero; a lone frame in one slot is a view of its
    tensor, which on the CPU shares the memory of an array of
    ``dtype``."""
    ts = [torch.as_tensor(_readable(f), dtype=dtype, device=device)
          for f in frames]
    if len(ts) == slots == 1:
        return ts[0][None]
    return torch.stack(ts + [torch.zeros_like(ts[0])] * (slots - len(ts)))


def hand_over(frames: Mapping[str, Sequence], slots: int,
              device: torch.device, pixels: str = "float32",
              ahead: tuple | None = None,
              **attrs) -> dict[str, torch.Tensor]:
    """``frames[name]``, the frames of one input (each (h, w), numpy or
    tensor), as one (slots, h, w) float32 tensor each on ``device``, idle
    slots zero, under an ``engine.assemble`` span (``attrs`` its
    attributes) that carries ``h2d_bytes``, ``pinned_bytes``, the bytes
    of the frames the stager staged through page-locked memory, and
    ``ahead_bytes``, those whose copy to the card it had issued before
    the hand-over.

    ``pixels`` is the frames' format: ``"float32"``, frames of any float
    or integer type converted to float32 on the host, or ``"unorm8"``,
    uint8 frames moved as they are, a byte a pixel, and decoded on
    ``device`` (:func:`_decode`).

    ``ahead`` is ``(stager, {name: [ticket or None, a frame]})`` for
    frames a :class:`~repro_torch.kernels.stage_ahead.Stager` took at
    admission. They are claimed first, in one call: a frame staged is
    gathered from its slot on the card, one being staged (or not started,
    with a slot free for it) is waited for, and one with no slot free is
    taken back. A frame taken back or without a ticket is copied into its
    slot by ``torch.as_tensor``; an input with no ticket at all is
    stacked by :func:`_stacked`. Nothing is kept of or keyed by the
    caller's arrays, and no buffer outlives the call but the returned
    tensors. An input of more frames than ``slots``, or of frames of
    another shape than its first, is refused before anything is copied."""
    for fs in frames.values():
        _check(fs, slots)
    u8 = pixels == "unorm8"
    dtype = torch.uint8 if u8 else torch.float32
    with h2d_span("engine.assemble",
                  (f for fs in frames.values() for f in fs), device,
                  1 if u8 else 4, **attrs) as sp:
        claimed = _claim(ahead, frames, slots, device, dtype) \
            if ahead else {}
        out, pinned, early = {}, 0, 0
        for name, fs in frames.items():
            if name in claimed:
                out[name], states = claimed[name]
                p, e = _fill_taken(fs, states, out[name])
                pinned, early = pinned + p, early + e
            else:
                out[name] = _stacked(fs, slots, device, dtype)
            if u8:
                out[name] = _decode(out[name], len(fs), attrs)
        sp.set(pinned_bytes=pinned, ahead_bytes=early)
    return out


def _check(frames: Sequence, slots: int) -> None:
    """Raise ValueError unless ``frames`` fill at most ``slots`` slots of
    the first frame's shape (a claim copies a frame's bytes into its
    slot, whatever the slot's size)."""
    if len(frames) > slots:
        raise ValueError(f"batch of {len(frames)} exceeds {slots} slots")
    shape = tuple(np.shape(frames[0]))
    for i, f in enumerate(frames):
        if tuple(np.shape(f)) != shape:
            raise ValueError(f"frame {i} of shape {tuple(np.shape(f))}, "
                             f"slots take {shape}")


def _claim(ahead: tuple, frames: Mapping[str, Sequence], slots: int,
           device: torch.device, dtype: torch.dtype
           ) -> dict[str, tuple[torch.Tensor, list[int]]]:
    """{name: (its (slots, h, w) buffer on ``device``, what the claim
    found a frame)} for the inputs with a ticket in ``ahead``; a frame
    without one is :data:`TAKEN`. The frames staged are in their slots of
    the buffer once the current stream reaches this point."""
    stager, tickets = ahead
    bufs, ids, dsts = {}, [], []
    for name, ts in tickets.items():
        if all(t is None for t in ts):
            continue
        buf = bufs[name] = torch.empty(
            (slots, *np.shape(frames[name][0])), dtype=dtype, device=device)
        for i, t in enumerate(ts):
            if t is not None:
                ids.append(t)
                dsts.append(buf[i])
    found = iter(stager.claim(ids, dsts) if ids else ())
    return {name: (buf, [TAKEN if t is None else next(found)
                         for t in tickets[name]])
            for name, buf in bufs.items()}


def _fill_taken(frames: Sequence, states: Sequence[int],
                buf: torch.Tensor) -> tuple[int, int]:
    """Copy the frames of ``frames`` the claim took back (or that had no
    ticket; :data:`TAKEN` in ``states``) into their slots of ``buf`` by
    ``torch.as_tensor``, and zero its idle slots. Returns the bytes the
    stager staged and the bytes of the frames :data:`AHEAD`."""
    nbytes = buf[0].numel() * buf.element_size()
    for i, s in enumerate(states):
        if s == TAKEN:
            buf[i].copy_(torch.as_tensor(_readable(frames[i])))
    if len(frames) < buf.shape[0]:
        buf[len(frames):].zero_()
    return (nbytes * sum(s != TAKEN for s in states),
            nbytes * sum(s == AHEAD for s in states))


def _decode(raw: torch.Tensor, n: int, attrs: Mapping) -> torch.Tensor:
    """The first ``n`` slots of ``raw`` (slots, h, w) uint8 decoded
    (``kernels.unorm8``) into a float32 tensor of its shape on its
    device, the other slots zero, under an ``engine.unorm8`` span
    (``attrs``, ``n_frames`` and ``pixels``, the pixels decoded)."""
    out = torch.empty(raw.shape, dtype=torch.float32, device=raw.device)
    with trace.span("engine.unorm8", n_frames=n, pixels=raw[:n].numel(),
                    **attrs):
        unorm8.decode(raw[:n], out[:n])
    if n < out.shape[0]:
        out[n:].zero_()
    return out
