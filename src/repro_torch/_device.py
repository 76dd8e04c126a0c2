"""Device resolution for the port's entry points, and the hand-over of
host frames to the card (:func:`hand_over`)."""
from __future__ import annotations

import contextlib
from time import monotonic as _now
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.obs import trace


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist.

    The entry points default to ``"cuda"``. Asking for it on a machine
    without a card raises here instead of carrying on on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but no CUDA "
                           f"device is available; pass device='cpu' to run "
                           f"the plain PyTorch version")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def device_label(device: torch.device) -> str:
    """``device`` as an entry point prints it: a card with its name."""
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        return f"cuda:{index} ({torch.cuda.get_device_name(index)})"
    return str(device)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stream_synchronize(device: torch.device) -> None:
    """Wait for the work queued on the calling thread's current stream of
    ``device`` (a no-op on the CPU), not for other streams': a
    ``FrameEngine`` step waits for its batch, not for the stager's copies
    of later frames (on an H100's host a device-wide wait for those
    lengthened steps past the busy rule's 2 ms on slow hosts)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def host_bytes(arrays, device: torch.device, itemsize: int = 4) -> int:
    """Bytes that handing ``arrays`` to ``device`` copies out of host
    memory, at ``itemsize`` an element, the size of what crosses the
    link (4: float32, which a float frame of any type is converted to
    first; 1: unorm8 pixels): every numpy array, whatever the device (so
    a CPU engine fed numpy frames counts what a CUDA one does), and a
    CPU tensor handed to a card. A tensor already on the card counts
    nothing, nor a CPU tensor that stays on the CPU."""
    n = 0
    for a in arrays:
        if isinstance(a, torch.Tensor):
            if a.device.type == "cpu" and device.type != "cpu":
                n += a.numel()
        else:
            n += np.size(a)
    return itemsize * n


def h2d_span(name: str, arrays, device: torch.device, itemsize: int = 4,
             **attrs):
    """``trace.span(name, **attrs)`` over a step that hands ``arrays`` to
    ``device``. While tracing, the span carries ``h2d_bytes``, their
    :func:`host_bytes` at ``itemsize`` an element, when that is not 0;
    ``arrays`` (any iterable, a generator too) is read only then."""
    sp = trace.span(name, **attrs)
    if sp is not trace.NULL_SPAN:
        n = host_bytes(arrays, device, itemsize)
        if n:
            sp.set(h2d_bytes=n)
    return sp


def launch_context(index: int):
    """Make card ``index`` current for a kernel launch: a no-op context
    when it already is, which saves two device switches per launch."""
    if index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def raw_stream(index: int) -> int:
    """The cudaStream_t of card ``index``'s current stream, as an int.
    ``torch.cuda.current_stream`` builds a Stream object on every call;
    a launch needs only the handle."""
    return torch._C._cuda_getCurrentRawStream(index)


def caller_stream_context():
    """Capture the calling thread's current card and stream; returns a
    function that builds a context making them current in another
    thread. A fresh thread starts on card 0 and its default stream, so
    work handed to one (a timed attempt) would otherwise launch on
    another card or stream than its caller's. A no-op context before
    CUDA is initialised (and on a machine without a card)."""
    if not torch.cuda.is_initialized():
        return contextlib.nullcontext
    index = torch.cuda.current_device()
    stream = torch.cuda.current_stream(index)

    @contextlib.contextmanager
    def context():
        with torch.cuda.device(index), torch.cuda.stream(stream):
            yield
    return context


def page_locked_pair(device: torch.device, shape: tuple,
                     dtype: torch.dtype = torch.float32
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """A page-locked host buffer and a buffer on card ``device``, both
    ``dtype`` of ``shape``, from torch's caching allocators: a
    page-locked block a non-blocking copy read is reused only once that
    copy is done, so nothing of a call outlives it but the card's
    buffer."""
    return (torch.empty(shape, dtype=dtype, pin_memory=True),
            torch.empty(shape, dtype=dtype, device=device))


def _readable(frame):
    """``frame``, a numpy view with a negative stride (a flipped frame,
    which ``torch.as_tensor`` refuses) copied into C order first."""
    if isinstance(frame, np.ndarray) and any(s < 0 for s in frame.strides):
        return np.ascontiguousarray(frame)
    return frame


def stage_into(frames: Sequence, host: torch.Tensor,
               dev: torch.Tensor) -> int:
    """Copy ``frames`` (each (h, w), numpy or tensor) into the leading
    slots of ``dev`` (slots, h, w; float32, or uint8 for unorm8 pixels)
    and zero the rest. A host frame is converted to ``dev``'s type into
    its slot of ``host``, a staging buffer of ``dev``'s shape and type,
    by ``Tensor.copy_`` on torch's intra-op threads, then copied on to
    ``dev`` with ``non_blocking=True``, so each slot's copy to a card
    runs while the next slot is staged; a frame already on a device is
    copied over directly. Returns the bytes that went through ``host``,
    at its itemsize an element, as :func:`host_bytes` counts them.

    The copies are queued on ``dev``'s current stream: ``host`` may be
    written again once that stream has run them."""
    if len(frames) > dev.shape[0]:
        raise ValueError(f"batch of {len(frames)} exceeds "
                         f"{dev.shape[0]} slots")
    staged = 0
    for i, f in enumerate(frames):
        src = torch.as_tensor(_readable(f))
        if src.shape != dev.shape[1:]:
            raise ValueError(f"frame {i} of shape {tuple(src.shape)}, "
                             f"slots take {tuple(dev.shape[1:])}")
        if src.device.type != "cpu":
            dev[i].copy_(src)
            continue
        host[i].copy_(src)
        dev[i].copy_(host[i], non_blocking=True)
        staged += host.element_size() * src.numel()
    if len(frames) < dev.shape[0]:
        dev[len(frames):].zero_()
    return staged


def _stacked(frames: Sequence, slots: int, device: torch.device,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``frames`` by ``torch.as_tensor`` as one (slots, h, w) ``dtype``
    tensor, idle slots zero; a lone frame in one slot is a view of its
    tensor, which on the CPU shares the memory of an array of
    ``dtype``."""
    if len(frames) > slots:
        raise ValueError(f"batch of {len(frames)} exceeds {slots} slots")
    ts = [torch.as_tensor(_readable(f), dtype=dtype, device=device)
          for f in frames]
    if len(ts) == slots == 1:
        return ts[0][None]
    return torch.stack(ts + [torch.zeros_like(ts[0])] * (slots - len(ts)))


# Staging on torch's intra-op threads pays while the host keeps handing
# frames to a card: on an H100's host, back to back or after 2 ms idle, a
# 1080p frame took p50 0.57-0.86 ms staged against 1.47-1.88 by
# torch.as_tensor, a batch of four 1.5-2.6 against 5.5-7.1
# (tools/staging_gaps.py). After 8.3 ms idle some hosts' threads woke
# late: a lone frame p95 8.8-16.4 ms staged against 1.8-2.4, and a live
# camera's frames staged after an idle host ~4 ms a frame against 1.4 by
# torch.as_tensor. One staging with the threads asleep thus costs what
# about three with them awake save, so frames are staged only once the
# host has handed over four times in a row, each hand-over begun within
# WARM_S of the previous one's end: from the fifth of such a run on.
WARM_S = 0.002
RUN = 4
# _now() at the end of the latest hand-over to a card, by any engine, and
# how many hand-overs before it followed their predecessor within WARM_S
_last_hand_over = -float("inf")
_run = 0

# What claiming a frame staged ahead found (kernels/stage_ahead.py): its
# copy to the card issued before the claim, issued while the claim waited,
# or not started with no slot free, so taken back for the hand-over.
TAKEN, WAITED, AHEAD = 0, 1, 2


def staging_pays() -> bool:
    """Whether a hand-over to a card begun now would be staged: the
    :data:`RUN` hand-overs before it each began within :data:`WARM_S` of
    the previous one's end, and the latest ended within :data:`WARM_S`."""
    return _run >= RUN - 1 and _now() - _last_hand_over < WARM_S


def hand_over(frames: Mapping[str, Sequence], slots: int,
              device: torch.device, pixels: str = "float32",
              ahead: tuple | None = None,
              **attrs) -> dict[str, torch.Tensor]:
    """``frames[name]``, the frames of one input (each (h, w), numpy or
    tensor), as one (slots, h, w) float32 tensor each on ``device``, idle
    slots zero, under an ``engine.assemble`` span (``attrs`` its
    attributes) that carries ``h2d_bytes``, ``pinned_bytes``, the bytes
    that went through page-locked memory, and ``ahead_bytes``, those of
    frames whose copy to the card was issued before the hand-over.

    ``pixels`` is the frames' format: ``"float32"``, frames of any float
    or integer type converted to float32 on the host, or ``"unorm8"``,
    uint8 frames moved as they are, a byte a pixel, and decoded on
    ``device`` (:func:`_decode`).

    For a card, when this hand-over and the :data:`RUN` before it each
    began within :data:`WARM_S` of the previous one's end (the host is
    busy, torch's intra-op threads awake), each input is staged
    by :func:`stage_into` through a page-locked buffer made for this
    call; otherwise, and on the CPU, by :func:`_stacked`.

    ``ahead`` is ``(stager, {name: [ticket or None, a frame]})`` for
    frames a :class:`~repro_torch.kernels.stage_ahead.Stager` took at
    admission. They are claimed first, in one call: a frame staged is
    gathered from its slot on the card, one being staged (or not started,
    with a slot free for it) is waited for, and one with no slot free is
    taken back and handed over here by the rule above, as is every frame
    without a ticket. Nothing is kept of or keyed by the caller's arrays,
    and no buffer outlives the call but the returned tensors."""
    global _last_hand_over, _run
    unorm8 = pixels == "unorm8"
    dtype = torch.uint8 if unorm8 else torch.float32
    card = device.type == "cuda"
    if card:
        _run = _run + 1 if _now() - _last_hand_over < WARM_S else 0
    with h2d_span("engine.assemble",
                  (f for fs in frames.values() for f in fs), device,
                  1 if unorm8 else 4, **attrs) as sp:
        warm = card and _run >= RUN
        claimed = _claim(ahead, frames, slots, device, dtype) \
            if ahead else {}
        out, pinned, early = {}, 0, 0
        for name, fs in frames.items():
            if name in claimed:
                out[name], states = claimed[name]
                p, e = _stage_taken(fs, states, out[name], warm)
                pinned, early = pinned + p, early + e
            elif not warm:
                out[name] = _stacked(fs, slots, device, dtype)
            else:
                host, out[name] = page_locked_pair(
                    device, (slots, *np.shape(fs[0])), dtype)
                pinned += stage_into(fs, host, out[name])
            if unorm8:
                out[name] = _decode(out[name], len(fs), attrs)
        sp.set(pinned_bytes=pinned, ahead_bytes=early)
    if card:
        _last_hand_over = _now()
    return out


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


def _stage_taken(frames: Sequence, states: Sequence[int],
                 buf: torch.Tensor, warm: bool) -> tuple[int, int]:
    """Hand the frames of ``frames`` the claim took back (or that had no
    ticket; :data:`TAKEN` in ``states``) over into their slots of ``buf``,
    through page-locked memory when ``warm``, and zero its idle slots.
    Returns the bytes that went through page-locked memory, the claimed
    frames' included, and the bytes of the frames :data:`AHEAD`."""
    nbytes = buf[0].numel() * buf.element_size()
    taken = [i for i, s in enumerate(states) if s == TAKEN]
    pinned = nbytes * (len(states) - len(taken))
    early = nbytes * sum(s == AHEAD for s in states)
    if taken and warm:
        host = torch.empty((len(taken), *buf.shape[1:]), dtype=buf.dtype,
                           pin_memory=True)
        for j, i in enumerate(taken):
            pinned += stage_into([frames[i]], host[j:j + 1], buf[i:i + 1])
    elif taken:
        for i in taken:
            buf[i].copy_(torch.as_tensor(_readable(frames[i])))
    if len(frames) < buf.shape[0]:
        buf[len(frames):].zero_()
    return pinned, early


def _decode(raw: torch.Tensor, n: int, attrs: Mapping) -> torch.Tensor:
    """The first ``n`` slots of ``raw`` (slots, h, w) uint8 decoded
    (``kernels.unorm8``) into a float32 tensor of its shape on its
    device, the other slots zero, under an ``engine.unorm8`` span
    (``attrs``, ``n_frames`` and ``pixels``, the pixels decoded)."""
    from repro_torch.kernels import unorm8      # the kernels import this
    out = torch.empty(raw.shape, dtype=torch.float32, device=raw.device)
    with trace.span("engine.unorm8", n_frames=n, pixels=raw[:n].numel(),
                    **attrs):
        unorm8.decode(raw[:n], out[:n])
    if n < out.shape[0]:
        out[n:].zero_()
    return out
