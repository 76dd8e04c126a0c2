"""Device resolution for the port's entry points, the bytes a step
hands to a device, and the helpers of the kernels' launches."""
from __future__ import annotations

import contextlib

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
