"""Device resolution for the port's entry points."""
from __future__ import annotations

import contextlib

import torch


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


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
