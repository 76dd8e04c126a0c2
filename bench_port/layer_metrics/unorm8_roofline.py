"""Kernel: the unorm8 decode's share of its bytes roofline, %.

The bound reads each decoded pixel once as a byte and writes it once as
a float32, 5 bytes a pixel (the ``pixels`` of the program's
``engine.unorm8`` spans), at the card's published memory rate. The time
is the union of the device kernels launched inside those spans,
whatever their names. Nothing from a program without the span."""
from bench_port.harness import profile

BYTES_PER_PIXEL = 1 + 4


def bytes_moved(pixels: int) -> int:
    """Bytes the decode of ``pixels`` pixels has to move."""
    return BYTES_PER_PIXEL * pixels


def read(ctx):
    if ctx.trace is None:
        return None
    pixels = sum(int(e.attrs.get("pixels", 0)) for e in ctx.spans
                 if e.name == "engine.unorm8")
    ks = profile.kernels_launched_in(ctx.trace, "engine.unorm8")
    busy = sum(t - s for s, t in profile.union((k[1], k[2]) for k in ks))
    if not pixels or not busy:
        return None
    bound_ns = bytes_moved(pixels) / ctx.peak_bytes_per_s * 1e9
    return 100.0 * bound_ns / busy
