"""Kernel: the stencil pipeline's share of its bytes roofline, %.

The bound moves each served frame's input pixels in once and its output
pixels out once, at 4 bytes a pixel, at the card's published memory rate.
The time is that of every device kernel launched inside the program's
``engine.execute`` spans, whatever its name, so a renamed or split
kernel is still counted (a video state roll launched there counts too).
"""
from bench_port.harness import profile, spans


def read(ctx):
    frames = spans.frames_served(ctx.spans)
    if ctx.trace is None or not frames:
        return None
    ks = profile.kernels_launched_in(ctx.trace, "engine.execute")
    busy = sum(t - s for s, t in profile.union((k[1], k[2]) for k in ks))
    if not busy:
        return None
    bound_ns = frames * ctx.frame_bytes / ctx.peak_bytes_per_s * 1e9
    return 100.0 * bound_ns / busy
