"""Host-to-device input: device ms a served frame of the unorm8 decode —
the union of the device kernels launched inside the program's
``engine.unorm8`` spans, over the frames served. Nothing from a program
without the span."""
from bench_port.harness import profile, spans


def read(ctx):
    frames = spans.frames_served(ctx.spans)
    if ctx.trace is None or not frames:
        return None
    ks = profile.kernels_launched_in(ctx.trace, "engine.unorm8")
    busy = sum(t - s for s, t in profile.union((k[1], k[2]) for k in ks))
    return busy / 1e6 / frames if busy else None
