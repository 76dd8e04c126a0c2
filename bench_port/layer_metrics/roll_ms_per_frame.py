"""Kernel: device ms a served frame of the video state roll — the union
of the device kernels launched inside the program's ``executor.roll``
spans (each temporal producer's ``torch.cat``), over the frames served.
K1's roofline still counts these kernels as part of ``engine.execute``.
"""
from bench_port.harness import profile, spans


def read(ctx):
    frames = spans.frames_served(ctx.spans)
    if ctx.trace is None or not frames:
        return None
    ks = profile.kernels_launched_in(ctx.trace, "executor.roll")
    busy = sum(t - s for s, t in profile.union((k[1], k[2]) for k in ks))
    return busy / 1e6 / frames if busy else None
