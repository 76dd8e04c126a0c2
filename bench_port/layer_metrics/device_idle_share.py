"""Device: 1 minus the union of device activity over the traced
window's wall time."""
from bench_port.harness import profile


def read(ctx):
    if ctx.trace is None:
        return None
    return 1.0 - profile.busy_s(ctx.trace) / profile.window_s(ctx.trace)
