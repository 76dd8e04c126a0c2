"""Host-to-device input: device ms of ``Memcpy HtoD`` a served frame."""
from bench_port.harness import profile, spans


def read(ctx):
    frames = spans.frames_served(ctx.spans)
    if ctx.trace is None or not frames:
        return None
    ms = profile.device_seconds(ctx.trace, "Memcpy HtoD") * 1e3
    return ms / frames if ms else None
