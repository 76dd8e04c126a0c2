"""Host-to-device input: the copy's rate, GB/s — the ``h2d_bytes`` the
program's spans say they handed from host memory to the card, over the
device time of ``Memcpy HtoD``. Moves with the copy's speed, not with
the bytes a frame needs."""
from bench_port.harness import profile


def read(ctx):
    if ctx.trace is None:
        return None
    moved = sum(int(e.attrs.get("h2d_bytes", 0)) for e in ctx.spans)
    seconds = profile.device_seconds(ctx.trace, "Memcpy HtoD")
    if not moved or not seconds:
        return None
    return moved / seconds / 1e9
