"""Host-to-device input: host ms of the program's ``engine.assemble``
spans a served frame — the engine handing a step's frames to the card,
which on the pageable path holds the host for the whole copy."""
from bench_port.harness import spans


def read(ctx):
    frames = spans.frames_served(ctx.spans)
    ns = sum(e.dur_ns for e in ctx.spans if e.name == "engine.assemble")
    if not frames or not ns:
        return None
    return ns / 1e6 / frames
