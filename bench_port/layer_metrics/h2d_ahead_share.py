"""Host-to-device input: the share of the bytes the program handed from
host memory to the card whose copy was issued ahead of their batch, by
the stager at admission — the ``ahead_bytes`` of the ``engine.assemble``
spans over their ``h2d_bytes``. Nothing from a program whose spans carry
no ``ahead_bytes``, or when nothing moved."""


def read(ctx):
    spans = [e for e in ctx.spans if e.name == "engine.assemble"]
    if not any("ahead_bytes" in e.attrs for e in spans):
        return None
    moved = sum(int(e.attrs.get("h2d_bytes", 0)) for e in spans)
    if not moved:
        return None
    return sum(int(e.attrs.get("ahead_bytes", 0)) for e in spans) / moved
