"""Host-to-device input: the share of the bytes the program handed from
host memory to the card that went through its page-locked staging
buffers — the ``pinned_bytes`` of the ``engine.assemble`` spans over the
``h2d_bytes`` of every span. Nothing from a program whose spans carry no
``pinned_bytes``."""


def read(ctx):
    if not any("pinned_bytes" in e.attrs for e in ctx.spans):
        return None
    moved = sum(int(e.attrs.get("h2d_bytes", 0)) for e in ctx.spans)
    if not moved:
        return None
    return sum(int(e.attrs.get("pinned_bytes", 0))
               for e in ctx.spans) / moved
