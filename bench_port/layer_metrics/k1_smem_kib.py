"""Kernel: shared memory one CTA of the serving executor reserves (its
ring line buffers), KiB, the mean over the cell's pipelines — the
paper's on-chip memory figure, as the program reports it."""


def read(ctx):
    if not ctx.smem:
        return None
    return sum(ctx.smem.values()) / len(ctx.smem) / 1024
