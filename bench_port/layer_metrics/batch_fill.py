"""Serving engine: frames served per executor call over the call's
capacity (``max_batch`` frames, or a video ``chunk``), in the traced
window. 1 when every launch is full."""
from bench_port.harness import spans


def read(ctx):
    calls = spans.executor_calls(ctx.spans)
    if not calls:
        return None
    return spans.frames_served(ctx.spans) / calls / ctx.capacity
