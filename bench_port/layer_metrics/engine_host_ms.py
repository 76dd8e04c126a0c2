"""Serving engine: mean host self time of a step, ms — each
``engine.step`` span minus its ``engine.assemble`` and ``engine.execute``
children (the scheduling, bookkeeping and result objects)."""
from bench_port.harness import spans


def read(ctx):
    selfs = spans.step_self_ns(ctx.spans)
    if not selfs:
        return None
    return sum(selfs) / len(selfs) / 1e6
