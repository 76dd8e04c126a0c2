"""Serving engine: the share of the frames delivered whose batch an
earlier ``step()`` had launched, so the host's work for the next batch
overlapped the card's work for it — the ``launched_ahead`` of the
``engine.step`` spans over their ``delivered``. Nothing from a program
whose spans carry no ``launched_ahead``, or when nothing was
delivered."""
from bench_port.harness import spans


def read(ctx):
    steps = [e for e in ctx.spans if e.name == spans.STEP]
    if not any("launched_ahead" in e.attrs for e in steps):
        return None
    delivered = spans.frames_served(ctx.spans)
    if not delivered:
        return None
    return sum(int(e.attrs.get("launched_ahead", 0))
               for e in steps) / delivered
