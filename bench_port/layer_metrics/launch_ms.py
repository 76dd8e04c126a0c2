"""Kernel: mean host ms of a compiled executor call (the program's
``executor.call`` spans): the feed checks, the output allocation, the
launch and the enqueue of a video state roll. The engine hands the call
device tensors, and synchronises after it returns."""


def read(ctx):
    calls = [e.dur_ns for e in ctx.spans if e.name == "executor.call"]
    if not calls:
        return None
    return sum(calls) / len(calls) / 1e6
