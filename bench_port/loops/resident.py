"""Closed loop over frames resident on the card: the closed loop of
``closed.py``, whose clients offer frames already in device memory, as
a multi-stage GPU service or a hardware decoder holds them. The pool is
copied to the server's device once, before the window's clock starts;
that is after set-up is timed and, in a traced run, inside the
profiler's window (a copy of a fraction of a second), since a loop is
first handed the pool there. The check still reads the host pool, the
same pixels.
"""
from __future__ import annotations

import torch

from bench_port.loops import closed

clients = closed.clients


def on_device(pool: list, device: torch.device) -> list[torch.Tensor]:
    """Each pool frame as a tensor on ``device``, the same pixels, the
    copies done (a copy from pageable memory may return before its last
    DMA lands)."""
    resident = [torch.from_numpy(f).to(device) for f in pool]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return resident


def run(server, cls, mix, pool, seconds: float, keep, seed: int, on_close):
    return closed.run(server, cls, mix,
                      on_device(pool, server.engine.device), seconds, keep,
                      seed, on_close)
