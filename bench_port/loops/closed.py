"""Closed loop: ``clients_per_pipeline`` clients a pipeline, each
offering its next frame the moment its last one returns.

The window closes at the return of the first ``step()`` that ends
``seconds`` or more after it opened; fps counts the frames delivered
until then over that time. Frames still in flight are then served and
neither counted nor checked.
"""
from __future__ import annotations

import time

from torch.profiler import record_function

from bench_port.harness import traffic
from bench_port.harness.loop import Window, frame


def clients(mix: dict, pipelines: list[str], seed: int
            ) -> list[traffic.Client]:
    return traffic.spread(mix["clients_per_pipeline"] * len(pipelines), mix,
                          pipelines, seed)


def run(server, cls, mix, pool, seconds: float, keep, seed: int, on_close
        ) -> Window:
    """``keep(client, k, output)`` sees every frame delivered in the
    window, ``on_close()`` runs as the window closes. A frame the server
    refuses is offered again after the next step."""
    nxt = [0] * len(cls)
    inflight: dict = {}               # client -> (k, offered)
    w = Window(seconds=0.0)
    t0 = time.perf_counter()

    def refill(now):
        for c in cls:
            if c.index in inflight:
                continue
            k = nxt[c.index]
            with record_function("bench.submit"):
                ok = server.submit(c, k, frame(mix, pool, c, k))
            if ok:
                nxt[c.index] += 1
                inflight[c.index] = (k, now)
                w.accepted[c.index].append(k)

    refill(0.0)
    open_ = True
    while open_ or inflight:
        with record_function("bench.step"):
            res = server.step()
        now = time.perf_counter() - t0
        if not res and not server.pending and inflight:
            raise RuntimeError("closed loop: frames in flight, none pending")
        for ci, k, out in res:
            _, due = inflight.pop(ci)
            if not open_:
                continue
            w.offered += 1
            if out is None:
                w.missing.append((ci, k))
            else:
                w.delivered.append((ci, k, due, now))
                keep(cls[ci], k, out)
        if open_ and now >= seconds:
            open_ = False
            w.seconds = now
            w.counted = len(w.delivered)
            w.backlog_end = server.pending
            on_close()
        if open_:
            refill(now)
    return w
