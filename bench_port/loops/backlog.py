"""Closed loop of streams catching up on recorded footage:
``clients_per_pipeline`` clients a pipeline, each one stream, offering
its next ``chunk`` consecutive frames at once the instant the last of
its previous ``chunk`` has returned.

A frame's due instant is its offer. A frame the server refuses is
offered again after the next step, and its client's later frames wait
behind it, so a stream never skips a frame. The window closes as
``closed.py``'s does: at the return of the first ``step()`` that ends
``seconds`` or more after it opened; fps counts the frames delivered
until then over that time. Frames still in flight are then served and
neither counted nor checked; frames not yet accepted are not offered.
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
    window, ``on_close()`` runs as the window closes."""
    chunk = int(mix["chunk"])
    nxt = [0] * len(cls)                 # each client's next chunk's first k
    waiting: dict = {c.index: [] for c in cls}   # offered, not accepted
    inflight: dict = {c.index: {} for c in cls}  # accepted: k -> due
    w = Window(seconds=0.0)
    t0 = time.perf_counter()

    def offer(now):
        for c in cls:
            i = c.index
            if not waiting[i] and not inflight[i]:
                waiting[i] = list(range(nxt[i], nxt[i] + chunk))
                nxt[i] += chunk
            while waiting[i]:
                k = waiting[i][0]
                with record_function("bench.submit"):
                    ok = server.submit(c, k, frame(mix, pool, c, k))
                if not ok:
                    break
                waiting[i].pop(0)
                inflight[i][k] = now
                w.accepted[i].append(k)

    offer(0.0)
    open_ = True
    while open_ or any(inflight.values()):
        with record_function("bench.step"):
            res = server.step()
        now = time.perf_counter() - t0
        if not res and not server.pending and any(inflight.values()):
            raise RuntimeError("backlog loop: frames in flight, none pending")
        for ci, k, out in res:
            due = inflight[ci].pop(k)
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
            offer(now)
    return w
