"""Open loop of periodic clients, as live cameras send: ``clients``
clients, in turn over the pipelines, each offering one frame every
1/``rate_hz`` s whatever the server does. The clients' phases split the
period evenly, j / (clients rate_hz) for j < clients, and the seed
decides which client takes which, so every seed offers the same arrival
grid. ``step()`` runs whenever frames are pending. After the window the
run waits up to ``drain_s`` for the frames due in it.
"""
from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function

from bench_port.harness import traffic
from bench_port.harness.loop import Window, frame


def clients(mix: dict, pipelines: list[str], seed: int
            ) -> list[traffic.Client]:
    n = mix["clients"]
    period = 1.0 / mix["rate_hz"]
    return traffic.spread(n, mix, pipelines, seed,
                          traffic.rng(seed, 2).permutation(n) * (period / n))


def arrivals(mix: dict, cls: list, seconds: float
             ) -> list[tuple[float, int, int]]:
    """Every (due seconds after the window opens, client, k) due before
    ``seconds``, in due order."""
    rate = float(mix["rate_hz"])
    out = []
    for c in cls:
        n = int(np.ceil((seconds - c.phase_s) * rate))
        due = c.phase_s + np.arange(max(n, 0)) / rate
        out += [(float(d), c.index, k) for k, d in enumerate(due)
                if d < seconds]
    out.sort()
    return out


def run(server, cls, mix, pool, seconds: float, keep, seed: int, on_close
        ) -> Window:
    """fps counts the delivered frames over the window, or over the time
    to the last delivery when that is longer. ``keep(client, k, output)``
    sees every frame delivered, ``on_close()`` runs as the window
    closes."""
    plan = arrivals(mix, cls, seconds)
    drain = float(mix["drain_s"])
    w = Window(seconds=seconds, offered=len(plan))
    due_of = {}
    i = 0
    closed_ = False
    last = 0.0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        while i < len(plan) and plan[i][0] <= now:
            due, ci, k = plan[i]
            i += 1
            with record_function("bench.submit"):
                ok = server.submit(cls[ci], k, frame(mix, pool, cls[ci], k))
            w.lag_s.append(time.perf_counter() - t0 - due)
            if ok:
                due_of[ci, k] = due
                w.accepted[ci].append(k)
            else:
                w.refused.append((ci, k))
        if not closed_ and now >= seconds:
            closed_ = True
            w.backlog_end = server.pending
            on_close()
        if server.pending:
            with record_function("bench.step"):
                res = server.step()
            done = time.perf_counter() - t0
            for ci, k, out in res:
                due = due_of.pop((ci, k))
                if out is None:
                    w.missing.append((ci, k))
                    continue
                w.delivered.append((ci, k, due, done))
                keep(cls[ci], k, out)
                last = done
        elif i < len(plan) or not closed_:
            # idle until the next frame is due, or until the window closes
            nxt = plan[i][0] if i < len(plan) else seconds
            with record_function("bench.wait"):
                time.sleep(max(0.0, nxt - now))
        else:
            break
        if now > seconds + drain:
            w.missing += list(due_of)
            break
    w.seconds = max(seconds, last)
    w.counted = len(w.delivered)
    return w
