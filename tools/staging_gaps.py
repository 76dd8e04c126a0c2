"""Time the hand-over of 1080p host frames to the card after the host
idled, by either way of ``repro_torch.imaging.hand_over.hand_over``.

    PYTHONPATH=src python3 tools/staging_gaps.py [--gaps-ms 0 0.5 1 2 4 8]
        [--reps 60] [--rounds 2]

For each gap, for a lone frame and for a batch of four, and for each
way (``as_tensor``: ``torch.as_tensor`` and a stack; ``stager``: each
frame put to a ``kernels.stage_ahead.Stager`` of eight 1080p slots, its
threads copying it through page-locked memory, then the batch claimed
by the hand-over and released), it sleeps the gap, hands the frames over
and waits for the card, ``--reps`` times in a row (the first five not
counted). The stager's time starts at the first put, so it holds the
whole copy, as a hand-over right after admission would wait for it. It
prints one JSON line a round with the p50 and p95 ms of each, then
``cold_then_stager``: a lone frame through the stager right after one by
``torch.as_tensor`` that followed 8 ms of sleep. The card's name and
power limit come first, with the stager's thread count. Needs an NVIDIA
GPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch.imaging.hand_over import hand_over
from repro_torch.kernels import stage_ahead


def _as_tensor(frames, card, stager):
    return hand_over({"in": frames}, len(frames), card)


def _staged(frames, card, stager):
    tickets = [stager.put(f, stage_ahead.layout(f, torch.float32))
               for f in frames]
    out = hand_over({"in": frames}, len(frames), card,
                    ahead=(stager, {"in": tickets}))
    stager.release(tickets)
    return out


def _timed(fn, frames, gap_s, card, stager):
    if gap_s:
        time.sleep(gap_s)
    t0 = time.perf_counter()
    fn(frames, card, stager)
    torch.cuda.synchronize(card)
    return 1e3 * (time.perf_counter() - t0)


def _pct(xs):
    q = statistics.quantiles(xs, n=20)
    return {"p50": statistics.median(xs), "p95": q[18]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gaps-ms", type=float, nargs="+",
                    default=[0, 0.5, 1, 2, 4, 8])
    ap.add_argument("--reps", type=int, default=60)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    card = torch.device("cuda")
    h, w = 1080, 1920
    stager = stage_ahead.Stager(card, 8, 4 * h * w)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), stager.threads,
          "copying threads", flush=True)
    rng = np.random.default_rng(0)
    pool = [rng.random((h, w), dtype=np.float32) for _ in range(16)]
    ways = {"as_tensor": _as_tensor, "stager": _staged}
    for way in ways.values():                    # allocate, load the kernels
        way(pool[:4], card, stager)
    k = 0
    for r in range(args.rounds):
        row = {}
        for gap in args.gaps_ms:
            for n in (1, 4):
                for name, fn in ways.items():
                    xs = []
                    for _ in range(args.reps):
                        k += n
                        xs.append(_timed(fn, [pool[(k + i) % 16]
                                              for i in range(n)],
                                         gap / 1e3, card, stager))
                    row[f"{name}_{n}@{gap:g}ms"] = _pct(xs[5:])
        print(json.dumps({"round": r, "ms": row}), flush=True)
    xs = []
    for _ in range(args.reps):
        k += 2
        _timed(_as_tensor, [pool[k % 16]], 8e-3, card, stager)
        xs.append(_timed(_staged, [pool[(k + 1) % 16]], 0, card, stager))
    print(json.dumps({"cold_then_stager": _pct(xs[5:])}), flush=True)
    stager.close()


if __name__ == "__main__":
    main()
