"""Time the hand-over of 1080p host frames to the card after the host
idled, by either path of ``repro_torch._device.hand_over``.

    PYTHONPATH=src python3 tools/staging_gaps.py [--gaps-ms 0 0.5 1 2 4 8]
        [--reps 60] [--rounds 2]

For each gap, for a lone frame and for a batch of four, and for each
path (``pageable``: ``torch.as_tensor`` and a stack; ``staged``:
through a page-locked buffer on torch's intra-op threads), it sleeps
the gap, hands the frames over and waits for the card, ``--reps`` times
in a row (the first five not counted). It prints one JSON line a round
with the p50 and p95 ms of each, then ``cold_then_staged``: a lone
frame staged right after a pageable one that followed 8 ms of sleep
(two streams' frames in one step after the host idled). The card's
name and power limit come first. Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch._device import _stacked, page_locked_pair, stage_into


def _staged(frames, card):
    host, dev = page_locked_pair(card, (len(frames), *frames[0].shape))
    stage_into(frames, host, dev)
    return dev


def _timed(fn, frames, gap_s, card):
    if gap_s:
        time.sleep(gap_s)
    t0 = time.perf_counter()
    fn(frames)
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), torch.get_num_threads(),
          "intra-op threads", flush=True)
    rng = np.random.default_rng(0)
    pool = [rng.random((1080, 1920), dtype=np.float32) for _ in range(16)]
    paths = {"pageable": lambda fs: _stacked(fs, len(fs), card),
             "staged": lambda fs: _staged(fs, card)}
    for path in paths.values():                  # allocate, load the kernels
        path(pool[:4])
    k = 0
    for r in range(args.rounds):
        row = {}
        for gap in args.gaps_ms:
            for n in (1, 4):
                for name, fn in paths.items():
                    xs = []
                    for _ in range(args.reps):
                        k += n
                        xs.append(_timed(fn, [pool[(k + i) % 16]
                                              for i in range(n)],
                                         gap / 1e3, card))
                    row[f"{name}_{n}@{gap:g}ms"] = _pct(xs[5:])
        print(json.dumps({"round": r, "ms": row}), flush=True)
    xs = []
    for _ in range(args.reps):
        k += 2
        _timed(paths["pageable"], [pool[k % 16]], 8e-3, card)
        xs.append(_timed(paths["staged"], [pool[(k + 1) % 16]], 0, card))
    print(json.dumps({"cold_then_staged": _pct(xs[5:])}), flush=True)


if __name__ == "__main__":
    main()
