"""Find an open-loop cell's knee by a sweep over its number of clients.

    python3 bench_port/sweep.py --workload video4-1080p.cams30 \
        --clients 5 6 7 8 --seeds 1 2 --seconds 51

Runs the cell once per client count and seed, in one process, with
everything else as the cell states, and prints one JSON line per window:
fps, latency_p95_ms, the frames still pending as the window closed, the
frames refused or never delivered, and whether the window sustained its
count. A window sustains it when every frame came, the 95th percentile
of latency stays within one period of a client's rate, and no more
frames were pending at the close than there are clients. The knee is
the highest count below the first that a window, any window, did not
sustain; the last line gives it, four fifths of it rounded down, and
that rounded down to a whole number of clients a pipeline.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench_port.harness import cell  # noqa: E402


def sustained(row: dict, clients: int, period_ms: float) -> bool:
    return (row["undelivered"] == 0 and row["refused"] == 0
            and row["latency_p95_ms"] <= period_ms
            and row["backlog_end"] <= clients)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--clients", type=int, nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 3
    bench, spec, config, mix = cell.load(args.workload, ROOT)
    if "clients" not in mix:
        print("sweep: the cell's mix sets no client count", file=sys.stderr)
        return 2
    period_ms = 1e3 / mix["rate_hz"]
    bench = dict(bench, end_to_end=[
        {"name": n, "unit": u, "workloads": [spec["name"]]}
        for n, u in (("fps", "frames/s"), ("latency_p95_ms", "ms"),
                     ("setup_s", "s"))])
    knee = None
    for n in sorted(args.clients):
        held = True
        for seed in args.seeds:
            r, _ = cell.run(bench, spec, config, dict(mix, clients=n), seed,
                            args.seconds, False, torch.device("cuda", 0),
                            time.perf_counter())
            row = {"clients": n, "seed": seed,
                   **{k: v["value"] for k, v in r["metrics"].items()
                      if k != "setup_s"},
                   "backlog_end": r["load"]["backlog_end"],
                   "refused": r["load"]["refused"],
                   "undelivered": r["checks"]["undelivered"]["value"],
                   "correct": r["correct"]}
            row["sustained"] = sustained(row, n, period_ms)
            print(json.dumps(row), flush=True)
            held = held and row["sustained"]
        if not held:
            break
        knee = n
    p = len(config["pipelines"])
    cell_clients = None if knee is None else int(knee * 4 // 5)
    print(json.dumps({"knee": knee, "four_fifths": cell_clients,
                      "even": None if knee is None
                      else cell_clients // p * p}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
