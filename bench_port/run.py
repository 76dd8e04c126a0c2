"""Run one cell of the port's benchmark once.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up (imports, the card, the kernel libraries, which the first run
of a checkout builds into src/repro_torch/kernels/_build/, the engine,
the frame pool and the warm-up) ends where the window opens. The last
line of standard output is the result; the compared numbers are the last
lines of standard error. ``--trace 1`` reports the per-layer metrics of a
traced window instead of the end-to-end ones.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench_port.harness import cell, guard

    bench, spec, config, mix = cell.load(args.workload, ROOT)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < spec["chips"]:
        print(f"run: the cell needs {spec['chips']} CUDA card(s), this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != ROOT / "src":
        print(f"run: repro_torch loaded from {repro_torch.__file__}, not "
              f"from this checkout", file=sys.stderr)
        return 3
    result, lines = cell.run(bench, spec, config, mix, args.seed,
                             args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START)
    found = guard.forbidden_modules()
    if found:
        print(f"run: the process loaded {found}", file=sys.stderr)
        return 4
    cell.report(result, lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
