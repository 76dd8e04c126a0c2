"""The readings that set the limits of ``correct``: the program on a dozen
seeds, its lower-precision control, and the faults a cell can have.

    python3 bench_port/control.py --workload <name> --seeds 1 2 ... \
        --control-seeds 3 --seconds 3

Runs the cell's own path at its own size in one process, once per seed,
and prints one JSON line per run: which side ran (``program``, the
``control`` or a fault), the seed and every compared number. The
control is the plain reference, computed in bfloat16 (the precision
below the configurations' float32), put in the kernel's place. The
faults break the timed path underneath: ``alter`` changes a pixel of
every output where the kernel writes it, ``drop_half`` leaves half of a
batch out and fills it with the mean of the rest, ``stale_state`` returns
a stream's frame rings unchanged. The benchmark's own runs run none of
this; ``bench_port/tests`` runs it at a small size on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench_port.harness import cell  # noqa: E402
from bench_port.reference import pipelines as reference  # noqa: E402


@contextlib.contextmanager
def kernel_replaced(fn):
    """Every executor's kernel call goes through ``fn(kernel, program,
    feeds, states)`` while the block runs."""
    import repro_torch.kernels.stencil_pipeline as sp
    kernel = sp.stencil_pipeline
    sp.stencil_pipeline = lambda program, feeds, states=(): \
        fn(kernel, program, feeds, states)
    try:
        yield
    finally:
        sp.stencil_pipeline = kernel


def control_kernel(kernel, program, feeds, states):
    """The reference in bfloat16 in the kernel's place: frame b of a
    launch reads the launch's earlier frames and the stream's rings."""
    if list(program.feeds) != ["in"] or list(program.states) not in \
            ([], ["in"]) or program.frame_outs:
        raise ValueError(f"{program.dag.name}: the control takes one input "
                         f"and rings of that input only")
    x = feeds[0]
    past = states[0].flip(0) if states else x[:0]
    return torch.stack([
        reference.run(program.dag.name, torch.cat([past, x[:b + 1]]),
                      dtype=reference.CONTROL_DTYPE)
        for b in range(x.shape[0])])


def alter(kernel, program, feeds, states):
    out = kernel(program, feeds, states)
    out[..., 0, 0] += 1.0
    return out


def drop_half(kernel, program, feeds, states):
    out = kernel(program, feeds, states)
    half = out.shape[0] // 2
    if half:
        out[half:] = out[:half].mean(dim=0, keepdim=True)
    return out


@contextlib.contextmanager
def stale_state():
    """Video executors return the stream's rings as they were given."""
    from repro_torch.kernels.stencil_pipeline import VideoExecutor
    call = VideoExecutor.__call__

    def unchanged(self, images, state):
        out, _ = call(self, images, state)
        return out, dict(state)
    VideoExecutor.__call__ = unchanged
    try:
        yield
    finally:
        VideoExecutor.__call__ = call


SIDES = {
    "program": contextlib.nullcontext,
    "control": lambda: kernel_replaced(control_kernel),
    "alter": lambda: kernel_replaced(alter),
    "drop_half": lambda: kernel_replaced(drop_half),
    "stale_state": stale_state,
}
# the faults each server can have
FAULTS = {"frame_engine": ("alter", "drop_half"),
          "video_engine": ("alter", "stale_state")}


def run_side(side: str, bench, spec, config, mix, seed: int,
             seconds: float, device) -> dict:
    with SIDES[side]():
        r, _ = cell.run(bench, spec, config, mix, seed, seconds, False,
                        device, time.perf_counter())
    return {"side": side, "seed": seed, "correct": r["correct"],
            "attempted": r["attempted"],
            "checks": {k: v["value"] for k, v in r["checks"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    bench, spec, config, mix = cell.load(args.workload, ROOT)
    plan = [("program", s) for s in args.seeds]
    plan += [(side, s) for side in ("control", *FAULTS[config["server"]])
             for s in args.seeds[:args.control_seeds]]
    for side, seed in plan:
        print(json.dumps(run_side(side, bench, spec, config, mix, seed,
                                  args.seconds, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
