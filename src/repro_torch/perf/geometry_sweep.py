"""Sweep the fused stencil kernel's launch geometry on the card.

    python -m repro_torch.perf.geometry_sweep [--iters 20] [--seed 0]

For each of the seven spatial pipelines at 1080p and R=8, single frames
and batches of four, times one launch (CUDA events, mean over ``--iters``
launches after two warm-up launches) for every (strip width, CTA target)
pair, and prints one JSON line per cell: the CTAs of the launch, how many
fit on one SM at its shared memory, the waves that makes, and the time.
Every output is checked bitwise against the default geometry's. Needs an
NVIDIA GPU; the card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from repro_torch.core import algorithms
from repro_torch.core.codegen import compile_pipeline
from repro_torch.kernels import stencil_pipeline as sp

STRIPS = (64, 128)
TARGETS = (264, 528, 1056, 2112, 4224)
H, W, R = 1080, 1920, 8


def _ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("geometry_sweep: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.RandomState(args.seed)
    for name in sorted(algorithms.ALGORITHMS):
        dag = algorithms.ALGORITHMS[name]()
        plan = compile_pipeline(dag, W)
        for frames in (1, 4):
            x = torch.from_numpy(rng.rand(frames, H, W).astype(np.float32))
            x = x.cuda()
            base = sp.build_program(dag, H, W, R, frames=frames,
                                    alloc_buffers=plan.alloc.buffers)
            ref = sp.stencil_pipeline(base, [x])
            for strip in STRIPS:
                for target in TARGETS:
                    prog = sp.build_program(
                        dag, H, W, R, frames=frames,
                        alloc_buffers=plan.alloc.buffers, strip_w=strip,
                        target_ctas=target)
                    out = sp.stencil_pipeline(prog, [x])
                    if not torch.equal(out, ref):
                        raise SystemExit(f"{name} strip={strip} target="
                                         f"{target}: output differs")
                    occ = sp.blocks_per_sm(prog)
                    ctas = prog.grid_x * prog.grid_y * frames
                    print(json.dumps({
                        "pipeline": name, "frames": frames,
                        "strip_w": strip, "target_ctas": target,
                        "band_h": prog.band_h, "ctas": ctas,
                        "smem_bytes": prog.smem_bytes,
                        "blocks_per_sm": occ, "waves": ctas / (occ * sms),
                        "default": (strip, target) == (sp.STRIP_W,
                                                       sp.TARGET_CTAS),
                        "ms": _ms(lambda: sp.stencil_pipeline(prog, [x]),
                                  args.iters)}), flush=True)


if __name__ == "__main__":
    main()
