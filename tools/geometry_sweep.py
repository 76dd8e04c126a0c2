"""Sweep the fused stencil kernel's launch geometry on the card.

    PYTHONPATH=src python3 tools/geometry_sweep.py [--iters 20] [--seed 0]

For each of the seven spatial pipelines at 1080p and R=8, single frames
and batches of four, times one launch (CUDA events, mean over ``--iters``
launches after two warm-up launches) for every (strip width, CTA target)
pair at the default threads per CTA, and for every (strip width,
threads) pair at the default CTA target, and prints one JSON line per
cell: the
strip, band height and threads, the CTAs of the launch, how many fit on
one SM at its threads and shared memory, the waves that makes, the halo
recompute (pixels computed per stage over output pixels), and the time. Every
output is checked bitwise against the default geometry's. Needs an
NVIDIA GPU; the card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.core import algorithms
from repro_torch.core.codegen import compile_pipeline
from repro_torch.kernels import stencil_pipeline as sp
from repro_torch.perf.measure import card_info

STRIPS = (56, 120, 240, 496)
TARGETS = (264, 528, 1056, 2112, 4224)
THREADS = (128, 256)
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
    print(card_info()["nvidia_smi"], flush=True)
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
            cells = [(s, t, sp.THREADS) for s in STRIPS for t in TARGETS]
            cells += [(s, sp.TARGET_CTAS, n) for s in STRIPS
                      for n in THREADS if n != sp.THREADS]
            for strip, target, threads in cells:
                prog = sp.build_program(
                    dag, H, W, R, frames=frames,
                    alloc_buffers=plan.alloc.buffers, strip_w=strip,
                    target_ctas=target, threads=threads)
                out = sp.stencil_pipeline(prog, [x])
                if not torch.equal(out, ref):
                    raise SystemExit(f"{name} strip={strip} target="
                                     f"{target} threads={threads}: "
                                     f"output differs")
                occ = sp.blocks_per_sm(prog)
                ctas = prog.grid_x * prog.grid_y * frames
                up = int(prog.table[sp.H_HALO_UP])
                rows = sum(-(-(min(y + prog.band_h, H) - max(y - up, 0))
                             // R) * R for y in range(0, H, prog.band_h))
                cols = prog.grid_x * int(prog.table[sp.H_NCOLS])
                print(json.dumps({
                    "pipeline": name, "frames": frames,
                    "strip_w": strip, "target_ctas": target,
                    "threads": int(prog.table[sp.H_THREADS]),
                    "band_h": prog.band_h, "ctas": ctas,
                    "smem_bytes": prog.smem_bytes,
                    "blocks_per_sm": occ, "waves": ctas / (occ * sms),
                    "recompute": rows * cols / (H * W),
                    "default": (strip, target, threads) == (
                        sp.STRIP_W, sp.TARGET_CTAS, sp.THREADS),
                    "ms": _ms(lambda: sp.stencil_pipeline(prog, [x]),
                              args.iters)}), flush=True)


if __name__ == "__main__":
    main()
