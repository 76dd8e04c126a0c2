"""Time the fused stencil kernel (K1a-K1d) of a source tree on the card.

    PYTHONPATH=<tree>/src python3 tools/kernel_times.py \
        [--tag NAME] [--iters 20] [--depth 1] [--bare]

``repro_torch`` is imported from whichever tree
``PYTHONPATH`` names: one call can time two commits of the kernel on one
card (unpack the other commit with ``git archive`` and run parent,
change, change, parent). For each of the seven spatial pipelines at
1080p, R=8 and a batch of four frames, and each of the four video
pipelines over a chunk of four frames and random frame-ring states, at
the executors' default launch geometry, prints one JSON line with both
clocks -- the mean time of one call (CUDA events over ``--iters`` calls
after two warm-up calls, host included) and the kernel's device time
(``perf/timing.py::device_ms``, the profiler) -- the CTAs, threads,
shared memory and CTAs per SM of the launch, and a hash of the output,
so two trees can also be checked for equal pixels, and, in trees that
have ``kernel_attributes``, the registers and local memory bytes a
thread of the instantiation that ran, read from the loaded library. A
last line holds the sums and ptxas's registers and spill bytes per
instantiation of the libraries nvcc built in this run. Uses
only ``build_program``, the wrapper and ``blocks_per_sm``, whose
signatures every tree of the port shares, and ``perf.measure.card_info``,
which trees with the perf lab have; ``--depth`` above 1 passes
``prefetch_depth``, which only trees with the prefetch kernel take.
``--bare`` times the bare forms instead (``core/expr.py::bare_pipeline``:
every payload replaced by its eager function, so every stage runs in the
expression body; trees since user-written stage functions), the
libraries built first in one wave where the tree builds one per program
(``build_libraries``).
Needs an NVIDIA GPU; the card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import hashlib
import json

import numpy as np
import torch

from repro_torch.core import algorithms
from repro_torch.core.codegen import compile_pipeline
from repro_torch.kernels import _build
from repro_torch.kernels import stencil_pipeline as sp
from repro_torch.perf.measure import card_info
from repro_torch.perf.timing import device_ms, event_ms

H, W, R, B = 1080, 1920, 8, 4


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--depth", type=int, default=1,
                    help="prefetch depth of the programs timed")
    ap.add_argument("--bare", action="store_true",
                    help="time the bare forms (the expression body)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    smi = card_info()["nvidia_smi"]
    print(json.dumps({"tag": args.tag, "nvidia_smi": smi}), flush=True)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(B, H, W).astype(np.float32)).cuda()
    extra = {"prefetch_depth": args.depth} if args.depth != 1 else {}
    dags = [algorithms.ALGORITHMS[n]() for n in sorted(algorithms.ALGORITHMS)]
    dags += [algorithms.VIDEO_ALGORITHMS[n]()
             for n in sorted(algorithms.VIDEO_ALGORITHMS)]
    plans = [compile_pipeline(dag, W) for dag in dags]
    if args.bare:
        from repro_torch.core.expr import bare_pipeline
        dags = [bare_pipeline(dag) for dag in dags]
    progs = [sp.build_program(dag, H, W, R, frames=B,
                              alloc_buffers=plan.alloc.buffers, **extra)
             for dag, plan in zip(dags, plans)]
    libraries = ["stencil_pipeline"]
    if hasattr(sp, "build_libraries"):
        sp.build_libraries(progs)
        libraries = sorted({p.library_spec.name for p in progs})
    sums: dict[str, float] = {}
    for dag, prog in zip(dags, progs):
        depths = dag.temporal_depths()
        states = [torch.from_numpy(rng.rand(depths[p] - 1, H, W)
                                   .astype(np.float32)).cuda()
                  for p in prog.states]
        out = sp.stencil_pipeline(prog, [x], states)
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()

        def call():
            sp.stencil_pipeline(prog, [x], states)
        ms = event_ms(call, args.iters)
        dev_ms = device_ms(call, args.iters)[0]
        kind = "video" if dag.is_temporal() else "spatial"
        sums[f"{kind}_ms"] = sums.get(f"{kind}_ms", 0.0) + ms
        sums[f"{kind}_device_ms"] = sums.get(f"{kind}_device_ms", 0.0) \
            + dev_ms
        threads = int(prog.table[sp.H_THREADS]) \
            if hasattr(sp, "H_THREADS") else 256
        print(json.dumps({
            "tag": args.tag, "pipeline": dag.name, "frames": B,
            "depth": args.depth, "strip_w": prog.strip_w,
            "band_h": prog.band_h,
            "ctas": prog.grid_x * prog.grid_y * B, "threads": threads,
            "smem_bytes": prog.smem_bytes,
            "blocks_per_sm": sp.blocks_per_sm(prog),
            **(sp.kernel_attributes(prog)
               if hasattr(sp, "kernel_attributes") else {}),
            "ms": ms, "device_ms": dev_ms,
            "output_sha256": digest[:16]}), flush=True)
    print(json.dumps({"tag": args.tag, "depth": args.depth,
                      "bare": args.bare, **sums,
                      "ptxas": {n: _build.ptxas(n) for n in libraries}}),
          flush=True)


if __name__ == "__main__":
    main()
