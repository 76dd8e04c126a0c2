"""Copy/compute overlap on the PyTorch port: prefetch depth as a serving
knob.

    PYTHONPATH=src python examples/overlap_depth_torch.py           # the card
    PYTHONPATH=src python examples/overlap_depth_torch.py --full    # 1080p
    PYTHONPATH=src python examples/overlap_depth_torch.py --device cpu

A compiled plan streams rows synchronously at ``prefetch_depth=1``; at
depth 2/4 the fused kernel copies row groups ahead into its grown
shared-memory line rings with cp.async, so copies hide behind compute.
Depth is a pure scheduling change — outputs are identical — and only
DMA-bound pipelines (the perf model's roofline split of the modeled
accelerator) can win from it. This script classifies one compute-bound and
one DMA-bound pipeline, lets the autotuner pick a depth under a ring
budget, and runs the deep executor to show the outputs and the
shared-memory bill. Runs on the card unless --device cpu (the kernel's
plain version).
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch._device import device_label, resolve_device  # noqa: E402
from repro_torch.core import DP, algorithms, dse  # noqa: E402
from repro_torch.imaging import PlanCache  # noqa: E402
from repro_torch.kernels.stencil_pipeline import SMEM_LIMIT  # noqa: E402
from repro_torch.perf import model as perf_model  # noqa: E402

# (W, H): the JAX package's, and 1080p
SIZES = {False: (48, 32), True: (1920, 1080)}
# the JAX package's budget on the modeled accelerator's rings; at 1920
# wide it admits no depth above 1, so --full takes the card's per-block
# shared-memory limit instead
MODEL_BUDGET = 256 * 1024


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="1080p frames")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = SIZES[args.full]
    print(f"device: {device_label(dev)}")
    rng = np.random.RandomState(0)
    cache = PlanCache(device=dev)

    # 1. the roofline split decides who overlaps: cycles are
    #    fill + steady + dma at depth 1 but fill + max(steady, dma) at
    #    depth >= 2, so a compute-bound pipeline gains nothing
    rows = []
    for name in ("unsharp-m", "tdenoise-t"):
        plan = cache.plan_for(name, w)
        for depth in (1, 2, 4):
            m = perf_model.predict(
                dataclasses.replace(plan, prefetch_depth=depth), h)
            rows.append((name, depth, m.bound, m.cycles_per_frame,
                         m.vmem_ring_bytes))
            print(f"{name:11s} depth={depth}  bound={m.bound:7s} "
                  f"cycles/frame={m.cycles_per_frame:5d}  "
                  f"vmem={m.vmem_ring_bytes} B (modeled accelerator)")
        print()

    # 2. the autotuner owns the trade: depth rides the memory-config search
    #    as an extra axis, ranked by (predicted cycles, ring bytes) under a
    #    budget
    if args.full:
        budget = SMEM_LIMIT
        print(f"budget: {budget} B, the card's per-block shared-memory "
              f"limit")
    else:
        budget = MODEL_BUDGET
        print(f"budget: {budget} B of the modeled accelerator's rings")
    res = dse.autotune(algorithms.VIDEO_ALGORITHMS["tdenoise-t"](), w,
                       options=(DP,), frame_h=h, vmem_budget=budget)
    print(f"tdenoise-t autotune: bound={res.bound} "
          f"best_depth={res.best_depth}")
    for row in res.depth_candidates:
        print(f"  depth={row['prefetch_depth']}  "
              f"cycles={row['predicted_cycles_per_frame']:5d}  "
              f"vmem={row['vmem_bytes']:6d} B  "
              f"within_budget={row['within_budget']}")

    # 3. serving opts in per executor — the plan cache derives the depth
    #    sibling without re-running the ILP, and outputs stay bitwise equal
    img = {"in": rng.rand(h, w).astype(np.float32)}
    e1 = cache.executor_for("unsharp-m", h, w)
    e2 = cache.executor_for("unsharp-m", h, w,
                            prefetch_depth=res.best_depth
                            if res.best_depth > 1 else 2)
    o1, o2 = e1(img), e2(img)
    same = bool((o1 == o2).all())
    print(f"\nunsharp-m depth {e1.prefetch_depth} vs {e2.prefetch_depth}: "
          f"bitwise equal = {same}, shared memory {e1.smem_bytes} -> "
          f"{e2.smem_bytes} B a CTA")
    if not same:
        raise RuntimeError("the deep executor's output differs from depth 1")
    return {"predict": rows, "budget": budget, "tuning": res,
            "img": img["in"], "depth1": o1, "deep": o2,
            "depths": (e1.prefetch_depth, e2.prefetch_depth),
            "dag": cache.dag_for("unsharp-m")}


if __name__ == "__main__":
    main()
