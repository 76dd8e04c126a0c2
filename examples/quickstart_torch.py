"""Quickstart on the PyTorch port: compile an image pipeline with ImaGen,
verify it cycle-accurately, and run it as one fused CUDA kernel.

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --full     # 1920x1080
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Runs on the card unless --device cpu (the kernel's plain version).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch._device import device_label, resolve_device  # noqa: E402
from repro_torch.core import DP, DPLC, algorithms, compile_pipeline  # noqa
from repro_torch.kernels import ops, ref  # noqa: E402

# (W, H): the JAX package's example, and the served 1080p frame
SIZES = {False: (128, 96), True: (1920, 1080)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="a 1920x1080 frame (the served size)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = SIZES[args.full]
    print(f"device: {device_label(dev)}")

    # 1. pick an algorithm (paper Tbl. 3) and compile it
    dag = algorithms.unsharp_m()
    plan = compile_pipeline(dag, w, mem=DP)
    print(plan.pseudo_rtl())
    print(f"\nSRAM: {plan.total_alloc_bits/1024:.0f} Kb in "
          f"{plan.alloc.total_blocks} blocks; relative power {plan.power:.1f}")

    # 2. the cycle-accurate simulator proves R1/R2/R3 (no stalls @ 1 px/cycle)
    rep = plan.verify(h)
    print(f"simulation: ok={rep.ok} throughput={rep.throughput} px/cycle "
          f"latency={rep.latency_cycles} cycles")

    # 3. line coalescing (paper Sec. 6) packs lines into wide words
    lc = compile_pipeline(dag, w, mem=DPLC)
    print(f"with coalescing: {lc.total_alloc_bits/1024:.0f} Kb in "
          f"{lc.alloc.total_blocks} blocks "
          f"({100*(1-lc.total_alloc_bits/plan.total_alloc_bits):.0f}% saved)")

    # 4. run the whole pipeline as ONE fused kernel (shared-memory line
    # rings), against the kernel's plain version on the same device
    img = np.random.RandomState(0).rand(h, w).astype(np.float32)
    out = ops.fused_pipeline(dag, {"in": img}, plan=plan, device=dev)
    exp = ref.stencil_pipeline_ref(dag, {"in": torch.from_numpy(img).to(dev)})
    smem = ops.pipeline_smem_bytes(dag, h, w, plan, device=dev)
    print(f"fused kernel vs plain version: max err "
          f"{float((out - exp).abs().max()):.2e}; "
          f"shared memory {smem} bytes a CTA")
    return {"dag": dag, "plan": plan, "report": rep, "lc": lc, "img": img,
            "out": out, "smem_bytes": smem}


if __name__ == "__main__":
    main()
