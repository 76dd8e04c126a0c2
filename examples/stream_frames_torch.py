"""Frame-serving quickstart on the PyTorch port: compile once, stream frames.

    PYTHONPATH=src python examples/stream_frames_torch.py           # the card
    PYTHONPATH=src python examples/stream_frames_torch.py --full    # 1080p
    PYTHONPATH=src python examples/stream_frames_torch.py --device cpu

Walks the three layers of the imaging subsystem on one pipeline: a
PlanCache hit/miss, a tiled oversize frame, and a FrameEngine draining a
small burst with continuous batching. Runs on the card unless --device
cpu (the kernel's plain version).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch._device import device_label, resolve_device  # noqa: E402
from repro_torch.imaging import (FrameEngine, FrameRequest,  # noqa: E402
                                 PlanCache, execute_tiled)
from repro_torch.kernels import ref  # noqa: E402

# w: the compiled width; rows: the row-group frame's height; frame: the
# tiled frame, larger than the tile; req: each engine request, which fits
# the engine's tile. The JAX package's sizes, and 1080p with the smoke's
# 256x512 tile for canny-m
SIZES = {
    False: dict(w=48, rows=64, frame=(100, 140), tile=(40, 48),
                req=(32, 48), engine_tile=(40, 48)),
    True: dict(w=1920, rows=1080, frame=(1080, 1920), tile=(256, 512),
               req=(1080, 1920), engine_tile=(1080, 1920)),
}
N_REQUESTS = 10


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="1920-wide plans and 1080p frames")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sz = SIZES[args.full]
    w = sz["w"]
    print(f"device: {device_label(dev)}")
    rng = np.random.RandomState(0)

    # 1. plan cache: the second lookup is a pure cache hit
    cache = PlanCache(device=dev)
    plan = cache.plan_for("canny-m", w=w)
    plan2 = cache.plan_for("canny-m", w=w)
    if plan is not plan2:
        raise RuntimeError("the second plan_for was not a cache hit")
    print(f"plan {plan.dag.name} W={plan.w}: {plan.total_alloc_bits} bits, "
          f"fingerprint {plan.fingerprint()[:12]}, "
          f"stats {cache.stats.snapshot()}")

    # 1b. row-group execution: same plan, 8 rows per step — identical
    # output, a fraction of the steps
    img = rng.rand(sz["rows"], w).astype(np.float32)
    e1 = cache.executor_for("canny-m", sz["rows"], w, rows_per_step=1)
    e8 = cache.executor_for("canny-m", sz["rows"], w, rows_per_step=8)
    r1, r8 = e1({"in": img}), e8({"in": img})
    print(f"row-group R=8: max|out_r8 - out_r1| = "
          f"{float((r8 - r1).abs().max()):.2e}, "
          f"shared memory {e1.smem_bytes} -> {e8.smem_bytes} B a CTA")

    # 2. tiled execution: a frame larger than the tile through the
    # tile-wide compiled plan
    fh, fw = sz["frame"]
    th, tw = sz["tile"]
    frame = rng.rand(fh, fw).astype(np.float32)
    tiled = execute_tiled(cache, "canny-m", {"in": frame}, tile_h=th,
                          tile_w=tw)
    exp = ref.stencil_pipeline_ref(cache.dag_for("canny-m"),
                                   {"in": torch.from_numpy(frame).to(dev)})
    print(f"tiled {fh}x{fw} frame ({th}x{tw} tiles): max|err| vs plain "
          f"version = {float((tiled - exp).abs().max()):.2e}")

    # 3. engine: a burst of mixed-pipeline requests, batched per pipeline
    eng = FrameEngine(cache=cache, max_batch=4, max_pending=16,
                      tile_shape=sz["engine_tile"])
    reqs = [FrameRequest(rid=i, pipeline=["canny-m", "unsharp-m"][i % 2],
                         frames={"in": rng.rand(*sz["req"]).astype(
                             np.float32)})
            for i in range(N_REQUESTS)]
    results = eng.run(reqs)
    snap = eng.metrics.snapshot()
    print(f"engine: {snap['frames_completed']} frames in {snap['batches']} "
          f"batches, fill {snap['mean_batch_fill']:.2f}, "
          f"{snap['fps_execute']:.1f} f/s (execute), "
          f"shared-memory high-water {snap['smem_high_water_bytes']} B")
    return {"cache": cache, "plan": plan, "img": img, "r1": r1, "r8": r8,
            "frame": frame, "tiled": tiled, "requests": reqs,
            "results": results}


if __name__ == "__main__":
    main()
