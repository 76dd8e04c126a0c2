"""Autotune one pipeline's memory configuration and serve with it, on the
PyTorch port.

    PYTHONPATH=src python examples/tune_pipeline_torch.py           # the card
    PYTHONPATH=src python examples/tune_pipeline_torch.py --full    # 1080p
    PYTHONPATH=src python examples/tune_pipeline_torch.py --device cpu \
        --pipeline canny-m --width 96

Walks the three layers of the autotuning story:

  1. ``core.dse.autotune`` — the raw search: ranked candidates and the
     {ring bytes, power, contention slack} Pareto frontier of the modeled
     accelerator;
  2. ``PlanCache(tune=True)`` — the memoized serving path: one search,
     every executor variant derived from the winner;
  3. ``FrameEngine(autotune=True)`` — end to end: frames served through
     the tuned config, output identical to the default config's.

Runs on the card unless --device cpu (the kernel's plain version).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch._device import device_label, resolve_device  # noqa: E402
from repro_torch.core import algorithms, dse  # noqa: E402
from repro_torch.imaging import PlanCache  # noqa: E402
from repro_torch.imaging.engine import FrameEngine, FrameRequest  # noqa

# (width, frame height): the JAX package's, and 1080p
SIZES = {False: (64, 48), True: (1920, 1080)}
N_FRAMES = 4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipeline", default="unsharp-m",
                    choices=sorted(algorithms.ALGORITHMS))
    ap.add_argument("--width", type=int, default=None,
                    help="default 64, 1920 with --full")
    ap.add_argument("--full", action="store_true",
                    help="1920-wide plans and 1080p frames")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    width, frame_h = SIZES[args.full]
    width = args.width or width
    print(f"device: {device_label(dev)}")

    # 1. the raw search ---------------------------------------------------
    dag = algorithms.ALGORITHMS[args.pipeline]()
    res = dse.autotune(dag, width)
    d, b = res.default, res.best
    print(f"{args.pipeline} @ w={width}: searched "
          f"{res.stats.n_compiled}/{res.stats.space_size} combos "
          f"in {res.stats.tune_s:.2f}s")
    print(f"  default (DP): vmem={d.vmem_bytes}B power={d.power:.2f} "
          f"alloc={d.alloc_bits}b")
    print(f"  best {b.combo}: vmem={b.vmem_bytes}B power={b.power:.2f} "
          f"alloc={b.alloc_bits}b")
    print("  Pareto frontier (vmem B of the modeled accelerator, power, "
          "slack):")
    for c in res.pareto():
        print(f"    {c.vmem_bytes:>8} {c.power:>8.2f} "
              f"{c.contention_slack:>3}   {c.combo}")

    # 2. the serving cache ------------------------------------------------
    cache = PlanCache(device=dev)
    plan = cache.plan_for(args.pipeline, width, tune=True)
    cache.plan_for(args.pipeline, width, rows_per_step=8, tune=True)
    print(f"cache: {cache.stats.tunes} search(es), plan fingerprint "
          f"{plan.fingerprint()[:12]}, R-sibling derived without re-solve")

    # 3. the engine -------------------------------------------------------
    eng = FrameEngine(cache=cache, autotune=True, max_batch=2,
                      tile_shape=(frame_h, width))
    rng = np.random.RandomState(0)
    frames = [rng.rand(frame_h, width).astype(np.float32)
              for _ in range(N_FRAMES)]
    outs = eng.run([FrameRequest(i, args.pipeline, {"in": f})
                    for i, f in enumerate(frames)])
    print(f"served {len(outs)} frames through the tuned config "
          f"(shared-memory high water {eng.metrics.smem_high_water}B)")
    return {"tuning": res, "plan": plan, "frames": frames, "outputs": outs,
            "dag": cache.dag_for(args.pipeline)}


if __name__ == "__main__":
    main()
