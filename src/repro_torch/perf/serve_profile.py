"""Where the serving path's time goes on the card.

    python -m repro_torch.perf.serve_profile [--requests 8] [--seed 0]

Serves ``--requests`` 1080p frames of each of the seven spatial pipelines
through ``FrameEngine`` (B=4, R=8, untiled) twice after a warm-up round:
once on the host clock alone, once under ``torch.profiler``. Prints one
JSON line: the wall time of each run (each ends in a device synchronise),
the engine's ``execute_s``, the device time by kernel or copy name, the
device's busy and idle shares of the traced run, and the bytes the frames
carry from the host. Needs an NVIDIA GPU; the card's name and power limit
come first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import algorithms
from repro_torch.imaging import FrameEngine, FrameRequest

H, W, B, R = 1080, 1920, 4, 8


def _requests(names, per_pipeline: int, seed: int) -> list[FrameRequest]:
    rng = np.random.RandomState(seed)
    return [FrameRequest(rid=i, pipeline=names[i % len(names)],
                         frames={"in": rng.rand(H, W).astype(np.float32)})
            for i in range(per_pipeline * len(names))]


def _serve(engine: FrameEngine, reqs) -> tuple[float, float]:
    """(wall seconds, engine execute seconds) of serving ``reqs``."""
    ex0 = engine.metrics.execute_s
    t0 = time.perf_counter()
    out = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(out) != len(reqs) or not all(
            isinstance(v, torch.Tensor) for v in out.values()):
        raise SystemExit("serve_profile: a request was not served")
    return wall, engine.metrics.execute_s - ex0


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    raise SystemExit("serve_profile: the profiler reports no device time")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=8,
                    help="1080p frames per pipeline")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_profile: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    names = sorted(algorithms.ALGORITHMS)
    engine = FrameEngine(device="cuda", max_batch=B, rows_per_step=R,
                         tile_shape=(H, W))
    _serve(engine, _requests(names, 1, args.seed + 1))      # warm-up
    reqs = _requests(names, args.requests, args.seed)
    wall, execute = _serve(engine, reqs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_wall, traced_execute = _serve(engine, reqs)
    by_name: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.key] = by_name.get(evt.key, 0.0) \
                + _device_us(evt) / 1e6
    busy = sum(by_name.values())
    if busy == 0.0:
        raise SystemExit("serve_profile: the trace holds no device time")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "frames": len(reqs),
        "shape": [H, W], "batch": B, "rows_per_step": R,
        "wall_s": wall, "execute_s": execute, "fps": len(reqs) / wall,
        "traced_wall_s": traced_wall, "traced_execute_s": traced_execute,
        "device_busy_s": busy, "device_idle_share": 1.0 - busy / traced_wall,
        "device_s_by_name": dict(sorted(by_name.items(),
                                        key=lambda kv: -kv[1])),
        "host_to_device_bytes": len(reqs) * H * W * 4,
    }), flush=True)


if __name__ == "__main__":
    main()
