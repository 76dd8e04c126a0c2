"""Video-serving quickstart on the PyTorch port: temporal pipelines, frame
rings, streams.

    PYTHONPATH=src python examples/stream_video_torch.py           # the card
    PYTHONPATH=src python examples/stream_video_torch.py --full    # 1080p
    PYTHONPATH=src python examples/stream_video_torch.py --device cpu

Walks the temporal subsystem end to end: a DSL pipeline with a temporal
read, the frame-ring executor driven by hand, and a VideoEngine
multiplexing two streams of the same pipeline without sharing history.
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
from repro_torch.core import algorithms  # noqa: E402
from repro_torch.core.dsl import Pipeline  # noqa: E402
from repro_torch.imaging import PlanCache  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.video import VideoEngine, make_video_executor  # noqa: E402

# (T, H, W): the JAX package's stream, and 1080p
SIZES = {False: (12, 32, 48), True: (12, 1080, 1920)}


def my_tunsharp():
    """Sharpen each frame against a 3-frame, 3x3 spatio-temporal mean;
    reads are (ref, st, sh, sw). The payloads are the port's op codes, so
    this DAG resolves to the kernel's stage table like a registered one."""
    p = Pipeline("my-tunsharp")
    x = p.input("in")
    avg = p.stage("stavg", [(x, 3, 3, 3)], algorithms.stmean_fn(3, 3, 3))
    sh = p.stage("sharp", [(x, 1, 1), (avg, 1, 1)], algorithms.tunsharp_fn)
    p.output("out", [(sh, 1, 1)])
    return p.build()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="1080p streams")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t_len, h, w = SIZES[args.full]
    print(f"device: {device_label(dev)}")
    rng = np.random.RandomState(0)

    # 1. a temporal pipeline in the DSL
    dag = my_tunsharp()
    print(f"{dag.name}: temporal depth {dag.temporal_depths()}, "
          f"cumulative extent (back, up, left) = "
          f"{dag.cumulative_extent(temporal=True)}")

    # 2. the executor, driven by hand: history is explicit state — zeros at
    # stream start (warm-up), rolled forward by every call
    ex = make_video_executor(dag, h, w, rows_per_step=8, device=dev)
    state = ex.init_state()
    vid = rng.rand(t_len, h, w).astype(np.float32)
    outs = []
    for t in range(t_len):
        out, state = ex({"in": vid[t]}, state)
        outs.append(out)
    hand = torch.stack(outs)
    exp = ref.video_pipeline_ref(dag, {"in": torch.from_numpy(vid).to(dev)})
    print(f"hand-driven stream: max|err| vs multi-frame plain version = "
          f"{float((hand - exp).abs().max()):.2e}, "
          f"frame-ring state {ex.frame_state_bytes} B, "
          f"shared memory {ex.smem_bytes} B a CTA, "
          f"warm-up {ex.warmup_frames} frames")

    # 3. the engine: two interleaved streams of a registered pipeline — the
    # compiled executor is shared, the frame rings are not
    cache = PlanCache(device=dev)
    eng = VideoEngine(cache=cache, chunk=4)
    vids = [rng.rand(t_len, h, w).astype(np.float32) for _ in range(2)]
    sids = [eng.open_stream("tbackground-t", h, w) for _ in range(2)]
    results = eng.run({sid: [{"in": f} for f in v]
                       for sid, v in zip(sids, vids)})
    streams = {}
    for sid, v in zip(sids, vids):
        exp = ref.video_pipeline_ref(cache.dag_for("tbackground-t"),
                                     {"in": torch.from_numpy(v).to(dev)})
        got = torch.stack([torch.as_tensor(o) for o in results[sid]])
        streams[sid] = (v, got)
        print(f"stream {sid}: {len(results[sid])} frames, "
              f"max|err| vs own plain version = "
              f"{float((got - exp).abs().max()):.2e}")
    snap = eng.snapshot()
    print(f"engine: {snap['frames_completed']} frames, "
          f"{snap['fps_execute']:.1f} f/s (execute), warm-up latency "
          f"{snap['warmup_latency']['mean'] * 1e3:.1f} ms, "
          f"shared-memory high-water {snap['smem_high_water_bytes']} B")
    return {"dag": dag, "video": vid, "hand": hand, "streams": streams,
            "engine_dag": cache.dag_for("tbackground-t")}


if __name__ == "__main__":
    main()
