"""Observability walkthrough on the PyTorch port: trace a serve, read the
flame summary.

    PYTHONPATH=src python examples/trace_serving_torch.py           # the card
    PYTHONPATH=src python examples/trace_serving_torch.py --full    # 1080p
    PYTHONPATH=src python examples/trace_serving_torch.py --device cpu

Lights up the whole instrumented stack in one run: enable the global
tracer, drain a small autotuned FrameEngine burst (which forces every
layer — DSE search, MILP solve, executor build, cache fill, engine
batching, kernel calls), then export the Chrome/Perfetto trace JSON
(trace_serving.json in the working directory), print the aggregate flame
summary, and scrape the shared metrics registry as Prometheus text. Runs
on the card unless --device cpu (the kernel's plain version).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch._device import device_label, resolve_device  # noqa: E402
from repro_torch.imaging import FrameEngine, FrameRequest  # noqa: E402
from repro_torch.obs import MetricsRegistry, export, trace  # noqa: E402

# (H, W) of each request: the JAX package's, and 1080p
SIZES = {False: (32, 48), True: (1080, 1920)}
N_REQUESTS = 6
EXCERPT = ("frame_engine_frames", "plan_cache_plan",
           "frame_engine_smem_high_water_bytes")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="1080p frames")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    h, w = SIZES[args.full]
    print(f"device: {device_label(dev)}")
    rng = np.random.RandomState(0)

    # 1. turn the global tracer on — before this, span() costs one flag
    # check. The trace holds this run's spans only
    trace.clear()
    trace.enable()
    try:
        # 2. one shared registry = the telemetry plane: the engine's
        # metrics and its PlanCache's stats land under one scrape,
        # disambiguated by prefix
        registry = MetricsRegistry()
        eng = FrameEngine(max_batch=2, max_pending=16, autotune=True,
                          registry=registry, tile_shape=(h, w), device=dev)
        reqs = [FrameRequest(rid=i, pipeline="unsharp-m",
                             frames={"in": rng.rand(h, w).astype(
                                 np.float32)})
                for i in range(N_REQUESTS)]
        results = eng.run(reqs)
        print(f"served {len(results)} frames; p95 latency "
              f"{eng.metrics.latency_s.percentile(95) * 1e3:.2f} ms")

        # 3. export: spans -> Chrome trace_event JSON. Open
        # trace_serving.json in ui.perfetto.dev for the timeline
        data = export.export_global_trace("trace_serving.json",
                                          process_name="trace_serving")
        print(f"\nwrote trace_serving.json "
              f"({sum(1 for e in data['traceEvents'] if e['ph'] == 'X')} "
              f"spans)\n")
    finally:
        trace.disable()

    # 4. the terminal answer to "where did the milliseconds go": per span
    # name, call count, total and *self* wall time (children subtracted)
    print(export.flame_summary(data, top=12))

    # 5. the same run's counters/gauges/histograms, Prometheus-style
    print("\n--- telemetry plane (excerpt) ---")
    text = registry.to_prometheus_text()
    excerpt = [line for line in text.splitlines()
               if line.startswith(EXCERPT)]
    print("\n".join(excerpt))

    # 6. or as one JSON-able dict, cache included
    snap = eng.snapshot()
    print(f"\nsnapshot: completed={snap['frames_completed']} "
          f"batches={snap['batches']} "
          f"plans_resident={snap['cache']['plans_resident']} "
          f"cache_smem={snap['cache']['smem_bytes']} B")
    return {"trace": data, "excerpt": excerpt, "requests": reqs,
            "results": results, "dag": eng.cache.dag_for("unsharp-m")}


if __name__ == "__main__":
    main()
