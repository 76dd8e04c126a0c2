"""Memtrace walkthrough on the PyTorch port: cycle-level buffer occupancy
for one pipeline, joined to the kernel's shared-memory rings.

    PYTHONPATH=src python examples/memtrace_pipeline_torch.py          # card
    PYTHONPATH=src python examples/memtrace_pipeline_torch.py --full   # 1080p
    PYTHONPATH=src python examples/memtrace_pipeline_torch.py --device cpu

The no-stall checker proves R1-R3 by walking every buffer cycle by
cycle; the memtrace plane keeps what that walk throws away. This script
captures a ``memtrace/v1`` artifact for a compiled pipeline, reads the
ring-rows-vs-peak waste table (a line buffer's allocation is the rows of
its shared-memory ring in the kernel's program), serves a few traced
frames, then merges the cycle-domain occupancy curves into the wall-clock
trace as Perfetto counter tracks. It writes memtrace_unsharp.json and
memtrace_pipeline.json into the working directory; open the second in
ui.perfetto.dev. Runs on the card unless --device cpu (the kernel's plain
version).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch._device import device_label, resolve_device  # noqa: E402
from repro_torch.imaging import FrameEngine, FrameRequest  # noqa: E402
from repro_torch.obs import export, memtrace, trace  # noqa: E402

# (W, H): the JAX package's, and 1080p
SIZES = {False: (48, 32), True: (1920, 1080)}
N_REQUESTS = 4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="1080p frames")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = SIZES[args.full]
    print(f"device: {device_label(dev)}")
    rng = np.random.RandomState(0)

    # 1. engine + cache as usual; memtrace_for() reuses the cached plan, so
    # capturing a memtrace never re-runs the ILP. The trace holds this
    # run's spans only
    trace.clear()
    trace.enable()
    try:
        eng = FrameEngine(max_batch=2, max_pending=16, tile_shape=(h, w),
                          device=dev)
        reqs = [FrameRequest(rid=i, pipeline="unsharp-m",
                             frames={"in": rng.rand(h, w).astype(
                                 np.float32)})
                for i in range(N_REQUESTS)]
        results = eng.run(reqs)
        mt = eng.cache.memtrace_for("unsharp-m", w, h)

        # 2. the artifact is schema-stamped JSON; validate before trusting
        errs = memtrace.validate_memtrace(mt)
        if errs:
            raise ValueError(f"invalid memtrace: {errs}")
        with open("memtrace_unsharp.json", "w") as f:
            json.dump(mt, f, indent=1)
        print(f"wrote memtrace_unsharp.json "
              f"({len(mt['buffers'])} buffers, {mt['cycles']} cycles)\n")

        # 3. the waste table: allocation (the rows of each buffer's shared-
        # memory ring) vs the simulated peak, per buffer
        print(memtrace.memtrace_text(mt))
        s = mt["summary"]
        print(f"\nalloc {s['alloc_bytes']} B, peak {s['peak_bytes']} B "
              f"-> waste {s['waste_frac']:.1%}, shared-memory rings "
              f"{s['smem_ring_bytes']} B a CTA, "
              f"worst port pressure {s['worst_port_pressure']:.2f}")

        # 4. merge the cycle-domain curves into the wall-clock span trace:
        # counter tracks mem:{pipeline}:{buffer} + port:{pipeline}:{stage},
        # anchored to the pipeline's first engine.execute span
        data = export.export_global_trace("memtrace_pipeline.json",
                                          process_name="memtrace_pipeline")
        data = export.merge_counter_tracks(data, [mt])
        errs = export.validate_trace(data)
        if errs:
            raise ValueError(f"invalid merged trace: {errs}")
        export.write_trace("memtrace_pipeline.json", data)
        n_c = sum(1 for e in data["traceEvents"] if e["ph"] == "C")
        print(f"\nwrote memtrace_pipeline.json "
              f"({sum(1 for e in data['traceEvents'] if e['ph'] == 'X')} "
              f"spans, {n_c} counter samples) — open in ui.perfetto.dev")

        # 5. the same capture for an autotuned memory config: the waste
        # columns are directly comparable because the buffers are the same
        mt_tuned = eng.cache.memtrace_for("unsharp-m", w, h, tune=True)
        dw = s["waste_frac"] - mt_tuned["summary"]["waste_frac"]
        print(f"\ntuned mem config: waste "
              f"{mt_tuned['summary']['waste_frac']:.1%} "
              f"({dw:+.1%} vs default)")
    finally:
        trace.disable()
    return {"memtrace": mt, "memtrace_tuned": mt_tuned, "trace": data,
            "requests": reqs, "results": results,
            "dag": eng.cache.dag_for("unsharp-m")}


if __name__ == "__main__":
    main()
