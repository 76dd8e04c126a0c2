"""Memory-system observability: per-buffer cycle traces (``memtrace/v1``).

Spans and counters show wall-clock behavior; the memory hierarchy itself
(line-buffer fill, frame-ring residency, port pressure) stays a black
box. This module makes it observable, in the JAX package's schema:

  * :func:`capture` plays a compiled :class:`PipelinePlan` through the
    cycle-accurate sampler (:func:`repro_torch.core.simulate.
    sample_buffers`) and emits a schema-stamped ``memtrace/v1`` artifact
    — per buffer: a downsampled occupancy track, a worst-per-block
    port-access track, a derived port-pressure track (accesses / ports)
    and conflict-stall cycle counts, all equal to the JAX package's for
    the same plan; and an allocation-vs-peak-occupancy **waste** join
    against the shared-memory rings the CUDA kernel reserves for the
    plan (:func:`repro_torch.kernels.stencil_pipeline.build_program`),
    where the JAX package joins its TPU VMEM rings.
  * :func:`validate_memtrace` is the structural schema gate; it accepts
    both packages' artifacts.
  * :func:`memtrace_text` renders the terminal table.

Downsampling is max-preserving: cycles are bucketed into at most
``max_samples`` windows and each window reports its *maximum*, so peaks
(the quantity waste and pressure are judged on) survive any stride.
Perfetto counter-track rendering lives in :mod:`repro_torch.obs.export`
(``memtrace_counter_events`` / ``merge_counter_tracks``).
"""
from __future__ import annotations

import numpy as np

MEMTRACE_SCHEMA = "memtrace/v1"


def downsample_max(values: np.ndarray, max_samples: int
                   ) -> tuple[list[int], list[float], int]:
    """Bucket a per-cycle array into <= max_samples windows, keeping the
    max of each window. Returns (bucket start cycles, values, stride)."""
    n = len(values)
    if n == 0:
        return [], [], 1
    stride = max(1, -(-n // max_samples))
    pad = (-n) % stride
    if pad:
        values = np.concatenate(
            [values, np.full(pad, values.min(), values.dtype)])
    chunked = values.reshape(-1, stride)
    t = list(range(0, n, stride))
    return t, chunked.max(axis=1).tolist(), stride


def _waste(capacity: int, peak: int, bytes_per_unit: float) -> dict:
    waste_units = max(capacity - peak, 0)
    return {
        "alloc": capacity,
        "peak": peak,
        "waste": waste_units,
        "waste_frac": waste_units / capacity if capacity else 0.0,
        "alloc_bytes": int(round(capacity * bytes_per_unit)),
        "peak_bytes": int(round(peak * bytes_per_unit)),
    }


def capture(plan, h: int, max_samples: int = 512) -> dict:
    """Sample one frame of a compiled plan into a ``memtrace/v1`` dict.

    ``plan`` is a :class:`repro_torch.core.codegen.PipelinePlan`; ``h``
    the frame height to play (plans are height-independent, so this is
    an execution-shape parameter exactly like the executor's). The
    tracks are the JAX package's. The waste join reads the program the
    kernel runs for the plan at ``(h, plan.w, plan.rows_per_step,
    plan.prefetch_depth)``: a line buffer's ``capacity`` is its ring's
    rows, ``ring`` the ring's index in the program's table, and a row
    costs ``pitch * 4`` bytes of one CTA's shared memory. A simulated
    buffer that has no ring gets ``capacity`` 0 and ``ring`` None, and
    holds no bytes. Frame rings stay full frames in device memory
    (``ring`` None). The summary reconciles with the program:
    ``smem_ring_bytes`` is its ring bill (line, tap and grown feed rows),
    ``prefetch_ring_bytes`` the grown rows' part of it. Raises what
    ``build_program`` raises for a DAG the kernel cannot run. The
    imports are deferred so ``repro_torch.obs`` keeps its small import
    surface for the telemetry-only consumers.
    """
    from repro_torch.core.simulate import sample_buffers
    from repro_torch.kernels import stencil_pipeline as sp

    samples = sample_buffers(plan.dag, plan.schedule, plan.w, h,
                             alloc=plan.alloc, cfg_of=plan.mem_cfg)
    prog = sp.build_program(plan.dag, h, plan.w, plan.rows_per_step,
                            alloc_buffers=plan.alloc.buffers,
                            prefetch_depth=plan.prefetch_depth)
    pitch = int(prog.table[sp.H_PITCH])
    row_bytes = pitch * 4
    base = sp.HDR + sp.MAX_STAGES * sp.STAGE_INTS
    ring_rows = {name: int(prog.table[base + 2 * i + 1])
                 for i, name in enumerate(prog.rings)}
    ring_of = {name: i for i, name in enumerate(prog.rings)}

    buffers: list[dict] = []
    stages: list[dict] = []
    total_peak_bytes = 0
    total_alloc_bytes = 0
    conflict_total = 0
    sampled: set = set()
    for name in sorted(samples):
        s = samples[name]
        t_occ, occ, stride = downsample_max(s.occupancy, max_samples)
        _, acc, _ = downsample_max(s.accesses, max_samples)
        if s.kind == "frame_ring":
            # frame rings live in device-memory full frames, not shared
            # memory rings: account rows at full-line bytes
            ring = None
            capacity = s.capacity
            bytes_per_unit = plan.w * 4
            mem = "-"
        else:
            sampled.add(s.owner)
            ring = ring_of.get(s.owner)
            capacity = ring_rows.get(s.owner, 0)
            bytes_per_unit = row_bytes if ring is not None else 0
            b = plan.alloc.buffers.get(s.owner)
            mem = b.cfg.name if b is not None else "-"
        waste = _waste(capacity, s.peak_occupancy, bytes_per_unit)
        total_alloc_bytes += waste["alloc_bytes"]
        total_peak_bytes += waste["peak_bytes"]
        conflict_total += s.conflict_cycles
        entry = {
            "name": name,
            "kind": s.kind,
            "stage": s.owner,
            "unit": s.unit,
            "mem": mem,
            "ports": s.ports,
            "pack": s.pack,
            "capacity": capacity,
            "ring": ring,
            "n_lines_phys": s.capacity if s.kind == "line_buffer" else None,
            "peak_occupancy": s.peak_occupancy,
            "peak_accesses": s.peak_accesses,
            "port_pressure_peak": (s.peak_accesses / s.ports
                                   if s.ports else 0.0),
            "conflict_cycles": s.conflict_cycles,
            "waste": waste,
            "t": t_occ,
            "occupancy": occ,
            "accesses": acc,
            "sample_stride": stride,
        }
        buffers.append(entry)
        if s.ports:
            t_p, press, _ = downsample_max(
                s.accesses.astype(np.float64) / s.ports, max_samples)
            stages.append({
                "stage": s.owner,
                "ports": s.ports,
                "t": t_p,
                "port_pressure": press,
                "peak": s.peak_accesses / s.ports,
            })

    cycles = int(max(plan.schedule.starts.values()) + plan.w * h)
    # rings the simulator never samples still count in the allocation:
    # history-tap rings (history frames stream at exactly slab rate) and
    # the ring of an input only the output reads, which exists to land
    # its copies at prefetch depth >= 2
    tap_bytes = sum(rows * row_bytes for name, rows in ring_rows.items()
                    if isinstance(name, tuple))
    unsampled_bytes = sum(rows * row_bytes
                          for name, rows in ring_rows.items()
                          if not isinstance(name, tuple)
                          and name not in sampled)
    total_alloc_bytes += tap_bytes + unsampled_bytes
    return {
        "schema": MEMTRACE_SCHEMA,
        "pipeline": plan.dag.name,
        "w": plan.w,
        "h": h,
        "rows_per_step": plan.rows_per_step,
        "prefetch_depth": plan.prefetch_depth,
        "cycles": cycles,
        "mem_cfg": {s: c.name for s, c in plan.mem_cfg.items()},
        "buffers": buffers,
        "stages": stages,
        "summary": {
            "n_buffers": len(buffers),
            "smem_ring_bytes": int(prog.table[sp.H_OSTAGE]) * 4,
            "smem_bytes": prog.smem_bytes,
            "pitch": pitch,
            "strip_w": prog.strip_w,
            "tap_ring_bytes": tap_bytes,
            "unsampled_ring_bytes": unsampled_bytes,
            "prefetch_ring_bytes": prog.prefetch_bytes,
            "alloc_bytes": total_alloc_bytes,
            "peak_bytes": total_peak_bytes,
            "waste_bytes": max(total_alloc_bytes - total_peak_bytes, 0),
            "waste_frac": (max(total_alloc_bytes - total_peak_bytes, 0)
                           / total_alloc_bytes if total_alloc_bytes
                           else 0.0),
            "conflict_cycles": conflict_total,
            "worst_port_pressure": max(
                (b["port_pressure_peak"] for b in buffers), default=0.0),
        },
    }


# ---------------------------------------------------------------- schema
def validate_memtrace(data) -> list[str]:
    """Structural schema check; returns error strings (empty = valid)."""
    errs: list[str] = []
    if not isinstance(data, dict):
        return [f"memtrace must be a dict, got {type(data).__name__}"]
    if data.get("schema") != MEMTRACE_SCHEMA:
        errs.append(f"schema is {data.get('schema')!r}, "
                    f"expected {MEMTRACE_SCHEMA!r}")
    for k in ("pipeline", "w", "h", "cycles"):
        if k not in data:
            errs.append(f"missing top-level key {k!r}")
    bufs = data.get("buffers")
    if not isinstance(bufs, list) or not bufs:
        return errs + ["missing or empty 'buffers' list"]
    for i, b in enumerate(bufs):
        where = f"buffers[{i}]"
        if not isinstance(b, dict):
            errs.append(f"{where}: not a dict")
            continue
        for k in ("name", "kind", "stage", "capacity", "peak_occupancy",
                  "t", "occupancy", "accesses", "waste"):
            if k not in b:
                errs.append(f"{where}: missing key {k!r}")
        if b.get("kind") not in ("line_buffer", "frame_ring"):
            errs.append(f"{where}: kind must be 'line_buffer' or "
                        f"'frame_ring', got {b.get('kind')!r}")
        t, occ = b.get("t"), b.get("occupancy")
        if isinstance(t, list) and isinstance(occ, list):
            if len(t) != len(occ):
                errs.append(f"{where}: t and occupancy lengths differ "
                            f"({len(t)} vs {len(occ)})")
            if occ and isinstance(b.get("peak_occupancy"), (int, float)) \
                    and max(occ) > b["peak_occupancy"]:
                errs.append(f"{where}: occupancy series exceeds "
                            f"peak_occupancy")
        wst = b.get("waste")
        if isinstance(wst, dict):
            wf = wst.get("waste_frac")
            if not isinstance(wf, (int, float)) or not 0.0 <= wf <= 1.0:
                errs.append(f"{where}.waste: waste_frac must be in "
                            f"[0, 1], got {wf!r}")
        elif wst is not None:
            errs.append(f"{where}: waste must be a dict")
    for i, st in enumerate(data.get("stages", [])):
        where = f"stages[{i}]"
        if not isinstance(st, dict) or "stage" not in st \
                or "port_pressure" not in st:
            errs.append(f"{where}: must be a dict with stage + "
                        f"port_pressure")
    summ = data.get("summary")
    if not isinstance(summ, dict):
        errs.append("missing 'summary' dict")
    return errs


# ---------------------------------------------------------------- render
def memtrace_text(data: dict) -> str:
    """Terminal table of a ``memtrace/v1`` dict: per buffer its ring rows
    (``alloc``), peak occupancy, waste, port pressure and stalls."""
    s = data.get("summary", {})
    # the port's artifacts carry the kernel's shared-memory rings; the JAX
    # package's render as the JAX package renders them
    port = "smem_ring_bytes" in s
    depth = f"  depth={data.get('prefetch_depth')}" if port else ""
    smem = (f"shared-memory rings {s.get('smem_ring_bytes', 0)} B a CTA "
            f"(prefetch {s.get('prefetch_ring_bytes', 0)} B), "
            if port else "")
    head = (f"memtrace {data.get('pipeline')}  "
            f"{data.get('h')}x{data.get('w')}  R={data.get('rows_per_step')}"
            f"{depth}  cycles/frame={data.get('cycles')}")
    rows = [head,
            f"{'buffer':<18} {'kind':<11} {'mem':>5} {'P':>2} "
            f"{'alloc':>6} {'peak':>5} {'waste%':>7} {'acc/P':>6} "
            f"{'stalls':>6}"]
    for b in data.get("buffers", []):
        rows.append(
            f"{b['name']:<18} {b['kind']:<11} {b.get('mem', '-'):>5} "
            f"{b.get('ports', 0):>2} {b['capacity']:>6} "
            f"{b['peak_occupancy']:>5} "
            f"{100.0 * b['waste']['waste_frac']:>6.1f}% "
            f"{b.get('port_pressure_peak', 0.0):>6.2f} "
            f"{b.get('conflict_cycles', 0):>6}")
    rows.append(
        f"summary: {s.get('n_buffers', 0)} buffers, "
        f"alloc {s.get('alloc_bytes', 0)} B, peak {s.get('peak_bytes', 0)} B "
        f"({100.0 * s.get('waste_frac', 0.0):.1f}% waste), {smem}"
        f"worst port pressure {s.get('worst_port_pressure', 0.0):.2f}, "
        f"{s.get('conflict_cycles', 0)} conflict cycles")
    return "\n".join(rows)
