"""Port memtrace plane: occupancy oracle vs vectorized sampler,
capture/validate round-trip, downsampling, counter-track merge, the
cache seam, and the waste join against the CUDA kernel's shared-memory
rings.

The contracts of tests/test_memtrace.py, held by
``repro_torch.obs.memtrace`` and ``repro_torch.imaging.PlanCache``; then
the same plans through both packages: every track (occupancy, accesses,
conflict cycles, peaks, strides, port pressure) equal to the JAX
package's, key for key. Only the join differs: the reference joins its
TPU VMEM rings, the port the rings ``build_program`` reserves.
"""
import copy
import dataclasses
import json

import numpy as np
import pytest

from repro.core import algorithms as jax_algorithms
from repro.core import codegen as jax_codegen
from repro.core import linebuffer as jax_linebuffer
from repro.obs import memtrace as jax_memtrace
from repro_torch.core import DP, algorithms, compile_pipeline
from repro_torch.core.contention import (buffer_occupancy, lines_retired,
                                         lines_written)
from repro_torch.core.dsl import Pipeline
from repro_torch.core.linebuffer import SP
from repro_torch.core.simulate import sample_buffers, simulate
from repro_torch.imaging import PlanCache
from repro_torch.kernels import stencil_pipeline as sp
from repro_torch.obs import export, memtrace
from repro_torch.obs.memtrace import (capture, downsample_max, memtrace_text,
                                      validate_memtrace)

NAMES = sorted(algorithms.ALGORITHMS) + sorted(algorithms.VIDEO_ALGORITHMS)
# the keys that join an allocation; every other buffer key is a track or
# a plan fact and equals the reference's
JOIN_KEYS = {"capacity", "waste", "ring"}


def _plan(name="unsharp-m", w=32, mem=DP):
    dag = algorithms.ALGORITHMS[name]()
    return dag, compile_pipeline(dag, w, mem=mem)


def _dag(name):
    return (algorithms.ALGORITHMS.get(name)
            or algorithms.VIDEO_ALGORITHMS[name])()


def _jax_dag(name):
    return (jax_algorithms.ALGORITHMS.get(name)
            or jax_algorithms.VIDEO_ALGORITHMS[name])()


# ------------------------------------------------- scalar oracle vs sampler
def test_lines_written_edges():
    # writer touches line 0 at its start cycle, one new line per W cycles
    assert lines_written(10, 9, 8, 4) == 0
    assert lines_written(10, 10, 8, 4) == 1
    assert lines_written(10, 17, 8, 4) == 1
    assert lines_written(10, 18, 8, 4) == 2
    assert lines_written(10, 1000, 8, 4) == 4    # clipped at h


def test_lines_retired_edges():
    # line l is last read at s_c + l*W, retired the cycle after
    assert lines_retired(10, 10, 8, 4) == 0      # still reading line 0
    assert lines_retired(10, 11, 8, 4) == 1      # line 0 done
    assert lines_retired(10, 18, 8, 4) == 1      # reading line 1
    assert lines_retired(10, 19, 8, 4) == 2
    assert lines_retired(10, 9, 8, 4) == 0
    assert lines_retired(10, 10**6, 8, 4) == 4


def test_occupancy_oracle_matches_vectorized_sampler():
    """The memtrace sampler's occupancy curves equal the scalar
    set-arithmetic oracle cycle for cycle."""
    for name in ("unsharp-m", "denoise-m", "harris-s"):
        dag, plan = _plan(name)
        h = 16
        samples = sample_buffers(dag, plan.schedule, plan.w, h,
                                 alloc=plan.alloc, cfg_of=plan.mem_cfg)
        for p, s in samples.items():
            if s.kind != "line_buffer":
                continue
            s_p = plan.schedule.starts[p]
            readers = [plan.schedule.starts[e.consumer]
                       for e in dag.out_edges(p)
                       if not dag.stages[e.consumer].is_output]
            for t in range(0, len(s.occupancy), 7):
                want = buffer_occupancy(s_p, readers, t, plan.w, h)
                assert s.occupancy[t] == want, (name, p, t)


def test_occupancy_bounded_by_physical_ring():
    """Live lines never exceed the physical ring of a valid plan; the
    sampler agrees with the checker about that."""
    for name in ("unsharp-m", "canny-s", "denoise-m"):
        dag, plan = _plan(name)
        rep = simulate(dag, plan.schedule, plan.w, 32,
                       alloc=plan.alloc, cfg_of=plan.mem_cfg)
        assert rep.ok
        for p, s in sample_buffers(dag, plan.schedule, plan.w, 32,
                                   alloc=plan.alloc,
                                   cfg_of=plan.mem_cfg).items():
            assert s.peak_occupancy <= s.capacity, (name, p)
            assert s.conflict_cycles == 0, (name, p)


def test_sampler_flags_conflicts_on_underprovisioned_ports():
    """Re-sampling a DP-scheduled plan as if its memories were
    single-ported shows conflict stalls."""
    dag, plan = _plan("denoise-m")
    sp_of = {s: SP for s in plan.mem_cfg}
    samples = sample_buffers(dag, plan.schedule, plan.w, 16,
                             alloc=None, cfg_of=sp_of)
    assert any(s.conflict_cycles > 0 for s in samples.values()
               if s.kind == "line_buffer")


def test_frame_ring_track_for_temporal_pipeline():
    dag = algorithms.VIDEO_ALGORITHMS["tmotion-t"]()
    plan = compile_pipeline(dag, 32, mem=DP)
    h = 16
    samples = sample_buffers(dag, plan.schedule, plan.w, h,
                             alloc=plan.alloc, cfg_of=plan.mem_cfg)
    rings = {k: s for k, s in samples.items() if s.kind == "frame_ring"}
    assert rings, "temporal pipeline must expose a frame-ring track"
    for k, s in rings.items():
        depth = dag.temporal_depths()[s.owner]
        assert s.unit == "rows"
        assert s.capacity == depth * h
        # (depth-1) history frames resident before the write ramp starts
        assert s.occupancy[0] >= (depth - 1) * h
        assert s.peak_occupancy == depth * h


# ------------------------------------------------------------ downsampling
def test_downsample_preserves_peak_and_length():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 1000, size=5000).astype(np.int32)
    t, out, stride = downsample_max(v, 64)
    assert len(t) == len(out) <= 64
    assert stride == -(-5000 // 64)
    assert max(out) == v.max()          # max-preserving by construction
    assert t[0] == 0 and t[1] - t[0] == stride
    assert (t, out, stride) == jax_memtrace.downsample_max(v, 64)


def test_downsample_short_series_is_identity():
    v = np.arange(10, dtype=np.int32)
    t, out, stride = downsample_max(v, 64)
    assert stride == 1
    assert out == list(range(10))
    assert downsample_max(np.array([], np.int32), 8) == ([], [], 1)


# --------------------------------------------------- capture + schema gate
def test_capture_round_trips_and_validates():
    _, plan = _plan()
    mt = capture(plan, h=24, max_samples=128)
    assert validate_memtrace(mt) == []
    rt = json.loads(json.dumps(mt))      # artifact = JSON file on disk
    assert validate_memtrace(rt) == []
    assert rt["schema"] == memtrace.MEMTRACE_SCHEMA == "memtrace/v1"
    for b in rt["buffers"]:
        assert len(b["t"]) == len(b["occupancy"]) <= 128
    assert "memtrace" in memtrace_text(rt)


def test_capture_waste_joins_the_kernel_rings():
    """Line-buffer alloc bytes plus the tap and unsampled rings
    reconcile exactly with the program's ring bill (smem_ring_bytes: its
    shared memory less the output block and the two row tables)."""
    for name in ("unsharp-m", "harris-m", "tdenoise-t", "tbackground-t"):
        dag = _dag(name)
        for r, d in ((1, 1), (8, 1), (8, 2), (4, 3)):
            plan = compile_pipeline(dag, 40, mem=DP, rows_per_step=r,
                                    prefetch_depth=d)
            mt = capture(plan, h=32)
            prog = sp.build_program(dag, 32, 40, r,
                                    alloc_buffers=plan.alloc.buffers,
                                    prefetch_depth=d)
            s = mt["summary"]
            ncols = int(prog.table[sp.H_NCOLS])
            assert s["smem_ring_bytes"] == prog.smem_bytes \
                - (r * ncols + 2 * sp.MAX_RINGS) * 4
            assert s["prefetch_ring_bytes"] == prog.prefetch_bytes
            assert (d > 1) == (s["prefetch_ring_bytes"] > 0)
            lb_bytes = sum(b["waste"]["alloc_bytes"] for b in mt["buffers"]
                           if b["kind"] == "line_buffer")
            assert lb_bytes + s["tap_ring_bytes"] \
                + s["unsampled_ring_bytes"] == s["smem_ring_bytes"]
            for b in mt["buffers"]:
                w = b["waste"]
                assert w["alloc"] >= w["peak"] >= 0
                assert 0.0 <= w["waste_frac"] <= 1.0
                assert w["alloc_bytes"] >= w["peak_bytes"]


@pytest.mark.parametrize("name", NAMES)
def test_join_equals_the_program_ring_table(name):
    """Each line buffer's capacity is its ring's rows in
    ``build_program``'s table, at ``pitch * 4`` bytes a row; history taps
    are the table's (producer, j) rings; frame rings stay full frames.
    Every simulated line buffer of a registered pipeline has a ring."""
    dag = _dag(name)
    for r, d in ((1, 1), (8, 2)):
        plan = compile_pipeline(dag, 48, mem=DP, rows_per_step=r,
                                prefetch_depth=d)
        mt = capture(plan, h=20)
        prog = sp.build_program(dag, 20, 48, r,
                                alloc_buffers=plan.alloc.buffers,
                                prefetch_depth=d)
        base = sp.HDR + sp.MAX_STAGES * sp.STAGE_INTS
        table = {name_: (int(prog.table[base + 2 * i]),
                         int(prog.table[base + 2 * i + 1]))
                 for i, name_ in enumerate(prog.rings)}
        pitch = int(prog.table[sp.H_PITCH])
        assert mt["summary"]["pitch"] == pitch
        for b in mt["buffers"]:
            if b["kind"] == "frame_ring":
                assert b["ring"] is None
                assert b["waste"]["alloc_bytes"] \
                    == b["capacity"] * plan.w * 4
                continue
            assert b["ring"] is not None, b["name"]
            assert prog.rings[b["ring"]] == b["stage"]
            assert b["capacity"] == table[b["stage"]][1]
            assert b["waste"]["alloc_bytes"] == b["capacity"] * pitch * 4
        taps = sum(rows for k, (_, rows) in table.items()
                   if isinstance(k, tuple))
        assert mt["summary"]["tap_ring_bytes"] == taps * pitch * 4
        # ring offsets tile the ring region with no gap
        offs = sorted(table.values())
        assert offs[0][0] == 0
        for (o1, n1), (o2, _) in zip(offs, offs[1:]):
            assert o2 == o1 + n1 * pitch


def test_a_ring_with_no_simulated_buffer_still_counts():
    """An input only the output reads has no line buffer in the
    simulator, but at prefetch depth >= 2 the kernel gives it a ring of
    d * R rows to land its copies: the join counts it, never a buffer
    the kernel does not reserve."""
    p = Pipeline("passthrough")
    x = p.input("in")
    p.output("out", [(x, 1, 1)])
    dag = p.build()
    for d in (1, 2):
        plan = compile_pipeline(dag, 24, mem=DP, rows_per_step=4,
                                prefetch_depth=d)
        samples = sample_buffers(dag, plan.schedule, plan.w, 8,
                                 alloc=plan.alloc, cfg_of=plan.mem_cfg)
        assert samples == {}
        prog = sp.build_program(dag, 8, 24, 4,
                                alloc_buffers=plan.alloc.buffers,
                                prefetch_depth=d)
        assert prog.rings == (("in",) if d > 1 else ())
        mt = capture(plan, h=8)
        assert mt["buffers"] == []
        s = mt["summary"]
        assert s["unsampled_ring_bytes"] == s["smem_ring_bytes"] \
            == s["alloc_bytes"] == (d * 4 * s["pitch"] * 4 if d > 1 else 0)


def test_buffer_without_a_ring_is_marked_not_invented():
    """A simulated line buffer whose producer has no ring in the
    program gets capacity 0 and ring None, and holds no bytes."""
    _, plan = _plan("unsharp-m")
    real = sp.build_program

    def drop_by(*args, **kw):
        prog = real(*args, **kw)
        return dataclasses.replace(
            prog, rings=tuple(r if r != "by" else ("gone", 0)
                              for r in prog.rings))

    sp.build_program = drop_by
    try:
        mt = capture(plan, h=16)
    finally:
        sp.build_program = real
    (by,) = [b for b in mt["buffers"] if b["name"] == "by"]
    assert by["ring"] is None and by["capacity"] == 0
    assert by["waste"]["alloc_bytes"] == by["waste"]["peak_bytes"] == 0
    assert by["peak_occupancy"] > 0
    assert validate_memtrace(mt) == []


@pytest.mark.parametrize("name", NAMES)
def test_tracks_equal_the_reference(name):
    """Same plan in both packages, same tracks: every buffer key other
    than the allocation join, the per-stage port pressure, the cycle
    count and the plan facts."""
    for w, h, r, d in ((32, 16, 1, 1), (40, 27, 8, 2)):
        plan = compile_pipeline(_dag(name), w, mem=DP, rows_per_step=r,
                                prefetch_depth=d)
        jplan = jax_codegen.compile_pipeline(
            _jax_dag(name), w, mem=jax_linebuffer.DP, rows_per_step=r,
            prefetch_depth=d)
        mt, jmt = capture(plan, h, max_samples=64), \
            jax_memtrace.capture(jplan, h, max_samples=64)
        for k in ("schema", "pipeline", "w", "h", "rows_per_step",
                  "prefetch_depth", "cycles", "mem_cfg", "stages"):
            assert mt[k] == jmt[k], k
        assert [b["name"] for b in mt["buffers"]] \
            == [b["name"] for b in jmt["buffers"]]
        for b, jb in zip(mt["buffers"], jmt["buffers"]):
            assert set(b) - JOIN_KEYS == set(jb) - JOIN_KEYS
            for k in set(jb) - JOIN_KEYS:
                assert b[k] == jb[k], (b["name"], k)
            # frame rings are the same full frames in both packages
            if b["kind"] == "frame_ring":
                assert b["capacity"] == jb["capacity"]
                assert b["waste"] == jb["waste"]
        for k in ("n_buffers", "conflict_cycles", "worst_port_pressure"):
            assert mt["summary"][k] == jmt["summary"][k]
        # each package's validator accepts the other's artifact
        assert validate_memtrace(jmt) == []
        assert jax_memtrace.validate_memtrace(mt) == []


def test_validate_rejects_corruption():
    _, plan = _plan()
    mt = capture(plan, h=16)

    bad = copy.deepcopy(mt)
    bad["schema"] = "memtrace/v0"
    assert any("schema" in e for e in validate_memtrace(bad))

    bad = copy.deepcopy(mt)
    bad["buffers"][0]["occupancy"] = bad["buffers"][0]["occupancy"][:-1]
    assert any("lengths differ" in e for e in validate_memtrace(bad))

    bad = copy.deepcopy(mt)
    bad["buffers"][0]["peak_occupancy"] = -1
    assert any("exceeds" in e for e in validate_memtrace(bad))

    bad = copy.deepcopy(mt)
    bad["buffers"][0]["waste"]["waste_frac"] = 1.5
    assert any("waste_frac" in e for e in validate_memtrace(bad))

    bad = copy.deepcopy(mt)
    del bad["buffers"]
    assert any("buffers" in e for e in validate_memtrace(bad))

    assert validate_memtrace([1, 2]) != []
    assert validate_memtrace(bad) == jax_memtrace.validate_memtrace(bad)


# ------------------------------------------------------- counter-track merge
def _fake_trace(pipeline="unsharp-m"):
    return {
        "traceEvents": [
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": "t"}},
            {"name": "engine.step", "ph": "X", "cat": "repro_torch",
             "ts": 0.0, "dur": 500.0, "pid": 1, "tid": 1, "args": {}},
            {"name": "engine.execute", "ph": "X", "cat": "repro_torch",
             "ts": 100.0, "dur": 300.0, "pid": 1, "tid": 1,
             "args": {"pipeline": pipeline}},
        ],
        "displayTimeUnit": "ms",
        "otherData": {"schema": export.SCHEMA},
    }


def test_counter_merge_validates_and_anchors_to_execute_span():
    _, plan = _plan("unsharp-m")
    mt = capture(plan, h=16, max_samples=32)
    data = export.merge_counter_tracks(_fake_trace(), [mt])
    assert export.validate_trace(data) == []
    counters = [e for e in data["traceEvents"] if e["ph"] == "C"]
    assert counters
    # every counter sample lands inside the matching execute span
    assert all(100.0 <= e["ts"] <= 400.0 for e in counters)
    names = {e["name"] for e in counters}
    assert any(n.startswith("mem:unsharp-m:") for n in names)
    assert any(n.startswith("port:unsharp-m:") for n in names)
    occ = [e for e in counters if e["name"].startswith("mem:")]
    assert all(set(e["args"]) == {"occupancy", "capacity"} for e in occ)


def test_counter_merge_falls_back_to_trace_extent():
    _, plan = _plan("unsharp-m")
    mt = capture(plan, h=16, max_samples=16)
    tr = _fake_trace(pipeline="some-other-pipe")
    data = export.merge_counter_tracks(tr, [mt])
    assert export.validate_trace(data) == []
    counters = [e for e in data["traceEvents"] if e["ph"] == "C"]
    assert counters
    assert all(0.0 <= e["ts"] <= 500.0 for e in counters)


def test_validator_rejects_bad_counter_events():
    tr = _fake_trace()
    tr["traceEvents"].append({"name": "mem:x", "ph": "C", "ts": 1.0,
                              "pid": 1, "tid": 0,
                              "args": {"occupancy": "five"}})
    assert any("numeric" in e for e in export.validate_trace(tr))
    tr = _fake_trace()
    tr["traceEvents"].append({"name": "mem:x", "ph": "C", "ts": -1.0,
                              "pid": 1, "tid": 0, "args": {"v": 1.0}})
    assert any("ts" in e for e in export.validate_trace(tr))


# ------------------------------------------------------------- cache seam
def test_plan_cache_memtrace_for():
    pc = PlanCache(device="cpu")
    mt = pc.memtrace_for("unsharp-m", 32, 24)
    assert validate_memtrace(mt) == []
    assert pc.stats.plan_misses == 1
    # same plan key: no re-solve, just a re-sample
    mt2 = pc.memtrace_for("unsharp-m", 32, 24)
    assert pc.stats.plan_misses == 1 and pc.stats.plan_hits == 1
    assert mt2["summary"] == mt["summary"]


def test_memtrace_for_reconciles_with_the_served_executor():
    """The cache's trace at the served shape carries the ring bill of
    the executor the same cache serves."""
    pc = PlanCache(device="cpu")
    for name, d in (("canny-m", 1), ("canny-m", 2), ("tmotion-t", 1)):
        if name in algorithms.VIDEO_ALGORITHMS:
            ex = pc.video_executor_for(name, 30, 64, chunk=2,
                                       rows_per_step=8, prefetch_depth=d)
        else:
            ex = pc.executor_for(name, 30, 64, batch=2, rows_per_step=8,
                                 prefetch_depth=d)
        mt = pc.memtrace_for(name, 64, 30, rows_per_step=8,
                             prefetch_depth=d)
        prog = ex.program
        assert mt["summary"]["smem_ring_bytes"] \
            == int(prog.table[sp.H_OSTAGE]) * 4
        assert mt["summary"]["smem_bytes"] == ex.smem_bytes
        assert mt["summary"]["prefetch_ring_bytes"] == prog.prefetch_bytes


def test_memtrace_for_emits_its_span():
    from repro_torch.obs import trace
    trace.clear()
    trace.enable()
    try:
        PlanCache(device="cpu").memtrace_for("xcorr-m", 24, 12)
        spans = [e for e in trace.events() if e.name == "cache.memtrace"]
    finally:
        trace.disable()
        trace.clear()
    assert len(spans) == 1
    assert spans[0].attrs == {"pipeline": "xcorr-m", "w": 24, "h": 12}


def test_tuned_memtrace_uses_tuned_plan():
    pc = PlanCache(device="cpu")
    mt_def = pc.memtrace_for("denoise-m", 32, 16)
    mt_tuned = pc.memtrace_for("denoise-m", 32, 16, tune=True)
    assert validate_memtrace(mt_tuned) == []
    assert mt_tuned["mem_cfg"] == {
        s: c.name for s, c in pc.tuning_for("denoise-m", 32)
        .best.mem_cfg.items()}
    # same shape either way: the waste columns are directly comparable
    assert {b["name"] for b in mt_tuned["buffers"]} \
        == {b["name"] for b in mt_def["buffers"]}
