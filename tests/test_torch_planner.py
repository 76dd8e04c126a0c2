"""Port planner parity: repro_torch's compile_pipeline against repro's.

The planner is pure Python in both packages, so the comparison is exact:
schedule start cycles, every field of every buffer allocation, total
allocated bits, power, the row-group ring sizing and the plan
fingerprint must be equal — no tolerance.
"""
import dataclasses

import pytest

from repro.core import algorithms as jax_algorithms
from repro.core import codegen as jax_codegen
from repro.core import linebuffer as jax_lb
from repro_torch.core import algorithms, codegen, linebuffer
from repro_torch.core.codegen import plan_from_dict

NAMES = sorted(algorithms.ALGORITHMS)
MEMS = ["DP", "SP", "DPLC"]


def _plans(name, mem, w):
    ref = jax_codegen.compile_pipeline(jax_algorithms.ALGORITHMS[name](), w,
                                       mem=getattr(jax_lb, mem))
    port = codegen.compile_pipeline(algorithms.ALGORITHMS[name](), w,
                                    mem=getattr(linebuffer, mem))
    return ref, port


def _buffers(plan):
    return {p: dataclasses.asdict(b) for p, b in plan.alloc.buffers.items()}


def test_pipeline_registry_matches_reference():
    assert sorted(jax_algorithms.ALGORITHMS) == NAMES
    for name in NAMES:
        ref = jax_algorithms.ALGORITHMS[name]()
        port = algorithms.ALGORITHMS[name]()
        assert port.topo_order == ref.topo_order
        assert [dataclasses.astuple(e) for e in port.edges] == \
            [dataclasses.astuple(e) for e in ref.edges]
        assert port.cumulative_extent() == ref.cumulative_extent()


@pytest.mark.parametrize("w", [48, 480])
@pytest.mark.parametrize("mem", MEMS)
@pytest.mark.parametrize("name", NAMES)
def test_compile_pipeline_equals_reference(name, mem, w):
    ref, port = _plans(name, mem, w)
    assert port.schedule.starts == ref.schedule.starts
    assert port.schedule.buffer_lines == ref.schedule.buffer_lines
    assert _buffers(port) == _buffers(ref)
    assert port.total_alloc_bits == ref.total_alloc_bits
    assert port.power == ref.power
    for r in (1, 8):
        assert codegen.row_group_rings(port.dag, port.alloc.buffers, r) == \
            jax_codegen.row_group_rings(ref.dag, ref.alloc.buffers, r)
    assert port.to_dict() == ref.to_dict()
    assert port.fingerprint() == ref.fingerprint()


@pytest.mark.parametrize("mem", MEMS)
@pytest.mark.parametrize("name", NAMES)
def test_plan_from_reference_dict_round_trips(name, mem):
    ref, _ = _plans(name, mem, 480)
    ref = dataclasses.replace(ref, rows_per_step=8)
    plan = plan_from_dict(ref.to_dict(), algorithms.ALGORITHMS[name]())
    assert plan.schedule.starts == ref.schedule.starts
    assert _buffers(plan) == _buffers(ref)
    assert plan.rows_per_step == 8 and plan.prefetch_depth == 1
    assert plan.power == ref.power
    assert plan.fingerprint() == ref.fingerprint()
    assert plan.verify(h=24).ok


def test_plan_from_dict_rejects_inconsistent_dicts():
    ref, _ = _plans("canny-m", "DP", 48)
    dag = algorithms.canny_m()
    d = ref.to_dict()
    with pytest.raises(ValueError, match="is for"):
        plan_from_dict(d, algorithms.unsharp_m())
    bad = dict(d, buffers={**d["buffers"],
                           "in": dict(d["buffers"]["in"], n_blocks=999)})
    with pytest.raises(ValueError, match="reallocate"):
        plan_from_dict(bad, dag)
    with pytest.raises(ValueError, match="memory config"):
        plan_from_dict(d, dag, configs=(linebuffer.SP,))
