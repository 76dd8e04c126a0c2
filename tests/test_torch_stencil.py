"""Port payloads and fused stencil kernel against the JAX oracle.

The oracle is ``repro.core.algorithms.execute_reference`` (pure jnp); the
JAX package's Pallas executors are not used. Inputs come from
``numpy.random.RandomState`` and reach both packages as numpy arrays.

Tolerance: bitwise equality first, else <= 32 ULP at the array's scale
(``tests/test_video.py``): XLA may contract a multiply and an add into
one FMA where the eager port rounds twice, which moves a result by about
1 ULP. A structural fault (wrong slab row, missing mask, wrong operand
order) is off by ~1e6 ULP.

On the CPU the kernel's wrapper runs its plain PyTorch version, so these
tests hold the plain version and the executor plumbing (shapes, batching,
table validation, the kernel memo) against the oracle;
``tests/test_torch_cuda.py`` holds the CUDA kernel against the plain
version on the card.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import algorithms as jax_algorithms
from repro.core import codegen as jax_codegen
from repro_torch.core import DP, SP, algorithms, compile_pipeline
from repro_torch.core.codegen import plan_from_dict
from repro_torch.core.dsl import Pipeline
from repro_torch.kernels import ops
from repro_torch.kernels import stencil_pipeline as sp

NAMES = sorted(algorithms.ALGORITHMS)
SHAPES = [(37, 53), (5, 48), (64, 128)]


def assert_ulp_equal(got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    if (got == exp).all():
        return
    tol = 32 * np.spacing(np.abs(exp).max())   # a few ULP at array scale
    np.testing.assert_allclose(got, exp, rtol=0, atol=tol)


def _frames(seed, n, h, w):
    return np.random.RandomState(seed).rand(n, h, w).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_stages(name):
    """The jnp oracle of ``name``, jitted (one compile per frame shape):
    img -> {stage: values}."""
    dag = jax_algorithms.ALGORITHMS[name]()
    return jax.jit(lambda img: jax_algorithms.execute_reference(
        dag, {"in": img}))


def _oracle(name, h, w, seed, idx):
    img = _frames(seed, idx + 1, h, w)[idx]
    return np.asarray(_jax_stages(name)(img)["out"])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_execute_reference_matches_jax(name, shape):
    h, w = shape
    img = _frames(1, 1, h, w)[0]
    dag = algorithms.ALGORITHMS[name]()
    vals = algorithms.execute_reference(dag, {"in": img})
    jvals = _jax_stages(name)(img)
    assert set(vals) == set(jvals)
    for stage in vals:                       # every intermediate stage
        assert_ulp_equal(vals[stage].numpy(), np.asarray(jvals[stage]))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_plain_kernel_matches_jax(name, shape, r, batched):
    """K1 through the executor (plain version on the CPU), single frame
    and batched with a zero idle slot between two live frames."""
    h, w = shape
    dag = algorithms.ALGORITHMS[name]()
    plan = compile_pipeline(dag, w, rows_per_step=r)
    if not batched:
        ex = sp.make_executor(dag, h, w, plan=plan, device="cpu")
        got = ex({"in": _frames(2, 1, h, w)[0]})
        assert got.shape == (h, w) and got.dtype == torch.float32
        assert_ulp_equal(got.numpy(), _oracle(name, h, w, 2, 0))
        return
    frames = _frames(3, 3, h, w)
    frames[1] = 0.0                          # idle slot
    ex = sp.make_executor(dag, h, w, batch=3, plan=plan, device="cpu")
    got = ex({"in": frames}).numpy()
    assert got.shape == (3, h, w)
    for b in (0, 2):
        assert_ulp_equal(got[b], _oracle(name, h, w, 3, b))
    assert_ulp_equal(got[1], sp.stencil_pipeline_plain(
        dag, {"in": torch.zeros(h, w)}).numpy())


@pytest.mark.parametrize("name", NAMES)
def test_executor_runs_the_reference_plan(name):
    """The port executor on exactly the plan the reference compiles,
    carried across as ``PipelinePlan.to_dict()``: same shared-memory
    rings as on the port's own plan, same pixels as the oracle."""
    h, w = 37, 53
    ref = jax_codegen.compile_pipeline(jax_algorithms.ALGORITHMS[name](), w,
                                       rows_per_step=8)
    dag = algorithms.ALGORITHMS[name]()
    plan = plan_from_dict(ref.to_dict(), dag)
    ex = sp.make_executor(dag, h, w, plan=plan, device="cpu")
    own = sp.make_executor(dag, h, w, plan=compile_pipeline(
        dag, w, rows_per_step=8), device="cpu")
    assert ex.rows_per_step == 8
    assert np.array_equal(ex.program.table, own.program.table)
    assert_ulp_equal(ex({"in": _frames(10, 1, h, w)[0]}).numpy(),
                     _oracle(name, h, w, 10, 0))


def test_wrapper_runs_plain_version_on_cpu_without_launching():
    dag = algorithms.canny_m()
    prog = sp.build_program(dag, 16, 24, rows_per_step=8, frames=2)
    x = torch.from_numpy(_frames(4, 2, 16, 24))
    before = sp.stencil_pipeline.launches
    out = sp.stencil_pipeline(prog, [x])
    assert sp.stencil_pipeline.launches == before
    assert torch.equal(out, sp.stencil_pipeline_plain(dag, {"in": x}))


@pytest.mark.parametrize("bad,err", [
    (lambda x: x.double(), TypeError),
    (lambda x: x[:, :, :20], ValueError),
    (lambda x: x.transpose(1, 2).contiguous().transpose(1, 2), ValueError),
    (lambda x: x[:0], ValueError),
])
def test_wrapper_rejects_bad_inputs(bad, err):
    prog = sp.build_program(algorithms.unsharp_m(), 16, 24, rows_per_step=1)
    x = torch.from_numpy(_frames(5, 2, 16, 24))
    with pytest.raises(err):
        sp.stencil_pipeline(prog, [bad(x)])
    with pytest.raises(ValueError, match="takes 1 inputs"):
        sp.stencil_pipeline(prog, [x, x])


def test_stage_table_resolves_operand_order():
    """Operand order is resolved once on the host: sorted keys for mag,
    ``in`` first for unsharp, the 18-tall window first for xcorr, and
    in/b/lap for denoise's blend."""
    def srcs(dag, stage, r=1):
        prog = sp.build_program(dag, 16, 24, rows_per_step=r)
        rings = list(sp.smem_rings(dag, None, r))
        s = [n for n in dag.topo_order
             if not dag.stages[n].is_output].index(stage)
        row = prog.table[sp.HDR + s * sp.STAGE_INTS:]
        n = row[sp.S_NSRC]
        return [(rings[row[sp.S_SRC + j]], int(row[sp.S_SH + j]),
                 int(row[sp.S_SW + j])) for j in range(n)], \
            sp.OPS[row[sp.S_OP]]
    assert srcs(algorithms.canny_m(), "mag") == \
        ([("gx", 1, 1), ("gy", 1, 1)], "mag")
    assert srcs(algorithms.unsharp_m(), "sharp") == \
        ([("in", 1, 1), ("by", 1, 1)], "unsharp")
    assert srcs(algorithms.xcorr_m(), "xc") == \
        ([("in", 18, 1), ("in", 1, 1)], "xcorr")
    assert srcs(algorithms.denoise_m(), "comb") == \
        ([("in", 1, 1), ("b", 1, 1), ("lap", 1, 1)], "denoise_comb")
    # a stage written with its inputs in the other order resolves the same
    p = Pipeline("swapped")
    x = p.input("in")
    b = p.stage("b", [(x, 3, 3)], algorithms.conv_fn(algorithms.G3))
    lap = p.stage("lap", [(b, 3, 3)], algorithms.conv_fn(algorithms.LAPLACE))
    comb = p.stage("comb", [(lap, 1, 1), (b, 1, 1), (x, 1, 1)],
                   algorithms.denoise_comb_fn)
    p.output("out", [(comb, 1, 1)])
    dag = p.build()
    assert srcs(dag, "comb")[0] == [("in", 1, 1), ("b", 1, 1),
                                    ("lap", 1, 1)]
    img = _frames(6, 1, 20, 30)[0]
    assert torch.equal(
        sp.make_executor(dag, 20, 30, device="cpu")({"in": img}),
        sp.make_executor(algorithms.denoise_m(), 20, 30,
                         device="cpu")({"in": img}))


def test_smem_rings_and_launch_geometry():
    dag = algorithms.canny_m()
    plan = compile_pipeline(dag, 1920)
    rings = sp.smem_rings(dag, plan.alloc.buffers, 8)
    # one read slab per consumer (R + sh - 1), no TPU rounding; the
    # output stage's producer streams out and owns no ring
    assert rings == {"in": 8, "bx": 12, "by": 10, "gx": 8, "gy": 8,
                     "mag": 10, "nms": 10, "hyst": 8}
    prog = sp.build_program(dag, 1080, 1920, 8, frames=4,
                            alloc_buffers=plan.alloc.buffers)
    up, left = dag.cumulative_extent()
    assert prog.smem_bytes == sum(rings.values()) * (sp.STRIP_W + left) * 4
    assert prog.grid_x == 1920 // sp.STRIP_W
    assert prog.band_h >= 4 * up
    assert prog.grid_y * prog.band_h >= 1080
    assert prog.grid_x * prog.grid_y * 4 >= sp.TARGET_CTAS


def test_build_program_rejects_what_the_kernel_cannot_run():
    p = Pipeline("opaque")
    x = p.input("in")
    y = p.stage("y", [(x, 1, 1)], lambda wins: wins["in"][..., 0, 0])
    p.output("out", [(y, 1, 1)])
    with pytest.raises(ValueError, match="no kernel op"):
        sp.build_program(p.build(), 8, 8, 1)
    p = Pipeline("tall")
    x = p.input("in")
    y = p.stage("y", [(x, 1000, 1)], algorithms.conv_fn(np.ones((1000, 1))))
    p.output("out", [(y, 1, 1)])
    with pytest.raises(ValueError, match="shared memory"):
        sp.build_program(p.build(), 8, 128, 8)
    p = Pipeline("shape")
    x = p.input("in")
    y = p.stage("y", [(x, 3, 3)], algorithms.conv_fn(algorithms.G5H))
    p.output("out", [(y, 1, 1)])
    with pytest.raises(ValueError, match="weights"):
        sp.build_program(p.build(), 8, 8, 1)


def test_make_executor_refuses_unported_modes():
    dag = algorithms.unsharp_m()
    with pytest.raises(ValueError, match="prefetch_depth"):
        sp.make_executor(dag, 8, 24, prefetch_depth=2, device="cpu")
    p = Pipeline("temporal")
    x = p.input("in")
    y = p.stage("y", [(x, 2, 1, 1)], algorithms.identity_fn)
    p.output("out", [(y, 1, 1)])
    with pytest.raises(ValueError, match="frame history"):
        sp.make_executor(p.build(), 8, 24, device="cpu")


def test_cuda_entry_points_refuse_to_run_without_a_card():
    dag = algorithms.unsharp_m()
    img = {"in": _frames(7, 1, 8, 24)[0]}
    if torch.cuda.is_available():
        assert ops.fused_pipeline(dag, img).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sp.make_executor(dag, 8, 24)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.fused_pipeline(dag, img)


# ------------------------------------------------- fused-kernel memo
def test_kernel_cache_keys_on_plan_content():
    """Two plans at the same (pipeline, h, w, R) differing only in mem
    config must build distinct executors: the memo keys on the plan
    fingerprint, not on ``plan is not None``."""
    dag = algorithms.unsharp_m()
    p_dp = compile_pipeline(dag, 24, mem=DP)
    p_sp = compile_pipeline(dag, 24, mem=SP)
    assert p_dp.fingerprint() != p_sp.fingerprint()
    ops._PIPE_CACHE.clear()
    img = {"in": _frames(8, 1, 16, 24)[0]}
    a = ops.fused_pipeline(dag, img, plan=p_dp, device="cpu")
    b = ops.fused_pipeline(dag, img, plan=p_sp, device="cpu")
    assert ops._PIPE_CACHE.stats.misses == 2
    assert ops._PIPE_CACHE.stats.hits == 0
    assert len(ops._PIPE_CACHE) == 2
    assert torch.equal(a, b)            # same math, distinct executors
    # row-group siblings also miss — and report their own shared memory
    p_r8 = dataclasses.replace(p_dp, rows_per_step=8)
    s1 = ops.pipeline_smem_bytes(dag, 16, 24, plan=p_dp, device="cpu")
    s8 = ops.pipeline_smem_bytes(dag, 16, 24, plan=p_r8, device="cpu")
    assert s8 > s1
    assert ops._PIPE_CACHE.stats.misses == 3    # p_dp smem probe hits
    assert_ulp_equal(ops.fused_pipeline(dag, img, plan=p_r8,
                                        device="cpu").numpy(),
                     _oracle("unsharp-m", 16, 24, 8, 0))


def test_kernel_cache_lru_bounded():
    c = ops._KernelCache(max_entries=2)
    c.get_or_build(("a",), lambda: ("fa", 0))
    c.get_or_build(("b",), lambda: ("fb", 1))
    assert c.get_or_build(("a",), lambda: ("never", -1)) == ("fa", 0)
    c.get_or_build(("c",), lambda: ("fc", 2))   # evicts b (LRU), keeps a
    assert ("a",) in c and ("c",) in c and ("b",) not in c
    assert len(c) == 2
    assert (c.stats.hits, c.stats.misses, c.stats.evictions) == (1, 3, 1)
    c.get_or_build(("b",), lambda: ("fb2", 3))  # rebuild after eviction
    assert c.stats.misses == 4 and c.stats.evictions == 2
    with pytest.raises(ValueError):
        ops._KernelCache(max_entries=0)
