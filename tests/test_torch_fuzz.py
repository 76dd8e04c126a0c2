"""Executor fuzz harness of the port: random pipelines vs the jnp oracle.

The twin of ``tests/test_executor_fuzz.py``. The same seeded generator
(``repro_torch.core.fuzz``) builds random DAGs — convolution chains with 2-input blends, skip
connections and diamond joins, drained by a terminal sum — and each goes
through the port's whole stack (``build_program``, ``make_executor``
single-frame and batched, ``PlanCache`` + ``execute_tiled``, and for a
temporal variant ``make_video_executor`` in chunks) against the JAX
package's pure-jnp oracle (``repro.kernels.ref.stencil_pipeline_ref``,
``repro.core.algorithms.execute_reference_video``) run on the jnp
versions of the same stage functions.

The blends, drains and temporal convolutions are plain closures written
once for both packages (they index and add, which torch and jnp spell
alike); the port lowers them to expression stages of the kernel. The
spatial convolutions come in two forms: the port's ``conv_fn`` (a
built-in ``Payload``) and its bare eager function (lowered too). On the
CPU every executor runs the kernel's plain version, the user's own
functions; the single-frame and temporal tests also run the kernel
itself, compiled for the host under the shim of
``tests/test_torch_kernel_host.py`` (every lowered stage through its
generated body), against the oracle. ``tests/test_torch_cuda.py`` holds
the kernel on the card against the plain version.

Tolerance: bitwise, else 3 ULP at the array's scale, as the JAX harness
(XLA may contract a multiply and an add into one FMA).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import algorithms as jax_algorithms
from repro.core.dsl import Pipeline as JaxPipeline
from repro.kernels import ref as jax_ref
from repro_torch.core import algorithms, fuzz
from repro_torch.core.dag import window_keys
from repro_torch.core.dsl import Pipeline
from repro_torch.imaging import (FrameEngine, FrameRequest, PlanCache,
                                 execute_tiled)
from repro_torch.kernels import stencil_pipeline as sp
from repro_torch.resilience import ResilienceConfig
from repro_torch.video import VideoEngine, VideoFrame
from test_torch_kernel_host import host_kernel  # noqa: F401  (fixture)

SEEDS = list(range(8))
H, W = 20, 40
T, CHUNK = 8, 4
FORMS = ["payload", "bare"]


_CONV = {"jax": jax_algorithms.conv_fn, "payload": algorithms.conv_fn,
         "bare": fuzz.bare_conv}


def random_pipeline(seed: int, form: str = "payload",
                    temporal: bool = False):
    """The harness's DAG in the JAX package (``form="jax"``) or the port
    (convolutions as payloads or bare functions)."""
    return fuzz.random_pipeline(
        seed, conv=_CONV[form],
        pipeline=JaxPipeline if form == "jax" else Pipeline,
        temporal=temporal)


def HOST_EXPR_DAGS():
    """The DAGs whose expression stages the host-compiled kernel runs."""
    return [random_pipeline(seed, form, temporal=t) for seed in SEEDS
            for form in FORMS for t in (False, True)]


@pytest.fixture(scope="module")
def frame():
    return np.random.RandomState(99).rand(H, W).astype(np.float32)


def assert_close_to_oracle(got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    if (got == exp).all():
        return
    tol = 3 * np.spacing(np.abs(exp).max())   # <= 3 ULP at array scale
    np.testing.assert_allclose(got, exp, rtol=0, atol=tol)


def _exprs(dag) -> set[str]:
    return set(sp.build_program(dag, H, W, 1).exprs)


def test_generator_matches_the_jax_harness():
    """The generator draws the JAX harness's DAGs, edge for edge, and each
    form lowers exactly the stages that are no payload."""
    path = Path(__file__).with_name("test_executor_fuzz.py")
    spec = importlib.util.spec_from_file_location("_jax_fuzz", path)
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    for seed in SEEDS:
        want = [(e.producer, e.consumer, e.sh, e.sw, e.st)
                for e in harness.random_pipeline(seed).edges]
        for form in ("jax", *FORMS):
            dag = random_pipeline(seed, form)
            assert [(e.producer, e.consumer, e.sh, e.sw, e.st)
                    for e in dag.edges] == want, (seed, form)
        bare, payload = random_pipeline(seed, "bare"), \
            random_pipeline(seed, "payload")
        computed = {n for n, s in bare.stages.items() if s.fn is not None}
        assert _exprs(bare) == computed
        assert _exprs(payload) == {
            n for n in computed
            if not isinstance(payload.stages[n].fn, algorithms.Payload)}


def test_generator_is_deterministic():
    for temporal in (False, True):
        a, b = (random_pipeline(3, temporal=temporal) for _ in range(2))
        assert [(e.producer, e.consumer, e.st, e.sh, e.sw) for e in a.edges] \
            == [(e.producer, e.consumer, e.st, e.sh, e.sw) for e in b.edges]
        pa, pb = (sp.build_program(d, H, W, 8) for d in (a, b))
        assert np.array_equal(pa.table, pb.table)
        assert pa.source == pb.source


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_single_frame(seed, form, frame, host_kernel):
    dag = random_pipeline(seed, form)
    exp = jax_ref.stencil_pipeline_ref(random_pipeline(seed, "jax"),
                                       {"in": frame})
    for rows in (1, 8):
        got = sp.make_executor(dag, H, W, rows_per_step=rows,
                               device="cpu")({"in": frame})
        assert got.shape == (H, W)
        assert_close_to_oracle(got, exp)
        # the kernel itself, its lowered stages through their generated
        # bodies
        prog = sp.build_program(dag, H, W, rows)
        assert_close_to_oracle(host_kernel(prog, frame[None])[0], exp)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_batched(seed, form):
    dag = random_pipeline(seed, form)
    jdag = random_pipeline(seed, "jax")
    frames = np.random.RandomState(seed + 100).rand(2, H, W) \
        .astype(np.float32)
    got = sp.make_executor(dag, H, W, batch=2, rows_per_step=8,
                           device="cpu")({"in": frames})
    for b in range(2):
        assert_close_to_oracle(
            got[b], jax_ref.stencil_pipeline_ref(jdag, {"in": frames[b]}))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_tiled(seed, form, frame):
    """Tiles stitch the halo for DAG shapes no hand-written pipeline
    covers (the halo is the random cumulative extent)."""
    dag = random_pipeline(seed, form)
    up, left = dag.cumulative_extent()
    th, tw = 16, 32
    assert up < th and left < tw, "generator bounds keep halo < tile"
    cache = PlanCache(pipelines={dag.name: lambda: dag}, device="cpu")
    got = execute_tiled(cache, dag.name, {"in": frame}, th, tw, batch=2)
    assert_close_to_oracle(got, jax_ref.stencil_pipeline_ref(
        random_pipeline(seed, "jax"), {"in": frame}))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_temporal(seed, form, host_kernel):
    """The temporal variant through ``make_video_executor`` in chunks of
    4 from a zero state, and through the kernel itself under the host
    shim (one launch over the whole video from zero frame rings), against
    the JAX package's video oracle."""
    dag = random_pipeline(seed, form, temporal=True)
    vid = np.random.RandomState(seed + 200).rand(T, H, W).astype(np.float32)
    exp = np.asarray(jax_algorithms.execute_reference_video(
        random_pipeline(seed, "jax", temporal=True), {"in": vid}))
    ex = sp.make_video_executor(dag, H, W, rows_per_step=8, chunk=CHUNK,
                                device="cpu")
    state = ex.init_state()
    outs = []
    for t in range(0, T, CHUNK):
        out, state = ex({"in": vid[t:t + CHUNK]}, state)
        outs.append(out)
    assert_close_to_oracle(torch.cat(outs), exp)
    prog = sp.build_program(dag, H, W, 8, frames=T)
    depths = dag.temporal_depths()
    zeros = [np.zeros((depths[p] - 1, H, W), np.float32)
             for p in sorted(depths, key=dag.topo_order.index)]
    assert_close_to_oracle(host_kernel(prog, vid, zeros), exp)
    assert "t0" in ex.program.exprs


def test_window_keys_match_the_lowered_operands():
    """A lowered stage's operands follow the window keys of its in-edges,
    the order the plain version hands its windows in."""
    for seed in SEEDS:
        dag = random_pipeline(seed, "bare")
        prog = sp.build_program(dag, H, W, 8)
        for name, ex in prog.exprs.items():
            ins = dag.in_edges(name)
            assert len(window_keys(ins)) == len(ex.operands)
            assert [o[0] for o in ex.operands] == [e.producer for e in ins]


@pytest.mark.parametrize("seed", [3, 5])
def test_user_pipelines_through_both_resilient_engines(seed):
    """Pipelines of plain torch stage functions served fault free by a
    resilient ``FrameEngine`` (the spatial DAG, batches of 2) and a
    resilient ``VideoEngine`` (the temporal variant, chunks of 4): every
    frame on the primary (compiled) rung, none retried or fallen back,
    equal to the JAX oracle."""
    dag = random_pipeline(seed, "bare")
    cache = PlanCache(pipelines={dag.name: lambda: dag}, device="cpu")
    eng = FrameEngine(cache=cache, max_batch=2, tile_shape=(H, W),
                      resilience=ResilienceConfig())
    frames = np.random.RandomState(seed + 300).rand(5, H, W) \
        .astype(np.float32)
    for i, f in enumerate(frames):
        assert eng.submit(FrameRequest(rid=i, pipeline=dag.name,
                                       frames={"in": f})) is True
    done = {}
    while eng.pending:
        done.update({c.rid: c for c in eng.step()})
    assert {c.rung for c in done.values()} == {"default"}
    assert eng.metrics.executor_retries == eng.metrics.fallback_frames == 0
    jdag = random_pipeline(seed, "jax")
    for i, f in enumerate(frames):
        assert_close_to_oracle(done[i].output, jax_ref.stencil_pipeline_ref(
            jdag, {"in": f}))

    vdag = random_pipeline(seed, "bare", temporal=True)
    cache = PlanCache(pipelines={vdag.name: lambda: vdag}, device="cpu")
    veng = VideoEngine(cache=cache, chunk=CHUNK,
                       resilience=ResilienceConfig(), device="cpu")
    vid = np.random.RandomState(seed + 400).rand(T, H, W).astype(np.float32)
    sid = veng.open_stream(vdag.name, H, W)
    for f in vid:
        assert veng.submit(VideoFrame(sid, {"in": f})) is True
    vdone = []
    while veng.pending:
        vdone += veng.step()
    assert [c.rung for c in vdone] == ["default"] * T
    assert veng.metrics.executor_retries == veng.metrics.fallback_frames == 0
    assert_close_to_oracle(
        torch.stack([c.output for c in vdone]),
        jax_algorithms.execute_reference_video(
            random_pipeline(seed, "jax", temporal=True), {"in": vid}))
