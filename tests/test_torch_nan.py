"""NaN frames through the registered pipelines whose payload bodies take a
max or a clamp: canny-s, canny-m, harris-s (nms) and denoise-m
(denoise_comb).

The reference takes ``jnp.max`` and ``jnp.clip``
(``src/repro/core/algorithms.py``), and the port's plain version
``amax`` and ``torch.clamp``: all pass a NaN on. So a NaN anywhere in an
nms window gives 0 (``center >= NaN`` is false), and a NaN Laplacian
gives a NaN pixel. The kernel's payload bodies take the same rule
(``max_nan`` / ``min_nan`` in ``csrc/stencil_pipeline.cu``); with
fmaxf / fminf they kept an nms centre beside a NaN and gave the blur for
a NaN Laplacian.

Each case checks two things on the same frames:

* the kernel, compiled for the host under the shim of
  ``tests/test_torch_kernel_host.py``, equals the plain version with NaN
  positions equal and every other bit equal (single frames, batches and
  tiles of a larger frame, prefetch depths 1 and 2);
* the plain version equals the jnp oracle
  (``repro.core.algorithms.execute_reference``) by the comparison of
  ``tests/test_torch_stencil.py`` (bitwise, else 32 ULP at the array's
  scale), NaN positions equal.

Two kinds of frame: NaN sprinkled at seeded positions, and NaN on a grid
whose pitch leaves every finite pocket of the first nms stage's input
narrower than its 3x3 window, so every nms centre has a NaN in its
window. Each case first checks that its frames reach the rule: the
pipeline with fmaxf / fminf's rule in those bodies gives other pixels.
``tests/test_torch_cuda.py`` runs the kernel half on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms
from repro_torch.core.dag import PipelineDAG
from repro_torch.imaging import PlanCache, execute_tiled
from repro_torch.kernels import stencil_pipeline as sp
from test_torch_kernel_host import host_kernel  # noqa: F401  (fixture)

NAN_PIPELINES = ["canny-m", "canny-s", "denoise-m", "harris-s"]
FRAME_KINDS = ["sprinkled", "centres"]
# (rows, columns) of the NaN grid of a "centres" frame: a NaN input pixel
# reaches a block of the first nms stage's input (canny-s: 7 x 7 through
# the blurs and gradients; harris-s: 3 x 5), and a pitch of the block
# plus 2 (or 1) leaves finite pockets too narrow for a 3x3 window
# (canny-m's two gradient branches leave wider ones: a pitch of 7).
# denoise-m's Laplacian reaches 5 x 5: its pitch leaves finite blurs
# beside NaN Laplacians.
CENTRE_PITCH = {"canny-s": (9, 9), "canny-m": (7, 7), "harris-s": (4, 6),
                "denoise-m": (7, 7)}


def nan_frames(name: str, kind: str, b: int, h: int, w: int,
               seed: int) -> np.ndarray:
    """``b`` seeded (h, w) frames of values in [0, 4) (canny-s's
    threshold keeps some nms peaks) with NaN pixels: 0.4% at seeded
    positions, or on the pipeline's centre grid (offset per frame, with
    the first and last row and column, so no finite pocket at an edge is
    wider than one inside)."""
    rng = np.random.RandomState(seed)
    x = (4 * rng.rand(b, h, w)).astype(np.float32)
    if kind == "sprinkled":
        x[rng.rand(b, h, w) < 0.004] = np.nan
    else:
        py, px = CENTRE_PITCH[name]
        for i in range(b):
            rows = sorted({0, h - 1, *range(i % py, h, py)})
            cols = sorted({0, w - 1, *range(2 * i % px, w, px)})
            x[i][np.ix_(rows, cols)] = np.nan
    return x


def dag_of(name: str):
    return algorithms.ALGORITHMS[name]()


def _nms_dropping(wins):
    """nms with fmaxf's rule: a NaN in the window is skipped."""
    win = next(iter(wins.values()))
    centre = win[..., -2, -2]
    m = win[..., 0, 0]
    for dy in range(win.shape[-2]):
        for dx in range(win.shape[-1]):
            m = torch.fmax(m, win[..., dy, dx])
    return torch.where(centre >= m, centre, 0.0)


def _comb_dropping(wins):
    """denoise_comb with fminf / fmaxf's clamp: a NaN Laplacian gives 0."""
    e = torch.fmin(torch.fmax(torch.abs(wins["lap"][..., 0, 0]),
                              torch.tensor(0.0)), torch.tensor(1.0))
    return e * wins["in"][..., 0, 0] + (1.0 - e) * wins["b"][..., 0, 0]


def dropping_dag(name: str):
    """``name`` with its nms and denoise_comb stages taking fmaxf /
    fminf's rule (the payload bodies before the NaN rule)."""
    dag = dag_of(name)
    fns = {"nms": _nms_dropping, "denoise_comb": _comb_dropping}
    stages = [dataclasses.replace(st, fn=fns[st.fn.op])
              if st.fn is not None and st.fn.op in fns else st
              for st in dag.stages.values()]
    return PipelineDAG(dag.name, stages, dag.edges)


def assert_equal_nan_positions(got, exp):
    """NaN where ``exp`` is NaN and every other float32 bit equal (the
    NaN's own payload bits may differ: the card's max.NaN gives the
    canonical NaN)."""
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    nan = np.isnan(exp)
    assert np.array_equal(np.isnan(got), nan), \
        f"NaN at {np.argwhere(np.isnan(got) != nan)[:5].tolist()}"
    diff = got[~nan].view(np.int32) != exp[~nan].view(np.int32)
    assert not diff.any(), \
        f"{int(diff.sum())} pixels differ, e.g. {got[~nan][diff][:5]} " \
        f"against {exp[~nan][diff][:5]}"


def assert_oracle_close(got, exp):
    """The oracle comparison (bitwise, else 32 ULP at the array's scale
    of the finite pixels), NaN positions equal."""
    got, exp = np.asarray(got), np.asarray(exp)
    nan = np.isnan(exp)
    assert np.array_equal(np.isnan(got), nan)
    g, e = got[~nan], exp[~nan]
    if np.array_equal(g, e):
        return
    tol = 32 * np.spacing(np.abs(e).max())
    np.testing.assert_allclose(g, e, rtol=0, atol=tol)


def check_frames_show_the_rule(name: str, kind: str, x: np.ndarray) -> None:
    """The frames reach the NaN rule: fmaxf / fminf's rule gives other
    output pixels; the first nms stage's input has finite centres with a
    NaN in their window (for a "centres" frame: every window holds a
    NaN); denoise-m has finite blurs beside NaN Laplacians."""
    feeds = {"in": torch.from_numpy(x)}
    exp = sp.stencil_pipeline_plain(dag_of(name), feeds).numpy()
    drop = sp.stencil_pipeline_plain(dropping_dag(name), feeds).numpy()
    with pytest.raises(AssertionError):
        assert_equal_nan_positions(drop, exp)
    vals = algorithms.execute_reference(dag_of(name), feeds)
    if name == "denoise-m":
        lap, blur = vals["lap"].numpy(), vals["b"].numpy()
        assert (np.isnan(lap) & ~np.isnan(blur)).any()
        return
    src = next(e.producer for e in dag_of(name).in_edges("nms"))
    v = np.pad(vals[src].numpy(), ((0, 0), (2, 0), (2, 0)))
    h, w = x.shape[1:]
    windows = np.lib.stride_tricks.sliding_window_view(v, (3, 3),
                                                       axis=(1, 2))
    any_nan = np.isnan(windows).any(axis=(-2, -1))[:, :h, :w]
    centre = vals[src].numpy()
    # the nms centre sits at window cell [-2, -2]: one row and column up
    ctr = np.pad(centre, ((0, 0), (1, 0), (1, 0)))[:, :h, :w]
    assert (any_nan & ~np.isnan(ctr)).any()
    if kind == "centres":
        assert any_nan.all()


# (rows per step, prefetch depth) of the host runs
STEPS = [(1, 1), (8, 1), (3, 2), (8, 2)]


@pytest.mark.parametrize("kind", FRAME_KINDS)
@pytest.mark.parametrize("name", NAN_PIPELINES)
def test_nan_frames_match_plain_and_the_oracle(host_kernel, name, kind):
    """Single frames and batches of 3 at a scalar and a float4 width, R =
    1, 3, 8, depths 1 and 2: the kernel equals the plain version (NaN
    positions equal, every other bit equal), which equals the jnp
    oracle."""
    dag = dag_of(name)
    for seed, (b, h, w) in enumerate([(1, 37, 53), (3, 37, 53),
                                      (2, 20, 64)]):
        x = nan_frames(name, kind, b, h, w, seed)
        check_frames_show_the_rule(name, kind, x)
        exp = sp.stencil_pipeline_plain(dag, {"in": torch.from_numpy(x)})
        for r, depth in STEPS:
            prog = sp.build_program(dag, h, w, r, frames=b, target_ctas=64,
                                    prefetch_depth=depth,
                                    poison_prefetch=depth > 1)
            assert_equal_nan_positions(host_kernel(prog, x), exp.numpy())
        assert_oracle_close(exp.numpy(), oracle(name, x))


def oracle(name: str, x: np.ndarray) -> np.ndarray:
    """The jnp oracle's output for each frame of ``x``."""
    import jax

    from repro.core import algorithms as jax_algorithms
    dag = jax_algorithms.ALGORITHMS[name]()
    run = jax.jit(lambda img: jax_algorithms.execute_reference(
        dag, {"in": img})["out"])
    return np.stack([np.asarray(run(f)) for f in x])


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("kind", FRAME_KINDS)
@pytest.mark.parametrize("name", NAN_PIPELINES)
def test_tiled_nan_frames_match_plain_and_the_oracle(host_kernel, name, kind,
                                                     depth):
    """A 50 x 70 frame through ``execute_tiled`` in 24 x 40 tiles (each
    tile's halo recomputed from real input, NaN included), every batch of
    tiles run by the host-compiled kernel: equal to the plain version of
    the whole frame, which equals the oracle."""
    ran = []

    def on_host(ex):
        def run(frames):
            x = np.ascontiguousarray(frames["in"].numpy())
            ran.append(ex.prefetch_depth)
            return torch.from_numpy(host_kernel(ex.program, x))
        return run
    cache = PlanCache(device="cpu")
    cache.executor_wrapper = on_host
    x = nan_frames(name, kind, 1, 50, 70, 40 + depth)
    check_frames_show_the_rule(name, kind, x)
    got = execute_tiled(cache, name, {"in": x[0]}, 24, 40, batch=4,
                        prefetch_depth=depth)
    assert ran and set(ran) == {depth}
    exp = sp.stencil_pipeline_plain(dag_of(name), {"in": torch.from_numpy(x)})
    assert_equal_nan_positions(got.numpy()[None], exp.numpy())
    assert_oracle_close(exp.numpy(), oracle(name, x))
