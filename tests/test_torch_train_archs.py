"""One train step of every architecture against the JAX package's, on
the CPU (float32, from the reference's state carried across), and the
reference's per-layer weight decay. The helpers and bounds are
``tests/test_torch_train.py``'s (split off so that neither file holds a
test worker long).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import OptConfig as JOptConfig
from repro.train import make_train_step as jax_train_step
from repro.train import optimizer as jax_opt
from repro_torch.train import OptConfig, make_train_step
from repro_torch.train import optimizer as opt
from test_torch_train import (ARCHS, OPT, RTOL, assert_state_close,  # noqa: F401
                              carried, make_batch, one_torch_thread,
                              reduced)


def test_reference_decays_per_layer_vectors():
    """The reference's fault: a norm scale stacked over layers (1, d) is
    decayed, the same scale unstacked (d,) is not. With zero gradients
    only decay moves a master."""
    ones = {"stacked": np.ones((1, 8), np.float32),
            "final": np.ones((8,), np.float32)}
    zeros = {k: np.zeros_like(v) for k, v in ones.items()}
    cfg = dict(lr=1e-2, warmup_steps=0)
    _, js, _ = jax_opt.adamw_update(
        JOptConfig(**cfg), ones, zeros,
        {"step": jnp.int32(0), "master": ones, "m": zeros, "v": zeros})
    assert float(js["master"]["stacked"][0, 0]) < 1.0     # decayed
    assert float(js["master"]["final"][0]) == 1.0
    t = {"scale": torch.ones(8)}
    state = {"step": torch.zeros((), dtype=torch.int32),
             "master": {"scale": torch.ones(8)},
             "m": {"scale": torch.zeros(8)}, "v": {"scale": torch.zeros(8)}}
    opt.adamw_update(OptConfig(**cfg), t, {"scale": torch.zeros(8)}, state)
    assert torch.equal(state["master"]["scale"], torch.ones(8))


@pytest.mark.parametrize("name", ARCHS)
def test_one_train_step_matches_reference(name, monkeypatch):
    """Every architecture, float32, from the reference's state: loss,
    grad norm, the new master copies, moments and parameters."""
    jm, jstate, tm, tstate = carried(name, reduced, monkeypatch,
                                     dtype="float32")
    batch = make_batch(tm.cfg)
    jnew, jmet = jax.jit(jax_train_step(jm, JOptConfig(**OPT)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tmet = make_train_step(tm, OptConfig(**OPT))(tstate, batch)
    assert tnew is tstate and int(tstate["opt"]["step"]) == 1
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=RTOL, err_msg=k)
    assert_state_close(tm, tstate, jnew, float(jmet["lr"]))
    for n, p in tm.named_parameters():
        assert torch.equal(p, tstate["opt"]["master"][n].to(p.dtype)), n


def test_vlm_grad_accum_splits_mrope_positions(monkeypatch):
    """qwen2-vl with grad_accum=2: the (3, B, S) M-RoPE positions split on
    their batch axis, as the reference's ``split`` does."""
    jm, jstate, tm, tstate = carried("qwen2-vl-7b", reduced, monkeypatch,
                                     dtype="float32")
    batch = make_batch(tm.cfg, b=4)
    jnew, jmet = jax.jit(jax_train_step(jm, JOptConfig(**OPT),
                                        grad_accum=2))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tmet = make_train_step(tm, OptConfig(**OPT), grad_accum=2)(tstate,
                                                                  batch)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=RTOL)
    assert_state_close(tm, tstate, jnew, float(jmet["lr"]))


def test_grad_accum_splits_a_batch_of_three_by_name(monkeypatch):
    """The reference's fault: its ``split`` takes any 3-d input whose first
    axis is 3 for the (3, B, S) M-RoPE positions, so hubert's (3, S, D)
    frame embeddings at batch 3 split along the sequence and the step
    fails. The port splits the positions by name: grad_accum=3 on a batch
    of 3 equals the reference's grad_accum=1 step."""
    jm, jstate, tm, tstate = carried("hubert-xlarge", reduced, monkeypatch,
                                     dtype="float32")
    batch = make_batch(tm.cfg, b=3, s=12)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="shapes"):
        jax.jit(jax_train_step(jm, JOptConfig(**OPT), grad_accum=3))(jstate,
                                                                     jb)
    jnew, jmet = jax.jit(jax_train_step(jm, JOptConfig(**OPT)))(jstate, jb)
    _, tmet = make_train_step(tm, OptConfig(**OPT), grad_accum=3)(tstate,
                                                                  batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=RTOL, err_msg=k)
    assert_state_close(tm, tstate, jnew, float(jmet["lr"]))
