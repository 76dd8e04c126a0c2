"""The port's ``Model.loss`` against the JAX package's, on the CPU.

The chunked cross-entropy (``LOSS_CHUNK`` forced to 8 at S = 64, as
``tests/test_loss_chunking.py`` forces it), the ``loss_mask``, remat per
super-block, and the gradients of every attention path (masked, banded,
the flash path forced by a query block of 16) against ``jax.grad`` of the
reference's loss, parameters carried across by ``params_from_reference``.

Bounds: losses within rtol 1e-5; gradients within rtol 1e-4 / atol 1e-6
(measured on these inputs: at most 2.0e-7 absolute; float32 sums in
another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build
from repro.models import get_config as jax_config
from repro.models import layers as jax_layers
from repro_torch.models import build_model, get_config, layers, \
    params_from_reference
from repro_torch.models.weights import reference_items

G_RTOL, G_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: one intra-op thread (more only spin against the
    other test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny(**extra):
    """``tests/test_loss_chunking.py``'s config."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab=128, dtype="float32", remat=False)
    kw.update(extra)
    return kw


def pair(name="qwen2.5-3b", **extra):
    jm = jax_build(dataclasses.replace(jax_config(name), **tiny(**extra)))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(dataclasses.replace(get_config(name), **tiny(**extra)),
                     device="cpu")
    params_from_reference(tm, jax.tree.map(np.asarray, params))
    tm.requires_grad_(True)
    return jm, params, tm


def batch_of(vocab, b=2, s=64, seed=1, mask=False):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, vocab, (b, s)).astype(np.int32),
             "labels": rng.randint(0, vocab, (b, s)).astype(np.int32)}
    if mask:
        batch["loss_mask"] = (rng.rand(b, s) < 0.6).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def port_grads(tm, tb):
    tm.zero_grad(set_to_none=True)
    loss, metrics = tm.loss(tb)
    loss.backward()
    return loss.detach(), metrics, {n: p.grad.clone() for n, p in
                           tm.named_parameters()}


def assert_grads_close(tm, tgrads, jm, params, jb):
    """The port's gradients against ``jax.grad`` of the reference's loss
    on the same batch."""
    jgrads = jax.jit(jax.grad(lambda p: jm.loss(p, jb)[0]))(params)
    for name, exp in reference_items(tm, jax.tree.map(np.asarray, jgrads)):
        np.testing.assert_allclose(tgrads[name].numpy(), exp, rtol=G_RTOL,
                                   atol=G_ATOL, err_msg=name)


def test_chunked_ce_matches_direct_and_reference():
    """LOSS_CHUNK = 8 at S = 64: 8 checkpointed chunks, against the
    direct path of the same model, the reference's chunked loss and its
    gradient."""
    jm, params, tm = pair()
    jm.LOSS_CHUNK = tm.LOSS_CHUNK = 8
    jb, tb = batch_of(128)
    calls = []
    orig = tm._nll
    tm._nll = lambda x, lab: (calls.append(x.shape[1]), orig(x, lab))[1]
    loss, metrics, grads = port_grads(tm, tb)
    assert calls[:8] == [8] * 8                  # chunked forward
    jloss, jmet = jm.loss(params, jb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["nll"]), float(jmet["nll"]),
                               rtol=1e-5)
    assert_grads_close(tm, grads, jm, params, jb)
    del tm._nll
    tm.LOSS_CHUNK = 512                          # direct: S <= 2 * chunk
    direct, _, dgrads = port_grads(tm, tb)
    np.testing.assert_allclose(float(direct), float(loss), rtol=1e-5)
    for n in grads:
        np.testing.assert_allclose(dgrads[n].numpy(), grads[n].numpy(),
                                   rtol=G_RTOL, atol=G_ATOL, err_msg=n)
    with torch.no_grad():                        # the reference's formula
        logits, aux = tm.forward(tb)
        logz = torch.logsumexp(logits, -1)
        gold = logits.gather(-1, tb["labels"][..., None].long())[..., 0]
        np.testing.assert_allclose(float((logz - gold).mean() + 0.01 * aux),
                                   float(loss), rtol=1e-5)


def test_ce_chunks_only_when_the_sequence_divides():
    """S = 60 with LOSS_CHUNK = 8: not a multiple, the direct path."""
    _, _, tm = pair()
    tm.LOSS_CHUNK = 8
    _, tb = batch_of(128, s=60)
    calls = []
    orig = tm._nll
    tm._nll = lambda x, lab: (calls.append(x.shape[1]), orig(x, lab))[1]
    with torch.no_grad():
        tm.loss(tb)
    assert calls == [60]


@pytest.mark.parametrize("chunk", [8, 512])
def test_loss_mask_matches_reference(chunk):
    """A seeded 0/1 mask: the masked mean and its gradient; an all-zero
    mask gives loss 0 + aux (denominator clamped to 1)."""
    jm, params, tm = pair()
    jm.LOSS_CHUNK = tm.LOSS_CHUNK = chunk
    jb, tb = batch_of(128, mask=True)
    loss, _, grads = port_grads(tm, tb)
    jloss, _ = jm.loss(params, jb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_grads_close(tm, grads, jm, params, jb)
    tb["loss_mask"] = torch.zeros_like(tb["loss_mask"])
    with torch.no_grad():
        zero, metrics = tm.loss(tb)
    assert float(zero) == 0.0 and float(metrics["nll"]) == 0.0


@pytest.mark.parametrize("name", ["gemma3-1b", "granite-moe-1b-a400m",
                                  "recurrentgemma-2b"])
def test_remat_on_and_off_bit_for_bit(name):
    """cfg.remat checkpoints each super-block (gemma3's 5 local : 1
    global, recurrentgemma's rec, rec, attn, an MoE's aux loss inside the
    checkpoint): loss and every gradient equal bit for bit on the CPU."""
    cfg = dataclasses.replace(get_config(name), **tiny(
        n_layers=6, vocab=128, window=min(get_config(name).window, 6),
        n_kv_heads=1 if name != "granite-moe-1b-a400m" else 2,
        n_experts=min(get_config(name).n_experts, 4),
        top_k=min(get_config(name).top_k, 2),
        lru_width=64 if get_config(name).lru_width else 0,
        head_dim=16 if get_config(name).head_dim else 0))
    _, tb = batch_of(128, s=32)
    out = []
    for remat in (False, True):
        tm = build_model(dataclasses.replace(cfg, remat=remat), device="cpu",
                         generator=torch.Generator().manual_seed(0))
        tm.requires_grad_(True)
        calls = []
        orig = tm._superblock
        tm._superblock = lambda *a: (calls.append(1), orig(*a))[1]
        out.append((port_grads(tm, tb), len(calls)))
    ((l0, m0, g0), n0), ((l1, m1, g1), n1) = out
    n_blocks = sum(s.n for s in tm.segments)
    assert n0 == n_blocks and n1 == 2 * n_blocks     # recomputed once
    assert torch.equal(l0, l1) and torch.equal(m0["aux"], m1["aux"])
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_flash_and_banded_gradients_match_reference(monkeypatch):
    """gemma3 (a local and a global layer, window 6) at S = 64 with a
    query block of 16 in both packages: the local layer takes the banded
    path, the global one the flash path (-inf masks and isfinite guards):
    loss and gradients against ``jax.grad``, all finite."""
    monkeypatch.setattr(jax_layers, "_QUERY_BLOCK", 16)
    monkeypatch.setattr(layers, "_QUERY_BLOCK", 16)
    calls = []
    for fn in ("_flash_attention", "banded_attention"):
        orig = getattr(layers, fn)
        monkeypatch.setattr(layers, fn, lambda *a, _o=orig, _n=fn, **k: (
            calls.append(_n), _o(*a, **k))[1])
    extra = dict(n_layers=2, layer_pattern="LG", window=6, n_kv_heads=1,
                 head_dim=16, remat=True)
    jm, params, tm = pair("gemma3-1b", **extra)
    jb, tb = batch_of(128, s=64)
    loss, _, grads = port_grads(tm, tb)
    assert calls == ["banded_attention", "_flash_attention"] * 2  # + remat
    jloss, _ = jm.loss(params, jb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert_grads_close(tm, grads, jm, params, jb)


def test_masked_path_gradients_match_reference():
    """The same model at S = 12 (no banded or flash path: S <= 2 *
    window, S <= 2 * query block): the masked softmax's gradients."""
    extra = dict(n_layers=2, layer_pattern="LG", window=6, n_kv_heads=1,
                 head_dim=16)
    jm, params, tm = pair("gemma3-1b", **extra)
    jb, tb = batch_of(128, s=12)
    loss, _, grads = port_grads(tm, tb)
    np.testing.assert_allclose(float(loss), float(jm.loss(params, jb)[0]),
                               rtol=1e-5)
    assert_grads_close(tm, grads, jm, params, jb)
