"""The port's model layers against the JAX package's, on the CPU.

Each layer function of ``repro_torch.models`` (attention on its masked,
banded and flash paths, RoPE and M-RoPE, the ring decode step, MoE
dispatch, RG-LRU and RWKV-6) takes the same seeded float32 inputs and
parameters as its counterpart in ``repro.models``. Bound: rtol 1e-5 /
atol 1e-5, as for the whole models (``tests/test_torch_models.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models import rglru as jax_rglru
from repro.models import rwkv6 as jax_rwkv6
from repro_torch.models import layers, moe, rglru, rwkv6

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny: one intra-op thread. More only spin
    against the other test workers (the three LM test files took 401 s of
    CPU for 70 s of wall on 3 workers with 8 threads each, 155 s for 43 s
    with one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, exp, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(exp, np.float32), rtol=rtol, atol=atol)


def _attn_params(seed, d=64, n_heads=4, n_kv=2, hd=16, bias=True):
    rng = np.random.RandomState(seed)
    p = {"wq": rng.randn(d, n_heads, hd) / 8, "wk": rng.randn(d, n_kv, hd) / 8,
         "wv": rng.randn(d, n_kv, hd) / 8,
         "wo": rng.randn(n_heads, hd, d) / 8}
    if bias:
        p.update(bq=rng.randn(n_heads, hd), bk=rng.randn(n_kv, hd),
                 bv=rng.randn(n_kv, hd))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    blk = layers.Attention(d, n_heads, n_kv, hd, bias, 1e4, torch.float32,
                           "cpu")
    for k, v in p.items():
        getattr(blk, k).data.copy_(torch.from_numpy(v))
    return {k: jnp.asarray(v) for k, v in p.items()}, blk


@pytest.mark.parametrize("path,s,window,causal", [
    ("masked", 24, 0, True), ("masked", 24, 0, False),
    ("masked-window", 24, 16, True), ("banded", 40, 8, True),
    ("banded-padded", 43, 8, True), ("flash", 3072, 0, True),
    ("flash-bidirectional", 3072, 0, False)])
def test_attention_paths(path, s, window, causal):
    jp, blk = _attn_params(3)
    rng = np.random.RandomState(4)
    x = rng.randn(1, s, 64).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (1, s))
    exp = jax_layers.gqa_attention(jp, jnp.asarray(x), jnp.asarray(pos),
                                   causal=causal, window=window)
    got = layers.gqa_attention(blk, torch.from_numpy(x),
                               torch.from_numpy(pos.copy()), causal=causal,
                               window=window)
    close(got, exp)


def test_rope_and_mrope():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 9, 3, 32).astype(np.float32)
    pos = rng.randint(0, 500, (2, 9))
    mpos = rng.randint(0, 500, (3, 2, 9))
    freqs = torch.from_numpy(layers.rope_freqs(32, 1e6))
    close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            freqs),
          jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    close(layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(mpos),
                             freqs),
          jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(mpos), 1e6))


def test_decode_ring_wraps_like_reference():
    """A window-5 ring over 13 positions for two rows at different
    positions (one wraps twice, one not yet full)."""
    jp, blk = _attn_params(6)
    rng = np.random.RandomState(7)
    jk = jnp.zeros((2, 5, 2, 16))
    jv = jnp.zeros((2, 5, 2, 16))
    tk, tv = torch.zeros((2, 5, 2, 16)), torch.zeros((2, 5, 2, 16))
    for t in range(13):
        x = rng.randn(2, 1, 64).astype(np.float32)
        pos = np.array([t, max(t - 9, 0)])
        jo, jk, jv = jax_layers.gqa_decode_step(
            jp, jnp.asarray(x), jk, jv, jnp.asarray(pos), window=5)
        to, tk, tv = layers.gqa_decode_step(
            blk, torch.from_numpy(x), tk, tv, torch.from_numpy(pos), window=5)
        close(to, jo)
        close(tk, jk)
        close(tv, jv)


@pytest.mark.parametrize("capacity_factor,s", [(1.25, 24), (0.5, 24),
                                               (1.25, 1)])
def test_moe_dispatch_matches_reference(capacity_factor, s):
    """Per-row capacity dispatch, overflow drops included (factor 0.5)."""
    rng = np.random.RandomState(8)
    d, f, e, k = 32, 48, 4, 2
    p = {"router": rng.randn(d, e) * 0.5, "w_gate": rng.randn(e, d, f) / 6,
         "w_up": rng.randn(e, d, f) / 6, "w_down": rng.randn(e, f, d) / 7}
    p = {n: v.astype(np.float32) for n, v in p.items()}
    blk = moe.MoE(d, f, e, torch.float32, "cpu")
    for n, v in p.items():
        getattr(blk, n).data.copy_(torch.from_numpy(v))
    x = rng.randn(3, s, d).astype(np.float32)
    jo, jaux = jax_moe.moe_apply({n: jnp.asarray(v) for n, v in p.items()},
                                 jnp.asarray(x), top_k=k,
                                 capacity_factor=capacity_factor)
    to, taux = moe.moe_apply(blk, torch.from_numpy(x), top_k=k,
                             capacity_factor=capacity_factor)
    close(to, jo)
    for n in ("load_balance", "router_z"):
        close(taux[n], jaux[n])


def test_moe_top_k_ties_take_the_lower_index():
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2]])
    _, idx = moe._top_k(probs, 3)
    j_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)[1]
    assert idx.tolist() == np.asarray(j_idx).tolist() == [[1, 2, 0]]


def _rglru_params(rng, d=32, w=48):
    p = {"w_x": rng.randn(d, w) / 6, "w_y": rng.randn(d, w) / 6,
         "conv_w": rng.randn(4, w) * 0.1, "conv_b": rng.randn(w) * 0.1,
         "lambda_p": np.linspace(2.0, 6.0, w),
         "w_rgate": rng.randn(w, w) * 0.1, "w_igate": rng.randn(w, w) * 0.1,
         "w_out": rng.randn(w, d) / 7}
    p = {n: v.astype(np.float32) for n, v in p.items()}
    blk = rglru.RGLRU(d, w, 4, torch.float32, "cpu")
    for n, v in p.items():
        getattr(blk, n).data.copy_(torch.from_numpy(v))
    return {n: jnp.asarray(v) for n, v in p.items()}, blk


@pytest.mark.parametrize("s", [7, 600])
def test_rglru_block_and_decode_match_reference(s):
    """The chunked scan (600 steps cross a 512 chunk, padded with a = 1)
    and the one-step decode with its conv state."""
    rng = np.random.RandomState(9)
    jp, blk = _rglru_params(rng)
    x = rng.randn(2, s, 32).astype(np.float32)
    jo, jst = jax_rglru.rglru_block(jp, jnp.asarray(x))
    to, tst = rglru.rglru_block(blk, torch.from_numpy(x))
    close(to, jo)
    close(tst, jst)
    xs = rng.randn(2, 1, 32).astype(np.float32)
    conv = rng.randn(2, 3, 48).astype(np.float32)
    jr = jax_rglru.rglru_decode(jp, jnp.asarray(xs), jst, jnp.asarray(conv))
    tr = rglru.rglru_decode(blk, torch.from_numpy(xs), tst,
                            torch.from_numpy(conv))
    for g, e in zip(tr, jr):
        close(g, e)


def test_rwkv6_time_and_channel_mix_match_reference():
    """70 steps cross the reference's 64-step chunk (padded w = 1, k = 0).
    The reference's initialisers, with the token-shift mixes, decay base
    and bonus moved off their constants."""
    rng = np.random.RandomState(10)
    d, h, f = 32, 4, 64
    blk = rwkv6.RWKV6(d, h, f, torch.float32, "cpu")
    blk.init_(torch.Generator().manual_seed(10))
    p = {}
    for n, t in blk.named_parameters():
        if n in ("mu", "cm_mu", "bonus_u", "decay_base"):
            t.data += torch.from_numpy(
                rng.uniform(-0.4, 0.4, t.shape).astype(np.float32))
        p[n] = jnp.asarray(t.numpy())
    x = rng.randn(2, 70, d).astype(np.float32)
    jo, js = jax_rwkv6.time_mix(p, jnp.asarray(x), h)
    to, ts = rwkv6.time_mix(blk, torch.from_numpy(x), h)
    close(to, jo)
    close(ts, js)
    close(rwkv6.channel_mix(blk, torch.from_numpy(x)),
          jax_rwkv6.channel_mix(p, jnp.asarray(x)))
    xs = rng.randn(2, 1, d).astype(np.float32)
    prev = rng.randn(2, 1, d).astype(np.float32)
    jo, js2 = jax_rwkv6.time_mix_decode(p, jnp.asarray(xs), h, js,
                                        jnp.asarray(prev))
    to, ts2 = rwkv6.time_mix_decode(blk, torch.from_numpy(xs), h, ts,
                                    torch.from_numpy(prev))
    close(to, jo)
    close(ts2, js2)
