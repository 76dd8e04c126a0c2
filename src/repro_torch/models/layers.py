"""Core neural layers in PyTorch: norms, RoPE/M-RoPE, GQA attention, MLPs.

The port of ``src/repro/models/layers.py``. Parameters live in small
``nn.Module`` blocks (:class:`ParamBlock`) that hold the reference's
parameter names and shapes, so carrying a JAX parameter tree across is a
copy (``models/weights.py``); the layer functions take a block and
tensors, as the reference's take a dict and arrays.

Each weight is stored in the dtype its uses read: a weight the reference
reads only through ``.astype(x.dtype)`` is kept in the compute dtype (the
values are the same, cast once at load), and the ones it reads in float32
(norm scales, the embedding table that ``unembed`` reads, the MoE router,
the RG-LRU and RWKV decay constants) stay float32.

The reference's sharding hooks (``activation_sharding``, ``shard_dim``,
``pin_batch``, ``_seq_constraint``) are identities without a mesh and are
left out; they come with the ``distributed/`` port. RoPE takes its
frequency table from the attention block (``Attention.freqs``, built once
on the block's device) where the reference recomputes it from ``theta``.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Init = Callable[[tuple, torch.Generator, torch.device], torch.Tensor]


def normal(scale: float | None = None) -> Init:
    """The reference's ``_init``: N(0, 1) x scale, scale 1/sqrt(shape[0])
    unless given, drawn in float32."""
    def init(shape, gen, device):
        s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * s
    return init


def const(value: float) -> Init:
    def init(shape, gen, device):
        return torch.full(shape, value, dtype=torch.float32, device=device)
    return init


def linspace(start: float, end: float) -> Init:
    def init(shape, gen, device):
        return torch.linspace(start, end, shape[0], dtype=torch.float32,
                              device=device)
    return init


class ParamBlock(nn.Module):
    """Named parameters with the reference's shapes, each with the
    reference's initialiser. A block is built with gradients off, as
    serving uses it (the engine captures its steps as CUDA graphs); the
    training state turns them on (``train.make_train_state``,
    ``requires_grad_(True)``)."""

    def __init__(self, device: torch.device):
        super().__init__()
        self._device = torch.device(device)
        self._inits: dict[str, Init] = {}

    def param(self, name: str, shape: tuple, dtype: torch.dtype,
              init: Init) -> None:
        t = torch.empty(shape, dtype=dtype, device=self._device)
        self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self._inits[name] = init

    def draws(self, gen: torch.Generator):
        """(name, float32 value) of this block's own parameters, drawn
        from ``gen`` in registration order."""
        for name, init in self._inits.items():
            p = getattr(self, name)
            yield name, init(tuple(p.shape), gen, p.device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """Fill this block's own parameters (drawn in float32, then cast
        to each parameter's dtype) from ``gen``, in registration order."""
        for name, value in self.draws(gen):
            getattr(self, name).copy_(value)


def weak(value: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX applies it to an array of ``dtype``: cast to
    that dtype first (JAX scalars are weakly typed). PyTorch would multiply
    a bfloat16 tensor by the unrounded scalar and round once."""
    return torch.tensor(value, dtype=dtype).item()


# ----------------------------------------------------------------- norms
class RMSNorm(ParamBlock):
    def __init__(self, d: int, device):
        super().__init__(device)
        self.param("scale", (d,), torch.float32, const(1.0))


def rmsnorm(p, x, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale).to(x.dtype)


# ------------------------------------------------------------------ RoPE
def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


def _rotate(x, cos, sin):
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, N, hd); positions: (B, S); freqs: ``rope_freqs`` on the
    device -> rotated x."""
    ang = positions[..., None].float() * freqs               # (B, S, hd/2)
    return _rotate(x, ang.cos()[:, :, None, :], ang.sin()[:, :, None, :])


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                freqs: torch.Tensor, sections=(2, 3, 3)) -> torch.Tensor:
    """Qwen2-VL M-RoPE: positions (3, B, S) = (temporal, h, w); the head-dim
    frequency bands are split across the three components in proportion
    ``sections`` (arXiv:2409.12191)."""
    half = x.shape[-1] // 2
    total = sum(sections)
    bounds = np.cumsum([int(half * s / total) for s in sections])
    comp = torch.zeros((half,), dtype=torch.long, device=x.device)
    comp[int(bounds[0]):int(bounds[1])] = 1
    comp[int(bounds[1]):] = 2
    pos = positions.float()                                  # (3, B, S)
    ang = pos[comp].permute(1, 2, 0) * freqs                 # (B, S, half)
    return _rotate(x, ang.cos()[:, :, None, :], ang.sin()[:, :, None, :])


# ------------------------------------------------------------- attention
_QUERY_BLOCK = 1024  # query-chunk size for long-sequence full attention


class Attention(ParamBlock):
    """GQA projections; ``freqs`` is the RoPE table for ``theta``."""

    def __init__(self, d, n_heads, n_kv, hd, qkv_bias, theta, dtype,
                 device):
        super().__init__(device)
        self.param("wq", (d, n_heads, hd), dtype, normal())
        self.param("wk", (d, n_kv, hd), dtype, normal())
        self.param("wv", (d, n_kv, hd), dtype, normal())
        self.param("wo", (n_heads, hd, d), dtype,
                   normal(1.0 / math.sqrt(n_heads * hd)))
        if qkv_bias:
            self.param("bq", (n_heads, hd), dtype, const(0.0))
            self.param("bk", (n_kv, hd), dtype, const(0.0))
            self.param("bv", (n_kv, hd), dtype, const(0.0))
        self.qkv_bias = qkv_bias
        self.register_buffer("freqs", torch.from_numpy(
            rope_freqs(hd, theta)).to(self._device), persistent=False)


def _proj(x, w):
    """einsum('bsd,dnh->bsnh') as one matrix product."""
    d, n, h = w.shape
    return (x @ w.reshape(d, n * h)).unflatten(-1, (n, h))


def _out(o, wo):
    """einsum('bsnh,nhd->bsd') as one matrix product."""
    n, h, d = wo.shape
    return o.flatten(-2) @ wo.reshape(n * h, d)


def _qkv(p, x, positions, mrope_positions=None):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if p.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, p.freqs)
        k = apply_mrope(k, mrope_positions, p.freqs)
    elif positions is not None:
        q = apply_rope(q, positions, p.freqs)
        k = apply_rope(k, positions, p.freqs)
    return q, k, v


def gqa_attention(p, x, positions, *, causal=True, window=0,
                  mrope_positions=None):
    """Full-sequence GQA attention. window>0 masks i-j < window (causal
    sliding window); causal=False gives a bidirectional encoder.

    The reference's three paths at its thresholds: banded when
    ``window and causal and s > 2*window``, the online-softmax flash path
    when ``s > 2048 and s % 1024 == 0``, the masked one otherwise."""
    b, s, d = x.shape
    if window and causal and s > 2 * window:
        return banded_attention(p, x, positions, window=window)
    n_heads, hd = p.wq.shape[1], p.wq.shape[2]
    g = n_heads // p.wk.shape[1]
    q, k, v = _qkv(p, x, positions, mrope_positions)
    kf = k.repeat_interleave(g, dim=2)                      # (B, S, N, hd)
    vf = v.repeat_interleave(g, dim=2)

    qblk = _QUERY_BLOCK
    if s > 2 * qblk and s % qblk == 0:
        out = _flash_attention(q, kf, vf, causal=causal, window=window)
    else:
        scores = torch.einsum("bsnh,btnh->bnst", q, kf).float()
        scores = scores / math.sqrt(hd)                      # (B,N,S,T)
        i = torch.arange(s, device=x.device)[:, None]
        j = torch.arange(s, device=x.device)[None, :]
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device)
        if causal:
            mask = mask & (j <= i)
        if window:
            mask = mask & (i - j < window)
        scores = torch.where(mask, scores, -1e30)
        pr = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bnst,btnh->bsnh", pr, vf)
    return _out(out, p.wo)


def _flash_attention(q, kf, vf, *, causal=True, window=0):
    """Online-softmax attention over key blocks of 1024, all query blocks
    at once. q/kf/vf: (B, S, N, hd) with KV heads pre-gathered to flat N.
    Keeps the reference's -inf mask with its isfinite guards."""
    b, s, n, hd = q.shape
    qblk = kblk = _QUERY_BLOCK
    nb, nk = s // qblk, s // kblk
    dev = q.device
    qb = q.reshape(b, nb, qblk, n, hd)
    kb = kf.reshape(b, nk, kblk, n, hd)
    vb = vf.reshape(b, nk, kblk, n, hd)
    scale = 1.0 / math.sqrt(hd)
    i_glob = (torch.arange(nb, device=dev)[:, None] * qblk
              + torch.arange(qblk, device=dev)[None, :])    # (nb, qblk)
    ii = i_glob[None, :, None, :, None]

    m_run = torch.full((b, nb, n, qblk), -math.inf, device=dev)
    l_run = torch.zeros((b, nb, n, qblk), device=dev)
    acc = torch.zeros((b, nb, qblk, n, hd), device=dev)
    for t in range(nk):
        sc = torch.einsum("bnqah,btah->bnaqt", qb, kb[:, t])
        sc = sc.float() * scale                              # (B,nb,N,q,k)
        jj = (t * kblk + torch.arange(kblk, device=dev))[None, None, None,
                                                          None, :]
        mask = torch.ones(sc.shape[-2:], dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (jj <= ii)
        if window:
            mask = mask & (ii - jj < window)
        sc = torch.where(mask, sc, -math.inf)
        m_new = torch.maximum(m_run, sc.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        pr = torch.exp(sc - m_safe[..., None])
        pr = torch.where(torch.isfinite(sc), pr, 0.0)
        corr = torch.where(torch.isfinite(m_run),
                           torch.exp(m_run - m_safe), 0.0)
        l_run = l_run * corr + pr.sum(dim=-1)
        pv = torch.einsum("bnaqt,btah->bnqah", pr.to(vb.dtype), vb[:, t])
        acc = acc * corr.transpose(2, 3)[..., None] + pv.float()
        m_run = m_new
    out = acc / l_run.clamp_min(1e-30).transpose(2, 3)[..., None]
    return out.reshape(b, s, n, hd).to(q.dtype)


def banded_attention(p, x, positions, *, window):
    """Causal sliding-window attention computed on w-sized blocks: each
    query block attends its own + the previous key block (covers all
    j in (i-w, i]). Exact same output as the masked full attention."""
    b, s, d = x.shape
    w = window
    n_heads, hd = p.wq.shape[1], p.wq.shape[2]
    g = n_heads // p.wk.shape[1]
    q, k, v = _qkv(p, x, positions)
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    pad = (-s) % w
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
    sp = s + pad
    nb = sp // w
    qb = q.reshape(b, nb, w, n_heads, hd)
    kb = k.reshape(b, nb, w, n_heads, hd)
    vb = v.reshape(b, nb, w, n_heads, hd)

    def shift(a):
        return torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], dim=1)
    kcat = torch.cat([shift(kb), kb], dim=2)               # (B,nb,2w,N,hd)
    vcat = torch.cat([shift(vb), vb], dim=2)
    scores = torch.einsum("bcqnh,bcknh->bcnqk", qb, kcat)
    scores = scores.float() / math.sqrt(hd)                 # (B,nb,N,w,2w)
    dev = x.device
    qi = torch.arange(w, device=dev)[:, None]               # local query
    kj = torch.arange(2 * w, device=dev)[None, :]           # local key
    blk = torch.arange(nb, device=dev)[:, None, None]
    rel = qi + w - kj                                        # i - j
    jglob = (blk - 1) * w + kj                               # >= 0 validity
    mask = (rel >= 0) & (rel < w) & (jglob >= 0)             # (nb, w, 2w)
    scores = torch.where(mask[None, :, None], scores, -1e30)
    pr = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bcnqk,bcknh->bcqnh", pr, vcat)
    out = out.reshape(b, sp, n_heads, hd)[:, :s]
    return _out(out, p.wo)


def gqa_decode_step(p, x, cache_k, cache_v, pos, *, window=0):
    """One-token decode. x: (B, 1, D); cache: (B, S_cache, Nkv, hd) — a full
    causal cache (S_cache = max_seq) or a ring (S_cache = ring size) when
    window > 0 (the line-buffer analogue).

    pos: (B,) current absolute position. Writes this token's K/V row into
    the caches in place (``_scatter_rows``) and returns (out, cache_k,
    cache_v)."""
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    n_heads, hd = p.wq.shape[1], p.wq.shape[2]
    n_kv = p.wk.shape[1]
    g = n_heads // n_kv
    q, k, v = _qkv(p, x, pos[:, None])
    slot = torch.remainder(pos, s_cache) if window else pos   # ring/linear
    cache_k = _scatter_rows(cache_k, k, slot)
    cache_v = _scatter_rows(cache_v, v, slot)
    qg = q.reshape(b, n_kv, g, hd)                            # squeeze S=1
    scores = torch.einsum("bngh,btnh->bngt", qg, cache_k)
    scores = scores.float() / math.sqrt(hd)                   # (B,Nkv,G,T)
    t = torch.arange(s_cache, device=x.device)[None, :]
    if window:
        # ring slot t holds absolute position p_t with (slot - t) mod S =
        # age; valid if age < min(pos+1, window)
        age = torch.remainder(slot[:, None] - t, s_cache)
        valid = age < torch.clamp(pos[:, None] + 1, max=window)
    else:
        valid = t <= pos[:, None]
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    pr = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bngt,btnh->bngh", pr, cache_v).reshape(
        b, 1, n_heads, hd)
    return _out(out, p.wo), cache_k, cache_v


def _scatter_rows(cache, kv, slot):
    """cache (B,S,N,h) <- kv (B,1,N,h) at per-batch row ``slot``, in place
    (an indexed write: the reference's one-hot blend leaves every other
    row as it was and sets this one to kv)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot] = kv[:, 0]
    return cache


# -------------------------------------------------------------------- MLP
class MLP(ParamBlock):
    def __init__(self, d, d_ff, kind, dtype, device):
        super().__init__(device)
        if kind in ("swiglu", "geglu"):
            self.param("w_gate", (d, d_ff), dtype, normal())
        self.param("w_up", (d, d_ff), dtype, normal())
        self.param("w_down", (d_ff, d), dtype, normal(1.0 / math.sqrt(d_ff)))


def gelu(x):
    """jax.nn.gelu's default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(p, x, kind="swiglu"):
    if kind == "swiglu":
        h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    elif kind == "geglu":
        h = gelu(x @ p.w_gate) * (x @ p.w_up)
    else:
        h = gelu(x @ p.w_up)
    return h @ p.w_down


# ------------------------------------------------------------- embedding
class Embed(ParamBlock):
    def __init__(self, vocab, d, device):
        super().__init__(device)
        # scale 1/sqrt(d): with the sqrt(d) embedding multiplier activations
        # enter the stack ~N(0,1) and tied-unembed logits stay O(1)
        self.param("table", (vocab, d), torch.float32,
                   normal(1.0 / math.sqrt(d)))


def embed(p, tokens, dtype):
    """The table's rows for ``tokens``. ``F.embedding``'s backward sums a
    row's gradient in a fixed order (indexing's accumulates in an order
    that varies with the CPU's threads)."""
    return F.embedding(tokens, p.table).to(dtype)


def unembed(p_embed, x, lm_head=None):
    if lm_head is not None:
        return x @ lm_head.to(x.dtype)
    return x @ p_embed.table.to(x.dtype).T
