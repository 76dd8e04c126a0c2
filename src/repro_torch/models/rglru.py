"""RG-LRU recurrent blocks (Griffin/RecurrentGemma, arXiv:2402.19427).

The port of ``src/repro/models/rglru.py``. The recurrence is
diagonal-linear with input-dependent gates,

    a_t = a^(c * r_t),  a = sigmoid(lambda_p)   (per channel)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence path runs it in chunks of 512 steps, a log-depth scan
inside each chunk and the carry across them (the reference's chunked
``associative_scan``; padded steps have a = 1 and add nothing), and decode
carries the O(1) diagonal state. The block is linear -> temporal conv1d
(width 4) -> RG-LRU -> gated linear out.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import ParamBlock, const, gelu, linspace, normal

_C = 8.0  # gate temperature from the Griffin paper


class RGLRU(ParamBlock):
    def __init__(self, d, lru_width, conv_width, dtype, device):
        super().__init__(device)
        w = lru_width
        self.param("w_x", (d, w), dtype, normal())
        self.param("w_y", (d, w), dtype, normal())
        self.param("conv_w", (conv_width, w), dtype, normal(0.1))
        self.param("conv_b", (w,), dtype, const(0.0))
        self.param("lambda_p", (w,), torch.float32, linspace(2.0, 6.0))
        self.param("w_rgate", (w, w), dtype, normal(0.02))
        self.param("w_igate", (w, w), dtype, normal(0.02))
        self.param("w_out", (w, d), dtype, normal(1.0 / math.sqrt(w)))


def _conv1d(x, w, b):
    """Causal depthwise temporal conv. x: (B,S,W); w: (K,W)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = pad[:, 0:x.shape[1]] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + x.shape[1]] * w[i]
    return out + b


def _gates(p, u):
    r = torch.sigmoid(u @ p.w_rgate).float()
    i = torch.sigmoid(u @ p.w_igate).float()
    # log sigmoid(lambda_p) = -softplus(-lambda_p), softplus as logaddexp
    neg = -p.lambda_p
    log_a0 = -torch.logaddexp(neg, torch.zeros_like(neg))
    log_a = _C * r * log_a0[None, None, :]
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * u.float()
    return a, gated


_CHUNK = 512  # time-chunk: log-depth scan inside, sequential across


def _scan(a, g):
    """Inclusive scan of h_t = a_t h_{t-1} + g_t along dim 0 in log2(T)
    doubling steps (Hillis-Steele), h_{-1} = 0."""
    n = a.shape[0]
    d = 1
    while d < n:
        g = torch.cat([g[:d], a[d:] * g[:-d] + g[d:]])
        a = torch.cat([a[:d], a[d:] * a[:-d]])
        d *= 2
    return g


def rglru_block(p, x, state=None):
    """x: (B,S,D) -> (out, final_state (B,W))."""
    b, s, d = x.shape
    u = x @ p.w_x
    y_branch = gelu(x @ p.w_y)
    u = _conv1d(u, p.conv_w, p.conv_b)
    a, gated = _gates(p, u)
    w = u.shape[-1]
    if state is None:
        state = torch.zeros((b, w), dtype=torch.float32, device=x.device)

    chunk = min(_CHUNK, s)
    pad = (-s) % chunk
    nc = (s + pad) // chunk
    ap = F.pad(a, (0, 0, 0, pad), value=1.0)
    gp = F.pad(gated, (0, 0, 0, pad))
    ac = ap.transpose(0, 1).reshape(nc, chunk, b, w)
    gc = gp.transpose(0, 1).reshape(nc, chunk, b, w)
    hs = []
    for c in range(nc):
        g_i = gc[c].clone()
        g_i[0] = g_i[0] + ac[c, 0] * state
        hh = _scan(ac[c], g_i)
        state = hh[-1]
        hs.append(hh)
    hh = torch.cat(hs)[:s].transpose(0, 1)
    out = (hh.to(x.dtype) * y_branch) @ p.w_out
    return out, state


def rglru_decode(p, x, state, conv_state):
    """x: (B,1,D); state: (B,W); conv_state: (B,K-1,W) past conv inputs.
    Returns (out, new state, new conv state)."""
    u_new = (x @ p.w_x)[:, 0]                                # (B, W)
    y_branch = gelu(x @ p.w_y)[:, 0]
    k = p.conv_w.shape[0]
    window = torch.cat([conv_state, u_new[:, None]], dim=1)  # (B,K,W)
    u = window[:, 0] * p.conv_w[0]
    for i in range(1, k):
        u = u + window[:, i] * p.conv_w[i]
    u = u + p.conv_b
    a, gated = _gates(p, u[:, None])
    h = a[:, 0] * state + gated[:, 0]
    out = (h.to(x.dtype) * y_branch) @ p.w_out
    return out[:, None], h, window[:, 1:]
