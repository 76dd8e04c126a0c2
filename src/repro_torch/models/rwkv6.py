"""RWKV-6 "Finch" blocks (arXiv:2404.05892): data-dependent decay linear
attention (time-mix) + channel-mix, attention-free.

The port of ``src/repro/models/rwkv6.py``. State per head is the (hd, hd)
outer-product accumulator

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with w_t produced from the token-shifted input. The full-sequence path
steps it over time; decode carries S as the O(1) recurrent state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import ParamBlock, const, normal


class RWKV6(ParamBlock):
    def __init__(self, d, n_heads, d_ff, dtype, device):
        super().__init__(device)
        hd = d // n_heads
        # time-mix
        self.param("mu", (5, d), dtype, const(0.5))   # token-shift mixes
        self.param("w_r", (d, d), dtype, normal())
        self.param("w_k", (d, d), dtype, normal())
        self.param("w_v", (d, d), dtype, normal())
        self.param("w_o", (d, d), dtype, normal())
        self.param("w_decay", (d, d), dtype, normal(0.01))
        self.param("decay_base", (n_heads, hd), torch.float32, const(-6.0))
        self.param("bonus_u", (n_heads, hd), torch.float32, const(0.0))
        self.param("w_gate", (d, d), dtype, normal())
        # channel-mix
        self.param("cm_mu", (2, d), dtype, const(0.5))
        self.param("cm_k", (d, d_ff), dtype, normal())
        self.param("cm_v", (d_ff, d), dtype, normal(1.0 / math.sqrt(d_ff)))
        self.param("cm_r", (d, d), dtype, normal())


def _shift(x):
    """Token shift: x_{t-1} (zeros at t=0). x: (B, S, D)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _mix(x, xs, mu):
    return x * mu + xs * (1 - mu)


def _decay(p, dx):
    """w = exp(-exp(base + dx)) in (0, 1), float32."""
    return torch.exp(-torch.exp(p.decay_base + dx.float()))


def _time_mix_inputs(p, x, n_heads):
    b, s, d = x.shape
    hd = d // n_heads
    xs = _shift(x)
    mu = p.mu
    xr, xk, xv, xw, xg = (_mix(x, xs, mu[i]) for i in range(5))

    def proj(u, w):
        return (u @ w).reshape(b, s, n_heads, hd)
    r, k, v = proj(xr, p.w_r), proj(xk, p.w_k), proj(xv, p.w_v)
    w = _decay(p, proj(xw, p.w_decay))
    g = F.silu(xg @ p.w_gate)
    return r, k, v, w, g


def _wkv_step(S, r_t, k_t, v_t, u):
    """(o_t, kv_t) for one step; r/k/v: (B,H,hd), S: (B,H,hd,hd) fp32."""
    kv = torch.einsum("bhk,bhv->bhkv", k_t.float(), v_t.float())
    o = torch.einsum("bhk,bhkv->bhv", r_t.float(),
                     S + u[None, :, :, None] * kv)
    return o, kv


def time_mix(p, x, n_heads, state=None):
    """x: (B,S,D) -> (out, final_state). state: (B,H,hd,hd) fp32.

    One step a token: the reference's two-level scan (chunks of 64, padded
    steps with w = 1 and k = 0, which leave S as it is) in its own order."""
    b, s, d = x.shape
    hd = d // n_heads
    r, k, v, w, g = _time_mix_inputs(p, x, n_heads)
    u = p.bonus_u
    if state is None:
        state = torch.zeros((b, n_heads, hd, hd), dtype=torch.float32,
                            device=x.device)
    outs = []
    for t in range(s):
        o, kv = _wkv_step(state, r[:, t], k[:, t], v[:, t], u)
        state = w[:, t, ..., None] * state + kv
        outs.append(o)
    out = torch.stack(outs, dim=1).reshape(b, s, d).to(x.dtype)
    out = (out * g) @ p.w_o
    return out, state


def channel_mix(p, x):
    return channel_mix_decode(p, x, _shift(x))


def channel_mix_decode(p, x, x_prev):
    """Channel-mix with an explicit token shift: ``x_prev`` holds the
    previous token's activations (the decode state)."""
    xk, xr = _mix(x, x_prev, p.cm_mu[0]), _mix(x, x_prev, p.cm_mu[1])
    k = torch.square(torch.relu(xk @ p.cm_k))
    return torch.sigmoid(xr @ p.cm_r) * (k @ p.cm_v)


def time_mix_decode(p, x, n_heads, state, x_prev):
    """Single-token decode. x: (B,1,D); state: (B,H,hd,hd); x_prev: (B,1,D)
    (the previous token's activations for the token-shift)."""
    b, _, d = x.shape
    hd = d // n_heads
    mu = p.mu

    def proj(i, w):
        return (_mix(x, x_prev, mu[i]) @ w).reshape(b, n_heads, hd)
    r, k, v = proj(0, p.w_r), proj(1, p.w_k), proj(2, p.w_v)
    w = _decay(p, proj(3, p.w_decay))
    g = F.silu(_mix(x, x_prev, mu[4]) @ p.w_gate)
    o, kv = _wkv_step(state, r, k, v, p.bonus_u)
    state = w[..., None] * state + kv
    out = o.reshape(b, 1, d).to(x.dtype)
    out = (out * g) @ p.w_o
    return out, state
