"""Token-choice top-k MoE with per-row sorted capacity dispatch.

The port of ``src/repro/models/moe.py``. Each batch row dispatches its own
seq*top_k assignments into (E, C) buffers with
C = ceil(seq * k / E * capacity_factor); assignments sort by expert
(stable), rank within their expert, and those ranked past C go to an
overflow bin that is dropped (the residual path keeps those tokens).
The ordering is the reference's: ``jax.lax.top_k`` puts the lower index
first on ties, so the top k come from a stable descending sort (``_top_k``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import ParamBlock, gelu, normal


class MoE(ParamBlock):
    def __init__(self, d, d_ff, n_experts, dtype, device):
        super().__init__(device)
        self.param("router", (d, n_experts), torch.float32, normal(0.02),
                   ("embed", None))
        self.param("w_gate", (n_experts, d, d_ff), dtype, normal(),
                   ("expert", "embed", "mlp"))
        self.param("w_up", (n_experts, d, d_ff), dtype, normal(),
                   ("expert", "embed", "mlp"))
        self.param("w_down", (n_experts, d_ff, d), dtype,
                   normal(1.0 / math.sqrt(d_ff)), ("expert", "mlp", "embed"))


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p, x, *, top_k: int, capacity_factor: float = 1.25,
              kind: str = "swiglu"):
    """x: (B, S, D) -> (B, S, D), aux losses dict. Per-row dispatch."""
    b, s, d = x.shape
    e = p.router.shape[1]
    nk = s * top_k
    dev = x.device

    logits = x.float() @ p.router                                # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, top_k)                          # (B,S,K)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    cap = int(math.ceil(s * top_k / e * capacity_factor))
    flat_e = top_i.reshape(b, nk)                                # (B, S*K)
    flat_t = (torch.arange(nk, device=dev) // top_k)[None].expand(b, nk)
    flat_w = top_p.reshape(b, nk)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, order)
    sorted_t = flat_t.gather(1, order)
    sorted_w = flat_w.gather(1, order)
    # rank within expert = position - first position of that expert
    pos = torch.arange(nk, device=dev)[None]
    first = torch.searchsorted(
        sorted_e, torch.arange(e, device=dev)[None].expand(b, e).contiguous())
    rank = pos - first.gather(1, sorted_e)
    keep = rank < cap
    dest = torch.where(keep, sorted_e * cap + rank, e * cap)     # overflow

    # slot -> sorted position (nk = the zero row); the overflow bin's
    # column is dropped, so its colliding writes never matter
    inv = torch.full((b, e * cap + 1), nk, dtype=torch.long, device=dev)
    inv.scatter_(1, dest, pos.expand(b, nk))
    gathered = x.gather(1, sorted_t[..., None].expand(b, nk, d))  # (B,nk,D)
    xpad = torch.cat([gathered, x.new_zeros((b, 1, d))], dim=1)
    buf = xpad.gather(1, inv[:, :-1, None].expand(b, e * cap, d))
    hidden = buf.reshape(b, e, cap, d)

    if kind == "swiglu":
        h = F.silu(torch.einsum("becd,edf->becf", hidden, p.w_gate)) * \
            torch.einsum("becd,edf->becf", hidden, p.w_up)
    else:
        h = gelu(torch.einsum("becd,edf->becf", hidden, p.w_up))
    out_buf = torch.einsum("becf,efd->becd", h, p.w_down)
    out_buf = out_buf.reshape(b, e * cap, d)
    out_buf = torch.cat([out_buf, x.new_zeros((b, 1, d))], dim=1)

    weighted = out_buf.gather(1, dest[..., None].expand(b, nk, d)) \
        * sorted_w[..., None].to(x.dtype)
    # unsort the (token, k) entries back to token-major order, then sum
    # each token's k slots
    inv_order = torch.argsort(order, dim=1)
    unsorted = weighted.gather(1, inv_order[..., None].expand(b, nk, d))
    out = unsorted.reshape(b, s, top_k, d).sum(dim=2)

    # load-balancing aux loss (Switch-style), fp32
    me = probs.mean(dim=(0, 1))                                  # (E,)
    ce = torch.zeros((e,), device=dev).index_add_(
        0, flat_e.reshape(-1), torch.ones((b * nk,), device=dev)) / (b * nk)
    aux = {"load_balance": e * torch.sum(me * ce),
           "router_z": torch.mean(torch.logsumexp(logits, -1) ** 2)}
    return out, aux
