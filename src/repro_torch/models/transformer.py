"""Generic LM assembler covering the full architecture zoo.

The port of ``src/repro/models/transformer.py``. A model is a sequence of
*segments*, each a stack of identical super-blocks (``plan_segments``, the
reference's planner): gemma3's 5 local : 1 global and recurrentgemma's
rec,rec,attn become super-blocks whose sub-layers keep a static kind. The
reference scans each stack; here the sub-blocks are one flat
``nn.ModuleList`` in layer order, and the decode caches keep the
reference's layout (per segment, per sub-layer kind, a leading axis of the
segment's ``n``) so that a slot's rows are one view of every tensor.
Training (``loss``) checkpoints one super-block at a time under
``cfg.remat``, as the reference's ``jax.checkpoint`` of its scan body
does, and computes the cross-entropy in checkpointed sequence chunks.

Families:
  dense / moe / encoder / vlm -> attention super-blocks (+ MoE FFN)
  ssm (rwkv6)                 -> time-mix/channel-mix blocks
  hybrid (recurrentgemma)     -> RG-LRU blocks + local-attention blocks
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device

from . import layers as L
from . import moe as M
from . import rglru as R
from . import rwkv6 as W
from .common import ModelConfig


@dataclasses.dataclass(frozen=True)
class Segment:
    n: int                      # number of super-blocks (scan length)
    kinds: tuple[str, ...]      # sub-layer kinds within one super-block:
                                # 'G' global attn, 'L' local attn, 'R' rglru,
                                # 'W' rwkv
    def __post_init__(self):
        assert self.n >= 1 and len(self.kinds) >= 1


def plan_segments(cfg: ModelConfig) -> list[Segment]:
    """Factor the per-layer kind sequence into scan-able segments."""
    if cfg.family == "ssm":
        kinds = ["W"] * cfg.n_layers
    elif cfg.family == "hybrid":
        kinds = ["R" if k == "rec" else "L" for k in cfg.block_kinds()]
    else:
        kinds = cfg.layer_kinds()
    # greedy: find smallest repeating unit, scan over repeats, unroll rest
    segs: list[Segment] = []
    i = 0
    n = len(kinds)
    while i < n:
        best = (1, 1)  # (unit_len, repeats)
        for unit in range(1, min(8, n - i) + 1):
            reps = 1
            while i + unit * (reps + 1) <= n and \
                    kinds[i + unit * reps: i + unit * (reps + 1)] == \
                    kinds[i:i + unit]:
                reps += 1
            if unit * reps > best[0] * best[1] or \
                    (unit * reps == best[0] * best[1] and unit < best[0]):
                best = (unit, reps)
        unit, reps = best
        segs.append(Segment(n=reps, kinds=tuple(kinds[i:i + unit])))
        i += unit * reps
    return segs


# ------------------------------------------------------------- sub-layers
class SubBlock(nn.Module):
    """One sub-layer's parameters, named as the reference's dict."""

    def __init__(self, cfg: ModelConfig, kind: str, device):
        super().__init__()
        self.kind = kind
        dt = cfg.compute_dtype
        d = cfg.d_model
        if kind in ("G", "L"):
            self.ln1 = L.RMSNorm(d, device)
            self.attn = L.Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                    cfg.qkv_bias, cfg.rope_theta, dt, device)
            self.ln2 = L.RMSNorm(d, device)
            if cfg.n_experts:
                self.moe = M.MoE(d, cfg.d_ff, cfg.n_experts, dt, device)
            else:
                self.mlp = L.MLP(d, cfg.d_ff, cfg.mlp, dt, device)
        elif kind == "R":
            self.ln1 = L.RMSNorm(d, device)
            self.rec = R.RGLRU(d, cfg.lru_width or d, cfg.conv1d_width, dt,
                               device)
            self.ln2 = L.RMSNorm(d, device)
            self.mlp = L.MLP(d, cfg.d_ff, cfg.mlp, dt, device)
        elif kind == "W":
            self.ln1 = L.RMSNorm(d, device)
            self.ln2 = L.RMSNorm(d, device)
            self.rwkv = W.RWKV6(d, cfg.n_heads, cfg.d_ff, dt, device)
        else:
            raise ValueError(kind)


def _subblock_apply(p, cfg: ModelConfig, kind: str, x, positions,
                    mrope_positions=None):
    """Full-sequence application. Returns (x, aux)."""
    aux = {}
    if kind in ("G", "L"):
        h = L.rmsnorm(p.ln1, x)
        h = L.gqa_attention(
            p.attn, h, positions, causal=cfg.causal,
            window=(cfg.window if kind == "L" else 0),
            mrope_positions=mrope_positions)
        x = x + h
        h = L.rmsnorm(p.ln2, x)
        if cfg.n_experts:
            h, aux = M.moe_apply(p.moe, h, top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor,
                                 kind=cfg.mlp)
        else:
            h = L.mlp(p.mlp, h, cfg.mlp)
        x = x + h
    elif kind == "R":
        h = L.rmsnorm(p.ln1, x)
        h, _ = R.rglru_block(p.rec, h)
        x = x + h
        h = L.rmsnorm(p.ln2, x)
        x = x + L.mlp(p.mlp, h, cfg.mlp)
    elif kind == "W":
        h, _ = W.time_mix(p.rwkv, L.rmsnorm(p.ln1, x), cfg.n_heads)
        x = x + h
        x = x + W.channel_mix(p.rwkv, L.rmsnorm(p.ln2, x))
    return x, aux


# ------------------------------------------------------------ decode state
def _subblock_cache_init(cfg: ModelConfig, kind: str, n: int, b: int,
                         max_len: int, dtype, device):
    """Decode state of ``n`` stacked sub-layers of one kind (the
    kv_planner sizes the rings)."""
    def z(*shape, dt=dtype):
        return torch.zeros((n, b) + shape, dtype=dt, device=device)
    if kind == "G":
        return {"k": z(max_len, cfg.n_kv_heads, cfg.hd),
                "v": z(max_len, cfg.n_kv_heads, cfg.hd)}
    if kind == "L":
        ring = min(cfg.window, max_len)
        return {"k": z(ring, cfg.n_kv_heads, cfg.hd),
                "v": z(ring, cfg.n_kv_heads, cfg.hd)}
    if kind == "R":
        w = cfg.lru_width or cfg.d_model
        return {"h": z(w, dt=torch.float32),
                "conv": z(cfg.conv1d_width - 1, w)}
    if kind == "W":
        hd = cfg.d_model // cfg.n_heads
        return {"s": z(cfg.n_heads, hd, hd, dt=torch.float32),
                "tm_prev": z(1, cfg.d_model),
                "cm_prev": z(1, cfg.d_model)}
    raise ValueError(kind)


def _subblock_decode(p, cfg: ModelConfig, kind: str, x, cache, pos):
    """One token through one sub-layer; ``cache`` (this layer's views) is
    updated in place."""
    if kind in ("G", "L"):
        h = L.rmsnorm(p.ln1, x)
        h, _, _ = L.gqa_decode_step(
            p.attn, h, cache["k"], cache["v"], pos,
            window=(cfg.window if kind == "L" else 0))
        x = x + h
        h = L.rmsnorm(p.ln2, x)
        if cfg.n_experts:
            h, _ = M.moe_apply(p.moe, h, top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor,
                               kind=cfg.mlp)
        else:
            h = L.mlp(p.mlp, h, cfg.mlp)
        x = x + h
    elif kind == "R":
        h = L.rmsnorm(p.ln1, x)
        h, hs, conv = R.rglru_decode(p.rec, h, cache["h"], cache["conv"])
        cache["h"].copy_(hs)
        cache["conv"].copy_(conv)
        x = x + h
        h = L.rmsnorm(p.ln2, x)
        x = x + L.mlp(p.mlp, h, cfg.mlp)
    elif kind == "W":
        h_in = L.rmsnorm(p.ln1, x)
        h, s = W.time_mix_decode(p.rwkv, h_in, cfg.n_heads, cache["s"],
                                 cache["tm_prev"])
        x = x + h
        c_in = L.rmsnorm(p.ln2, x)
        x = x + W.channel_mix_decode(p.rwkv, c_in, cache["cm_prev"])
        cache["s"].copy_(s)
        cache["tm_prev"].copy_(h_in)
        cache["cm_prev"].copy_(c_in)
    return x


# ------------------------------------------------------------------ model
Caches = list  # [segment][sub-layer kind] -> {name: (n, B, ...) tensor}


class Model(nn.Module):
    """forward / decode for one ModelConfig, parameters on ``device``.

    ``device`` defaults to the card; ``"cpu"`` runs on the CPU and
    ``"meta"`` builds shapes only (parameter counts of configs too large
    to allocate). The parameters are uninitialised until :meth:`init_`
    or ``models.weights.params_from_reference`` fills them."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        dev = torch.device(device)
        self.device = dev if dev.type == "meta" else resolve_device(dev)
        self.cfg = cfg
        self.segments = plan_segments(cfg)
        self.embed = L.Embed(cfg.vocab, cfg.d_model, self.device)
        self.layers = nn.ModuleList(
            SubBlock(cfg, kind, self.device)
            for seg in self.segments for _ in range(seg.n)
            for kind in seg.kinds)
        self.final_ln = L.RMSNorm(cfg.d_model, self.device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(
                (cfg.d_model, cfg.vocab), device=self.device),
                requires_grad=False)
        else:
            self.lm_head = None
        self._embed_scale = L.weak(math.sqrt(cfg.d_model),
                                   cfg.compute_dtype)

    def draw_init(self, gen: torch.Generator):
        """(parameter name, float32 value) for every parameter, drawn from
        ``gen`` with the reference's initialisers, one at a time. The
        values are the unrounded float32 draws: the training state keeps
        them as its master copies."""
        for prefix, m in self.named_modules():
            if isinstance(m, L.ParamBlock):
                for name, value in m.draws(gen):
                    yield f"{prefix}.{name}", value
        if self.lm_head is not None:
            yield "lm_head", L.normal(1.0 / math.sqrt(self.cfg.d_model))(
                tuple(self.lm_head.shape), gen, self.device)

    def logical_axes(self) -> dict[str, tuple[str | None, ...]]:
        """Trailing-dim logical axes of every parameter, keyed by its
        name: the reference's ``Model.logical_axes`` with the stack dim
        of its super-block leaves removed (the port keeps each
        super-block's parameters as tensors of their own)."""
        ax = {}
        for prefix, m in self.named_modules():
            if isinstance(m, L.ParamBlock):
                for name, axes in m.axes.items():
                    ax[f"{prefix}.{name}"] = axes
        if self.lm_head is not None:
            ax["lm_head"] = ("embed", "vocab")
        return ax

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "Model":
        """Random weights with the reference's initialisers, drawn from
        ``gen`` (a generator on the model's device)."""
        for name, value in self.draw_init(gen):
            self.get_parameter(name).copy_(value)
        return self

    def _stack(self):
        """(segment, sub-block index in the super-block, depth index,
        module) in layer order."""
        it = iter(self.layers)
        for si, seg in enumerate(self.segments):
            for i in range(seg.n):
                for ki in range(len(seg.kinds)):
                    yield si, ki, i, next(it)

    # ------------------------------------------------------------- forward
    def _embed_inputs(self, batch):
        cfg = self.cfg
        dt = cfg.compute_dtype
        if cfg.frontend_stub and cfg.family == "encoder":
            x = batch["frame_embeds"].to(dt)
        else:
            x = L.embed(self.embed, batch["tokens"], dt)
            x = x * self._embed_scale
            if cfg.family == "vlm" and "vision_embeds" in batch:
                nv = batch["vision_embeds"].shape[1]
                x[:, :nv] = batch["vision_embeds"].to(dt)
        b, s = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        mrope = batch.get("mrope_positions") if cfg.mrope else None
        return x, positions, mrope

    def _superblock(self, blocks, x, positions, mrope):
        """One scan step of the reference: the sub-blocks of one
        super-block. Returns (x, its aux loss)."""
        a = torch.zeros((), device=x.device)
        for sb in blocks:
            x, aux = _subblock_apply(sb, self.cfg, sb.kind, x, positions,
                                     mrope)
            if aux:
                a = a + aux["load_balance"] + 1e-3 * aux["router_z"]
        return x, a

    def _hidden(self, batch):
        """Run the layer stack; return (final hidden states, aux loss).
        Under ``cfg.remat`` and autograd, each super-block is
        checkpointed: its activations are recomputed in the backward."""
        x, positions, mrope = self._embed_inputs(batch)
        aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self.cfg.remat and torch.is_grad_enabled()
        layers = iter(self.layers)
        for seg in self.segments:
            auxs = []
            for _ in range(seg.n):
                blocks = [next(layers) for _ in seg.kinds]
                if remat:
                    x, a = checkpoint(self._superblock, blocks, x, positions,
                                      mrope, use_reentrant=False)
                else:
                    x, a = self._superblock(blocks, x, positions, mrope)
                auxs.append(a)
            aux_acc = aux_acc + torch.stack(auxs).sum()
        x = L.rmsnorm(self.final_ln, x)
        return x, aux_acc

    @torch.no_grad()
    def forward(self, batch: dict[str, torch.Tensor]):
        """batch: ``tokens`` (B, S) (or ``frame_embeds`` (B, S, D) for the
        encoder), optional ``positions``, ``vision_embeds`` and
        ``mrope_positions`` (3, B, S) -> (logits (B, S, V) fp32, aux)."""
        x, aux_acc = self._hidden(batch)
        logits = L.unembed(self.embed, x.float(), self.lm_head)
        return logits, aux_acc

    # sequence-chunk size for the cross-entropy when S*V is large: one
    # (B, 512, V) float32 logits tensor is live at a time (0.54 GB a batch
    # row at gemma3's 262,144 vocab) instead of (B, S, V)
    LOSS_CHUNK = 512

    def _nll(self, x, labels):
        logits = L.unembed(self.embed, x.float(), self.lm_head)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[..., None].long())[..., 0]
        return logz - gold

    def _ce_from_hidden(self, x, labels):
        """Per-token negative log-likelihood (B, S): unembed + logsumexp
        one checkpointed sequence chunk at a time when S > 2 * LOSS_CHUNK
        and divides by it, else directly."""
        s = x.shape[1]
        chunk = self.LOSS_CHUNK
        if s <= 2 * chunk or s % chunk:
            return self._nll(x, labels)
        nll = self._nll
        if torch.is_grad_enabled():
            nll = functools.partial(checkpoint, self._nll,
                                    use_reentrant=False)
        return torch.cat([nll(x[:, c:c + chunk], labels[:, c:c + chunk])
                          for c in range(0, s, chunk)], dim=1)

    def loss(self, batch: dict[str, torch.Tensor]):
        """Mean next-token cross-entropy over ``batch["labels"]`` (B, S),
        weighted by an optional ``loss_mask`` (B, S), plus 0.01 x the MoE
        aux loss -> (loss, {"nll", "aux"}). Differentiable: the training
        step calls ``backward`` on it."""
        x, aux = self._hidden(batch)
        nll = self._ce_from_hidden(x, batch["labels"])
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = mask.to(nll.dtype)
            nll = nll * mask
            denom = mask.sum().clamp_min(1.0)
        else:
            denom = float(nll.numel())
        mean = nll.sum() / denom
        return mean + 0.01 * aux, {"nll": mean.detach(), "aux": aux.detach()}

    # -------------------------------------------------------------- decode
    def decode_init(self, b: int, max_len: int, device=None) -> Caches:
        """Zero decode caches for ``b`` rows of ``max_len`` positions on
        ``device`` (the model's unless given; ``"meta"`` for shapes
        only)."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        return [[_subblock_cache_init(cfg, kind, seg.n, b, max_len,
                                      cfg.compute_dtype, dev)
                 for kind in seg.kinds] for seg in self.segments]

    @torch.no_grad()
    def decode_step(self, caches: Caches, tokens, pos):
        """tokens: (B,), pos: (B,) -> (logits (B, V), caches). The caches
        are updated in place and returned."""
        cfg = self.cfg
        x = L.embed(self.embed, tokens[:, None], cfg.compute_dtype)
        x = x * self._embed_scale
        for si, ki, i, sb in self._stack():
            cache = {k: v[i] for k, v in caches[si][ki].items()}
            x = _subblock_decode(sb, cfg, sb.kind, x, cache, pos)
        x = L.rmsnorm(self.final_ln, x)
        logits = L.unembed(self.embed, x.float(), self.lm_head)
        return logits[:, 0], caches

    # --------------------------------------------------------------- stats
    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def active_param_count(self) -> int:
        """MoE: only top_k of n_experts count as active. As the reference
        counts it, every MoE leaf (the router too) is scaled."""
        cfg = self.cfg
        total = self.param_count()
        if not cfg.n_experts:
            return total
        expert_leaves = sum(p.numel() for sb in self.layers
                            if hasattr(sb, "moe")
                            for p in sb.moe.parameters())
        # fraction of expert weights that fire per token
        frac = cfg.top_k / cfg.n_experts
        return int(total - expert_leaves * (1.0 - frac))

    def weight_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())


def slot_view(caches: Caches, slot: int) -> Caches:
    """One batch row of every cache tensor, as a batch of one (views: a
    decode step on them writes into ``caches``)."""
    return [[{k: v[:, slot:slot + 1] for k, v in sub.items()}
             for sub in seg] for seg in caches]


def build_model(cfg: ModelConfig, device="cuda",
                generator: torch.Generator | None = None) -> Model:
    """A model on ``device``, initialised from ``generator`` when given."""
    model = Model(cfg, device)
    if generator is not None:
        model.init_(generator)
    return model


__all__ = ["Caches", "Model", "Segment", "SubBlock", "build_model",
           "plan_segments", "slot_view"]
