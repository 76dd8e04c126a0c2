"""Logical-axis sharding rules (MaxText-style), resolved on a mesh.

The port of ``src/repro/distributed/sharding.py``. The rules and the
specs are the reference's; a spec is the port's own
:class:`PartitionSpec`, a tuple of mesh-axis names (a name, a tuple of
names, or None) per dimension. The port runs on one card, so a spec is a
statement of layout: on the card's (1, 1) mesh every spec means
replicated, and on the reference's logical (16, 16) and (2, 16, 16)
meshes it says how a production deployment would split the leaf — the
dry run divides each leaf's bytes by the mesh axes its spec names.

The port keeps each super-block's parameters as tensors of their own
where the reference stacks them, so a port spec is the reference's with
the stack dim removed. Parameter and state trees are keyed by parameter
name (``Model.named_parameters``); the decode caches keep the
reference's stacked (n, B, ...) layout (``Model.decode_init``).

Parameter rules (FSDP + TP):
  vocab      -> 'model'   (vocab-parallel embedding / lm head)
  embed      -> 'data'    (FSDP: d_model dim sharded over the DP axis)
  heads      -> 'model'   (Megatron head-parallel attention)
  kv_heads   -> 'model' when n_kv % tp == 0 else replicated
  mlp        -> 'model'   (Megatron column/row parallel FFN)
  expert     -> 'model' when n_experts % tp == 0 (EP) else None
  heads_flat -> 'model'   (RWKV fused d->d projections)

Activation rules:
  batch      -> ('pod','data'); sequence over 'model' (context
  parallelism) for decode caches whose kv heads cannot use 'model', and
  over ('data','model') for the batch=1 long-context cells.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import Model


class PartitionSpec(tuple):
    """One entry per dimension: a mesh-axis name, a tuple of names, or
    None (not split). A tuple of one name is that name and an empty one
    None, as jax normalises its ``PartitionSpec``."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, tuple) and len(p) <= 1:
                return p[0] if p else None
            return p
        return super().__new__(cls, (norm(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf lives: its spec on the mesh, and the mesh's device,
    which holds every shard (the reference's ``NamedSharding``)."""
    mesh: Mesh
    spec: PartitionSpec

    @property
    def device(self) -> torch.device:
        return self.mesh.device


def axes_size(mesh: Mesh, axes) -> int:
    """The product of the mesh sizes of ``axes`` (a name, a tuple of
    names, or None)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def _tp(mesh: Mesh) -> int:
    return mesh.shape["model"]


def dp_axes(mesh: Mesh):
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def rules_for(cfg: ModelConfig, mesh: Mesh, fsdp: bool = True,
              moe_tp: bool = False) -> dict:
    tp = _tp(mesh)
    return {
        "vocab": "model",
        "embed": "data" if fsdp else None,
        "heads": "model" if cfg.n_heads % tp == 0 else None,
        "kv_heads": "model" if cfg.n_kv_heads % tp == 0 else None,
        "head_dim": None,
        "mlp": "model" if cfg.d_ff % tp == 0 else None,
        # moe_tp: replicate experts, shard inside them (d_ff over 'model')
        "expert": ("model" if (cfg.n_experts and cfg.n_experts % tp == 0
                               and not moe_tp) else None),
        "heads_flat": "model" if cfg.d_model % tp == 0 else None,
        None: None,
    }


def param_specs(model: Model, params_shape: dict[str, torch.Tensor],
                mesh: Mesh, fsdp: bool = True, moe_tp: bool = False
                ) -> dict[str, PartitionSpec]:
    """name -> spec for every tensor of ``params_shape`` (keyed like
    ``model.named_parameters()``; meta tensors do): each dim mapped
    through the logical-axis rules."""
    rules = rules_for(model.cfg, mesh, fsdp, moe_tp)
    axes = model.logical_axes()

    def leaf_spec(leaf, ax):
        rank = len(leaf.shape)
        ax = tuple(ax)
        prefix = (None,) * (rank - len(ax))
        mapped = tuple(rules.get(a) for a in ax)
        # drop shard axes that do not divide the dim, and deduplicate mesh
        # axes (e.g. EP puts 'model' on the expert dim — the mlp dim must
        # then stay unsharded)
        out, used = [], set()
        for dim, m in zip(leaf.shape[rank - len(ax):], mapped):
            if m is not None and (dim % mesh.shape[m] != 0 or m in used):
                m = None
            if m is not None:
                used.add(m)
            out.append(m)
        return P(*(prefix + tuple(out)))

    return {name: leaf_spec(leaf, axes[name])
            for name, leaf in params_shape.items()}


def state_specs(model: Model, state_shape: dict, mesh: Mesh,
                fsdp: bool = True, moe_tp: bool = False) -> dict:
    """Specs for the train state ``{"params", "opt": {"step", "master",
    "m", "v"[, "ef_residual"]}}`` (``train.make_train_state``)."""
    pspec = param_specs(model, state_shape["params"], mesh, fsdp, moe_tp)
    opt = {"step": P(), "master": pspec, "m": pspec, "v": pspec}
    if "ef_residual" in state_shape["opt"]:
        opt["ef_residual"] = pspec
    return {"params": pspec, "opt": opt}


def batch_specs(batch_shape: dict[str, torch.Tensor], mesh: Mesh
                ) -> dict[str, PartitionSpec]:
    dp = dp_axes(mesh)

    def spec(leaf):
        rank = len(leaf.shape)
        if rank == 0:
            return P()
        b = leaf.shape[0]
        if b == 3 and rank == 3:   # mrope positions (3, B, S)
            return P(None, dp, *([None] * (rank - 2)))
        if b % axes_size(mesh, dp) == 0:
            return P(dp, *([None] * (rank - 1)))
        return P(*([None] * rank))
    return {k: spec(v) for k, v in batch_shape.items()}


def cache_specs(model: Model, cache_shape: list, mesh: Mesh) -> list:
    """Decode-cache sharding, in ``decode_init``'s layout: batch over DP
    when divisible; the cache sequence dim over 'model' when kv heads
    can't use it (context parallel); for batch=1 long-context also over
    'data'."""
    cfg = model.cfg
    tp = _tp(mesh)
    dp = dp_axes(mesh)
    dp_size = axes_size(mesh, dp)
    kv_on_model = cfg.n_kv_heads % tp == 0

    def spec(name, leaf):
        shape = leaf.shape
        rank = len(shape)
        if rank < 2:
            return P(*([None] * rank))
        b = shape[1]  # (n_layers, B, ...)
        batch_ax = dp if (b % dp_size == 0 and b >= dp_size) else None
        if name in ("k", "v") and rank == 5:  # attn cache (n,B,S,kv,hd)
            if kv_on_model:
                return P(None, batch_ax, None, "model", None)
            s = shape[2]
            if batch_ax is None and s % (dp_size * tp) == 0:
                seq_ax = ("data", "model")   # long-context batch=1
            elif s % tp == 0:
                seq_ax = "model"             # context parallel
            else:
                seq_ax = None
            return P(None, batch_ax, seq_ax, None, None)
        # recurrent states (rwkv s/tm_prev/cm_prev, rglru h/conv): batch only
        return P(None, batch_ax, *([None] * (rank - 2)))

    return [[{name: spec(name, leaf) for name, leaf in sub.items()}
             for sub in seg] for seg in cache_shape]


def shard_leaf(mesh: Mesh, spec: PartitionSpec) -> Placement:
    """The leaf's placement: its spec on ``mesh``, every shard on the
    mesh's device."""
    return Placement(mesh, P(*spec))


def per_device_bytes(leaf: torch.Tensor, spec: PartitionSpec,
                     mesh: Mesh) -> int:
    """Bytes of one device's shard of ``leaf`` under ``spec``: the leaf's
    bytes over the mesh sizes of the axes its spec names (the specs only
    name axes that divide their dim)."""
    n = leaf.numel() * leaf.element_size()
    return n // math.prod(axes_size(mesh, a) for a in spec)
