"""Train step: bf16 compute / fp32 master, grad accumulation, optional
int8 error-feedback gradient compression.

The port of ``src/repro/train/train_loop.py``. The state is
``{"params": {name: the model's own Parameter}, "opt": {"step",
"master", "m", "v"[, "ef_residual"]}}``: the parameters are the model's
live tensors, and ``make_train_step``'s step updates every tensor of the
state in place and returns the same dict. A checkpoint restore therefore
copies into these tensors (``checkpointing.checkpoint.restore``). The
loop itself lives in ``launch/train.py`` and in the supervisor.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from .optimizer import OptConfig, adamw_update, init_opt_state


def make_train_state(model, gen: torch.Generator,
                     compress_grads: bool = False) -> dict:
    """Random weights drawn from ``gen`` (a generator on the model's
    device) with the reference's initialisers: the float32 draws become
    the master copies, the parameters those draws in their stored dtype.
    Turns the model's gradients on. With ``compress_grads`` the state
    holds a zero error-feedback residual from the start, so every
    checkpoint of the run (the supervisor's step-0 one too) has the same
    leaves; the reference adds it at the first step, after which a
    restore of the step-0 checkpoint fails (``ROADMAP.md`` C)."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    master = {}
    with torch.no_grad():
        for name, value in model.draw_init(gen):
            params[name].copy_(value)
            master[name] = value
    opt = init_opt_state(master)
    if compress_grads:
        opt["ef_residual"] = _zeros_f32(master)
    return {"params": params, "opt": opt}


def _zeros_f32(tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for n, t in tree.items()}


def to_device(batch: dict[str, Any], device: torch.device
              ) -> dict[str, torch.Tensor]:
    """A host batch (numpy arrays, as the data streams give it) as
    tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _split(batch: dict[str, torch.Tensor], n: int) -> list[dict]:
    """``n`` microbatches along the batch axis; the M-RoPE positions
    (3, B, S) along their second axis."""
    parts = {}
    for k, v in batch.items():
        axis = 1 if k == "mrope_positions" else 0
        if v.shape[axis] % n:
            raise ValueError(f"{k}: batch {v.shape[axis]} does not split "
                             f"into {n} microbatches")
        parts[k] = torch.chunk(v, n, dim=axis)
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def make_train_step(model, opt_cfg: OptConfig, grad_accum: int = 1,
                    compress_grads: bool = False,
                    process_group=None) -> Callable:
    """Build ``train_step(state, batch) -> (state, metrics)``.

    grad_accum > 1 splits the batch into microbatches run serially, their
    float32 gradients averaged. compress_grads applies int8 quantization
    with error feedback to the gradients before the update (the
    reference applies it before its data-parallel all-reduce); the
    residual lives in the optimizer state as ``ef_residual``. One int8
    scale covers a parameter of all super-blocks of a segment, as the
    reference's covers its leaf stacked over them. With a
    ``process_group`` the gradients are then averaged over its ranks
    (sum, then divide by the world size: exact for one rank)."""
    groups = scale_groups(model) if compress_grads else None

    def grads_of(params):
        return {n: p.grad if p.grad is not None else torch.zeros_like(p)
                for n, p in params.items()}

    def one_micro(params, batch):
        for p in params.values():
            p.grad = None
        loss, _ = model.loss(batch)
        loss.backward()
        return loss.detach()

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        batch = to_device(batch, model.device)
        if grad_accum == 1:
            loss = one_micro(params, batch)
            grads = grads_of(params)
        else:
            grads = _zeros_f32(params)
            losses = []
            for mb in _split(batch, grad_accum):
                loss_i = one_micro(params, mb)
                with torch.no_grad():
                    for n, g in grads_of(params).items():
                        grads[n].add_(g.float() / grad_accum)
                losses.append(loss_i)
            loss = torch.stack(losses).mean()
        for p in params.values():       # no gradient outlives its step
            p.grad = None

        if compress_grads:
            opt = state["opt"]
            if "ef_residual" not in opt:
                opt["ef_residual"] = _zeros_f32(grads)
            err = opt["ef_residual"]
            with torch.no_grad():
                grads, new_err = _int8_ef_compress(
                    {n: g.float() + err[n] for n, g in grads.items()},
                    groups)
                for n, e in new_err.items():
                    err[n].copy_(e)

        if process_group is not None:
            import torch.distributed as dist
            world = dist.get_world_size(process_group)
            with torch.no_grad():
                for g in grads.values():
                    dist.all_reduce(g, group=process_group)
                    g.div_(world)

        opt_metrics = adamw_update(opt_cfg, params, grads, state["opt"])
        return state, {"loss": loss, **opt_metrics}

    return train_step


def scale_groups(model) -> list[list[str]]:
    """Parameter names that share one int8 scale: each parameter of a
    super-block with the same parameter of the segment's other
    super-blocks (the reference's stacked leaf), every other parameter
    alone."""
    groups: dict[tuple, list[str]] = {}
    for n, (si, ki, _, sb) in enumerate(model._stack()):
        for sub, _ in sb.named_parameters():
            groups.setdefault((si, ki, sub), []).append(f"layers.{n}.{sub}")
    stacked = {name for g in groups.values() for name in g}
    return [[n] for n, _ in model.named_parameters()
            if n not in stacked] + list(groups.values())


def _int8_ef_compress(grads: dict[str, torch.Tensor],
                      groups: list[list[str]]) -> tuple[dict, dict]:
    """int8 quantize/dequantize with error feedback, one scale per group
    of names: (dequantized, residual). ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    deq, err = {}, {}
    for group in groups:
        peak = torch.stack([grads[n].abs().max() for n in group]).max()
        scale = torch.clamp(peak, min=1e-12) / 127.0
        for n in group:
            g = grads[n]
            d = torch.clamp(torch.round(g / scale), -127, 127) * scale
            deq[n], err[n] = d, g - d
    return deq, err
