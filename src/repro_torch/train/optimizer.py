"""AdamW + gradient clipping + schedules, written out (no torch.optim).

The port of ``src/repro/train/optimizer.py``. Mixed precision: the
model's parameters are stored in the dtype their uses read (bf16 for the
layers' weights), and the optimizer holds float32 master copies and
moments; after each update a parameter is its master cast to its stored
dtype. The state is a plain dict of tensors keyed like
``model.named_parameters()``, so checkpointing stays a walk over it.

Every update happens in place, on the step's device, with the
reference's float32 arithmetic in its order (bias corrections
``1 - b ** step``, the clip scale ``min(1, clip / (norm + 1e-9))``, decay
on tensors of two or more dimensions only, ``master - lr * delta``).
``torch.optim.AdamW`` decays before the moment update and keeps no master
copies, so it gives another result.
"""
from __future__ import annotations

import dataclasses
import math

import torch

Tree = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac; ``step`` an integer
    tensor, the result float32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_opt_state(master: Tree) -> dict:
    """Step 0, the given float32 master copies and zero moments. The
    master copies are the unrounded float32 values (the initial draws,
    or a carried state's), never the stored bf16 parameters."""
    dev = next(iter(master.values())).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "master": master,
        "m": {n: torch.zeros_like(t) for n, t in master.items()},
        "v": {n: torch.zeros_like(t) for n, t in master.items()},
    }


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in tree.values()))


def _decay_mask(leaf: torch.Tensor) -> bool:
    """No weight decay on norms/biases/1-d tensors."""
    return leaf.ndim >= 2


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: Tree, grads: Tree, state: dict
                 ) -> dict[str, torch.Tensor]:
    """One AdamW step in place: ``state``'s step, moments and masters,
    then each parameter set to its master in its stored dtype. Returns
    the metrics ``grad_norm`` and ``lr`` (0-dim tensors)."""
    step = state["step"]
    step += 1
    gnorm = global_norm(grads)
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                        / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.betas
    one = torch.ones((), dtype=torch.float32, device=step.device)
    bc1 = 1.0 - torch.pow(one * b1, step.float())
    bc2 = 1.0 - torch.pow(one * b2, step.float())
    for name, g in grads.items():
        m, v, master = state["m"][name], state["v"][name], \
            state["master"][name]
        g = g.float() * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if _decay_mask(master):
            delta = delta + master * cfg.weight_decay
        master.sub_(lr * delta)
        params[name].copy_(master)
    return {"grad_norm": gnorm, "lr": lr}
