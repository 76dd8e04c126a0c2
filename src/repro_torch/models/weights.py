"""Carry the JAX package's parameter tree into the port's modules.

``params_from_reference(model, tree)`` loads the tree that the reference's
``Model.init`` returns, given as numpy arrays (``jax.tree.map(np.asarray,
params)``), into a :class:`~repro_torch.models.transformer.Model` of the
same config. The reference initialises each segment's super-blocks with
one ``vmap``, so every leaf under ``segments`` carries a leading axis of
the segment's ``n``; the converter takes row ``i`` for the ``i``-th
super-block. Each value is cast to the dtype its parameter is stored in
(the compute dtype for weights the reference casts at every use).

``train_state_from_reference(model, state)`` does the same for the
reference's training state (``make_train_state``'s ``{"params", "opt"}``
tree): the parameters, and the optimizer's step, float32 master copies,
moments and, when present, the error-feedback residual, each parameter-
shaped tree mapped with the same rows.
"""
from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch

from .transformer import Model


def _block_items(prefix: str, tree: Mapping[str, Any], index: int):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _block_items(f"{prefix}.{key}", value, index)
        else:
            yield f"{prefix}.{key}", np.asarray(value)[index]


def reference_items(model: Model, tree: Mapping[str, Any]
                    ) -> Iterator[tuple[str, np.ndarray]]:
    """(the port's parameter name, the reference's value) for every leaf
    of a parameter-shaped reference tree, super-block rows taken apart."""
    yield "embed.table", np.asarray(tree["embed"]["table"])
    for n, (si, ki, i, _) in enumerate(model._stack()):
        yield from _block_items(f"layers.{n}", tree["segments"][si][ki], i)
    yield "final_ln.scale", np.asarray(tree["final_ln"]["scale"])
    if model.lm_head is not None:
        yield "lm_head", np.asarray(tree["lm_head"])


def _load(targets: Mapping[str, torch.Tensor], model: Model,
          tree: Mapping[str, Any], what: str) -> None:
    """Copy every leaf of ``tree`` into ``targets`` (keyed like the
    model's parameters); each target must be set exactly once."""
    loaded = set()
    for name, value in reference_items(model, tree):
        if name not in targets:
            raise ValueError(f"{what}: {name} is not a parameter of the "
                             f"port's model")
        t = targets[name]
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"{what}: {name}: reference shape "
                             f"{value.shape}, port shape {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.array(value)))
        loaded.add(name)
    missing = [n for n in targets if n not in loaded]
    if missing:
        raise ValueError(f"{what}: parameters not in the reference tree: "
                         f"{missing}")


def params_from_reference(model: Model, tree: Mapping[str, Any]) -> Model:
    """Load the reference's parameter tree into ``model``; every parameter
    of the model must be set exactly once. Returns the model."""
    _load(dict(model.named_parameters()), model, tree, "params")
    return model


def train_state_from_reference(model: Model, state: Mapping[str, Any]
                               ) -> dict:
    """The port's training state (``train.make_train_state``'s layout) of
    the reference's ``{"params", "opt": {"step", "master", "m", "v"[,
    "ef_residual"]}}`` tree, given as numpy arrays: the parameters are
    loaded into ``model`` (gradients on), the optimizer's tensors are new
    float32 tensors on the model's device."""
    from repro_torch.train.optimizer import init_opt_state
    params_from_reference(model, state["params"])
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt_ref = state["opt"]

    def fp32_like():
        return {n: torch.empty(p.shape, dtype=torch.float32,
                               device=p.device) for n, p in params.items()}
    opt = init_opt_state(fp32_like())
    for key in ("master", "m", "v", "ef_residual"):
        if key in opt_ref:
            opt.setdefault(key, fp32_like())
            _load(opt[key], model, opt_ref[key], key)
    opt["step"].fill_(int(np.asarray(opt_ref["step"])))
    return {"params": params, "opt": opt}
