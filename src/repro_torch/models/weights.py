"""Carry the JAX package's parameter tree into the port's modules.

``params_from_reference(model, tree)`` loads the tree that the reference's
``Model.init`` returns, given as numpy arrays (``jax.tree.map(np.asarray,
params)``), into a :class:`~repro_torch.models.transformer.Model` of the
same config. The reference initialises each segment's super-blocks with
one ``vmap``, so every leaf under ``segments`` carries a leading axis of
the segment's ``n``; the converter takes row ``i`` for the ``i``-th
super-block. Each value is cast to the dtype its parameter is stored in
(the compute dtype for weights the reference casts at every use).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .transformer import Model


def _copy(param: torch.Tensor, value: np.ndarray, where: str) -> None:
    value = np.asarray(value)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{where}: reference shape {value.shape}, port "
                         f"shape {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(value)))


def _load_block(module: torch.nn.Module, tree: Mapping[str, Any], index: int,
                where: str, loaded: set) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _load_block(getattr(module, key), value, index, f"{where}.{key}",
                        loaded)
        else:
            param = getattr(module, key)
            _copy(param, np.asarray(value)[index], f"{where}.{key}")
            loaded.add(id(param))


def params_from_reference(model: Model, tree: Mapping[str, Any]) -> Model:
    """Load the reference's parameter tree into ``model``; every parameter
    of the model must be set exactly once. Returns the model."""
    loaded: set = set()
    _copy(model.embed.table, tree["embed"]["table"], "embed.table")
    loaded.add(id(model.embed.table))
    for si, ki, i, sb in model._stack():
        _load_block(sb, tree["segments"][si][ki], i,
                    f"segments[{si}][{ki}][{i}]", loaded)
    _copy(model.final_ln.scale, tree["final_ln"]["scale"], "final_ln.scale")
    loaded.add(id(model.final_ln.scale))
    if model.lm_head is not None:
        _copy(model.lm_head, tree["lm_head"], "lm_head")
        loaded.add(id(model.lm_head))
    missing = [n for n, p in model.named_parameters() if id(p) not in loaded]
    if missing:
        raise ValueError(f"parameters not in the reference tree: {missing}")
    return model
