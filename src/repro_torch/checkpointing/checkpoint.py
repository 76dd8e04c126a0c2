"""Sharded checkpointing: npz shards + a JSON index.

The port of ``src/repro/checkpointing/checkpoint.py``. Layout:

    <dir>/step_<N>/
        index.json        — leaf paths, shapes, dtypes, shard map
        shard_<k>.npz     — flat arrays, chunked ~512MB per file
        data_state.json   — data-pipeline snapshot
    <dir>/LATEST          — atomic pointer (write temp + rename)

Differences from the reference's format (the port does not read the
reference's checkpoints): the index and the data state are JSON, not
msgpack; numpy has no bfloat16, so a bf16 leaf is stored as its uint16
bits with ``"bfloat16"`` as its dtype in the index.

  * async save: ``save`` copies every leaf to the host before it returns
    (a fresh copy, also on the CPU, where ``.cpu()`` would share the
    training state's storage), then writes on a worker thread while
    training goes on — the step updates the state in place, so a later
    step cannot reach the snapshot;
  * restore writes into the live tensors of ``template`` (``copy_``): a
    train step closes over the model's parameters and the optimizer's
    tensors. ``shard_fn(path, host_tensor)`` is applied to each leaf
    before the copy (the reference's elastic re-mesh hook).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable

import numpy as np
import torch

_SHARD_BYTES = 512 << 20


def _flatten_with_paths(tree: Any, prefix: str = ""
                        ) -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) for every leaf of nested dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"{prefix or 'state'}: {type(tree).__name__} is "
                        f"not a tensor, dict or list")
    out = []
    for k, v in items:
        out += _flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy that shares no storage with ``t``."""
    h = t.detach().to("cpu", copy=True)
    if h.dtype == torch.bfloat16:
        h = h.view(torch.uint16)
    return h.numpy()


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t.view(torch.bfloat16) if dtype_name == "bfloat16" else t


class _Writer(threading.Thread):
    """The async writer: ``join`` re-raises what the write raised."""

    def __init__(self, write: Callable[[], None]):
        super().__init__(daemon=True)
        self._write, self._error = write, None

    def run(self) -> None:
        try:
            self._write()
        except BaseException as e:     # handed to the joining thread
            self._error = e

    def join(self, timeout: float | None = None) -> None:
        super().join(timeout)
        if self._error is not None:
            raise self._error


def save(ckpt_dir: str, step: int, state: Any,
         data_state: dict | None = None, asynchronous: bool = False
         ) -> threading.Thread | None:
    """Write a checkpoint; returns the writer thread if asynchronous. The
    host snapshot is taken before this returns either way."""
    leaves = _flatten_with_paths(state)
    paths = [p for p, _ in leaves]
    dtypes = [_dtype_name(t.dtype) for _, t in leaves]
    host = [_to_host(t) for _, t in leaves]       # device -> host copy now

    def write():
        d = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(d, exist_ok=True)
        index = {"paths": paths, "step": step, "shards": [],
                 "dtypes": dtypes, "shapes": [list(a.shape) for a in host]}
        shard, size, k = {}, 0, 0
        for name, arr in zip(paths, host):
            shard[name] = arr
            size += arr.nbytes
            if size >= _SHARD_BYTES:
                np.savez(os.path.join(d, f"shard_{k}.npz"), **shard)
                index["shards"].append({"file": f"shard_{k}.npz",
                                        "keys": list(shard)})
                shard, size, k = {}, 0, k + 1
        if shard:
            np.savez(os.path.join(d, f"shard_{k}.npz"), **shard)
            index["shards"].append({"file": f"shard_{k}.npz",
                                    "keys": list(shard)})
        with open(os.path.join(d, "index.json"), "w") as f:
            json.dump(index, f)
        if data_state is not None:
            with open(os.path.join(d, "data_state.json"), "w") as f:
                json.dump(data_state, f)
        tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, os.path.join(ckpt_dir, "LATEST"))

    if asynchronous:
        t = _Writer(write)
        t.start()
        return t
    write()
    return None


def latest_step(ckpt_dir: str) -> int | None:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


@torch.no_grad()
def restore(ckpt_dir: str, template: Any, step: int | None = None,
            shard_fn: Callable[[str, torch.Tensor], Any] | None = None
            ) -> tuple[Any, dict | None, int]:
    """Restore into the tensors of ``template``, in place; returns
    (template, data state, step).

    shard_fn(path, host_tensor) -> tensor lets the caller place each leaf
    (a CPU tensor in the leaf's dtype) before it is copied in."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)
    dtype_of = dict(zip(index["paths"], index["dtypes"]))
    arrays: dict[str, np.ndarray] = {}
    for sh in index["shards"]:
        with np.load(os.path.join(d, sh["file"])) as z:
            for kk in sh["keys"]:
                arrays[kk] = z[kk]
    leaves = _flatten_with_paths(template)
    for p_, leaf in leaves:
        if p_ not in arrays:
            raise KeyError(f"checkpoint missing leaf {p_}")
        a = arrays[p_]
        if list(a.shape) != list(leaf.shape):
            raise ValueError(f"{p_}: shape {a.shape} != {tuple(leaf.shape)}")
    for p_, leaf in leaves:
        h = _from_host(arrays[p_], dtype_of[p_]).to(leaf.dtype)
        leaf.copy_(shard_fn(p_, h) if shard_fn else h)
    ds_path = os.path.join(d, "data_state.json")
    data_state = None
    if os.path.exists(ds_path):
        with open(ds_path) as f:
            data_state = json.load(f)
    return template, data_state, step
