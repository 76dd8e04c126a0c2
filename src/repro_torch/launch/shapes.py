"""Assigned input shapes x per-arch input specs (meta tensors only).

The port of ``src/repro/launch/shapes.py``. A spec is a tensor on
``torch.device("meta")``: its shape and dtype, no storage (the
reference's ``jax.ShapeDtypeStruct``). The keys, shapes and dtypes are
the reference's.

Shapes (assignment):
  train_4k     seq=4096   global_batch=256   -> train_step
  prefill_32k  seq=32768  global_batch=32    -> serve prefill (forward)
  decode_32k   seq=32768  global_batch=128   -> serve_step (1 new token,
                                               KV cache of seq_len)
  long_500k    seq=524288 global_batch=1     -> long-context decode

Skips: hubert (encoder-only) has no decode step; long_500k only runs for
sub-quadratic archs (rwkv6, recurrentgemma, gemma3 5:1 local, mixtral
SWA).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import Model

META = torch.device("meta")

SHAPES = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}

SUBQUADRATIC = {"rwkv6-1.6b", "recurrentgemma-2b", "gemma3-1b",
                "mixtral-8x22b"}


def cell_status(arch: str, shape: str) -> str:
    """'run' or a skip reason."""
    if arch == "hubert-xlarge" and shape in ("decode_32k", "long_500k"):
        return "SKIP: encoder-only, no decode step"
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return "SKIP: pure full attention at 500k (per assignment)"
    return "run"


def spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_input_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    i32 = torch.int32
    specs = {"tokens": spec((batch, seq), i32),
             "labels": spec((batch, seq), i32)}
    if cfg.family == "encoder":
        specs["frame_embeds"] = spec((batch, seq, cfg.d_model),
                                     torch.bfloat16)
    if cfg.family == "vlm":
        specs["vision_embeds"] = spec((batch, cfg.n_vision_tokens,
                                       cfg.d_model), torch.bfloat16)
        specs["mrope_positions"] = spec((3, batch, seq), i32)
    return specs


def prefill_input_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    specs = train_input_specs(cfg, batch, seq)
    specs.pop("labels")
    return specs


def decode_input_specs(model: Model, batch: int, seq: int) -> dict:
    """Specs for decode_step: tokens, pos, and the caches, built on
    ``meta`` whatever device ``model`` is on."""
    return {"tokens": spec((batch,), torch.int32),
            "pos": spec((batch,), torch.int32),
            "caches": model.decode_init(batch, seq, device=META)}
