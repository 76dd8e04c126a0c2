"""Model configuration and registry shared across the architecture zoo."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"         # swiglu | geglu | gelu
    rope_theta: float = 1e4
    tie_embeddings: bool = True
    causal: bool = True
    # attention pattern
    window: int = 0             # sliding-window size; 0 = full attention
    layer_pattern: str = ""     # e.g. "LLLLLG" repeated; "" = uniform
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # recurrent families
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec","rec","attn")
    lru_width: int = 0
    conv1d_width: int = 4
    # multimodal
    mrope: bool = False
    n_vision_tokens: int = 0
    frontend_stub: bool = False  # input_specs provides embeddings directly
    # numerics
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def layer_kinds(self) -> list[str]:
        """Per-layer attention kind: 'G' global or 'L' local/windowed."""
        if self.layer_pattern:
            pat = self.layer_pattern
            return [pat[i % len(pat)] for i in range(self.n_layers)]
        return ["L" if self.window else "G"] * self.n_layers

    def block_kinds(self) -> list[str]:
        """Per-layer block type for hybrid models: 'attn' | 'rec'."""
        if self.block_pattern:
            pat = self.block_pattern
            return [pat[i % len(pat)] for i in range(self.n_layers)]
        return ["attn"] * self.n_layers


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        from repro_torch import configs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    from repro_torch import configs  # noqa: F401
    return sorted(_REGISTRY)
