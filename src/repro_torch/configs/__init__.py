"""Architecture configs (assigned pool) + the paper's own pipelines.

Importing this package populates the model registry; use
``repro_torch.models.common.get_config(name)`` / ``list_archs()``.
"""
from . import (gemma3_1b, granite_3_2b, granite_moe_1b, hubert_xlarge,
               mixtral_8x22b, phi4_mini_3_8b, qwen2_5_3b, qwen2_vl_7b,
               recurrentgemma_2b, rwkv6_1_6b)
from .imagen_pipelines import PIPELINES  # noqa: F401

ALL_ARCHS = [
    "hubert-xlarge", "qwen2.5-3b", "gemma3-1b", "phi4-mini-3.8b",
    "granite-3-2b", "rwkv6-1.6b", "qwen2-vl-7b", "recurrentgemma-2b",
    "granite-moe-1b-a400m", "mixtral-8x22b",
]
