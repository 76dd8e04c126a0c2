"""Architecture zoo: generic transformer + MoE + RWKV6 + RG-LRU hybrid."""
from . import common, layers, moe, rglru, rwkv6, transformer, weights
from .common import ModelConfig, get_config, list_archs
from .transformer import Model, build_model
from .weights import params_from_reference, train_state_from_reference

__all__ = ["ModelConfig", "Model", "build_model", "common", "get_config",
           "layers", "list_archs", "moe", "params_from_reference", "rglru",
           "rwkv6", "train_state_from_reference", "transformer",
           "weights"]
