"""rwkv6-1.6b [ssm]: 24L d=2048 attention-free, ff=7168 vocab=65536.

RWKV-6 "Finch" — data-dependent decay [arXiv:2404.05892]. O(1) decode
state -> long_500k runs (the sub-quadratic family).
"""
from repro_torch.models.common import ModelConfig, register


@register("rwkv6-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=7168, vocab=65536, tie_embeddings=True)
