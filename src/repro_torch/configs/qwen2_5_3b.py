"""qwen2.5-3b [dense]: 36L d=2048 16H (GQA kv=2) ff=11008 vocab=151936.

GQA with QKV bias [hf:Qwen/Qwen2.5]. Full attention -> long_500k skipped.
"""
from repro_torch.models.common import ModelConfig, register


@register("qwen2.5-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
        d_ff=11008, vocab=151936, qkv_bias=True, mlp="swiglu",
        rope_theta=1e6, tie_embeddings=True)
