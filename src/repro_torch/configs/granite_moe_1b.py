"""granite-moe-1b-a400m [moe]: 24L d=1024 16H (GQA kv=8) ff(expert)=512
vocab=49155, 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base].
Full attention -> long_500k skipped. EP: 32 experts over the 16-way
model axis (2 experts/device).
"""
from repro_torch.models.common import ModelConfig, register


@register("granite-moe-1b-a400m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=512, vocab=49155, mlp="swiglu",
        n_experts=32, top_k=8, tie_embeddings=True)
