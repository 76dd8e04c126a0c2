"""granite-3-2b [dense]: 40L d=2048 32H (GQA kv=8) ff=8192 vocab=49155.

[hf:ibm-granite/granite-3.0-2b-base]. Full attention -> long_500k skip.
"""
from repro_torch.models.common import ModelConfig, register


@register("granite-3-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b", family="dense",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab=49155, mlp="swiglu", tie_embeddings=True)
