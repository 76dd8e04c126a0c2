"""gemma3-1b [dense]: 26L d=1152 4H (GQA kv=1, head_dim=256) ff=6912
vocab=262144. 5 local : 1 global layer pattern, local window 512
[hf:google/gemma-3-1b-pt]. Sub-quadratic (5:1 local) -> long_500k runs;
local layers use ImaGen-planned ring KV caches at decode.
"""
from repro_torch.models.common import ModelConfig, register


@register("gemma3-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
        head_dim=256, d_ff=6912, vocab=262144, mlp="geglu",
        rope_theta=1e6, window=512, layer_pattern="LLLLLG",
        tie_embeddings=True)
