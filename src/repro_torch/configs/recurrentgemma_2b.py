"""recurrentgemma-2b [hybrid]: 26L d=2560 10H (GQA kv=1, head_dim=256)
ff=7680 vocab=256000. RG-LRU + local attention 2:1 (rec,rec,attn)
[arXiv:2402.19427], local window 2048, lru_width=2560.
Sub-quadratic -> long_500k runs.
"""
from repro_torch.models.common import ModelConfig, register


@register("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
        head_dim=256, d_ff=7680, vocab=256000, mlp="geglu",
        window=2048, block_pattern=("rec", "rec", "attn"),
        lru_width=2560, conv1d_width=4, tie_embeddings=True)
