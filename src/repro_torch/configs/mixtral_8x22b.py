"""mixtral-8x22b [moe]: 56L d=6144 48H (GQA kv=8) ff=16384 vocab=32768,
8 experts top-2, sliding-window attention [arXiv:2401.04088], window 4096.
SWA -> sub-quadratic -> long_500k runs with ImaGen-planned ring KV.
E=8 does not divide the 16-way model axis: TP-inside-expert (d_ff over
'model') + FSDP over 'data' (see distributed/sharding.py).
"""
from repro_torch.models.common import ModelConfig, register


@register("mixtral-8x22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=32768, mlp="swiglu",
        n_experts=8, top_k=2, window=4096, layer_pattern="L",
        tie_embeddings=True)
