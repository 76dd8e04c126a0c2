"""qwen2-vl-7b [vlm]: 28L d=3584 28H (GQA kv=4) ff=18944 vocab=152064.

M-RoPE + dynamic resolution [arXiv:2409.12191]. The vision tower is a
STUB: input_specs provides patch embeddings scattered over the first
n_vision_tokens positions plus (3, B, S) M-RoPE position ids.
Full attention -> long_500k skipped.
"""
from repro_torch.models.common import ModelConfig, register


@register("qwen2-vl-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab=152064, mlp="swiglu", rope_theta=1e6,
        mrope=True, n_vision_tokens=1024, frontend_stub=True,
        tie_embeddings=True)
