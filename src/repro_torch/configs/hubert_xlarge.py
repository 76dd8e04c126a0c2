"""hubert-xlarge [audio]: 48L d=1280 16H (kv=16) ff=5120 vocab=504.

Encoder-only (bidirectional), same arch as wav2vec2 [arXiv:2106.07447].
The conv waveform frontend is a STUB: input_specs provides precomputed
frame embeddings (B, S, D); the head predicts 504 cluster units.
No decode step (encoder) -> decode_32k / long_500k skipped.
"""
from repro_torch.models.common import ModelConfig, register


@register("hubert-xlarge")
def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="encoder",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab=504, mlp="gelu", causal=False,
        tie_embeddings=False, frontend_stub=True)
