"""seamless-m4t-large-v2: encoder-decoder, multimodal (audio) backbone.

[arXiv:2308.11596; hf]  24 encoder + 24 decoder layers, d_model=1024,
16H (kv=16), d_ff=8192, vocab=256206.  The speech frontend (w2v-BERT feature
extractor) is a stub, as in the JAX package: the backbone takes precomputed
frame embeddings ``enc_embeds`` of shape (batch, frames, d_model).
"""
from repro_torch.configs.base import FF_GELU, ModelConfig, register


@register("seamless-m4t-large-v2")
def seamless_m4t_large_v2() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        num_layers=24,          # decoder layers
        enc_layers=24,          # encoder layers
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=256_206,
        ff_kind=FF_GELU,
        frontend="audio",
        tie_embeddings=True,
        rope_theta=10_000.0,
        expected_params=1.45e9,  # transformer backbone only (frontend stubbed)
        source="arXiv:2308.11596",
    )
