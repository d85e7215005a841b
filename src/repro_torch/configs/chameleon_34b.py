"""chameleon-34b — early-fusion VLM backbone (VQ image tokens), qk-norm.

[arXiv:2405.09818; unverified]  48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 (text + VQ image codes).  The VQ-VAE image tokenizer is a stub
(``frontend="vision"``): the backbone consumes token ids, image codes
included.
"""
from repro_torch.configs.base import FF_SWIGLU, ModelConfig, register


@register("chameleon-34b")
def chameleon_34b() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        family="vlm",
        num_layers=48,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22_016,
        vocab_size=65_536,
        ff_kind=FF_SWIGLU,
        qk_norm=True,
        frontend="vision",
        rope_theta=10_000.0,
        expected_params=34.3e9,
        source="arXiv:2405.09818",
    )
