"""mamba2-1.3b — SSD (state-space duality), attention-free.

[arXiv:2405.21060]  48L d_model=2048, d_ff=0, vocab=50280, ssm_state=128.
d_inner = 2*d_model = 4096, head_dim=64 -> 64 SSD heads; tied embeddings.
"""
from repro_torch.configs.base import (FF_NONE, SSM, ModelConfig, SSMConfig,
                                      register)


@register("mamba2-1.3b")
def mamba2_1_3b() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50_280,
        default_mixer=SSM,
        attn_every=0,  # never attention
        ff_kind=FF_NONE,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, num_groups=1,
                      conv_width=4, chunk=128),
        tie_embeddings=True,
        supports_long_context=True,
        expected_params=1.35e9,
        source="arXiv:2405.21060",
    )
