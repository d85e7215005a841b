"""jamba-v0.1-52b — hybrid Mamba + attention (1:7) with MoE (16e top-2).

[arXiv:2403.19887; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, attention at 1 of every 8 layers (offset 3 within each block),
MoE at every other layer (16 experts, top-2), Mamba elsewhere.

Hardware adaptation note (the JAX package's, kept here): Jamba v0.1 uses
the Mamba-1 selective scan; both packages use the Mamba-2 SSD block
(d_state=16 as in Jamba) so both SSM archs share the chunked-SSD kernel.
Parameter count is preserved to ~2%.
"""
from repro_torch.configs.base import (FF_SWIGLU, SSM, ModelConfig, MoEConfig,
                                      SSMConfig, register)


@register("jamba-v0.1-52b")
def jamba_v0_1_52b() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14_336,
        vocab_size=65_536,
        default_mixer=SSM,
        attn_every=8,
        attn_offset=3,
        ff_kind=FF_SWIGLU,
        moe=MoEConfig(num_experts=16, experts_per_token=2,
                      num_shared_experts=0, d_ff_expert=14_336,
                      moe_every=2, moe_offset=1, ff_kind=FF_SWIGLU),
        ssm=SSMConfig(d_state=16, head_dim=64, expand=2, num_groups=1,
                      conv_width=4, chunk=128),
        supports_long_context=True,
        rope_theta=10_000.0,
        expected_params=51.5e9,
        source="arXiv:2403.19887",
    )
