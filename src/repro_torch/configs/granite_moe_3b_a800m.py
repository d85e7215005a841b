"""granite-moe-3b-a800m — MoE transformer, 40 routed experts, top-8.

[hf:ibm-granite/granite-3.0-*-base family; hf]  32L d_model=1536 24H (GQA kv=8)
expert d_ff=512, vocab=49155, MoE 40e top-8, every layer MoE (no dense FFN).

NOTE: the assignment line reads "MoE 40e top-8" while its provenance note says
"32 experts top-8"; we implement the primary spec (40 experts) and record the
discrepancy here.
"""
from repro_torch.configs.base import FF_SWIGLU, ModelConfig, MoEConfig, register


@register("granite-moe-3b-a800m")
def granite_moe_3b_a800m() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=0,
        vocab_size=49_155,
        ff_kind=FF_SWIGLU,
        moe=MoEConfig(num_experts=40, experts_per_token=8,
                      num_shared_experts=0, d_ff_expert=512,
                      moe_every=1, moe_offset=0, ff_kind=FF_SWIGLU),
        tie_embeddings=True,
        rope_theta=10_000.0,
        expected_params=3.3e9,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base (scaled spec per assignment)",
    )
