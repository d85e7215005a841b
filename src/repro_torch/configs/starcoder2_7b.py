"""starcoder2-7b — dense GQA + RoPE code model.

[arXiv:2402.19173; hf]  32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152, non-gated GELU MLP, rope_theta=1e5.
"""
from repro_torch.configs.base import FF_GELU, ModelConfig, register


@register("starcoder2-7b")
def starcoder2_7b() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        num_layers=32,
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        d_ff=18_432,
        vocab_size=49_152,
        ff_kind=FF_GELU,
        rope_theta=100_000.0,
        expected_params=7.4e9,
        source="arXiv:2402.19173",
    )
