"""yi-9b — llama-architecture dense GQA model.

[arXiv:2403.04652; hf]  48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import FF_SWIGLU, ModelConfig, register


@register("yi-9b")
def yi_9b() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        family="dense",
        num_layers=48,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        d_ff=11_008,
        vocab_size=64_000,
        ff_kind=FF_SWIGLU,
        rope_theta=10_000.0,
        expected_params=8.8e9,
        source="arXiv:2403.04652",
    )
