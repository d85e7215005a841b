"""minitron-4b — pruned Nemotron dense model (squared-ReLU MLP).

[arXiv:2407.14679; hf]  32L d_model=3072 24H (GQA kv=8, head_dim=128)
d_ff=9216 vocab=256000.
"""
from repro_torch.configs.base import FF_RELU2, ModelConfig, register


@register("minitron-4b")
def minitron_4b() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        vocab_size=256_000,
        ff_kind=FF_RELU2,
        rope_theta=10_000.0,
        expected_params=4.2e9,
        source="arXiv:2407.14679",
    )
