"""deepseek-v2-236b — MLA + fine-grained MoE.

[arXiv:2405.04434; hf]  60L d_model=5120 128H, MLA kv_lora=512 (q_lora=1536,
qk_nope=128, qk_rope=64, v=128), MoE: 2 shared + 160 routed top-6,
expert d_ff=1536, first layer dense (d_ff=12288), vocab=102400.
"""
from repro_torch.configs.base import (FF_SWIGLU, ModelConfig, MLAConfig,
                                      MoEConfig, register)


@register("deepseek-v2-236b")
def deepseek_v2_236b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,       # MLA: logical kv heads == q heads
        head_dim=128,           # v head dim (roofline bookkeeping)
        d_ff=12_288,            # dense FFN used in layer 0 only
        vocab_size=102_400,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        ff_kind=FF_SWIGLU,
        moe=MoEConfig(num_experts=160, experts_per_token=6,
                      num_shared_experts=2, d_ff_expert=1536,
                      moe_every=1, moe_offset=0, first_dense=1,
                      ff_kind=FF_SWIGLU),
        rope_theta=10_000.0,
        expected_params=236e9,
        source="arXiv:2405.04434",
    )
