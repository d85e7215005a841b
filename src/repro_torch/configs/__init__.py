"""Architecture configs of the port: dense yi-6b, yi-9b, starcoder2-7b,
minitron-4b, the chameleon-34b backbone, the granite-moe-3b-a800m MoE,
the deepseek-v2-236b MLA + MoE model, Mamba-2 mamba2-1.3b, the
jamba-v0.1-52b hybrid (Mamba-2 and attention layers, MoE every second
layer, stacked in period-8 blocks) and the seamless-m4t-large-v2
encoder-decoder (its audio frontend a stub).

``get_config(arch)`` returns the full published config; ``smoke_config(arch)``
the same tiny variant as ``repro.configs.smoke_config`` (d_model 64, vocab 128
padded to 256; attention: 4 heads, 2 KV heads, head_dim 16; MLA: 4 heads,
q/kv lora 32, nope 16, rope 8, v 16; MoE: 4 experts, top-2, expert d_ff 32,
its ``first_dense`` layers added to the depth; SSM: d_state 16, head_dim 16,
one group, chunk 8; an encoder of 2 layers).
"""
import dataclasses

from repro_torch.configs.base import (ATTN, FF_GELU, FF_MOE, FF_NONE,
                                      FF_RELU2, FF_SWIGLU, MLA, SSM, MLAConfig,
                                      ModelConfig, MoEConfig, SHAPES,
                                      ShapeConfig, SSMConfig,
                                      count_active_params, count_params,
                                      get_config, list_archs, register,
                                      shape_applicable)
from repro_torch.configs import (chameleon_34b, deepseek_v2_236b,  # noqa: F401
                                 granite_moe_3b_a800m, jamba_v0_1_52b,
                                 mamba2_1_3b, minitron_4b,
                                 seamless_m4t_large_v2, starcoder2_7b,
                                 yi_6b, yi_9b)


def smoke_config(arch: str, *, layers_per_period: int = 1) -> ModelConfig:
    """Tiny structurally faithful variant of ``arch`` for CPU tests."""
    cfg = get_config(arch)
    num_layers = max(2, cfg.layer_period() * layers_per_period)
    num_layers += cfg.moe.first_dense if cfg.moe else 0
    kw = dict(name=cfg.name + "-smoke", num_layers=num_layers, d_model=64,
              d_ff=128 if cfg.d_ff else 0, vocab_size=128, expected_params=0.0)
    if cfg.num_heads:
        kw.update(num_heads=4,
                  num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
                  head_dim=16)
    if cfg.mla is not None:
        kw.update(mla=MLAConfig(q_lora_rank=32, kv_lora_rank=32,
                                qk_nope_head_dim=16, qk_rope_head_dim=8,
                                v_head_dim=16),
                  num_heads=4, num_kv_heads=4, head_dim=16)
    if cfg.moe is not None:
        kw.update(moe=dataclasses.replace(
            cfg.moe, num_experts=4,
            experts_per_token=min(2, cfg.moe.experts_per_token),
            d_ff_expert=32))
    if cfg.ssm is not None:
        kw.update(ssm=dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, num_groups=1, chunk=8))
    if cfg.enc_layers:
        kw.update(enc_layers=2)
    return cfg.with_(**kw)


__all__ = ["ATTN", "MLA", "SSM", "FF_SWIGLU", "FF_GELU", "FF_RELU2", "FF_MOE",
           "FF_NONE", "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
           "ShapeConfig", "SHAPES", "shape_applicable", "get_config",
           "smoke_config", "list_archs", "count_params", "count_active_params",
           "register"]
