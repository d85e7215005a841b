"""Architecture configs of the port: dense yi-6b, yi-9b, starcoder2-7b,
minitron-4b, the chameleon-34b backbone, the granite-moe-3b-a800m MoE and
Mamba-2 mamba2-1.3b.

``get_config(arch)`` returns the full published config; ``smoke_config(arch)``
the same tiny variant as ``repro.configs.smoke_config`` (d_model 64, vocab 128
padded to 256; attention: 4 heads, 2 KV heads, head_dim 16; MoE: 4 experts,
top-2, expert d_ff 32; SSM: d_state 16, head_dim 16, one group, chunk 8).
"""
import dataclasses

from repro_torch.configs.base import (ATTN, FF_GELU, FF_MOE, FF_NONE,
                                      FF_RELU2, FF_SWIGLU, MLA, SSM, MLAConfig,
                                      ModelConfig, MoEConfig, SSMConfig,
                                      count_active_params, count_params,
                                      get_config, list_archs, register)
from repro_torch.configs import (chameleon_34b, granite_moe_3b_a800m,  # noqa: F401
                                 mamba2_1_3b, minitron_4b, starcoder2_7b,
                                 yi_6b, yi_9b)


def smoke_config(arch: str) -> ModelConfig:
    """Tiny structurally faithful variant of ``arch`` for CPU tests."""
    cfg = get_config(arch)
    kw = dict(name=cfg.name + "-smoke",
              num_layers=max(2, cfg.layer_period()), d_model=64,
              d_ff=128 if cfg.d_ff else 0, vocab_size=128, expected_params=0.0)
    if cfg.num_heads:
        kw.update(num_heads=4,
                  num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
                  head_dim=16)
    if cfg.moe is not None:
        kw.update(moe=dataclasses.replace(
            cfg.moe, num_experts=4,
            experts_per_token=min(2, cfg.moe.experts_per_token),
            d_ff_expert=32))
    if cfg.ssm is not None:
        kw.update(ssm=dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, num_groups=1, chunk=8))
    return cfg.with_(**kw)


__all__ = ["ATTN", "MLA", "SSM", "FF_SWIGLU", "FF_GELU", "FF_RELU2", "FF_MOE",
           "FF_NONE", "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
           "get_config", "smoke_config", "list_archs", "count_params",
           "count_active_params", "register"]
