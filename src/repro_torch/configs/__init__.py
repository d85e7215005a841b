"""Architecture configs of the port (dense yi-6b and Mamba-2 mamba2-1.3b).

``get_config(arch)`` returns the full published config; ``smoke_config(arch)``
the same tiny variant as ``repro.configs.smoke_config`` (d_model 64, vocab 128
padded to 256; attention: 4 heads, 2 KV heads, head_dim 16; SSM: d_state 16,
head_dim 16, one group, chunk 8).
"""
import dataclasses

from repro_torch.configs.base import (ATTN, FF_NONE, FF_SWIGLU, SSM,
                                      ModelConfig, SSMConfig, get_config,
                                      register)
from repro_torch.configs import mamba2_1_3b, yi_6b  # noqa: F401  (registry)


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
    if cfg.ssm is not None:
        kw.update(ssm=dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, num_groups=1, chunk=8))
    return cfg.with_(**kw)


__all__ = ["ATTN", "FF_NONE", "FF_SWIGLU", "SSM", "ModelConfig", "SSMConfig",
           "get_config", "register", "smoke_config"]
