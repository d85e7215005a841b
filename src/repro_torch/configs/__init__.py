"""Architecture configs of the port (the dense yi-6b family so far).

``get_config(arch)`` returns the full published config; ``smoke_config(arch)``
the same tiny variant as ``repro.configs.smoke_config`` (d_model 64, 4 heads,
2 KV heads, head_dim 16, vocab 128 padded to 256).
"""
from repro_torch.configs.base import (FF_SWIGLU, ModelConfig, get_config,
                                      register)
from repro_torch.configs import yi_6b  # noqa: F401  (populate the registry)


def smoke_config(arch: str) -> ModelConfig:
    """Tiny structurally faithful variant of ``arch`` for CPU tests."""
    cfg = get_config(arch)
    kw = dict(name=cfg.name + "-smoke", num_layers=2, d_model=64,
              d_ff=128 if cfg.d_ff else 0, vocab_size=128, expected_params=0.0)
    if cfg.num_heads:
        kw.update(num_heads=4,
                  num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
                  head_dim=16)
    return cfg.with_(**kw)


__all__ = ["FF_SWIGLU", "ModelConfig", "get_config", "register",
           "smoke_config"]
