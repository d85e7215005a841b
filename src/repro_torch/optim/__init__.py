from repro_torch.optim.adamw import (AdamWConfig, abstract_opt_state,
                                    adamw_init, adamw_update, global_norm,
                                    opt_logical_axes)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamWConfig", "abstract_opt_state", "adamw_init", "adamw_update",
           "global_norm", "opt_logical_axes", "warmup_cosine"]
