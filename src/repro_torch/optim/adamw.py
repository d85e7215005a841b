"""AdamW with global-norm clipping (counterpart of ``repro.optim.adamw``).

float32 moments, an int32 ``count``, bias correction, and weight decay on
EVERY leaf, norms included, as the reference does.  Unlike the reference's
pure function, ``adamw_update`` updates params and moments IN PLACE: at full
width a second copy of the 1.2e9-parameter state would not be free.  It
updates each leaf in pieces of ``CHUNK`` elements, so its temporaries stay
small beside a 4 GB leaf (granite-moe-3b-a800m's stacked experts); every
operation is elementwise, so the result is the same as in one piece.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from repro_torch.checkpoint.reshard import tree_leaves, tree_map

CHUNK = 1 << 26            # elements: 256 MB of float32 temporaries a piece


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state, params, lr
                 ) -> Dict[str, torch.Tensor]:
    """Apply one step in place to ``params`` and ``state``; ``grads`` is a
    tree shaped like ``params``.  Returns {"grad_norm", "lr"}."""
    g_leaves = tree_leaves(grads)
    m_leaves, v_leaves = tree_leaves(state["m"]), tree_leaves(state["v"])
    p_leaves = tree_leaves(params)
    state["count"].add_(1)
    count = state["count"].float()
    gnorm = global_norm(g_leaves)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=count.device)
    bc1 = 1.0 - torch.pow(f32(cfg.b1), count)
    bc2 = 1.0 - torch.pow(f32(cfg.b2), count)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=count.device)
    for g, m, v, p in zip(g_leaves, m_leaves, v_leaves, p_leaves):
        g = g.reshape(-1)
        m, v, p = m.view(-1), v.view(-1), p.view(-1)   # updated in place: views
        for lo in range(0, g.numel(), CHUNK):
            _update(cfg, g[lo:lo + CHUNK], m[lo:lo + CHUNK], v[lo:lo + CHUNK],
                    p[lo:lo + CHUNK], scale, bc1, bc2, lr)
    return {"grad_norm": gnorm, "lr": lr}


def _update(cfg: AdamWConfig, g, m, v, p, scale, bc1, bc2, lr):
    g = g.float() * scale
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
    step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    p32 = p.float()
    p.copy_(p32 - lr * (step + cfg.weight_decay * p32))
