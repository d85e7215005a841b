"""The cells' configurations and mixes cut to a smoke size (every width
small, the structure kept), and one driver run of a cell at that size."""
import copy
import os
import time

from bench import spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ("yi6b-d4.migrate", "granite-moe-3b.steady", "yi6b-d4.steady")
SMOKE_SEQ = 32


def smoke_config(cfg: dict) -> dict:
    """``cfg`` at d_model 64, 4 heads of 16 (2 KV heads), 2 layers, a
    vocabulary of 250 (padded rows in play) or 256; MoE: 4 experts, top 2,
    expert width 32.  Published keys and the port's section alike."""
    c = copy.deepcopy(cfg)
    moe = "num_local_experts" in c
    vocab = 250 if moe else 256
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             vocab_size=vocab, num_hidden_layers=2, intermediate_size=32 if moe else 128)
    c["port"].update(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                     vocab_size=vocab, num_layers=2, d_ff=0 if moe else 128)
    if moe:
        c.update(num_local_experts=4, num_experts_per_tok=2)
        c["port"]["moe"].update(num_experts=4, experts_per_token=2, d_ff_expert=32)
    return c


def smoke_inputs(bench_json, name):
    cell = spec.cell(bench_json, name)
    cfg = smoke_config(spec.config(bench_json, cell["config"]))
    traffic = dict(spec.traffic(cell["traffic"]), seq_len=SMOKE_SEQ)
    return cell, cfg, traffic, spec.limits(name)


def smoke_run(bench_json, name, *, seed=2**31 + 11, device="cpu", seconds=0.2,
              traced=False):
    """One driver run of cell ``name`` at smoke size, the card check skipped."""
    import torch
    torch.manual_seed(0)
    cell, cfg, traffic, limits = smoke_inputs(bench_json, name)
    driver = spec.driver(traffic["driver"])
    return driver.run(cell, cfg, traffic, limits, seed=seed, seconds=seconds,
                      traced=traced, device=device, t_start=time.perf_counter())
