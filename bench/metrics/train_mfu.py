"""Model FLOPs of the window's steps over their host-clock step seconds
times the card's peak for the configuration's precision (none: no
reading), in %.  The FLOPs
are ``bench.flops.train_step_flops`` (no recompute counted)."""
from bench import flops


def read(run):
    peak = flops.peak(run.device_name, run.cfg["assumed"]["dtype"])
    if not run.steps or peak is None:
        return None
    t = run.traffic
    step = flops.train_step_flops(run.cfg, t["global_batch"], t["seq_len"],
                                  run.ref.causal_attention_layers(run.cfg))
    return 100.0 * step * len(run.steps) / (sum(s["seconds"] for s in run.steps) * peak)
