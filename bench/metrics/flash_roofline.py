"""The flash forward kernel's share of its roofline over the traced window,
in %: the least time the card could take for the launches (the larger of
their causal operations over the compute peak and their bytes over the HBM
rate, ``bench.flops``) over their device time.

A step's launches are taken to be a whole number of passes over its
replicas' shards, one launch a layer and shard of ``global_batch /
replicas`` sequences, as the port's trainer launches them; a step whose
count is not such a multiple leaves the metric out."""
from bench import flops, trace

NAME = "flash_fwd"


def read(run):
    tr = run.trace
    cfg, t = run.cfg, run.traffic
    peak = flops.peak(run.device_name, cfg["assumed"]["dtype"])   # float32 only
    bw = flops.peak(run.device_name, "hbm_bytes_per_s")
    if tr is None or peak is None or bw is None:
        return None
    steps = [s for s in tr["spans"] if s[2] == "bench.step"]
    if len(steps) != len(run.steps):
        return None
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, kv = cfg.get("head_dim") or d // h, cfg["num_key_value_heads"]
    layers = run.ref.causal_attention_layers(cfg)
    bound = busy = 0.0
    for (s0, s1, _), rec in zip(steps, run.steps):
        launches = [k for k in trace.within(tr["kernels"], s0, s1) if NAME in k[2]]
        r = rec["replicas"]
        if not launches:
            continue
        if len(launches) % (layers * r):
            return None
        b = t["global_batch"] // r
        one = max(flops.causal_attention_ops(b, t["seq_len"], h, hd) / peak,
                  flops.flash_fwd_bytes(b, t["seq_len"], h, kv, hd) / bw)
        bound += one * len(launches)
        busy += sum(k[1] - k[0] for k in launches) / 1e9
    return 100.0 * bound / busy if busy else None
