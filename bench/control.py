#!/usr/bin/env python3
"""The port's readings, the control and the planted faults of a training
cell, at the cell's own size, each held to the cell's limits
(``limits/<cell>.json``) by the comparison a run makes.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 [--variants ...]

Variants: ``port`` (the run's own set-up and comparison, with no window:
the readings the lower end of each limit is set from), ``tf32`` (the
control: the reference put in the port's place, with the configuration's
float32 computed as TF32, the nearest precision below it), ``half_batch``
(half of each batch left out, the mean taken over the rest) and
``no_exchange`` (the replicas' gradients never summed: the last replica's
shard alone, its own mean).  A state left unchanged reads 1 by the
comparison's measure and needs no run.  ``regrouped`` is no fault but a
witness: the float32 reference with its gradient accumulated over blocks
twice as large, which changes only the order of its sums, so it reads what
rounding alone does to each number.  The reference follows as many steps
as a run compares (``drivers.train.compared_steps``).

Prints one JSON line a seed and variant, with the verdict under the
cell's limits.  Exits 1 if a ``port`` reading is not correct, or the
control or a fault is; the benchmark's runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("tf32", "half_batch", "no_exchange")
PORT, WITNESS = "port", "regrouped"


def variant_rows(traffic: dict, variant: str):
    """The batch rows a variant keeps (None: all)."""
    b = traffic["global_batch"]
    if variant == "half_batch":
        return list(range(b // 2))
    if variant == "no_exchange":
        per = b // len(traffic["slot_sets"][0])
        return list(range(b - per, b))
    return None


def readings(ref, cfg: dict, traffic: dict, seed: int, variant: str, device) -> dict:
    """The reference's readings under ``variant`` (``fp32``: as stated) over
    the steps a run compares."""
    from bench.drivers.train import compared_steps
    from bench.stream import Stream
    steps = compared_steps(traffic)
    stream = Stream(seed, cfg["vocab_size"], traffic["global_batch"],
                    traffic["seq_len"], traffic["zipf_s"])
    batches = [stream.global_batch_at(i) for i in range(steps)]
    blocks = {"block_rows": 2 * ref.ROWS} if variant == WITNESS else {}
    return ref.train(cfg, batches, seed, device=device, steps=steps,
                     precision="tf32" if variant == "tf32" else "fp32",
                     rows=variant_rows(traffic, variant), **blocks)


def check(cell: dict, cfg: dict, traffic: dict, limits: dict, seeds, variants, device):
    """Each seed's and variant's readings held to ``limits``: yields one
    record each, with ``wrong`` set where the port is not correct or the
    control or a fault is."""
    from bench import compare, spec
    ref = spec.reference(cfg["reference"])
    for seed in seeds:
        t0 = time.perf_counter()
        if PORT in variants:
            out = spec.driver(traffic["driver"]).run(
                cell, cfg, traffic, limits, seed=seed, seconds=0, traced=False,
                device=device, t_start=t0)
            want, got = out.readings["reference"], {PORT: out.readings["port"]}
        else:
            want, got = readings(ref, cfg, traffic, seed, "fp32", device), {}
        ref_s = time.perf_counter() - t0
        for v in variants:
            if v not in got:
                got[v] = readings(ref, cfg, traffic, seed, v, device)
            gaps = compare.gaps(got[v], want)
            correct = compare.verdict(gaps, limits)
            yield {"workload": cell["name"], "seed": seed, "variant": v,
                   "correct": correct,
                   "wrong": correct != (v == PORT) if v != WITNESS else False,
                   "gaps": gaps, "limits": limits, "seconds_to_reference": ref_s,
                   "losses": got[v]["losses"], "want_losses": want["losses"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+", default=[PORT, *VARIANTS],
                   choices=(PORT, *VARIANTS, WITNESS))
    args = p.parse_args(argv)
    sys.path[:0] = [ROOT]
    from bench.run import use_checkout
    use_checkout()
    import torch
    from bench import spec
    if not torch.cuda.is_available():
        print("control: no CUDA card is available", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg, traffic = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    wrong = []
    for rec in check(cell, cfg, traffic, spec.limits(cell["name"]), args.seeds,
                     args.variants, "cuda"):
        if rec["wrong"]:
            wrong.append((rec["seed"], rec["variant"]))
        print(json.dumps(rec), flush=True)
    if wrong:
        print(f"control: the port not correct, or the control or a fault correct: "
              f"{wrong}", file=sys.stderr)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
