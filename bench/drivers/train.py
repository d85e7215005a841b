"""The training driver: one malleable job, the port's ``ElasticTrainer``,
stepped and rescaled as a training mix says.

A mix (``traffic/<mix>.json``) gives the global batch and sequence length,
the Zipf exponent of the token ids, the slot sets the job moves through
(``slot_sets``, slot ids of one card) and how many steps it takes on each
(``steps_per_set``).  One unit of work is ``steps_per_set`` steps and,
where there is more than one set, the rescale to the next set, in the lane
the trainer picks (the host lane between disjoint sets); the window runs
whole units until ``--seconds`` has passed.

Set-up builds the trainer, hands it the benchmark's weights (drawn into its
parameters in place) and token stream, and runs whole units until the
compared steps (``compared_steps``) and a rescale into every set are
behind it: those warm every shape the window uses, and are the steps the
reference follows.  Their readings are taken as they pass (the first
moment after step 1, each leaf's change after the last compared step).
Once the window has closed and the peak is read, the trainer is freed and
the reference runs.
"""
from __future__ import annotations

import gc
import math
import time
from contextlib import nullcontext
from types import SimpleNamespace
from typing import Dict

import torch

from bench import compare, spec, trace, weights
from bench.stream import Stream, trained_tokens



def compared_steps(traffic: dict) -> int:
    """The steps the reference follows: 3, or where the job moves through
    more than one slot set, one whole cycle through them and one step more,
    so that the last compared step runs on state that came back through
    every set's rescale (the later ones through recycled pinned blocks)."""
    sets = len(traffic["slot_sets"])
    return 3 if sets == 1 else traffic["steps_per_set"] * sets + 1


def flat(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested dict of tensors as {'a/b/c': tensor}, keys in sorted order."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = tree[k]
    return out


def port_config(cfg: dict):
    from repro_torch.configs.base import ModelConfig, MoEConfig
    kw = dict(cfg["port"])
    if kw.get("moe"):
        kw["moe"] = MoEConfig(**kw["moe"])
    return ModelConfig(**kw)


class CountingStream(Stream):
    """The mix's stream, noting each step's trained tokens as the trainer
    draws its batch."""

    def __init__(self, *args):
        super().__init__(*args)
        self.trained: Dict[int, int] = {}

    def global_batch_at(self, step: int):
        batch = super().global_batch_at(step)
        self.trained[step] = trained_tokens(batch)
        return batch


class Job:
    """The trainer under test, its schedule, and the host clock around it."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, specs: dict):
        from repro_torch.core.elastic import ElasticTrainer, Slot, TrainJobConfig
        from repro_torch.optim import AdamWConfig
        a = cfg["assumed"]
        self.ids = traffic["slot_sets"]
        self.sets = [[Slot(i) for i in ids] for ids in self.ids]
        self.steps_per_set = traffic["steps_per_set"]
        job = TrainJobConfig(global_batch=traffic["global_batch"],
                             seq_len=traffic["seq_len"], total_steps=a["total_steps"],
                             peak_lr=a["peak_lr"], warmup_steps=a["warmup_steps"],
                             seed=seed, dtype=a["dtype"])
        self.trainer = ElasticTrainer(port_config(cfg), job, self.sets[0], device=device)
        self.trainer.adamw = AdamWConfig(**a["adamw"])
        self.stream = CountingStream(seed, cfg["vocab_size"], traffic["global_batch"],
                                     traffic["seq_len"], traffic["zipf_s"])
        self.trainer.stream = self.stream
        params = flat(self.trainer.params)
        got = {k: tuple(t.shape) for k, t in params.items()}
        want = {k: tuple(s[0]) for k, s in specs.items()}
        if got != want:
            raise ValueError(f"the port's parameters {got} are not the reference's {want}")
        for k, (shape, init, fan) in specs.items():
            weights.fill_(params[k], seed, k, init, fan)
        self.seed, self.specs = seed, specs
        self.set_idx = 0
        self.steps, self.rescales, self.spans = [], [], []

    def unit(self, after_step=None):
        for _ in range(self.steps_per_set):
            self.step()
            if after_step is not None:
                after_step(len(self.trainer.metrics_log))
        if len(self.sets) > 1:
            self.rescale()

    def step(self):
        t = self.trainer
        idx, r = t.step_idx, t.replicas
        t0, t0_ns = time.perf_counter(), time.time_ns()
        m = t.step()
        self.steps.append({"seconds": time.perf_counter() - t0, "replicas": r,
                           "tokens": self.stream.trained[idx], "loss": m["loss"]})
        self.spans.append((t0_ns, time.time_ns(), "bench.step"))

    def rescale(self):
        old = self.ids[self.set_idx]
        self.set_idx = (self.set_idx + 1) % len(self.sets)
        t0, t0_ns = time.perf_counter(), time.time_ns()
        r = self.trainer.rescale(self.sets[self.set_idx])
        seconds = time.perf_counter() - t0
        self.spans.append((t0_ns, time.time_ns(), "bench.rescale"))
        if not set(old) & set(self.ids[self.set_idx]) and r.path != "host":
            raise RuntimeError(f"a rescale between disjoint slot sets took the "
                               f"{r.path} lane, not the host lane")
        self.rescales.append({"seconds": seconds, "path": r.path, **r.as_dict()})

    # -- readings ----------------------------------------------------------------
    @torch.no_grad()
    def grad_norms(self) -> Dict[str, float]:
        b1 = self.trainer.adamw.b1
        return {k: float(torch.linalg.vector_norm(m)) / (1 - b1)
                for k, m in flat(self.trainer.opt_state["m"]).items()}

    @torch.no_grad()
    def update_norms(self) -> Dict[str, float]:
        out = {}
        for k, p in flat(self.trainer.params).items():
            shape, init, fan = self.specs[k]
            start = weights.make(shape, self.seed, k, init, fan, p.device, p.dtype)
            out[k] = float(torch.linalg.vector_norm(p - start))
            del start
        return out


def run(cell: dict, cfg: dict, traffic: dict, limits: dict, *, seed: int,
        seconds: float, traced: bool, device, t_start: float) -> SimpleNamespace:
    """One run of a training cell: set-up, the window, the reference.  The
    result carries the window's records for the metric readers, the traced
    window's reduction, and the compared numbers beside their limits."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    ref = spec.reference(cfg["reference"])
    specs = ref.param_specs(cfg)
    compared = compared_steps(traffic)
    # float32 as the configurations state it: TF32 off
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    job = Job(cfg, traffic, seed, device, specs)
    log = {"before_trainer_s": t0 - t_start, "trainer_s": time.perf_counter() - t0}
    got = {}

    def after_step(n):
        if n == 1:
            got["grad_norms"] = job.grad_norms()
        if n == compared:
            got["update_norms"] = job.update_norms()
            got["losses"] = [m["loss"] for m in job.trainer.metrics_log[:compared]]

    while len(job.steps) < compared or (len(job.sets) > 1
                                        and len(job.rescales) < len(job.sets)):
        job.unit(after_step)
    log["warm_steps_s"] = [s["seconds"] for s in job.steps]
    log["warm_rescales_s"] = [r["seconds"] for r in job.rescales]
    for records in (job.steps, job.rescales, job.spans):
        records.clear()

    if on_card:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    window = trace.Window() if traced else nullcontext()
    with window:
        w0, w0_ns = time.perf_counter(), time.time_ns()
        setup_s = w0 - t_start
        while time.perf_counter() - w0 < seconds:
            job.unit()
        window_s, w1_ns = time.perf_counter() - w0, time.time_ns()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    reduced, t_reduce = None, time.perf_counter()
    if traced:
        reduced = window.reduce(job.spans, w0_ns, w1_ns)
    t_reduce = time.perf_counter() - t_reduce
    steps, rescales = job.steps, job.rescales
    log["steps_s"] = [s["seconds"] for s in steps]
    log["rescales"] = [{k: r[k] for k in ("seconds", "checkpoint", "restore")}
                       for r in rescales]
    # the host lane's snapshot, to read each rescale's copy rate from the log
    log["state_bytes"] = sum(t.numel() * t.element_size()
                             for tree in (job.trainer.params, job.trainer.opt_state)
                             for t in flat(tree).values() if torch.is_tensor(t))
    batches = [job.stream.global_batch_at(i) for i in range(compared)]
    del job, window
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    want = ref.train(cfg, batches, seed, device=device, steps=compared)
    found = compare.gaps(got, want)
    checks = {k: {"value": found[k], "limit": limits[k]} for k in limits}
    return SimpleNamespace(
        cell=cell, cfg=cfg, traffic=traffic, ref=ref, setup_s=setup_s,
        window_s=window_s, steps=steps, rescales=rescales, peak_bytes=peak,
        memory_peak_bytes=max(peak, setup_peak) if on_card else 0, trace=reduced,
        attempted=len(steps) + len(rescales),
        failed=sum(not math.isfinite(s["loss"]) for s in steps),
        correct=compare.verdict(found, limits), checks=checks,
        readings={"port": got, "reference": want},
        reference_s=time.perf_counter() - t_ref, trace_reduce_s=t_reduce, log=log)
