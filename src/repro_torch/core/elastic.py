"""ElasticTrainer — live shrink/expand of a PyTorch training job (paper C1).

Counterpart of ``repro.core.elastic``.  A job runs on R data-parallel
replicas.  On one card the replicas are logical slots (``Slot``, small
handles with an ``.id``, all on the trainer's one device, the counterpart of
``jax.devices()``): the fixed global batch is split into R shards, each
shard's gradient is accumulated in slot order (a fixed summation order), and
the loss is sum(loss_sum) / sum(weight) over the global batch, as the
reference's SPMD step computes it.  As in the reference, R is the slot count
over ``TrainJobConfig.model_axis`` (1 by default), and ``job.rules`` names
the sharding rule set of the job's (R, model_axis) mesh shape
(``ElasticTrainer.rules``), which the port reports and does not apply.

A model with MoE layers adds the load-balance loss of the GLOBAL batch, as
the reference's step (one ``loss_fn`` over the whole batch) does: it is
``E * sum_e f_e * P_e`` with ``f_e`` and ``P_e`` means over every shard, not a
sum of shard losses.  Its counts are not differentiable, so once every
shard's sums are known the loss is linear in each shard's probabilities:
the step runs every shard's forward, keeps the graphs, reduces the sums,
and runs one backward.  Models without MoE layers backpropagate each shard
as soon as its forward ends.

A rescale reports the paper's four stages (Fig. 5):

    load_balance  re-split the global batch over the new slots (shard_bounds)
    checkpoint    device -> host snapshot through the fused pack kernel
                  (host lane only)
    restart       rebuild the per-R step state, cached per slot set
    restore       host -> device on the host lane; nothing on the p2p lane,
                  where the state stays resident on the card

Each stage is a ``rescale.<stage>`` span of ``obs.device_spans``, whose own
clock reads fill ``RescaleTimings`` whether or not a recorder is installed;
``step()`` opens ``trainer.batch``, ``trainer.forward`` and
``trainer.backward`` (each shard's, or one backward on the MoE path),
``trainer.optimizer`` and ``trainer.metrics`` inside ``trainer.step``.
Both record under a running ``torch.profiler`` (``follow_profiler``).

Training state is ``(params, opt_state, step)``; the data stream is a pure
function of ``(seed, step)``, so a rescaled run reproduces the static run.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import torch

from repro_torch.checkpoint.async_ckpt import AsyncCheckpointer
from repro_torch.checkpoint.reshard import (restore_from_host,
                                            snapshot_to_host,
                                            surviving_devices, tree_leaves,
                                            tree_map)
from repro_torch.configs.base import FF_MOE, ModelConfig
from repro_torch.data import make_stream
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model as M
from repro_torch.obs.device_spans import follow_profiler, span, timed
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               warmup_cosine)
from repro_torch.sharding import AxisRules, rules_for


@dataclass(frozen=True)
class Slot:
    """One logical replica slot on the trainer's device."""
    id: int


def local_slots(n: int) -> List[Slot]:
    return [Slot(i) for i in range(n)]


@dataclass
class RescaleTimings:
    load_balance: float = 0.0
    checkpoint: float = 0.0
    restart: float = 0.0
    restore: float = 0.0
    path: str = "host"          # "p2p" (state stays resident) or "host"

    @property
    def total(self) -> float:
        return self.load_balance + self.checkpoint + self.restart + self.restore

    def as_dict(self) -> Dict[str, float]:
        return {"load_balance": self.load_balance, "checkpoint": self.checkpoint,
                "restart": self.restart, "restore": self.restore,
                "total": self.total}


@dataclass
class TrainJobConfig:
    global_batch: int = 8
    seq_len: int = 32
    total_steps: int = 50
    model_axis: int = 1
    rules: str = "tp"
    peak_lr: float = 3e-3
    warmup_steps: int = 10
    seed: int = 0
    dtype: str = "float32"


class ElasticTrainer:
    def __init__(self, cfg: ModelConfig, job: TrainJobConfig,
                 slots: Sequence[Slot], *,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg.with_(dtype=job.dtype)
        self.job = job
        self.step_idx = 0
        self.stream = make_stream(self.cfg, seed=job.seed,
                                  global_batch=job.global_batch,
                                  seq_len=job.seq_len)
        self.adamw = AdamWConfig()
        self.metrics_log: List[dict] = []
        self.rescale_log: List[RescaleTimings] = []
        self._async_ckpt: Optional[AsyncCheckpointer] = None
        self._has_moe = any(self.cfg.ff_at(i) == FF_MOE
                            for i in range(self.cfg.num_layers))

        t0 = time.perf_counter()
        self._step_cache: Dict[tuple, dict] = {}
        r = self.validate_devices(slots)
        self._ensure_step_state(slots, self._shard_bounds(r))
        self.params = M.init_params(self.cfg, job.seed, self.device)
        self.opt_state = adamw_init(self.params)
        self._sync()
        self.startup_time = time.perf_counter() - t0

    # -- slots ----------------------------------------------------------------
    @property
    def replicas(self) -> int:
        return len(self.slots) // self.job.model_axis

    @property
    def rules(self) -> AxisRules:
        """The job's rule set (``job.rules``) on the (data, model) mesh
        shape of its slots, (R, ``model_axis``), as the reference's trainer
        builds its shardings; the port places nothing on it, but its specs
        give the per-device state bytes of the job at that shape."""
        return rules_for(self.job.rules,
                         MeshShape(("data", "model"), (self.replicas, self.job.model_axis)))

    def validate_devices(self, slots: Sequence[Slot]) -> int:
        """Check a target slot set BEFORE any rescale stage runs; returns the
        replica count, the slots over ``model_axis``."""
        slots = list(slots)
        m = self.job.model_axis
        if not slots:
            raise ValueError("rescale target has no slots (devices)")
        ids = [s.id for s in slots]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate slot ids {ids}")
        if len(slots) % m != 0:
            raise ValueError(f"{len(slots)} slots not divisible by model_axis {m}")
        r = len(slots) // m
        if self.job.global_batch % r != 0:
            raise ValueError(f"global_batch {self.job.global_batch} not "
                             f"divisible by {r} replicas")
        return r

    def _ensure_step_state(self, slots: Sequence[Slot], bounds) -> bool:
        """Install the per-R step state of ``slots``, built from the shard
        ``bounds`` or taken from the cache; True on a cache hit."""
        key = tuple(s.id for s in slots)
        hit = key in self._step_cache
        if not hit:
            self._step_cache[key] = {"slots": list(slots),
                                     "bounds": list(bounds)}
        state = self._step_cache[key]
        self.slots, self._bounds = state["slots"], state["bounds"]
        return hit

    def _shard_bounds(self, r: int) -> list:
        return [self.stream.shard_bounds(i, r) for i in range(r)]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- train step -------------------------------------------------------------
    def step(self) -> dict:
        follow_profiler(self.device)
        with span("trainer.step", self.step_idx):
            with span("trainer.batch"):
                batch_np = self.stream.global_batch_at(self.step_idx)
                # tokens and labels as long; an encoder-decoder model's float32
                # enc_embeds as they are (the model casts them to its dtype)
                batch = {k: torch.from_numpy(v).to(self.device, None if v.dtype.kind == "f"
                                                  else torch.long)
                         for k, v in batch_np.items()}
                n_tokens = float((batch_np["labels"] >= 0).sum())
                denom = max(n_tokens, 1.0)
                shards = [{k: v[lo:hi] for k, v in batch.items()} for lo, hi in self._bounds]
            if self._has_moe:
                parts = []
                for i, shard in enumerate(shards):
                    with span("trainer.forward", attrs={"shard": i}):
                        parts.append(M.loss_terms(self.cfg, self.params, shard))
                with span("trainer.backward"):
                    # per layer: (psum, counts) summed over the shards, in slot order
                    moe_stats = [tuple(sum(t) for t in zip(*layer))
                                 for layer in zip(*(stats for _, _, stats in parts))]
                    aux = M.aux_loss(self.cfg, moe_stats, batch["tokens"].numel(),
                                     self.device)
                    loss_sum = sum(ls for ls, _, _ in parts)
                    (loss_sum / denom + aux).backward()
                    loss_sum, aux = loss_sum.detach(), aux.detach()
                    del parts, moe_stats
            else:
                loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
                for i, shard in enumerate(shards):
                    with span("trainer.forward", attrs={"shard": i}):
                        ls, _, _ = M.loss_terms(self.cfg, self.params, shard)
                    with span("trainer.backward", attrs={"shard": i}):
                        (ls / denom).backward()
                        loss_sum += ls.detach()
                aux = torch.zeros((), dtype=torch.float32, device=self.device)
            with span("trainer.optimizer"):
                lr = warmup_cosine(self.step_idx, peak_lr=self.job.peak_lr,
                                   warmup_steps=self.job.warmup_steps,
                                   total_steps=self.job.total_steps)
                # no local names the gradients: a first step's frame can outlive
                # it in a reference cycle (lazy imports), and would hold them
                om = adamw_update(self.adamw, tree_map(lambda p: p.grad, self.params),
                                  self.opt_state, self.params, lr)
                for p in tree_leaves(self.params):
                    p.grad = None
            with span("trainer.metrics"):
                xent = loss_sum / denom
                self.step_idx += 1
                metrics = {"loss": float(xent + aux), "xent": float(xent),
                           "aux": float(aux), "tokens": n_tokens,
                           **{k: float(v) for k, v in om.items()},
                           "step": self.step_idx, "replicas": self.replicas}
                self.metrics_log.append(metrics)
        return metrics

    @property
    def done(self) -> bool:
        return self.step_idx >= self.job.total_steps

    def rescale(self, slots: Sequence[Slot], *, via_host: bool = None
                ) -> RescaleTimings:
        """Shrink or expand onto ``slots`` (paper §3.1 shrink/expand).

        ``via_host=None`` picks the path: when any current slot survives into
        the target set the state stays resident (p2p lane); a disjoint target
        goes through a host snapshot (host lane).  The host lane's snapshot
        always goes through the fused pack kernel."""
        slots = list(slots)
        r = self.validate_devices(slots)
        if via_host is None:
            via_host = surviving_devices(self.slots, slots) == 0
        t = RescaleTimings(path="host" if via_host else "p2p")
        follow_profiler(self.device)
        with span("trainer.rescale", self.step_idx):
            with timed("rescale.load_balance") as stage:
                bounds = self._shard_bounds(r)
            t.load_balance = stage.seconds

            host = None
            if via_host:
                with timed("rescale.checkpoint") as stage:
                    host = {"params": snapshot_to_host(self.params, fused=True),
                            "opt": snapshot_to_host(self.opt_state, fused=True)}
                t.checkpoint = stage.seconds

            with timed("rescale.restart") as stage:
                self._ensure_step_state(slots, bounds)
            t.restart = stage.seconds

            if via_host:           # the p2p lane leaves the state resident
                with timed("rescale.restore") as stage:
                    self.params = restore_from_host(host["params"], self.params,
                                                    self.device)
                    self.opt_state = restore_from_host(host["opt"], self.opt_state,
                                                       self.device)
                    self._sync()
                t.restore = stage.seconds
                with span("rescale.free"):          # the pinned snapshot
                    del host

        self.rescale_log.append(t)
        return t

    # -- fault tolerance (paper §3.2.2) ----------------------------------------
    def state_tree(self) -> dict:
        return {"params": self.params, "opt": self.opt_state,
                "step": torch.tensor(self.step_idx, dtype=torch.int32,
                                     device=self.device)}

    def save_disk(self, store, job_id: str, *, delta: bool = False,
                  fused: bool = False) -> float:
        return store.save(job_id, self.step_idx, self.state_tree(),
                          meta={"replicas": self.replicas}, delta=delta,
                          fused=fused)

    def save_disk_async(self, store, job_id: str, *, delta: bool = True,
                        fused: bool = False) -> None:
        """Copy the state to host now, write it to disk in the background.

        Returns once the host copy is complete, so ``step()`` may run at
        once: its in-place updates cannot reach the checkpoint.  Call
        ``ckpt_barrier()`` before the job's slots are released (preempt) so
        ``latest_step`` is a fully published checkpoint."""
        if self._async_ckpt is None or self._async_ckpt.store is not store:
            if self._async_ckpt is not None:
                self._async_ckpt.close()
            self._async_ckpt = AsyncCheckpointer(store, delta=delta)
        self._async_ckpt.delta = delta
        self._async_ckpt.submit(job_id, self.step_idx, self.state_tree(),
                                meta={"replicas": self.replicas}, fused=fused)

    def ckpt_barrier(self) -> None:
        """Join all pending async checkpoint writes (preempt-time barrier)."""
        if self._async_ckpt is not None:
            self._async_ckpt.barrier()

    def restore_disk(self, store, job_id: str) -> int:
        """Restart from the latest disk checkpoint (written by the port or by
        the JAX package)."""
        flat, manifest = store.load(job_id)
        tree = restore_from_host(flat, self.state_tree(), self.device)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step_idx = int(manifest["step"])
        return self.step_idx
