#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero, and
without a CUDA device the script exits non-zero before printing a result:

1. the card (``nvidia-smi --query-gpu=name,power.limit``);
2. the build of every ``src/repro_torch/csrc/*.cu`` (one nvcc per source,
   all started together, with ``-Xptxas -v``): each kernel's registers,
   spill bytes and shared memory from ptxas, and, where a source exports
   them, its registers, local bytes, shared bytes and resident blocks per SM
   from the runtime; then the Triton JIT;
3. each hand-written kernel against its plain PyTorch version on the card at
   the main path's shapes, in float32 (the paths' type) and, for flash
   attention and the SSD scan, in bf16: error, kernel / plain / library ms
   (CUDA events), the least time the card could take (bound), its share
   (of_bound = bound / kernel) and the achieved TFLOP/s; for the SSD scan,
   the device ms of each of its three launches (torch.profiler); flash
   attention and the parameters' pack also at phase 11's granite-moe shapes,
   flash attention and the SSD scan also at phase 12's prefill shapes and
   at phase 14's jamba prefill (group 4; 128 SSM heads of d_state 16),
   flash attention at phase 15's seamless training shard and prefill (group
   1, head dim 64), the pack at phases 13's, 14's and 15's training
   snapshots; the ragged expert products in their three forms (forward,
   input gradient, weight gradient) at one granite-moe MoE layer's shard
   at R=4, with counts falling as 1/rank from the capacity, against
   ``torch.bmm`` over the padded slot layout (their plain version and
   library call), their bound from the kept rows' operations;
4. the main paths, each an ElasticTrainer at global batch 8 x 2048 on 4
   logical replicas, stepped, shrunk to 2 on the host lane, stepped,
   expanded to 4 on the p2p lane, stepped; launch counts are zeroed just
   before each path and read just after it; then one more step under
   ``torch.profiler`` (device busy share, kernels by device time).  First
   yi-6b at full width with depth cut to 4 layers, then mamba2-1.3b at its
   full published size (48 layers, 1,344,052,224 parameters);
5. a static vs rescaled trajectory check at depth 1, for each path and for
   granite-moe-3b-a800m (whose load-balance loss is the global batch's at
   every replica count), deepseek-v2-236b (its dense MLA prefix layer),
   jamba-v0.1-52b (its layer 0: Mamba-2 and a dense SwiGLU) and
   seamless-m4t-large-v2 (one encoder and one decoder layer);
6. ``repro_torch.launch.train --smoke`` on the card with ``--rescale-at``,
   ``--checkpoint-dir`` and ``--restart``, for each arch the port builds
   (SwiGLU, GELU, squared ReLU, qk_norm, MoE, MLA, Mamba-2, jamba's
   hybrid block and seamless's encoder-decoder);
7. the live operator (``ElasticClusterController``) at full width, with
   the launch counts zeroed before the phase and read after it: scenario A
   (priority shrink and expand-back of two yi-6b depth-4 jobs on 8 logical
   slots, then the low job's static run, losses within ``TRAJ_LOSS_TOL``)
   and scenario B (a Mamba-2 victim at depth 8 beside a yi-6b neighbor on
   two nodes of 4: a fused async checkpoint under an in-place step, a node
   failure and restart from disk, a drain migration on the host lane).  The
   ``[operator]`` lines give each rescale's stages and path, each
   scenario's ``ScheduleMetrics.row()``, peak memory, live trainers and
   seconds, and the launches against those the steps imply.  Each scenario
   runs under the port's ``Tracer``, writing a JSONL trace;
8. the policy simulator (paper C3) on the host, ``[simulator]`` lines: the
   port's auditor over both phase-7 traces (zero violations), with their
   phase reconciliation, causal chains and text Gantt; Table 1's simulation
   columns at the paper's size (64 slots, 16 Jacobi jobs, seed 7, gap 90 s,
   T_rescale_gap 180 s) for the four variants and ``elastic_preempt``,
   traced and audited, the four variants held to
   ``tests/golden/schedule_metrics.json`` (integers exactly, floats to a
   relative ``GOLDEN_RTOL``); the Fig. 7 and Fig. 8 sweeps at the
   benchmarks' grids (every job completes); the event loop's retired
   events/s on the bench_simcore rungs and the self-profiler's cost per
   event kind; and the H100 ``ArchScalingModel``'s one-card fp32 step
   prediction beside phase 4's measured steady R=4 step;
9. bfloat16 on the host lane, ``[bf16]`` lines: phase 4's yi-6b job with
   ``dtype="bfloat16"`` (the bf16 flash instantiation on every layer), two
   steps at R=4 (the first loss, before any update, held to phase 4's
   float32 first loss within one bf16 rounding step), a fused host snapshot
   held byte for byte against the device state, a host-lane shrink to R=2
   through the pack kernel's 2-byte instantiation whose restored state is
   held against the snapshot, a step, a fused ``save_disk``, a step, a
   fused delta ``save_disk`` (fewer bytes), and a restart from disk held
   against the saved step; step times at R=4 and R=2, the rescale stages,
   peak memory and the launches by dtype, zeroed before the phase and
   checked after it;
10. the cloud layer and the trace workloads on the host, ``[cloud]`` lines:
    Table 2's 18 cells (policy x provisioning x market) through
    ``CloudSimulator``, the two golden cells held to the fixture as in
    phase 8, and the verdict row (autoscaled elastic cheaper than
    static-max at a WMCT ratio under 1.5), which must say PASS; both
    fixture traces characterized and replayed through every entry of
    ``REPLAY_VARIANTS`` and through ``replay_cloud`` with a
    ``NodeAutoscaler``, traced, audited with zero violations, every job
    completed; and bench_simcore's fleet smoke row (20,000 jobs on 10,000
    slots over 3 days, bounded-memory mode) held to ``BENCH_simcore.json``
    (counters exactly, utilization to ``GOLDEN_RTOL``), with its wall time
    and jobs/s;
11. the MoE path, ``[moe]`` lines: granite-moe-3b-a800m at its full
    published size (32 layers, d_model 1536, 24 heads, 8 KV heads, 40
    experts top-8 of 512, tied 49,408-row embedding; 3,299,182,080
    parameters, 881,690,112 active) in float32 through phase 4's sequence at
    the operator's peak rate, launch counts zeroed before and read after:
    every loss and aux finite, aux above 0, flash launches 2 x 32 x 20, pack
    launches on the host lane, the restored state byte for byte the snapshot
    it was restored from, peak memory under 80 GB; step s, tokens/s, rescale
    stages, peak memory and host RAM, one more step under ``torch.profiler``,
    and the H100 arch model (active parameters) beside the measured step;
12. serving, ``[serve]`` lines: yi-6b at its full 32 layers, then
    mamba2-1.3b at its full 48, in float32, each prefilling a batch of 8
    prompts of 2048 tokens and decoding 64 tokens (63 steps) through the
    port's ``prefill`` / ``pad_cache`` / ``decode_step``, launch counts
    zeroed before the prefill and before the decode loop and read after
    each (flash 32 or SSD 48 a prefill, none in decode): prefill s and
    tokens/s against the reference's FLOP count (``utils.flops.fwd_flops``)
    and the fp32 peak, decode ms a step and tokens/s against the step's
    byte bound, the device idle share of a prefill and of a decode step
    (``torch.profiler``), peak memory, and the decode logits held to the
    training forward's at the generated positions (teacher forcing); then
    ``python -m repro_torch.launch.serve --smoke`` on the card for yi-6b,
    granite-moe-3b-a800m, mamba2-1.3b, deepseek-v2-236b, jamba-v0.1-52b and
    seamless-m4t-large-v2 (random encoder frames);
13. multi-head latent attention, ``[mla]`` lines: deepseek-v2-236b at its
    full published width (d_model 5120, 128 heads, q/kv lora 1536/512,
    qk 128+64, v 128, 160 routed experts top-6 and 2 shared of 1536, vocab
    102,400).  (a) Its training job cut to depth 1, the dense prefix layer
    alone (1,386,562,560 parameters), through phase 4's sequence at the
    operator's peak rate, as phase 11 runs granite: every loss finite, the
    first near ln 102400, aux 0 (no MoE layer), no flash launch, the pack
    kernel once a dtype group of the host-lane snapshot, the restored state
    byte for byte the snapshot; step s, tokens/s, rescale stages, peak
    memory, a profiled step and the arch model beside the step.  (b) Served
    with the prefix layer and 3 MoE layers (13,302,912,000 parameters) at
    phase 12's batch, prompt and generation, decode absorbed (W_UK folded
    into the query, scores against the latent cache): prefill and decode
    times against the reference FLOPs and the byte bound, idle shares,
    peak memory, no kernel launch; its first decode step also through the
    unabsorbed form from the same cache, the logits held together within
    ``SERVE_TF_TOL`` scaled, peak memory under ``SERVE_PEAK``.  (c) Teacher
    forcing at full width under the dense MoE: one prompt of 32 tokens, 16
    decode steps;
14. the hybrid layout, ``[hybrid]`` lines: jamba-v0.1-52b at its full
    published width (d_model 4096, 32 heads with 8 KV heads of 128, d_ff
    14,336, 16 experts top-2 of 14,336, Mamba-2 of d_state 16 and head dim
    64 in 128 heads, vocab 65,536), in period-8 blocks: Mamba-2 mixers with
    attention at sub3, MoE on the odd subs, dense SwiGLU on the even ones.
    (a) Its training job cut to depth 1, layer 0 alone (the Mamba-2 mixer
    and a dense SwiGLU, 814,412,320 parameters), through phase 4's sequence
    as phase 13(a) runs deepseek's: every loss finite, the first near ln
    65536, aux 0, the SSD scan twice a replica-step (40), no flash launch,
    the pack {float32: 2, int32: 1}, the restore byte-exact, the profile
    and the arch model beside the step.  (b) Served at depth 8, one whole
    period (13,267,656,416 parameters, 53.07 GB in float32), at phase 12's
    sizes: flash once and the SSD scan 7 times a prefill, none a decode
    step, prefill and decode against the reference FLOPs and the byte
    bound, idle shares, peak memory under ``SERVE_PEAK``.  (c) Teacher
    forcing at full width under the dense MoE, as phase 13(c);
15. the encoder-decoder layout, ``[encdec]`` lines: seamless-m4t-large-v2
    at its full published size (24 encoder and 24 decoder layers, d_model
    1024, 16 heads of 64, GELU d_ff 8192, tied 256,256-row embedding;
    1,369,827,328 parameters), through the same function.  (a) Its
    training job, the encoder reading 2048 float32 frames a sequence,
    through phase 4's sequence: every loss finite, the first near ln
    256206, aux 0, flash 2 x 24 x R a step (the decoder's causal
    self-attention, forward and recompute; the encoder's bidirectional
    attention and the cross attention go through the blocked twin), pack
    {float32: 2, int32: 1}, the restore byte-exact, the profile and the
    arch model beside the step.  (b) Served at phase 12's sizes with 2048
    random frames a prompt: flash 24 a prefill, none a decode step, prefill
    against the reference FLOPs (encoder included), decode against the
    byte bound (no encoder weight and no cross ``wk``/``wv``, the cross
    cache read once), idle shares, peak memory under ``SERVE_PEAK``.  (c)
    Teacher forcing on that serving run, with the same frames;
16. the dry-run, ``[dryrun]`` lines (``launch.dryrun`` and
    ``launch.cells``, nothing allocated on the card): (a) every applicable
    (arch x shape) cell of ``all_cells()``, 10 archs at their full
    published sizes, traced on the meta device on the card's 1x1 mesh in
    spawned worker processes: argument, temp and peak GB, ``fits_hbm``
    (80 GB), the traced FLOPs (``FlopCounterMode`` and the kernel wrappers'
    notes) against ``utils.flops.cell_flops``, the H100 roofline's
    bottleneck and ``mfu_bound``; (b) the per-device argument GB of every
    cell on the reference's 16x16 and 2x16x16 meshes, from the sharding
    rules; (c) the live-bytes tracker against the allocator: four reduced
    cells at full width (seamless-m4t-large-v2 and granite-moe-3b-a800m
    trained, yi-6b and mamba2-1.3b prefilled, float32, batch 8 x 2048)
    traced on meta and then run for real under the same tracker, the meta
    peak within 10% of ``torch.cuda.max_memory_allocated()`` (less what was
    resident before the cell's arguments), the real runs' flash and SSD
    launches checked against their layers.

The last lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Each kernel record names the main path
whose shapes it was measured at and the launch count it reads (``kernel``,
by ``dtype``), and holds its launches on that path, and its launches on the
operator path (``operator_launches``); the pack kernel,
which runs on every path, has one record per path (``pack_bf16`` is its
2-byte instantiation on phase 9's path, ``yi-6b-bf16``, as
``flash_attention_bf16`` is flash attention's); the bf16 SSD
instantiation, on no path, has a record of its own with ``"path": null``
and 0 launches; ``flash_attention_granite`` and ``pack_granite`` are flash
attention and the parameters' pack at phase 11's shapes, on its path
``granite-moe-3b-a800m``; ``flash_attention_serve`` and ``ssd_serve`` are
the two kernels at phase 12's prefill shapes (batch 8), on its paths
``yi-6b-serve`` and ``mamba2-1.3b-serve``; ``pack_deepseek`` is the pack of
phase 13's host-lane snapshot, on its path ``deepseek-v2-236b``;
``flash_attention_jamba`` and ``ssd_jamba`` are the two kernels at phase
14's prefill shapes, on its path ``jamba-v0.1-52b-serve``, and
``pack_jamba`` is the pack of phase 14's training snapshot, on its path
``jamba-v0.1-52b``; ``flash_attention_seamless`` is flash attention at one
replica's shard of phase 15's training job, on its path
``seamless-m4t-large-v2``, ``flash_attention_seamless_serve`` at its
prefill, on ``seamless-m4t-large-v2-serve``, and ``pack_seamless`` the pack
of its training snapshot; ``moe_gemm``, ``moe_gemm_dx`` and ``moe_gemm_dw``
are the ragged expert products' three forms at phase 11's shapes, on its
path ``granite-moe-3b-a800m``.
"""
import contextlib
import dataclasses
import gc
import json
import math
import multiprocessing
import os
import re
import resource
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# keep Triton's compile cache inside the checkout's ignored build directory
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))

from repro_torch.checkpoint import (DiskCheckpointStore, flatten_tree,  # noqa: E402
                                    restore_from_host, snapshot_to_host)
from repro_torch.checkpoint.reshard import host_tensor  # noqa: E402
from repro_torch.cloud import (SPOT, AutoscalerConfig, CloudProvider,  # noqa: E402
                               CloudSimulator, NodeAutoscaler, NodePool)
from repro_torch.configs import ATTN, FF_MOE, SSM, get_config  # noqa: E402
from repro_torch.configs.base import FF_SWIGLU, ShapeConfig  # noqa: E402
from repro_torch.core import elastic  # noqa: E402
from repro_torch.core import (ElasticClusterController, ElasticTrainer,  # noqa: E402
                              JobSpec, JobStatus, PolicyConfig,
                              PreemptingPolicy, TrainJobConfig, VARIANTS,
                              jacobi_workload, local_slots, make_jacobi_jobs,
                              run_variant)
from repro_torch.core.perf_model import (H100_HBM_BW,  # noqa: E402
                                         H100_PEAK_FLOPS_BF16,
                                         H100_PEAK_FLOPS_FP32,
                                         arch_model_from_config)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.moe_gemm import (NN, NT, TN, ragged_gemm,  # noqa: E402
                                          ragged_gemm_ref, rows_computed)
from repro_torch.kernels.pack import pack_leaves  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_fwd  # noqa: E402
from repro_torch.launch import cells as dry_cells  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_card_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.moe import moe_impl, set_moe_impl  # noqa: E402
from repro_torch.models.transformer import set_mla_absorb  # noqa: E402
from repro_torch.obs import (SimProfiler, Tracer, build_span_graph,  # noqa: E402
                             install, install_profiler)
from repro_torch.obs.audit import audit_records  # noqa: E402
from repro_torch.obs.critical_path import reconcile  # noqa: E402
from repro_torch.obs.spans import render_chains  # noqa: E402
from repro_torch.obs.timeline import render_last_run  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.utils.flops import cell_flops, decode_flops, fwd_flops  # noqa: E402
from repro_torch.workloads import (LOADERS, REPLAY_VARIANTS,  # noqa: E402
                                   ReplayConfig, characterize, fixture_path,
                                   google_fleet_trace, replay_cloud,
                                   replay_variant)

# H100 SXM peaks (NVIDIA data sheet, dense): float32 outside the tensor cores,
# bf16 tensor cores, HBM3 bandwidth; the perf model's constants
PEAK_FLOPS = {torch.float32: H100_PEAK_FLOPS_FP32, torch.bfloat16: H100_PEAK_FLOPS_BF16}
PEAK_BYTES = H100_HBM_BW

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the ragged expert products against torch.bmm: both sum in float32, in
# different orders, terms of order 1/sqrt(K) (tests/test_torch_cuda_kernels.py)
MOE_GEMM_TOL = 1e-4
RMSNORM_TOL = 1e-5
# atol = rtol, the reference's own SSD tolerances (tests/test_kernels.py:79)
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
MAMBA2_PARAMS = 1_344_052_224
# phase 4's job and the replicas of its six steps (R=4, host-lane shrink to
# 2, p2p expand to 4)
MAIN_JOB = dict(global_batch=8, seq_len=2048, total_steps=6, seed=0)
MAIN_REPLICAS = (4, 4, 2, 2, 4, 4)
# static vs rescaled at full width on the card: the shards of R=4 and R=2 are
# products of different shapes, for which cuBLAS may pick kernels that sum in
# another order; AdamW's m/sqrt(v) turns a rounding difference in a gradient
# near eps into a visible step, so params get a looser bound than losses
TRAJ_LOSS_TOL = 1e-4
TRAJ_PARAM_TOL = 1e-3
# the operator's Mamba-2 victim: full width, 8 of the 48 layers (about 3.1e8
# parameters), so its checkpoints stay a few GB and it fits beside a yi-6b job
OPERATOR_MAMBA2_LAYERS = 8
# the operator's full-width jobs train at a peak rate of 3e-4, LLaMA 2's for
# its 7B decoder (arXiv:2307.09288, table 1); TrainJobConfig's default 3e-3
# is sized for the smoke configs and makes the full-width yi-6b loss climb
# (11.48 to 13.93 over 10 steps on an NVIDIA H100 80GB HBM3 at 700 W), which
# amplifies the rounding differences between replica counts past
# TRAJ_LOSS_TOL
OPERATOR_JOB = dict(global_batch=8, seq_len=2048, peak_lr=3e-4)
# phase 8: the JAX package's committed Table 1 simulation metrics.  The
# reference itself differs from them in the last bit of a float on some
# machines, so floats are held to a relative 1e-9, integers exactly
GOLDEN = os.path.join(ROOT, "tests", "golden", "schedule_metrics.json")
GOLDEN_RTOL = 1e-9
# the paper's Table 1 cell and the benchmarks' grids
# (benchmarks/fig7_submission_gap.py, fig8_rescale_gap.py, bench_simcore.py)
TABLE1 = dict(seed=7, n_jobs=16, submission_gap=90.0, total_slots=64, rescale_gap=180.0)
TABLE1_VARIANTS = VARIANTS + ("elastic_preempt",)
FIG_SEEDS = tuple(range(12))
FIG7_GAPS = (0, 30, 60, 90, 120, 180, 240, 300)
FIG8_TGAPS = (0, 60, 180, 300, 600, 900, 1200)
FIG8_VARIANTS = ("elastic", "moldable", "rigid_min")
SIMCORE_JOBS = (16, 32, 64, 128)
SIMCORE_REPEATS = 7
# phase 9: phase 4's yi-6b job in bfloat16 (parameters, activations and the
# bf16 flash instantiation; AdamW's moments stay float32), named as a path.
# It trains at the operator's peak rate, phase 7's for the same full-width
# job in float32.  Its first loss, taken before any update, is phase 4's
# float32 first loss on the same batch from the same initial values rounded
# to bf16: held to it within one bf16 rounding step of the loss (8
# significant bits)
BF16_PATH = "yi-6b-bf16"
BF16_JOB = dict(MAIN_JOB, dtype="bfloat16", peak_lr=OPERATOR_JOB["peak_lr"])
BF16_LOSS_RTOL = 2.0 ** -8
# phase 10: Table 2 (benchmarks/table2_cloud_cost.py), restated here because
# the card's machine has no JAX: the 16-job small/medium Jacobi stream on
# 8-slot nodes, at most 8 nodes (the paper's 64 slots), on-demand $0.048 and
# spot $0.016 a slot-hour
T2_PRICE_OD = 0.048
T2_PRICE_SPOT = 0.016
T2_SLOTS_PER_NODE = 8
T2_MAX_NODES = 8
T2_POLICIES = ("moldable", "elastic", "elastic_preempt")
T2_PROVISIONING = ("static_max", "static_min", "autoscaled")
T2_MARKETS = ("on_demand", "spot30")
T2_GOLDEN = (("elastic", "static_max", "on_demand"), ("elastic", "autoscaled", "spot30"))
# the fixture traces through the simulator and the cloud simulator
# (benchmarks/table4_traces.py's cluster: 8 nodes of 8 slots at $0.048)
TRACE_FIXTURES = (("google", "google_sample.csv"), ("azure", "azure_sample.csv"))
T4_CLUSTER_SLOTS = 64
# bench_simcore.py's fleet smoke row: a Google-shape trace of 20,000 jobs
# over 3 days on 1,250 nodes of 8 slots (10,000 slots), elastic, T_rescale_gap
# 1800 s, bounded-memory mode; its committed counters are BENCH_simcore.json's
FLEET_SMOKE = dict(n_jobs=20_000, seed=3, days=3.0, nodes=1_250, slots_per_node=8)
FLEET_RESCALE_GAP = 1800.0
BENCH_SIMCORE = os.path.join(ROOT, "BENCH_simcore.json")
FLEET_EXACT = ("events", "stale_events", "completions", "rescales", "dropped_jobs")
# phase 11: granite-moe-3b-a800m at its full published size, in float32 at
# phase 4's batch and replicas and the operator's peak rate
GRANITE = "granite-moe-3b-a800m"
GRANITE_PARAMS = 3_299_182_080
GRANITE_ACTIVE_PARAMS = 881_690_112
MOE_JOB = dict(MAIN_JOB, peak_lr=OPERATOR_JOB["peak_lr"])
CARD_MEMORY = 80e9
# the archs whose CLI smoke runs in phase 6 besides phase 4's paths
CLI_ARCHS = ("granite-moe-3b-a800m", "yi-9b", "starcoder2-7b", "minitron-4b",
             "chameleon-34b", "deepseek-v2-236b", "jamba-v0.1-52b",
             "seamless-m4t-large-v2")
# phase 12: serving at full published size in float32 (the reference's
# serve CLI forces it): a batch of 8 prompts of 2048 tokens, 64 generated
# tokens (63 decode steps); the decode logits are held to the training
# forward's at the generated positions within the reference's 2e-4
# (tests/test_models.py), scaled by max(1, max |logit|)
SERVE = dict(batch=8, prompt=2048, gen=64, seed=0)
SERVE_ARCHS = ("yi-6b", "mamba2-1.3b")
SERVE_TF_TOL = 2e-4
# phase 13: deepseek-v2-236b (MLA, a dense first layer, then layers of 160
# routed experts top-6 and 2 shared) at its full published width.  It trains
# at depth 1, the dense prefix layer alone (1,386,562,560 parameters, 22.2 GB
# of float32 AdamW state; with one MoE layer the state would be 85.7 GB), at
# phase 4's batch and replicas and the operator's peak rate; it serves with
# the prefix layer and 3 MoE layers (13,302,912,000 parameters, 53.2 GB in
# float32) at phase 12's batch, prompt and generation, decode absorbed.  A
# random model's first loss is about ln V (+ 0.5 for unit-variance logits).
# Teacher forcing at full width runs the MoE in its dense form, as the
# reference's test does (the capacity dispatch depends on the batch), on one
# prompt of 32 tokens and 16 decode steps
DEEPSEEK = "deepseek-v2-236b"
DEEPSEEK_TRAIN_LAYERS, DEEPSEEK_TRAIN_PARAMS = 1, 1_386_562_560
DEEPSEEK_SERVE_LAYERS, DEEPSEEK_SERVE_PARAMS = 4, 13_302_912_000
FIRST_LOSS_TOL = 1.0
MLA_TF = dict(batch=1, prompt=32, gen=17)
# phases 13 and 14 serve a model of about 53 GB of float32 weights; its
# transient peak (the MoE dispatch's expert activations at capacity 1.25)
# must leave 4 GB of the card's 80 free
SERVE_PEAK = 76e9
# phase 14: jamba-v0.1-52b at its full published width, in period-8 blocks.
# It trains at depth 1, layer 0 alone (814,412,320 parameters, 13.0 GB of
# float32 AdamW state; at depth 2, 3,734,426,688 parameters, the state is
# 59.8 GB and the host-lane snapshot packs a 29.9 GB moments group into one
# device buffer beside it), at phase 4's batch and replicas and the
# operator's peak rate; it serves one whole period at depth 8
# (13,267,656,416 parameters, 53.07 GB in float32) at phase 12's sizes, and
# teacher forcing runs as phase 13's
JAMBA = "jamba-v0.1-52b"
JAMBA_TRAIN_LAYERS, JAMBA_TRAIN_PARAMS = 1, 814_412_320
JAMBA_SERVE_LAYERS, JAMBA_SERVE_PARAMS = 8, 13_267_656_416
# phase 15: seamless-m4t-large-v2, the encoder-decoder (24 encoder and 24
# decoder layers, d_model 1024, 16 heads of 64, GELU d_ff 8192, a tied
# 256,256-row embedding), at its full published size (21.9 GB of float32
# AdamW state: the card holds it whole, nothing is cut).  It trains at
# phase 4's batch and replicas and the operator's peak rate, its encoder
# reading 2048 frames a sequence (the stream's enc_len = seq_len); it
# serves at phase 12's sizes with 2048 random frames a prompt, and teacher
# forcing runs on that serving run, with the same frames
SEAMLESS = "seamless-m4t-large-v2"
SEAMLESS_PARAMS = 1_369_827_328
SERVE_CLI_ARCHS = ("yi-6b", GRANITE, "mamba2-1.3b", DEEPSEEK, JAMBA, SEAMLESS)
# phase 16: the dry-run.  Every applicable (arch x shape) cell is traced on
# the meta device at its full published size on the card's 1x1 mesh, in
# spawned worker processes on the host's cores (a meta trace runs its ops in
# Python: mamba2-1.3b's train_4k cell alone takes about 90 s); one core stays
# with the card's real runs.  The tracker's peak is held to the allocator's
# (max_memory_allocated less what was resident before the cell's
# arguments) within 10% of the allocator's, on four reduced cells the card
# runs for real in float32 at batch 8 x 2048, as earlier phases run them:
# seamless trained as phase 15 and granite as phase 11 (at full size, one
# global batch a step), yi-6b (32 layers) and mamba2-1.3b (48) prefilled as
# phase 12
DRYRUN_WORKERS = 7
DRYRUN_PEAK_TOL = 0.10
DRYRUN_POD_MESHES = ("pod_16x16", "multipod_2x16x16")
DRYRUN_REAL = ((SEAMLESS, "train_4k"), ("yi-6b", "prefill_32k"),
               ("mamba2-1.3b", "prefill_32k"), (GRANITE, "train_4k"))
DRYRUN_REAL_SHAPE = dict(seq_len=2048, batch=8)


def serve_path(arch):
    return f"{arch}-serve"


# flash attention's phase-3 cases: (record, path, dtype, one replica's shard
# at R=4, or phase 12's, 14's or 15's prefill batch, as (B, S, H, KV,
# head_dim)); seamless's decoder self-attention is group 1 at head dim 64
FLASH_CASES = (("flash_attention", "yi-6b", torch.float32, (2, 2048, 32, 4, 128)),
               ("flash_attention_bf16", BF16_PATH, torch.bfloat16, (2, 2048, 32, 4, 128)),
               ("flash_attention_granite", GRANITE, torch.float32, (2, 2048, 24, 8, 64)),
               ("flash_attention_serve", serve_path("yi-6b"), torch.float32,
                (8, 2048, 32, 4, 128)),
               ("flash_attention_jamba", serve_path(JAMBA), torch.float32,
                (8, 2048, 32, 8, 128)),
               ("flash_attention_seamless", SEAMLESS, torch.float32, (2, 2048, 16, 16, 64)),
               ("flash_attention_seamless_serve", serve_path(SEAMLESS), torch.float32,
                (8, 2048, 16, 16, 64)))
# the SSD scan's phase-3 cases: (record, path, dtype, (B, L, H, P, G, N,
# chunk)): one replica's shard of mamba2-1.3b at R=4, phase 12's prefill,
# and phase 14's jamba prefill (128 heads, d_state 16)
MAMBA2_SSD = (2048, 64, 64, 1, 128, 128)
SSD_CASES = (("ssd", "mamba2-1.3b", torch.float32, (2, *MAMBA2_SSD)),
             ("ssd_bf16", None, torch.bfloat16, (2, *MAMBA2_SSD)),
             ("ssd_serve", serve_path("mamba2-1.3b"), torch.float32, (8, *MAMBA2_SSD)),
             ("ssd_jamba", serve_path(JAMBA), torch.float32, (8, 2048, 128, 64, 1, 16, 128)))


# the ragged expert products' phase-3 shapes: one granite-moe MoE layer's
# shard at R=4 (40 experts, two sequences of capacity 512, d_model 1536,
# expert width 512) as (E, T, D, F), and each expert's kept rows, falling
# as 1/rank from the capacity (25.3% of the slots, as the benchmark's
# Zipf(1) token ids fill 25-27%)
MOE_GEMM_SHAPE = (40, 1024, 1536, 512)
MOE_GEMM_ROWS = tuple(min(1024, 3000 // r) for r in range(1, 41))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def say(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def time_ms(fn, iters, warmup=2, reps=5):
    """Median over ``reps`` rounds of the mean ms of ``iters`` launches
    between CUDA events (the median keeps one slow round, such as a stall
    of the shared host, out of the number)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        rounds.append(start.elapsed_time(end) / iters)
    return sorted(rounds)[len(rounds) // 2]


def dtype_name(dtype):
    return None if dtype is None else str(dtype).split(".")[1]


def record(name, kernel, path, dtype, source, replaces, err, ms, plain, lib, b_ms,
           b_by, flops, route="cuda"):
    """One entry of the kernels line: the kernel's times beside its bound,
    the share of the bound it reaches and its rate.  ``kernel`` and ``dtype``
    name the launch count it reads (``dtype`` None: all of the kernel's)."""
    return {"name": name, "kernel": kernel, "path": path, "dtype": dtype_name(dtype),
            "route": route,
            "source": source, "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "of_bound": b_ms / ms, "tflops": flops / ms / 1e9}


def launches_of(rec, counts):
    """A kernels-line record's launches in ``counts`` ({kernel: {dtype:
    launches}}): those of its dtype, or all of its kernel's where it has none."""
    by_dtype = counts.get(rec["kernel"], {})
    return sum(by_dtype.values()) if rec["dtype"] is None else by_dtype.get(rec["dtype"], 0)


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# -- phase 2 -------------------------------------------------------------------

def build_kernels():
    t0 = time.perf_counter()
    logs = _build.build(force=True)
    wall = time.perf_counter() - t0
    check(set(logs) == set(_build.sources()), f"built {sorted(logs)}")
    for name, info in logs.items():
        say("build", source=f"{name}.cu", seconds=f"{info['seconds']:.1f}")
        kernels = _build.ptxas_report(info["log"])
        check(kernels, f"no ptxas report for {name}.cu")
        for k in kernels:
            say("ptxas", **k)
        for k in _build.kernel_info(name):
            say("kernel_info", **k)
    x = torch.ones((1, 64), device="cuda")
    t1 = time.perf_counter()
    ops.rmsnorm(x, torch.ones(64, device="cuda"))
    torch.cuda.synchronize()
    say("build", nvcc_wall_s=f"{wall:.1f}",
        triton_jit_s=f"{time.perf_counter() - t1:.1f}")


# -- phase 3 -------------------------------------------------------------------

def check_flash(gen):
    recs = []
    for name, path, dtype, (B, S, H, KV, hd) in FLASH_CASES:
        q = torch.randn((B, S, H, hd), device="cuda", generator=gen).to(dtype)
        k = torch.randn((B, S, KV, hd), device="cuda", generator=gen).to(dtype)
        v = torch.randn((B, S, KV, hd), device="cuda", generator=gen).to(dtype)
        out, lse = flash_attention_fwd(q, k, v)
        exp = ref.flash_attention_ref(q.float(), k.float(), v.float()).to(dtype)
        err = float((out.float() - exp.float()).abs().max())
        lse_err = float((lse - ref.attention_lse_ref(q.float(), k.float())).abs().max())
        del exp
        check(math.isfinite(err) and err <= FLASH_TOL[dtype],
              f"flash {name} max_abs_err {err} > {FLASH_TOL[dtype]}")
        check(lse_err <= 1e-4, f"flash {name} lse err {lse_err}")
        ms = time_ms(lambda: flash_attention_fwd(q, k, v), 10)
        plain = time_ms(lambda: ref.flash_attention_ref(q, k, v), 3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 10)
        flops = 4 * hd * B * H * S * (S + 1) // 2      # causal pairs only
        b_ms, b_by = bound(nbytes(q, k, v, out, lse), flops, dtype)
        recs.append(record(
            name, "flash_attention", path, dtype, "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:26", err, ms, plain, lib,
            b_ms, b_by, flops))
        say("kernels", kernel="flash_attention", path=path, dtype=dtype_name(dtype),
            shape=f"B{B}xS{S}xH{H}xKV{KV}xhd{hd}", max_abs_err=err,
            lse_err=lse_err, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=b_ms, bound_by=b_by, of_bound=recs[-1]["of_bound"],
            tflops=recs[-1]["tflops"])
        del q, k, v, out, lse, qt, kt, vt
    return recs


def check_rmsnorm(gen):
    N, D = 8 * 2048, 4096                        # the global batch's rows
    x = torch.randn((N, D), device="cuda", generator=gen)
    w = 1 + 0.1 * torch.randn((D,), device="cuda", generator=gen)
    y = ops.rmsnorm(x, w)
    err = float((y - ref.rmsnorm_ref(x, w)).abs().max())
    check(err <= RMSNORM_TOL, f"rmsnorm max_abs_err {err} > {RMSNORM_TOL}")
    ms = time_ms(lambda: ops.rmsnorm(x, w), 20)
    plain = time_ms(lambda: ref.rmsnorm_ref(x, w), 10)
    lib = time_ms(lambda: torch.nn.functional.rms_norm(x, (D,), w, 1e-5), 20)
    b_ms, b_by = bound(nbytes(x, w, y), 4 * x.numel(), torch.float32)
    say("kernels", kernel="rmsnorm", shape=f"{N}x{D}", max_abs_err=err, ms=ms,
        plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)
    return record("rmsnorm", "rmsnorm", "yi-6b", torch.float32,
                  "src/repro_torch/kernels/rmsnorm.py",
                  "src/repro/kernels/rmsnorm.py:11", err, ms, plain, lib, b_ms,
                  b_by, 4 * x.numel(), route="triton")


def check_moe_gemm(gen):
    """The ragged expert products' three forms at ``MOE_GEMM_SHAPE`` with
    ``MOE_GEMM_ROWS``: the forward's X @ W, the input gradient G @ W^T and
    the weight gradient X^T @ G, each against ``torch.bmm`` over the padded
    layout (the plain version, and the library call), its bound from the
    kept rows' operations."""
    E, T, D, F = MOE_GEMM_SHAPE
    rows = torch.tensor(MOE_GEMM_ROWS, dtype=torch.int32, device="cuda")
    past = torch.arange(T, device="cuda")[None, :, None] >= rows[:, None, None]
    x = torch.randn((E, T, D), device="cuda", generator=gen).masked_fill(past, 0.0)
    w = torch.randn((E, D, F), device="cuda", generator=gen) / D ** 0.5
    gy = torch.randn((E, T, F), device="cuda", generator=gen).masked_fill(past, 0.0)
    kept = sum(MOE_GEMM_ROWS)
    flops = 2 * kept * D * F                       # each form, over the kept rows
    recs = []
    for name, form, a, b in (("moe_gemm", NN, x, w), ("moe_gemm_dx", NT, gy, w),
                             ("moe_gemm_dw", TN, x, gy)):
        out = ragged_gemm(form, a, b, rows)
        err = float((out - ragged_gemm_ref(form, a, b)).abs().max())
        check(math.isfinite(err) and err <= MOE_GEMM_TOL,
              f"{name} max_abs_err {err} > {MOE_GEMM_TOL}")
        ms = time_ms(lambda: ragged_gemm(form, a, b, rows), 10)
        lib = time_ms(lambda: ragged_gemm_ref(form, a, b), 10)
        # the kept rows of the slot operands, the whole weight, the output
        read = nbytes(w) if form != TN else 0
        read += kept * 4 * (a.shape[2] + (b.shape[2] if form == TN else 0))
        b_ms, b_by = bound(read + nbytes(out), flops, torch.float32)
        recs.append(record(name, "moe_gemm", GRANITE, torch.float32,
                           "src/repro_torch/csrc/moe_gemm.cu", None, err, ms, lib, lib,
                           b_ms, b_by, flops))
        say("kernels", kernel="moe_gemm", path=GRANITE, form=name,
            shape=f"E{E}xT{T}xD{D}xF{F}", rows_kept=kept,
            rows_computed=int(rows_computed(rows, T, x)), max_abs_err=err, ms=ms,
            plain_ms=lib, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
            of_bound=recs[-1]["of_bound"], tflops=recs[-1]["tflops"])
        del out
    return recs


def pack_groups(cfg, gen, dtype=None):
    """The leaf lists that the host-lane shrink of ``cfg``'s trainer packs,
    one per pack launch, grouped as ``packed_snapshot_to_host`` groups them:
    the float32 parameters, the float32 AdamW moments and the int32 step
    count, the moments and count filled so the bytes compared are not all
    zero.  With ``dtype``, only the parameters' group, in that dtype."""
    params = M.init_params(cfg.with_(dtype=dtype_name(dtype) or TrainJobConfig.dtype), 0,
                           device="cuda")
    if dtype is not None:
        return [[t.detach() for t in flatten_tree(params).values()]]
    opt = adamw_init(params)
    for t in flatten_tree(opt).values():
        if t.is_floating_point():
            t.normal_(generator=gen)
        else:
            t.fill_(2)
    groups = []
    for tree in (params, opt):
        by_dtype = {}
        for t in flatten_tree(tree).values():
            by_dtype.setdefault(t.dtype, []).append(t.detach())
        groups += by_dtype.values()
    return groups


def check_pack(cfg, gen, name, path, dtype=None):
    """The pack kernel on each leaf list of ``cfg``'s host-lane shrink on
    ``path`` (``pack_groups``; with ``dtype``, that group alone): byte
    equality with ``pack_leaves_ref``, and the times of the launches (sums
    of each launch's median), as the kernels-line record ``name``."""
    ms = plain = 0.0
    moved = 0
    groups = pack_groups(cfg, gen, dtype)
    for leaves in groups:
        out = pack_leaves(leaves)
        exp = ref.pack_leaves_ref(leaves)
        same = out.shape == exp.shape and torch.equal(out.view(torch.uint8),
                                                      exp.view(torch.uint8))
        check(same, f"{cfg.name}: pack of {len(leaves)} {leaves[0].dtype} leaves "
              "is not byte-identical to pack_leaves_ref")
        del exp
        g_ms = time_ms(lambda: pack_leaves(leaves), 5, warmup=1)
        g_plain = time_ms(lambda: ref.pack_leaves_ref(leaves), 3, warmup=1)
        say("kernels", kernel="pack", path=path, dtype=dtype_name(leaves[0].dtype),
            leaves=len(leaves), gb=f"{nbytes(*leaves) / 1e9:.3f}", byte_identical=same,
            ms=g_ms, plain_ms=g_plain)
        ms, plain, moved = ms + g_ms, plain + g_plain, moved + nbytes(*leaves, out)
        del out
    b_ms, b_by = bound(moved, 0, torch.float32)
    say("kernels", kernel="pack", path=path, launches_per_snapshot=len(groups),
        gb_moved=f"{moved / 1e9:.3f}", ms=ms, plain_ms=plain, library_ms=None,
        bound_ms=b_ms, bound_by=b_by)
    del groups
    return record(name, "pack", path, dtype, "src/repro_torch/csrc/pack.cu",
                  "src/repro/kernels/pack.py:40", 0.0, ms, plain, None, b_ms, b_by, 0)


def kernel_times(prof):
    """{kernel name: (launches, device ms)} from a finished profile, summed
    over the raw events: a Mamba-2 step launches hundreds of thousands of
    kernels, too many for ``key_averages()`` to group in the time limit."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            n, ms = by_name.get(e.name(), (0, 0.0))
            by_name[e.name()] = (n + 1, ms + e.duration_ns() / 1e6)
    return by_name


def device_ms_by_kernel(fn, n=5):
    """Device ms of each kernel that ``fn`` launches, per call, over ``n``
    calls under ``torch.profiler`` (device activity only)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {name: ms / n for name, (_, ms) in kernel_times(prof).items()}


def _ssd_inputs(gen, B, L, H, P, G, N, dtype, dt_shift=0.0):
    """The reference kernel test's distributions (tests/test_kernels.py),
    with dt = softplus(N(0,1) + dt_shift)."""
    x = (0.5 * torch.randn((B, L, H, P), device="cuda", generator=gen)).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, L, H), device="cuda", generator=gen) + dt_shift)
    a_log = torch.log(1 + 7 * torch.rand((H,), device="cuda", generator=gen))
    b = (0.3 * torch.randn((B, L, G, N), device="cuda", generator=gen)).to(dtype)
    c = (0.3 * torch.randn((B, L, G, N), device="cuda", generator=gen)).to(dtype)
    return x, dt, a_log, b, c


def _ssd_err(out, exp, tol):
    """(max |out - exp|, max |out - exp| / (tol + tol * |exp|)): the check is
    the reference's ``assert_allclose(atol=tol, rtol=tol)``, which passes
    while the second number is at most 1."""
    diff = (out.float() - exp.float()).abs()
    return float(diff.max()), float((diff / (tol + tol * exp.float().abs())).max())


def check_ssd(gen):
    recs = []
    for name, path, dtype, (B, L, H, P, G, N, Q) in SSD_CASES:
        args = _ssd_inputs(gen, B, L, H, P, G, N, dtype)
        y = ssd_scan_fwd(*args, chunk=Q)
        err, frac = _ssd_err(y, ref.ssd_chunked_ref(*args, chunk=Q), SSD_TOL[dtype])
        check(frac <= 1.0, f"ssd {dtype} max_abs_err {err}: {frac} of the "
              f"allowance atol=rtol={SSD_TOL[dtype]}")
        ms = time_ms(lambda: ssd_scan_fwd(*args, chunk=Q), 10)
        phases = {re.search(r"ssd_\w+_kernel", kname).group(0): t for kname, t in
                  device_ms_by_kernel(lambda: ssd_scan_fwd(*args, chunk=Q)).items()}
        check(len(phases) == 3, f"ssd launched {sorted(phases)}, not three phases")
        say("kernels", kernel="ssd", path=path, dtype=dtype_name(dtype),
            phases_device_ms=json.dumps({k: round(v, 4) for k, v in phases.items()}
                                        ).replace(" ", ""))
        plain = time_ms(lambda: ref.ssd_chunked_ref(*args, chunk=Q), 3, warmup=1)
        # causal pairs only; the C.B^T scores once a group (its heads share
        # them), then a head's masked scores times x and its state terms
        pairs = Q * (Q + 1) // 2
        flops = B * (L // Q) * (G * 2 * pairs * N + H * (2 * pairs * P + 4 * Q * N * P))
        b_ms, b_by = bound(nbytes(*args, y), flops, dtype)
        recs.append(record(
            name, "ssd", path, dtype, "src/repro_torch/csrc/ssd_scan.cu",
            "src/repro/kernels/ssd_scan.py:24", err, ms, plain, None, b_ms, b_by, flops))
        say("kernels", kernel="ssd", path=path, dtype=dtype_name(dtype),
            shape=f"B{B}xL{L}xH{H}xP{P}xG{G}xN{N}xQ{Q}", max_abs_err=err,
            atol_rtol=SSD_TOL[dtype], of_allowance=frac, ms=ms, plain_ms=plain,
            library_ms=None, bound_ms=b_ms, bound_by=b_by, flops=flops,
            bytes=nbytes(*args, y), of_bound=recs[-1]["of_bound"],
            tflops=recs[-1]["tflops"])
        del args, y
    # long memory: dt about 0.004 (the low end of Mamba-2's dt init), so
    # dt*A sums to a few units over a chunk and the state carried from
    # earlier chunks makes up about half of y (by norm, past the first chunk)
    L, H, P, G, N, Q = MAMBA2_SSD
    for dtype in (torch.float32, torch.bfloat16):
        args = _ssd_inputs(gen, 2, L, H, P, G, N, dtype, dt_shift=-6.0)
        err, frac = _ssd_err(ssd_scan_fwd(*args, chunk=Q),
                             ref.ssd_chunked_ref(*args, chunk=Q), SSD_TOL[dtype])
        check(frac <= 1.0, f"ssd {dtype} long memory: max_abs_err {err}")
        say("kernels", kernel="ssd", case="long_memory", dt_shift=-6.0,
            dtype=dtype_name(dtype), max_abs_err=err, of_allowance=frac)
        del args
    # groups > 1 against the naive recurrence
    args = _ssd_inputs(gen, 2, 64, 4, 16, 2, 16, torch.float32)
    err, frac = _ssd_err(ssd_scan_fwd(*args, chunk=16), ref.ssd_ref(*args),
                         SSD_TOL[torch.float32])
    check(frac <= 1.0, f"ssd G=2 vs the naive recurrence: max_abs_err {err}")
    say("kernels", kernel="ssd", vs="ssd_ref", shape="B2xL64xH4xP16xG2xN16xQ16",
        max_abs_err=err, of_allowance=frac)
    return recs


# -- phases 4 and 5 -----------------------------------------------------------------

def run_elastic(cfg, job, steps=(2, 2, 2), log="main", device="cuda", on_shrink=None):
    """steps at R=4, host-lane shrink to 2, steps, p2p expand to 4, steps;
    each step logged under the phase tag ``log`` (none if empty), with its
    aux loss where it has one and, on the card, the peak memory so far (the
    step after which it grows set it).  ``on_shrink(trainer)`` runs after
    the shrink, outside its timed stages."""
    slots = local_slots(4)
    t = ElasticTrainer(cfg, job, slots, device=device)
    step_s, timings = [], []
    on_card = torch.device(device).type == "cuda"

    def run(n):
        for _ in range(n):
            t0 = time.perf_counter()
            m = t.step()
            step_s.append(time.perf_counter() - t0)
            if log:
                aux = {"aux": m["aux"]} if m["aux"] else {}
                peak = ({"peak_so_far_gb": f"{torch.cuda.max_memory_allocated() / 1e9:.2f}"}
                        if on_card else {})
                say(log, step=m["step"], replicas=m["replicas"],
                    loss=m["loss"], **aux, grad_norm=m["grad_norm"],
                    seconds=f"{step_s[-1]:.3f}", **peak)
    run(steps[0])
    timings.append(t.rescale(slots[2:], via_host=True))
    if on_shrink is not None:
        on_shrink(t)
    run(steps[1])
    timings.append(t.rescale(slots))
    run(steps[2])
    return t, step_s, timings


def main_path(cfg):
    job = TrainJobConfig(**MAIN_JOB)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t, step_s, timings = run_elastic(cfg, job)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    by_dtype = ops.launch_counts_by_dtype()
    losses = [m["loss"] for m in t.metrics_log]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check([r.path for r in timings] == ["host", "p2p"],
          f"paths {[r.path for r in timings]}")
    for r in timings:
        say("main", rescale=r.path, **{k: f"{v:.4f}" for k, v in r.as_dict().items()})
    kernel = "flash_attention" if cfg.mixer_at(0) == ATTN else "ssd"
    expected = 2 * cfg.num_layers * sum(MAIN_REPLICAS)  # fwd + recompute
    say("main", arch=cfg.name, layers=cfg.num_layers, params=M.param_count(cfg),
        startup_s=f"{t.startup_time:.2f}", step_s=[round(s, 4) for s in step_s],
        tokens_per_s=f"{job.global_batch * job.seq_len / min(step_s):.0f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        launches=json.dumps(counts), **{f"expected_{kernel}": expected})
    check(counts[kernel] == expected,
          f"{kernel} launches {counts[kernel]} != {expected}")
    check(counts["pack"] > 0, "the host lane did not go through the pack kernel")
    profile_step(t)
    # a process's first step runs torch's lazy imports, whose frames can hold
    # the step's frame, and with it the trainer, in a cycle: collect it here
    del t
    gc.collect()
    torch.cuda.empty_cache()
    return by_dtype, step_s, losses


KERNEL_GROUPS = (("ssd", ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")),
                 ("flash_attention", ("flash_fwd_",)), ("pack", ("pack_kernel",)),
                 ("gemm", ("gemm", "xmma", "cutlass")), ("softmax", ("softmax",)),
                 ("sort", ("sort", "topk", "radix", "bitonic")), ("reduce", ("reduce",)),
                 ("index", ("index", "scatter", "gather")),
                 ("elementwise", ("elementwise",)))


def kernel_group(name):
    low = name.lower()
    for group, words in KERNEL_GROUPS:
        if any(w in low for w in words):
            return group
    return "other"


def device_profile(fn):
    """``fn()`` once under torch.profiler, device activity only: (wall ms
    to its end, {kernel: (launches, device ms)}, device busy ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = kernel_times(prof)
    return wall_ms, by_name, sum(ms for _, ms in by_name.values())


def kernel_groups(by_name):
    """{kernel group: device ms}, largest first."""
    groups = {}
    for name, (_, ms) in by_name.items():
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def profile_step(t, top=8):
    """One more steady step at R=4 under torch.profiler: device busy share,
    device time by kernel group and the kernels that take the most (after
    the launch counts were read, so it does not add to them).  Only device
    activity is traced."""
    t1 = time.perf_counter()
    wall_ms, by_name, busy_ms = device_profile(t.step)
    check(busy_ms > 0, "the profiler saw no device time")
    say("profile", arch=t.cfg.name, replicas=t.replicas, wall_ms=f"{wall_ms:.1f}",
        device_ms=f"{busy_ms:.1f}", idle_share=f"{1 - busy_ms / wall_ms:.3f}",
        kernels=sum(n for n, _ in by_name.values()),
        parse_s=f"{time.perf_counter() - t1 - wall_ms / 1e3:.1f}",
        **{f"{g}_ms": f"{v:.1f}" for g, v in kernel_groups(by_name).items()})
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        say("profile", ms=f"{ms:.2f}", calls=n, kernel=name[:90].replace(" ", "_"))


def trajectory(arch, device="cuda", base=None):
    """Static vs rescaled at depth 1 (an encoder-decoder: one encoder layer
    and one decoder layer) of ``base``, ``arch``'s published config by
    default (the CPU tests pass a smoke one)."""
    cfg = base or get_config(arch)
    cfg = cfg.with_(num_layers=1, enc_layers=min(cfg.enc_layers, 1))
    job = TrainJobConfig(global_batch=8, seq_len=256, total_steps=6, seed=1)
    static = ElasticTrainer(cfg, job, local_slots(4), device=device)
    for _ in range(6):
        static.step()
    el, _, timings = run_elastic(cfg, job, log=False, device=device)
    la = [m["loss"] for m in static.metrics_log]
    lb = [m["loss"] for m in el.metrics_log]
    lerr = max(abs(a - b) for a, b in zip(la, lb))
    fa, fb = flatten_tree(static.params), flatten_tree(el.params)
    errs = {k: float((fa[k] - fb[k]).detach().abs().max()) for k in fa}
    leaf = max(errs, key=errs.get)                  # the leaf that sets the error
    perr = errs[leaf]
    at = np.unravel_index(int((fa[leaf] - fb[leaf]).detach().abs().argmax()),
                          tuple(fa[leaf].shape))
    say("trajectory", arch=arch, depth=1, enc_layers=cfg.enc_layers, loss_err=lerr,
        param_err=perr, param_err_leaf=leaf, param_err_at=list(map(int, at)),
        static_value=float(fa[leaf].detach()[at]),
        rescaled_value=float(fb[leaf].detach()[at]),
        loss_tol=TRAJ_LOSS_TOL, param_tol=TRAJ_PARAM_TOL,
        paths=[r.path for r in timings], loss_first=la[0], loss_last=la[-1])
    check(lerr <= TRAJ_LOSS_TOL, f"trajectory loss err {lerr}")
    check(perr <= TRAJ_PARAM_TOL, f"trajectory param err {perr}")
    del static, el
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# -- phase 6 -------------------------------------------------------------------------

def train_cli_smoke(arch):
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        args = ["--arch", arch, "--smoke", "--device", "cuda", "--devices", "4",
                "--global-batch", "8", "--seq-len", "32", "--log-every", "2",
                "--checkpoint-dir", d]
        t1 = train_cli.main(args + ["--steps", "6", "--rescale-at", "2:2",
                                    "--rescale-at", "4:4", "--checkpoint-every", "3"])
        t2 = train_cli.main(args + ["--steps", "8", "--restart"])
    losses = [m["loss"] for m in t1.metrics_log + t2.metrics_log]
    check(all(math.isfinite(x) for x in losses), f"cli losses {losses}")
    check([m["step"] for m in t2.metrics_log] == [7, 8], "restart did not resume")
    check(t1.device.type == "cuda", "the CLI did not run on the card")
    say("cli", arch=arch, rescales=[r.path for r in t1.rescale_log], losses=len(losses))


# -- phase 7 -------------------------------------------------------------------------

def trainer_factory(cfg, job, device):
    """The operator's factory: slots -> a trainer of ``cfg`` on ``device``."""
    return lambda slots: ElasticTrainer(cfg, job, slots, device=device)


def live_trainers(op):
    return sum(1 for live in op.live.values() if live.trainer is not None)


def say_rescales(scenario, op):
    for t, job_id, old, new, timings in op.rescale_events:
        say("operator", scenario=scenario, t=f"{t:.3f}", job=job_id,
            rescale=f"{old}->{new}", path=timings.path,
            **{k: f"{v:.4f}" for k, v in timings.as_dict().items()})


def scenario_priority(cfg, low_job, high_job, device):
    """Scenario A, priority shrink and expand-back (paper Figs. 2 and 3): 8
    logical slots on one node; "low" (priority 1, R 2..8) starts alone on all
    8, "high" (priority 5, R 4..8) arrives after the first tick and shrinks
    it, and low expands back when high completes.  The operator's clock is
    the wall clock (no ``step_time_fn``).  Returns the controller and its
    ``ScheduleMetrics``; the trainers stay resident, as the reference's do."""
    op = ElasticClusterController(local_slots(8), slots=8,
                                  policy=PolicyConfig(rescale_gap=0.0),
                                  steps_per_tick=2)
    op.submit(JobSpec("low", 1, 2, 8, 0.0, divides=8),
              trainer_factory(cfg, low_job, device))
    op.submit(JobSpec("high", 5, 4, 8, 0.001, divides=8),
              trainer_factory(cfg, high_job, device))
    m = op.run()
    low, high = op.cluster.jobs["low"], op.cluster.jobs["high"]
    check(low.status == JobStatus.COMPLETED and high.status == JobStatus.COMPLETED,
          f"scenario A: low {low.status}, high {high.status}")
    moves = [(old, new) for _, job_id, old, new, _ in op.rescale_events
             if job_id == "low"]
    check(len(moves) >= 2 and moves[0][0] > moves[0][1] and moves[-1][0] < moves[-1][1],
          f"scenario A: low must shrink for high, then expand back: {moves}")
    check(op.live["low"].trainer.step_idx == low_job.total_steps
          and op.live["high"].trainer.step_idx == high_job.total_steps,
          "scenario A: step counts")
    return op, m


def static_run(cfg, job, device, replicas=8):
    """The same job, built by the same factory, stepped to its end on a
    fixed slot set."""
    t = trainer_factory(cfg, job, device)(local_slots(replicas))
    while not t.done:
        t.step()
    return t


def chosen_leaves(trainer):
    """Host copies of the embedding and of layer 0 of every stacked block
    leaf, as ``{key: (index, bytes)}``."""
    out = {}
    for k, v in flatten_tree(trainer.params).items():
        if k == "embed":
            out["params/embed"] = (slice(None), v.detach().cpu().numpy().tobytes())
        elif k.startswith("decoder/blocks/"):
            out[f"params/{k}"] = (0, v[0].detach().cpu().numpy().tobytes())
    return out


def state_nbytes(trainer):
    return sum(t.numel() * t.element_size()
               for t in flatten_tree(trainer.state_tree()).values())


def scenario_faults(victim_cfg, victim_job, neighbor_cfg, neighbor_job, device,
                    ckpt_root):
    """Scenario B, fault tolerance and node operations (paper §3.2.2): 8
    slots as two nodes of 4; "victim" (priority 3, R 2..4) and "neighbor"
    (priority 2, R 2..4) fill one node each.  After a first tick (one step
    each, by hand, as ``tests/helpers/operator_scenario.py`` drives it):

    1. a synchronous ``save_disk`` of the victim (timed), then a fused
       ``save_disk_async`` of the same step, an in-place step at once, the
       barrier, and the checkpoint held byte for byte against host copies of
       chosen leaves taken before the step;
    2. ``inject_node_failure`` on the victim's node: its trainer is dropped
       (on the card: the memory comes back) and it is requeued with the
       restart flag;
    3. ``recover_node`` on that node, then ``drain_node`` on the neighbor's
       node: the neighbor migrates onto the recovered node's disjoint slots,
       which takes the host lane; then that node is recovered too;
    4. ``run()``: the victim restarts from the checkpoint's step
       (``restore_disk``) and both complete.

    Returns the controller, its ``ScheduleMetrics``, the launch record of
    the victim's first trainer (``trainer_record``; the trainer itself is
    dropped) and the checkpoint timings."""
    store = DiskCheckpointStore(ckpt_root)
    op = ElasticClusterController(local_slots(8), slots=8, slots_per_node=4,
                                  policy=PolicyConfig(rescale_gap=0.0),
                                  disk_store=store, steps_per_tick=1)
    op.submit(JobSpec("victim", 3, 2, 4, 0.0, divides=8),
              trainer_factory(victim_cfg, victim_job, device))
    op.submit(JobSpec("neighbor", 2, 2, 4, 0.0, divides=8),
              trainer_factory(neighbor_cfg, neighbor_job, device))
    op._process_submissions()
    home = {j: [n for n in op.cluster.nodes() if j in op.cluster.residents(n)]
            for j in ("victim", "neighbor")}
    check(len(home["victim"]) == 1 and len(home["neighbor"]) == 1
          and home["victim"] != home["neighbor"],
          f"scenario B: each job should fill one node: {home}")
    for job_id in ("victim", "neighbor"):
        op.live[job_id].trainer.step()

    victim = op.live["victim"].trainer
    timings = {"save_s": victim.save_disk(store, "victim")}
    timings["save_bytes"] = store.last_bytes_written
    before = chosen_leaves(victim)
    t0 = time.perf_counter()
    victim.save_disk_async(store, "victim", fused=True)
    timings["async_submit_s"] = time.perf_counter() - t0
    ckpt_step = victim.step_idx
    victim.step()                       # in place, while the write is in flight
    t0 = time.perf_counter()
    victim.ckpt_barrier()
    timings["async_barrier_s"] = time.perf_counter() - t0
    flat, manifest = store.load("victim")
    check(manifest["step"] == ckpt_step, f"checkpoint step {manifest['step']}")
    after = chosen_leaves(victim)
    for k, (idx, raw) in before.items():
        check(flat[k][idx].tobytes() == raw,
              f"scenario B: checkpoint leaf {k} is not the pre-step state")
    check(any(after[k][1] != raw for k, (_, raw) in before.items()),
          "scenario B: the step after the snapshot changed none of the chosen leaves")
    del flat, after
    dropped = trainer_record(victim)
    timings["snapshot_packs"] = dtype_groups(victim.state_tree())
    victim_bytes = state_nbytes(victim)
    del victim

    on_card = torch.device(device).type == "cuda"
    gc.collect()
    held = torch.cuda.memory_allocated() if on_card else 0
    (node,) = home["victim"]
    check(op.inject_node_failure(node) == ["victim"], "scenario B: failure victims")
    check(op.live["victim"].trainer is None, "scenario B: the victim's trainer survived")
    gc.collect()
    if on_card:
        timings["freed_gb"] = (held - torch.cuda.memory_allocated()) / 1e9
        check(held - torch.cuda.memory_allocated() >= victim_bytes,
              f"scenario B: failure freed {timings['freed_gb']:.3f} GB of the "
              f"victim's {victim_bytes / 1e9:.3f} GB")
    op.recover_node(node)

    neighbor = op.live["neighbor"].trainer
    (nnode,) = home["neighbor"]
    op.drain_node(nnode)
    check(not op.cluster.residents(nnode), "scenario B: the drained node is not empty")
    check(neighbor.rescale_log and neighbor.rescale_log[-1].path == "host",
          f"scenario B: the drain migration took {neighbor.rescale_log[-1:]}")
    check(op.cluster.jobs["neighbor"].replicas == 4, "scenario B: the neighbor shrank")
    del neighbor
    op.recover_node(nnode)

    m = op.run()
    for job_id, job in (("victim", victim_job), ("neighbor", neighbor_job)):
        check(op.cluster.jobs[job_id].status == JobStatus.COMPLETED,
              f"scenario B: {job_id} {op.cluster.jobs[job_id].status}")
        check(op.live[job_id].trainer.step_idx == job.total_steps,
              f"scenario B: {job_id} step {op.live[job_id].trainer.step_idx}")
    resumed = op.live["victim"].trainer
    check(op.live["victim"].failures == 1 and resumed.metrics_log[0]["step"] == ckpt_step + 1,
          f"scenario B: the victim did not resume from step {ckpt_step}")
    timings["ckpt_step"] = ckpt_step
    return op, m, dropped, timings


def dtype_groups(tree):
    """Pack launches of one fused snapshot of ``tree``: one per dtype group
    of its non-empty leaves (``packed_snapshot_to_host``)."""
    return len({t.dtype for t in flatten_tree(tree).values() if t.numel()})


def trainer_record(t):
    """What a trainer's steps and rescales imply for the launch counts."""
    host = sum(r.path == "host" for r in t.rescale_log)
    return {"cfg": t.cfg, "replicas": [m["replicas"] for m in t.metrics_log],
            "host_packs": host * (dtype_groups(t.params) + dtype_groups(t.opt_state))}


def expected_launches(records, snapshot_packs):
    """{kernel: launches} that the recorded steps, host-lane rescales and
    fused snapshots imply: a step launches its mixer's kernel twice per layer
    and replica (forward and the per-layer recompute)."""
    out = {"flash_attention": 0, "pack": snapshot_packs, "rmsnorm": 0, "ssd": 0}
    for rec in records:
        kernel = "flash_attention" if rec["cfg"].mixer_at(0) == ATTN else "ssd"
        out[kernel] += 2 * rec["cfg"].num_layers * sum(rec["replicas"])
        out["pack"] += rec["host_packs"]
    return out


def operator_phase(yi_cfg, victim_cfg, trace_dir):
    """Phase 7: the live operator at full width on the card, scenarios A and
    B, with the launch counts zeroed before and read after the phase.  Each
    scenario runs under a ``Tracer`` writing ``<trace_dir>/operator_<A|B>.jsonl``.
    Returns the launch counts by dtype and ``{scenario: trace path}``."""
    t_phase = time.perf_counter()
    traces = {s: os.path.join(trace_dir, f"operator_{s}.jsonl") for s in "AB"}
    device = "cuda"
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    records = []

    def scenario_end(name, op, m, t0):
        say_rescales(name, op)
        say("operator", scenario=name, clock="wall (no step_time_fn)",
            live_trainers=live_trainers(op),
            peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
            seconds=f"{time.perf_counter() - t0:.1f}")
        say("operator", scenario=name, metrics=m.row().replace(" ", "_"))
        check(torch.cuda.max_memory_allocated() < 80e9, "peak memory past 80 GB")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    low_job = TrainJobConfig(total_steps=10, seed=0, **OPERATOR_JOB)
    high_job = TrainJobConfig(total_steps=4, seed=1, **OPERATOR_JOB)
    with install(Tracer(traces["A"])) as tracer:
        op, m = scenario_priority(yi_cfg, low_job, high_job, device)
    tracer.close()
    scenario_end("A", op, m, t0)
    records += [trainer_record(live.trainer) for live in op.live.values()]
    low_losses = [x["loss"] for x in op.live["low"].trainer.metrics_log]
    del op
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    static = static_run(yi_cfg, low_job, device)
    records.append(trainer_record(static))
    static_losses = [x["loss"] for x in static.metrics_log]
    del static
    gc.collect()
    torch.cuda.empty_cache()
    errs = [abs(a - b) for a, b in zip(low_losses, static_losses)]
    lerr = max(errs)
    say("operator", scenario="A", static_replicas=8, loss_err=lerr,
        loss_err_by_step=json.dumps([float(f"{e:.3g}") for e in errs]).replace(" ", ""),
        loss_tol=TRAJ_LOSS_TOL, loss_first=low_losses[0], loss_last=low_losses[-1],
        static_seconds=f"{time.perf_counter() - t0:.1f}")
    check(lerr <= TRAJ_LOSS_TOL, f"scenario A: low vs its static run, loss err {lerr}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    victim_job = TrainJobConfig(total_steps=4, seed=2, **OPERATOR_JOB)
    neighbor_job = TrainJobConfig(total_steps=4, seed=3, **OPERATOR_JOB)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d, \
            install(Tracer(traces["B"])) as tracer:
        op, m, dropped, timings = scenario_faults(victim_cfg, victim_job, yi_cfg,
                                                  neighbor_job, device, d)
    tracer.close()
    say("operator", scenario="B", **{k: f"{v:.4f}" if isinstance(v, float) else v
                                     for k, v in timings.items()})
    scenario_end("B", op, m, t0)
    records += [trainer_record(live.trainer) for live in op.live.values()]
    records.append(dropped)
    del op
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    counts = ops.launch_counts()
    by_dtype = ops.launch_counts_by_dtype()
    expected = expected_launches(records, timings["snapshot_packs"])
    say("operator", launches=json.dumps(counts).replace(" ", ""),
        expected=json.dumps(expected).replace(" ", ""),
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    for kernel in ("flash_attention", "ssd", "pack"):
        check(expected[kernel] > 0, f"the operator path implies no {kernel} launch")
        check(counts[kernel] == expected[kernel],
              f"operator path: {kernel} launches {counts[kernel]} != {expected[kernel]}")
    return by_dtype, traces


# -- phase 8 -------------------------------------------------------------------------

def say_block(what, text):
    """A multi-line text as ``[simulator]`` lines."""
    for line in text.splitlines():
        print(f"[simulator] {what} | {line}", flush=True)


def audit_trace(name, records):
    """The port's auditor over every run in ``records``: one line per run,
    and a failure on any violation.  Returns the reports."""
    reports = audit_records(records, source=name)
    check(reports, f"{name}: the trace holds no run")
    for rep in reports:
        say("simulator", trace=name, run=rep.run, records=rep.counts.get("records", 0),
            violations=len(rep.violations), checks=",".join(
                f"{k}={'ok' if v else 'VIOLATED'}" for k, v in sorted(rep.checks.items())))
    check(all(rep.ok for rep in reports),
          "\n".join(rep.summary() for rep in reports if not rep.ok))
    return reports


def audit_operator_trace(name, path):
    """Phase 7's trace of scenario ``name``: audited, then its phase
    reconciliation, causal chains and text Gantt."""
    records = Tracer.load(path)
    check(len(audit_trace(f"operator_{name}", records)) == 1,
          f"scenario {name}: one operator run per trace")
    violations = reconcile(records)
    say("simulator", trace=f"operator_{name}", reconcile_violations=len(violations))
    check(not violations, f"scenario {name}: {violations}")
    say_block(f"operator_{name} chains", render_chains(build_span_graph(records)))
    say_block(f"operator_{name} timeline", render_last_run(records))


def golden_diff(got, want, rtol=GOLDEN_RTOL, key=""):
    """(mismatches, largest relative float error) of ``got`` against
    ``want``: floats may differ by a relative ``rtol``, everything else
    (keys, integers, counters, strings) must be equal."""
    if isinstance(want, dict) and isinstance(got, dict):
        bad = [f"{key}: keys {sorted(set(got) ^ set(want))}"] if set(got) != set(want) else []
        err = 0.0
        for k in sorted(set(got) & set(want)):
            b, e = golden_diff(got[k], want[k], rtol, f"{key}.{k}")
            bad, err = bad + b, max(err, e)
        return bad, err
    if isinstance(got, float) and isinstance(want, float):
        scale = max(abs(got), abs(want))
        err = abs(got - want) / scale if scale else 0.0
        return ([] if err <= rtol else [f"{key}: {got!r} != {want!r}"]), err
    return ([] if type(got) is type(want) and got == want
            else [f"{key}: {got!r} != {want!r}"]), 0.0


def table1_phase(trace_path):
    """Table 1's simulation columns at the paper's size, traced: one row per
    variant, the four paper variants held to the golden metrics, the trace
    audited."""
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    specs = make_jacobi_jobs(seed=TABLE1["seed"], n_jobs=TABLE1["n_jobs"],
                             submission_gap=TABLE1["submission_gap"])
    t0 = time.perf_counter()
    with install(Tracer(trace_path)) as tracer:
        rows = {v: run_variant(v, specs, total_slots=TABLE1["total_slots"],
                               rescale_gap=TABLE1["rescale_gap"]) for v in TABLE1_VARIANTS}
    tracer.close()
    seconds = time.perf_counter() - t0
    for v, m in rows.items():
        print(f"[simulator] table1.sim.{v:<15s} {m.row()}", flush=True)
        check(m.dropped_jobs == 0, f"table1 {v}: {m.dropped_jobs} jobs dropped")
    for v in VARIANTS:
        got = json.loads(json.dumps(rows[v].to_dict(), sort_keys=True))
        bad, err = golden_diff(got, golden[f"table1.sim.{v}"])
        say("simulator", golden=f"table1.sim.{v}", mismatches=len(bad),
            max_rel_err=err, rtol=GOLDEN_RTOL)
        check(not bad, f"table1 {v} against the golden metrics: {bad[:5]}")
    reports = audit_trace("table1", Tracer.load(trace_path))
    check(len(reports) == len(TABLE1_VARIANTS), f"table1 trace: {len(reports)} runs")
    say("simulator", table1_seconds=f"{seconds:.3f}")


def figure_sweeps(seeds=FIG_SEEDS, gaps=FIG7_GAPS, tgaps=FIG8_TGAPS):
    """Fig. 7 (submission gap, T_rescale_gap 180 s) and Fig. 8
    (T_rescale_gap, submission gap 180 s) at the benchmarks' grids: each
    cell's mean over ``seeds`` as the benchmarks print it; every job of
    every run completes.  Returns the number of runs."""
    t0 = time.perf_counter()
    cells = ([("fig7", f"gap{g}", v, float(g), 180.0) for g in gaps for v in VARIANTS]
             + [("fig8", f"tgap{tg}", v, 180.0, float(tg))
                for tg in tgaps for v in FIG8_VARIANTS])
    for fig, cell, v, gap, tgap in cells:
        rows = []
        for seed in seeds:
            specs = make_jacobi_jobs(seed=seed, n_jobs=16, submission_gap=gap)
            m = run_variant(v, specs, total_slots=64, rescale_gap=tgap)
            check(m.dropped_jobs == 0 and m.counters.get("completions") == 16,
                  f"{fig}.{cell}.{v} seed {seed}: {m.counters}")
            rows.append((m.total_time, m.utilization, m.weighted_mean_response,
                         m.weighted_mean_completion, m.rescale_count))
        a = [sum(col) / len(rows) for col in zip(*rows)]
        say("simulator", cell=f"{fig}.{cell}.{v}", total=f"{a[0]:.0f}",
            util=f"{a[1]:.3f}", resp=f"{a[2]:.1f}", compl=f"{a[3]:.1f}",
            rescales=f"{a[4]:.1f}")
    runs = len(cells) * len(seeds)
    say("simulator", figures="fig7+fig8", runs=runs,
        seconds=f"{time.perf_counter() - t0:.3f}")
    return runs


def event_rate(card, job_counts=SIMCORE_JOBS, repeats=SIMCORE_REPEATS):
    """The event loop on this machine's host: retired events (dispatched +
    stale-dropped) per second on bench_simcore's rungs, best of ``repeats``;
    then the self-profiler's cost per event kind and section on the largest
    rung, over ``repeats`` runs."""
    def rung(n):
        specs = make_jacobi_jobs(seed=11, n_jobs=n, submission_gap=45.0)
        return lambda: run_variant("elastic", specs, total_slots=64, rescale_gap=180.0)
    for n in job_counts:
        run = rung(n)
        m = run()
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run()
            walls.append(time.perf_counter() - t0)
        retired = m.counters["events"] + m.counters.get("stale_events", 0)
        say("simulator", rung_jobs=n, events=m.counters["events"],
            stale_events=m.counters.get("stale_events", 0), wall_s=f"{min(walls):.6f}",
            events_retired_per_s=f"{retired / min(walls):.0f}", card=json.dumps(card))
    prof = SimProfiler()
    run = rung(job_counts[-1])
    for _ in range(repeats):
        one = SimProfiler()
        t0 = time.perf_counter()
        with install_profiler(one):
            run()
        one.wall_s = time.perf_counter() - t0
        prof.merge(one)
    rep = prof.report()
    for table in ("events", "sections"):
        for name, cell in rep[table].items():
            say("simulator", profile_jobs=job_counts[-1], repeats=repeats, **{table[:-1]: name},
                count=cell["count"], total_s=cell["total_s"], mean_us=cell["mean_us"])
    say("simulator", profile_jobs=job_counts[-1], wall_s=rep["wall_s"],
        handler_s=rep["handler_s"], unattributed_s=rep["unattributed_s"], card=json.dumps(card))
    return rep


def arch_prediction(cfg):
    """The H100 ``ArchScalingModel``'s one-card float32 model of phase 4's
    step: 6*N*tokens at global batch 8 x 2048 over the fp32 peak, mfu 0.4."""
    m = arch_model_from_config(cfg, seq_len=MAIN_JOB["seq_len"],
                               global_batch=MAIN_JOB["global_batch"])
    return dataclasses.replace(m, peak_flops=H100_PEAK_FLOPS_FP32, gpus_per_group=1)


def arch_vs_card(cfg, step_s, card, tag="simulator"):
    """The arch model's prediction beside phase 4's steady R=4 step (the
    median of its R=4 steps after the first) and their ratio.  No gate."""
    m = arch_prediction(cfg)
    predicted = m.time_per_step(1)
    r4 = sorted(s for s, r in list(zip(step_s, MAIN_REPLICAS))[1:] if r == 4)
    measured = r4[len(r4) // 2]
    say(tag, arch=cfg.name, layers=cfg.num_layers, flops=f"{m.flops_per_step:.4e}",
        peak_flops=m.peak_flops, mfu=m.mfu, predicted_s=f"{predicted:.4f}",
        measured_r4_s=f"{measured:.4f}", measured_over_predicted=f"{measured / predicted:.4f}",
        fp32_peak_share=f"{m.flops_per_step / measured / m.peak_flops:.4f}",
        card=json.dumps(card))


def simulator_phase(op_traces, arch_steps, card, trace_dir):
    """Phase 8: the policy simulator and the flight recorder on the host,
    with the operator's traces from the card."""
    t_phase = time.perf_counter()
    for name, path in op_traces.items():
        audit_operator_trace(name, path)
    table1_phase(os.path.join(trace_dir, "table1.jsonl"))
    figure_sweeps()
    event_rate(card)
    for cfg, step_s in arch_steps:
        arch_vs_card(cfg, step_s, card)
    say("simulator", seconds=f"{time.perf_counter() - t_phase:.1f}")


# -- phase 9 -------------------------------------------------------------------------

INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def same_bits(a, b):
    """Whether two tensors of one shape and dtype hold the same bytes
    (compared as integers, so any NaN payload or signed zero counts)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = INT_OF_SIZE[a.element_size()]
    return torch.equal(a.detach().view(ints), b.detach().view(ints))


def state_matches(state, want):
    """Whether the leaves of ``state`` (a tree of tensors on the card) hold
    the bytes of the flat ``want``: tensors, or a host snapshot's arrays
    (bfloat16 as ``V2``), each moved to the card for the comparison.
    Returns (equal, bytes compared)."""
    flat = flatten_tree(state)
    check(sorted(flat) == sorted(want), f"keys {sorted(set(flat) ^ set(want))}")
    n = 0
    for k, t in flat.items():
        w = want[k]
        w = host_tensor(np.asarray(w)) if isinstance(w, np.ndarray) else w
        if not same_bits(t, w.to(t.device)):
            return False, n
        n += t.numel() * t.element_size()
    return True, n


def bf16_phase(cfg, ckpt_root, fp32_loss, job=BF16_JOB, device="cuda"):
    """Phase 9: phase 4's yi-6b job with ``dtype="bfloat16"`` on the card.
    Two steps at R=4 (the first loss held to ``fp32_loss``, the float32
    job's first, within ``BF16_LOSS_RTOL``), a fused host snapshot held
    against the device state, a host-lane shrink to R=2 (the parameters'
    group through the pack kernel's 2-byte instantiation) whose restored
    state is held against the snapshot, a step, a fused ``save_disk``, a
    step, a fused delta ``save_disk`` (fewer bytes), and a restart from disk
    into a new trainer whose state is held against the saved step's; the
    restarted trainer takes one step.  Launch counts are zeroed before and
    read after, by dtype.  Returns those counts."""
    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    slots = local_slots(4)
    t = ElasticTrainer(cfg, TrainJobConfig(**job), slots, device=device)
    check({v.dtype for v in flatten_tree(t.params).values()} == {torch.bfloat16},
          "bf16: the parameters are not bfloat16")
    step_s, replicas = [], []

    def run(trainer, n):
        for _ in range(n):
            t0 = time.perf_counter()
            m = trainer.step()
            step_s.append(time.perf_counter() - t0)
            replicas.append(m["replicas"])
            say("bf16", step=m["step"], replicas=m["replicas"], loss=m["loss"],
                grad_norm=m["grad_norm"], seconds=f"{step_s[-1]:.3f}")
            check(math.isfinite(m["loss"]), f"bf16: loss {m['loss']}")

    run(t, 2)
    first = t.metrics_log[0]["loss"]
    rel = abs(first - fp32_loss) / abs(fp32_loss)
    say("bf16", first_loss=first, fp32_first_loss=fp32_loss, rel_err=rel,
        rtol=BF16_LOSS_RTOL)
    check(rel <= BF16_LOSS_RTOL, f"bf16: first loss {first} vs float32 {fp32_loss}")
    t0 = time.perf_counter()
    host = snapshot_to_host(t.state_tree(), fused=True)
    snap_s = time.perf_counter() - t0
    same, nb = state_matches(t.state_tree(), host)
    say("bf16", snapshot="fused", seconds=f"{snap_s:.4f}", bytes=nb,
        v2_leaves=sum(a.dtype == np.dtype("V2") for a in host.values()), byte_exact=same)
    check(same, "bf16: the fused host snapshot differs from the device state")
    timings = t.rescale(slots[2:], via_host=True)
    check(timings.path == "host", f"bf16: the shrink took the {timings.path} lane")
    say("bf16", rescale="4->2", path=timings.path,
        **{k: f"{v:.4f}" for k, v in timings.as_dict().items()})
    same, _ = state_matches(t.state_tree(), host)
    say("bf16", restored_vs_snapshot_byte_exact=same)
    check(same, "bf16: the state restored on the host lane differs from the snapshot")
    del host
    run(t, 1)
    store = DiskCheckpointStore(ckpt_root)
    full_s = t.save_disk(store, "bf16", fused=True)
    full_b = store.last_bytes_written
    run(t, 1)
    delta_s = t.save_disk(store, "bf16", delta=True, fused=True)
    delta_b = store.last_bytes_written
    say("bf16", save_s=f"{full_s:.4f}", save_bytes=full_b, delta_save_s=f"{delta_s:.4f}",
        delta_bytes=delta_b, delta_of_full=f"{delta_b / full_b:.6f}")
    check(delta_b < full_b, f"bf16: the delta save wrote {delta_b} bytes, the full {full_b}")
    t2 = ElasticTrainer(cfg, TrainJobConfig(**dict(job, seed=job["seed"] + 1)), slots[2:],
                        device=device)
    t0 = time.perf_counter()
    step = t2.restore_disk(store, "bf16")
    restore_s = time.perf_counter() - t0
    same, nb = state_matches(t2.state_tree(), flatten_tree(t.state_tree()))
    say("bf16", restart_step=step, restore_s=f"{restore_s:.4f}", bytes=nb,
        restart_vs_saved_byte_exact=same)
    check(step == t.step_idx and same, "bf16: the restart from disk does not hold the "
          f"saved step's bytes (step {step} of {t.step_idx})")
    del t
    gc.collect()
    run(t2, 1)
    counts = ops.launch_counts_by_dtype()
    # each fused snapshot (the checked one, the shrink's, two saves) packs
    # the bf16 parameters, the float32 moments and the int32 counters
    expected = {"flash_attention": {}, "moe_gemm": {}, "pack": {}, "rmsnorm": {}, "ssd": {}}
    if on_card:
        expected.update(flash_attention={"bfloat16": 2 * cfg.num_layers * sum(replicas)},
                        pack={"bfloat16": 4, "float32": 4, "int32": 4})
    r4 = [s for s, r in zip(step_s, replicas) if r == 4]
    r2 = [s for s, r in zip(step_s, replicas) if r == 2]
    say("bf16", arch=cfg.name, layers=cfg.num_layers, r4_step_s=[round(x, 4) for x in r4],
        r2_step_s=[round(x, 4) for x in r2],
        tokens_per_s=f"{job['global_batch'] * job['seq_len'] / min(step_s):.0f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}" if on_card else None,
        launches=json.dumps(counts).replace(" ", ""),
        expected=json.dumps(expected).replace(" ", ""),
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    check(counts == expected, f"bf16: launches {counts} != {expected}")
    del t2
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return counts


# -- phase 10 ------------------------------------------------------------------------

def table2_provider(provisioning, market, seed_extra):
    """benchmarks/table2_cloud_cost.py ``_pools``: a static fleet (all 8
    nodes, or 4) or one node for the autoscaler; with ``spot30``, 30% of a
    static fleet from the spot market (mean lifetime 1800 s)."""
    spot = market == "spot30"
    od_nodes = {"static_max": T2_MAX_NODES, "static_min": 4, "autoscaled": 1}[provisioning]
    pools = []
    if spot:
        spot_nodes = {"static_max": 2, "static_min": 1, "autoscaled": 0}[provisioning]
        od_nodes -= spot_nodes
        pools.append(NodePool(
            "spot", slots_per_node=T2_SLOTS_PER_NODE, price_per_slot_hour=T2_PRICE_SPOT,
            market=SPOT, boot_latency=90.0, teardown_delay=30.0, max_nodes=T2_MAX_NODES,
            initial_nodes=spot_nodes, spot_lifetime_mean=1800.0))
    pools.append(NodePool(
        "od", slots_per_node=T2_SLOTS_PER_NODE, price_per_slot_hour=T2_PRICE_OD,
        boot_latency=120.0, teardown_delay=30.0, max_nodes=T2_MAX_NODES,
        initial_nodes=od_nodes))
    return CloudProvider(pools, seed=11 + seed_extra)


def table2_cell(policy_name, provisioning, market, seed=7):
    """One Table 2 cell (benchmarks/table2_cloud_cost.py ``run_cell``) through
    the port's ``CloudSimulator``: its ``ScheduleMetrics``."""
    specs = make_jacobi_jobs(seed=seed, n_jobs=16, submission_gap=90.0,
                             sizes=("small", "medium"))
    pcfg = (PolicyConfig.moldable() if policy_name == "moldable"
            else PolicyConfig(rescale_gap=180.0))
    prov = table2_provider(provisioning, market, seed_extra=(
        T2_POLICIES.index(policy_name) * len(T2_PROVISIONING)
        + T2_PROVISIONING.index(provisioning)))
    autoscaler = None
    if provisioning == "autoscaled":
        autoscaler = NodeAutoscaler(prov, AutoscalerConfig(
            tick_interval=30.0, scale_up_cooldown=30.0, scale_down_cooldown=120.0,
            idle_timeout=180.0, headroom_slots=8,
            spot_fraction=0.3 if market == "spot30" else 0.0))
    sim = CloudSimulator(prov, pcfg, autoscaler=autoscaler,
                         policy=PreemptingPolicy(pcfg) if policy_name == "elastic_preempt"
                         else None)
    for s in specs:
        sim.submit(s, jacobi_workload(s.workload))
    return sim.run()


def table2_verdict(cells):
    """Table 2's verdict row: autoscaled elastic against static-max elastic,
    on demand: (cost saving, WMCT ratio, cheaper at a ratio under 1.5)."""
    static = cells[("elastic", "static_max", "on_demand")]
    scaled = cells[("elastic", "autoscaled", "on_demand")]
    ratio = scaled.weighted_mean_completion / static.weighted_mean_completion
    return (1.0 - scaled.total_cost / static.total_cost, ratio,
            scaled.total_cost < static.total_cost and ratio < 1.5)


def table2_phase(golden):
    """All 18 Table 2 cells, the two golden ones held to the fixture, and the
    verdict row, which must say PASS."""
    t0 = time.perf_counter()
    cells = {}
    for key in ((p, v, m) for p in T2_POLICIES for v in T2_PROVISIONING for m in T2_MARKETS):
        m = cells[key] = table2_cell(*key)
        print(f"[cloud] table2.{'.'.join(key):<36s} {m.row()}", flush=True)
        check(m.dropped_jobs == 0 and m.counters.get("completions") == 16,
              f"table2 {key}: {m.counters}")
    for key in T2_GOLDEN:
        name = "table2." + ".".join(key)
        got = json.loads(json.dumps(cells[key].to_dict(), sort_keys=True))
        bad, err = golden_diff(got, golden[name])
        say("cloud", golden=name, mismatches=len(bad), max_rel_err=err, rtol=GOLDEN_RTOL)
        check(not bad, f"{name} against the golden metrics: {bad[:5]}")
    saving, ratio, ok = table2_verdict(cells)
    print(f"[cloud] table2.verdict.autoscaled_vs_static_max cost_saving={saving:.1%};"
          f"wmct_ratio={ratio:.2f};{'PASS' if ok else 'FAIL'}", flush=True)
    check(ok, "table2: autoscaled elastic is not cheaper than static-max at a "
          "WMCT ratio under 1.5")
    say("cloud", table2_cells=len(cells), seconds=f"{time.perf_counter() - t0:.3f}")


def trace_cloud_provider():
    """benchmarks/table4_traces.py's autoscaled fleet and autoscaler: one
    node up, up to 8, on demand."""
    prov = CloudProvider([NodePool(
        "od", slots_per_node=T2_SLOTS_PER_NODE, price_per_slot_hour=T2_PRICE_OD,
        boot_latency=120.0, teardown_delay=30.0,
        max_nodes=T4_CLUSTER_SLOTS // T2_SLOTS_PER_NODE, initial_nodes=1)], seed=23)
    return prov, NodeAutoscaler(prov, AutoscalerConfig(
        tick_interval=30.0, scale_up_cooldown=30.0, scale_down_cooldown=120.0,
        idle_timeout=180.0, headroom_slots=T2_SLOTS_PER_NODE))


def replay_fixture(kind, name, trace_path):
    """One fixture trace, normalized to 64 slots, through every entry of
    ``REPLAY_VARIANTS`` and ``replay_cloud`` with the autoscaler, traced to
    ``trace_path``.  Returns (trace, {run name: ScheduleMetrics})."""
    trace = LOADERS[kind](fixture_path(name)).normalized(T4_CLUSTER_SLOTS)
    cfg = ReplayConfig(cluster_slots=T4_CLUSTER_SLOTS)
    runs = {}
    with install(Tracer(trace_path)) as tracer:
        for v in REPLAY_VARIANTS:
            runs[v] = replay_variant(trace, v, cfg)
        prov, asc = trace_cloud_provider()
        runs["cloud_autoscaled"] = replay_cloud(trace, cfg, prov, variant="elastic",
                                                autoscaler=asc).metrics
    tracer.close()
    return trace, runs


def trace_phase(trace_dir):
    """Both fixture traces: characterized, replayed through every variant and
    the autoscaled cloud, each run audited with zero violations and every
    job completed."""
    t0 = time.perf_counter()
    for kind, name in TRACE_FIXTURES:
        path = os.path.join(trace_dir, f"replay_{kind}.jsonl")
        trace, runs = replay_fixture(kind, name, path)
        say("cloud", trace=name, **dataclasses.asdict(characterize(trace)))
        for run, m in runs.items():
            print(f"[cloud] replay.{kind}.{run:<17s} {m.row()}", flush=True)
            check(m.dropped_jobs == 0 and m.counters.get("completions") == len(trace),
                  f"{name} {run}: {m.counters.get('completions')} of {len(trace)} "
                  f"completed, {m.dropped_jobs} dropped")
        reports = audit_trace(f"replay_{kind}", Tracer.load(path))
        check(len(reports) == len(runs), f"{name}: {len(reports)} audited runs")
    say("cloud", traces=len(TRACE_FIXTURES), seconds=f"{time.perf_counter() - t0:.3f}")


def fleet_replay(n_jobs, seed, days, nodes, slots_per_node):
    """bench_simcore.py's fleet row: the Google-shape trace with priorities
    bucketed, replayed ``elastic`` in bounded-memory mode.  Returns
    (row, wall seconds of the replay)."""
    trace = google_fleet_trace(n_jobs=n_jobs, seed=seed, days=days, nodes=nodes,
                               slots_per_node=slots_per_node).bucket_priorities()
    capacity = nodes * slots_per_node
    t0 = time.perf_counter()
    m = replay_variant(trace, "elastic",
                       ReplayConfig(cluster_slots=capacity, rescale_gap=FLEET_RESCALE_GAP),
                       slots_per_node=slots_per_node, util_series=False,
                       track_phases=False)
    wall = time.perf_counter() - t0
    c = m.counters
    return {"n_jobs": n_jobs, "nodes": nodes, "days": days,
            "offered_load": trace.slot_seconds / (capacity * days * 86400.0),
            "events": c.get("events", 0), "stale_events": c.get("stale_events", 0),
            "completions": c.get("completions", 0), "rescales": c.get("rescales", 0),
            "utilization": m.utilization, "dropped_jobs": m.dropped_jobs}, wall


def fleet_phase(card):
    """The fleet smoke row, held to BENCH_simcore.json's counters exactly and
    its utilization to a relative ``GOLDEN_RTOL``."""
    with open(BENCH_SIMCORE) as fh:
        want = next(r for r in json.load(fh)["fleet"] if r["name"] == "smoke")
    row, wall = fleet_replay(**FLEET_SMOKE)
    retired = row["events"] + row["stale_events"]
    say("cloud", fleet="smoke", **row, wall_s=f"{wall:.3f}",
        jobs_per_s=f"{row['n_jobs'] / wall:.0f}",
        events_retired_per_s=f"{retired / wall:.0f}", card=json.dumps(card))
    bad = [f"{k}: {row[k]} != {want[k]}" for k in FLEET_EXACT if row[k] != want[k]]
    _, err = golden_diff(row["utilization"], want["utilization"])
    say("cloud", fleet="smoke", against="BENCH_simcore.json", mismatches=len(bad),
        utilization_rel_err=err, rtol=GOLDEN_RTOL)
    check(not bad and err <= GOLDEN_RTOL, f"fleet smoke row: {bad}, utilization "
          f"{row['utilization']!r} vs {want['utilization']!r}")


def cloud_phase(card, trace_dir):
    """Phase 10: the cloud layer and the trace workloads on the host."""
    t_phase = time.perf_counter()
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    table2_phase(golden)
    trace_phase(trace_dir)
    fleet_phase(card)
    say("cloud", seconds=f"{time.perf_counter() - t_phase:.1f}")


# -- phase 11 ------------------------------------------------------------------------

def mixer_layers(cfg):
    """{kernel: the layers of ``cfg`` whose mixer launches it}: flash
    attention a GQA layer's, the SSD scan a Mamba-2 layer's."""
    return {kernel: sum(cfg.mixer_at(i) == mixer for i in range(cfg.num_layers))
            for kernel, mixer in (("flash_attention", ATTN), ("ssd", SSM))}


def moe_forward_launches(cfg, on_card):
    """Ragged expert-product launches of one forward pass of ``cfg`` (a
    prefill or a decode step): the FFN's products (gate, up and down; up and
    down for GELU) of each MoE layer under the gather dispatch, in float32
    on the card; the training step's recompute launches them again and its
    backward twice as many."""
    layers = sum(cfg.ff_at(i) == FF_MOE for i in range(cfg.num_layers))
    if not layers or not on_card or cfg.dtype != "float32" or moe_impl() != "gather":
        return 0
    return layers * (3 if cfg.moe.ff_kind == FF_SWIGLU else 2)


@contextlib.contextmanager
def kept_restores():
    """While open, each host snapshot that a trainer restores from
    (``restore_from_host`` as ``core.elastic`` calls it) is appended to the
    list this yields, so the restored state can be held against it after
    the rescale's timed stages."""
    kept = []
    restore = elastic.restore_from_host

    def keep(host_flat, template, device):
        kept.append(host_flat)
        return restore(host_flat, template, device)
    elastic.restore_from_host = keep
    try:
        yield kept
    finally:
        elastic.restore_from_host = restore


def host_memory():
    """The machine's RAM in use (/proc/meminfo), this process's resident set
    (/proc/self/statm) and its peak (``getrusage``), in GB."""
    mem = {}
    with open("/proc/meminfo") as fh:
        for line in fh:
            k, _, v = line.partition(":")
            mem[k] = int(v.split()[0]) * 1024
    with open("/proc/self/statm") as fh:
        rss = int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024     # kB on Linux
    return {"host_used_gb": f"{(mem['MemTotal'] - mem['MemAvailable']) / 1e9:.2f}",
            "rss_gb": f"{rss / 1e9:.2f}", "rss_peak_gb": f"{peak / 1e9:.2f}"}


def job_phase(cfg, tag, job=MOE_JOB, device="cuda", reduced="none"):
    """An ``ElasticTrainer`` of ``cfg`` at full width through phase 4's
    sequence, logged under ``tag``, launch counts zeroed before and read
    after: phase 11 (granite-moe-3b-a800m) and the training jobs of phases
    13 and 14 (deepseek-v2-236b and jamba-v0.1-52b at depth 1).  Pinned
    host blocks cached by earlier phases are released first: a snapshot
    needs tens of GB of them.  Every loss and aux finite (aux above 0 where
    the model has MoE layers, 0 where it has none), flash attention
    launched twice a GQA layer and replica-step (forward and recompute),
    the SSD scan twice a Mamba-2 layer and replica-step, the pack kernel
    once a dtype group of the one host-lane snapshot (float32 parameters,
    float32 moments, the int32 count), and the state restored on the host
    lane byte for byte the snapshot it was restored from.  Returns (launch
    counts by dtype, step seconds, losses).  ``reduced`` says how the
    config was cut from its published size."""
    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    gc.collect()
    release = getattr(torch._C, "_host_emptyCache", None)
    if on_card:
        torch.cuda.empty_cache()
        if release is not None:
            release()
        torch.cuda.reset_peak_memory_stats()
    say(tag, pinned_cache_released=on_card and release is not None, **host_memory())
    ops.reset_launch_counts()

    def held_to_snapshot(t):
        params_flat, opt_flat = kept
        t0 = time.perf_counter()
        same_p, nb_p = state_matches(t.params, params_flat)
        same_o, nb_o = state_matches(t.opt_state, opt_flat)
        say(tag, restored_vs_snapshot_byte_exact=same_p and same_o, bytes=nb_p + nb_o,
            compare_s=f"{time.perf_counter() - t0:.2f}", **host_memory())
        check(same_p and same_o, f"{tag}: the state restored on the host lane differs "
              "from the snapshot it was restored from")
        kept.clear()

    with kept_restores() as kept:
        t, step_s, timings = run_elastic(cfg, TrainJobConfig(**job), log=tag,
                                         device=device, on_shrink=held_to_snapshot)
    if on_card:
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    by_dtype = ops.launch_counts_by_dtype()
    ms = t.metrics_log
    has_moe = any(cfg.ff_at(i) == FF_MOE for i in range(cfg.num_layers))
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["aux"])
              and (m["aux"] > 0) == has_moe for m in ms),
          f"{tag}: losses and aux {[(m['loss'], m['aux']) for m in ms]}")
    check([r.path for r in timings] == ["host", "p2p"],
          f"{tag}: paths {[r.path for r in timings]}")
    for r in timings:
        say(tag, rescale=r.path, **{k: f"{v:.4f}" for k, v in r.as_dict().items()})
    expected = {kernel: 2 * n * sum(MAIN_REPLICAS) if on_card else 0
                for kernel, n in mixer_layers(cfg).items()}
    # forward, recompute, and each product's two gradients
    expected["moe_gemm"] = 4 * moe_forward_launches(t.cfg, on_card) * sum(MAIN_REPLICAS)
    expected_pack = {"float32": 2, "int32": 1} if on_card else {}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    say(tag, arch=cfg.name, layers=cfg.num_layers, params=M.param_count(cfg),
        active_params=M.count_active_params(cfg), reduced=reduced,
        startup_s=f"{t.startup_time:.2f}", step_s=[round(x, 4) for x in step_s],
        tokens_per_s=f"{job['global_batch'] * job['seq_len'] / min(step_s):.0f}",
        peak_gb=f"{peak / 1e9:.2f}", **host_memory(), launches=json.dumps(counts),
        pack_launches=json.dumps(by_dtype["pack"]).replace(" ", ""),
        **{f"expected_{k}": n for k, n in expected.items()},
        expected_pack=json.dumps(expected_pack).replace(" ", ""))
    for kernel, n in expected.items():
        check(counts[kernel] == n, f"{tag}: {kernel} launches {counts[kernel]} != {n}")
    check(by_dtype["pack"] == expected_pack,
          f"{tag}: pack launches {by_dtype['pack']} != {expected_pack}")
    check(peak < CARD_MEMORY, f"{tag}: peak memory {peak / 1e9:.2f} GB")
    if on_card:
        profile_step(t)
    losses = [m["loss"] for m in ms]
    del t
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    say(tag, seconds=f"{time.perf_counter() - t_phase:.1f}")
    return by_dtype, step_s, losses


# -- phase 12 ------------------------------------------------------------------------

@contextlib.contextmanager
def routed_experts():
    """While open, each MoE layer call's per-expert assignment counts (the
    ``balance_stats`` counts ``moe_layer`` already returns, so no launch is
    added) are appended, in call order, to the list this yields."""
    seen = []
    layer = tfm.moe_layer

    def keep(cfg, p, x):
        y, stats = layer(cfg, p, x)
        seen.append(stats[1])
        return y, stats
    tfm.moe_layer = keep
    try:
        yield seen
    finally:
        tfm.moe_layer = layer


def decode_step_bytes(cfg, params, cache, batch, ctx, experts):
    """The least bytes a decode step with ``ctx`` tokens in the cache moves:
    every weight a decode step uses read once, except an untied embedding
    table (only the rows it gathers) and the routed experts (only the
    ``experts`` (layer, expert) pairs the step's routing selected; every MoE
    layer has the same widths); the cache entries (keys and values, or
    MLA's latent and rope key) of ``ctx + 1`` positions a layer read and the
    new position's written, or the SSM conv window and state read and
    written.  An encoder-decoder model's step uses no encoder weight and no
    cross ``wk``/``wv`` (the cross cache holds their products), and reads
    its cross cache once, writing none of it."""
    flat = {k: t for k, t in flatten_tree(params).items()
            if not k.startswith("encoder/") and not k.endswith(("/cross/wk", "/cross/wv"))}
    w = nbytes(*flat.values())
    if not cfg.tie_embeddings:
        e = params["embed"]
        w -= (e.shape[0] - batch) * e.shape[1] * e.element_size()
    routed = [t for key, t in flat.items()          # an MoE layer's w_gate/w_up/w_down
              if key.rsplit("/", 1)[0] + "/router" in flat and not key.endswith("/router")]
    if routed:
        moe_layers = sum(cfg.ff_at(i) == FF_MOE for i in range(cfg.num_layers))
        all_experts = moe_layers * cfg.moe.num_experts
        w -= nbytes(*routed) * (all_experts - experts) // all_experts
    c = 0
    for key, t in flatten_tree(cache).items():
        if "/kv/" in key:               # (layers, B, window, ...) or, prefix, (B, window, ...)
            per_pos = nbytes(t) // t.shape[1 if key.startswith("prefix/") else 2]
            c += per_pos * (ctx + 2)
        elif "/cross/" in key:          # the encoder's keys and values, read only
            c += nbytes(t)
        else:
            c += 2 * nbytes(t)
    return w + c


def serve_model(cfg, card, batch=SERVE["batch"], prompt=SERVE["prompt"],
                gen=SERVE["gen"], device="cuda", tag="serve", forced=True,
                reduced="none"):
    """Phase 12 for one model: a prefill of ``batch`` random prompts of
    ``prompt`` tokens, ``pad_cache`` to the serving window, ``gen - 1``
    greedy decode steps, each timed to a device sync and with the launch
    counts zeroed before and read after (a prefill launches flash attention
    once a GQA layer and the SSD scan once a Mamba-2 layer, a decode step
    neither); then (on the card) one prefill and one decode step under
    ``torch.profiler``; then, with ``forced``, teacher forcing: the
    training forward over the prompt and the decoded inputs (padded at the
    end to the SSD's chunk, which leaves earlier positions unchanged), its
    logits at the generated positions held to the decode logits (not under
    the MoE's gather dispatch, whose drops depend on the batch).  An
    encoder-decoder model's prefill and teacher forcing read the same
    ``prompt`` random frames a prompt (``enc_embeds``, from the prompts'
    seeded generator), and its prefill FLOPs count the encoder.  An MLA
    model's first decode step runs once more through the unabsorbed form
    first, from the same cache, and the two steps' logits are held together
    (each layer writes its new latent entry before it reads the cache, so
    the absorbed step's entries replace the unabsorbed one's).  Lines are
    logged under ``tag``; ``reduced`` says how ``cfg`` was cut.
    Returns the launch counts by dtype of the prefill."""
    t_model = time.perf_counter()
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, SERVE["seed"], device=device)
    g = torch.Generator(device=device).manual_seed(SERVE["seed"])
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g, device=device)
    frames = ({"enc_embeds": torch.randn((batch, prompt, cfg.d_model), generator=g,
                                         device=device)} if cfg.enc_layers else {})
    max_len = prompt + gen
    none = {k: {} for k in ops.launch_counts()}

    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cache, logits = M.prefill(cfg, params, {"tokens": prompts, **frames})
    sync()
    prefill_s = time.perf_counter() - t0
    prefill_counts = ops.launch_counts_by_dtype()
    t0 = time.perf_counter()
    cache = M.pad_cache(cfg, cache, prompt, max_len)
    sync()
    pad_s = time.perf_counter() - t0
    want = {k: {} for k in none}
    products = moe_forward_launches(cfg, on_card)
    if on_card:
        want.update({k: {"float32": n} for k, n in mixer_layers(cfg).items() if n})
    if products:
        want["moe_gemm"] = {"float32": products}
    check(prefill_counts == want, f"{tag} {cfg.name}: prefill launches {prefill_counts} "
          f"!= {want}")
    check(logits.shape == (batch, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"{tag} {cfg.name}: prefill logits {tuple(logits.shape)}")

    toks = logits.argmax(-1, keepdim=True)
    out, step_logits = [toks], [logits]
    ops.reset_launch_counts()
    if cfg.mla is not None:
        set_mla_absorb("decode", False)
        try:
            unabsorbed, _ = M.decode_step(cfg, params, cache, toks, prompt)
        finally:
            set_mla_absorb("decode", True)
        absorbed, _ = M.decode_step(cfg, params, cache, toks, prompt)
        scale = max(1.0, float(unabsorbed.abs().max()))
        err = float((absorbed - unabsorbed).abs().max()) / scale
        say(tag, arch=cfg.name, absorbed_vs_unabsorbed_pos=prompt,
            max_abs_err_over_scale=err, scale=scale, tol=SERVE_TF_TOL)
        check(math.isfinite(err) and err <= SERVE_TF_TOL,
              f"{tag} {cfg.name}: absorbed vs unabsorbed decode {err} > {SERVE_TF_TOL}")
        del unabsorbed, absorbed
        sync()
    t0 = time.perf_counter()
    with routed_experts() as routed:
        for pos in range(prompt, max_len - 1):
            logits, cache = M.decode_step(cfg, params, cache, toks, pos)
            toks = logits.argmax(-1, keepdim=True)
            out.append(toks)
            step_logits.append(logits)
        sync()
    decode_s = time.perf_counter() - t0
    decode_counts = ops.launch_counts_by_dtype()
    want_decode = dict(none)
    if products:        # each decode step, and an MLA model's two steps before them
        steps = max_len - 1 - prompt + (2 if cfg.mla is not None else 0)
        want_decode["moe_gemm"] = {"float32": products * steps}
    check(decode_counts == want_decode, f"{tag} {cfg.name}: decode launched "
          f"{decode_counts}, not {want_decode}")
    n = len(out) - 1
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    flops = fwd_flops(cfg, batch, prompt, enc_len=prompt)
    steps = range(prompt, max_len - 1)
    # the (layer, expert) pairs each step's routing selected
    moe_layers = sum(cfg.ff_at(i) == FF_MOE for i in range(cfg.num_layers))
    check(len(routed) == n * moe_layers, f"{tag} {cfg.name}: {len(routed)} MoE calls "
          f"in {n} decode steps of {moe_layers} MoE layers")
    chosen = [int((c > 0).sum()) for c in routed]
    experts = [sum(chosen[i * moe_layers:(i + 1) * moe_layers]) for i in range(n)]
    step_bytes = sum(decode_step_bytes(cfg, params, cache, batch, pos, e)
                     for pos, e in zip(steps, experts)) / n
    step_flops = sum(decode_flops(cfg, batch, pos) for pos in steps) / n
    bound_ms = step_bytes / PEAK_BYTES * 1e3
    step_ms = decode_s * 1e3 / n
    say(tag, arch=cfg.name, layers=cfg.num_layers, params=M.param_count(cfg),
        reduced=reduced, batch=batch, prompt=prompt, generated=gen, decode_steps=n,
        prefill_s=f"{prefill_s:.4f}", prefill_tokens_per_s=f"{batch * prompt / prefill_s:.0f}",
        pad_cache_s=f"{pad_s:.4f}", decode_s=f"{decode_s:.4f}",
        decode_ms_per_step=f"{step_ms:.4f}",
        decode_tokens_per_s=f"{batch * n / decode_s:.0f}",
        peak_gb=f"{peak / 1e9:.2f}", card=json.dumps(card))
    say(tag, arch=cfg.name, prefill_ref_flops=f"{flops:.6e}",
        ref_flops_count_masked_tiles=True,
        prefill_tflops=f"{flops / prefill_s / 1e12:.2f}",
        fp32_peak_share=f"{flops / prefill_s / H100_PEAK_FLOPS_FP32:.4f}",
        decode_ref_flops_per_step=f"{step_flops:.6e}",
        decode_bytes_per_step=f"{step_bytes:.6e}",
        **({"routed_experts_per_moe_layer": f"{sum(experts) / (n * moe_layers):.4f}"}
           if moe_layers else {}),
        decode_bound_ms_per_step=f"{bound_ms:.4f}",
        decode_of_bound=f"{bound_ms / step_ms:.4f}", card=json.dumps(card))
    say(tag, arch=cfg.name, prefill_launches=json.dumps(prefill_counts).replace(" ", ""),
        decode_launches=json.dumps(decode_counts).replace(" ", ""),
        expected_prefill=json.dumps(want).replace(" ", ""),
        expected_decode=json.dumps(want_decode).replace(" ", ""))

    if on_card:
        for what, fn in (("prefill", lambda: M.prefill(cfg, params,
                                                        {"tokens": prompts, **frames})),
                         ("decode_step", lambda: M.decode_step(cfg, params, cache, toks,
                                                               max_len - 1))):
            wall_ms, by_name, busy_ms = device_profile(fn)
            check(busy_ms > 0, f"{tag} {cfg.name}: the profiler saw no device time")
            say(tag, arch=cfg.name, profile=what, wall_ms=f"{wall_ms:.3f}",
                device_ms=f"{busy_ms:.3f}", idle_share=f"{1 - busy_ms / wall_ms:.4f}",
                kernels=sum(k for k, _ in by_name.values()),
                **{f"{grp}_ms": f"{v:.3f}" for grp, v in kernel_groups(by_name).items()})

    if forced:
        teacher_forcing(cfg, params, prompts, out, step_logits, tag, frames)
    del params, cache, step_logits, frames
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    say(tag, arch=cfg.name, seconds=f"{time.perf_counter() - t_model:.1f}")
    return prefill_counts           # the decode loop's are checked to be none


def teacher_forcing(cfg, params, prompts, out, step_logits, tag, frames=None):
    """The training forward over the prompt and the decoded inputs (padded
    at the end to the SSD's chunk, which leaves earlier positions
    unchanged; an encoder-decoder model's encoder over the prefill's
    ``frames``), its logits at the generated positions held to the decode
    logits within ``SERVE_TF_TOL`` x max(1, max |logit|)."""
    prompt = prompts.shape[1]
    seq = torch.cat([prompts, *out[:-1]], dim=1)         # the decode steps' inputs
    pad = -seq.shape[1] % cfg.ssm.chunk if cfg.ssm is not None else 0
    with torch.inference_mode():
        hidden, _ = M.forward_hidden(cfg, params, {"tokens": torch.nn.functional.pad(
            seq, (0, pad)), **(frames or {})})
        forced = torch.matmul(hidden[:, prompt - 1:seq.shape[1]],
                              M._head_weight(cfg, params))[..., :cfg.vocab_size].float()
    del hidden
    got = torch.stack(step_logits, dim=1)
    scale = max(1.0, float(forced.abs().max()))
    err = float((got - forced).abs().max()) / scale
    say(tag, arch=cfg.name, teacher_forcing_positions=got.shape[1],
        teacher_forcing_pad=pad, max_abs_err_over_scale=err, scale=scale, tol=SERVE_TF_TOL)
    check(math.isfinite(err) and err <= SERVE_TF_TOL,
          f"{tag} {cfg.name}: decode vs teacher forcing {err} > {SERVE_TF_TOL}")


def serve_cli_smoke(arch):
    """``python -m repro_torch.launch.serve --arch <arch> --smoke``, on the
    card by default: it must exit 0 and print its ``[serve]`` lines."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
                           "--smoke"], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    lines = proc.stdout.splitlines()
    say("serve", cli=arch, rc=proc.returncode, seconds=f"{time.perf_counter() - t0:.1f}")
    for line in lines:
        print(f"[serve] cli {arch} | {line}", flush=True)
    check(proc.returncode == 0, f"serve CLI {arch}: rc {proc.returncode}: {proc.stderr[-2000:]}")
    check(len(lines) >= 3 and lines[0].startswith("[serve] prefill")
          and lines[1].startswith("[serve] decoded"), f"serve CLI {arch}: {lines}")


def serve_phase(card):
    """Phase 12: both models served at full size, then the CLI smoke.
    Returns {serving path: launch counts by dtype}."""
    t_phase = time.perf_counter()
    counts = {serve_path(arch): serve_model(get_config(arch).with_(dtype="float32"), card)
              for arch in SERVE_ARCHS}
    for arch in SERVE_CLI_ARCHS:
        serve_cli_smoke(arch)
    say("serve", seconds=f"{time.perf_counter() - t_phase:.1f}", card=json.dumps(card))
    return counts


# -- phases 13, 14 and 15 -----------------------------------------------------------

def full_width_phase(arch, tag, card, train_layers, serve_layers, device="cuda",
                     train_cfg=None, serve_cfg=None, job=MOE_JOB, serve=SERVE, tf=MLA_TF):
    """A model at its full published width, cut in depth or not, logged
    under ``tag``: its training job at ``train_layers`` through phase 4's
    sequence (``job_phase``; its first loss held near ln V), the arch model
    beside its steady step; then served at ``serve_layers``
    (``serve_model``), its peak memory held under ``SERVE_PEAK``; then
    teacher forcing under the dense MoE at the ``tf`` sizes (batch 1), or,
    with ``tf`` None, on the serving run itself.  The configs and sizes
    default to the card's; the CPU tests pass smoke ones.  Returns (the
    training job's launch counts by dtype, the serving prefill's)."""
    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    full = get_config(arch)
    train_cfg = train_cfg or full.with_(num_layers=train_layers)
    serve_cfg = serve_cfg or full.with_(num_layers=serve_layers, dtype="float32")

    def cut(cfg):
        if (cfg.num_layers, cfg.enc_layers) == (full.num_layers, full.enc_layers):
            return "none"
        return f"depth:{cfg.num_layers}/{full.num_layers}"
    train_counts, step_s, losses = job_phase(
        train_cfg, tag, job=job, device=device, reduced=cut(train_cfg))
    ln_v = math.log(train_cfg.vocab_size)
    say(tag, arch=train_cfg.name, first_loss=losses[0], ln_vocab=ln_v,
        first_loss_minus_ln_vocab=losses[0] - ln_v, tol=FIRST_LOSS_TOL)
    check(abs(losses[0] - ln_v) <= FIRST_LOSS_TOL,
          f"{tag}: first loss {losses[0]} is not near ln V = {ln_v}")
    if on_card:
        arch_vs_card(train_cfg, step_s, card, tag=tag)
    serve_counts = serve_model(serve_cfg, card, device=device, tag=tag, forced=tf is None,
                               reduced=cut(serve_cfg),
                               **{k: serve[k] for k in ("batch", "prompt", "gen")})
    if on_card:         # serve_model reset the peak before its prefill
        peak = torch.cuda.max_memory_allocated()
        say(tag, arch=serve_cfg.name, serve_peak_gb=f"{peak / 1e9:.2f}",
            limit_gb=f"{SERVE_PEAK / 1e9:.0f}")
        check(peak < SERVE_PEAK, f"{tag}: serving peak {peak / 1e9:.2f} GB")
    if tf is not None:
        set_moe_impl("dense")
        try:
            serve_model(serve_cfg, card, device=device, tag=tag, reduced=cut(serve_cfg),
                        **tf)
        finally:
            set_moe_impl("gather")
    say(tag, seconds=f"{time.perf_counter() - t_phase:.1f}", card=json.dumps(card))
    return train_counts, serve_counts


def mla_phase(card, **kw):
    """Phase 13, ``[mla]`` lines: deepseek-v2-236b trained at depth 1 (the
    dense MLA prefix layer), served with 3 MoE layers (decode absorbed,
    checked against the unabsorbed form on its first step)."""
    return full_width_phase(DEEPSEEK, "mla", card, DEEPSEEK_TRAIN_LAYERS,
                            DEEPSEEK_SERVE_LAYERS, **kw)


def hybrid_phase(card, **kw):
    """Phase 14, ``[hybrid]`` lines: jamba-v0.1-52b trained at depth 1
    (layer 0: Mamba-2 and a dense SwiGLU), served at depth 8, one whole
    period (Mamba-2 and attention mixers, MoE and dense FFNs, the hybrid
    cache)."""
    return full_width_phase(JAMBA, "hybrid", card, JAMBA_TRAIN_LAYERS,
                            JAMBA_SERVE_LAYERS, **kw)


def encdec_phase(card, **kw):
    """Phase 15, ``[encdec]`` lines: seamless-m4t-large-v2 at its full
    published size, 24 encoder and 24 decoder layers, trained (flash in the
    decoder's causal self-attention, the blocked twin in the encoder's and
    in the cross attention) and served (the cross cache written by the
    prefill, read by every decode step), teacher forcing on the serving
    run with the same frames."""
    full = get_config(SEAMLESS).num_layers
    return full_width_phase(SEAMLESS, "encdec", card, full, full, tf=None, **kw)


def reduced_cell(arch, shape_name, cfg, *, seq_len, batch, mesh=None):
    """``launch.cells.make_cell`` with the cell's ``SHAPES`` entry overridden
    to ``seq_len`` tokens and ``batch`` sequences (the reference's
    ``tests/helpers/dryrun_small.py`` does the same)."""
    s = dry_cells.SHAPES[shape_name]
    orig = dry_cells.SHAPES
    dry_cells.SHAPES = dict(orig, **{shape_name: ShapeConfig(s.name, seq_len, batch, s.kind)})
    try:
        return dry_cells.make_cell(arch, shape_name, mesh or make_card_mesh(),
                                   cfg_override=cfg)
    finally:
        dry_cells.SHAPES = orig


def real_args(cell, seed, device):
    """Tensors on ``device`` for a train or prefill cell's abstract
    arguments: ``init_params``'s parameters, AdamW's zeros and step 0 in
    train, tokens and labels below the vocabulary and normal frames."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cfg = cell.cfg

    def batch_of(spec):
        return {k: (torch.randint(0, cfg.vocab_size, t.shape, generator=gen, device=device)
                    if t.dtype == torch.long else
                    torch.randn(t.shape, generator=gen, device=device).to(t.dtype))
                for k, t in spec.items()}
    params = M.init_params(cfg, seed, device)
    if cell.shape.kind == "train":
        return (params, adamw_init(params), batch_of(cell.abstract_args[2]),
                torch.zeros((), dtype=torch.int32, device=device))
    return params, batch_of(cell.abstract_args[1])


def cell_launches(cfg, kind):
    """(flash, SSD) launches of one train step (forward and the layer's
    checkpoint recompute) or one prefill: one a causal self-attention or
    Mamba-2 layer and pass."""
    passes = 2 if kind == "train" else 1
    mixers = [cfg.mixer_at(i) for i in range(cfg.num_layers)]
    return passes * mixers.count(ATTN), passes * mixers.count(SSM)


def float32_config(arch):
    return get_config(arch).with_(dtype="float32")


def tracker_vs_allocator(arch, shape_name, cfg, shape, device="cuda"):
    """One reduced cell traced on meta, then run for real on ``device``
    under the same tracker: the meta trace's peak against the allocator's
    (cuda) or the real run's tracker (cpu, the rehearsal)."""
    cell = reduced_cell(arch, shape_name, cfg, **shape)
    ops.reset_launch_counts()
    meta = cell.trace()
    check(sum(ops.launch_counts().values()) == 0, f"{arch}: a meta trace launched")
    gc.collect()
    on_card = torch.device(device).type == "cuda"
    resident = torch.cuda.memory_allocated() if on_card else 0
    args = real_args(cell, 0, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    real = dataclasses.replace(cell, abstract_args=args).trace(torch.device(device).type)
    if on_card:
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - resident if on_card else real.peak_bytes
    del args
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    flash, ssd = cell_launches(cfg, cell.shape.kind)
    ratio = meta.peak_bytes / peak
    say("dryrun", check="tracker_vs_allocator", arch=arch, shape=shape_name,
        batch=cell.shape.global_batch, seq_len=cell.shape.seq_len, dtype=cfg.dtype,
        layers=cfg.num_layers, meta_peak_gb=meta.peak_bytes / 1e9,
        real_tracker_peak_gb=real.peak_bytes / 1e9, allocator_peak_gb=peak / 1e9,
        resident_gb=resident / 1e9, meta_over_allocator=ratio,
        flash=counts["flash_attention"], ssd=counts["ssd"], step_s=f"{step_s:.2f}")
    check(abs(meta.peak_bytes - peak) <= DRYRUN_PEAK_TOL * peak,
          f"{arch} {shape_name}: the meta trace's peak {meta.peak_bytes} is not "
          f"within {DRYRUN_PEAK_TOL} of the allocator's {peak}")
    if on_card:
        check((counts["flash_attention"], counts["ssd"]) == (flash, ssd),
              f"{arch} {shape_name}: launches {counts}, not flash {flash}, ssd {ssd}")
    return ratio


def dryrun_phase(card, *, device="cuda", workers=DRYRUN_WORKERS, targets=None,
                 real=DRYRUN_REAL, real_shape=DRYRUN_REAL_SHAPE, cfg_of=float32_config):
    """Phase 16, ``[dryrun]`` lines: (a) every applicable cell of
    ``all_cells()`` traced on meta at its full published size on the card's
    mesh: argument, temp and peak GB, ``fits_hbm``, the traced FLOPs against
    ``utils.flops.cell_flops``, the H100 roofline's bottleneck and
    ``mfu_bound``; (b) the per-device argument GB of every cell on the
    reference's pod meshes; (c) the tracker's peak against the allocator's
    on the reduced cells of ``real`` (each arch's ``cfg_of(arch)`` at
    ``real_shape``), run for real on the card."""
    t_phase = time.perf_counter()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        say("dryrun", resident_at_entry_gb=torch.cuda.memory_allocated() / 1e9)
    targets = targets or [(a, s) for a, s, ok, _ in dry_cells.all_cells() if ok]
    # longest first: the train cells of the Mamba-2 layouts, then the others
    order = sorted(targets, key=lambda c: (not c[1].startswith("train"),
                                           get_config(c[0]).ssm is None))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [(c, pool.submit(dryrun.run_cell, *c)) for c in order]
        for mesh in DRYRUN_POD_MESHES:                                  # (b)
            for arch, shape in targets:
                rec = dryrun.run_cell(arch, shape, mesh_name=mesh)
                say("dryrun", arch=arch, shape=shape, mesh=mesh, chips=rec["chips"],
                    rules=rec["rules"],
                    argument_gb=rec["memory"]["argument_bytes"] / 1e9,
                    fits_hbm_arguments=rec["fits_hbm_arguments"])
        ratios = [tracker_vs_allocator(a, s, cfg_of(a), real_shape, device)
                  for a, s in real]                                         # (c)
        results = [(c, f.result()) for c, f in futures]                   # (a)
    for (arch, shape), rec in results:
        check(rec["status"] == "ok", f"{arch} {shape}: {rec}")
        mem, rl = rec["memory"], rec["roofline"]
        analytic = cell_flops(get_config(arch), dry_cells.SHAPES[shape])
        say("dryrun", arch=arch, shape=shape, mesh=rec["mesh"], rules=rec["rules"],
            argument_gb=mem["argument_bytes"] / 1e9, temp_gb=mem["temp_bytes"] / 1e9,
            peak_gb=mem["peak_bytes"] / 1e9, fits_hbm=rec["fits_hbm"],
            traced_flops=rec["traced_cost"]["flops"], cell_flops=analytic,
            traced_over_cell=rec["traced_cost"]["flops"] / analytic,
            kernel_flops=json.dumps(rec["traced_cost"]["kernel_flops"]).replace(" ", ""),
            bottleneck=rl["bottleneck"], mfu_bound=rl["mfu_bound"], trace_s=rec["trace_s"])
        check(rec["traced_cost"]["flops"] > 0 and mem["temp_bytes"] > 0,
              f"{arch} {shape}: an empty trace")
    fits = sorted(f"{a}|{s}" for (a, s), rec in results if rec["fits_hbm"])
    say("dryrun", cells=len(results), fit_one_card=json.dumps(fits).replace(" ", ""),
        tracker_vs_allocator=json.dumps([round(r, 4) for r in ratios]),
        seconds=f"{time.perf_counter() - t_phase:.1f}", card=json.dumps(card))
    return results


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    say("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    build_kernels()

    gen = torch.Generator(device="cuda").manual_seed(0)
    paths = [get_config("yi-6b").with_(num_layers=4), get_config("mamba2-1.3b")]
    check(M.param_count(paths[1]) == MAMBA2_PARAMS,
          f"mamba2-1.3b has {M.param_count(paths[1])} parameters")
    granite = get_config(GRANITE)
    check((M.param_count(granite), M.count_active_params(granite))
          == (GRANITE_PARAMS, GRANITE_ACTIVE_PARAMS),
          f"{GRANITE} has {M.param_count(granite)} parameters, "
          f"{M.count_active_params(granite)} active")
    deepseek, jamba, seamless = get_config(DEEPSEEK), get_config(JAMBA), get_config(SEAMLESS)
    check(M.param_count(seamless) == SEAMLESS_PARAMS,
          f"{SEAMLESS} has {M.param_count(seamless)} parameters, not {SEAMLESS_PARAMS}")
    for cfg, layers, n in ((deepseek, DEEPSEEK_TRAIN_LAYERS, DEEPSEEK_TRAIN_PARAMS),
                           (deepseek, DEEPSEEK_SERVE_LAYERS, DEEPSEEK_SERVE_PARAMS),
                           (jamba, JAMBA_TRAIN_LAYERS, JAMBA_TRAIN_PARAMS),
                           (jamba, JAMBA_SERVE_LAYERS, JAMBA_SERVE_PARAMS)):
        got = M.param_count(cfg.with_(num_layers=layers))
        check(got == n, f"{cfg.name} at depth {layers} has {got} parameters, not {n}")
    records = [*check_flash(gen), check_rmsnorm(gen), *check_ssd(gen), *check_moe_gemm(gen)]
    records += [check_pack(cfg, gen, "pack", cfg.name) for cfg in paths]
    records.append(check_pack(paths[0], gen, "pack_bf16", BF16_PATH, torch.bfloat16))
    # the host-lane snapshot's float32 parameter group at granite's size
    records.append(check_pack(granite, gen, "pack_granite", GRANITE, torch.float32))
    # the host-lane snapshot of phase 13's training job: all three groups
    records.append(check_pack(deepseek.with_(num_layers=DEEPSEEK_TRAIN_LAYERS), gen,
                              "pack_deepseek", DEEPSEEK))
    records.append(check_pack(jamba.with_(num_layers=JAMBA_TRAIN_LAYERS), gen,
                              "pack_jamba", JAMBA))
    records.append(check_pack(seamless, gen, "pack_seamless", SEAMLESS))
    runs = {cfg.name: main_path(cfg) for cfg in paths}
    counts = {name: c for name, (c, _, _) in runs.items()}    # by path
    for arch in [cfg.name for cfg in paths] + [GRANITE, DEEPSEEK, JAMBA, SEAMLESS]:
        trajectory(arch)
    for arch in [cfg.name for cfg in paths] + list(CLI_ARCHS):
        train_cli_smoke(arch)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as trace_dir:
        op_counts, op_traces = operator_phase(
            paths[0], paths[1].with_(num_layers=OPERATOR_MAMBA2_LAYERS), trace_dir)
        simulator_phase(op_traces, [(cfg, runs[cfg.name][1]) for cfg in paths], card,
                        trace_dir)
        counts[BF16_PATH] = bf16_phase(paths[0], os.path.join(trace_dir, "bf16_ckpt"),
                                       runs[paths[0].name][2][0])
        cloud_phase(card, trace_dir)
    counts[GRANITE], moe_steps, _ = job_phase(granite, "moe")
    arch_vs_card(granite, moe_steps, card)
    counts.update(serve_phase(card))
    counts[DEEPSEEK], counts[serve_path(DEEPSEEK)] = mla_phase(card)
    counts[JAMBA], counts[serve_path(JAMBA)] = hybrid_phase(card)
    counts[SEAMLESS], counts[serve_path(SEAMLESS)] = encdec_phase(card)
    dryrun_phase(card)
    for rec in records:     # launches on the path its shapes are from, and the operator's
        rec["launches"] = launches_of(rec, counts.get(rec["path"], {}))
        rec["operator_launches"] = launches_of(rec, op_counts)
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
