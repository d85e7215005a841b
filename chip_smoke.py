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
   the device ms of each of its three launches (torch.profiler);
4. the main paths, each an ElasticTrainer at global batch 8 x 2048 on 4
   logical replicas, stepped, shrunk to 2 on the host lane, stepped,
   expanded to 4 on the p2p lane, stepped; launch counts are zeroed just
   before each path and read just after it; then one more step under
   ``torch.profiler`` (device busy share, kernels by device time).  First
   yi-6b at full width with depth cut to 4 layers, then mamba2-1.3b at its
   full published size (48 layers, 1,344,052,224 parameters);
5. a static vs rescaled trajectory check at depth 1, for each path;
6. ``repro_torch.launch.train --smoke`` on the card with ``--rescale-at``,
   ``--checkpoint-dir`` and ``--restart``, for each arch;
7. the live operator (``ElasticClusterController``) at full width, with
   the launch counts zeroed before the phase and read after it: scenario A
   (priority shrink and expand-back of two yi-6b depth-4 jobs on 8 logical
   slots, then the low job's static run, losses within ``TRAJ_LOSS_TOL``)
   and scenario B (a Mamba-2 victim at depth 8 beside a yi-6b neighbor on
   two nodes of 4: a fused async checkpoint under an in-place step, a node
   failure and restart from disk, a drain migration on the host lane).  The
   ``[operator]`` lines give each rescale's stages and path, each
   scenario's ``ScheduleMetrics.row()``, peak memory, live trainers and
   seconds, and the launches against those the steps imply.

The last lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Each kernel record names the main path
whose shapes it was measured at and holds its launches on that path, and
its launches on the operator path (``operator_launches``); the pack kernel,
which runs on both, has one record per path; the bf16 instantiations of
flash attention and the SSD scan, on no path, have records of their own
with ``"path": null`` and 0 launches.
"""
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# keep Triton's compile cache inside the checkout's ignored build directory
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))

from repro_torch.checkpoint import DiskCheckpointStore, flatten_tree  # noqa: E402
from repro_torch.configs import ATTN, get_config  # noqa: E402
from repro_torch.core import (ElasticClusterController, ElasticTrainer,  # noqa: E402
                              JobSpec, JobStatus, PolicyConfig, TrainJobConfig,
                              local_slots)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.pack import pack_leaves  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_fwd  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): float32 outside the tensor cores,
# bf16 tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
RMSNORM_TOL = 1e-5
# atol = rtol, the reference's own SSD tolerances (tests/test_kernels.py:79)
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
MAMBA2_PARAMS = 1_344_052_224
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


def record(name, path, dtype, source, replaces, err, ms, plain, lib, b_ms, b_by,
           flops, route="cuda"):
    """One entry of the kernels line: the kernel's times beside its bound,
    the share of the bound it reaches and its rate."""
    return {"name": name, "path": path, "dtype": dtype_name(dtype), "route": route,
            "source": source, "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "of_bound": b_ms / ms, "tflops": flops / ms / 1e9}


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
    B, S, H, KV, hd = 2, 2048, 32, 4, 128         # one replica's shard at R=4
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((B, S, H, hd), device="cuda", generator=gen).to(dtype)
        k = torch.randn((B, S, KV, hd), device="cuda", generator=gen).to(dtype)
        v = torch.randn((B, S, KV, hd), device="cuda", generator=gen).to(dtype)
        out, lse = flash_attention_fwd(q, k, v)
        exp = ref.flash_attention_ref(q.float(), k.float(), v.float()).to(dtype)
        err = float((out.float() - exp.float()).abs().max())
        lse_err = float((lse - ref.attention_lse_ref(q.float(), k.float())).abs().max())
        del exp
        check(math.isfinite(err) and err <= FLASH_TOL[dtype],
              f"flash {dtype} max_abs_err {err} > {FLASH_TOL[dtype]}")
        check(lse_err <= 1e-4, f"flash {dtype} lse err {lse_err}")
        ms = time_ms(lambda: flash_attention_fwd(q, k, v), 10)
        plain = time_ms(lambda: ref.flash_attention_ref(q, k, v), 3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 10)
        flops = 4 * hd * B * H * S * (S + 1) // 2      # causal pairs only
        b_ms, b_by = bound(nbytes(q, k, v, out, lse), flops, dtype)
        f32 = dtype == torch.float32                     # the main path's type
        recs.append(record(
            "flash_attention" if f32 else "flash_attention_bf16",
            "yi-6b" if f32 else None, dtype,
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:26", err, ms, plain, lib,
            b_ms, b_by, flops))
        say("kernels", kernel="flash_attention", dtype=dtype_name(dtype),
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
    return record("rmsnorm", "yi-6b", torch.float32,
                  "src/repro_torch/kernels/rmsnorm.py",
                  "src/repro/kernels/rmsnorm.py:11", err, ms, plain, lib, b_ms,
                  b_by, 4 * x.numel(), route="triton")


def pack_groups(cfg, gen):
    """The leaf lists that the host-lane shrink of ``cfg``'s trainer packs,
    one per pack launch, grouped as ``packed_snapshot_to_host`` groups them:
    the float32 parameters, the float32 AdamW moments and the int32 step
    count.  Moments and count are filled, so the bytes compared are not all
    zero."""
    params = M.init_params(cfg.with_(dtype=TrainJobConfig.dtype), 0, device="cuda")
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


def check_pack(cfg, gen):
    """The pack kernel on each leaf list of ``cfg``'s host-lane shrink: byte
    equality with ``pack_leaves_ref``, and the times of the whole snapshot's
    launches (sums of each launch's median)."""
    ms = plain = 0.0
    moved = 0
    groups = pack_groups(cfg, gen)
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
        say("kernels", kernel="pack", path=cfg.name,
            dtype=str(leaves[0].dtype).split(".")[1], leaves=len(leaves),
            gb=f"{nbytes(*leaves) / 1e9:.3f}", byte_identical=same, ms=g_ms,
            plain_ms=g_plain)
        ms, plain, moved = ms + g_ms, plain + g_plain, moved + nbytes(*leaves, out)
        del out
    b_ms, b_by = bound(moved, 0, torch.float32)
    say("kernels", kernel="pack", path=cfg.name, launches_per_snapshot=len(groups),
        gb_moved=f"{moved / 1e9:.3f}", ms=ms, plain_ms=plain, library_ms=None,
        bound_ms=b_ms, bound_by=b_by)
    del groups
    return record("pack", cfg.name, None, "src/repro_torch/csrc/pack.cu",
                  "src/repro/kernels/pack.py:40", 0.0, ms, plain, None, b_ms,
                  b_by, 0)


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
    B, L, H, P, G, N, Q = 2, 2048, 64, 64, 1, 128, 128   # one replica's shard at R=4
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        args = _ssd_inputs(gen, B, L, H, P, G, N, dtype)
        y = ssd_scan_fwd(*args, chunk=Q)
        err, frac = _ssd_err(y, ref.ssd_chunked_ref(*args, chunk=Q), SSD_TOL[dtype])
        check(frac <= 1.0, f"ssd {dtype} max_abs_err {err}: {frac} of the "
              f"allowance atol=rtol={SSD_TOL[dtype]}")
        ms = time_ms(lambda: ssd_scan_fwd(*args, chunk=Q), 10)
        phases = {re.search(r"ssd_\w+_kernel", name).group(0): t for name, t in
                  device_ms_by_kernel(lambda: ssd_scan_fwd(*args, chunk=Q)).items()}
        check(len(phases) == 3, f"ssd launched {sorted(phases)}, not three phases")
        say("kernels", kernel="ssd", dtype=dtype_name(dtype), phases_device_ms=json.dumps(
            {k: round(v, 4) for k, v in phases.items()}).replace(" ", ""))
        plain = time_ms(lambda: ref.ssd_chunked_ref(*args, chunk=Q), 3, warmup=1)
        pairs = Q * (Q + 1) // 2                         # causal pairs only
        flops = B * H * (L // Q) * (2 * pairs * (N + P) + 4 * Q * N * P)
        b_ms, b_by = bound(nbytes(*args, y), flops, dtype)
        f32 = dtype == torch.float32                     # the main path's type
        recs.append(record(
            "ssd" if f32 else "ssd_bf16", "mamba2-1.3b" if f32 else None, dtype,
            "src/repro_torch/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:24",
            err, ms, plain, None, b_ms, b_by, flops))
        say("kernels", kernel="ssd", dtype=dtype_name(dtype),
            shape=f"B{B}xL{L}xH{H}xP{P}xG{G}xN{N}xQ{Q}", max_abs_err=err,
            atol_rtol=SSD_TOL[dtype], of_allowance=frac, ms=ms, plain_ms=plain,
            library_ms=None, bound_ms=b_ms, bound_by=b_by, flops=flops,
            bytes=nbytes(*args, y), of_bound=recs[-1]["of_bound"],
            tflops=recs[-1]["tflops"])
        del args, y
    # long memory: dt about 0.004 (the low end of Mamba-2's dt init), so
    # dt*A sums to a few units over a chunk and the state carried from
    # earlier chunks makes up about half of y (by norm, past the first chunk)
    for dtype in (torch.float32, torch.bfloat16):
        args = _ssd_inputs(gen, B, L, H, P, G, N, dtype, dt_shift=-6.0)
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

def run_elastic(cfg, job, steps=(2, 2, 2), log=True):
    """steps at R=4, host-lane shrink to 2, steps, p2p expand to 4, steps."""
    slots = local_slots(4)
    t = ElasticTrainer(cfg, job, slots, device="cuda")
    step_s, timings = [], []

    def run(n):
        for _ in range(n):
            t0 = time.perf_counter()
            m = t.step()
            step_s.append(time.perf_counter() - t0)
            if log:
                say("main", step=m["step"], replicas=m["replicas"],
                    loss=m["loss"], grad_norm=m["grad_norm"],
                    seconds=f"{step_s[-1]:.3f}")
    run(steps[0])
    timings.append(t.rescale(slots[2:], via_host=True))
    run(steps[1])
    timings.append(t.rescale(slots))
    run(steps[2])
    return t, step_s, timings


def main_path(cfg):
    job = TrainJobConfig(global_batch=8, seq_len=2048, total_steps=6, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t, step_s, timings = run_elastic(cfg, job)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    losses = [m["loss"] for m in t.metrics_log]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check([r.path for r in timings] == ["host", "p2p"],
          f"paths {[r.path for r in timings]}")
    for r in timings:
        say("main", rescale=r.path, **{k: f"{v:.4f}" for k, v in r.as_dict().items()})
    per_step = [4, 4, 2, 2, 4, 4]
    kernel = "flash_attention" if cfg.mixer_at(0) == ATTN else "ssd"
    expected = 2 * cfg.num_layers * sum(per_step)       # fwd + recompute
    say("main", arch=cfg.name, layers=cfg.num_layers, params=M.param_count(cfg),
        startup_s=f"{t.startup_time:.2f}", step_s=[round(s, 4) for s in step_s],
        tokens_per_s=f"{job.global_batch * job.seq_len / min(step_s):.0f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        launches=json.dumps(counts), **{f"expected_{kernel}": expected})
    check(counts[kernel] == expected,
          f"{kernel} launches {counts[kernel]} != {expected}")
    check(counts["pack"] > 0, "the host lane did not go through the pack kernel")
    profile_step(t)
    del t
    torch.cuda.empty_cache()
    return counts


KERNEL_GROUPS = (("ssd", ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")),
                 ("flash_attention", ("flash_fwd_",)), ("pack", ("pack_kernel",)),
                 ("gemm", ("gemm", "xmma", "cutlass")), ("softmax", ("softmax",)),
                 ("reduce", ("reduce",)), ("index", ("index", "scatter", "gather")),
                 ("elementwise", ("elementwise",)))


def kernel_group(name):
    low = name.lower()
    for group, words in KERNEL_GROUPS:
        if any(w in low for w in words):
            return group
    return "other"


def profile_step(t, top=8):
    """One more steady step at R=4 under torch.profiler: device busy share,
    device time by kernel group and the kernels that take the most (after
    the launch counts were read, so it does not add to them).  Only device
    activity is traced."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    by_name = kernel_times(prof)
    busy_ms = sum(ms for _, ms in by_name.values())
    groups = {}
    for name, (_, ms) in by_name.items():
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    check(busy_ms > 0, "the profiler saw no device time")
    say("profile", arch=t.cfg.name, replicas=t.replicas, wall_ms=f"{wall_ms:.1f}",
        device_ms=f"{busy_ms:.1f}", idle_share=f"{1 - busy_ms / wall_ms:.3f}",
        kernels=sum(n for n, _ in by_name.values()),
        parse_s=f"{time.perf_counter() - t1:.1f}",
        **{f"{g}_ms": f"{v:.1f}" for g, v in sorted(groups.items(),
                                                    key=lambda kv: -kv[1])})
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        say("profile", ms=f"{ms:.2f}", calls=n, kernel=name[:90].replace(" ", "_"))


def trajectory(arch):
    cfg = get_config(arch).with_(num_layers=1)
    job = TrainJobConfig(global_batch=8, seq_len=256, total_steps=6, seed=1)
    static = ElasticTrainer(cfg, job, local_slots(4), device="cuda")
    for _ in range(6):
        static.step()
    el, _, timings = run_elastic(cfg, job, log=False)
    la = [m["loss"] for m in static.metrics_log]
    lb = [m["loss"] for m in el.metrics_log]
    lerr = max(abs(a - b) for a, b in zip(la, lb))
    fa, fb = flatten_tree(static.params), flatten_tree(el.params)
    perr = max(float((fa[k] - fb[k]).detach().abs().max()) for k in fa)
    say("trajectory", arch=arch, depth=1, loss_err=lerr, param_err=perr,
        loss_tol=TRAJ_LOSS_TOL, param_tol=TRAJ_PARAM_TOL,
        paths=[r.path for r in timings], loss_first=la[0], loss_last=la[-1])
    check(lerr <= TRAJ_LOSS_TOL, f"trajectory loss err {lerr}")
    check(perr <= TRAJ_PARAM_TOL, f"trajectory param err {perr}")
    del static, el
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


def operator_phase(yi_cfg, victim_cfg):
    """Phase 7: the live operator at full width on the card, scenarios A and
    B, with the launch counts zeroed before and read after the phase."""
    t_phase = time.perf_counter()
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
    op, m = scenario_priority(yi_cfg, low_job, high_job, device)
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
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        op, m, dropped, timings = scenario_faults(victim_cfg, victim_job, yi_cfg,
                                                  neighbor_job, device, d)
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
    expected = expected_launches(records, timings["snapshot_packs"])
    say("operator", launches=json.dumps(counts).replace(" ", ""),
        expected=json.dumps(expected).replace(" ", ""),
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    for kernel in ("flash_attention", "ssd", "pack"):
        check(expected[kernel] > 0, f"the operator path implies no {kernel} launch")
        check(counts[kernel] == expected[kernel],
              f"operator path: {kernel} launches {counts[kernel]} != {expected[kernel]}")
    return counts


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
    records = [*check_flash(gen), check_rmsnorm(gen), *check_ssd(gen)]
    records += [check_pack(cfg, gen) for cfg in paths]
    counts = {cfg.name: main_path(cfg) for cfg in paths}
    for rec in records:     # each record's launches on the path its shapes are from
        rec["launches"] = counts[rec["path"]][rec["name"]] if rec["path"] else 0
    for cfg in paths:
        trajectory(cfg.name)
    for cfg in paths:
        train_cli_smoke(cfg.name)
    op_counts = operator_phase(paths[0], paths[1].with_(num_layers=OPERATOR_MAMBA2_LAYERS))
    for rec in records:
        rec["operator_launches"] = op_counts[rec["name"]] if rec["path"] else 0
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
