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
   ``--checkpoint-dir`` and ``--restart``, for each arch.

The last lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Each kernel record names the main path
whose shapes it was measured at and holds its launches on that path; the
pack kernel, which runs on both, has one record per path; the bf16
instantiations of flash attention and the SSD scan, on no path, have
records of their own with ``"path": null`` and 0 launches.
"""
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

from repro_torch.checkpoint.reshard import flatten_tree  # noqa: E402
from repro_torch.configs import ATTN, get_config  # noqa: E402
from repro_torch.core.elastic import (ElasticTrainer, TrainJobConfig,  # noqa: E402
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
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
