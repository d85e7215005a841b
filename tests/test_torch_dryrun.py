"""The port's dry-run against the JAX package's: the cell list and skip
reasons, MODEL_FLOPS, the roofline terms under one ``HW``; the live-bytes
tracker on known allocations; smoke-size meta traces of six layouts at the
reference helper's reduced shapes (no kernel launch); the CLI's records; the
kernel wrappers' meta branches; the MoE counts without ``bincount``; and the
trainer's ``model_axis`` validation.  Torch runs on one intra-op thread."""
import dataclasses
import gc
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.cells as jcells  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.core.elastic import ElasticTrainer as JTrainer  # noqa: E402
from repro.core.elastic import TrainJobConfig as JJob  # noqa: E402
from repro.utils import roofline as jroof  # noqa: E402

import repro_torch.launch.cells as pcells  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.core.elastic import ElasticTrainer, TrainJobConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.moe_gemm import NN, NT, TN, ragged_gemm  # noqa: E402
from repro_torch.kernels.pack import pack_leaves  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_fwd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import MeshShape, make_card_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.utils import roofline as proof  # noqa: E402
from repro_torch.utils.memtrace import BLOCK, MemTracker, note_kernel_flops  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- cells ---------------------------------------------------------------------

def test_all_cells_equal_the_reference():
    assert pcells.all_cells() == jcells.all_cells()
    assert sum(ok for *_, ok, _ in pcells.all_cells()) == 32


def test_model_flops_equal_the_reference_to_the_last_bit():
    for arch, sname, ok, _ in pcells.all_cells():
        got = pcells._model_flops(get_config(arch), SHAPES[sname])
        assert got == jcells._model_flops(jget_config(arch), JSHAPES[sname]), (arch, sname)


def test_rule_names_and_overrides_equal_the_reference():
    assert pcells._FSDP_ARCHS == jcells._FSDP_ARCHS
    assert pcells._NO_SP_ARCHS == jcells._NO_SP_ARCHS
    assert pcells.ARCH_OVERRIDES == jcells.ARCH_OVERRIDES
    for arch, sname, ok, _ in pcells.all_cells():
        assert pcells.train_rules_name(arch) == jcells.train_rules_name(arch)
        assert (pcells.decode_rules_name(arch, SHAPES[sname])
                == jcells.decode_rules_name(arch, JSHAPES[sname]))


# -- roofline ------------------------------------------------------------------

@pytest.mark.parametrize("terms", [(1000.0, 50.0, 2.0, 8000.0, 16),
                                   (10.0, 2000.0, 0.0, 100.0, 1),
                                   (3.0e15, 1.2e12, 5.0e10, 2.0e15, 256),
                                   (0.0, 0.0, 0.0, 0.0, 4)])
def test_roofline_terms_equal_the_reference(terms):
    for kw in ({}, dict(peak_flops=100.0, hbm_bw=10.0, ici_bw=1.0)):
        jhw = jroof.HW(**kw) if kw else jroof.HW(peak_flops=proof.H100.peak_flops,
                                                 hbm_bw=proof.H100.hbm_bw,
                                                 ici_bw=proof.H100.ici_bw,
                                                 hbm_bytes=proof.H100.hbm_bytes)
        phw = proof.HW(**dataclasses.asdict(jhw))
        got = proof.RooflineTerms(*terms, hw=phw).as_dict()
        assert got == jroof.RooflineTerms(*terms, hw=jhw).as_dict()
        f, b, c, m, chips = terms
        got = proof.roofline_from_analysis({"flops": f, "bytes accessed": b}, c, m,
                                           chips, hw=phw).as_dict()
        assert got == jroof.roofline_from_analysis(
            {"flops": f, "bytes accessed": b}, c, m, chips, hw=jhw).as_dict()


def test_default_hw_is_the_h100():
    from repro_torch.core.perf_model import (H100_HBM_BW, H100_NVLINK_BW,
                                             H100_PEAK_FLOPS_BF16)
    assert proof.HW() == proof.H100
    assert proof.H100 == proof.HW(H100_PEAK_FLOPS_BF16, H100_HBM_BW, H100_NVLINK_BW, 80e9)
    assert proof.RooflineTerms(1.0, 1.0, 0.0, 1.0, 1).hw == proof.H100
    assert proof.roofline_from_analysis(None, 0.0, 1.0, 1).hw == proof.H100
    assert proof.roofline_from_analysis(None, 0.0, 1.0, 1).flops_per_device == 0.0


# -- the live-bytes tracker ----------------------------------------------------

def _r(n):
    return -(-n // BLOCK) * BLOCK


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_tracker_counts_known_live_bytes(device):
    a = torch.zeros(1000, device=device)                 # 4000 -> 4096 at entry
    with MemTracker(device, entry=[a, a[10:]]) as mt:
        assert mt.entry_bytes == mt.live_bytes == _r(4000)
        b = torch.empty((256, 256), device=device)       # 262144
        v = b.view(-1)[:100]                             # a view: nothing new
        b.add_(1.0)                                      # in place: nothing new
        assert mt.live_bytes == _r(4000) + 262144
        c = b * 2                                        # another 262144
        del b, v
        gc.collect()
        assert mt.live_bytes == _r(4000) + 262144
        d = torch.ones(3, dtype=torch.int8, device=device)   # rounded to a block
        assert mt.live_bytes == _r(4000) + 262144 + BLOCK
        del c, d
        gc.collect()
        assert mt.live_bytes == _r(4000)
    assert mt.peak_bytes == _r(4000) + 2 * 262144


def test_tracker_follows_backward_inference_and_other_devices():
    w = torch.empty((64, 32), device="meta", requires_grad=True)
    x = torch.empty((8, 64), device="meta")
    host = torch.zeros(10)
    with MemTracker("meta", entry=[w, x]) as mt:
        (x @ w).sum().backward()                         # w.grad is new: 8192
        with torch.inference_mode():
            y = torch.empty((128,), device="meta") + 1   # inference tensors count
        host2 = host + 1                                 # a cpu tensor: not counted
        note_kernel_flops("k", 7)
    assert w.grad is not None and y.is_inference() and host2.device.type == "cpu"
    assert mt.live_bytes == mt.entry_bytes + 64 * 32 * 4 + BLOCK
    assert mt.kernel_flops == {"k": 7}
    assert mt.bytes_accessed > 0
    note_kernel_flops("k", 5)                            # no tracker active
    assert mt.kernel_flops == {"k": 7}


def test_tracker_counts_the_cuda_kernels_own_temporaries():
    """logsumexp's ``x - max`` (and the max and its mask); softmax
    backward's ``grad * output`` and the contiguous copy of a
    non-contiguous product."""
    x = torch.empty((64, 1000), device="meta")
    with MemTracker("meta", entry=[x]) as mt:
        y = torch.logsumexp(x, dim=-1)
    out = _r(64 * 4)
    assert mt.live_bytes == _r(256000) + out
    assert mt.peak_bytes == _r(256000) + out + _r(256000) + out + _r(64)
    g = torch.empty((4, 8, 16), device="meta").transpose(1, 2)     # not contiguous
    o = torch.empty((4, 16, 8), device="meta")
    for grad, copies in ((g, 2), (g.contiguous(), 1)):
        with MemTracker("meta", entry=[grad, o]) as mt:
            gi = torch.ops.aten._softmax_backward_data(grad, o, -1, torch.float32)
        n = _r(4 * 8 * 16 * 4)
        assert mt.peak_bytes == mt.entry_bytes + n + copies * n
    assert y.shape == (64,) and gi.shape == o.shape


# -- meta traces at smoke size -------------------------------------------------

SMOKE_CELLS = [("yi-6b", "train_4k"), ("granite-moe-3b-a800m", "train_4k"),
               ("mamba2-1.3b", "decode_32k"), ("jamba-v0.1-52b", "long_500k"),
               ("deepseek-v2-236b", "prefill_32k"),
               ("seamless-m4t-large-v2", "train_4k")]


def small_cell(arch, shape, mesh, cfg):
    """The reference helper's reduced shape (64 tokens, 32 in train, batch
    8) as an override of the cell's ``SHAPES`` entry."""
    seq = 32 if SHAPES[shape].kind == "train" else 64
    cell = chip_smoke.reduced_cell(arch, shape, cfg, seq_len=seq, batch=8, mesh=mesh)
    assert pcells.SHAPES[shape] == SHAPES[shape]          # the override is undone
    assert (cell.shape.seq_len, cell.shape.global_batch) == (seq, 8)
    return cell


@pytest.mark.parametrize("arch,shape", SMOKE_CELLS)
def test_smoke_meta_trace(arch, shape):
    ops.reset_launch_counts()
    cell = small_cell(arch, shape, make_card_mesh(), smoke_config(arch))
    tr = cell.trace()
    temp = tr.peak_bytes - tr.entry_bytes - (tr.output_bytes - tr.alias_bytes)
    assert temp > 0 and tr.flops > 0 and tr.bytes_accessed > 0
    assert tr.entry_bytes >= dryrun.argument_bytes(cell, make_card_mesh())[0]
    want_alias = {"train": 2, "prefill": 0, "decode": 1}[cell.shape.kind]
    assert (tr.alias_bytes > 0) == (want_alias > 0)
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    if arch in ("yi-6b", "granite-moe-3b-a800m", "seamless-m4t-large-v2"):
        assert tr.kernel_flops["flash_attention"] > 0
    if arch == "mamba2-1.3b":
        assert not tr.kernel_flops          # decode runs no kernel


def test_argument_bytes_shard_on_the_pod_meshes():
    cfg = smoke_config("yi-6b")
    card = small_cell("yi-6b", "train_4k", make_card_mesh(), cfg)
    pod = small_cell("yi-6b", "train_4k", MeshShape(("data", "model"), (2, 4)), cfg)
    a1, alias1 = dryrun.argument_bytes(card, make_card_mesh())
    a8, alias8 = dryrun.argument_bytes(pod, MeshShape(("data", "model"), (2, 4)))
    assert a8 < a1 and alias8 < alias1 and alias1 < a1
    params = pcells._tensors(card.abstract_args[0])         # bfloat16
    assert alias1 == sum(t.numel() * (2 + 4 + 4) for t in params) + 4


def test_phase_16_rehearses_on_the_cpu(capsys):
    """chip_smoke's phase 16 at a small size: two cheap full-size cells in
    two spawned workers, the pod meshes, and the tracker's meta peak against
    its own count of the same step run for real on the CPU."""
    results = chip_smoke.dryrun_phase(
        "cpu", device="cpu", workers=2,
        targets=[("mamba2-1.3b", "long_500k"), ("jamba-v0.1-52b", "long_500k")],
        real_shape=dict(seq_len=32, batch=4),
        cfg_of=lambda a: smoke_config(a).with_(dtype="float32"))
    assert [r["status"] for _, r in results] == ["ok", "ok"]
    out = capsys.readouterr().out
    assert out.count("check=tracker_vs_allocator") == 4
    assert "meta_over_allocator=1.0 " in out
    assert out.count("mesh=multipod_2x16x16") == 2
    assert 'fit_one_card=["mamba2-1.3b|long_500k"]' in out
    flash, ssd = chip_smoke.cell_launches(get_config("jamba-v0.1-52b"), "prefill")
    assert (flash, ssd) == (4, 28)


# -- the CLI -------------------------------------------------------------------

def test_cli_writes_one_ok_record_and_the_skipped_records(tmp_path):
    out = tmp_path / "dry.json"
    dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k", "--out", str(out)])
    rec = json.loads(out.read_text())
    ok = {k: v for k, v in rec.items() if v["status"] == "ok"}
    skipped = {k: v for k, v in rec.items() if v["status"] == "skipped"}
    assert list(ok) == ["mamba2-1.3b|long_500k|card_1x1"]
    assert len(skipped) == len([c for c in pcells.all_cells() if not c[2]]) == 8
    assert all(v["reason"].startswith("pure full-attention") for v in skipped.values())
    r = ok["mamba2-1.3b|long_500k|card_1x1"]
    mem = r["memory"]
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                 + mem["temp_bytes"] - mem["alias_bytes"])
    assert r["fits_hbm"] and r["collectives"] == {"total": 0}
    assert r["roofline"]["bottleneck"] == "memory" and r["traced_cost"]["flops"] > 0
    dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k", "--out", str(out),
                 "--mesh", "pod_16x16"])
    pod = json.loads(out.read_text())["mamba2-1.3b|long_500k|pod_16x16"]
    assert pod["memory"]["temp_bytes"] is None and pod["traced_cost"] is None
    assert pod["fits_hbm_arguments"] and "fits_hbm" not in pod
    assert pod["memory"]["argument_bytes"] < mem["argument_bytes"]


# -- the kernel wrappers on meta -----------------------------------------------

def test_meta_wrappers_give_the_kernels_outputs_and_launch_nothing():
    ops.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn((2, 32, 4, 16), generator=g), torch.randn((2, 32, 2, 16), generator=g)
    cpu = flash_attention_fwd(q, k, k)
    meta = flash_attention_fwd(q.to("meta"), k.to("meta"), k.to("meta"))
    x, w = torch.randn((6, 64), generator=g), torch.randn(64, generator=g)
    leaves = [torch.randn(s, generator=g) for s in ((3, 4), (1,), (9, 130))]
    B, L, H, P, G, N = 1, 32, 4, 8, 2, 8
    ssd_in = [torch.randn((B, L, H, P), generator=g), torch.rand((B, L, H), generator=g),
              torch.randn(H, generator=g), torch.randn((B, L, G, N), generator=g),
              torch.randn((B, L, G, N), generator=g)]
    pairs = [*zip(cpu, meta),
             (rmsnorm(x, w), rmsnorm(x.to("meta"), w.to("meta"))),
             (pack_leaves(leaves), pack_leaves([t.to("meta") for t in leaves])),
             (ssd_scan_fwd(*ssd_in, chunk=8),
              ssd_scan_fwd(*(t.to("meta") for t in ssd_in), chunk=8))]
    xe, we, ge = (torch.randn(s, generator=g) for s in ((3, 8, 16), (3, 16, 5), (3, 8, 5)))
    rows = torch.tensor([8, 0, 3], dtype=torch.int32)
    for form, a, b in ((NN, xe, we), (NT, ge, we), (TN, xe, ge)):
        with MemTracker("meta") as mt:
            meta = ragged_gemm(form, a.to("meta"), b.to("meta"), rows.to("meta"))
        assert mt.kernel_flops == {"moe_gemm": 2 * 3 * 8 * 16 * 5}     # the padded product's
        pairs.append((ragged_gemm(form, a, b, rows), meta))
    for c, m in pairs:
        assert m.is_meta and m.shape == c.shape and m.dtype == c.dtype
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)


# -- the MoE counts --------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4, 40, 160])
def test_moe_counts_equal_bincount(n):
    rng = np.random.default_rng(n)
    ids = torch.from_numpy(rng.integers(0, max(1, n // 2), (3, 17, 2)))   # empty experts
    got = moe._counts(ids, n)
    assert got.dtype == torch.long
    assert torch.equal(got, torch.bincount(ids.reshape(-1), minlength=n))
    assert moe._counts(ids.to("meta"), n).shape == (n,)


# -- model_axis ----------------------------------------------------------------

def test_model_axis_validation_matches_the_reference():
    devs = lambda n: [SimpleNamespace(id=i) for i in range(n)]   # noqa: E731
    for gb, m, n in [(8, 1, 4), (8, 1, 0), (8, 1, 3), (8, 2, 5), (8, 2, 4),
                     (8, 2, 8), (8, 4, 8), (6, 2, 8), (8, 3, 9)]:
        jh = SimpleNamespace(job=JJob(global_batch=gb, model_axis=m))
        ph = SimpleNamespace(job=TrainJobConfig(global_batch=gb, model_axis=m))
        try:
            want = JTrainer.validate_devices(jh, devs(n))
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                ElasticTrainer.validate_devices(ph, devs(n))
            if "model_axis" in str(e):
                assert "model_axis" in str(got.value)
        else:
            assert ElasticTrainer.validate_devices(ph, devs(n)) == want
    assert dataclasses.asdict(TrainJobConfig()) == dataclasses.asdict(JJob())


def test_trainer_replicas_and_rules_follow_model_axis():
    from repro_torch.core.elastic import local_slots
    job = TrainJobConfig(global_batch=4, seq_len=16, model_axis=2, rules="tp_sp")
    t = ElasticTrainer(smoke_config("yi-6b"), job, local_slots(4), device="cpu")
    assert t.replicas == 2 and len(t._bounds) == 2
    assert t.rules.mesh.shape == {"data": 2, "model": 2}
    assert t.rules.rules["seq"] == "model"
    with pytest.raises(ValueError, match="model_axis"):
        t.rescale(local_slots(3))
    t.rescale(local_slots(2))
    assert t.replicas == 1 and t.rules.mesh.shape == {"data": 1, "model": 2}
    assert np.isfinite(t.step()["loss"])
