"""The PyTorch port's ElasticTrainer on the CPU: trajectories against the JAX
trainer, disk checkpoints in both directions, static vs rescaled runs, and
the training CLI.  Tolerance 5e-5, as ``tests/helpers/elastic_trajectory.py``
holds the reference."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.checkpoint import DiskCheckpointStore as JDiskStore  # noqa: E402
from repro.checkpoint.reshard import flatten_tree as jflatten  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.core.elastic import ElasticTrainer as JTrainer  # noqa: E402
from repro.core.elastic import TrainJobConfig as JJob  # noqa: E402
from repro_torch.checkpoint import (DiskCheckpointStore,  # noqa: E402
                                    MemoryCheckpointStore, flatten_tree,
                                    restore_from_host, snapshot_to_host)
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.elastic import (ElasticTrainer, Slot,  # noqa: E402
                                      TrainJobConfig, local_slots)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

TOL = 5e-5
JOB = dict(global_batch=8, seq_len=32, total_steps=12, seed=3)
ARCHS = ["yi-6b", "mamba2-1.3b", "granite-moe-3b-a800m"]
MOE = "granite-moe-3b-a800m"


def _trainer(n_slots=4, arch="yi-6b"):
    return ElasticTrainer(smoke_config(arch), TrainJobConfig(**JOB),
                          local_slots(n_slots), device="cpu")


def _max_param_err(a_tree, b_flat):
    a = {k: v.detach().numpy() for k, v in flatten_tree(a_tree).items()}
    assert list(a) == list(b_flat)
    return max(float(np.max(np.abs(a[k] - np.asarray(b_flat[k])))) for k in a)


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_into_port_and_trajectories_agree(tmp_path, arch):
    jt = JTrainer(jsmoke_config(arch), JJob(**JOB), jax.devices()[:1])
    for _ in range(2):
        jt.step()
    jt.save_disk(JDiskStore(str(tmp_path)), "job")

    pt = _trainer(2, arch)
    assert pt.restore_disk(DiskCheckpointStore(str(tmp_path)), "job") == 2
    assert _max_param_err(pt.params, jflatten(jax.device_get(jt.params))) == 0.0
    assert int(pt.opt_state["count"]) == 2
    for _ in range(3):
        jm, pm = jt.step(), pt.step()
        assert abs(jm["loss"] - pm["loss"]) < TOL, (jm["loss"], pm["loss"])
        assert abs(jm["grad_norm"] - pm["grad_norm"]) < 1e-4
    assert _max_param_err(pt.params, jflatten(jax.device_get(jt.params))) < TOL

    # and back: the port's checkpoint restores into a fresh JAX trainer
    pt.save_disk(DiskCheckpointStore(str(tmp_path / "back")), "job", fused=True)
    jt2 = JTrainer(jsmoke_config(arch), JJob(**JOB), jax.devices()[:1])
    assert jt2.restore_disk(JDiskStore(str(tmp_path / "back")), "job") == 5
    assert _max_param_err(pt.params, jflatten(jax.device_get(jt2.params))) == 0.0
    jopt = jflatten(jax.device_get(jt2.opt_state))
    for k, t in flatten_tree(pt.opt_state).items():
        assert np.asarray(jopt[k]).tobytes() == t.numpy().tobytes(), k


def _jax_and_port_from_step0(tmp_path, arch, slots):
    """A single-device JAX trainer and a port trainer on ``slots``, both at
    the JAX trainer's step-0 parameters (through its disk checkpoint)."""
    jt = JTrainer(jsmoke_config(arch), JJob(**JOB), jax.devices()[:1])
    jt.save_disk(JDiskStore(str(tmp_path)), "job")
    pt = ElasticTrainer(smoke_config(arch), TrainJobConfig(**JOB), slots, device="cpu")
    assert pt.restore_disk(DiskCheckpointStore(str(tmp_path)), "job") == 0
    return jt, pt


def test_moe_loss_and_aux_are_the_global_batchs_at_every_replica_count(tmp_path):
    """The load-balance loss is a product of two means over the GLOBAL batch:
    the port's first step from the JAX step-0 parameters gives the JAX
    trainer's loss, aux and parameters at R = 1, 2 and 4.  The mean of the
    shards' own aux losses, which the global one replaces, differs."""
    runs = {}
    for r in (1, 2, 4):
        jt, pt = _jax_and_port_from_step0(tmp_path / str(r), MOE, local_slots(r))
        runs[r] = pt.step(), pt.params
    step0 = jflatten(jax.device_get(jt.params))
    jm = jt.step()
    want = jflatten(jax.device_get(jt.params))
    for r, (pm, params) in runs.items():
        assert pm["replicas"] == r and pm["aux"] > 0
        for k in ("loss", "aux", "xent", "grad_norm"):
            assert abs(pm[k] - jm[k]) < TOL, (r, k, pm[k], jm[k])
            assert abs(pm[k] - runs[1][0][k]) < 1e-6, (r, k)
        assert abs(pm["loss"] - pm["xent"] - pm["aux"]) < 1e-6
        assert _max_param_err(params, want) < TOL

    params0 = M.from_numpy_flat({k: np.asarray(v) for k, v in step0.items()}, device="cpu")
    batch = pt.stream.global_batch_at(0)
    shard_aux = [float(M.loss_fn(pt.cfg, params0, {k: torch.from_numpy(v[lo:hi]).long()
                                                   for k, v in batch.items()})[1]["aux"].detach())
                 for lo, hi in pt._shard_bounds(4)]
    assert abs(sum(shard_aux) / 4 - jm["aux"]) > 10 * TOL, (shard_aux, jm["aux"])


def test_moe_trainer_follows_the_jax_trainer_through_both_lanes(tmp_path):
    """granite-moe at smoke size from the JAX step-0 parameters: R=4, a
    host-lane shrink to 2, a p2p expand to 4; every loss and aux within
    ``TOL`` of the single-device JAX trainer's, and the parameters at the
    end."""
    slots = local_slots(4)
    jt, pt = _jax_and_port_from_step0(tmp_path, MOE, slots)
    for i in range(6):
        if i == 2:
            assert pt.rescale(slots[2:], via_host=True).path == "host"
        if i == 4:
            assert pt.rescale(slots).path == "p2p"
        jm, pm = jt.step(), pt.step()
        for k in ("loss", "aux"):
            assert abs(jm[k] - pm[k]) < TOL, (i, k, jm[k], pm[k])
    assert [m["replicas"] for m in pt.metrics_log] == [4, 4, 2, 2, 4, 4]
    assert _max_param_err(pt.params, jflatten(jax.device_get(jt.params))) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_static_and_rescaled_runs_agree(arch):
    static = _trainer(4, arch)
    for _ in range(12):
        static.step()
    slots = local_slots(4)
    el = _trainer(4, arch)
    for _ in range(4):
        el.step()
    t1 = el.rescale(slots[2:], via_host=True)      # shrink 4 -> 2, host lane
    for _ in range(4):
        el.step()
    t2 = el.rescale(slots)                           # expand 2 -> 4, p2p lane
    for _ in range(4):
        el.step()
    assert (t1.path, t2.path) == ("host", "p2p")
    assert t1.checkpoint > 0 and t1.restore > 0
    assert t2.checkpoint == 0.0 and t2.restore == 0.0
    assert [m["replicas"] for m in el.metrics_log] == [4] * 4 + [2] * 4 + [4] * 4
    la = [m["loss"] for m in static.metrics_log]
    lb = [m["loss"] for m in el.metrics_log]
    assert max(abs(a - b) for a, b in zip(la, lb)) < TOL
    assert la[-1] < la[0]
    perr = _max_param_err(el.params, {k: v.detach().numpy() for k, v in
                                      flatten_tree(static.params).items()})
    assert perr < TOL
    assert all(p.requires_grad for p in flatten_tree(el.params).values())


def test_loss_is_global_sum_over_global_weight():
    """R=4 shards of unequal masked weight still give sum/sum, not a mean of
    shard means (model.py:77-81 of the reference)."""
    a, b = _trainer(1), _trainer(4)
    orig = b.stream.global_batch_at

    def masked(step):
        batch = orig(step)
        batch["labels"][0, :30] = -1               # shard 0 nearly empty
        return batch
    a.stream = b.stream = type("S", (), {"global_batch_at": staticmethod(masked)})()
    ma, mb = a.step(), b.step()
    assert ma["tokens"] == mb["tokens"] == 8 * 32 - 30
    assert abs(ma["loss"] - mb["loss"]) < TOL


def test_rescale_validates_before_any_stage():
    t = _trainer(4)
    for bad in ([], local_slots(3), [Slot(0), Slot(0)]):
        with pytest.raises(ValueError):
            t.rescale(bad)
    assert t.rescale_log == [] and t.replicas == 4


def test_warm_slot_set_hits_the_step_state_cache():
    t = _trainer(4)
    t.rescale(local_slots(2))
    assert len(t._step_cache) == 2
    t.rescale(local_slots(4))
    assert len(t._step_cache) == 2 and t.replicas == 4


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the no-card refusal shows only without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ElasticTrainer(smoke_config("yi-6b"), TrainJobConfig(**JOB), local_slots(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "yi-6b", "--smoke", "--steps", "1"])


def test_memory_store_and_delta_disk_chain(tmp_path):
    t = _trainer(2)
    t.step()
    mem = MemoryCheckpointStore()
    mem.save("j", t.state_tree(), fused=True)
    ref = snapshot_to_host(t.state_tree())
    assert list(mem.load("j")) == list(ref)
    assert all(mem.load("j")[k].tobytes() == ref[k].tobytes() for k in ref)
    restored = restore_from_host(mem.load("j"), t.state_tree(), t.device)
    with torch.no_grad():
        restored["params"]["final_norm"].add_(1.0)   # must not write into the store
    assert mem.load("j")["params/final_norm"].tobytes() == \
        ref["params/final_norm"].tobytes()
    store = DiskCheckpointStore(str(tmp_path))
    t.save_disk(store, "j")
    with torch.no_grad():
        t.params["final_norm"].add_(1.0)
    t.step_idx += 1
    t.save_disk(store, "j", delta=True)
    assert 0 < store.last_bytes_written < store.nbytes_on_disk("j")
    flat, manifest = JDiskStore(str(tmp_path)).load("j")   # JAX reads the chain
    assert manifest["delta"] and manifest["step"] == 2
    assert flat["params/final_norm"].tobytes() == \
        t.params["final_norm"].detach().numpy().tobytes()


def _bf16_tree():
    g = torch.Generator().manual_seed(0)
    w = torch.randn((6, 40), generator=g).to(torch.bfloat16)
    return {"w": w, "w_t": w.t(),                  # a view that is not contiguous
            "scalar": torch.tensor(-2.5, dtype=torch.bfloat16),
            "empty": torch.zeros((0, 3), dtype=torch.bfloat16),
            "f32": torch.randn((7,), generator=g),
            "count": torch.tensor(3, dtype=torch.int32)}


def _bits(t):
    """The raw bytes of a tensor, bfloat16 included (as int16 bits)."""
    t = t.detach().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


@pytest.mark.parametrize("fused", [False, True])
def test_bfloat16_leaves_round_trip_on_the_host_path(tmp_path, fused):
    """A bfloat16 leaf's host form is a ``V2`` view of its bits (plain and
    through the pack kernel's 2-byte group); restore, the memory store and
    the disk store give back the same bits as bfloat16."""
    tree = _bf16_tree()
    host = snapshot_to_host(tree, fused=fused)
    assert list(host) == sorted(tree)
    for k, t in tree.items():
        want = np.dtype("V2") if t.dtype == torch.bfloat16 else t.numpy().dtype
        assert host[k].dtype == want and host[k].shape == tuple(t.shape), k
        assert host[k].tobytes() == _bits(t), k
    back = restore_from_host(host, tree, torch.device("cpu"))
    for k, t in tree.items():
        assert back[k].dtype == t.dtype and _bits(back[k]) == _bits(t), k
    with torch.no_grad():
        back["w"].add_(1.0)                # a restore never shares the snapshot
    assert host["w"].tobytes() == _bits(tree["w"])

    mem = MemoryCheckpointStore()
    mem.save("j", tree, fused=fused)
    assert {k: a.tobytes() for k, a in mem.load("j").items()} == \
        {k: a.tobytes() for k, a in host.items()}
    store = DiskCheckpointStore(str(tmp_path))
    store.save("j", 1, tree, fused=fused)
    flat, manifest = store.load("j")
    assert manifest["step"] == 1 and list(flat) == list(host)
    for k in host:
        assert flat[k].dtype == host[k].dtype and flat[k].tobytes() == host[k].tobytes()
    again = restore_from_host(flat, tree, torch.device("cpu"))
    assert all(_bits(again[k]) == _bits(t) for k, t in tree.items())


def test_restore_refuses_a_void_leaf_that_is_not_bfloat16():
    tree = {"w": torch.zeros(4, dtype=torch.float32)}
    with pytest.raises(TypeError):
        restore_from_host({"w": np.zeros(4, np.float32).view("V4")}, tree,
                          torch.device("cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_trainer_shrinks_on_the_host_lane_and_restarts_from_disk(
        tmp_path, arch):
    """``dtype="bfloat16"`` at smoke size on the CPU: two steps at R=4, a
    host-lane shrink to R=2 whose snapshot holds the state's bytes, a step,
    a full and a delta disk save, and a restart from disk with the saved
    step's bytes."""
    job = TrainJobConfig(**{**JOB, "dtype": "bfloat16"})
    t = ElasticTrainer(smoke_config(arch), job, local_slots(4), device="cpu")
    assert t.params["embed"].dtype == torch.bfloat16
    for _ in range(2):
        t.step()
    before = {k: _bits(v) for k, v in flatten_tree(t.state_tree()).items()}
    r = t.rescale(local_slots(4)[2:], via_host=True)
    assert r.path == "host" and t.replicas == 2
    assert {k: _bits(v) for k, v in flatten_tree(t.state_tree()).items()} == before
    t.step()
    store = DiskCheckpointStore(str(tmp_path))
    t.save_disk(store, "j")
    full = store.last_bytes_written
    t.step()
    t.save_disk(store, "j", delta=True)
    assert 0 < store.last_bytes_written < full
    saved = {k: _bits(v) for k, v in flatten_tree(t.state_tree()).items()}
    fresh = ElasticTrainer(smoke_config(arch), TrainJobConfig(**{**JOB, "dtype": "bfloat16",
                                                                  "seed": 9}),
                           local_slots(2), device="cpu")
    assert fresh.restore_disk(store, "j") == 4
    assert {k: _bits(v) for k, v in flatten_tree(fresh.state_tree()).items()} == saved
    losses = [m["loss"] for m in t.metrics_log] + [fresh.step()["loss"]]
    assert all(np.isfinite(losses)), losses


@pytest.mark.parametrize("peak_lr", [3e-3, 3e-4])
@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_trainer_matches_the_jax_package(tmp_path, arch, peak_lr):
    """The JAX package's trainer and the port's with ``dtype="bfloat16"``,
    from the same bf16 parameters (the JAX package's, through its disk
    checkpoint), at the default peak rate and at ``chip_smoke.py`` phase
    9's: six steps, the port's shrunk 4 -> 2 on the host lane after the
    third.  Losses agree within one bf16 rounding step of the loss (8
    significant bits), gradient norms within two.  Parameters agree within
    twice the rates summed over the steps plus one bf16 step at 1.0: an
    early AdamW update is about ``lr * sign(g)``, so a gradient near zero
    that rounds to the other sign moves a weight by up to 2 lr a step.  At
    the default rate both losses end below where they start."""
    job = {**JOB, "dtype": "bfloat16", "peak_lr": peak_lr}
    jt = JTrainer(jsmoke_config(arch), JJob(**job), jax.devices()[:1])
    jt.save_disk(JDiskStore(str(tmp_path)), "job")
    pt = ElasticTrainer(smoke_config(arch), TrainJobConfig(**job), local_slots(4),
                        device="cpu")
    assert pt.restore_disk(DiskCheckpointStore(str(tmp_path)), "job") == 0

    def jax_params():
        return {k: np.asarray(v) for k, v in jflatten(jax.device_get(jt.params)).items()}

    start = jax_params()
    assert {k: _bits(v) for k, v in flatten_tree(pt.params).items()} == \
        {k: a.tobytes() for k, a in start.items()}
    losses, lrs = [], []
    for i in range(6):
        if i == 3:
            assert pt.rescale(local_slots(4)[2:], via_host=True).path == "host"
        jm, pm = jt.step(), pt.step()
        assert abs(jm["loss"] - pm["loss"]) <= 2.0 ** -8 * abs(jm["loss"]), (i, jm, pm)
        assert abs(jm["grad_norm"] - pm["grad_norm"]) <= 2.0 ** -7 * jm["grad_norm"], \
            (i, jm, pm)
        losses.append((jm["loss"], pm["loss"]))
        lrs.append(pm["lr"])
    assert [m["replicas"] for m in pt.metrics_log] == [4] * 3 + [2] * 3
    want = jax_params()
    perr = max(float(np.max(np.abs(v.detach().float().numpy()
                                   - want[k].astype(np.float32))))
               for k, v in flatten_tree(pt.params).items())
    assert perr <= 2 * sum(lrs) + 2.0 ** -7, (perr, lrs)
    if peak_lr == 3e-3:
        assert losses[-1][0] < losses[0][0] and losses[-1][1] < losses[0][1], losses


def test_chip_smoke_bf16_phase_runs_at_smoke_size_on_the_cpu(tmp_path, capsys):
    """``chip_smoke.py``'s phase 9 with the smoke config on the CPU: every
    byte check passes, the delta save writes less, no kernel launches."""
    fp32_loss = _trainer(4).step()["loss"]
    counts = chip_smoke.bf16_phase(smoke_config("yi-6b"), str(tmp_path), fp32_loss,
                                   job={**JOB, "dtype": "bfloat16"}, device="cpu")
    assert counts == ops.launch_counts_by_dtype() == {
        "flash_attention": {}, "pack": {}, "rmsnorm": {}, "ssd": {}}
    out = capsys.readouterr().out
    for flag in ("byte_exact=True", "restored_vs_snapshot_byte_exact=True",
                 "restart_vs_saved_byte_exact=True"):
        assert flag in out, out
    assert out.count("[bf16] step=") == 5


def test_chip_smoke_moe_phase_runs_at_smoke_size_on_the_cpu(capsys):
    """``chip_smoke.py``'s phase 11 with the granite-moe smoke config on the
    CPU: finite losses, aux above 0, the host lane's restored state byte for
    byte its snapshot, no kernel launches."""
    counts, step_s = chip_smoke.moe_phase(smoke_config(MOE), job=JOB, device="cpu")
    assert counts == {"flash_attention": {}, "pack": {}, "rmsnorm": {}, "ssd": {}}
    assert len(step_s) == 6
    out = capsys.readouterr().out
    assert "restored_vs_snapshot_byte_exact=True" in out, out
    assert out.count("[moe] step=") == 6 and out.count(" aux=") == 6
    assert "rescale=host" in out and "rescale=p2p" in out


def test_chip_smoke_kernel_records_read_their_launch_count():
    """A kernels-line record reads its kernel's count for its dtype, or all
    of its kernel's counts where it has no dtype (a whole snapshot's packs)."""
    counts = {"flash_attention": {"float32": 8},
              "pack": {"float32": 2, "int32": 1, "bfloat16": 4}}

    def launches(name, kernel, dtype):
        rec = chip_smoke.record(name, kernel, "p", dtype, "src", "tpu", 0.0, 1.0, 1.0,
                                None, 1.0, "bytes", 0)
        return chip_smoke.launches_of(rec, counts)

    assert launches("pack", "pack", None) == 7
    assert launches("pack_bf16", "pack", torch.bfloat16) == 4
    assert launches("flash_attention", "flash_attention", torch.float32) == 8
    assert launches("flash_attention_bf16", "flash_attention", torch.bfloat16) == 0
    assert launches("rmsnorm", "rmsnorm", torch.float32) == 0


def test_train_cli_checkpoints_and_restarts_in_bfloat16(tmp_path, capsys):
    args = ["--arch", "yi-6b", "--smoke", "--device", "cpu", "--devices", "4",
            "--global-batch", "8", "--seq-len", "32", "--dtype", "bfloat16",
            "--log-every", "4", "--checkpoint-dir", str(tmp_path)]
    t = train_cli.main(args + ["--steps", "4", "--rescale-at", "2:2",
                               "--checkpoint-every", "2"])
    assert t.params["embed"].dtype == torch.bfloat16
    assert [m["replicas"] for m in t.metrics_log] == [4, 4, 2, 2]
    t2 = train_cli.main(args + ["--steps", "6", "--restart"])
    assert "restarted from disk checkpoint at step 4" in capsys.readouterr().out
    assert [m["step"] for m in t2.metrics_log] == [5, 6]
    assert all(np.isfinite([m["loss"] for m in t.metrics_log + t2.metrics_log]))


@pytest.mark.parametrize("arch", ARCHS + ["yi-9b", "starcoder2-7b", "minitron-4b",
                                          "chameleon-34b"])
def test_train_cli_rescales_checkpoints_and_restarts(tmp_path, capsys, arch):
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--devices", "4",
            "--global-batch", "8", "--seq-len", "32", "--log-every", "1",
            "--checkpoint-dir", str(tmp_path)]
    t = train_cli.main(args + ["--steps", "6", "--rescale-at", "2:2",
                               "--rescale-at", "4:4", "--checkpoint-every", "3"])
    assert [r.path for r in t.rescale_log] == ["p2p", "p2p"]
    assert [m["replicas"] for m in t.metrics_log] == [4, 4, 2, 2, 4, 4]
    t2 = train_cli.main(args + ["--steps", "8", "--restart"])
    out = capsys.readouterr().out
    assert "restarted from disk checkpoint at step 6" in out
    assert [m["step"] for m in t2.metrics_log] == [7, 8]
