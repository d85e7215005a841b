"""The PyTorch port's ElasticTrainer on the CPU: trajectories against the JAX
trainer, disk checkpoints in both directions, static vs rescaled runs, and
the training CLI.  Tolerance 5e-5, as ``tests/helpers/elastic_trajectory.py``
holds the reference."""
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
from repro_torch.launch import train as train_cli  # noqa: E402

TOL = 5e-5
JOB = dict(global_batch=8, seq_len=32, total_steps=12, seed=3)
ARCHS = ["yi-6b", "mamba2-1.3b"]


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


def test_bfloat16_leaves_are_refused_on_the_host_path(tmp_path):
    tree = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    for fused in (False, True):
        with pytest.raises(NotImplementedError):
            snapshot_to_host(tree, fused=fused)
    with pytest.raises(NotImplementedError):
        DiskCheckpointStore(str(tmp_path)).save("j", 0, tree)


@pytest.mark.parametrize("arch", ARCHS)
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
