"""The port's ``AsyncCheckpointer`` and the trainer's ``save_disk_async`` /
``ckpt_barrier`` on the CPU, mirroring the JAX package's fast-lane tests
(``tests/test_checkpoint_fastlane.py``): writes drain in order into a delta
chain, the barrier never publishes a half-written step and re-raises a
write's error, ``close()`` joins the worker, delta chains load in both
directions between the packages, and an in-place step right after
``save_disk_async`` never reaches the checkpoint.  bfloat16 leaves hash as
the JAX package hashes them and their npz files load in both packages."""
import gc
import threading
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import AsyncCheckpointer as JAsync  # noqa: E402
from repro.checkpoint import DiskCheckpointStore as JDiskStore  # noqa: E402
from repro.checkpoint.disk import _leaf_hash as jleaf_hash  # noqa: E402
from repro_torch.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                    DiskCheckpointStore, flatten_tree)
from repro_torch.checkpoint.disk import _leaf_hash  # noqa: E402
from repro_torch.checkpoint.reshard import (host_array, host_tensor,  # noqa: E402
                                            tree_map, unflatten_tree)
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.elastic import (ElasticTrainer, TrainJobConfig,  # noqa: E402
                                      local_slots)


def _state(hot_val: float):
    return {"weights": {"w0": torch.arange(64.0),
                        "w1": torch.ones(32)},
            "opt": {"m": torch.full((16,), hot_val)},
            "step": torch.tensor(int(hot_val), dtype=torch.int32)}


def _np_state(hot_val: float):
    """``_state`` as a nested dict of numpy arrays (what the JAX package's
    checkpointer takes)."""
    return tree_map(lambda t: t.numpy(), _state(hot_val))


def test_async_writes_drain_in_submit_order(tmp_path):
    store = DiskCheckpointStore(str(tmp_path))
    ac = AsyncCheckpointer(store, delta=True)
    for step in (1, 2, 3):
        ac.submit("j", step, _state(float(step)))
    ac.barrier()
    assert store.latest_step("j") == 3 and ac.completed == 3 and ac.pending == 0
    flat, m3 = store.load("j", step=3)
    assert m3["delta"]                     # chained off step 2's manifest
    assert m3["leaves"]["weights/w0"]["file"] == "step_000000001.npz"
    assert m3["leaves"]["opt/m"]["file"] == "step_000000003.npz"
    np.testing.assert_array_equal(flat["opt/m"], np.full((16,), 3.0, np.float32))
    ac.close()


def test_async_barrier_never_publishes_half_written_step(tmp_path):
    store = DiskCheckpointStore(str(tmp_path))
    store.save("j", 1, _state(1.0))
    gate = threading.Event()
    orig = store.save_flat

    def slow_save(*a, **kw):
        gate.wait(5.0)                     # hold the write mid-flight
        return orig(*a, **kw)
    store.save_flat = slow_save
    ac = AsyncCheckpointer(store, delta=True)
    ac.submit("j", 2, _state(2.0))
    assert store.latest_step("j") == 1     # a preempt here resumes from step 1
    gate.set()
    ac.barrier()
    assert store.latest_step("j") == 2
    flat, manifest = store.load("j")
    assert manifest["delta"]
    np.testing.assert_array_equal(flat["opt/m"], np.full((16,), 2.0, np.float32))
    ac.close()


def test_async_error_surfaces_at_barrier(tmp_path):
    store = DiskCheckpointStore(str(tmp_path))

    def boom(*a, **kw):
        raise OSError("disk full")
    store.save_flat = boom
    ac = AsyncCheckpointer(store)
    ac.submit("j", 1, _state(1.0))
    with pytest.raises(OSError, match="disk full"):
        ac.barrier()
    ac.barrier()                           # the error is raised once
    assert ac.completed == 0 and ac.pending == 0


def test_async_close_joins_the_worker(tmp_path):
    ac = AsyncCheckpointer(DiskCheckpointStore(str(tmp_path)))
    ac.submit("j", 1, _state(1.0))
    worker = ac._worker
    assert worker is not None
    ac.close()
    worker.join(timeout=5.0)
    assert not worker.is_alive() and ac._worker is None
    assert ac.completed == 1


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_async_delta_chains_load_in_both_packages(tmp_path, writer):
    if writer == "port":
        ac = AsyncCheckpointer(DiskCheckpointStore(str(tmp_path)), delta=True)
        for step in (1, 2, 3):
            ac.submit("j", step, _state(float(step)))
        reader = JDiskStore(str(tmp_path))
    else:
        ac = JAsync(JDiskStore(str(tmp_path)), delta=True)
        for step in (1, 2, 3):
            ac.submit("j", step, _np_state(float(step)))
        reader = DiskCheckpointStore(str(tmp_path))
    ac.close()
    for step in (1, 2, 3):
        flat, manifest = reader.load("j", step=step)
        assert manifest["delta"] == (step > 1)
        want = flatten_tree(_np_state(float(step)))
        assert sorted(flat) == sorted(want)
        for k in want:
            assert np.asarray(flat[k]).dtype == want[k].dtype
            assert np.asarray(flat[k]).tobytes() == want[k].tobytes(), (step, k)


@pytest.mark.parametrize("fused", [False, True])
def test_in_place_step_after_save_disk_async_never_reaches_the_checkpoint(
        tmp_path, fused):
    t = ElasticTrainer(smoke_config("yi-6b"),
                       TrainJobConfig(global_batch=8, seq_len=16, total_steps=4),
                       local_slots(2), device="cpu")
    t.step()
    store = DiskCheckpointStore(str(tmp_path))
    gate = threading.Event()
    orig = store.save_flat

    def held_save(*a, **kw):
        gate.wait(5.0)                     # the write lands after the step
        return orig(*a, **kw)
    store.save_flat = held_save
    before = {k: v.detach().numpy().copy()
              for k, v in flatten_tree(t.state_tree()).items()}
    t.save_disk_async(store, "j", fused=fused)
    t.step()                               # AdamW updates params and moments in place
    gate.set()
    t.ckpt_barrier()
    flat, manifest = store.load("j")
    assert manifest["step"] == 1 and not manifest["delta"]
    after = {k: v.detach().numpy() for k, v in flatten_tree(t.state_tree()).items()}
    assert sorted(flat) == sorted(before)
    for k, want in before.items():
        assert flat[k].tobytes() == want.tobytes(), k
    assert not np.array_equal(after["params/embed"], before["params/embed"])
    assert not np.array_equal(after["opt/m/embed"], before["opt/m/embed"])
    t._async_ckpt.close()


def _bf16(seed, shape):
    """An ``ml_dtypes.bfloat16`` array, as the JAX package holds one."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32).astype(jnp.bfloat16)


@pytest.mark.parametrize("shape", [(), (5,), (3, 4)])
def test_bf16_leaf_hash_equals_the_jax_packages(shape):
    a = _bf16(1, shape)
    assert str(a.dtype) == "bfloat16"
    port = host_array(torch.from_numpy(a.view(np.int16)).view(torch.bfloat16))
    assert port.dtype == np.dtype("V2") and port.tobytes() == a.tobytes()
    want = jleaf_hash(a)
    assert _leaf_hash(port) == _leaf_hash(a) == want
    assert jleaf_hash(a.view(np.int16)) != want      # the dtype is in the hash


def _bf16_state(step: int):
    """A state whose ``cold`` bf16 leaf never changes and whose other leaves
    change every step, as ml_dtypes/numpy arrays."""
    return {"params": {"cold": _bf16(2, (8, 16)),
                       "hot": np.full((4, 5), step, np.float32).astype(jnp.bfloat16)},
            "opt": {"m": np.full((3,), step, np.float32)},
            "step": np.asarray(step, np.int32)}


def _save(writer, root, step, delta):
    tree = _bf16_state(step)
    if writer == "port":
        tree = tree_map(lambda a: host_tensor(np.array(a)), tree)
        store = DiskCheckpointStore(root)
    else:
        tree = tree_map(jnp.asarray, tree)
        store = JDiskStore(root)
    store.save("j", step, tree, delta=delta)
    return store.last_bytes_written


@pytest.mark.parametrize("full_writer", ["port", "jax"])
@pytest.mark.parametrize("delta_writer", ["port", "jax"])
def test_bf16_checkpoints_load_across_packages(tmp_path, full_writer, delta_writer):
    """A full save by one package and a delta save by the same or the other
    one: the delta references the unchanged bf16 leaf (the hashes agree
    across packages), and both packages load both steps with the saved
    bytes, bf16 leaves as ``V2``."""
    root = str(tmp_path)
    full = _save(full_writer, root, 1, delta=False)
    delta = _save(delta_writer, root, 2, delta=True)
    assert 0 < delta < full
    for reader in (DiskCheckpointStore(root), JDiskStore(root)):
        for step in (1, 2):
            flat, manifest = reader.load("j", step=step)
            assert manifest["delta"] == (step == 2)
            want = flatten_tree(_bf16_state(step))
            assert sorted(flat) == sorted(want)
            for k, a in want.items():
                got = np.asarray(flat[k])
                assert got.tobytes() == a.tobytes(), (reader, step, k)
                assert got.dtype == (np.dtype("V2") if a.dtype.kind == "V" else a.dtype)
        assert manifest["leaves"]["params/cold"]["file"] == "step_000000001.npz"
        assert manifest["leaves"]["params/hot"]["file"] == "step_000000002.npz"


def test_unflatten_tree_leaves_no_cycle_holding_the_leaves():
    """A tree built by ``unflatten_tree`` (``init_params``, every host-lane
    restore) frees its leaves as soon as it is dropped: a recursive closure
    there was a reference cycle that held every leaf until the garbage
    collector ran (granite-moe's 13 GB of parameters beside a restore)."""
    leaf = torch.zeros(3)
    ref = weakref.ref(leaf)
    gc.disable()
    try:
        tree = unflatten_tree({"a": {"b/c": 0}}, {"a/b%2Fc": leaf})
        assert tree["a"]["b/c"] is leaf
        del tree, leaf
        assert ref() is None
    finally:
        gc.enable()
