"""``moe_rows_computed``: the share of the experts' slots that their
products compute, from the port's ``moe.rows`` and ``moe.slots`` counters;
silent on a port that counts no ``moe.rows``."""
from types import SimpleNamespace

import pytest

from bench import spec


def _run(counters):
    return SimpleNamespace(program={"spans": [], "counters": counters})


def test_the_share_of_slots_the_products_compute():
    reader = spec.reader("moe_rows_computed")
    got = reader.read(_run({"moe.kept": 13_107, "moe.slots": 40_960, "moe.rows": 13_440}))
    assert got == pytest.approx(100 * 13_440 / 40_960)
    assert reader.read(_run({"moe.kept": 13_107, "moe.slots": 40_960})) is None
    assert reader.read(_run({})) is None
    assert reader.read(SimpleNamespace(program=None)) is None


def test_a_profiled_cpu_trainer_computes_every_slot():
    """On the CPU the products are the plain ``torch.bmm`` over the whole
    slot layout: 100%."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import smoke_config
    from repro_torch.core.elastic import ElasticTrainer, TrainJobConfig, local_slots
    from repro_torch.obs import device_spans as ds
    job = TrainJobConfig(global_batch=4, seq_len=16, total_steps=2, seed=5, dtype="float32")
    tr = ElasticTrainer(smoke_config("granite-moe-3b-a800m"), job, local_slots(2),
                        device="cpu")
    if ds.profiled_recorder() is not None:
        ds.profiled_recorder().flush()
    with profile(activities=[ProfilerActivity.CPU]):
        tr.step()
    run = SimpleNamespace(trace={})
    assert spec.reader("moe_rows_computed").read(run) == pytest.approx(100.0)
