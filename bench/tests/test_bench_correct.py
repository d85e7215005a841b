"""The comparison that decides ``correct``, at smoke size: the port agrees
with the reference over the compared steps (a migrate cycle among them),
and the control and every planted fault come out not correct.

On the CPU the control's TF32 is emulated (the inputs of every product
rounded to TF32's mantissa); the ``cuda`` tests take the card's own TF32.
Each fault is planted in the port, under the driver, which runs as a
benchmark run does with the card check skipped."""
import math

import pytest
import torch

from bench import control
from bench.drivers import train
from bench_cells import CELLS, smoke_inputs, smoke_run

SEED = 2**31 + 11


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _check_sound(out):
    assert out.correct, out.checks
    assert out.attempted >= 1 and out.failed == 0
    assert all(math.isfinite(c["value"]) for c in out.checks.values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_agrees_with_the_reference(bench_json, cell):
    out = smoke_run(bench_json, cell, seed=SEED)
    _check_sound(out)
    if cell.endswith("migrate"):
        assert {r["path"] for r in out.rescales} == {"host"} and out.rescales


@pytest.mark.parametrize("cell,steps", [("yi6b-d4.migrate", 5), ("granite-moe-3b.steady", 3),
                                        ("yi6b-d4.steady", 3)])
def test_the_compared_steps_run_through_every_rescale_of_a_cycle(bench_json, cell, steps):
    """Migrate compares 2 steps at R=4, the 4->2 rescale, 2 steps at R=2,
    the 2->4 rescale (the host lane's blocks reused) and a fifth step."""
    _, _, traffic, _ = smoke_inputs(bench_json, cell)
    assert train.compared_steps(traffic) == steps
    out = smoke_run(bench_json, cell, seed=SEED)
    assert len(out.readings["port"]["losses"]) == len(out.readings["reference"]["losses"]) \
        == steps


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_port_agrees_with_the_reference_on_the_card(bench_json, cell):
    _check_sound(smoke_run(bench_json, cell, seed=SEED, device=_card()))


def _control_fails(bench_json, cell, device):
    c, cfg, traffic, limits = smoke_inputs(bench_json, cell)
    recs = list(control.check(c, cfg, traffic, limits, [SEED],
                              [control.PORT, *control.VARIANTS], device))
    assert [r["variant"] for r in recs] == [control.PORT, *control.VARIANTS]
    for r in recs:
        assert r["correct"] == (r["variant"] == control.PORT), r
        assert not r["wrong"]
        assert len(r["losses"]) == train.compared_steps(traffic)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_the_reference_faults_fail(bench_json, cell):
    _control_fails(bench_json, cell, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_the_reference_faults_fail_on_the_card(bench_json, cell):
    _control_fails(bench_json, cell, _card())


# -- faults planted in the port ----------------------------------------------------

def _frozen(monkeypatch):
    """A step that returns its state unchanged."""
    from repro_torch.core import elastic
    from repro_torch.optim import global_norm

    def no_update(cfg, grads, state, params, lr):
        g = [t for t in elastic.tree_leaves(grads) if t is not None]
        return {"grad_norm": global_norm(g), "lr": torch.as_tensor(lr)}
    monkeypatch.setattr(elastic, "adamw_update", no_update)


def _rows_only(monkeypatch, keep):
    """The step sees only the shards ``keep(bounds)`` picks, and the mean is
    taken over their tokens."""
    from repro_torch.core.elastic import ElasticTrainer
    step = ElasticTrainer.step

    def faulty(self):
        bounds, stream = self._bounds, self.stream
        kept = keep(bounds)
        rows = [r for lo, hi in kept for r in range(lo, hi)]
        draw = stream.global_batch_at

        def masked(i):
            batch = dict(draw(i))
            labels = batch["labels"].copy()
            labels[[r for r in range(labels.shape[0]) if r not in rows]] = -1
            batch["labels"] = labels
            return batch
        self._bounds = kept
        stream.global_batch_at = masked
        try:
            return step(self)
        finally:
            self._bounds = bounds
            del stream.global_batch_at
    monkeypatch.setattr(ElasticTrainer, "step", faulty)


def _half_batch(monkeypatch):
    _rows_only(monkeypatch, lambda b: b[:max(1, len(b) // 2)])


def _no_exchange(monkeypatch):
    _rows_only(monkeypatch, lambda b: b[-1:])


def _loss_altered(monkeypatch):
    """The step's loss altered where it is produced."""
    from repro_torch.core.elastic import ElasticTrainer
    step = ElasticTrainer.step

    def faulty(self):
        m = step(self)
        m["loss"] *= 1.001
        return m
    monkeypatch.setattr(ElasticTrainer, "step", faulty)


def _moments_dropped(monkeypatch):
    """The host lane restores the parameters, and AdamW's moments as zeros."""
    from repro_torch.core import elastic
    restore = elastic.restore_from_host

    def faulty(host_flat, template, device):
        tree = restore(host_flat, template, device)
        if isinstance(tree, dict) and "m" in tree:
            for part in ("m", "v"):
                for t in elastic.tree_leaves(tree[part]):
                    t.zero_()
        return tree
    monkeypatch.setattr(elastic, "restore_from_host", faulty)


def _stale_snapshot(monkeypatch):
    """The host lane hands back its first rescale's snapshot on every later
    one, as a reused pinned block that was never written again would."""
    from repro_torch.core import elastic
    snapshot, first = elastic.snapshot_to_host, []

    def faulty(tree, **kw):
        first.append(snapshot(tree, **kw))
        return first[(len(first) - 1) % 2]
    monkeypatch.setattr(elastic, "snapshot_to_host", faulty)


FAULTS = {"frozen": _frozen, "half_batch": _half_batch, "no_exchange": _no_exchange,
          "loss_altered": _loss_altered, "moments_dropped": _moments_dropped,
          "stale_snapshot": _stale_snapshot}
HOST_LANE = ("moments_dropped", "stale_snapshot")


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in sorted(FAULTS)
    if f not in HOST_LANE or c.endswith("migrate")])
def test_a_fault_in_the_port_is_not_correct(bench_json, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    out = smoke_run(bench_json, cell, seed=SEED)
    assert not out.correct, (fault, out.checks)
