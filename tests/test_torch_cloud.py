"""The port's cloud layer against the JAX package's, on the CPU.

Both packages run the same framework-free arithmetic, numpy RNG draws and
iteration order, so the tolerance is exact equality: of the canonical JSON
form of ``ScheduleMetrics.to_dict()`` (``json.loads(json.dumps(...,
sort_keys=True))``), of cost reports, of event pop orders, of the
autoscaler's and the bidder's decisions and of trace records.  Scenarios are
drawn with numpy from a seed and fed to both packages.  The port is compared
with the JAX package, never with the golden fixture.
"""
import dataclasses
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.cloud as jcloud  # noqa: E402
import repro.core.autoscale as jauto  # noqa: E402
import repro.core.events as jev  # noqa: E402
import repro.core.job as jjob  # noqa: E402
import repro.core.policies as jpol  # noqa: E402
import repro.core.simulator as jsim  # noqa: E402
import repro.obs.audit as jaudit  # noqa: E402
import repro.obs.trace as jtrace  # noqa: E402
import repro.workloads as jwl  # noqa: E402
import repro_torch.cloud as pcloud  # noqa: E402
import repro_torch.core.autoscale as pauto  # noqa: E402
import repro_torch.core.events as pev  # noqa: E402
import repro_torch.core.job as pjob  # noqa: E402
import repro_torch.core.policies as ppol  # noqa: E402
import repro_torch.core.simulator as psim  # noqa: E402
import repro_torch.obs.audit as paudit  # noqa: E402
import repro_torch.obs.trace as ptrace  # noqa: E402
import repro_torch.workloads as pwl  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from benchmarks import table2_cloud_cost  # noqa: E402

PACKAGES = {
    "jax": SimpleNamespace(cloud=jcloud, auto=jauto, ev=jev, job=jjob, pol=jpol,
                           sim=jsim, audit=jaudit, trace=jtrace, wl=jwl),
    "torch": SimpleNamespace(cloud=pcloud, auto=pauto, ev=pev, job=pjob, pol=ppol,
                             sim=psim, audit=paudit, trace=ptrace, wl=pwl),
}
TABLE2_CELLS = [(p, v, m) for p in table2_cloud_cost.POLICIES
                for v in table2_cloud_cost.PROVISIONING
                for m in table2_cloud_cost.MARKETS]


def _canon(m) -> dict:
    return json.loads(json.dumps(m.to_dict(), sort_keys=True))


def _both(fn, *args, **kw):
    return [fn(P, *args, **kw) for P in PACKAGES.values()]


# -- provider ----------------------------------------------------------------

def _zoned_provider(P, seed):
    c = P.cloud
    return c.CloudProvider([
        c.NodePool("od", slots_per_node=8, price_per_slot_hour=0.048,
                   boot_latency=120.0, teardown_delay=30.0, max_nodes=3,
                   initial_nodes=1, region="east", zone="east-1a"),
        c.NodePool("spot-b", slots_per_node=8, price_per_slot_hour=0.016,
                   market=c.SPOT, boot_latency=90.0, teardown_delay=30.0,
                   max_nodes=4, initial_nodes=2, spot_lifetime_mean=900.0,
                   region="east", zone="east-1b"),
        c.NodePool("spot-w", slots_per_node=4, price_per_slot_hour=0.016,
                   market=c.SPOT, boot_latency=300.0, teardown_delay=60.0,
                   max_nodes=3, initial_nodes=1, spot_lifetime_mean=2400.0,
                   region="west", zone="west-2a"),
    ], seed=seed, region_price_multipliers={"west": 1.08},
        zone_reclaim_interval={"east-1b": 700.0, "west-2a": 1500.0},
        zone_reclaim_fraction=0.5, transfer_price_per_gb=0.02)


def _node_view(n):
    return (n.node_id, n.pool.name, n.state.name, n.requested_at, n.up_at,
            n.billing_ends_at, n.kill_at)


def _provider_script(P, seed, n_events=120):
    """Bootstrap, arm the zone streams, then pop events in order: each node
    event goes through the provider's handler, each zone reclaim replays its
    victims as spot kills; between events a numpy-seeded script requests
    nodes, releases UP nodes and injects kills and reclaims.  Returns the
    log of everything observable."""
    rng = np.random.default_rng(seed)
    prov, q = _zoned_provider(P, seed), P.ev.EventQueue()
    log = [("bootstrap", [_node_view(n) for n in prov.bootstrap(q)])]
    prov.schedule_zone_reclaims(q)
    prov.inject_zone_reclaim("east-1b", 50.0, q)
    pools = sorted(prov.pools)
    for _ in range(n_events):
        ev = q.pop()
        if ev is None:
            break
        t, kind, payload = ev.time, ev.kind, ev.payload
        if kind == "node_up":
            out = prov.on_node_up(payload, t)
        elif kind == "node_down":
            out = prov.on_node_down(payload, t)
        elif kind == "spot_kill":
            node, was_up = prov.on_spot_kill(payload, t)
            out = (node is not None, was_up)
        else:
            victims = prov.on_zone_reclaim(payload, t, q)
            out = (victims, [prov.on_spot_kill(v, t)[1] for v in victims])
        out = _node_view(out) if hasattr(out, "node_id") else out
        log.append((t, kind, payload, out))
        r = rng.random()
        if r < 0.3:
            node = prov.request_node(pools[rng.integers(len(pools))], t, q)
            log.append(("request", node and _node_view(node)))
        elif r < 0.45 and prov.up_nodes():
            ups = sorted(n.node_id for n in prov.up_nodes())
            log.append(("release", _node_view(
                prov.release_node(ups[rng.integers(len(ups))], t, q))))
        elif r < 0.5 and prov.up_nodes():
            ups = sorted(n.node_id for n in prov.up_nodes())
            prov.inject_spot_kill(ups[rng.integers(len(ups))], t + 10.0, q)
        log.append(("census", prov.pending_slots(), prov.market_slots(P.cloud.SPOT),
                    [prov.pool_census(p) for p in pools],
                    [prov.zone_slots(z) for z in prov.spot_zones()]))
    now = log[-2][0] if len(log) > 1 else 0.0
    log.append(("final", [_node_view(n) for n in prov.nodes.values()],
                [n.billed_hours(now) for n in prov.nodes.values()],
                prov.theoretical_max_slots(), q.stale_total))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_provider_lifecycle_kills_and_reclaims_match_jax(seed):
    j, p = _both(_provider_script, seed)
    assert p == j
    kinds = {e[1] for e in p if isinstance(e[0], float)}
    assert {"node_up", "spot_kill", "zone_reclaim"} <= kinds, kinds
    assert any(e[1] == "zone_reclaim" and e[3][0] for e in p if isinstance(e[0], float))


# -- cost ----------------------------------------------------------------------

def _cost_script(P, seed):
    """A CostAccountant driven by node ups/downs, allocations of real
    JobStates, preempt overheads and transfers at numpy-drawn times."""
    rng = np.random.default_rng(seed)
    prov = _zoned_provider(P, seed)
    acct = P.cloud.CostAccountant()
    nodes = [prov._new_node(pool, 0.0) for pool in prov.pools.values() for _ in range(2)]
    jobs = [P.job.JobState(P.job.JobSpec(f"j{i}", i % 3 + 1, 1, 8, 0.0))
            for i in range(4)]
    up, t, spent = [], 0.0, []
    for _ in range(60):
        t += float(rng.exponential(120.0))
        acct.advance(t)
        r = rng.random()
        if r < 0.35 and len(up) < len(nodes):
            node = nodes[len(up)]
            acct.node_up(node)
            up.append(node)
        elif r < 0.5 and up:
            acct.node_down(up.pop(), killed=bool(rng.random() < 0.5))
        elif r < 0.75:
            for j in jobs:
                j.replicas = int(rng.integers(0, 9))
            acct.set_allocations(jobs)
        elif r < 0.9:
            acct.bill_preempt_overhead(f"j{rng.integers(4)}", float(rng.uniform(1, 60)),
                                       int(rng.integers(0, 9)))
        else:
            acct.bill_transfer(f"j{rng.integers(4)}", float(rng.uniform(1e8, 4e9)),
                               prov.transfer_price_per_gb)
        spent.append((acct.spend_through(t + 30.0), acct.blended_slot_rate()))
    rep = acct.report()
    return dataclasses.asdict(rep), rep.idle_fraction, rep.row(), spent


@pytest.mark.parametrize("seed", [0, 1])
def test_cost_report_matches_jax(seed):
    j, p = _both(_cost_script, seed)
    assert p == j
    assert p[0]["total_cost"] > 0 and p[0]["spot_preemptions"] > 0


# -- autoscaler and bidder ---------------------------------------------------

def _bidder_script(P, seed):
    """A ledger fed numpy-drawn kills and costs in three zones, and the
    bidder's risk ratios, quotas and flips after each record."""
    rng = np.random.default_rng(seed)
    c = P.cloud
    prov = _zoned_provider(P, seed)
    bidder = c.DemandAwareBidder(c.BidderConfig(
        half_life=900.0, hysteresis=0.25, risk_aversion=5.0,
        min_evidence_kills=2.0, spot_fraction_max=0.5))
    zones = ["east-1b", "west-2a"]
    t, out = 0.0, []
    for _ in range(80):
        t += float(rng.exponential(200.0))
        z = zones[int(rng.random() < 0.3)]
        if rng.random() < 0.6:
            bidder.ledger.record_kill(z, t, nodes=int(rng.integers(1, 3)),
                                      dollars=float(rng.uniform(0, 0.05)),
                                      lost_seconds=float(rng.uniform(0, 600)))
        else:
            bidder.ledger.record_cost(z, t, dollars=float(rng.uniform(0, 0.02)),
                                      lost_seconds=float(rng.uniform(0, 300)),
                                      transfer_dollars=float(rng.uniform(0, 0.01)))
        out.append((bidder.zone_quotas(zones, t, prov, 0.75),
                    [bidder.risk_ratio(z, t, prov) for z in zones],
                    [bidder.ledger.kill_rate(z, t) for z in zones],
                    [bidder.ledger.cost_rate(z, t) for z in zones],
                    [bidder.is_open(z) for z in zones], bidder.adjustments))
    return out, [dataclasses.asdict(bidder.ledger.totals(z)) for z in zones]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bidder_ledger_and_quotas_match_jax(seed):
    j, p = _both(_bidder_script, seed)
    assert p == j
    assert p[0][-1][-1] > 0, "the script flipped no zone"


def _bidding_cell(P, regime, policy, seed=5, n_jobs=12, tracer=None):
    """benchmarks/table6_bidding.py's cell at a small size: a bursty trace on
    a 3-zone/2-region fleet under a per-zone reclaim regime, with the
    demand-aware bidder or a static split."""
    c = P.cloud
    hot = "east-1b"
    intervals = {"one_hot": {hot: 240.0}, "uniform": {hot: 900.0, "west-2a": 900.0},
                 "escalating": {}}[regime]
    pools = [c.NodePool("od-east", slots_per_node=8, price_per_slot_hour=0.048,
                        boot_latency=120.0, teardown_delay=30.0, initial_nodes=1,
                        max_nodes=3, region="east", zone="east-1a")]
    for region, zone in (("east", hot), ("west", "west-2a")):
        pools.append(c.NodePool(f"spot-{zone}", slots_per_node=8,
                                price_per_slot_hour=0.016, market=c.SPOT,
                                boot_latency=300.0, teardown_delay=30.0,
                                initial_nodes=1, max_nodes=6,
                                spot_lifetime_mean=14400.0, region=region, zone=zone))
    prov = c.CloudProvider(pools, seed=seed,
                           region_price_multipliers={"east": 1.0, "west": 1.08},
                           zone_reclaim_interval=intervals or None,
                           zone_reclaim_fraction=1.0, transfer_price_per_gb=0.02)
    bidder = (c.DemandAwareBidder(c.BidderConfig(
        half_life=1800.0, hysteresis=0.25, risk_aversion=10.0,
        min_evidence_kills=2.0, spot_fraction_max=0.5))
        if policy == "demand_aware" else None)
    asc = c.NodeAutoscaler(prov, c.AutoscalerConfig(
        tick_interval=30.0, scale_up_cooldown=30.0, scale_down_cooldown=120.0,
        idle_timeout=240.0, spot_fraction=0.75, bidder=bidder))
    trace = P.wl.generate("bursty", n_jobs=n_jobs, seed=seed,
                          duration_median=900.0).normalized(32, max_fraction=0.2)

    def inject(sim):
        if regime == "escalating":
            for t in (1500.0, 2400.0, 3100.0, 3650.0):
                prov.inject_zone_reclaim(hot, t, sim.queue)
    sim = P.wl.replay_cloud(trace, P.wl.ReplayConfig(cluster_slots=32, elasticity=1.25,
                                                     bytes_per_slot=2.0e9),
                            prov, variant="elastic", autoscaler=asc, placement="pack",
                            pre_run=inject, tracer=tracer)
    return sim


def _traced_bidding(P, tmp_path, regime, policy):
    path = str(tmp_path / f"{P.cloud.__name__}.jsonl")
    tracer = P.trace.Tracer(path)
    sim = _bidding_cell(P, regime, policy, tracer=tracer)
    tracer.close()
    records = P.trace.Tracer.load(path)
    return _canon(sim.metrics), records, P.audit.audit_records(records)


@pytest.mark.parametrize("policy", ["static", "demand_aware"])
@pytest.mark.parametrize("regime", ["one_hot", "uniform", "escalating"])
def test_autoscaler_and_bidder_decisions_match_jax(tmp_path, regime, policy):
    """Table 6-shaped runs, traced: metrics and every trace record (the
    autoscaler's scale_up/scale_down and the bidder's bid_flip decisions
    among them) are equal, and both packages' auditors pass both traces."""
    (jm, jrec, jrep), (pm, prec, prep) = (
        _traced_bidding(P, tmp_path, regime, policy) for P in PACKAGES.values())
    assert pm == jm and prec == jrec
    points = {r.get("point") for r in prec if r["kind"] == "decision"}
    assert {"scale_up", "scale_down"} <= points, points
    if policy == "demand_aware" and regime == "one_hot":
        assert "bid_flip" in points and pm["bid_adjustments"] > 0
    assert pm["dropped_jobs"] == 0
    assert all(r.ok for r in jrep + prep)
    assert all(r.ok for r in jaudit.audit_records(prec) + paudit.audit_records(jrec))


# -- CloudSimulator: Table 2 and Table 3/5-shaped scenarios ------------------

@pytest.mark.parametrize("cell", TABLE2_CELLS, ids=[".".join(c) for c in TABLE2_CELLS])
def test_table2_cell_matches_jax(cell):
    """The port's ``CloudSimulator`` under chip_smoke.py's restated Table 2
    setup equals the JAX package under the benchmark's own ``run_cell``."""
    j = _canon(table2_cloud_cost.run_cell(*cell))
    p = _canon(chip_smoke.table2_cell(*cell))
    assert p == j
    assert p["dropped_jobs"] == 0 and p["counters"]["completions"] == 16
    assert p["total_cost"] > 0


def test_table2_verdict_matches_the_benchmark():
    cells = {c: chip_smoke.table2_cell(*c) for c in
             (("elastic", "static_max", "on_demand"), ("elastic", "autoscaled", "on_demand"))}
    saving, ratio, ok = chip_smoke.table2_verdict(cells)
    static, scaled = (table2_cloud_cost.run_cell(*c).to_dict() for c in cells)
    assert saving == 1.0 - scaled["total_cost"] / static["total_cost"]
    assert ratio == scaled["weighted_mean_completion"] / static["weighted_mean_completion"]
    assert ok


def test_chip_smoke_restates_table2_setup():
    assert (chip_smoke.T2_POLICIES, chip_smoke.T2_PROVISIONING, chip_smoke.T2_MARKETS) == (
        table2_cloud_cost.POLICIES, table2_cloud_cost.PROVISIONING, table2_cloud_cost.MARKETS)
    assert (chip_smoke.T2_PRICE_OD, chip_smoke.T2_PRICE_SPOT, chip_smoke.T2_SLOTS_PER_NODE,
            chip_smoke.T2_MAX_NODES) == (
        table2_cloud_cost.PRICE_OD, table2_cloud_cost.PRICE_SPOT,
        table2_cloud_cost.SLOTS_PER_NODE, table2_cloud_cost.MAX_NODES)
    for cell in chip_smoke.T2_GOLDEN:
        assert _canon(chip_smoke.table2_cell(*cell)) == \
            _canon(table2_cloud_cost.run_cell(*cell))


def _placement_cell(P, placement, seed):
    """benchmarks/table3_placement.py's cell at a small size: a preempting
    elastic policy on an autoscaled on-demand + spot fleet whose spot nodes
    live about as long as the run."""
    c = P.cloud
    specs = P.sim.make_jacobi_jobs(seed=seed, n_jobs=8, submission_gap=20.0,
                                   sizes=("small", "medium"))
    prov = c.CloudProvider([
        c.NodePool("od", slots_per_node=8, price_per_slot_hour=0.048,
                   boot_latency=120.0, teardown_delay=30.0, initial_nodes=1, max_nodes=4),
        c.NodePool("spot", slots_per_node=8, price_per_slot_hour=0.016, market=c.SPOT,
                   boot_latency=90.0, teardown_delay=30.0, initial_nodes=2, max_nodes=6,
                   spot_lifetime_mean=600.0)], seed=seed)
    pcfg = P.pol.PolicyConfig(rescale_gap=180.0)
    asc = c.NodeAutoscaler(prov, c.AutoscalerConfig(
        tick_interval=30.0, scale_up_cooldown=30.0, scale_down_cooldown=60.0,
        idle_timeout=120.0, spot_fraction=0.5))
    sim = c.CloudSimulator(prov, pcfg, policy=P.auto.PreemptingPolicy(pcfg),
                           autoscaler=asc, placement=placement)
    for s in specs:
        sim.submit(s, P.sim.jacobi_workload(s.workload))
    m = sim.run()
    return _canon(m), [tuple(k) for k in sim.kill_blasts]


@pytest.mark.parametrize("placement", ["pack", "spread"])
@pytest.mark.parametrize("seed", [7, 11])
def test_table3_placement_cell_matches_jax(placement, seed):
    j, p = _both(_placement_cell, placement, seed)
    assert p == j
    assert p[0]["dropped_jobs"] == 0


def _zones_cell(P, severity, placement, seed, inject):
    """benchmarks/table5_zones.py's cell at a small size: correlated zone
    reclaims on a 3-zone/2-region fleet, zone-aware placement, cross-region
    transfer billing; ``inject`` adds a deterministic reclaim."""
    c = P.cloud
    interval, fraction = {"calm": (None, 0.5), "mild": (1200.0, 0.5),
                          "severe": (900.0, 1.0)}[severity]
    pools = [c.NodePool("od-east", slots_per_node=8, price_per_slot_hour=0.048,
                        boot_latency=120.0, teardown_delay=30.0, initial_nodes=1,
                        max_nodes=2, region="east", zone="east-1a")]
    for region, zone in (("east", "east-1a"), ("east", "east-1b"), ("west", "west-2a")):
        pools.append(c.NodePool(f"spot-{zone}", slots_per_node=8,
                                price_per_slot_hour=0.016, market=c.SPOT,
                                boot_latency=300.0, teardown_delay=30.0,
                                initial_nodes=1, max_nodes=3,
                                spot_lifetime_mean=7200.0, region=region, zone=zone))
    prov = c.CloudProvider(pools, seed=seed,
                           region_price_multipliers={"east": 1.0, "west": 1.08},
                           zone_reclaim_interval=interval,
                           zone_reclaim_fraction=fraction, transfer_price_per_gb=0.02)
    asc = c.NodeAutoscaler(prov, c.AutoscalerConfig(
        tick_interval=30.0, scale_up_cooldown=30.0, scale_down_cooldown=120.0,
        idle_timeout=240.0, spot_fraction=0.75, headroom_slots=12))
    trace = P.wl.generate("heavy_tail", n_jobs=12, seed=seed,
                          duration_scale=450.0).normalized(48, max_fraction=0.2)
    sim = P.wl.replay_cloud(
        trace, P.wl.ReplayConfig(cluster_slots=48, elasticity=1.5, bytes_per_slot=2.0e9),
        prov, variant="elastic", autoscaler=asc, placement=placement,
        pre_run=(lambda s: prov.inject_zone_reclaim("east-1b", 600.0, s.queue))
        if inject else None)
    return (_canon(sim.metrics), [tuple(k) for k in sim.zone_blasts],
            dataclasses.asdict(sim.cost_report))


@pytest.mark.parametrize("placement", ["pack", "zone_spread"])
@pytest.mark.parametrize("severity,inject", [("calm", True), ("mild", False),
                                             ("severe", False)])
def test_table5_zone_reclaim_cell_matches_jax(severity, inject, placement):
    j, p = _both(_zones_cell, severity, placement, 13, inject)
    assert p == j
    m = p[0]
    assert m["dropped_jobs"] == 0
    if severity != "calm" or inject:
        assert m["zone_reclaims"] > 0 and p[1], "no zone reclaim landed"


def test_cloud_exports_match_jax():
    assert pcloud.__all__ == jcloud.__all__
    assert all(hasattr(pcloud, n) for n in pcloud.__all__)
