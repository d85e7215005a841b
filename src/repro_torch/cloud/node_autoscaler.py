"""CLUES-style node power manager (cf. the CLUES/indigo orchestrators and
Kub, arXiv:2410.10655): watch queue pressure and idle time, provision and
decommission whole nodes with hysteresis and a budget cap.

Copy of ``repro.cloud.node_autoscaler`` (framework-free), line for line, so both
packages give bit-equal results on the same inputs.

This is *node-level* elasticity, orthogonal to the paper's *job-level*
elasticity: the scheduling policy shrinks/expands jobs inside the provisioned
capacity, while the autoscaler decides how much capacity to pay for.

Scale-up:   unmet demand = queued min_replicas + headroom - free - booting.
            Provision when positive, at most every ``scale_up_cooldown`` s,
            never past ``budget_cap`` dollars, preferring spot pools while
            their ZONE's share of provisioned slots is below its per-zone
            quota (``spot_fraction`` split evenly across spot zones, or the
            :class:`~repro_torch.cloud.bidding.DemandAwareBidder`'s risk-adjusted
            shares when ``cfg.bidder`` is set), least-saturated zone first —
            correlated zone reclaims make spot concentration in one zone the
            expensive failure mode, so the share check that used to be
            global is counted per zone (a global check would keep
            over-provisioning the one cheapest zone until the GLOBAL share
            hit target, parking the whole spot fleet in a single blast
            domain).
Scale-down: only after the cluster has been continuously idle enough to free
            a whole node for ``idle_timeout`` s AND ``scale_down_cooldown``
            has passed since the last release (hysteresis against thrash).
            Drain-aware: the victim is the node with the FEWEST resident
            slots whose residents fit on free capacity elsewhere (ties break
            toward the most expensive node); residents are migrated off via
            :meth:`CloudSimulator.begin_drain`, retried every tick until the
            node empties (migrate-or-wait), and the drain is cancelled if
            queue pressure returns.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Set

from repro_torch.cloud.provider import (ON_DEMAND, SPOT, CloudProvider, Node,
                                        NodePool, NodeState)

if TYPE_CHECKING:       # avoid a runtime import cycle with cloud.bidding
    from repro_torch.cloud.bidding import DemandAwareBidder


@dataclass(frozen=True)
class AutoscalerConfig:
    tick_interval: float = 30.0         # evaluation period (s)
    scale_up_cooldown: float = 60.0
    scale_down_cooldown: float = 240.0
    idle_timeout: float = 300.0         # continuous idleness before release
    headroom_slots: int = 0             # keep this many free slots warm
    # stop provisioning when accrued spend + a COMMIT_HOURS charge for every
    # booting/new node would exceed this ($) — the commitment term is what
    # makes the cap bite during boot windows, before billing has started
    budget_cap: float = math.inf
    spot_fraction: float = 0.0          # target share of slots from spot
    max_horizon: float = 7 * 24 * 3600.0  # stop ticking past this sim time
    #: per-zone share strategy: None keeps the static even split of
    #: ``spot_fraction`` across open spot zones; a
    #: :class:`~repro_torch.cloud.bidding.DemandAwareBidder` instead emits each
    #: zone's quota from its observed risk-cost rate vs. its spot discount
    bidder: Optional["DemandAwareBidder"] = None

    def __post_init__(self):
        assert self.tick_interval > 0.0
        assert 0.0 <= self.spot_fraction <= 1.0


#: canonical alias: the config belongs to the NodeAutoscaler
NodeAutoscalerConfig = AutoscalerConfig


class NodeAutoscaler:
    def __init__(self, provider: CloudProvider,
                 cfg: AutoscalerConfig = AutoscalerConfig()):
        self.provider = provider
        self.cfg = cfg
        self._last_up = -math.inf
        self._last_down = -math.inf
        self._idle_since: Optional[float] = None
        self._draining: Optional[str] = None     # node mid-drain (cordoned)
        self.scale_ups = 0
        self.scale_downs = 0
        # decision-audit sink (repro_torch.obs); None records nothing
        self.decisions = None

    def _decide(self, point: str, now: float, verdict: str,
                inputs=None, alternatives=None) -> None:
        if self.decisions is not None:
            self.decisions.record(point, now, verdict, inputs=inputs,
                                  alternatives=alternatives)

    # -- main entry (called from the autoscale_tick event) -------------------
    def evaluate(self, sim, now: float) -> None:
        # the bidder re-evaluates every tick (decay moves the estimates even
        # when no scale-up runs this tick) — otherwise a zone would only be
        # reclassified at the next provisioning attempt, long after the
        # evidence crossed the band.  ALL spot zones are classified, not
        # just the growable ones: a zone parked at max_nodes still takes
        # kills, and its state must be current by the time it can grow
        # again.  (Static split: nothing to refresh.)
        if self.cfg.bidder is not None:
            zones = self.provider.spot_zones()
            if zones:
                self.cfg.bidder.zone_quotas(zones, now, self.provider,
                                            self.cfg.spot_fraction)
        cluster = sim.cluster
        queued = cluster.queued_jobs()
        pending = self.provider.pending_slots()
        # only satisfiable jobs create demand: a min_replicas beyond what the
        # pools could EVER provide must not trigger provisioning (it would
        # thrash provision/release cycles forever)
        max_slots = self.provider.theoretical_max_slots()

        def _demand() -> int:
            return (sum(j.spec.min_replicas for j in queued
                        if j.spec.min_replicas <= max_slots)
                    + self.cfg.headroom_slots
                    - max(0, cluster.free_slots) - pending)
        demand = _demand()
        if self._draining is not None:
            if self._draining not in cluster.nodes():
                self._draining = None     # spot market removed it mid-drain:
                #                           not a voluntary scale-down
            elif demand > 0:
                # pressure returned mid-drain: put the capacity back; the
                # restored free slots may satisfy the demand outright, so
                # recompute before the scale-up logic below sees it
                self._decide("scale_down", now, "drain_cancelled",
                             inputs={"node": self._draining,
                                     "demand": demand})
                sim.cancel_drain(self._draining)
                self._draining = None
                demand = _demand()
            elif sim.begin_drain(self._draining):     # migrate-or-wait
                self._decide("scale_down", now, "drain_complete",
                             inputs={"node": self._draining})
                self._draining = None
                self._last_down = now
                self.scale_downs += 1
                return
            else:
                return                                # keep waiting
        stranded = False
        if demand > 0:
            if now - self._last_up < self.cfg.scale_up_cooldown:
                self._idle_since = None
                return
            if self._provision(sim, now, demand):
                self._last_up = now
                self._idle_since = None
                return
            # demand exists but nothing could be provisioned (pools at
            # max_nodes / budget cap): the queued jobs are STRANDED — fall
            # through so capacity they can never use is still released
            # instead of billing idle until the horizon
            stranded = True

        if (queued or pending) and not stranded:
            # work is waiting on capacity already on its way: not idle
            self._idle_since = None
            return

        victim = self._removable(cluster)
        if victim is None:
            self._idle_since = None
            return
        if self._idle_since is None:
            self._idle_since = now
            return
        if (now - self._idle_since >= self.cfg.idle_timeout
                and now - self._last_down >= self.cfg.scale_down_cooldown):
            self._idle_since = None     # restart the idle clock
            drained = sim.begin_drain(victim.node_id)
            self._decide(
                "scale_down", now,
                "drained" if drained else "drain_started",
                inputs={"node": victim.node_id,
                        "residents": cluster.resident_count(victim.node_id)
                        if not drained else 0,
                        "free": cluster.free_slots})
            if drained:
                self._last_down = now
                self.scale_downs += 1
            else:
                # residents could not all migrate this tick: keep the node
                # cordoned and retry next tick (migrate-or-wait)
                self._draining = victim.node_id

    # -- scale-up ------------------------------------------------------------
    #: every held node is assumed to bill at least this many hours in total
    #: (the classic cloud billing quantum); the unbilled remainder counts
    #: against budget_cap — otherwise the cap check is loop- and tick-
    #: invariant during boot windows (billing starts at node_up) and a burst
    #: could commit spend far past the cap
    COMMIT_HOURS = 1.0

    def _provision(self, sim, now: float, demand: int) -> bool:
        committed = sum(
            max(0.0, self.COMMIT_HOURS - n.billed_hours(now))
            * n.pool.price_per_node_hour
            for n in self.provider.nodes_in(NodeState.PROVISIONING,
                                            NodeState.UP))
        attempts = [] if self.decisions is not None else None
        demand0 = demand
        provisioned = False
        while demand > 0:
            node = None
            for pool in self._pool_preference(now):
                commit = pool.price_per_node_hour * self.COMMIT_HOURS
                if (sim.accountant.spend_through(now) + committed + commit
                        > self.cfg.budget_cap):
                    if attempts is not None:
                        attempts.append({"pool": pool.name,
                                         "zone": pool.zone,
                                         "outcome": "over_budget"})
                    continue            # this pool would bust the budget
                node = self.provider.request_node(pool.name, now, sim.queue)
                if node is not None:
                    committed += commit
                    if attempts is not None:
                        attempts.append({"pool": pool.name,
                                         "zone": pool.zone,
                                         "market": pool.market,
                                         "outcome": "requested",
                                         "slots": node.slots})
                    break
                if attempts is not None:
                    attempts.append({"pool": pool.name, "zone": pool.zone,
                                     "outcome": "at_max_nodes"})
            if node is None:
                break                   # every pool at max_nodes or over cap
            demand -= node.slots
            provisioned = True
            self.scale_ups += 1
        if self.decisions is not None:
            cap = self.cfg.budget_cap
            self.decisions.record(
                "scale_up", now,
                "provisioned" if provisioned else "blocked",
                inputs={"demand": demand0, "unmet": max(0, demand),
                        "spend": sim.accountant.spend_through(now),
                        "budget_cap": None if math.isinf(cap) else cap,
                        "preference": [p.name
                                       for p in self._pool_preference(now)]},
                alternatives=attempts)
        return provisioned

    def _pool_preference(self, now: float) -> List[NodePool]:
        """Zone-aware spot preference: a spot pool comes first while its
        zone's share of ALL provisioned slots is below the zone's quota
        (static even split of ``spot_fraction``, or the bidder's
        demand-aware share), least-saturated (then cheapest) zone first, so
        provisioning diversifies across blast domains instead of draining
        the single cheapest pool.  On-demand pools follow by ascending
        $/slot-hour; quota-filled spot pools come last.  With one spot zone
        and no bidder this reduces exactly to the old global share check."""
        pools = sorted(self.provider.pools.values(),
                       key=lambda p: p.price_per_slot_hour)
        spot = [p for p in pools if p.market == SPOT]
        on_demand = [p for p in pools if p.market != SPOT]
        total = self.provider.market_slots(SPOT) + \
            self.provider.market_slots(ON_DEMAND)
        spot_share = self.provider.market_slots(SPOT) / total if total else 0.0
        open_zones = self._open_spot_zones()
        quotas = self._zone_quotas(open_zones, now)

        def zone_share(pool: NodePool) -> float:
            return (self.provider.zone_slots(pool.zone, SPOT) / total
                    if total else 0.0)
        preferred = sorted(
            (p for p in spot
             if p.zone in open_zones
             and spot_share < self.cfg.spot_fraction
             and zone_share(p) < quotas.get(p.zone, 0.0)),
            key=lambda p: (zone_share(p), p.price_per_slot_hour))
        saturated = [p for p in spot if p not in preferred]
        return preferred + on_demand + saturated

    def _open_spot_zones(self) -> Set[str]:
        """Spot zones that can still GROW: a zone whose pools all sit at
        max_nodes must not strand its slice of the configured spot share
        (the global gate keeps the redistribution from overshooting it)."""
        return {p.zone for p in self.provider.pools.values()
                if p.market == SPOT
                and self.provider.pool_census(p.name) < p.max_nodes}

    def _zone_quotas(self, open_zones: Set[str],
                     now: float) -> Dict[str, float]:
        """Per-zone spot-slot-share quotas.  Zero open zones yields zero
        quotas — a fully saturated (or cordoned) spot fleet must not
        produce a phantom even-split (the old ``max(1, len(open_zones))``
        denominator quietly treated no zones as one zone)."""
        if not open_zones:
            return {}
        if self.cfg.bidder is None:
            quota = self.cfg.spot_fraction / len(open_zones)
            return {z: quota for z in open_zones}
        return self.cfg.bidder.zone_quotas(sorted(open_zones), now,
                                           self.provider,
                                           self.cfg.spot_fraction)

    # -- scale-down ----------------------------------------------------------
    def _removable(self, cluster) -> Optional[Node]:
        """The min-residency node whose residents (if any) fit on free
        capacity elsewhere, so a drain can empty it without displacing work
        below min_replicas.  Ties break toward the most expensive node."""
        surplus = cluster.free_slots - self.cfg.headroom_slots
        candidates = []
        for n in self.provider.up_nodes():
            if n.node_id not in cluster.nodes() or \
                    cluster.is_cordoned(n.node_id):
                continue
            resident = cluster.resident_count(n.node_id)
            node_free = n.slots - resident
            # removing the node takes its own free slots with it; the
            # residents then need `resident` slots on OTHER nodes
            if surplus - node_free >= resident:
                candidates.append((resident, -n.pool.price_per_slot_hour,
                                   n.node_id, n))
        if not candidates:
            return None
        return min(candidates)[3]
