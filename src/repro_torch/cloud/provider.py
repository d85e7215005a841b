"""Cloud provider simulation: node pools, pricing, boot/teardown latency, and
spot-market preemption.

Copy of ``repro.cloud.provider`` (framework-free), line for line, so both
packages give bit-equal results on the same inputs.

The provider owns *node lifecycle* only; it never touches the scheduler.  It
communicates with the simulator exclusively by pushing events into the shared
:class:`~repro_torch.core.events.EventQueue`:

    request_node()  --boot_latency-->   "node_up"       (capacity attaches)
    release_node()  --teardown_delay--> "node_down"     (billing stops)
    spot fate drawn at request time --> "spot_kill"     (capacity yanked NOW)
    Poisson process per zone        --> "zone_reclaim"  (correlated burst)

Topology: every pool lives in a ``region``/``zone`` (zone names are globally
unique, AWS-style ``us-east-1a``).  Regions price capacity differently —
``region_price_multipliers`` scales each pool's ``price_per_slot_hour`` at
registration — and checkpoint data crossing a region boundary on restore is
billed at ``transfer_price_per_gb`` (see CostAccountant).

Spot reclaims happen at two scales, layered:

- *independent*: each spot node keeps its private Exp(mean) lifetime fate,
  drawn at request time (the background churn of one market);
- *correlated*: when ``zone_reclaim_interval`` is set, each zone hosting
  spot capacity carries a memoryless Poisson event stream; every event
  reclaims ``zone_reclaim_fraction`` of that zone's UP spot nodes AT ONCE
  (the capacity crunch real clouds exhibit — cf. Kub, arXiv:2410.10655).
  On-demand nodes and other zones are bystanders by construction.

Billing semantics (documented in README §Cloud): a node is billed from the
moment it comes UP until it goes DOWN (normal teardown or spot kill).  Boot
time is not billed — the cloud charges for running instances, but the
*scheduler* still feels the boot latency as provisioning lag.  A DRAINING
node (released, awaiting teardown) no longer offers capacity but still bills,
which is exactly the wasted-teardown money a real cluster pays.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.events import EventQueue

ON_DEMAND = "on_demand"
SPOT = "spot"


class NodeState(Enum):
    PROVISIONING = "provisioning"   # requested, booting
    UP = "up"                       # offering capacity, billing
    DRAINING = "draining"           # released: no capacity, still billing
    DOWN = "down"                   # gone, billing stopped


@dataclass(frozen=True)
class NodePool:
    """One instance type / market / zone combination (e.g. c5.2xlarge
    on-demand in us-east-1a)."""
    name: str
    slots_per_node: int = 8
    price_per_slot_hour: float = 0.048     # $/slot-hour (~c5.2xlarge / 8 vCPU)
    market: str = ON_DEMAND
    boot_latency: float = 120.0            # request -> capacity available (s)
    teardown_delay: float = 30.0           # release -> billing stops (s)
    max_nodes: int = 64
    initial_nodes: int = 0                 # provisioned (UP) at t=0, free
    # spot only: mean node lifetime before the market reclaims it; the fate
    # is drawn once per node from Exp(mean) at request time (memoryless)
    spot_lifetime_mean: float = 3600.0
    # topology: zone names are globally unique (AWS-style "us-east-1a"), so
    # the zone alone identifies a correlated-reclaim blast domain
    region: str = "default"
    zone: str = "default-a"

    def __post_init__(self):
        assert self.market in (ON_DEMAND, SPOT), self.market
        assert self.slots_per_node >= 1
        assert self.price_per_slot_hour >= 0.0

    @property
    def price_per_node_hour(self) -> float:
        return self.price_per_slot_hour * self.slots_per_node


@dataclass
class Node:
    node_id: str
    pool: NodePool
    state: NodeState = NodeState.PROVISIONING
    requested_at: float = 0.0
    up_at: Optional[float] = None
    billing_ends_at: Optional[float] = None
    kill_at: Optional[float] = None        # spot reclaim fate; None = safe

    @property
    def slots(self) -> int:
        return self.pool.slots_per_node

    def billed_hours(self, now: float) -> float:
        if self.up_at is None:
            return 0.0
        end = self.billing_ends_at if self.billing_ends_at is not None else now
        return max(0.0, end - self.up_at) / 3600.0


class CloudProvider:
    """Node pools + lifecycle.  All state transitions are driven by the
    simulator popping the events this class pushes."""

    def __init__(self, pools: Iterable[NodePool], seed: int = 0, *,
                 region_price_multipliers: Optional[Dict[str, float]] = None,
                 zone_reclaim_interval: Optional[
                     float | Dict[str, float]] = None,
                 zone_reclaim_fraction: float = 0.5,
                 transfer_price_per_gb: float = 0.02):
        # fold the region multiplier into each pool's price at registration
        # so every downstream consumer (billing, autoscaler preference,
        # budget commitment) sees the regionally-adjusted rate for free
        mult = region_price_multipliers or {}
        self.pools: Dict[str, NodePool] = {
            p.name: dataclasses.replace(
                p, price_per_slot_hour=(p.price_per_slot_hour
                                        * mult.get(p.region, 1.0)))
            for p in pools}
        self.nodes: Dict[str, Node] = {}
        self._ids = itertools.count()
        self.rng = np.random.default_rng(seed)
        #: mean seconds between correlated reclaim events PER ZONE hosting
        #: spot capacity (None disables the process); each event reclaims
        #: ceil(fraction * UP spot nodes) of that zone at once.  A dict maps
        #: zone -> interval so markets can differ per blast domain (zones
        #: absent from the dict carry no stream) — the one-hot and skewed
        #: reclaim regimes the demand-aware bidder is judged against
        self.zone_reclaim_interval = zone_reclaim_interval
        self.zone_reclaim_fraction = zone_reclaim_fraction
        assert 0.0 < zone_reclaim_fraction <= 1.0, zone_reclaim_fraction
        #: $/GB billed when a checkpoint is restored in a different REGION
        #: than it was written in (intra-region restores are free)
        self.transfer_price_per_gb = transfer_price_per_gb
        # when the Poisson stream fires next, per zone: an injected
        # (deterministic) reclaim event landing BEFORE it must not re-arm,
        # or the zone ends up with two live streams at double the rate
        self._next_fire: Dict[str, float] = {}

    def region_of(self, node_id: str) -> str:
        return self.nodes[node_id].pool.region

    def zone_of(self, node_id: str) -> str:
        return self.nodes[node_id].pool.zone

    # -- queries -------------------------------------------------------------
    def nodes_in(self, *states: NodeState) -> List[Node]:
        return [n for n in self.nodes.values() if n.state in states]

    def up_nodes(self) -> List[Node]:
        return self.nodes_in(NodeState.UP)

    def pending_slots(self) -> int:
        """Slots already requested but still booting."""
        return sum(n.slots for n in self.nodes_in(NodeState.PROVISIONING))

    def pool_census(self, pool_name: str) -> int:
        """Nodes of a pool that exist or are coming (counts vs. max_nodes)."""
        return sum(1 for n in self.nodes.values()
                   if n.pool.name == pool_name and n.state in (
                       NodeState.PROVISIONING, NodeState.UP,
                       NodeState.DRAINING))

    def theoretical_max_slots(self) -> int:
        """Ceiling on total capacity with every pool at max_nodes — a job
        whose min_replicas exceeds this can never run here."""
        return sum(p.max_nodes * p.slots_per_node for p in self.pools.values())

    def market_slots(self, market: str) -> int:
        return sum(n.slots for n in self.nodes.values()
                   if n.pool.market == market and n.state in (
                       NodeState.PROVISIONING, NodeState.UP))

    def spot_zones(self) -> List[str]:
        """Zones hosting spot pools — the correlated-reclaim blast domains."""
        return sorted({p.zone for p in self.pools.values()
                       if p.market == SPOT})

    def zone_slots(self, zone: str, market: Optional[str] = None) -> int:
        """Provisioned (booting + UP) slots in a zone, optionally by market
        — the autoscaler's per-zone spot-share denominator/numerator."""
        return sum(n.slots for n in self.nodes.values()
                   if n.pool.zone == zone
                   and (market is None or n.pool.market == market)
                   and n.state in (NodeState.PROVISIONING, NodeState.UP))

    # -- lifecycle -----------------------------------------------------------
    def bootstrap(self, queue: EventQueue) -> List[Node]:
        """Instantiate each pool's ``initial_nodes`` as already UP at t=0
        (the cluster you start the experiment with)."""
        out = []
        for pool in self.pools.values():
            for _ in range(pool.initial_nodes):
                node = self._new_node(pool, now=0.0, boots=False)
                node.state = NodeState.UP
                node.up_at = 0.0
                if node.kill_at is not None:
                    queue.push(node.kill_at, "spot_kill", node.node_id)
                out.append(node)
        return out

    def request_node(self, pool_name: str, now: float,
                     queue: EventQueue) -> Optional[Node]:
        """Ask for one node; returns None when the pool is at max_nodes.
        Capacity arrives via the "node_up" event after boot_latency."""
        pool = self.pools[pool_name]
        if self.pool_census(pool_name) >= pool.max_nodes:
            return None
        node = self._new_node(pool, now)
        queue.push(now + pool.boot_latency, "node_up", node.node_id)
        if node.kill_at is not None:
            queue.push(node.kill_at, "spot_kill", node.node_id)
        return node

    def release_node(self, node_id: str, now: float,
                     queue: EventQueue) -> Node:
        """Voluntary decommission.  The caller removes the capacity from the
        cluster NOW; billing continues through teardown_delay."""
        node = self.nodes[node_id]
        assert node.state == NodeState.UP, (node_id, node.state)
        node.state = NodeState.DRAINING
        queue.push(now + node.pool.teardown_delay, "node_down", node.node_id)
        return node

    def on_node_up(self, node_id: str, now: float) -> Optional[Node]:
        node = self.nodes[node_id]
        if node.state is not NodeState.PROVISIONING:
            return None                    # stale (already killed)
        node.state = NodeState.UP
        node.up_at = now
        return node

    def on_node_down(self, node_id: str, now: float) -> Optional[Node]:
        node = self.nodes[node_id]
        if node.state is not NodeState.DRAINING:
            return None                    # stale (spot-killed while draining)
        node.state = NodeState.DOWN
        node.billing_ends_at = now
        return node

    def on_spot_kill(self, node_id: str, now: float
                     ) -> Tuple[Optional[Node], bool]:
        """Returns (node, was_offering_capacity).  Stale kills (node already
        DOWN, or still booting) return (None, False) / end billing quietly."""
        node = self.nodes[node_id]
        if node.state is NodeState.PROVISIONING:
            # killed before it ever booted: it never billed, never served
            node.state = NodeState.DOWN
            node.billing_ends_at = None
            return None, False
        if node.state is NodeState.DOWN:
            return None, False
        was_up = node.state is NodeState.UP
        node.state = NodeState.DOWN
        node.billing_ends_at = now
        return node, was_up

    def inject_spot_kill(self, node_id: str, t: float,
                         queue: EventQueue) -> None:
        """Deterministic kill for tests/demos (bypasses the Exp(mean) draw)."""
        self.nodes[node_id].kill_at = t
        queue.push(t, "spot_kill", node_id)

    # -- correlated zone reclaims --------------------------------------------
    def reclaim_interval_of(self, zone: str) -> Optional[float]:
        """The zone's correlated-reclaim mean interval (None = no stream)."""
        zi = self.zone_reclaim_interval
        if isinstance(zi, dict):
            return zi.get(zone)
        return zi

    def schedule_zone_reclaims(self, queue: EventQueue) -> None:
        """Arm each spot zone's Poisson reclaim stream (first arrival per
        zone).  No-op unless ``zone_reclaim_interval`` is configured; with a
        per-zone dict, only the listed zones carry a stream."""
        if self.zone_reclaim_interval is None:
            return
        for zone in self.spot_zones():
            if self.reclaim_interval_of(zone) is not None:
                self._push_next_zone_reclaim(zone, 0.0, queue)

    def _push_next_zone_reclaim(self, zone: str, now: float,
                                queue: EventQueue) -> None:
        t = now + float(self.rng.exponential(self.reclaim_interval_of(zone)))
        self._next_fire[zone] = t
        queue.push(t, "zone_reclaim", zone)

    def on_zone_reclaim(self, zone: str, now: float,
                        queue: EventQueue) -> List[str]:
        """One correlated reclaim event: pick ceil(fraction x UP spot nodes)
        victims in the zone and re-arm the stream (memoryless).  Returns the
        victim node ids; the caller replays each through the node-exact
        spot-kill path, so on-demand nodes and other zones are bystanders by
        construction."""
        up = sorted(n.node_id for n in self.nodes.values()
                    if n.state is NodeState.UP and n.pool.market == SPOT
                    and n.pool.zone == zone)
        victims: List[str] = []
        if up:
            k = math.ceil(self.zone_reclaim_fraction * len(up))
            picked = self.rng.choice(len(up), size=k, replace=False)
            victims = [up[i] for i in sorted(picked)]
        # re-arm only when THIS event is the armed stream's own firing — an
        # injected event (arriving ahead of the pending stream event, or on
        # a zone that was never armed at all) must not start a new stream
        if (self.reclaim_interval_of(zone) is not None
                and zone in self._next_fire
                and now >= self._next_fire[zone]):
            self._push_next_zone_reclaim(zone, now, queue)
        return victims

    def inject_zone_reclaim(self, zone: str, t: float,
                            queue: EventQueue) -> None:
        """Deterministic correlated reclaim for tests/demos (the event still
        draws its victims via ``zone_reclaim_fraction``)."""
        queue.push(t, "zone_reclaim", zone)

    # -- internals -----------------------------------------------------------
    def _new_node(self, pool: NodePool, now: float,
                  boots: bool = True) -> Node:
        node = Node(node_id=f"{pool.name}-{next(self._ids)}", pool=pool,
                    requested_at=now)
        if pool.market == SPOT:
            # the Exp(mean) lifetime clock starts when the node comes UP —
            # bootstrap nodes (boots=False) are up at ``now`` already
            up_at = now + (pool.boot_latency if boots else 0.0)
            node.kill_at = up_at + float(
                self.rng.exponential(pool.spot_lifetime_mean))
        self.nodes[node.node_id] = node
        return node
