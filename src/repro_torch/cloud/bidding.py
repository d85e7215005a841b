"""Demand-aware per-zone spot bidding: turn observed reclaim pain into
provisioning decisions.

Copy of ``repro.cloud.bidding`` (framework-free), line for line, so both
packages give bit-equal results on the same inputs.

The autoscaler's static ``spot_fraction`` buys the same spot mix no matter
what the market does to it.  This module closes the measure-then-adapt loop
(cf. arXiv:2602.17318 — measured-adaptive dominates static policies — and
arXiv:2603.14630 — the adaptation must live in the runtime):

- :class:`SpotRiskLedger` folds every spot kill / correlated zone reclaim
  into a per-zone exponentially-decayed estimate of the *preemption cost
  actually paid*: checkpoint write + restore time at each victim's slot
  count (priced at the accountant's blended rate), cross-region checkpoint
  ``transfer_cost`` dollars, and lost-work seconds (the outage window
  between kill and resume, in victim slot-seconds).  Undecayed audit totals
  ride along so tests can reconcile the ledger against the raw blast
  records.
- :class:`DemandAwareBidder` compares, per zone, the ledger's observed
  risk-cost rate ($/s, exponentially weighted) against the spot discount
  that zone's capacity buys ($/s saved vs. the cheapest on-demand rate).
  Zones whose risk outruns their discount are closed (their share goes to
  zero and the freed share redistributes to the surviving zones); zones
  whose risk decays back below break-even reopen.  A Schmitt-trigger
  hysteresis band keeps estimates from flapping the share: the ratio must
  cross ``1 + hysteresis`` to close and fall below ``1 - hysteresis`` to
  reopen.

The bidder plugs into :class:`~repro_torch.cloud.node_autoscaler.AutoscalerConfig`
via the ``bidder=`` slot; with ``bidder=None`` the autoscaler keeps the
static even split (behaviorally identical to the pre-bidder code).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.cloud.provider import SPOT, CloudProvider, NodePool

LN2 = math.log(2.0)


@dataclass
class ZoneRisk:
    """Per-zone ledger state: exponentially-decayed estimates plus undecayed
    audit totals (the latter must always equal the sum of ingested records,
    whatever the interleaving — see tests/test_bidding_properties.py)."""
    last_update: float = 0.0
    # decayed estimators (half-life = ledger.half_life)
    decayed_kills: float = 0.0
    decayed_dollars: float = 0.0
    decayed_lost_s: float = 0.0
    # undecayed audit totals
    kills: int = 0                  # node kills attributed to this zone
    dollars: float = 0.0            # non-transfer preemption dollars
    transfer_dollars: float = 0.0   # cross-region checkpoint transfer
    lost_s: float = 0.0             # victim slot-seconds of lost work

    @property
    def total_dollars(self) -> float:
        return self.dollars + self.transfer_dollars


class SpotRiskLedger:
    """Fold kill/reclaim observables into per-zone decayed risk estimates.

    The decay is continuous-time exponential with the given half-life: a
    recorded dollar counts for half as much ``half_life`` seconds later.
    ``cost_rate`` converts the decayed tally into an exponentially-weighted
    $/s (a window of time-constant ``half_life / ln 2`` holds
    ``decayed_dollars`` dollars, so the rate is ``decayed * ln2 /
    half_life``)."""

    def __init__(self, half_life: float = 1800.0):
        assert half_life > 0.0, half_life
        self.half_life = half_life
        self._lambda = LN2 / half_life
        self.zones: Dict[str, ZoneRisk] = {}

    # -- ingestion -----------------------------------------------------------
    def _state(self, zone: str, now: float) -> ZoneRisk:
        s = self.zones.get(zone)
        if s is None:
            s = self.zones[zone] = ZoneRisk(last_update=now)
        else:
            self._advance(s, now)
        return s

    def _advance(self, s: ZoneRisk, now: float) -> None:
        dt = now - s.last_update
        if dt > 0.0:
            f = math.exp(-self._lambda * dt)
            s.decayed_kills *= f
            s.decayed_dollars *= f
            s.decayed_lost_s *= f
            s.last_update = now
        # out-of-order records (property tests shuffle events) fold in at
        # the current decay level instead of decaying negatively

    def record_kill(self, zone: str, now: float, *, nodes: int = 1,
                    dollars: float = 0.0, lost_seconds: float = 0.0) -> None:
        """One (or a batch of) node kill(s) in ``zone`` plus the preemption
        cost its victims paid up front (checkpoint writes at their slot
        counts, priced by the accountant)."""
        s = self._state(zone, now)
        s.decayed_kills += nodes
        s.decayed_dollars += dollars
        s.decayed_lost_s += lost_seconds
        s.kills += nodes
        s.dollars += dollars
        s.lost_s += lost_seconds

    def record_cost(self, zone: str, now: float, *, dollars: float = 0.0,
                    lost_seconds: float = 0.0,
                    transfer_dollars: float = 0.0) -> None:
        """Follow-up cost of an earlier kill (restore-from-disk at resume
        time, outage lost-work, cross-region transfer) attributed back to
        the zone that caused it.  Does not count as a new kill."""
        s = self._state(zone, now)
        s.decayed_dollars += dollars + transfer_dollars
        s.decayed_lost_s += lost_seconds
        s.dollars += dollars
        s.transfer_dollars += transfer_dollars
        s.lost_s += lost_seconds

    # -- queries -------------------------------------------------------------
    def observed(self, zone: str) -> bool:
        return self.zones.get(zone) is not None and self.zones[zone].kills > 0

    def kill_rate(self, zone: str, now: float) -> float:
        """Exponentially-weighted kills/s for the zone (0 with no history)."""
        s = self.zones.get(zone)
        if s is None:
            return 0.0
        self._advance(s, now)
        return s.decayed_kills * self._lambda

    def cost_rate(self, zone: str, now: float) -> float:
        """Exponentially-weighted preemption $/s attributed to the zone."""
        s = self.zones.get(zone)
        if s is None:
            return 0.0
        self._advance(s, now)
        return s.decayed_dollars * self._lambda

    def decayed_kills(self, zone: str, now: float) -> float:
        """Exponentially-decayed kill count — the evidence mass behind the
        zone's estimates (the bidder's ``min_evidence_kills`` gate)."""
        s = self.zones.get(zone)
        if s is None:
            return 0.0
        self._advance(s, now)
        return s.decayed_kills

    def totals(self, zone: str) -> ZoneRisk:
        return self.zones.get(zone, ZoneRisk())


@dataclass(frozen=True)
class BidderConfig:
    half_life: float = 1800.0     # ledger decay half-life (s)
    hysteresis: float = 0.25      # Schmitt band around break-even ratio 1.0
    #: assumed risk/discount ratio for zones with NO kill history — below
    #: 1 - hysteresis (the default) a fresh zone starts open at the static
    #: split; a cautious operator can set it above 1 + hysteresis to make
    #: zones earn their way in
    prior_ratio: float = 0.0
    #: per-zone ceiling on the emitted share (of total provisioned slots) —
    #: redistribution away from closed zones never concentrates more than
    #: this in one blast domain
    spot_fraction_max: float = 1.0
    #: multiplier on the observed risk-cost rate: >1 weights realized
    #: preemption pain more than raw dollars (the classic risk-aversion
    #: coefficient of the bidding literature)
    risk_aversion: float = 1.0
    #: decayed kill count below which a zone's estimates are not trusted and
    #: the prior applies — one catastrophic wipe is an anecdote, a cadence
    #: of kills is evidence (kills single-event variance in quiet markets)
    min_evidence_kills: float = 0.0

    def __post_init__(self):
        assert 0.0 <= self.hysteresis < 1.0, self.hysteresis
        assert 0.0 < self.spot_fraction_max <= 1.0, self.spot_fraction_max
        assert self.risk_aversion > 0.0
        assert self.min_evidence_kills >= 0.0


class DemandAwareBidder:
    """Per-zone spot share from observed risk vs. discount, with hysteresis.

    Each evaluation (one per ``autoscale_tick``) classifies every open spot
    zone as *open* (risk below break-even: worth its discount) or *closed*
    (risk above: the reclaims cost more than the discount saves) and splits
    the global ``spot_fraction`` evenly over the open zones, capped at
    ``spot_fraction_max`` per zone.  Every open<->closed flip counts as one
    ``adjustment`` (surfaced as ``ScheduleMetrics.bid_adjustments``)."""

    def __init__(self, cfg: BidderConfig = BidderConfig(),
                 ledger: Optional[SpotRiskLedger] = None):
        self.cfg = cfg
        self.ledger = ledger if ledger is not None \
            else SpotRiskLedger(cfg.half_life)
        self._open: Dict[str, bool] = {}
        self.adjustments = 0
        self.last_shares: Dict[str, float] = {}
        # decision-audit sink (repro_torch.obs); None records nothing
        self.decisions = None

    # -- risk model ----------------------------------------------------------
    def _zone_spot_pools(self, zone: str,
                         provider: CloudProvider) -> List[NodePool]:
        return [p for p in provider.pools.values()
                if p.market == SPOT and p.zone == zone]

    def savings_rate(self, zone: str, provider: CloudProvider) -> float:
        """$/s the zone's spot capacity saves vs. buying the cheapest
        on-demand rate instead, over max(current zone spot slots, one
        node) — the floor keeps the comparison marginal: even an empty zone
        is judged on what its NEXT node would save."""
        pools = self._zone_spot_pools(zone, provider)
        if not pools:
            return 0.0
        cheapest = min(pools, key=lambda p: p.price_per_slot_hour)
        od = [p.price_per_slot_hour for p in provider.pools.values()
              if p.market != SPOT]
        # no on-demand reference: judge the discount against the priciest
        # pool anywhere (an all-spot fleet still prefers its safer zones)
        ref = min(od) if od else max(
            p.price_per_slot_hour for p in provider.pools.values())
        discount = ref - cheapest.price_per_slot_hour
        if discount <= 0.0:
            return 0.0
        slots = max(provider.zone_slots(zone, SPOT), cheapest.slots_per_node)
        return discount * slots / 3600.0

    def kill_cost_floor(self, zone: str, provider: CloudProvider) -> float:
        """Minimum dollars one kill is worth: the replacement boot burn
        (node-hour price x boot latency).  Every kill forces a replacement
        boot during which the fleet misses capacity it provisioned for a
        reason — so a cadence of kills carries risk even when the individual
        wipes happened to hit empty nodes (the hot-zone self-limiting case:
        nodes die before work lands on them)."""
        pools = self._zone_spot_pools(zone, provider)
        if not pools:
            return 0.0
        cheapest = min(pools, key=lambda p: p.price_per_slot_hour)
        return cheapest.price_per_node_hour * cheapest.boot_latency / 3600.0

    def risk_ratio(self, zone: str, now: float,
                   provider: CloudProvider) -> Optional[float]:
        """Observed risk-cost rate / spot-discount rate.  >1 means the
        zone's reclaims cost more than its discount saves (past its
        break-even).  Zones with NO kill history return the configured
        prior; zones whose decayed evidence has fallen below
        ``min_evidence_kills`` return None — "not enough evidence to
        reclassify", so the zone HOLDS its current state (a closed zone
        with no remaining exposure generates no new kills and must not
        snap back to the prior).  The risk-cost rate is the larger of the
        realized rate (ledger dollars) and the kill-frequency floor
        (kills/s x replacement boot burn)."""
        if not self.ledger.observed(zone):
            return self.cfg.prior_ratio
        if self.ledger.decayed_kills(zone, now) < self.cfg.min_evidence_kills:
            return None
        floor = self.ledger.kill_rate(zone, now) * \
            self.kill_cost_floor(zone, provider)
        cost = max(self.ledger.cost_rate(zone, now), floor) * \
            self.cfg.risk_aversion
        savings = self.savings_rate(zone, provider)
        if savings <= 0.0:
            return math.inf if cost > 0.0 else self.cfg.prior_ratio
        return cost / savings

    # -- share emission ------------------------------------------------------
    def zone_quotas(self, zones: List[str], now: float,
                    provider: CloudProvider,
                    spot_fraction: float) -> Dict[str, float]:
        """Per-zone spot-slot-share quotas over the given open zones.  Each
        emitted share lies in ``[0, spot_fraction_max]`` and the shares sum
        to at most ``spot_fraction`` (the global cap the autoscaler still
        enforces independently)."""
        h = self.cfg.hysteresis
        for z in zones:
            r = self.risk_ratio(z, now, provider)
            was_open = self._open.get(z, True)
            is_open = was_open
            if r is None:
                pass                    # insufficient evidence: hold state
            elif was_open and r > 1.0 + h:
                is_open = False
            elif not was_open and r < 1.0 - h:
                is_open = True
            if is_open is not was_open:
                self.adjustments += 1
                if self.decisions is not None:
                    self.decisions.record(
                        "bid_flip", now, "open" if is_open else "close",
                        inputs={
                            "zone": z,
                            "risk_ratio": (None if r is None or math.isinf(r)
                                           else r),
                            "risk_cost_rate": self.ledger.cost_rate(z, now),
                            "kill_rate": self.ledger.kill_rate(z, now),
                            "kill_cost_floor": self.kill_cost_floor(
                                z, provider),
                            "savings_rate": self.savings_rate(z, provider),
                            "evidence_kills": self.ledger.decayed_kills(
                                z, now),
                            "risk_aversion": self.cfg.risk_aversion,
                            "close_above": 1.0 + h,
                            "open_below": 1.0 - h})
            self._open[z] = is_open
        n_open = sum(1 for z in zones if self._open[z])
        if n_open == 0:
            shares = {z: 0.0 for z in zones}
        else:
            per = min(self.cfg.spot_fraction_max, spot_fraction / n_open)
            shares = {z: (per if self._open[z] else 0.0) for z in zones}
        self.last_shares = dict(shares)
        return shares

    def is_open(self, zone: str) -> bool:
        return self._open.get(zone, True)
