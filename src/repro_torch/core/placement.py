"""Placement layer: slot -> concrete node ownership (paper: pods on nodes).

Copy of ``repro.core.placement`` (framework-free).

The counting :class:`~repro_torch.core.cluster.Cluster` of earlier revisions knew
*how many* slots a job held but not *where*; a spot kill therefore shrank
"some" victims rather than the jobs actually resident on the killed node, and
the autoscaler could not pick the emptiest node to drain.  ``PlacementMap``
closes that gap: every slot has a stable global index, belongs to exactly one
node, and is owned by at most one job.

Concepts
--------
- **node**: a named group of slots with a stable, contiguous index range
  (contiguity within a node is the interconnect/pod-affinity locality analog).
- **cordon**: a cordoned node is excluded from capacity and from new
  placement, but existing residents stay until migrated/evicted — the
  ``kubectl cordon``/drain analog used by spot kills and scale-down drains.
- **zone**: every node belongs to a failure zone (cloud: an availability
  zone whose spot capacity is reclaimed in correlated bursts).  Nodes added
  without a zone get a private one (zone == node_id), so zone-aware logic
  degenerates gracefully on zone-oblivious clusters.
- **strategy**: where new slots go.  ``pack`` fills the fullest non-empty
  node first (keeps whole nodes empty so the autoscaler can release them);
  ``spread`` round-robins across the emptiest nodes (minimizes how much of
  any single job one node kill can take out); ``zone_spread`` balances a
  job's slots across zones first (minimizes how much of the job one
  correlated ZONE reclaim can take out), packing within the chosen zone so
  the idle-dollar cost of diversification stays small.

Fleet-scale accounting: free counts, capacity, per-job slot sets, and the
fragmentation aggregate are all maintained incrementally on
place/evict/add_node/remove_node/cordon — ``free()``, ``total_capacity``,
``owned()`` and ``fragmentation()`` are O(1), never node scans.  ``pack``
and ``spread`` pick nodes through lazy min-heaps keyed exactly like the old
per-call sorts (stale entries are validated against the node's current free
count at pop time), so the chosen slot sequence is bit-identical to the
scan-and-sort implementation while each placement costs O(log nodes).

Invariants (property-tested on the JAX package's copy in
tests/test_placement_properties.py):
- no slot is ever owned by two jobs;
- per-node residency sums equal the total owned-slot count;
- cordoned capacity is excluded from ``total_capacity`` and ``free()``;
- the incremental aggregates reconcile against a full recount (``check()``).
"""
from __future__ import annotations

import heapq
import itertools
from bisect import bisect_left, insort
from typing import Dict, List, Optional, Set


class PlacementError(RuntimeError):
    """A placement request that cannot be satisfied (not a crash: callers
    that race capacity changes should pre-check with ``free()``)."""


class PlacementMap:
    STRATEGIES = ("pack", "spread", "zone_spread")

    def __init__(self, strategy: str = "pack"):
        assert strategy in self.STRATEGIES, strategy
        self.default_strategy = strategy
        self._next_slot = 0
        self._seq = itertools.count()
        self._slots: Dict[str, List[int]] = {}        # node -> slot indices
        self._node_seq: Dict[str, int] = {}           # deterministic tie-break
        self._cordoned: Set[str] = set()
        self._owner: Dict[int, Optional[str]] = {}    # slot -> job (None free)
        self._slot_node: Dict[int, str] = {}
        self._zone: Dict[str, str] = {}               # node -> failure zone
        # -- incremental aggregates (the fleet-scale hot path) ---------------
        self._free_ids: Dict[str, List[int]] = {}     # node -> SORTED free ids
        self._job_slots: Dict[str, Set[int]] = {}     # job -> owned slot ids
        self._free_sched = 0        # free slots on schedulable nodes
        self._cap_sched = 0         # capacity of schedulable nodes
        self._free_on_empty = 0     # free slots on EMPTY schedulable nodes
        # lazy selection heaps: entries carry the key the node had when
        # pushed; pop-time validation against the current free count drops
        # stale entries, so the min valid entry is the true strategy choice
        self._pack_heap: List[tuple] = []   # (is_empty, free, seq, nid)
        self._spread_heap: List[tuple] = []  # (-free, seq, nid)

    # -- aggregate maintenance ----------------------------------------------
    def _push_keys(self, nid: str) -> None:
        """Re-key a node in the selection heaps after its free count
        changed (lazy update: old entries are invalidated by comparison)."""
        f = len(self._free_ids[nid])
        if f == 0 or nid in self._cordoned:
            return
        seq = self._node_seq[nid]
        heapq.heappush(self._pack_heap,
                       (f == len(self._slots[nid]), f, seq, nid))
        heapq.heappush(self._spread_heap, (-f, seq, nid))
        # bound stale-entry growth: rebuild once the heaps dwarf the fleet
        if len(self._pack_heap) > 64 + 4 * len(self._slots):
            self._rebuild_heaps()

    def _rebuild_heaps(self) -> None:
        pack, spread = [], []
        for nid, fl in self._free_ids.items():
            f = len(fl)
            if f and nid not in self._cordoned:
                seq = self._node_seq[nid]
                pack.append((f == len(self._slots[nid]), f, seq, nid))
                spread.append((-f, seq, nid))
        heapq.heapify(pack)
        heapq.heapify(spread)
        self._pack_heap, self._spread_heap = pack, spread

    def _assign(self, slot: int, job_id: str, push: bool = True) -> None:
        """Give a FREE slot to ``job_id``, updating every aggregate.
        ``push=False`` defers the heap re-key to the caller (batch paths
        re-key each touched node once at the end)."""
        nid = self._slot_node[slot]
        fl = self._free_ids[nid]
        fl.pop(bisect_left(fl, slot))
        self._owner[slot] = job_id
        self._job_slots.setdefault(job_id, set()).add(slot)
        if nid not in self._cordoned:
            if len(fl) + 1 == len(self._slots[nid]):   # node was empty
                self._free_on_empty -= len(self._slots[nid])
            self._free_sched -= 1
            if push:
                self._push_keys(nid)

    def _release(self, slot: int) -> None:
        """Return an owned slot to the free pool, updating every aggregate."""
        job_id = self._owner[slot]
        self._owner[slot] = None
        owned = self._job_slots[job_id]
        owned.discard(slot)
        if not owned:
            del self._job_slots[job_id]
        nid = self._slot_node[slot]
        fl = self._free_ids[nid]
        insort(fl, slot)
        if nid not in self._cordoned:
            self._free_sched += 1
            if len(fl) == len(self._slots[nid]):       # node is empty again
                self._free_on_empty += len(self._slots[nid])
            self._push_keys(nid)

    # -- node lifecycle ------------------------------------------------------
    def add_node(self, node_id: str, slots: int,
                 zone: Optional[str] = None) -> List[int]:
        assert node_id not in self._slots, node_id
        assert slots >= 1, slots
        ids = list(range(self._next_slot, self._next_slot + slots))
        self._next_slot += slots
        self._slots[node_id] = ids
        self._node_seq[node_id] = next(self._seq)
        # zoneless nodes get a private zone so zone_spread degenerates to a
        # per-node spread instead of treating the cluster as one blast domain
        self._zone[node_id] = zone if zone is not None else node_id
        for i in ids:
            self._owner[i] = None
            self._slot_node[i] = node_id
        self._free_ids[node_id] = list(ids)
        self._cap_sched += slots
        self._free_sched += slots
        self._free_on_empty += slots
        self._push_keys(node_id)
        return ids

    def remove_node(self, node_id: str) -> int:
        """Retire an EMPTY node (drain residents first — see cordon/evict/
        migrate).  Raises :class:`PlacementError` while residents remain."""
        res = self.residents(node_id)
        if res:
            raise PlacementError(
                f"remove_node({node_id}): still hosts {res}")
        ids = self._slots.pop(node_id)
        self._node_seq.pop(node_id)
        self._zone.pop(node_id)
        if node_id not in self._cordoned:       # an empty schedulable node
            self._cap_sched -= len(ids)
            self._free_sched -= len(ids)
            self._free_on_empty -= len(ids)
        self._cordoned.discard(node_id)
        del self._free_ids[node_id]
        for i in ids:
            del self._owner[i]
            del self._slot_node[i]
        return len(ids)

    def cordon(self, node_id: str) -> None:
        """Exclude a node from capacity and from new placement; residents
        stay until evicted/migrated (drain)."""
        assert node_id in self._slots, node_id
        if node_id in self._cordoned:
            return
        f = len(self._free_ids[node_id])
        cap = len(self._slots[node_id])
        self._cap_sched -= cap
        self._free_sched -= f
        if f == cap:
            self._free_on_empty -= cap
        self._cordoned.add(node_id)

    def uncordon(self, node_id: str) -> None:
        assert node_id in self._slots, node_id
        if node_id not in self._cordoned:
            return
        self._cordoned.discard(node_id)
        f = len(self._free_ids[node_id])
        cap = len(self._slots[node_id])
        self._cap_sched += cap
        self._free_sched += f
        if f == cap:
            self._free_on_empty += cap
        self._push_keys(node_id)

    def is_cordoned(self, node_id: str) -> bool:
        return node_id in self._cordoned

    # -- queries -------------------------------------------------------------
    def nodes(self) -> List[str]:
        return list(self._slots)

    @property
    def node_count(self) -> int:
        return len(self._slots)

    def capacity(self, node_id: str) -> int:
        return len(self._slots[node_id])

    @property
    def total_capacity(self) -> int:
        """Schedulable slots: cordoned nodes are already on their way out."""
        return self._cap_sched

    def free(self, node_id: Optional[str] = None) -> int:
        """Free slots on schedulable nodes (or on one specific node)."""
        if node_id is not None:
            return len(self._free_ids[node_id])
        return self._free_sched

    def owned(self, job_id: str) -> int:
        return len(self._job_slots.get(job_id, ()))

    def slots_of(self, job_id: str) -> List[int]:
        return sorted(self._job_slots.get(job_id, ()))

    def node_of(self, slot: int) -> str:
        return self._slot_node[slot]

    def residents(self, node_id: str) -> Dict[str, int]:
        """job_id -> slot count resident on this node."""
        out: Dict[str, int] = {}
        for i in self._slots.get(node_id, ()):
            o = self._owner[i]
            if o is not None:
                out[o] = out.get(o, 0) + 1
        return out

    def resident_count(self, node_id: str) -> int:
        return sum(self.residents(node_id).values())

    def job_nodes(self, job_id: str) -> Dict[str, int]:
        """node_id -> slot count this job holds there (its blast footprint)."""
        out: Dict[str, int] = {}
        for i in sorted(self._job_slots.get(job_id, ())):
            nid = self._slot_node[i]
            out[nid] = out.get(nid, 0) + 1
        return out

    def zone_of(self, node_id: str) -> str:
        return self._zone[node_id]

    def job_zones(self, job_id: str) -> Dict[str, int]:
        """zone -> slot count this job holds there (its CORRELATED blast
        footprint: what one zone reclaim can take out at once)."""
        out: Dict[str, int] = {}
        for nid, cnt in self.job_nodes(job_id).items():
            z = self._zone[nid]
            out[z] = out.get(z, 0) + cnt
        return out

    def fragmentation(self) -> float:
        """Fraction of free schedulable capacity stranded on partially-used
        nodes (a whole-node consumer — scale-down, a min_replicas burst —
        cannot use it without a drain).  0 = all free capacity sits on empty
        nodes; 1 = every free slot shares a node with running work."""
        if not self._free_sched:
            return 0.0
        return 1.0 - self._free_on_empty / self._free_sched

    # -- placement -----------------------------------------------------------
    def _pop_pack(self) -> Optional[str]:
        """Fullest non-empty schedulable node with free slots (pack order);
        stale heap entries are discarded by comparing against the node's
        current key."""
        heap = self._pack_heap
        while heap:
            empty, f, seq, nid = heapq.heappop(heap)
            if (self._node_seq.get(nid) == seq
                    and nid not in self._cordoned
                    and len(self._free_ids[nid]) == f):
                return nid
        return None

    def _pop_spread(self) -> Optional[str]:
        """Emptiest schedulable node with free slots (spread order)."""
        heap = self._spread_heap
        while heap:
            negf, seq, nid = heapq.heappop(heap)
            if (self._node_seq.get(nid) == seq
                    and nid not in self._cordoned
                    and len(self._free_ids[nid]) == -negf):
                return nid
        return None

    def place(self, job_id: str, n: int, strategy: Optional[str] = None
              ) -> List[int]:
        """Assign ``n`` free slots to ``job_id`` per the strategy; returns the
        chosen slot indices.  All-or-nothing: raises :class:`PlacementError`
        (mutating nothing) when fewer than ``n`` schedulable slots are free."""
        assert n >= 1, n
        strategy = strategy or self.default_strategy
        assert strategy in self.STRATEGIES, strategy
        if self._free_sched < n:
            raise PlacementError(
                f"place({job_id}, {n}): only {self.free()} slots free")
        chosen: List[int] = []
        if strategy == "zone_spread":
            # one slot at a time into the zone where the job currently holds
            # the fewest slots (ties: most free capacity, then zone name) —
            # bounds the correlated blast: a fresh n-slot placement leaves at
            # most ceil(n / zones_with_capacity) slots in any one zone.
            # Within the chosen zone, pack (fullest non-empty node first) so
            # diversification does not also fragment every node.
            free_ids: Dict[str, List[int]] = {
                nid: list(fl) for nid, fl in self._free_ids.items()
                if fl and nid not in self._cordoned}
            zone_free: Dict[str, List[str]] = {}
            for nid in free_ids:
                zone_free.setdefault(self._zone[nid], []).append(nid)
            held = self.job_zones(job_id)
            touched: Set[str] = set()
            while len(chosen) < n:
                z = min(zone_free, key=lambda k: (
                    held.get(k, 0),
                    -sum(len(free_ids[nid]) for nid in zone_free[k]), k))
                nid = min(zone_free[z], key=lambda k: (
                    len(free_ids[k]) == len(self._slots[k]),  # empties last
                    len(free_ids[k]),                         # least free
                    self._node_seq[k]))
                slot = free_ids[nid].pop(0)
                # selection runs on the local free_ids copies, so the heap
                # re-key can wait until the loop is done (once per node)
                self._assign(slot, job_id, push=False)
                touched.add(nid)
                chosen.append(slot)
                held[z] = held.get(z, 0) + 1
                if not free_ids[nid]:
                    del free_ids[nid]
                    zone_free[z].remove(nid)
                    if not zone_free[z]:
                        del zone_free[z]
            for nid in touched:
                self._push_keys(nid)
        elif strategy == "spread":
            # one slot at a time from the currently-emptiest node
            while len(chosen) < n:
                nid = self._pop_spread()
                slot = self._free_ids[nid][0]
                self._assign(slot, job_id)
                chosen.append(slot)
        else:                                         # pack: fullest first
            # taking slots never raises another node's pack rank, so popping
            # the lazy heap reproduces the one-shot sorted order exactly.
            # Bulk form of _assign: every popped node is either drained to
            # zero (no heap key needed) or is the last node touched (re-keyed
            # once after the loop) — per-slot heap churn drops to zero.
            owner = self._owner
            owned = self._job_slots.setdefault(job_id, set())
            nid = None
            while len(chosen) < n:
                nid = self._pop_pack()                # never cordoned
                fl = self._free_ids[nid]
                k = min(n - len(chosen), len(fl))
                take = fl[:k]
                del fl[:k]
                for i in take:
                    owner[i] = job_id
                owned.update(take)
                cap = len(self._slots[nid])
                if len(fl) + k == cap:                # node was empty
                    self._free_on_empty -= cap
                self._free_sched -= k
                chosen.extend(take)
            if nid is not None and self._free_ids[nid]:
                self._push_keys(nid)
        return sorted(chosen)

    def evict(self, job_id: str, n: Optional[int] = None,
              prefer: Optional[str] = None) -> List[int]:
        """Free ``n`` of the job's slots (all when None).  Order: the
        ``prefer`` node first, then cordoned nodes, then — under pack/spread
        — nodes where the job holds the fewest slots (clearing its footprint
        off marginal nodes).  Under ``zone_spread`` the tail order instead
        drains the job's FATTEST zone first: thin-first eviction would strip
        the minority zones on every shrink and quietly re-concentrate the
        job into one blast domain, undoing exactly what the placement
        diversified for."""
        owned = self.slots_of(job_id)
        presorted = False
        if n is None or n >= len(owned):
            # total eviction: every slot goes, so victim ordering (and the
            # footprint bookkeeping that feeds it) is irrelevant
            victims = owned
            presorted = True            # slots_of returns sorted
        else:
            foot = self.job_nodes(job_id)
            zone_aware = self.default_strategy == "zone_spread"
            def key(slot: int, zfoot):
                nid = self._slot_node[slot]
                return (nid != prefer,             # preferred node first
                        nid not in self._cordoned,  # then draining nodes
                        -zfoot[self._zone[nid]] if zone_aware else 0,
                        foot[nid],                 # then thin footprints
                        self._node_seq[nid],
                        -slot)                     # highest index first
            if not zone_aware and len(foot) == 1:
                # all slots share one node: every key component except -slot
                # is constant, so the victim set is just the n highest indices
                victims = owned[len(owned) - n:]
                presorted = True
            elif zone_aware:
                # pick one victim at a time, re-ranking as zone footprints
                # fall: a one-shot sort against the initial footprint would
                # drain the fattest zone wholesale and re-concentrate the
                # survivor slots
                zfoot = self.job_zones(job_id)
                pool = list(owned)
                victims = []
                for _ in range(min(n, len(pool))):
                    slot = min(pool, key=lambda s: key(s, zfoot))
                    pool.remove(slot)
                    victims.append(slot)
                    nid = self._slot_node[slot]
                    zfoot[self._zone[nid]] -= 1
                    foot[nid] -= 1
            else:
                victims = sorted(owned, key=lambda s: key(s, None))[:n]
        if not victims:
            return []
        # bulk form of _release: aggregates and heap keys update once per
        # touched node instead of once per slot
        job_owned = self._job_slots[job_id]
        job_owned.difference_update(victims)
        if not job_owned:
            del self._job_slots[job_id]
        owner = self._owner
        if len(self._slots) == 1:       # single node: no grouping needed
            for i in victims:
                owner[i] = None
            by_node = {next(iter(self._slots)): victims}
        else:
            by_node: Dict[str, List[int]] = {}
            for i in victims:
                owner[i] = None
                nid = self._slot_node[i]
                g = by_node.get(nid)
                if g is None:
                    by_node[nid] = [i]
                else:
                    g.append(i)
        for nid, group in by_node.items():
            fl = self._free_ids[nid]
            # timsort merges the two sorted runs in one C call
            fl.extend(group)
            fl.sort()
            if nid not in self._cordoned:
                self._free_sched += len(group)
                if len(fl) == len(self._slots[nid]):   # node is empty again
                    self._free_on_empty += len(self._slots[nid])
                self._push_keys(nid)
        return victims if presorted else sorted(victims)

    def migrate(self, job_id: str, from_node: str,
                strategy: Optional[str] = None) -> int:
        """Move as many of the job's slots on ``from_node`` as fit onto free
        schedulable slots elsewhere; returns the number moved.  Cordon the
        node first if new placement must not land back on it."""
        resident = [i for i in self._slots[from_node]
                    if self._owner[i] == job_id]
        # free slots NOT on from_node (it may be uncordoned)
        movable = min(len(resident),
                      self.free() - (0 if from_node in self._cordoned
                                     else self.free(from_node)))
        if movable <= 0:
            return 0
        was_cordoned = from_node in self._cordoned
        self.cordon(from_node)                     # keep place() off it
        try:
            for i in resident[:movable]:
                self._release(i)
            self.place(job_id, movable, strategy)
        finally:
            if not was_cordoned:
                self.uncordon(from_node)
        return movable

    # -- invariants (test hook) ----------------------------------------------
    def check(self) -> None:
        owners: Dict[str, int] = {}
        for i, o in self._owner.items():
            assert i in self._slot_node
            if o is not None:
                owners[o] = owners.get(o, 0) + 1
        per_node = sum(self.resident_count(nid) for nid in self._slots)
        assert per_node == sum(owners.values()), (per_node, owners)
        assert 0.0 <= self.fragmentation() <= 1.0
        # incremental aggregates reconcile against a full recount
        for job_id, slots in self._job_slots.items():
            assert slots, job_id
            assert all(self._owner[i] == job_id for i in slots)
        assert owners == {j: len(s) for j, s in self._job_slots.items()}
        free_sched = cap_sched = free_on_empty = 0
        for nid, ids in self._slots.items():
            fl = self._free_ids[nid]
            assert fl == sorted(i for i in ids if self._owner[i] is None)
            if nid not in self._cordoned:
                free_sched += len(fl)
                cap_sched += len(ids)
                if len(fl) == len(ids):
                    free_on_empty += len(ids)
        assert free_sched == self._free_sched, (free_sched, self._free_sched)
        assert cap_sched == self._cap_sched, (cap_sched, self._cap_sched)
        assert free_on_empty == self._free_on_empty, \
            (free_on_empty, self._free_on_empty)
