"""Causal span graph: per-job lifecycle span trees with cause edges.

Copy of ``repro.obs.spans`` (framework-free).

The flight recorder (:mod:`repro_torch.obs.trace`) emits a flat, time-ordered
record stream.  This module folds that stream — offline from a loaded JSONL
trace, or online via a :class:`SpanTap` wrapped around the live tracer —
into per-job **span trees**:

.. code-block:: text

    job:j3                                  [   0.0 ..  941.2]
      queue_wait                            [   0.0 ..   60.0]
      compute                               [  60.0 ..  300.0]
      ckpt                                  [ 295.0 ..  300.0]
      outage            <- spot_kill        [ 300.0 ..  420.0]
      restore                               [ 420.0 ..  450.0]
      compute           <- outage           [ 420.0 ..  941.2]

plus infrastructure spans (``spot_kill`` blast windows, ``zone_reclaim``
batch windows, ``scale_down`` drains) and **cause edges** that stitch them
into chains the flat stream only implies:

- ``zone_reclaim -> spot_kill``: a kill whose node is in the reclaim's
  victim list, inside the reclaim's batch window;
- ``spot_kill -> preempt outage``: a job preempted inside the blast window
  of a kill whose ``residents`` include it;
- ``preempt outage -> resumed compute``: the segment that restarts a job
  after its outage;
- ``scale_down -> job_migrate``: a drain decision naming the node a later
  migration moved a job off.

:meth:`SpanGraph.longest_causal_chain` walks the cause edges — a full
``zone_reclaim -> spot_kill -> outage -> compute`` chain scores 4 — and
feeds the fleet rollups in :mod:`repro_torch.obs.critical_path`.

Phase *durations* live in :mod:`repro_torch.obs.critical_path` (exact partition);
this module keeps the *structure* — who caused what, in which order.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence


@dataclass
class Span:
    """One interval in a job's (or the infrastructure's) lifecycle.

    ``t1`` is None while the span is still open (live feeds see open spans).
    ``cause`` points at the span that made this one happen — the cause
    edges are a DAG layered over the per-job trees.
    """
    name: str
    t0: float
    t1: Optional[float] = None
    job: Optional[str] = None
    meta: Dict[str, Any] = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)
    cause: Optional["Span"] = None

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        end = f"{self.t1:.1f}" if self.t1 is not None else "open"
        tag = f" job={self.job}" if self.job else ""
        why = f" <-{self.cause.name}" if self.cause is not None else ""
        return f"<Span {self.name}{tag} [{self.t0:.1f}..{end}]{why}>"


class SpanGraph:
    """The assembled result: one root span per job + infrastructure spans."""

    def __init__(self):
        self.jobs: Dict[str, Span] = {}
        self.infra: List[Span] = []

    def all_spans(self) -> List[Span]:
        out: List[Span] = []

        def walk(s: Span) -> None:
            out.append(s)
            for c in s.children:
                walk(c)

        for root in self.jobs.values():
            walk(root)
        for s in self.infra:
            walk(s)
        return out

    def chain_of(self, span: Span) -> List[Span]:
        """The cause chain ending at ``span`` (root cause first)."""
        chain, seen = [], set()
        cur: Optional[Span] = span
        while cur is not None and id(cur) not in seen:
            seen.add(id(cur))
            chain.append(cur)
            cur = cur.cause
        return list(reversed(chain))

    def longest_causal_chain(self) -> int:
        """Length (in spans) of the longest cause chain in the graph."""
        return max((len(self.chain_of(s)) for s in self.all_spans()),
                   default=0)

    def job_tree(self, job_id: str) -> Optional[Span]:
        return self.jobs.get(job_id)


class SpanGraphBuilder:
    """Incremental builder: ``feed`` one record at a time (records must be
    time-ordered, as the recorder writes them).  Works identically on a
    loaded trace and on the live stream via :class:`SpanTap`."""

    #: a kill/drain can only cause a preempt/migrate this many seconds later
    CAUSE_HORIZON = 1e-6

    def __init__(self):
        self.graph = SpanGraph()
        self._open_wait: Dict[str, Span] = {}      # job -> open wait span
        self._open_seg: Dict[str, Span] = {}       # job -> open compute span
        self._open_kills: List[Span] = []          # spot_kill blast windows
        self._open_reclaims: List[Span] = []       # zone_reclaim batches
        self._drains: List[Span] = []              # scale_down decisions

    # -- record feed ---------------------------------------------------------
    def feed(self, rec: Dict[str, Any]) -> None:
        kind = rec.get("kind")
        handler = getattr(self, f"_on_{kind}", None) if kind else None
        if handler is not None:
            handler(rec)

    def build(self) -> SpanGraph:
        return self.graph

    # -- job lifecycle -------------------------------------------------------
    def _root(self, job_id: str, t: float) -> Span:
        root = self.graph.jobs.get(job_id)
        if root is None:
            root = self.graph.jobs[job_id] = Span("job", t, job=job_id)
        return root

    def _on_job_submit(self, r: Dict[str, Any]) -> None:
        job, t = r["job"], r.get("t", 0.0)
        root = Span("job", t, job=job,
                    meta={k: r[k] for k in ("priority", "min", "max")
                          if k in r})
        self.graph.jobs[job] = root
        wait = Span("queue_wait", t, job=job)
        root.children.append(wait)
        self._open_wait[job] = wait

    def _on_job_start(self, r: Dict[str, Any]) -> None:
        job, t = r["job"], r.get("t", 0.0)
        root = self._root(job, t)
        wait = self._open_wait.pop(job, None)
        if wait is not None:
            wait.t1 = t
        if r.get("resume") and r.get("overhead_s", 0.0) > 0.0:
            root.children.append(Span("restore", t, t + r["overhead_s"],
                                      job=job, cause=wait))
        seg = Span("compute", t, job=job,
                   meta={"slots": r.get("slots")},
                   cause=wait if (wait is not None
                                  and wait.name == "outage") else None)
        root.children.append(seg)
        self._open_seg[job] = seg

    def _on_job_rescale(self, r: Dict[str, Any]) -> None:
        job, t = r["job"], r.get("t", 0.0)
        self._root(job, t).children.append(
            Span("rescale", t, t + r.get("overhead_s", 0.0), job=job,
                 meta={"from": r.get("from"), "to": r.get("to")}))

    def _on_job_migrate(self, r: Dict[str, Any]) -> None:
        job, t = r["job"], r.get("t", 0.0)
        cause = self._match_drain(r.get("from_node"), t)
        self._root(job, t).children.append(
            Span("migrate", t, t + r.get("overhead_s", 0.0), job=job,
                 meta={"from_node": r.get("from_node"),
                       "moved": r.get("moved")},
                 cause=cause))

    def _on_job_preempt(self, r: Dict[str, Any]) -> None:
        job, t = r["job"], r.get("t", 0.0)
        root = self._root(job, t)
        seg = self._open_seg.pop(job, None)
        if seg is not None:
            seg.t1 = t
        ckpt_s = r.get("ckpt_s", 0.0)
        if ckpt_s > 0.0:
            root.children.append(Span("ckpt", t - ckpt_s, t, job=job))
        outage = Span("outage", t, job=job,
                      cause=self._match_kill(job, t))
        root.children.append(outage)
        self._open_wait[job] = outage

    def _on_job_fail(self, r: Dict[str, Any]) -> None:
        job, t = r["job"], r.get("t", 0.0)
        seg = self._open_seg.pop(job, None)
        if seg is not None:
            seg.t1 = t
        outage = Span("outage", t, job=job, cause=self._match_kill(job, t))
        self._root(job, t).children.append(outage)
        self._open_wait[job] = outage

    def _on_job_complete(self, r: Dict[str, Any]) -> None:
        job, t = r["job"], r.get("t", 0.0)
        seg = self._open_seg.pop(job, None)
        if seg is not None:
            seg.t1 = t
        wait = self._open_wait.pop(job, None)
        if wait is not None:
            wait.t1 = t
        root = self._root(job, t)
        root.t1 = t

    # -- infrastructure ------------------------------------------------------
    def _on_spot_kill(self, r: Dict[str, Any]) -> None:
        t = r.get("t", 0.0)
        kill = Span("spot_kill", t, job=None,
                    meta={"node": r.get("node"), "zone": r.get("zone"),
                          "residents": dict(r.get("residents") or {})},
                    cause=self._match_reclaim(r.get("node"), t))
        self.graph.infra.append(kill)
        self._open_kills.append(kill)

    def _on_kill_blast_end(self, r: Dict[str, Any]) -> None:
        node, t = r.get("node"), r.get("t", 0.0)
        for kill in self._open_kills:
            if kill.meta.get("node") == node and kill.t1 is None:
                kill.t1 = t
        self._open_kills = [k for k in self._open_kills if k.t1 is None]

    def _on_zone_reclaim(self, r: Dict[str, Any]) -> None:
        span = Span("zone_reclaim", r.get("t", 0.0),
                    meta={"zone": r.get("zone"),
                          "victims": list(r.get("victims") or [])})
        self.graph.infra.append(span)
        self._open_reclaims.append(span)

    def _on_zone_reclaim_end(self, r: Dict[str, Any]) -> None:
        zone, t = r.get("zone"), r.get("t", 0.0)
        for z in self._open_reclaims:
            if z.meta.get("zone") == zone and z.t1 is None:
                z.t1 = t
        self._open_reclaims = [z for z in self._open_reclaims
                               if z.t1 is None]

    def _on_decision(self, r: Dict[str, Any]) -> None:
        if r.get("point") != "scale_down":
            return
        inputs = r.get("inputs") or {}
        span = Span("scale_down", r.get("t", 0.0),
                    meta={"node": inputs.get("node"),
                          "verdict": r.get("verdict")})
        self.graph.infra.append(span)
        if r.get("verdict") in ("drained", "drain_started"):
            self._drains.append(span)
        elif r.get("verdict") in ("drain_complete", "drain_cancelled"):
            for d in self._drains:
                if d.meta.get("node") == inputs.get("node") \
                        and d.t1 is None:
                    d.t1 = span.t0
            self._drains = [d for d in self._drains if d.t1 is None]

    # -- cause matching ------------------------------------------------------
    def _match_kill(self, job_id: str, t: float) -> Optional[Span]:
        """The open spot-kill blast whose residents include this job (the
        recorder brackets kills as spot_kill..kill_blast_end, so displaced
        jobs preempt strictly inside the window)."""
        for kill in reversed(self._open_kills):
            if job_id in kill.meta.get("residents", {}):
                return kill
        return None

    def _match_reclaim(self, node_id: Optional[str],
                       t: float) -> Optional[Span]:
        for z in reversed(self._open_reclaims):
            if node_id in z.meta.get("victims", []):
                return z
        return None

    def _match_drain(self, node_id: Optional[str],
                     t: float) -> Optional[Span]:
        if node_id is None:
            return None
        for d in reversed(self._drains):
            if d.meta.get("node") == node_id:
                return d
        # the drain may already have closed this tick (drain_complete is
        # emitted after the migrations) — search closed decisions too
        for s in reversed(self.graph.infra):
            if s.name == "scale_down" and s.meta.get("node") == node_id:
                return s
        return None


class SpanTap:
    """Live tracer hook: quacks like a :class:`~repro_torch.obs.trace.Tracer`,
    feeds every record into a :class:`SpanGraphBuilder`, and forwards to an
    optional delegate tracer (so a run can build spans AND write JSONL).

    ::

        tap = SpanTap(delegate=Tracer(path))
        sim = Simulator(64, cfg, tracer=tap)
        sim.run()
        graph = tap.graph()     # open spans visible mid-run, too
    """

    enabled = True

    def __init__(self, delegate=None):
        from repro_torch.obs.trace import NULL_TRACER
        self.builder = SpanGraphBuilder()
        self.delegate = delegate if delegate is not None else NULL_TRACER

    def emit(self, kind: str, t: float = 0.0, **fields) -> None:
        rec = {"kind": kind, "t": t}
        rec.update(fields)
        self.builder.feed(rec)
        if self.delegate.enabled:
            self.delegate.emit(kind, t, **fields)

    def next_run_id(self) -> int:
        return self.delegate.next_run_id()

    def flush(self) -> None:
        self.delegate.flush()

    def close(self) -> None:
        self.delegate.close()

    def graph(self) -> SpanGraph:
        return self.builder.build()


def build_span_graph(records: Sequence[Dict[str, Any]]) -> SpanGraph:
    """Offline assembly: fold one run's records into a span graph."""
    builder = SpanGraphBuilder()
    for r in records:
        builder.feed(r)
    return builder.build()


def render_chains(graph: SpanGraph, min_len: int = 2) -> str:
    """Human-readable dump of the cause chains (longest first)."""
    chains = []
    for s in graph.all_spans():
        c = graph.chain_of(s)
        if len(c) >= min_len and s.cause is not None:
            chains.append(c)
    # keep only maximal chains (drop chains that are prefixes of longer ones)
    keyed = {tuple(id(s) for s in c): c for c in chains}
    maximal = [c for key, c in keyed.items()
               if not any(k != key and k[:len(key)] == key for k in keyed)]
    maximal.sort(key=len, reverse=True)
    lines = []
    for c in maximal:
        parts = []
        for s in c:
            tag = f"[{s.job}]" if s.job else \
                f"[{s.meta.get('node') or s.meta.get('zone') or ''}]"
            parts.append(f"{s.name}{tag}@{s.t0:.0f}")
        lines.append(" -> ".join(parts))
    return "\n".join(lines) if lines else "(no causal chains)"
