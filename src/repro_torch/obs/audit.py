"""Trace auditor: re-derive conservation invariants from the JSONL alone.

Copy of ``repro.obs.audit`` (framework-free): it reads the records of the
port's simulator and live operator, and the JAX package's, unchanged.

The flight recorder becomes a sanitizer: given nothing but the trace, replay
it through a slot/dollar ledger and check that the run could not have
violated physics.  Invariants (per run, a ``run_start`` .. ``run_end`` span):

- **slot_ownership** — a job's held slots follow its lifecycle records
  exactly (start sets, rescale moves ``from -> to``, preempt/complete/fail
  clear); total held slots never exceed the *physical* capacity (active +
  cordoned nodes), and outside kill-blast / drain windows never exceed the
  *active* capacity either.  Kill blasts are bracketed by ``spot_kill`` ..
  ``kill_blast_end`` records (and ``zone_reclaim`` .. ``zone_reclaim_end``
  for correlated batches): inside the bracket victims may transiently
  overcommit the dying node (checkpoint writes advance the clock before
  eviction lands), which is exactly the window the simulator itself allows.
- **dollar_conservation** — ``run_end.total_cost`` equals the re-derived
  capacity integral (each node's ``slots x $/slot-hour`` over its billed
  ``node_up`` .. billing-end interval) plus the itemized ``cost_transfer``
  records; ``run_end.transfer_cost`` and ``run_end.preempt_overhead_cost``
  equal their itemized sums.
- **preempt_resume** — every ``job_preempt`` is matched by a later resume
  (``job_start`` with ``resume: true``) or accounted a drop
  (``run_end.dropped``); a preempted job never completes without resuming.
- **blast_integrity** — every resident captured in a ``spot_kill`` record is
  resolved (migrated / shrunk / preempted / failed) before the matching
  ``kill_blast_end``.
- **lifecycle** — submit/complete/drop counts reconcile with ``run_end``.
- **phase_reconciliation** — the :mod:`repro_torch.obs.critical_path`
  decomposition of every completed job sums to its observed makespan
  (complete.t - submit.t) to <0.1%: the phase attribution is a PARTITION of
  response time, not an estimate.

CLI::

    PYTHONPATH=src python -m repro_torch.obs.audit trace1.jsonl [trace2.jsonl ...]

prints one PASS/FAIL line per run per file and exits non-zero on any FAIL.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.obs.trace import Tracer

#: records that prove a kill-blast victim was dealt with
_RESOLUTIONS = ("job_migrate", "job_rescale", "job_preempt", "job_fail",
                "job_complete")


@dataclass
class AuditReport:
    source: str = ""
    run: int = 0
    checks: Dict[str, bool] = field(default_factory=dict)
    violations: List[str] = field(default_factory=list)
    counts: Dict[str, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        status = "PASS" if self.ok else "FAIL"
        checks = " ".join(f"{k}={'ok' if v else 'VIOLATED'}"
                          for k, v in sorted(self.checks.items()))
        line = (f"[{status}] {self.source} run={self.run} "
                f"records={self.counts.get('records', 0)} {checks}")
        for v in self.violations[:8]:
            line += f"\n    - {v}"
        if len(self.violations) > 8:
            line += f"\n    ... {len(self.violations) - 8} more"
        return line


def split_runs(records: List[Dict[str, Any]]) -> List[List[Dict[str, Any]]]:
    """Split a (possibly multi-run) stream on ``run_start`` boundaries."""
    runs: List[List[Dict[str, Any]]] = []
    cur: Optional[List[Dict[str, Any]]] = None
    for r in records:
        if r.get("kind") == "run_start":
            if cur is not None:
                runs.append(cur)
            cur = [r]
        elif cur is not None:
            cur.append(r)
    if cur is not None:
        runs.append(cur)
    return runs


class _RunAuditor:
    """Replays one run's records through a slot/dollar ledger."""

    def __init__(self, records: List[Dict[str, Any]], source: str = ""):
        self.records = records
        self.rep = AuditReport(source=source)
        # slot ledger
        self.base_slots = 0
        self.held: Dict[str, int] = {}           # job -> slots
        self.active: Dict[str, int] = {}         # node -> slots
        self.cordoned: Dict[str, int] = {}
        self.blast_depth = 0                     # open kill/zone windows
        self.blasts: Dict[str, set] = {}         # killed node -> unresolved
        # dollar ledger
        self.node_rate: Dict[str, float] = {}    # node -> $/s while billed
        self.bill_from: Dict[str, float] = {}    # node -> billing start
        self.capacity_dollars = 0.0
        self.transfer_dollars = 0.0
        self.overhead_dollars = 0.0
        # lifecycle
        self.submitted: set = set()
        self.completed: set = set()
        self.open_preempts: set = set()
        self.resumes = 0
        self.preempts = 0

    # -- helpers -------------------------------------------------------------
    def fail(self, check: str, msg: str) -> None:
        self.rep.checks[check] = False
        self.rep.violations.append(f"{check}: {msg}")

    def _check_capacity(self, t: float, what: str) -> None:
        used = sum(self.held.values())
        physical = self.base_slots + sum(self.active.values()) \
            + sum(self.cordoned.values())
        if used > physical:
            self.fail("slot_ownership",
                      f"t={t:.1f} {what}: {used} slots held > "
                      f"{physical} physical (double-booked)")
        elif (self.blast_depth == 0 and not self.cordoned
                and used > self.base_slots + sum(self.active.values())):
            self.fail("slot_ownership",
                      f"t={t:.1f} {what}: {used} held > active capacity "
                      f"outside any blast/drain window")

    def _set_held(self, t: float, job: str, slots: int, expect: Optional[int],
                  what: str) -> None:
        if expect is not None and self.held.get(job, 0) != expect:
            self.fail("slot_ownership",
                      f"t={t:.1f} {what} {job}: record says {expect} held "
                      f"but ledger has {self.held.get(job, 0)}")
        self.held[job] = slots
        self._check_capacity(t, what)

    def _end_billing(self, t: float, node: str) -> None:
        rate = self.node_rate.pop(node, None)
        start = self.bill_from.pop(node, None)
        if rate is not None and start is not None:
            self.capacity_dollars += rate * max(0.0, t - start)

    def _resolve_victim(self, job: str) -> None:
        for jobs in self.blasts.values():
            jobs.discard(job)

    # -- main ----------------------------------------------------------------
    def run(self) -> AuditReport:
        rep = self.rep
        for check in ("slot_ownership", "dollar_conservation",
                      "preempt_resume", "blast_integrity", "lifecycle",
                      "phase_reconciliation"):
            rep.checks.setdefault(check, True)
        rep.counts["records"] = len(self.records)
        saw_end = False
        for r in self.records:
            kind, t = r.get("kind"), r.get("t", 0.0)
            if kind == "run_start":
                rep.run = r.get("run", 0)
                self.base_slots = int(r.get("slots", 0))
            elif kind == "job_submit":
                self.submitted.add(r["job"])
            elif kind == "job_queue":
                pass
            elif kind == "job_start":
                job = r["job"]
                if r.get("resume"):
                    self.resumes += 1
                self.open_preempts.discard(job)
                self._set_held(t, job, int(r["slots"]), 0, "job_start")
                self._resolve_victim(job)
            elif kind == "job_rescale":
                job = r["job"]
                self._set_held(t, job, int(r["to"]), int(r["from"]),
                               "job_rescale")
                self._resolve_victim(job)
            elif kind == "job_preempt":
                job = r["job"]
                self.preempts += 1
                self.open_preempts.add(job)
                self._set_held(t, job, 0, int(r["slots"]), "job_preempt")
                self._resolve_victim(job)
            elif kind == "job_fail":
                job = r["job"]
                self._set_held(t, job, 0, int(r["slots"]), "job_fail")
                self._resolve_victim(job)
            elif kind == "job_migrate":
                self._resolve_victim(r["job"])
            elif kind == "job_complete":
                job = r["job"]
                if job in self.open_preempts:
                    self.fail("preempt_resume",
                              f"t={t:.1f} {job} completed while preempted "
                              f"(no resume)")
                self._set_held(t, job, 0, int(r["slots"]), "job_complete")
                self.completed.add(job)
                self._resolve_victim(job)
            elif kind == "node_up":
                node = r["node"]
                self.active[node] = int(r["slots"])
                rate = (r.get("slots", 0)
                        * r.get("price_per_slot_hour", 0.0) / 3600.0)
                self.node_rate[node] = rate
                self.bill_from[node] = t
            elif kind == "node_cordon":
                # nodes carved out of run_start.slots (the live operator's
                # fixed pool) were never node_up'd: open the drain window
                # (cordoned non-empty) without inventing capacity
                node = r["node"]
                self.cordoned[node] = self.active.pop(node, 0)
            elif kind == "node_uncordon":
                node = r["node"]
                slots = self.cordoned.pop(node, 0)
                if slots:
                    self.active[node] = slots
            elif kind == "node_removed":
                node = r["node"]
                self.active.pop(node, None)
                self.cordoned.pop(node, None)
                self._check_capacity(t, "node_removed")
            elif kind == "spot_kill":
                node = r["node"]
                if not r.get("was_cordoned"):
                    self.cordoned[node] = self.active.pop(
                        node, r.get("slots", 0))
                self.blast_depth += 1
                self.blasts[node] = set(r.get("residents", {}))
                self._end_billing(t, node)
            elif kind == "kill_blast_end":
                node = r["node"]
                self.blast_depth -= 1
                self.cordoned.pop(node, None)
                self.active.pop(node, None)
                unresolved = self.blasts.pop(node, set())
                if unresolved:
                    self.fail("blast_integrity",
                              f"t={t:.1f} kill of {node}: victims "
                              f"{sorted(unresolved)} have no "
                              f"migrate/rescale/preempt span")
                self._check_capacity(t, "kill_blast_end")
            elif kind == "node_billing_end":
                self._end_billing(t, r["node"])
            elif kind == "zone_reclaim":
                self.blast_depth += 1
            elif kind == "zone_reclaim_end":
                self.blast_depth -= 1
            elif kind == "cost_transfer":
                self.transfer_dollars += float(r.get("dollars", 0.0))
            elif kind == "cost_preempt_overhead":
                self.overhead_dollars += float(r.get("dollars", 0.0))
            elif kind == "decision":
                rep.counts["decisions"] = rep.counts.get("decisions", 0) + 1
            elif kind == "run_end":
                saw_end = True
                self._finish(r, t)
        if not saw_end:
            self.fail("lifecycle", "no run_end record (truncated trace)")
        # phase decomposition must partition every completed job's makespan
        # (audit imports critical_path; critical_path never imports audit)
        from repro_torch.obs.critical_path import reconcile
        for msg in reconcile(self.records, rel_tol=1e-3):
            self.fail("phase_reconciliation", msg)
        rep.counts.update(
            submits=len(self.submitted), completes=len(self.completed),
            preempts=self.preempts, resumes=self.resumes)
        return rep

    def _finish(self, r: Dict[str, Any], t: float) -> None:
        # close out nodes still billing at the end of the run
        for node in list(self.node_rate):
            self._end_billing(t, node)
        expect_total = self.capacity_dollars + self.transfer_dollars
        total = float(r.get("total_cost", 0.0))
        if not math.isclose(total, expect_total,
                            rel_tol=1e-6, abs_tol=1e-6):
            self.fail("dollar_conservation",
                      f"run_end.total_cost={total:.6f} but node intervals + "
                      f"transfers re-derive {expect_total:.6f}")
        xfer = float(r.get("transfer_cost", 0.0))
        if not math.isclose(xfer, self.transfer_dollars,
                            rel_tol=1e-6, abs_tol=1e-9):
            self.fail("dollar_conservation",
                      f"run_end.transfer_cost={xfer:.6f} != itemized "
                      f"{self.transfer_dollars:.6f}")
        ovh = float(r.get("preempt_overhead_cost", 0.0))
        if not math.isclose(ovh, self.overhead_dollars,
                            rel_tol=1e-6, abs_tol=1e-9):
            self.fail("dollar_conservation",
                      f"run_end.preempt_overhead_cost={ovh:.6f} != itemized "
                      f"{self.overhead_dollars:.6f}")
        dropped = int(r.get("dropped", 0))
        if len(self.submitted) - len(self.completed) != dropped:
            self.fail("lifecycle",
                      f"{len(self.submitted)} submits - "
                      f"{len(self.completed)} completes != "
                      f"run_end.dropped={dropped}")
        # every preempt is matched by a resume or accounted a drop
        if len(self.open_preempts) > dropped:
            self.fail("preempt_resume",
                      f"{len(self.open_preempts)} preempted jobs never "
                      f"resumed but only {dropped} dropped")
        leaked = {j: s for j, s in self.held.items() if s}
        if leaked:
            self.fail("slot_ownership",
                      f"slots still held at run_end: {leaked}")


def audit_records(records: List[Dict[str, Any]],
                  source: str = "<records>") -> List[AuditReport]:
    """Audit every run in a loaded record stream."""
    return [_RunAuditor(run, source).run() for run in split_runs(records)]


def audit_file(path: str) -> List[AuditReport]:
    return audit_records(Tracer.load(path), source=path)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Replay trace JSONL files through the conservation "
                    "invariant auditor.")
    ap.add_argument("paths", nargs="+", help="trace .jsonl files")
    args = ap.parse_args(argv)
    failed = 0
    for path in args.paths:
        reports = audit_file(path)
        if not reports:
            print(f"[FAIL] {path}: no runs found")
            failed += 1
            continue
        for rep in reports:
            print(rep.summary())
            if not rep.ok:
                failed += 1
    print(f"obs-audit: {'FAIL' if failed else 'PASS'} "
          f"({failed} failing run(s))")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
