"""Text Gantt renderer over a flight-recorder trace.

Copy of ``repro.obs.timeline`` (framework-free).

One row per job (``#`` running, ``.`` queued, ``*`` a rescale, ``x`` a
preempt, ``>`` a migration), plus a capacity row (provisioned slots, scaled
0-9) and a kill row (``K`` spot kill, ``Z`` zone reclaim).  ``chip_smoke.py``
renders the live operator's and the simulator's runs on the card with it.

The renderer needs nothing but a list of loaded records (one run); pair it
with :func:`repro_torch.obs.audit.split_runs` for multi-run files.
"""
from __future__ import annotations

from typing import Any, Dict, List

from repro_torch.obs.audit import split_runs

_RUN, _QUEUE, _IDLE = "#", ".", " "


def _bucket(t: float, t0: float, dt: float, width: int) -> int:
    return max(0, min(width - 1, int((t - t0) / dt)))


def render(records: List[Dict[str, Any]], *, width: int = 72,
           max_jobs: int = 40) -> str:
    """Render ONE run's records as a text Gantt chart."""
    job_recs = [r for r in records
                if r.get("kind", "").startswith("job_") and "job" in r]
    if not job_recs:
        return "(no job records in trace)"
    t0 = min(r["t"] for r in job_recs)
    t1 = max(r["t"] for r in records if "t" in r)
    dt = max((t1 - t0) / width, 1e-9)

    # per-job state transitions -> row of state chars, then event markers
    jobs: List[str] = []
    seen = set()
    for r in job_recs:
        if r["job"] not in seen:
            seen.add(r["job"])
            jobs.append(r["job"])
    rows: Dict[str, List[str]] = {j: [_IDLE] * width for j in jobs}
    state: Dict[str, str] = {j: _IDLE for j in jobs}
    cursor: Dict[str, int] = {j: 0 for j in jobs}

    def advance(job: str, upto: int) -> None:
        row, c = rows[job], cursor[job]
        for i in range(c, min(upto, width)):
            row[i] = state[job]
        cursor[job] = max(c, upto)

    marks: Dict[str, Dict[int, str]] = {j: {} for j in jobs}
    for r in job_recs:
        job, kind = r["job"], r["kind"]
        b = _bucket(r["t"], t0, dt, width)
        advance(job, b)
        if kind in ("job_submit", "job_queue"):
            state[job] = _QUEUE
        elif kind == "job_start":
            state[job] = _RUN
        elif kind == "job_rescale":
            marks[job][b] = "*"
        elif kind == "job_migrate":
            marks[job][b] = ">"
        elif kind in ("job_preempt", "job_fail"):
            state[job] = _QUEUE
            marks[job][b] = "x"
        elif kind == "job_complete":
            state[job] = _IDLE
    for job in jobs:
        advance(job, width)
        for b, ch in marks[job].items():
            rows[job][b] = ch

    # capacity row: base slots + node_up/cordon/kill/removal deltas
    base = next((r.get("slots", 0) for r in records
                 if r.get("kind") == "run_start"), 0)
    cap_events: List[tuple] = []
    node_slots: Dict[str, int] = {}
    for r in records:
        kind = r.get("kind", "")
        if kind == "node_up":
            node_slots[r["node"]] = r.get("slots", 0)
            cap_events.append((r["t"], r.get("slots", 0)))
        elif kind in ("node_cordon", "spot_kill"):
            if not r.get("was_cordoned"):
                s = r.get("slots", node_slots.get(r["node"], 0))
                cap_events.append((r["t"], -s))
        elif kind == "node_uncordon":
            s = r.get("slots", node_slots.get(r["node"], 0))
            cap_events.append((r["t"], s))
    cap_row, kill_row = [" "] * width, [" "] * width
    if cap_events or base:
        cap = base
        caps = [base] * width
        for t, delta in sorted(cap_events, key=lambda e: e[0]):
            cap += delta
            b = _bucket(t, t0, dt, width)
            for i in range(b, width):
                caps[i] = cap
        peak = max(max(caps), 1)
        cap_row = [str(min(9, (9 * c) // peak)) for c in caps]
    for r in records:
        if r.get("kind") == "spot_kill":
            kill_row[_bucket(r["t"], t0, dt, width)] = "K"
        elif r.get("kind") == "zone_reclaim":
            kill_row[_bucket(r["t"], t0, dt, width)] = "Z"

    label_w = max([len(j) for j in jobs[:max_jobs]] + [8])
    label_w = min(label_w, 20)
    out = [f"timeline t0={t0:.1f}s t1={t1:.1f}s "
           f"({dt:.1f}s/col, {len(jobs)} jobs)"
           f"  [#=run .=queue *=rescale >=migrate x=preempt]"]
    for job in jobs[:max_jobs]:
        out.append(f"{job[:label_w]:>{label_w}} |{''.join(rows[job])}|")
    if len(jobs) > max_jobs:
        out.append(f"{'...':>{label_w}} |({len(jobs) - max_jobs} more jobs)")
    out.append(f"{'capacity':>{label_w}} |{''.join(cap_row)}|")
    if any(c != " " for c in kill_row):
        out.append(f"{'kills':>{label_w}} |{''.join(kill_row)}|")
    return "\n".join(out)


def render_last_run(records: List[Dict[str, Any]], **kw) -> str:
    """Render the last complete run in a (possibly multi-run) stream."""
    runs = split_runs(records)
    if not runs:
        return "(no runs in trace)"
    return render(runs[-1], **kw)
