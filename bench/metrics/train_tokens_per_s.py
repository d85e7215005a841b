"""Trained tokens (labels >= 0) of every step in the window, over the
window's whole wall time to the end of its last unit, rescale stalls
included (host clock)."""


def read(run):
    if not run.steps:
        return None
    return sum(s["tokens"] for s in run.steps) / run.window_s
