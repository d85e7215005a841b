"""Host-clock time in ``ElasticTrainer.step()`` over the window's steps,
per step (no rescale time); ``step()`` ends in a device sync."""


def read(run):
    if not run.steps:
        return None
    return sum(s["seconds"] for s in run.steps) / len(run.steps)
