"""Mean host-clock time of the window's ``ElasticTrainer.rescale()`` calls,
from the call to its return: every stage, and the free of the host
snapshot when the call's frame goes."""


def read(run):
    if not run.rescales:
        return None
    return sum(r["seconds"] for r in run.rescales) / len(run.rescales)
