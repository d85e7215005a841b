"""The share, in %, of the MoE layers' expert slots that hold a token over
the traced window: the port's ``moe.kept`` counter (assignments under
capacity) over its ``moe.slots`` (experts x sequences x capacity), both
counted in the forward phase."""
from bench import program


def read(run):
    counters = program.counters(run)
    if not counters.get("moe.slots"):
        return None
    return 100.0 * counters["moe.kept"] / counters["moe.slots"]
