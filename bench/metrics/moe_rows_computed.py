"""The share, in %, of the MoE layers' expert slots that the experts'
products compute over the traced window: the port's ``moe.rows`` counter
(each expert's kept rows rounded up to the ragged kernel's row tile, or
every slot where the products run over the whole slot layout) over its
``moe.slots``, both counted in the forward phase.  Silent where the port
counts no ``moe.rows``."""
from bench import program


def read(run):
    counters = program.counters(run)
    if not counters.get("moe.slots") or "moe.rows" not in counters:
        return None
    return 100.0 * counters["moe.rows"] / counters["moe.slots"]
