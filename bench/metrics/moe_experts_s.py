"""Device seconds of the port's ``model.moe.experts`` spans (the experts'
batched products, in the forward and the recompute), per step of the
traced window."""
from bench import program


def read(run):
    return program.s_per_step(run, "model.moe.experts")
