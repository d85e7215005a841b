"""Device seconds of the port's ``model.moe.dispatch`` spans (router, top-k,
the sort, positions and slot tables, the gather into slots; and the
gather's backward), every phase, per step of the traced window."""
from bench import program


def read(run):
    return program.s_per_step(run, "model.moe.dispatch")
