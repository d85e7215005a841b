"""Device seconds of the port's ``model.layer`` spans in phase
``recompute`` (each layer's forward run again by its checkpoint inside the
backward), per step of the traced window."""
from bench import program


def read(run):
    return program.s_per_step(run, "model.layer", "recompute")
