"""Device seconds of the port's ``model.moe.combine`` spans (each token's
slots, weighted and summed; and its backward), every phase, per step of
the traced window."""
from bench import program


def read(run):
    return program.s_per_step(run, "model.moe.combine")
