"""Device seconds of the port's ``trainer.optimizer`` span (AdamW's update
and the clearing of the gradients), per step of the traced window."""
from bench import program


def read(run):
    return program.s_per_step(run, "trainer.optimizer")
