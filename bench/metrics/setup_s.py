"""Host-clock seconds from the process's start to the window's start:
imports, the kernels' build or load, the trainer and its weights, and the
warm-up steps and rescales."""


def read(run):
    return run.setup_s
