"""``torch.cuda.max_memory_allocated()`` over the window (reset at its
start), in GB: what one job holds of the card, which decides how many jobs
the operator keeps resident on it."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
