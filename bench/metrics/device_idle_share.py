"""The traced window's share, in %, in which no kernel, copy or set ran on
the card: 1 - the union of the device intervals over the window's wall
time."""


def read(run):
    tr = run.trace
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
