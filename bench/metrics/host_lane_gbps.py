"""The host lane's copy rate over the traced window, in GB/s: the port's
``host_lane.bytes_d2h`` and ``host_lane.bytes_h2d`` counters (the packed
buffers, the restored leaves) over the device seconds of its
``rescale.copy_d2h`` and ``rescale.copy_h2d`` spans."""
from bench import program


def read(run):
    d2h = program.device_s(run, "rescale.copy_d2h")
    h2d = program.device_s(run, "rescale.copy_h2d")
    if d2h is None or h2d is None:
        return None
    c = program.counters(run)
    return (c["host_lane.bytes_d2h"] + c["host_lane.bytes_h2d"]) / (d2h + h2d) / 1e9
