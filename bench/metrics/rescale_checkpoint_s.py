"""The port's own ``RescaleTimings.checkpoint`` (device -> host snapshot
through the pack kernel), totalled over the window's host-lane rescales,
per rescale."""


def read(run):
    host = [r for r in run.rescales if r["path"] == "host"]
    if not host:
        return None
    return sum(r["checkpoint"] for r in host) / len(host)
