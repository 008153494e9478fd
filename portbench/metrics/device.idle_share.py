"""device.idle_share (device, %): 1 - the union of the device's busy
intervals over the traced window."""


def read(r):
    if r.trace is None or r.trace.window <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy / r.trace.window)
