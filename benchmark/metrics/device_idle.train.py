"""The share of the traced window in which no kernel, copy or fill ran on
the device (the holes in the union of the device intervals)."""

UNIT = "%"


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
