"""The share of the traced window in which no operation of the pass ran
on the device (the union of its kernels, copies and sets from the
profiler's timeline)."""

UNIT = "%"


def read(rec):
    if rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
