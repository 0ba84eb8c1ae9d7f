"""Kernel launches a view pass: every kernel the profiler saw in the
traced window, the hand kernels' launches held equal to the port's own
counters before any metric is read."""

UNIT = "launches"


def read(rec):
    return len(rec.kernels) / rec.steps if rec.steps else None
