"""Device time a view pass of the strong path's hand kernels: the initial
cost's K2, the strong sweep's K3, the classify and refine stages' K5, and
K11 and K1 where a route launches them, summed by kernel name from the
profiler."""

from mvsbench.program import STRONG_PATH

UNIT = "ms"


def read(rec):
    return 1e3 * rec.device_s(STRONG_PATH) / rec.steps if rec.steps else None
