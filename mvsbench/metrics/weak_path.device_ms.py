"""Device time a view pass of the APD weak path's hand kernels: the
re-score K6, the weak sweep K7, the APD setup's K8, K9 and K10, summed by
kernel name from the profiler. 0 in a pass whose priors hold no WEAK
pixel, which the weak path bypasses."""

from mvsbench.program import WEAK_PATH

UNIT = "ms"


def read(rec):
    return 1e3 * rec.device_s(WEAK_PATH) / rec.steps if rec.steps else None
