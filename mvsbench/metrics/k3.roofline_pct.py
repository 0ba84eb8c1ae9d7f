"""K3's share of its roofline: the least time of every K3 launch in the
traced window (the frozen count of `mvsbench.k3_count`, on each launch's
own pixels, candidates and view weights, against the H100 SXM's 67
TFLOP/s float32 and 3.35 TB/s) over K3's device time from the profiler.
Nothing where the window launched no K3."""

UNIT = "%"


def read(rec):
    k3_s = rec.device_s(("K3",))
    return 100.0 * rec.k3_bound_s / k3_s if k3_s > 0 else None
