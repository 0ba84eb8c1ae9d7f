"""Device time a view pass of every kernel not built from the port's
`csrc/`: the torch ops left around the hand kernels (copies, the median
filter, confidence, the plane conversions, the draws)."""

UNIT = "ms"


def read(rec):
    return 1e3 * rec.torch_s() / rec.steps if rec.steps else None
