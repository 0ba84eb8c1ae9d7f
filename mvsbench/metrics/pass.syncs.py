"""Synchronising CUDA calls a view pass in the traced window, counted by
the warnings of `torch.cuda.set_sync_debug_mode("warn")` (the pass's own
reads to the host and its copies of the maps at its end)."""

UNIT = "calls"


def read(rec):
    return rec.syncs / rec.steps if rec.steps else None
