"""gc_pause_ms: the pauses of Python's cyclic collector in the whole
process (`CudaDevice.info()["stats"]["gc_pause_ns"]`), which overlap the
manager's buckets, over the window, per solve.  Nothing where the
program lacks the counter."""


def read(run):
    ns = run.per_solve("stats.gc_pause_ns")
    return None if ns is None else ns / 1e6
