"""mgr_complete_ms: the device manager's time completing device tasks, the
native release of their dependencies and the completions from parked
results included (`CudaDevice.stats["mgr_complete_ns"]`) over the
window, per solve.  Nothing where the program lacks the counter."""


def read(run):
    ns = run.per_solve("stats.mgr_complete_ns")
    return None if ns is None else ns / 1e6
