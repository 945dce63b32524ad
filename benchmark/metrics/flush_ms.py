"""flush_ms: the device's write-back of its dirty mirrors to the host
at the end of each solve (`CudaDevice.stats["flush_ns"]`, the sum of
its DEVICE_FLUSH spans) over the window, per solve: the caller's wait
for the factor to reach the host tiles.  Nothing where the program
lacks the counter."""


def read(run):
    ns = run.per_solve("stats.flush_ns")
    return None if ns is None else ns / 1e6
