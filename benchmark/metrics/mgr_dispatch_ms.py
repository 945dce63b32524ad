"""mgr_dispatch_ms: the device manager's time inside its DEVICE_DISPATCH
spans, staging and the asynchronous enqueue
(`CudaDevice.stats["mgr_dispatch_ns"]`) over the window, per solve.
Nothing where the program lacks the counter."""


def read(run):
    ns = run.per_solve("stats.mgr_dispatch_ns")
    return None if ns is None else ns / 1e6
