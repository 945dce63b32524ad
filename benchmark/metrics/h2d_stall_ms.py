"""h2d_stall_ms: the device manager's dispatch-time host-to-device stall
(`CudaDevice.stats["h2d_stall_ns"]`, measured by the manager at its
waits) over the window, per solve."""


def read(run):
    ns = run.per_solve("stats.h2d_stall_ns")
    return None if ns is None else ns / 1e6
