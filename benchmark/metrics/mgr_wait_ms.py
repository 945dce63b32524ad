"""mgr_wait_ms: the device manager's time blocked on its queue with no
device task ready (`CudaDevice.stats["mgr_wait_ns"]`: the scheduler's,
the builders' and the releases' time, seen from the card's side) over
the window, per solve.  Nothing where the program lacks the counter."""


def read(run):
    ns = run.per_solve("stats.mgr_wait_ns")
    return None if ns is None else ns / 1e6
