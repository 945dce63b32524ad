"""mgr_plan_ms: the device manager's time grouping the batches it pops and
in the wave compiler's planning before a launch
(`CudaDevice.stats["mgr_plan_ns"]`) over the window, per solve.  Nothing
where the program lacks the counter."""


def read(run):
    ns = run.per_solve("stats.mgr_plan_ns")
    return None if ns is None else ns / 1e6
