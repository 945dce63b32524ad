"""device_idle_pct: the share of the traced window in which no device
operation (kernel, copy or fill) runs, from the union of their intervals
in torch.profiler's CUDA timeline.  Nothing when the trace holds no
device operation: a host time never stands in."""
from harness import arith


def read(run):
    ops = run.window_ops()
    if not ops:
        return None
    busy = arith.covered(ops, *run.window_ns) / 1e9
    return 100.0 * (1.0 - busy / run.window_s)
