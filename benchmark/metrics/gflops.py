"""gflops: the useful flops of every solve completed in the window over
the whole window (host clock), re-installs between solves included.
The flops are the operation's count (the reference module's `flops`),
whatever the program computes to get there."""
from harness import arith


def read(run):
    if not run.n_solves:
        return None
    return arith.window_rate(run.flops_per_solve, run.n_solves,
                             run.window_s) / 1e9
