"""comm_mb_per_solve: the bytes rank 0's comm engine received from the
other ranks (`CudaDevice.info()["stats"]["comm_bytes_recv"]`, the
engine's `ctx.comm_stats()["bytes_recv"]`: the tiles' payloads and the
frames around them) over the window, per solve, in MB (10^6 bytes).
Rank 0's counters only.  Nothing where the program lacks the counter."""


def read(run):
    b = run.per_solve("stats.comm_bytes_recv")
    return None if b is None else b / 1e6
