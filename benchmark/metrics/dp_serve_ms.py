"""dp_serve_ms: rank 0's host time serving its device tiles to the
ranks that pull them, the d2h into pinned memory and the handoff to the
comm engine (`CudaDevice.info()["stats"]["dp_serve_ns"]`, the sum of
its DEVICE_DP_SERVE spans) over the window, per solve.  Rank 0's
counters only.  Nothing where the program lacks the counter."""


def read(run):
    ns = run.per_solve("stats.dp_serve_ns")
    return None if ns is None else ns / 1e6
