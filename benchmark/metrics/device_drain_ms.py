"""device_drain_ms: the median over solves of the benchmark's span from
`wait()` returning to the exec stream's synchronize: the device's
backlog once the host is done."""
import statistics


def read(run):
    if not run.n_solves:
        return None
    return statistics.median(s["drain"] for s in run.solves) * 1e3
