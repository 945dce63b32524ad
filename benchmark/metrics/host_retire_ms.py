"""host_retire_ms: the median over solves of the benchmark's span from
`tp.run()` (DTD: the last insert) to `wait()` returning, when the host
has dispatched and retired every task."""
import statistics


def read(run):
    if not run.n_solves:
        return None
    return statistics.median(s["run_wait"] for s in run.solves) * 1e3
