"""dag_build_ms: the median over solves of the benchmark's span around
the DAG's construction: the builder call of a PTG path, the whole
insert loop of a DTD path (whose tasks start running meanwhile)."""
import statistics


def read(run):
    if not run.n_solves:
        return None
    return statistics.median(s["build"] for s in run.solves) * 1e3
