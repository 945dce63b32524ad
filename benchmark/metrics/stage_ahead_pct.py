"""stage_ahead_pct: the share of the bytes staged from the host over the
window that reached the card before the task reading them was
dispatched: 100 x (1 - `stats["h2d_dispatch_bytes"]` /
`stats["h2d_bytes"]`), the rest staged at dispatch (the prefetch lane's
misses).  Nothing where nothing was staged from the host, or where the
program lacks the counter."""


def read(run):
    total = run.counters.get("stats.h2d_bytes")
    at_dispatch = run.counters.get("stats.h2d_dispatch_bytes")
    if not total or at_dispatch is None:
        return None
    return 100.0 * (1.0 - at_dispatch / total)
