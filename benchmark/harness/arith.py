"""The benchmark's arithmetic: rates, spreads and device timelines.

Plain Python on lists of numbers, so that the tests can hold it to
hand-worked cases.  Nothing here names a cell, a configuration or a
metric.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def window_rate(work_per_item: float, items: int, window_s: float) -> float:
    """Work of every item completed in the window over the whole window
    (re-installs and host gaps between items included)."""
    if window_s <= 0:
        raise ValueError("empty window")
    return work_per_item * items / window_s


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The disjoint, sorted union of (start, end) intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Iterable[Interval], t0: float, t1: float
         ) -> List[Interval]:
    """The parts of the intervals inside [t0, t1]."""
    out = []
    for a, b in intervals:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            out.append((a, b))
    return out


def covered(intervals: Iterable[Interval], t0: float, t1: float) -> float:
    """Length of [t0, t1] that the union of the intervals covers."""
    return sum(b - a for a, b in union(clip(intervals, t0, t1)))


def gaps(intervals: Iterable[Interval], t0: float, t1: float
         ) -> List[Interval]:
    """The stretches of [t0, t1] that no interval covers, in time
    order."""
    out, at = [], t0
    for a, b in union(clip(intervals, t0, t1)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if t1 > at:
        out.append((at, t1))
    return out


def label_at(spans: Sequence[Tuple[str, float, float]], t: float
             ) -> Optional[str]:
    """The name of the span (name, start, end) open at time t, or None;
    spans do not nest."""
    for name, a, b in spans:
        if a <= t < b:
            return name
    return None


def quartile_spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, with the quartiles of
    statistics.quantiles(values, n=4): the spread a bound is set
    from."""
    import statistics
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
