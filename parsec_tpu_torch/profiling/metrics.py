"""Histogram records over the native bucket scheme.

Port of the part of parsec_tpu/profiling/metrics.py that the request
scopes (profiling/scope.py) read: the bucket constants and `Hist`, with
its quantile estimator.  The registry, exporter and watchdog are not
ported yet.
"""
from __future__ import annotations

# bucket scheme constants (keep in sync with native/runtime_internal.h)
_SUBBITS = 3
_SUB = 1 << _SUBBITS
_MAX_OCT = 45
_BUCKETS = _SUB + (_MAX_OCT - _SUBBITS) * _SUB

# index == PTC_MET_* kind (native/parsec_core.h)
KIND_NAMES = ("exec", "release", "h2d_stall", "comm_wait", "coll_wait")


def bucket_bounds(idx: int):
    """[lo, hi) nanosecond bounds of histogram bucket `idx`."""
    if idx < _SUB:
        return idx, idx + 1
    o = (idx - _SUB) // _SUB + _SUBBITS
    s = (idx - _SUB) % _SUB
    w = 1 << (o - _SUBBITS)
    lo = (1 << o) + s * w
    return lo, lo + w


class Hist:
    """One aggregated histogram record (kind, optional class name)."""

    __slots__ = ("kind", "mid", "name", "count", "sum_ns", "buckets")

    def __init__(self, kind, mid, name, count, sum_ns, buckets):
        self.kind = int(kind)
        self.mid = int(mid)
        self.name = name
        self.count = int(count)
        self.sum_ns = int(sum_ns)
        self.buckets = buckets  # np.int64[_BUCKETS]

    @property
    def kind_name(self) -> str:
        return KIND_NAMES[self.kind]

    @property
    def mean_ns(self) -> float:
        return self.sum_ns / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Estimated q-quantile in ns (linear interpolation inside the
        12.5%-wide bucket the rank lands in — <=~6% relative error)."""
        if self.count <= 0:
            return 0.0
        rank = q * self.count
        cum = 0
        for idx in range(_BUCKETS):
            c = int(self.buckets[idx])
            if c == 0:
                continue
            if cum + c >= rank:
                lo, hi = bucket_bounds(idx)
                frac = (rank - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        lo, hi = bucket_bounds(_BUCKETS - 1)
        return float(hi)

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum_ns": self.sum_ns,
            "mean_ns": round(self.mean_ns, 1),
            "p50_ns": round(self.quantile(0.50), 1),
            "p90_ns": round(self.quantile(0.90), 1),
            "p99_ns": round(self.quantile(0.99), 1),
        }
