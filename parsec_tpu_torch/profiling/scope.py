"""Request-scoped observability: per-request lifecycles and per-tenant
SLO metrics.

Port of parsec_tpu/profiling/scope.py (ScopeRegistry).  One registry per
Context allocates request-scope ids (stamped into taskpools beside the
QoS stamp), tracks each request's lifecycle (submit -> admitted -> first
token -> done), folds per-tenant SLO histograms (TTFT, queue wait,
admission-to-done latency, tokens/s) and reject counters, and keeps
each retired pool's QoS counters and measured wall on its scope.  Exported through
Context.stats()["scope"].

Not ported yet: the plan-vs-measured folds of conformance (plans wait
for the analysis layer, so every pool retires unplanned and the rollup
counts them), the trace-based request timeline (it reads the trace
module's spans; the legend take_trace stamps is here), the fleet and
journal exports (the black box) and the controller hook.

Clock note: request timestamps read the NATIVE ptc_now_ns clock
(ptc_clock_ns), the clock trace events are stamped with.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from .. import _native as N
from .metrics import _BUCKETS, Hist

__all__ = ["ScopeRegistry", "ScopeHist"]


# ------------------------------------------------------------ histogram
def _bucket_of(v: int) -> int:
    """Python mirror of the native log2/3-sub-bit bucket index
    (runtime_internal.h ptc_met_bucket) — tenant histograms quantize
    exactly like the native per-class ones, so quantiles compare."""
    _SUB, _SUBBITS, _MAX_OCT = 8, 3, 45
    if v < _SUB:
        return 0 if v < 0 else int(v)
    oct_ = int(v).bit_length() - 1
    if oct_ >= _MAX_OCT:
        return _BUCKETS - 1
    sub = (int(v) >> (oct_ - _SUBBITS)) & (_SUB - 1)
    return _SUB + (oct_ - _SUBBITS) * _SUB + sub


class ScopeHist:
    """Small single-writer histogram over the native bucket scheme.
    Values are any positive integers (ns for latencies, integer
    tokens/s for rates); quantiles ride metrics.Hist's estimator."""

    __slots__ = ("count", "sum", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0
        self.buckets = np.zeros(_BUCKETS, dtype=np.int64)

    def record(self, v) -> None:
        v = int(v)
        self.count += 1
        if v > 0:
            self.sum += v
        self.buckets[_bucket_of(v)] += 1

    def quantile(self, q: float) -> float:
        return Hist(0, -1, None, self.count, self.sum,
                    self.buckets).quantile(q)

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "p50": round(self.quantile(0.50), 1),
                "p99": round(self.quantile(0.99), 1)}


# -------------------------------------------------------------- records
class _Request:
    __slots__ = ("scope_id", "tenant", "kind", "rid", "meta", "state",
                 "submitted_ns", "admitted_ns", "first_token_ns",
                 "done_ns", "tokens", "pools", "qos", "measured",
                 "class_names")

    def __init__(self, scope_id, tenant, kind, rid, meta):
        self.scope_id = scope_id
        self.tenant = tenant
        self.kind = kind
        self.rid = rid
        self.meta = meta
        self.state = "submitted"
        self.submitted_ns: Optional[int] = None
        self.admitted_ns: Optional[int] = None
        self.first_token_ns: Optional[int] = None
        self.done_ns: Optional[int] = None
        self.tokens = 0
        self.pools: List[int] = []          # native tp ids stamped
        self.class_names: List[str] = []     # class id -> name (per pool)
        self.qos: Optional[dict] = None      # last pool's QoS counters
        self.measured: Optional[dict] = None


class _Tenant:
    __slots__ = ("slo_ms", "burn_threshold", "window", "counters",
                 "hists")

    def __init__(self, slo_ms=None, burn_threshold=0.5, window_n=128):
        self.slo_ms = slo_ms
        self.burn_threshold = float(burn_threshold)
        # sliding outcome window: True = SLO violated
        self.window: deque = deque(maxlen=int(window_n))
        self.counters = {"submitted": 0, "completed": 0, "failed": 0,
                         "rejected": 0, "slo_violations": 0,
                         "prefix_hits": 0, "prefix_misses": 0,
                         "spec_proposed": 0, "spec_accepted": 0}
        self.hists = {"ttft_ns": ScopeHist(), "queue_wait_ns": ScopeHist(),
                      "latency_ns": ScopeHist(), "tokens_per_s": ScopeHist(),
                      # per-verify-wave draft acceptance, in whole percent
                      # (0..100) of proposed tokens
                      "spec_accept_pct": ScopeHist()}


def _now_ns() -> int:
    """The NATIVE trace clock (ptc_now_ns), not time.monotonic_ns:
    request windows must align with trace span timestamps exactly."""
    return int(N.lib.ptc_clock_ns())


# ------------------------------------------------------------- registry
class ScopeRegistry:
    """Per-context request-scope bookkeeping (see module docstring).
    Thread-safe: the serve pump, submitter threads, the engine's step
    loop and stats readers all touch it concurrently."""

    def __init__(self, ctx, slo_window: int = 128):
        self.ctx = ctx
        self._lock = threading.Lock()
        self._next = 1
        self.slo_window = int(slo_window)
        self.requests: Dict[int, _Request] = {}
        self.tenants: Dict[str, _Tenant] = {}
        self._by_rid: Dict[object, int] = {}
        self._pools_done = 0  # retired pools (all unplanned)
        # structured decision log: bounded ring
        self._events: deque = deque(maxlen=1024)

    # -------------------------------------------------------- lifecycle
    def tenant(self, name: str, slo_ms=None, burn_threshold=None,
               ) -> _Tenant:
        """Get-or-create a tenant rollup; keyword args update config."""
        with self._lock:
            t = self.tenants.get(name)
            if t is None:
                t = self.tenants[name] = _Tenant(
                    window_n=self.slo_window)
            if slo_ms is not None:
                t.slo_ms = float(slo_ms)
            if burn_threshold is not None:
                t.burn_threshold = float(burn_threshold)
            return t

    def new_scope(self, tenant: str = "default", kind: str = "request",
                  rid=None, meta=None) -> int:
        """Allocate a scope id (sequential from 1).  A `kind` other than
        "request" marks a shared pool's scope (one continuous-batching
        decode step), which feeds no request counter."""
        self.tenant(tenant)
        with self._lock:
            sid = self._next
            self._next += 1
            r = _Request(sid, tenant, kind, rid, meta)
            r.submitted_ns = _now_ns()
            self.requests[sid] = r
            if rid is not None and kind == "request":
                self._by_rid[rid] = sid
            if kind == "request":
                self.tenants[tenant].counters["submitted"] += 1
        return sid

    def stamp(self, tp, scope_id: int) -> None:
        """Stamp a taskpool with the scope (native ptc_tp_set_scope,
        beside the QoS stamp) and remember the pool id and its class
        names (trace class ids are per pool)."""
        tp.set_scope(scope_id)
        with self._lock:
            r = self.requests.get(scope_id)
            if r is not None:
                r.pools.append(tp.tp_id)
                r.class_names = [tc.name for tc in tp.classes]

    def record_admitted(self, scope_id: int, t_ns: Optional[int] = None):
        with self._lock:
            r = self.requests.get(scope_id)
            if r is not None:
                r.admitted_ns = t_ns if t_ns is not None else _now_ns()
                r.state = "running"

    def record_first_token(self, scope_id: int,
                           t_ns: Optional[int] = None):
        """TTFT boundary (the engine calls this when a request's
        prefill produces its first output token)."""
        with self._lock:
            r = self.requests.get(scope_id)
            if r is None or r.first_token_ns is not None:
                return
            r.first_token_ns = t_ns if t_ns is not None else _now_ns()
            if r.submitted_ns is not None:
                self.tenants[r.tenant].hists["ttft_ns"].record(
                    r.first_token_ns - r.submitted_ns)

    def record_rejected(self, scope_id: int):
        with self._lock:
            r = self.requests.get(scope_id)
            if r is None:
                return
            r.state = "rejected"
            r.done_ns = _now_ns()
            self.tenants[r.tenant].counters["rejected"] += 1

    def record_pool_done(self, scope_id: int, qos: Optional[dict] = None,
                         measured: Optional[dict] = None):
        """One POOL retired under this scope: keep its QoS lane counters
        and measured wall on the scope (a request scope may span several
        pools; a shared decode-step scope is exactly one)."""
        with self._lock:
            r = self.requests.get(scope_id)
            if r is not None:
                if qos is not None:
                    r.qos = qos
                if measured is not None:
                    r.measured = measured
            self._pools_done += 1

    def record_done(self, scope_id: int, state: str = "done",
                    tokens: int = 0):
        """REQUEST-terminal transition: feeds the tenant SLO histograms
        (latency, queue wait, tokens/s) and the sliding SLO window."""
        with self._lock:
            r = self.requests.get(scope_id)
            if r is None:
                return
            r.state = state
            r.done_ns = _now_ns()
            r.tokens += int(tokens)
            t = self.tenants[r.tenant]
            if r.kind != "request":
                return
            key = "completed" if state == "done" else "failed"
            t.counters[key] += 1
            if state == "done" and r.submitted_ns is not None:
                e2e = r.done_ns - r.submitted_ns
                t.hists["latency_ns"].record(e2e)
                if r.admitted_ns is not None:
                    t.hists["queue_wait_ns"].record(
                        r.admitted_ns - r.submitted_ns)
                if r.tokens > 0 and r.admitted_ns is not None:
                    dt = max(1, r.done_ns - r.admitted_ns)
                    t.hists["tokens_per_s"].record(
                        round(r.tokens * 1e9 / dt))
                if t.slo_ms is not None:
                    viol = e2e > t.slo_ms * 1e6
                    t.window.append(viol)
                    if viol:
                        t.counters["slo_violations"] += 1

    def record_prefix(self, tenant: str, hits: int, misses: int):
        """One prompt's prefix-cache outcome — `hits` pages mapped onto
        frozen shared pages, `misses` prefilled cold."""
        self.tenant(tenant)
        with self._lock:
            t = self.tenants[tenant]
            t.counters["prefix_hits"] += int(hits)
            t.counters["prefix_misses"] += int(misses)

    def record_spec(self, tenant: str, proposed: int, accepted: int):
        """One speculative verify wave's outcome — `accepted` of
        `proposed` draft tokens survived target verification.  Feeds
        the per-tenant acceptance-rate histogram (whole percent)."""
        self.tenant(tenant)
        with self._lock:
            t = self.tenants[tenant]
            t.counters["spec_proposed"] += int(proposed)
            t.counters["spec_accepted"] += int(accepted)
            if proposed > 0:
                t.hists["spec_accept_pct"].record(
                    round(100 * accepted / proposed))

    def record_event(self, kind: str, **fields):
        """One structured decision (adaptive speculation moves, ...).
        Ring-buffered; `events()` snapshots."""
        ev = {"kind": str(kind), "t_ns": _now_ns()}
        ev.update(fields)
        with self._lock:
            self._events.append(ev)

    def events(self, kind: Optional[str] = None) -> List[dict]:
        """Snapshot of the structured decision log, oldest first,
        optionally filtered by kind."""
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def conformance(self) -> dict:
        """The stats()["scope"]["conformance"] namespace: retired pools
        and how many were planned (none until the analysis layer is
        ported, so coverage reads 0)."""
        with self._lock:
            pools = self._pools_done
        return {"pools": pools, "planned": 0,
                "coverage": 0.0 if pools else None}

    # -------------------------------------------------------------- SLO
    def slo_status(self) -> dict:
        """Per-tenant SLO burn: the fraction of the last `slo_window`
        completed requests that blew the tenant's slo_ms."""
        out = {}
        with self._lock:
            for name, t in self.tenants.items():
                if t.slo_ms is None:
                    continue
                n = len(t.window)
                burn = (sum(t.window) / n) if n else 0.0
                out[name] = {
                    "slo_ms": t.slo_ms,
                    "window_n": n,
                    "violations": t.counters["slo_violations"],
                    "burn_rate": round(burn, 4),
                    "breached": bool(n and burn >= t.burn_threshold),
                }
        return out

    def scope_legend(self) -> dict:
        """scope_id -> {tenant, kind, rid} — stamped into .ptt meta by
        take_trace so a trace names the requests it contains."""
        with self._lock:
            return {str(sid): {"tenant": r.tenant, "kind": r.kind,
                               "rid": r.rid}
                    for sid, r in self.requests.items()}

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        slo = self.slo_status()
        with self._lock:
            tenants = {}
            for name, t in self.tenants.items():
                row = dict(t.counters)
                for k, h in t.hists.items():
                    s = h.summary()
                    row[f"{k}_p50"] = s["p50"]
                    row[f"{k}_p99"] = s["p99"]
                    row[f"{k}_count"] = s["count"]
                tenants[name] = row
            n_req = sum(1 for r in self.requests.values()
                        if r.kind == "request")
            live = sum(1 for r in self.requests.values()
                       if r.state in ("submitted", "running"))
        return {
            "enabled": True,
            "scopes": self._next - 1,
            "requests": n_req,
            "live": live,
            "tenants": tenants,
            "slo": slo,
            "conformance": self.conformance(),
        }

    def scope_of(self, rid) -> Optional[int]:
        with self._lock:
            return self._by_rid.get(rid)

    def request(self, rid) -> Optional[_Request]:
        sid = self.scope_of(rid)
        with self._lock:
            return self.requests.get(sid) if sid is not None else None
