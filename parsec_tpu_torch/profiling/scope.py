"""Request-scoped observability: end-to-end tracing, SLO metrics,
plan-vs-measured conformance.

Reference role: PaRSEC's PINS layer attributes cost to workers and task
classes; a serving runtime must attribute it to the work unit the USER
cares about — the request.  This module is that attribution layer:

  ScopeRegistry     one per Context.  Allocates request-scope ids
                    (stamped into taskpools via ptc_tp_set_scope, beside
                    the QoS stamp), tracks each request's lifecycle
                    (submit -> admitted -> first token -> done), folds
                    per-tenant SLO histograms (TTFT, queue wait,
                    admission-to-done latency, tokens/s) + reject/shed
                    counters, and records plan-vs-measured conformance
                    at every pool retirement.  Exported through
                    Context.stats()["scope"] and — tenant-labelled —
                    through the Prometheus endpoint.

  request_timeline  reconstructs ONE request's full multi-rank story
                    from a (merged) Trace: admission wait, lane/sched
                    wait, per-wave EXEC, page h2d, wire hops — a
                    PARTITION of the request's end-to-end latency (the
                    stages sum to it exactly; "lane_wait" is the
                    measured residual between the pool's wall window
                    and its attributed work).

  conformance       the always-on honesty signal the
                    autotuner regresses against: per-pool ptc-plan
                    predictions (est_bytes, makespan lower bound, wire
                    byte bound, spill verdict) vs measured counters,
                    plus per-class calibration ratios (cost-model ns vs
                    the live metrics histograms' p50).

Clock note: request timestamps and trace events both read the NATIVE
ptc_now_ns clock (exported as ptc_clock_ns), so ticket times and
(rank-0-referenced, merged) trace spans live on one axis — the TSC fast
path's epoch drifts from CLOCK_MONOTONIC over long processes, so
time.monotonic_ns would misalign the windows by milliseconds.

Port of parsec_tpu/profiling/scope.py.  The conformance record's
measured wire bytes read the comm engine's bytes_sent counter (None, as
in the reference, when comm is off).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from .metrics import _BUCKETS, Hist

__all__ = ["ScopeRegistry", "ScopeHist", "request_timeline"]


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
                 "done_ns", "tokens", "pools", "qos", "plan", "measured",
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
        self.plan: Optional[dict] = None     # ptc-plan predictions
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
                         "spec_proposed": 0, "spec_accepted": 0,
                         "coll_waves": 0}
        self.hists = {"ttft_ns": ScopeHist(), "queue_wait_ns": ScopeHist(),
                      "latency_ns": ScopeHist(), "tokens_per_s": ScopeHist(),
                      # ptc-share: per-verify-wave draft acceptance, in
                      # whole percent (0..100) of proposed tokens
                      "spec_accept_pct": ScopeHist(),
                      # ptc-shard: per decode step, the critical-path
                      # exposure to the embedded tp all-reduce — local
                      # shard done -> reduced pre-logits delivered
                      "coll_wait_ns": ScopeHist()}


def _now_ns() -> int:
    """The NATIVE trace clock (ptc_now_ns), not time.monotonic_ns:
    request windows must align with trace span timestamps exactly, and
    the TSC fast path's epoch drifts from CLOCK_MONOTONIC by
    milliseconds over a long-lived process."""
    from .. import _native as N
    return int(N.lib.ptc_clock_ns())


# ------------------------------------------------------------- registry
class ScopeRegistry:
    """Per-context request-scope bookkeeping (see module docstring).
    Thread-safe: the serve pump, submitter threads, the engine driver
    and exporter scrapes all touch it concurrently."""

    def __init__(self, ctx, slo_window: int = 128):
        self.ctx = ctx
        self._lock = threading.Lock()
        self._next = 1
        self.slo_window = int(slo_window)
        self.requests: Dict[int, _Request] = {}
        self.tenants: Dict[str, _Tenant] = {}
        self._by_rid: Dict[object, int] = {}
        # decode-style shared pools: scope -> ordered member rids
        self._members: Dict[int, List[object]] = {}
        # conformance aggregates — EPOCHED (ptc-pilot): the fold-only
        # counters roll to a fresh generation every conformance_window
        # retired pools (one closed generation kept), so a long soak's
        # rollup reads the RECENT plan-vs-measured ratio in O(window)
        # state instead of a run-lifetime average the drift detector
        # could never move
        from ..utils import params as _mca
        try:
            self.conformance_window = int(
                _mca.get("scope.conformance_window"))
        except Exception:
            self.conformance_window = 2048
        self._conf_prev: Optional[dict] = None  # closed epoch fold
        self._conf_epochs = 0
        self._pools_done = 0
        self._pools_planned = 0
        self._unplanned = 0
        self._pred_wire_bytes = 0
        self._pred_est_bytes = 0
        self._makespan_ratios: deque = deque(maxlen=512)
        self._spill_pred_nonzero = 0
        self._per_class_cost: Dict[str, float] = {}  # last planned ns
        # structured decision log (fleet router placements, re-routes,
        # migrations): bounded ring so a long-lived router can't grow it
        self._events: deque = deque(maxlen=1024)
        # the comm engine's bytes_sent at the epoch's start
        self._comm_base = (ctx.comm_stats()["bytes_sent"]
                           if ctx.comm_enabled else 0)

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
                  rid=None, meta=None, members: Optional[list] = None,
                  ) -> int:
        """Allocate a scope id (sequential from 1 — SPMD-deterministic
        when allocation calls are SPMD).  `members` marks a SHARED pool
        (one continuous-batching decode step): an ordered rid list so
        EXEC spans' first local (the sequence lane) map back to
        requests."""
        self.tenant(tenant)
        with self._lock:
            sid = self._next
            self._next += 1
            r = _Request(sid, tenant, kind, rid, meta)
            r.submitted_ns = _now_ns()
            self.requests[sid] = r
            if rid is not None and kind == "request":
                self._by_rid[rid] = sid
            if members is not None:
                self._members[sid] = list(members)
            if kind == "request":
                self.tenants[tenant].counters["submitted"] += 1
        return sid

    def stamp(self, tp, scope_id: int) -> None:
        """Stamp a taskpool with the scope (native ptc_tp_set_scope,
        beside the QoS stamp) and remember the pool id."""
        tp.set_scope(scope_id)
        with self._lock:
            r = self.requests.get(scope_id)
            if r is not None:
                try:
                    r.pools.append(tp.tp_id)
                except Exception:
                    pass
                # class-id -> name table of the stamped pool: trace
                # class ids are PER POOL, so per-scope naming is the
                # only unambiguous one (request_timeline wave rows)
                try:
                    r.class_names = [tc.name for tc in tp.classes]
                except Exception:
                    pass

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
                         plan: Optional[dict] = None,
                         measured: Optional[dict] = None):
        """One POOL retired under this scope: fold the plan-vs-measured
        conformance record (a request scope may span several pools; a
        shared decode-step scope is exactly one)."""
        ratio = None
        with self._lock:
            r = self.requests.get(scope_id)
            if r is not None:
                if qos is not None:
                    r.qos = qos
                if plan is not None:
                    r.plan = plan
                if measured is not None:
                    r.measured = measured
            self._pools_done += 1
            if plan:
                self._pools_planned += 1
                if plan.get("est_bytes"):
                    self._pred_est_bytes += int(plan["est_bytes"])
                self._pred_wire_bytes += int(
                    plan.get("wire_out_bound_sum", 0))
                lb = plan.get("makespan_lb_ns")
                wall = (measured or {}).get("wall_ns")
                if lb and wall and lb > 0:
                    ratio = wall / lb
                    self._makespan_ratios.append(ratio)
                if plan.get("spills_predicted"):
                    self._spill_pred_nonzero += 1
                for cls, ns in (plan.get("per_class_cost") or {}).items():
                    self._per_class_cost[cls] = float(ns)
            else:
                self._unplanned += 1
            if self.conformance_window > 0 and \
                    self._pools_done >= self.conformance_window:
                self._conf_roll_locked()
        # ptc-pilot: the pool boundary IS the controller's clock — one
        # observation per retired pool (ratio None when unplanned),
        # delivered OUTSIDE the registry lock (the controller logs its
        # decisions back through record_event)
        ctrl = getattr(self.ctx, "_controller", None)
        if ctrl is not None:
            try:
                ctrl.observe_pool(ratio)
            except Exception:
                pass

    def _conf_roll_locked(self):
        """Close the current conformance epoch: fold it into
        `_conf_prev` (replacing the older generation) and zero the live
        counters.  The comm baseline advances so the closed epoch owns
        exactly the bytes sent during it — conformance() then merges
        the two generations, keeping coverage/soundness recent AND
        bounded."""
        bytes_now = self._comm_base
        if self.ctx.comm_enabled:
            bytes_now = self.ctx.comm_stats()["bytes_sent"]
        self._conf_prev = {
            "pools": self._pools_done,
            "planned": self._pools_planned,
            "unplanned": self._unplanned,
            "pred_wire": self._pred_wire_bytes,
            "pred_est": self._pred_est_bytes,
            "spill_pred": self._spill_pred_nonzero,
            "measured_wire": max(0, bytes_now - self._comm_base),
        }
        self._conf_epochs += 1
        self._pools_done = 0
        self._pools_planned = 0
        self._unplanned = 0
        self._pred_wire_bytes = 0
        self._pred_est_bytes = 0
        self._spill_pred_nonzero = 0
        self._comm_base = bytes_now

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
        """ptc-share: one prompt's prefix-cache outcome — `hits` pages
        mapped onto frozen shared pages, `misses` prefilled cold
        (per-tenant hit-rate feed for ptc_top + Prometheus)."""
        self.tenant(tenant)
        with self._lock:
            t = self.tenants[tenant]
            t.counters["prefix_hits"] += int(hits)
            t.counters["prefix_misses"] += int(misses)

    def record_spec(self, tenant: str, proposed: int, accepted: int):
        """ptc-share: one speculative verify wave's outcome — `accepted`
        of `proposed` draft tokens survived target verification.  Feeds
        the per-tenant acceptance-rate histogram (whole percent)."""
        self.tenant(tenant)
        with self._lock:
            t = self.tenants[tenant]
            t.counters["spec_proposed"] += int(proposed)
            t.counters["spec_accepted"] += int(accepted)
            if proposed > 0:
                t.hists["spec_accept_pct"].record(
                    round(100 * accepted / proposed))

    def record_coll_wait(self, tenant: str, wait_ns: int, n: int = 1):
        """ptc-shard: one tp pool's collective-wait exposure — the time
        between this rank's LAST local shard fold finishing and the
        all-reduced pre-logits arriving back (`n` sequences were served
        by the wave).  Feeds the per-tenant coll_wait histogram the
        ptc_top tenant table and Prometheus export surface."""
        self.tenant(tenant)
        with self._lock:
            t = self.tenants[tenant]
            t.counters["coll_waves"] += 1
            t.hists["coll_wait_ns"].record(max(0, int(wait_ns)))

    def record_event(self, kind: str, **fields):
        """ptc-route: one structured fleet decision — placement (with
        per-replica scores), re-route after a 503 flip, page-migration
        bundle.  Ring-buffered; `events()` snapshots for dashboards and
        the deterministic router tests (which assert on WHY a replica
        won, not just which one)."""
        ev = {"kind": str(kind), "t_ns": _now_ns()}
        ev.update(fields)
        with self._lock:
            self._events.append(ev)
        # ptc-blackbox: decision events are journal records too — the
        # ring above dies with the process, the journal does not
        jr = getattr(self.ctx, "_journal", None)
        if jr is not None:
            try:
                jr.record("scope_event", **ev)
            except Exception:
                pass

    def events(self, kind: Optional[str] = None) -> List[dict]:
        """Snapshot of the structured decision log, oldest first,
        optionally filtered by kind."""
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    @staticmethod
    def plan_summary(plan) -> dict:
        """Compress a ptc-plan result into the prediction record
        record_done consumes (analysis/plan.py Plan)."""
        out = {
            "est_bytes": plan.est_bytes(),
            "comm_bytes": plan.comm_bytes(),
            "wire_out_bound_sum": sum(plan.wire_out_bound(rk)
                                      for rk in plan.ranks()),
            "makespan_lb_ns": int(plan.makespan.get("lower_bound_ns", 0))
            if plan.makespan else 0,
            "cost_source": (plan.makespan or {}).get("cost_source"),
        }
        # per-class cost assumptions the makespan bound used — the
        # calibration baseline conformance() compares live p50s against
        try:
            cm = plan.makespan.get("per_class_cost")
            if cm:
                out["per_class_cost"] = dict(cm)
        except Exception:
            pass
        return out

    def conformance(self) -> dict:
        """Plan-vs-measured rollup — the stats()["scope"]["conformance"]
        namespace.  Soundness fields compare PREDICTED upper bounds
        against context-wide measured counters, so they are only
        asserted when every retired pool was planned (coverage 1.0):
        a single unplanned pool's traffic would falsely indict the
        bound."""
        with self._lock:
            pools = self._pools_done
            planned = self._pools_planned
            ratios = sorted(self._makespan_ratios)
            pred_wire = self._pred_wire_bytes
            pred_est = self._pred_est_bytes
            spill_pred = self._spill_pred_nonzero
            per_class_cost = dict(self._per_class_cost)
            prev = self._conf_prev
            epochs = self._conf_epochs
            comm_base = self._comm_base
        prev_wire = 0
        if prev is not None:
            # merge the closed generation: the rollup spans at most two
            # conformance windows, however long the run has been
            pools += prev["pools"]
            planned += prev["planned"]
            pred_wire += prev["pred_wire"]
            pred_est += prev["pred_est"]
            spill_pred += prev["spill_pred"]
            prev_wire = prev["measured_wire"]
        measured_wire = None
        comm_sound = None
        if self.ctx.comm_enabled:
            measured_wire = (self.ctx.comm_stats()["bytes_sent"]
                             - comm_base) + prev_wire
        coverage = planned / pools if pools else None
        if measured_wire is not None and pools and coverage == 1.0:
            comm_sound = bool(pred_wire >= measured_wire)
        peak = None
        res_sound = None
        try:
            ds = self.ctx.device_stats()
            peak = ds.get("cache_peak_bytes")
        except Exception:
            pass
        if peak and planned and coverage == 1.0 and pred_est:
            # every concurrent pool's residency <= the sum of predicts
            res_sound = bool(pred_est >= peak)
        # per-class calibration: live measured p50 vs the cost the
        # planner assumed — ~1.0 means the model is honest; the
        # autotuner regresses against this ratio
        per_class = {}
        try:
            from .metrics import snapshot_histograms
            from .. import _native as N
            for h in snapshot_histograms(self.ctx):
                if h.kind == N.MET_EXEC and h.name and h.count > 0 and \
                        h.name in per_class_cost:
                    planned_ns = per_class_cost[h.name]
                    p50 = h.quantile(0.50)
                    per_class[h.name] = {
                        "planned_ns": round(planned_ns, 1),
                        "measured_p50_ns": round(p50, 1),
                        "ratio": round(p50 / planned_ns, 4)
                        if planned_ns > 0 else None,
                    }
        except Exception:
            pass
        return {
            "pools": pools,
            "planned": planned,
            "epochs": epochs,
            "coverage": round(coverage, 4) if coverage is not None
            else None,
            "makespan": {
                "n": len(ratios),
                "ratio_p50": round(ratios[len(ratios) // 2], 4)
                if ratios else None,
                "ratio_min": round(ratios[0], 4) if ratios else None,
            },
            "comm_bytes": {
                "predicted_sum": pred_wire,
                "measured": measured_wire,
                "sound": comm_sound,
            },
            "residency": {
                "predicted_sum": pred_est,
                "measured_peak": peak,
                "sound": res_sound,
            },
            "spills": {
                "pools_predicting_spills": spill_pred,
                "measured": (self._device_spills() if spill_pred or peak
                             else None),
            },
            "per_class": per_class,
        }

    def _device_spills(self):
        try:
            return int(self.ctx.device_stats().get("spills", 0))
        except Exception:
            return None

    # -------------------------------------------------------------- SLO
    def slo_status(self) -> dict:
        """Per-tenant SLO burn: the fraction of the last `slo_window`
        completed requests that blew the tenant's slo_ms.  `breached`
        (burn_rate >= burn_threshold) drives /healthz 503 and the
        watchdog's slo_burn event."""
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

    def live_scopes(self) -> List[dict]:
        """Every scope not yet terminal (submitted/running) with enough
        identity for a postmortem to name a dead rank's inflight
        requests — the ptc-blackbox checkpoint's `live_scopes` field."""
        with self._lock:
            return [{"scope_id": sid, "tenant": r.tenant, "kind": r.kind,
                     "rid": r.rid, "state": r.state}
                    for sid, r in self.requests.items()
                    if r.state in ("submitted", "running")]

    def tenant_export(self) -> dict:
        """Per-tenant counters + SPARSE histogram buckets (native
        log2/8-sub-bucket indices, so cross-replica merging is pure
        addition — the same fold as the fence-time MSG_METRICS peer
        snapshots).  The FleetView scrape input; rides /stats.json as
        `scope_hists` so remote replicas federate identically."""
        slo = self.slo_status()
        with self._lock:
            out = {}
            for name, t in self.tenants.items():
                hists = {}
                for k, h in t.hists.items():
                    if not h.count:
                        continue
                    nz = np.nonzero(h.buckets)[0]
                    hists[k] = {
                        "count": int(h.count), "sum": int(h.sum),
                        "buckets": [[int(i), int(h.buckets[i])]
                                    for i in nz]}
                out[name] = {"counters": dict(t.counters),
                             "hists": hists, "slo": slo.get(name)}
        return out

    def scope_legend(self) -> dict:
        """scope_id -> {tenant, kind, rid} — stamped into .ptt meta by
        take_trace so a flight dump names the requests it contains."""
        with self._lock:
            return {str(sid): {"tenant": r.tenant, "kind": r.kind,
                               "rid": r.rid}
                    for sid, r in self.requests.items()}

    def scope_of(self, rid) -> Optional[int]:
        with self._lock:
            return self._by_rid.get(rid)

    def request(self, rid) -> Optional[_Request]:
        sid = self.scope_of(rid)
        with self._lock:
            return self.requests.get(sid) if sid is not None else None

    # --------------------------------------------------------- timeline
    def request_scopes(self, rid) -> List[Tuple[int, Optional[int]]]:
        """All scopes carrying work for `rid`: its own request scope
        plus every shared (decode-step) scope listing it as a member —
        as (scope_id, member_index or None)."""
        out: List[Tuple[int, Optional[int]]] = []
        with self._lock:
            sid = self._by_rid.get(rid)
            if sid is not None:
                out.append((sid, None))
            for ssid, members in self._members.items():
                if rid in members:
                    out.append((ssid, members.index(rid)))
        return out

    def scope_timeline(self, trace, scope_id: int) -> dict:
        """Timeline of ONE scope (server-owned tickets with no rid):
        same stage partition as request_timeline."""
        with self._lock:
            r = self.requests.get(int(scope_id))
            if r is None:
                raise KeyError(f"unknown scope {scope_id}")
            names = {int(scope_id): r.class_names}
            sub, adm, done = r.submitted_ns, r.admitted_ns, r.done_ns
        tl = request_timeline(trace, [(int(scope_id), None)],
                              submitted_ns=sub, admitted_ns=adm,
                              done_ns=done, class_names=names)
        tl["tenant"] = r.tenant
        tl["state"] = r.state
        return tl

    def request_timeline(self, trace, rid) -> dict:
        """One request's end-to-end story off a (merged) Trace: the
        admission record + the stage partition of its latency.  See
        module-level request_timeline for the decomposition."""
        r = self.request(rid)
        if r is None:
            raise KeyError(f"unknown request {rid!r}")
        scopes = self.request_scopes(rid)
        with self._lock:
            names = {sid: self.requests[sid].class_names
                     for sid, _ in scopes if sid in self.requests}
        tl = request_timeline(
            trace, scopes,
            submitted_ns=r.submitted_ns, admitted_ns=r.admitted_ns,
            done_ns=r.done_ns, class_names=names)
        tl["rid"] = rid
        tl["tenant"] = r.tenant
        tl["state"] = r.state
        tl["tokens"] = r.tokens
        tl["first_token_ns"] = r.first_token_ns
        if r.first_token_ns is not None and r.submitted_ns is not None:
            tl["ttft_ms"] = round(
                (r.first_token_ns - r.submitted_ns) / 1e6, 3)
        return tl


# ------------------------------------------------------- timeline maths
def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    if not iv:
        return []
    iv = sorted(iv)
    out = [list(iv[0])]
    for b, e in iv[1:]:
        if b <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([b, e])
    return [(b, e) for b, e in out]


def _union_len(iv) -> int:
    return sum(e - b for b, e in iv)


def _subtract(iv, cut) -> List[Tuple[int, int]]:
    """iv \\ cut, both interval unions (sorted, disjoint)."""
    out = []
    ci = 0
    for b, e in iv:
        cur = b
        while ci < len(cut) and cut[ci][1] <= cur:
            ci += 1
        j = ci
        while j < len(cut) and cut[j][0] < e:
            cb, ce = cut[j]
            if cb > cur:
                out.append((cur, min(cb, e)))
            cur = max(cur, ce)
            if cur >= e:
                break
            j += 1
        if cur < e:
            out.append((cur, e))
    return out


def _clip(iv, w0, w1):
    return [(max(b, w0), min(e, w1)) for b, e in iv
            if min(e, w1) > max(b, w0)]


def request_timeline(trace, scopes, submitted_ns=None, admitted_ns=None,
                     done_ns=None, class_names=None) -> dict:
    """Stage partition of one request's latency over a (merged) Trace.

    `scopes` is a list of (scope_id, member_index or None): the
    request's own scope plus any shared continuous-batching scopes
    (member_index = the request's sequence lane — EXEC/RELEASE spans
    are filtered to locals[0] == member_index there, so one decode pool
    shared by 8 sequences attributes each lane's folds to the right
    request; shared h2d/wire stay attributed to every member they
    served, which is honest for staging shared pages).

    Stages (ns, over the [admitted, done] window on the rank-0 clock):
      admission_wait  submit -> admitted (queue + backpressure)
      exec            time-union of the request's EXEC spans
      h2d             device staging (H2D spans) outside exec
      coll_wait       wire-flow windows delivering ptc_coll_* collective
                      steps (ptc-shard tp all-reduce legs — flows whose
                      (src, corr) matches a KEY_COLL instant, the same
                      evidence critpath.lost_time uses), outside
                      exec+h2d
      wire            remaining matched wire-flow windows outside
                      exec+h2d+coll_wait
      lane_wait       the measured residual: window - the above — lane
                      queueing, scheduler boundaries, driver overhead
    By construction admission_wait + exec + h2d + coll_wait + wire +
    lane_wait == end-to-end latency (done - submitted): the partition
    identity the acceptance test pins.  Also returns the per-stage span
    lists and the wire hops (src, dst, bytes, latency_ns, coll flag).
    `class_names` maps scope_id -> [class names by id] (class ids are
    per pool; the registry passes each scope's own table)."""
    from .trace import (KEY_COLL, KEY_EXEC, KEY_H2D, KEY_RELEASE,
                        KEY_STREAM)

    def _cname(sid, cid):
        tbl = (class_names or {}).get(sid)
        if tbl and 0 <= cid < len(tbl):
            return tbl[cid]
        return trace._cname(cid)

    ex_iv: List[Tuple[int, int]] = []
    h2d_iv: List[Tuple[int, int]] = []
    wire_iv: List[Tuple[int, int]] = []
    coll_iv: List[Tuple[int, int]] = []
    hops: List[dict] = []
    waves: List[dict] = []
    ev_min, ev_max = None, None
    for sid, member in scopes:
        sub = trace.filter_scope(sid)
        if not len(sub.events):
            continue
        t = sub._spans_table()
        coll_keys = set()
        for row in t:
            key = int(row[2])
            b, e = int(row[7]), int(row[8])
            ev_min = b if ev_min is None else min(ev_min, b)
            ev_max = e if ev_max is None else max(ev_max, e)
            if key in (KEY_EXEC, KEY_RELEASE):
                if member is not None and int(row[4]) != member:
                    continue
                if key == KEY_EXEC:
                    ex_iv.append((b, e))
                    waves.append({"scope": sid,
                                  "class": _cname(sid, int(row[3])),
                                  "l0": int(row[4]), "l1": int(row[5]),
                                  "begin_ns": b, "dur_ns": e - b,
                                  "rank": int(row[0])})
            elif key in (KEY_H2D, KEY_STREAM):
                h2d_iv.append((b, e))
            elif key == KEY_COLL:
                # collective-step delivery instant: l0 = source rank,
                # l1 = correlation cookie — tags the matching wire flow
                coll_keys.add((int(row[4]), int(row[5])))
        fl = sub.flows()
        for row in fl:
            s, d, corr, nbytes, t_s, t_r, lat = (int(x) for x in row)
            is_coll = (s, corr) in coll_keys
            (coll_iv if is_coll else wire_iv).append((t_s, t_r))
            hops.append({"scope": sid, "src": s, "dst": d,
                         "bytes": nbytes, "latency_ns": lat,
                         "send_ns": t_s, "recv_ns": t_r,
                         "coll": is_coll})
    # window: the ticket's [admitted, done] when known, else the span
    # envelope (pure-trace mode)
    w0 = admitted_ns if admitted_ns is not None else ev_min
    w1 = done_ns if done_ns is not None else ev_max
    if w0 is None or w1 is None or w1 < w0:
        w0 = w0 if w0 is not None else 0
        w1 = max(w1 if w1 is not None else 0, w0)
    ex_u = _clip(_union(ex_iv), w0, w1)
    h2d_u = _subtract(_clip(_union(h2d_iv), w0, w1), ex_u)
    busy = _union([*ex_u, *h2d_u])
    coll_u = _subtract(_clip(_union(coll_iv), w0, w1), busy)
    busy_c = _union([*busy, *coll_u])
    wire_u = _subtract(_clip(_union(wire_iv), w0, w1), busy_c)
    exec_ns = _union_len(ex_u)
    h2d_ns = _union_len(h2d_u)
    coll_ns = _union_len(coll_u)
    wire_ns = _union_len(wire_u)
    window_ns = w1 - w0
    lane_ns = max(0, window_ns - exec_ns - h2d_ns - coll_ns - wire_ns)
    admission_ns = (w0 - submitted_ns) if (submitted_ns is not None and
                                           admitted_ns is not None) else 0
    waves.sort(key=lambda w: w["begin_ns"])
    stages = {"admission_wait_ns": admission_ns, "exec_ns": exec_ns,
              "h2d_ns": h2d_ns, "coll_wait_ns": coll_ns,
              "wire_ns": wire_ns, "lane_wait_ns": lane_ns}
    return {
        "scopes": [s for s, _ in scopes],
        "window_ns": window_ns,
        "e2e_ns": admission_ns + window_ns,
        "stages": stages,
        "stages_sum_ns": sum(stages.values()),
        "waves": waves,
        "wire_hops": hops,
    }
