"""ptc-pilot — the online feedback controller that closes the
conformance loop.

The ScheduleSimulator picks knob vectors per (graph, host) OFFLINE;
the scope registry's conformance records measure — live, per pool —
exactly how wrong the cost model is.  This module is the consumer that was missing:
a deterministic `Controller` that runs at pool/step boundaries (no new
threads anywhere near the hot path) and

  (a) detects MODEL DRIFT — the median measured/lower-bound makespan
      ratio over the last `control.window` planned pools exceeding
      `control.drift_ratio` — then folds the live per-class calibration
      ratios into the CostModel (CostModel.recalibrated), re-runs
      ScheduleSimulator.propose() on the recalibrated model, and
      hot-swaps the winning knob vector at the NEXT pool boundary
      through tune.py's snapshot/restore apply path (hold_knobs).
      Winners persist through the TuneStore so recovery survives
      a restart;
  (b) drives the per-tenant cached-page budgets (PagePool cached-free
      LRU shares re-weighted by prefix hit rate) and feeds tenant SLO
      burn back into admission pricing (Server.set_admission_pressure)
      — a burning tenant sheds load BEFORE /healthz flips — via
      `poll()`, which the serving engine calls once per decode step;
  (c) takes watchdog `stuck_task` / `slow_rank` detections as its
      interrupt path: the observation window closes immediately and an
      evaluation runs without waiting for a full window.

Every decision is a structured scope event (`control_*` kinds in the
ScopeRegistry ring) AND an entry in the controller's own bounded
decision log.  The whole loop is deterministic: observations arrive
only through `observe_pool` / `interrupt` / `poll`, and with a
`SimClock` even the timestamps are reproducible — replaying the same
observation sequence yields an identical decision log (the replay
tests pin this).

Wiring (the serve stack does all of this automatically):

    ctrl = ctx.controller()            # lazy, one per context
    ctrl.attach_target(tp)             # the retune target graph
    ctrl.bind_engine(eng)              # budgets + spec_k visibility
    ... pools run; scope.record_pool_done feeds observe_pool ...
    ctx.stats()["control"]             # the unified namespace

Port of parsec_tpu/analysis/control.py.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional


class SimClock:
    """Deterministic clock for replay: every call advances a virtual
    nanosecond counter by a fixed step.  Two controllers fed the same
    observation sequence under equal SimClocks produce byte-identical
    decision logs, timestamps included."""

    def __init__(self, start_ns: int = 0, step_ns: int = 1_000_000):
        self._t = int(start_ns)
        self.step_ns = int(step_ns)

    def __call__(self) -> int:
        t = self._t
        self._t += self.step_ns
        return t


class Controller:
    """Deterministic pool-boundary feedback controller (module
    docstring).  Thread-safe: observations arrive from whatever thread
    retires a pool (engine driver, server pump, watchdog), stats
    scrapes from anywhere."""

    def __init__(self, ctx, clock: Optional[Callable[[], int]] = None,
                 drift_ratio: Optional[float] = None,
                 window: Optional[int] = None,
                 cooldown: Optional[int] = None,
                 store=None, max_decisions: int = 256):
        from ..utils import params as _mca
        self.ctx = ctx
        self.scope = ctx.scope_registry()
        self.drift_ratio = float(_mca.get("control.drift_ratio")
                                 if drift_ratio is None else drift_ratio)
        self.window = max(1, int(_mca.get("control.window")
                                 if window is None else window))
        self.cooldown = max(0, int(_mca.get("control.cooldown")
                                   if cooldown is None else cooldown))
        self._clock = clock or time.monotonic_ns
        self._store = store  # TuneStore (or stub); None = default
        self._lock = threading.Lock()
        self._ratios: deque = deque(maxlen=self.window)
        self._pools = 0          # boundaries observed
        self._cool_until = 0     # drift ignored until this boundary
        self._pending: Optional[dict] = None   # evaluated, not yet live
        self._applied: Optional[dict] = None   # live swap record
        self._restore: Optional[Callable] = None
        self._plan = None
        self._signature: Optional[str] = None
        self._workers: Optional[int] = None
        self._econ = None
        self._base_cost = None   # CostModel the target plan assumed
        self._engine = None
        self._retunes = 0
        self._swaps = 0
        self._interrupts = 0
        self._persisted = 0
        self._budget_shares: Dict[str, float] = {}
        self._pressure: Dict[str, float] = {}
        self.decisions: List[dict] = []
        self._max_decisions = int(max_decisions)
        self._stopped = False
        ctx._controller = self

    # ------------------------------------------------------------ wiring
    def attach_target(self, tp=None, plan=None, cost=None,
                      workers: Optional[int] = None, econ=None,
                      signature: Optional[str] = None):
        """Declare the retune target: a representative taskpool (or its
        concrete Plan).  Drift evaluation re-simulates THIS graph under
        the recalibrated cost model; without a target, drift is still
        detected and logged but no knob swap can be proposed."""
        from .plan import CostModel, plan_graph
        from .flowgraph import extract_flowgraph
        from .tune import graph_signature
        if plan is None:
            if tp is None:
                raise ValueError("attach_target needs a taskpool or plan")
            fg = extract_flowgraph(tp)
            plan = plan_graph(fg, cost=cost, econ=econ, workers=workers)
        if plan.bounded or plan.cg is None:
            raise ValueError("control target must plan concretely "
                             "(symbolic bounds cannot be simulated)")
        if signature is None and tp is not None:
            signature = graph_signature(tp)
        per_cls = (plan.makespan or {}).get("per_class_cost") or {}
        with self._lock:
            self._plan = plan
            self._signature = signature
            self._workers = workers
            self._econ = econ
            self._base_cost = cost or CostModel(
                dict(per_cls), source=(plan.makespan or {}).get(
                    "cost_source", "plan"))
        return plan

    def bind_engine(self, engine):
        """Give the controller its resource levers: the engine's
        PagePool (cached-share budgets), Server (admission pressure)
        and the adaptive-speculation snapshot for stats()."""
        with self._lock:
            self._engine = engine

    # ------------------------------------------------------ decision log
    def _record_locked(self, kind: str, **fields) -> dict:
        entry = {"n": len(self.decisions) + 1, "pool": self._pools,
                 "t_ns": int(self._clock()), "kind": kind}
        entry.update(fields)
        self.decisions.append(entry)
        if len(self.decisions) > self._max_decisions:
            del self.decisions[0]
        try:
            self.scope.record_event(
                kind, **{k: v for k, v in entry.items() if k != "kind"})
        except Exception:
            pass
        return entry

    def decision_log(self) -> List[dict]:
        with self._lock:
            return [dict(d) for d in self.decisions]

    # ------------------------------------------------------ observations
    def observe_pool(self, ratio: Optional[float] = None):
        """ONE retired pool (the boundary clock): apply any pending
        knob swap — the hot-swap contract is 'next pool boundary', and
        this IS it — then fold the pool's measured/lower-bound makespan
        ratio (None for an unplanned pool) and check for sustained
        drift."""
        with self._lock:
            if self._stopped:
                return
            self._pools += 1
            if self._pending is not None:
                self._apply_locked()
            if ratio is not None and ratio > 0:
                self._ratios.append(float(ratio))
            if len(self._ratios) < self.window or \
                    self._pools < self._cool_until:
                return
            med = sorted(self._ratios)[len(self._ratios) // 2]
            if med > self.drift_ratio:
                self._evaluate_locked("drift", med)

    def interrupt(self, kind: str, **fields):
        """Watchdog interrupt path (`stuck_task` / `slow_rank`): close
        the observation window NOW and evaluate without waiting for it
        to fill — a wedged task or a straggler rank is exactly the
        regime where the tuned knobs stopped describing reality.  The
        swap itself still waits for the next pool boundary."""
        with self._lock:
            if self._stopped:
                return
            self._interrupts += 1
            self._record_locked("control_interrupt", trigger=str(kind),
                                **fields)
            if self._pools < self._cool_until:
                return
            med = None
            if self._ratios:
                s = sorted(self._ratios)
                med = s[len(s) // 2]
            self._evaluate_locked(f"interrupt:{kind}", med)

    # ------------------------------------------------------- evaluation
    def _evaluate_locked(self, trigger: str, med: Optional[float]):
        """Window close: recalibrate, re-simulate, decide.  Runs under
        the controller lock; the scope registry is only ever taken
        AFTER it (record_pool_done delivers observations outside the
        registry lock), so the order is acyclic."""
        self._ratios.clear()
        self._cool_until = self._pools + self.cooldown
        if self._plan is None:
            self._record_locked(
                "control_drift", trigger=trigger,
                makespan_ratio=round(med, 4) if med else None,
                target=False)
            return
        from .tune import ScheduleSimulator, default_knobs
        ratios: Dict[str, float] = {}
        try:
            for cls, row in (self.scope.conformance()["per_class"]
                             or {}).items():
                if row.get("ratio"):
                    ratios[cls] = float(row["ratio"])
        except Exception:
            pass
        fallback = med if (med and med > 0) else 1.0
        cm = self._base_cost.recalibrated(ratios, fallback=fallback)
        sim = ScheduleSimulator(self._plan, cost=cm, econ=self._econ,
                                workers=self._workers)
        current = default_knobs()
        before_ns = sim.simulate(current)["makespan_ns"]
        ranked = sim.propose(topk=3, rounds=2)
        winner = ranked[0]
        changed = {k: v for k, v in winner["knobs"].items()
                   if v != current.get(k)}
        if not changed:
            self._record_locked(
                "control_drift", trigger=trigger,
                makespan_ratio=round(med, 4) if med else None,
                target=True, before_ns=round(before_ns),
                after_ns=round(winner["predicted_ns"]),
                held=True)
            return
        self._retunes += 1
        self._pending = {"knobs": dict(winner["knobs"]),
                         "changed": changed,
                         "before_ns": round(before_ns),
                         "after_ns": round(winner["predicted_ns"]),
                         "trigger": trigger}
        self._record_locked(
            "control_retune", trigger=trigger,
            makespan_ratio=round(med, 4) if med else None,
            before_ns=round(before_ns),
            after_ns=round(winner["predicted_ns"]),
            knobs=dict(changed))
        self._persist_locked(winner)

    def _persist_locked(self, winner: dict):
        """Tuned-cache persistence (TuneStore): the recovered
        vector keyed by (graph signature, host fingerprint), so a
        restarted process starts from the controller's winner instead
        of re-drifting through the same incident."""
        if self._signature is None:
            return
        try:
            from .tune import TuneStore, host_fingerprint
            store = self._store or TuneStore()
            store.put(self._signature, host_fingerprint(), {
                "knobs": dict(winner["knobs"]),
                "predicted_ns": winner["predicted_ns"],
                "measured_s": None, "critpath_ratio": None,
                "source": "control",
            })
            self._persisted += 1
        except Exception:
            pass

    def _apply_locked(self):
        """The pool-boundary hot swap: restore any previous hold, then
        apply the pending vector through tune.hold_knobs (MCA registry
        + PTC_MCA_* env, snapshot kept for teardown).  Every knob this
        package acts on binds when a Context or CudaDevice is created,
        so the swap reaches the runtimes created after it, not the live
        one: the control_apply record carries, beside the reference's
        fields, what the live runtime holds after the swap
        (`in_force`, tune.knobs_in_force) and the changed knobs it does
        not hold (`not_held`)."""
        from .tune import bound_value, hold_knobs, knobs_in_force
        pending, self._pending = self._pending, None
        if self._restore is not None:
            self._restore()
            self._restore = None
        try:
            _, self._restore = hold_knobs(pending["knobs"])
        except Exception as e:
            self._record_locked("control_apply", ok=False,
                                error=repr(e))
            return
        self._swaps += 1
        self._applied = pending
        force = knobs_in_force(self.ctx)
        not_held = sorted(
            k for k, v in pending["changed"].items()
            if k in force and any(h != bound_value(k, v)
                                  for h in force[k]))
        self._record_locked("control_apply", ok=True,
                            knobs=dict(pending["changed"]),
                            before_ns=pending["before_ns"],
                            after_ns=pending["after_ns"],
                            in_force=force, not_held=not_held)

    # --------------------------------------------------------- budgets
    def poll(self):
        """Step-boundary resource pass (the engine calls this once per
        decode step; anyone else may too — it is idempotent and cheap):
        re-weight the PagePool's cached-free LRU shares by per-tenant
        prefix hit rate, and feed tenant SLO burn into admission
        pricing so a burning tenant sheds load before /healthz flips.
        Changes (beyond a 0.05 dead-band) are logged decisions."""
        with self._lock:
            if self._stopped or self._engine is None:
                return
            engine = self._engine
        from ..utils import params as _mca
        min_share = float(_mca.get("control.budget_min_share"))
        rates: Dict[str, float] = {}
        burns: Dict[str, float] = {}
        try:
            with self.scope._lock:
                for name, t in self.scope.tenants.items():
                    h = t.counters.get("prefix_hits", 0)
                    m = t.counters.get("prefix_misses", 0)
                    if h + m:
                        rates[name] = h / (h + m)
            for name, st in self.scope.slo_status().items():
                burns[name] = float(st.get("burn_rate") or 0.0)
        except Exception:
            return
        shares: Dict[str, float] = {}
        if len(rates) > 1:
            total = sum(max(r, min_share) for r in rates.values())
            shares = {n: max(r, min_share) / total
                      for n, r in rates.items()}
        with self._lock:
            if shares and any(
                    abs(shares.get(n, 0.0)
                        - self._budget_shares.get(n, 0.0)) >= 0.05
                    for n in set(shares) | set(self._budget_shares)):
                self._budget_shares = dict(shares)
                try:
                    engine.pool.set_cached_shares(shares)
                except Exception:
                    pass
                self._record_locked(
                    "control_budget",
                    shares={n: round(s, 3)
                            for n, s in sorted(shares.items())})
            for name, burn in sorted(burns.items()):
                if abs(burn - self._pressure.get(name, 0.0)) < 0.05:
                    continue
                self._pressure[name] = burn
                try:
                    engine.server.set_admission_pressure(name, burn)
                except Exception:
                    pass
                self._record_locked("control_pressure", tenant=name,
                                    burn_rate=round(burn, 4))

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        with self._lock:
            s = sorted(self._ratios)
            spec = {}
            eng = self._engine
            applied = self._applied
            out = {
                "enabled": True,
                "pools": self._pools,
                "window": self.window,
                "window_n": len(s),
                "drift_ratio": self.drift_ratio,
                "drift_now": round(s[len(s) // 2], 4) if s else None,
                "retunes": self._retunes,
                "swaps": self._swaps,
                "interrupts": self._interrupts,
                "persisted": self._persisted,
                "pending": self._pending is not None,
                "target": self._plan is not None,
                "decisions": len(self.decisions),
                "last_swap": ({
                    "trigger": applied["trigger"],
                    "before_ns": applied["before_ns"],
                    "after_ns": applied["after_ns"],
                    "knobs": dict(applied["changed"]),
                } if applied else None),
                "budget_shares": {n: round(v, 4) for n, v in
                                  sorted(self._budget_shares.items())},
                "pressure": {n: round(v, 4) for n, v in
                             sorted(self._pressure.items())},
            }
        if eng is not None:
            try:
                spec = eng.spec_k_snapshot()
            except Exception:
                spec = {}
        out["spec_k"] = spec
        return out

    # --------------------------------------------------------- teardown
    def stop(self):
        """Restore any held knob vector and detach (idempotent; wired
        into Context.destroy)."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            self._pending = None
            if self._restore is not None:
                try:
                    self._restore()
                except Exception:
                    pass
                self._restore = None
        if getattr(self.ctx, "_controller", None) is self:
            self.ctx._controller = None
