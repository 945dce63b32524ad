"""Serving front door: admission control + backpressure over taskpools.

Port of parsec_tpu/serve/server.py.  A Server accepts request DAGs
(each a taskpool builder), enforces per-tenant budgets, and stamps every
admitted pool with the tenant's QoS (priority/weight → the native QoS
lanes of the lws scheduler):

  admission   a tenant may hold at most `max_pools` concurrently-running
              pools; excess submissions QUEUE up to `max_queue` entries
              and `max_queued_bytes` estimated bytes, and are REJECTED
              beyond that (backpressure the caller can see)
  retirement  completed pools are destroyed on the pump thread (native
              memory stays flat under pool churn) and the tenant's queue
              is pumped
  resources   a builder may raise ResourceBusy (engine out of KV pages /
              sequence slots): the ticket goes back to the queue head
              and the tenant pauses until the next retirement

Counters (per tenant + totals) export through Context.stats()["serve"],
which the MetricsRegistry flattens into Prometheus samples (ptc_serve_*)
and /stats.json.  With `conformance` (the default) every admitted pool
is planned (Taskpool.plan()) and its prediction folds into the scope
registry's plan-vs-measured record at retirement.

`cancel` withdraws a still-queued ticket: the fleet router
(serve/router.py) re-places work off an unhealthy replica with it.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["TenantConfig", "Ticket", "Server", "AdmissionError",
           "ResourceBusy"]


class AdmissionError(RuntimeError):
    """Raised by submit(wait=True) when the request was rejected."""


class ResourceBusy(RuntimeError):
    """Raised by a pool builder when a shared resource (KV pages,
    sequence slots) is exhausted: the ticket re-queues instead of
    failing, and the tenant pauses until a retirement."""


class TenantConfig:
    """One tenant's QoS + admission budgets.

    priority/weight feed Context.taskpool (native QoS lanes: priority
    orders tenants strictly at every scheduler wave boundary, weight
    stride-shares one priority tier).  max_pools bounds concurrently
    running pools; max_queue / max_queued_bytes bound the backlog."""

    def __init__(self, name: str, priority: int = 0, weight: int = 1,
                 max_pools: int = 4, max_queue: int = 64,
                 max_queued_bytes: Optional[int] = None,
                 default_est_bytes: Optional[int] = None,
                 slo_ms: Optional[float] = None,
                 slo_burn: float = 0.5):
        self.name = name
        self.priority = int(priority)
        self.weight = max(1, int(weight))
        self.max_pools = max(1, int(max_pools))
        self.max_queue = max(0, int(max_queue))
        self.max_queued_bytes = max_queued_bytes
        # byte estimate for submissions that declare none (est_bytes=0
        # means UNKNOWN): None = derive the static plan bound from the
        # submitted pool instead (see Server.submit)
        self.default_est_bytes = default_est_bytes
        # SLO target on submit->done latency (ms).  The ScopeRegistry
        # tracks a sliding violation window; a burn rate at or above
        # `slo_burn` marks the tenant breached — /healthz turns 503,
        # Server.healthy() is False and the watchdog emits a structured
        # slo_burn event.
        self.slo_ms = None if slo_ms is None else float(slo_ms)
        self.slo_burn = float(slo_burn)


class Ticket:
    """One submission's lifecycle handle.  States:
    queued -> running -> done | failed, or rejected / cancelled
    (terminal).  `cancelled` only ever happens to a still-QUEUED ticket
    (Server.cancel — the fleet router re-placing work off an unhealthy
    replica); a running pool is never torn out from under its waves."""

    __slots__ = ("tenant", "est_bytes", "meta", "state", "submitted_t",
                 "admitted_t", "done_t", "error", "_event", "_make_pool",
                 "_pool", "scope_id", "_owns_scope", "_plan",
                 "_est_discount")

    def __init__(self, tenant: str, make_pool: Callable, est_bytes,
                 meta):
        self.tenant = tenant
        # None = unknown AND statically unboundable (rejected whenever a
        # byte budget is in force — the budget can never be evaded)
        self.est_bytes = None if est_bytes is None else int(est_bytes)
        self.meta = meta
        self.state = "queued"
        self.submitted_t = time.monotonic()
        self.admitted_t: Optional[float] = None
        self.done_t: Optional[float] = None
        self.error: Optional[BaseException] = None
        self._event = threading.Event()
        self._make_pool = make_pool
        self._pool = None
        # request scope: stamped into the pool at admission;
        # _owns_scope = the server allocated it, so pool completion IS
        # the request's terminal state (an engine-owned scope outlives
        # the prefill pool — the engine retires it)
        self.scope_id: Optional[int] = None
        self._owns_scope = False
        self._plan: Optional[dict] = None  # plan prediction summary
        self._est_discount = 0  # predicted-shared bytes (prefix cache)

    @property
    def terminal(self) -> bool:
        return self.state in ("done", "failed", "rejected", "cancelled")

    def wait(self, timeout: Optional[float] = None) -> str:
        """Block until terminal; returns the final state."""
        self._event.wait(timeout)
        return self.state

    @property
    def queue_wait_s(self) -> float:
        if self.admitted_t is None:
            return 0.0
        return self.admitted_t - self.submitted_t

    @property
    def latency_s(self) -> Optional[float]:
        """submit -> done wall seconds (None before completion)."""
        if self.done_t is None:
            return None
        return self.done_t - self.submitted_t


class _TenantState:
    def __init__(self, cfg: TenantConfig):
        self.cfg = cfg
        self.active = 0
        self.queue: deque = deque()
        self.queued_bytes = 0
        self.blocked = False  # ResourceBusy: pause until a retirement
        self.counters = {
            "submitted": 0, "admitted": 0, "rejected": 0,
            "completed": 0, "failed": 0, "resource_waits": 0,
            "queue_wait_ns": 0, "discounted_bytes": 0, "cancelled": 0,
            "pressure_inflated_bytes": 0,
        }


class Server:
    """Admission-controlled multi-tenant front door over one Context.

    submit(tenant, make_pool, est_bytes) hands the server a taskpool
    BUILDER: `make_pool(priority=, weight=)` must create (and may
    commit) a Taskpool on the server's context and return it without
    running it — the server runs it at admission time with the tenant's
    QoS stamped, tracks completion, destroys it at retirement, and
    pumps the tenant's queue.  Builders raising ResourceBusy re-queue.
    """

    def __init__(self, ctx, tenants: List[TenantConfig],
                 name: str = "serve", conformance: bool = True):
        self.ctx = ctx
        self.name = name
        # request-scope observability: every ticket gets a scope_id
        # stamped into its pool beside the QoS stamp; the registry folds
        # tenant SLO metrics + plan-vs-measured conformance.
        # conformance=False skips the per-pool plan pass
        # (prediction-free pools count against coverage).
        self.scope = ctx.scope_registry()
        self.conformance = bool(conformance)
        for t in tenants:
            self.scope.tenant(t.name, slo_ms=t.slo_ms,
                              burn_threshold=t.slo_burn)
        self._tenants: Dict[str, _TenantState] = {
            t.name: _TenantState(t) for t in tenants}
        # shared-resource counter providers (the engine registers its
        # PagePool prefix-cache + speculative-decode counters here so
        # they export through Context.stats()["serve"])
        self._resource_stats: Dict[str, Callable[[], dict]] = {}
        # advertisement providers: cheap snapshots folded into
        # advertise() — the engine registers its frozen-page key digest
        # here so a fleet view can predict warm-prefix hits without
        # scraping full stats()
        self._advertisers: Dict[str, Callable[[], object]] = {}
        # admission pricing: per-tenant SLO-burn pressure set by the
        # controller — a burning tenant's byte estimates inflate by
        # (1 + pressure), so its queue budget bites EARLIER and load
        # sheds before /healthz flips for the whole replica
        self._admission_pressure: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._retired: List[Ticket] = []
        self._closed = False
        self._preempts_retired = 0
        self._pump_thread = threading.Thread(
            target=self._pump_loop, daemon=True, name=f"ptc-{name}-pump")
        self._pump_thread.start()
        ctx._servers.append(self)

    # ------------------------------------------------------------ submit
    def add_tenant(self, cfg: TenantConfig):
        self.scope.tenant(cfg.name, slo_ms=cfg.slo_ms,
                          burn_threshold=cfg.slo_burn)
        with self._lock:
            self._tenants[cfg.name] = _TenantState(cfg)

    def register_resource_stats(self, name: str, fn: Callable[[], dict]):
        """Export a shared-resource counter snapshot (e.g. the KV
        PagePool's prefix-cache counters) under stats()[name]."""
        self._resource_stats[name] = fn

    def register_advertiser(self, name: str, fn: Callable[[], object]):
        """Fold `fn()` into advertise() under `name` — the engine
        registers its frozen-page key digest here."""
        self._advertisers[name] = fn

    def set_admission_pressure(self, tenant: str, pressure: float):
        """Install SLO-burn admission pricing for `tenant` (the
        controller's lever): subsequent submits see their byte estimates
        inflated by (1 + pressure), clamped to [0, 4].  Pressure ~0
        removes the entry (free admission).  Unknown tenants are
        ignored."""
        p = min(4.0, max(0.0, float(pressure)))
        with self._lock:
            if tenant not in self._tenants:
                return
            if p < 1e-3:
                self._admission_pressure.pop(tenant, None)
            else:
                self._admission_pressure[tenant] = p

    def admission_pressure(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._admission_pressure)

    def healthy(self) -> bool:
        """The /healthz verdict a fleet view polls: False once closed or
        when any tenant's SLO burn rate breached its threshold (the same
        condition that flips the metrics exporter to 503)."""
        if self._closed:
            return False
        slo = self.scope.slo_status()
        return not any(st.get("breached") for st in slo.values())

    def advertise(self) -> dict:
        """Cheap placement snapshot for a fleet view (the reference's
        MIGRATION.md schema, in the reference): occupancy scalars + the max tenant SLO
        burn rate + whatever digests the engine registered
        (register_advertiser), typically {"prefix": {"mode": "set",
        ...}} over the PagePool's frozen content keys."""
        with self._lock:
            active = sum(t.active for t in self._tenants.values())
            queued = sum(len(t.queue) for t in self._tenants.values())
            queued_bytes = sum(t.queued_bytes
                               for t in self._tenants.values())
            pressure = max(self._admission_pressure.values(), default=0.0)
        burn = 0.0
        for st in self.scope.slo_status().values():
            burn = max(burn, float(st.get("burn_rate") or 0.0))
        out = {
            "name": self.name,
            "healthy": self.healthy(),
            "active_pools": active,
            "queue_depth": queued,
            "queued_bytes": queued_bytes,
            "slo_burn_rate": round(burn, 4),
            "admission_pressure": round(pressure, 4),
        }
        for name, fn in self._advertisers.items():
            out[name] = fn()
        return out

    def _journal_rec(self, op: str, ticket):
        """Every admission decision is a durable journal record (type
        "serve") when the context carries a journal, so a postmortem can
        replay the front door without the process's memory."""
        jr = getattr(self.ctx, "_journal", None)
        if jr is None:
            return
        jr.record("serve", op=op, server=self.name,
                  tenant=ticket.tenant, scope_id=ticket.scope_id)

    def cancel(self, ticket: Ticket) -> bool:
        """Withdraw a still-QUEUED ticket (fleet re-placement off an
        unhealthy replica).  True = removed from its tenant's queue and
        marked terminal `cancelled` (counted, never silently dropped);
        False = already running or terminal — a decoding sequence is
        NEVER re-placed, per the fleet contract."""
        t = self._tenants.get(ticket.tenant)
        if t is None:
            return False
        with self._lock:
            if ticket.state != "queued":
                return False
            try:
                t.queue.remove(ticket)
            except ValueError:
                return False  # the pump loop popped it first
            t.queued_bytes -= ticket.est_bytes or 0
            t.counters["cancelled"] += 1
            ticket.state = "cancelled"
            ticket.done_t = time.monotonic()
            ticket._event.set()
        if ticket._owns_scope and ticket.scope_id is not None:
            # scope-side terminal: counts as a rejection (the router's
            # re-route counter pairs with it, so nothing is lost)
            self.scope.record_rejected(ticket.scope_id)
        self._journal_rec("cancel", ticket)
        if ticket._pool is not None:
            self._destroy_pool(ticket)  # planning pool never admitted
        return True

    def submit(self, tenant: str, make_pool: Callable, est_bytes: int = 0,
               meta=None, wait: bool = False,
               scope: Optional[int] = None,
               est_discount_bytes: int = 0) -> Ticket:
        """Submit one request DAG.  Returns its Ticket immediately
        (state "queued", "running" — admitted synchronously — or
        "rejected").  wait=True blocks for the terminal state and
        raises AdmissionError on rejection.

        `est_bytes` <= 0 means UNKNOWN.  When the tenant has a byte
        budget in force, an unknown estimate resolves to the tenant's
        `default_est_bytes`, or — when none is configured — the server
        builds the pool NOW and takes the static plan's working-set
        bound (`Taskpool.plan().est_bytes`); the built pool is reused at
        admission, never built twice.  A submission whose bytes cannot
        be bounded at all is REJECTED whenever the byte budget applies:
        the budget can never be evaded.

        `scope` attaches a caller-owned request scope (the inference
        engine allocates one per request): the server stamps it into
        the pool but does not retire it at pool completion.  Left None,
        the server allocates its own — pool completion is then the
        request's terminal state."""
        if self._closed:
            raise RuntimeError("server closed")
        t = self._tenants[tenant]
        ticket = Ticket(tenant, make_pool, est_bytes, meta)
        # prefix-cache admission discount: pages predicted to map onto
        # existing frozen pages are free to the pool, so the byte budget
        # charges only the cold tail.  Clamped to stay a KNOWN estimate.
        disc = max(0, int(est_discount_bytes or 0))
        ticket._est_discount = disc
        if disc and ticket.est_bytes is not None and ticket.est_bytes > 0:
            applied = min(disc, ticket.est_bytes - 1)
            ticket.est_bytes -= applied
            with self._lock:
                t.counters["discounted_bytes"] += applied
        # SLO-burn admission pricing: a burning tenant's KNOWN
        # estimates inflate by (1 + pressure), so max_queued_bytes sheds
        # its load first — applied after the prefix discount (the
        # discount models real pool bytes; pressure is pure pricing)
        with self._lock:
            pressure = self._admission_pressure.get(tenant, 0.0)
        if pressure > 0 and ticket.est_bytes is not None \
                and ticket.est_bytes > 0:
            infl = int(ticket.est_bytes * pressure)
            if infl:
                ticket.est_bytes += infl
                with self._lock:
                    t.counters["pressure_inflated_bytes"] += infl
        if scope is None:
            ticket.scope_id = self.scope.new_scope(tenant, meta=meta)
            ticket._owns_scope = True
        else:
            ticket.scope_id = int(scope)
        if (ticket.est_bytes is None or ticket.est_bytes <= 0) \
                and t.cfg.max_queued_bytes is not None:
            early = self._resolve_est(t, ticket)
            if early is not None:  # ResourceBusy / failure at build
                if wait and not ticket.terminal:
                    ticket.wait()
                return ticket
        admit_now = False
        with self._lock:
            t.counters["submitted"] += 1
            if t.active < t.cfg.max_pools and not t.queue and \
                    not t.blocked:
                admit_now = True
                t.active += 1  # reserve before dropping the lock
            elif self._can_queue(t, ticket):
                t.queue.append(ticket)
                t.queued_bytes += ticket.est_bytes or 0
            else:
                t.counters["rejected"] += 1
                ticket.state = "rejected"
                ticket.done_t = time.monotonic()
                ticket._event.set()
        if ticket.state == "rejected":
            self.scope.record_rejected(ticket.scope_id)
            self._journal_rec("reject", ticket)
            if ticket._pool is not None:
                self._destroy_pool(ticket)  # planning pool never admitted
        if admit_now:
            self._admit(t, ticket)
        if wait and not ticket.terminal:
            ticket.wait()
        if wait and ticket.state == "rejected":
            raise AdmissionError(
                f"tenant {tenant!r}: queue budget exceeded "
                f"(max_queue={t.cfg.max_queue}, "
                f"max_queued_bytes={t.cfg.max_queued_bytes}, "
                f"est_bytes={ticket.est_bytes})")
        return ticket

    def _can_queue(self, t: _TenantState, ticket: Ticket) -> bool:
        if len(t.queue) >= t.cfg.max_queue:
            return False
        if t.cfg.max_queued_bytes is not None:
            if ticket.est_bytes is None:  # unboundable: never evades
                return False
            if t.queued_bytes + ticket.est_bytes > t.cfg.max_queued_bytes:
                return False
        return True

    def _resolve_est(self, t: _TenantState, ticket: Ticket):
        """Resolve an UNKNOWN byte estimate while the tenant's byte
        budget is in force: per-tenant default first, else build the
        pool and take the static plan bound.  Returns None on success
        (ticket.est_bytes resolved, possibly to the None=unboundable
        sentinel) or the ticket when the build itself parked
        (ResourceBusy) or failed — submit returns it as-is then."""
        if t.cfg.default_est_bytes is not None:
            ticket.est_bytes = int(t.cfg.default_est_bytes)
            return None
        try:
            tp = ticket._make_pool(priority=t.cfg.priority,
                                   weight=t.cfg.weight)
        except ResourceBusy:
            with self._lock:
                t.counters["submitted"] += 1
                t.counters["resource_waits"] += 1
                t.queue.appendleft(ticket)
                t.blocked = True
            return ticket
        except Exception as e:
            # a failing pool factory fails the ticket: recorded, not raised
            with self._lock:
                t.counters["submitted"] += 1
                t.counters["failed"] += 1
            ticket.state = "failed"
            ticket.error = e
            ticket.done_t = time.monotonic()
            ticket._event.set()
            self.scope.record_done(ticket.scope_id, state="failed")
            return ticket
        ticket._pool = tp  # reused by _admit; destroyed on rejection
        # the reference's semantics: a plan that fails leaves the
        # estimate unbounded (rejected under the budget), never raises
        try:
            plan = tp.plan()
            # None = unbounded; predicted-shared pages discount here too
            ticket.est_bytes = plan.est_bytes(
                discount_bytes=ticket._est_discount)
            if self.conformance:
                ticket._plan = self.scope.plan_summary(plan)
        except Exception:
            ticket.est_bytes = None
        return None

    # --------------------------------------------------------- admission
    def _admit(self, t: _TenantState, ticket: Ticket):
        """Build + run one pool (caller already reserved t.active).
        Runs on the submitter or the pump thread, never on a worker."""
        try:
            tp = ticket._pool  # prebuilt at submit for the plan bound
            if tp is None:
                tp = ticket._make_pool(priority=t.cfg.priority,
                                       weight=t.cfg.weight)
        except ResourceBusy:
            with self._lock:
                t.active -= 1
                t.counters["resource_waits"] += 1
                t.queue.appendleft(ticket)
                t.queued_bytes += ticket.est_bytes or 0
                t.blocked = True
            return
        except Exception as e:
            # a failing pool factory fails the ticket: recorded, not raised
            with self._lock:
                t.active -= 1
                t.counters["failed"] += 1
            ticket.state = "failed"
            ticket.error = e
            ticket.done_t = time.monotonic()
            ticket._event.set()
            self.scope.record_done(ticket.scope_id, state="failed")
            return
        ticket._pool = tp
        ticket.admitted_t = time.monotonic()
        ticket.state = "running"
        # stamp the request scope beside the QoS stamp, mark admission
        # (the registry reads the native trace clock), and snapshot the
        # static plan predictions the conformance record compares
        # against at retirement
        if ticket.scope_id is not None:
            self.scope.stamp(tp, ticket.scope_id)
            self.scope.record_admitted(ticket.scope_id)
            if self.conformance and ticket._plan is None:
                # the reference swallows a failing plan (the pool then
                # counts as unplanned against conformance coverage)
                try:
                    ticket._plan = self.scope.plan_summary(tp.plan())
                except Exception:
                    ticket._plan = None
        with self._lock:
            t.counters["admitted"] += 1
            t.counters["queue_wait_ns"] += int(ticket.queue_wait_s * 1e9)
        self._journal_rec("admit", ticket)
        tp.on_complete(lambda: self._on_pool_complete(t, ticket))
        try:
            tp.run()
        except Exception as e:
            with self._lock:
                t.active -= 1
                t.counters["failed"] += 1
            ticket.state = "failed"
            ticket.error = e
            ticket.done_t = time.monotonic()
            ticket._event.set()
            self.scope.record_done(ticket.scope_id, state="failed")
            self._journal_rec("failed", ticket)

    def _on_pool_complete(self, t: _TenantState, ticket: Ticket):
        """Fires on the completing worker thread: only mark + wake the
        pump (pool destroy and queue pumping never run on workers)."""
        ticket.done_t = time.monotonic()
        failed = ticket._pool is not None and ticket._pool.nb_errors > 0
        with self._lock:
            t.active -= 1
            t.blocked = False
            if failed:
                t.counters["failed"] += 1
                ticket.state = "failed"
            else:
                t.counters["completed"] += 1
                ticket.state = "done"
            self._retired.append(ticket)
            self._wake.notify_all()
        self._journal_rec("failed" if failed else "done", ticket)
        # fold the pool's conformance record (plan predictions vs the
        # measured wall + the pool's QoS lane counters) while the native pool is still alive; the request
        # itself retires here only when the server owns the scope (an
        # engine-owned scope keeps decoding past its prefill pool)
        if ticket.scope_id is not None:
            qos = ticket._pool.qos_stats() \
                if ticket._pool is not None else None
            measured = None
            if ticket.admitted_t is not None:
                measured = {"wall_ns": int(
                    (ticket.done_t - ticket.admitted_t) * 1e9)}
            self.scope.record_pool_done(ticket.scope_id, qos=qos,
                                        plan=ticket._plan,
                                        measured=measured)
            if ticket._owns_scope:
                self.scope.record_done(ticket.scope_id,
                                       state=ticket.state)
        ticket._event.set()

    def notify_resources(self):
        """A shared resource (KV pages, sequence slots) was freed
        OUTSIDE pool completion (engine sequence retirement): unblock
        every ResourceBusy-paused tenant and wake the pump."""
        with self._lock:
            for t in self._tenants.values():
                t.blocked = False
            self._wake.notify_all()

    # -------------------------------------------------------------- pump
    def _pump_loop(self):
        while True:
            with self._lock:
                while not self._closed and not self._retired and \
                        not self._admittable_locked():
                    self._wake.wait(0.2)
                if self._closed:
                    return
                retired = self._retired
                self._retired = []
                batch = []
                for t in self._tenants.values():
                    while t.queue and not t.blocked and \
                            t.active < t.cfg.max_pools:
                        ticket = t.queue.popleft()
                        t.queued_bytes -= ticket.est_bytes or 0
                        t.active += 1
                        batch.append((t, ticket))
            for ticket in retired:
                self._destroy_pool(ticket)
            for t, ticket in batch:
                self._admit(t, ticket)

    def _admittable_locked(self) -> bool:
        return any(t.queue and not t.blocked and
                   t.active < t.cfg.max_pools
                   for t in self._tenants.values())

    def _destroy_pool(self, ticket: Ticket):
        tp = ticket._pool
        ticket._pool = None
        if tp is None:
            return
        # fold the pool's scheduler preempt evidence into the server's
        # lifetime counter before the rows disappear
        st = tp.qos_stats()
        if st:
            self._preempts_retired += st["preempts"]
        tp.destroy()

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Per-tenant + total admission counters (the serve namespace of
        Context.stats())."""
        with self._lock:
            tenants = {}
            totals = {"submitted": 0, "admitted": 0, "rejected": 0,
                      "completed": 0, "failed": 0, "resource_waits": 0,
                      "queue_depth": 0, "queued_bytes": 0,
                      "active_pools": 0, "cancelled": 0}
            for name, t in self._tenants.items():
                row = dict(t.counters)
                row["queue_depth"] = len(t.queue)
                row["queued_bytes"] = t.queued_bytes
                row["active_pools"] = t.active
                row["priority"] = t.cfg.priority
                row["weight"] = t.cfg.weight
                tenants[name] = row
                for k in totals:
                    totals[k] += row.get(k, 0)
            totals["preempts"] = self._preempts_retired + sum(
                p["preempts"] for p in self.ctx._qos_pool_rows())
        out = {"tenants": tenants, "totals": totals}
        # shared-resource counters (prefix cache, speculative decode)
        for name, fn in self._resource_stats.items():
            out[name] = fn()
        return out

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted request is terminal."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                busy = any(t.active or t.queue
                           for t in self._tenants.values()) or \
                    bool(self._retired)
            if not busy:
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.002)

    def close(self):
        """Stop the pump thread and destroy retired pools."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            retired = self._retired
            self._retired = []
            self._wake.notify_all()
        self._pump_thread.join(timeout=10)
        for ticket in retired:
            self._destroy_pool(ticket)
        if self in self.ctx._servers:
            self.ctx._servers.remove(self)
