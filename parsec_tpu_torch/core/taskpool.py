"""Taskpool: a DAG of task classes sharing globals (reference:
parsec_taskpool_t, parsec/parsec_internal.h:119-161).

Port of parsec_tpu/core/taskpool.py, with the static-analysis hooks
(verify, plan, tuned and remap runs and the devices' pre-run
plan_check)."""
from __future__ import annotations

import ctypes as C
import traceback
from typing import Callable, Dict, List, Optional

from .. import _native as N
from .context import Context
from .taskclass import TaskClass, TaskView


class Taskpool:
    def __init__(self, ctx: Context, globals: Optional[Dict[str, int]] = None,
                 priority: Optional[int] = None,
                 weight: Optional[int] = None):
        """`priority`/`weight` arm per-pool QoS scheduling (the serving
        runtime's tenant knobs): priority orders pools strictly under
        the lws scheduler — a higher-priority pool wins every select
        boundary (wave-boundary preemption; negative = background) —
        and weight stride-shares a priority tier.  Leaving both None
        keeps the pool on the default path (no QoS counters)."""
        self.ctx = ctx
        self.globals_map: Dict[str, int] = {}
        vals: List[int] = []
        for i, (k, v) in enumerate((globals or {}).items()):
            self.globals_map[k] = i
            vals.append(int(v))
        arr = (C.c_int64 * max(1, len(vals)))(*vals)
        self._ptr = N.lib.ptc_tp_new(ctx._ptr, len(vals), arr)
        self.classes: List[TaskClass] = []
        self._by_name: Dict[str, TaskClass] = {}
        self._committed = False
        self._destroyed = False
        self.qos_priority: Optional[int] = None
        self.qos_weight: Optional[int] = None
        if priority is not None or weight is not None:
            self.qos_priority = int(priority or 0)
            self.qos_weight = max(1, int(weight if weight is not None
                                         else 1))
            N.lib.ptc_tp_set_qos(self._ptr, self.qos_priority,
                                 self.qos_weight)
        ctx._track_taskpool(self)

    def set_scope(self, scope_id: int):
        """Stamp the request-scope id this pool serves (0 = unscoped;
        profiling/scope.py)."""
        N.lib.ptc_tp_set_scope(self._ptr, int(scope_id))

    # ------------------------------------------------------------- building
    def add(self, tc: TaskClass) -> TaskClass:
        if self._committed:
            raise RuntimeError("taskpool already committed")
        tc.id = len(self.classes)
        self.classes.append(tc)
        self._by_name[tc.name] = tc
        return tc

    def task_class(self, name: str) -> TaskClass:
        return self.add(TaskClass(name))

    def class_by_name(self, name: str) -> TaskClass:
        return self._by_name[name]

    def _register_call(self, fn: Callable) -> int:
        """Register an inline-expression callback (JDF %{...%} analog)."""
        globals_names = list(self.globals_map)

        def _cb(user, locals_ptr, nb_locals, globals_ptr):
            locs = [locals_ptr[i] for i in range(nb_locals)]
            globs = {n: globals_ptr[i] for i, n in enumerate(globals_names)}
            try:
                return int(fn(locs, globs))
            except Exception:
                traceback.print_exc()
                return 0

        return self.ctx.register_expr_cb(_cb)

    def _register_body(self, tc: TaskClass, fn: Callable) -> int:
        def _cb(user, task_ptr):
            try:
                r = fn(TaskView(task_ptr, tc, self))
                # bool is an int subclass; True must not become HOOK_AGAIN
                if isinstance(r, int) and not isinstance(r, bool):
                    return r
                return N.HOOK_DONE
            except Exception:
                traceback.print_exc()
                return N.HOOK_ERROR

        return self.ctx.register_body_cb(_cb)

    def commit(self) -> "Taskpool":
        """Compile every class spec and register with the native core."""
        if self._committed:
            return self
        self._committed = True
        for tc in self.classes:
            spec = tc.compile(self)
            arr = (C.c_int64 * len(spec))(*spec)
            cid = N.lib.ptc_tp_add_class(self._ptr, tc.name.encode(), arr,
                                         len(spec))
            if cid != tc.id:
                raise RuntimeError(
                    f"class id mismatch for {tc.name}: {cid} != {tc.id}")
        return self

    # ------------------------------------------------------------- running
    def verify(self, mode="error", max_instances: int = 200_000):
        """Run the static dataflow verifier (analysis.verify, the
        V-rules) over this pool's task-class tables.  mode="error" (or
        True) raises VerifyError on error-severity findings; mode="warn"
        prints the report to stderr instead.  Returns the Report."""
        import sys

        from ..analysis import VerifyError, verify_taskpool
        report = verify_taskpool(self, max_instances=max_instances)
        if report.errors and mode in (True, "error", "raise"):
            raise VerifyError(report)
        if report.findings and mode == "warn":
            print(report.text(), file=sys.stderr)
        return report

    def plan(self, max_instances: Optional[int] = None, cost=None,
             econ=None, workers: Optional[int] = None):
        """Run the static resource & schedule analyzer (analysis/plan.py)
        over this pool's task-class tables — nothing executes.  Returns
        a Plan: per-rank peak tile residency (no-eviction working set +
        interval-liveness floor), the wave decomposition, per-(src, dst)
        comm volume split eager/rdv, and the critical-path/work
        makespan lower bounds.  `cost` defaults to the context's live
        per-class latency histograms when they carry samples
        (CostModel.from_context), else a uniform model."""
        from ..analysis.plan import plan_taskpool
        return plan_taskpool(self, max_instances=max_instances,
                             cost=cost, econ=econ, workers=workers)

    def run(self, verify=None, tuned=None, remap=None) -> "Taskpool":
        """commit + add to context + start (convenience).

        `remap=` opts into topology-aware rank remapping: True runs this
        pool's plan traffic matrix through Plan.remap_ranks() against
        the process TopologyModel and installs the winning rank_of
        permutation via ctx.set_rank_map() before anything schedules (a
        no-op when the search keeps the identity, as it always does on
        one rank); an explicit list installs that permutation directly.
        The applied permutation (or None) is `self.remap_applied`.

        `verify=` opts into the static dataflow verifier at insert time:
        "error"/True raises VerifyError before anything is scheduled
        when a V-rule error-severity finding exists; "warn" prints
        findings and proceeds.

        `tuned=` opts into the autotuner's persisted knob vectors
        (analysis/tune.py): True looks up the winner recorded for this
        pool's (graph signature, host fingerprint) — a no-op when none
        exists — and a dict names a vector directly.  Every knob this
        package acts on is read when the Context or CudaDevice is
        created, so the vector must already be in force on this pool's
        runtime (created under analysis.tune.apply_knobs(vector)): the
        run raises ValueError where it is not, and otherwise records
        the vector as `self.tuned_applied` (None when there is none).

        With device.plan_check armed (warn|error), every attached device
        runs its pre-run residency check before the pool schedules:
        predicted device peak against its byte budget (see
        CudaDevice.plan_check); error mode raises PlanCheckError before
        the pool is committed."""
        self.remap_applied = None
        if remap is not None and remap is not False:
            perm = remap if isinstance(remap, (list, tuple)) \
                else self.plan().remap_ranks()
            perm = list(perm)
            if perm != list(range(len(perm))):
                self.ctx.set_rank_map(perm)
                self.remap_applied = perm
        knobs = None
        if tuned:
            from ..analysis.tune import check_tuned, resolve_tuned
            knobs = resolve_tuned(self, tuned)
            if knobs is not None:
                check_tuned(self.ctx, knobs)
        self.tuned_applied = knobs
        return self._run_inner(verify)

    def _run_inner(self, verify) -> "Taskpool":
        if verify:
            self.verify(mode=verify)
        from ..utils import params as _mca
        pc_mode = _mca.get("device.plan_check")
        if pc_mode and pc_mode != "off" and self.classes:
            for dev in list(self.ctx._devices):
                dev.plan_check(self, mode=pc_mode)
        self.commit()
        rc = N.lib.ptc_context_add_taskpool(self.ctx._ptr, self._ptr)
        if rc != 0:
            raise RuntimeError("ptc_context_add_taskpool failed")
        return self

    def wait(self):
        rc = N.lib.ptc_tp_wait(self._ptr)
        if rc != 0:
            raise RuntimeError(
                "taskpool aborted: a task body failed (see stderr)")

    @property
    def scope_id(self) -> int:
        return int(N.lib.ptc_tp_scope(self._ptr))

    @property
    def tp_id(self) -> int:
        """Distributed taskpool id (assigned at add; -1 before)."""
        return N.lib.ptc_tp_id(self._ptr)

    def qos_stats(self) -> Optional[Dict[str, int]]:
        """Per-pool QoS counters, or None when QoS is not armed:
        scheduled/selected tasks through the lws lanes, executed tasks
        (any scheduler), lane wait nanoseconds, current queue depth, and
        wave preemptions this pool won over a lower-priority lane."""
        buf = (C.c_int64 * 8)()
        n = N.lib.ptc_tp_qos_stats(self._ptr, buf, 8)
        if n < 8:
            return None
        return {"priority": buf[0], "weight": buf[1], "scheduled": buf[2],
                "selected": buf[3], "executed": buf[4], "wait_ns": buf[5],
                "queued": buf[6], "preempts": buf[7]}

    @property
    def nb_tasks(self) -> int:
        return N.lib.ptc_tp_nb_tasks(self._ptr)

    @property
    def nb_total_tasks(self) -> int:
        return N.lib.ptc_tp_nb_total_tasks(self._ptr)

    @property
    def nb_errors(self) -> int:
        """Failed/dropped tasks (nonzero after an abort)."""
        return N.lib.ptc_tp_nb_errors(self._ptr)

    def addto_nb_tasks(self, delta: int) -> int:
        """Adjust the pending-task count from a body or a user hook
        (reference: tdm.module->taskpool_addto_nb_tasks — lets a DAG retire
        tasks that will never become ready, tests/dsl/ptg/choice).  Returns
        the new count."""
        return N.lib.ptc_tp_addto_nb_tasks(self._ptr, delta)

    @property
    def dense_classes(self) -> int:
        """Task classes whose dependency tracking runs on the dense-array
        engine (auto-chosen; reference: parsec_internal.h:201-216)."""
        return N.lib.ptc_tp_dense_classes(self._ptr)

    def drain(self) -> bool:
        """Block until every task counted so far has completed, without
        closing the pool (insertion may continue — reference:
        parsec_dtd_data_flush wait-for-writers semantics).  Returns False
        if the pool already completed/aborted instead."""
        return N.lib.ptc_tp_drain(self._ptr) == 0

    def set_open(self, open_: bool):
        """Hold the pool open (DTD insertion): it cannot complete while
        open, however many of its tasks have run."""
        N.lib.ptc_tp_set_open(self._ptr, 1 if open_ else 0)

    def on_complete(self, fn: Callable[[], None]):
        """Fire fn() exactly once when this taskpool completes (reference:
        tp->on_complete, the seam parsec_compose and recursive tasks build
        on — parsec/compound.c, parsec/recursive.h).  Runs on the
        completing thread; must not block on this pool.  Multiple
        registrations chain: every fn fires, in registration order."""
        fns = getattr(self, "_complete_fns", None)
        if fns is not None:
            fns.append(fn)
            return
        self._complete_fns = [fn]

        def _cb(user, tp_ptr):
            for f in list(self._complete_fns):
                try:
                    f()
                except Exception:
                    traceback.print_exc()

        cb = N.TP_COMPLETE_CB_T(_cb)
        self._complete_cb = cb  # keep-alive
        N.lib.ptc_tp_set_on_complete(self._ptr, cb, None)

    def destroy(self):
        if self._destroyed:
            return
        # the native free must not race a monitor thread reading this
        # pool's qos_stats/tp_id (Context._qos_pool_rows holds the same
        # lock for its whole walk)
        with self.ctx._tp_lock:
            if self._destroyed:
                return
            self._destroyed = True
            if self.nb_errors > 0:
                # an aborted pool completes while tasks it released
                # before the abort may still sit on a worker or a device
                # queue (a failed wave's other lanes among them), and
                # each reaches the native pool when it runs: the pool
                # stays allocated, and tracked so that its callbacks
                # live, until the context ends
                return
            self.ctx._untrack_taskpool_locked(self)
            N.lib.ptc_tp_destroy(self._ptr)
