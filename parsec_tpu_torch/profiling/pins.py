"""PINS: pluggable instrumentation modules at the runtime's event points.

Reference: the PINS MCA framework (parsec/mca/pins/pins.h:26-54) — small
instrumentation modules (task_counter, task_profiler, print_steals, papi,
alperf) chain callbacks onto task lifecycle points, selected by the
`--mca pins <list>` parameter.  Here the native core exposes one
synchronous sink at the trace event points (native ptc_set_pins_cb, fired
from ptc_prof_push/ptc_prof_instant with the 8-word event record); a
PinsChain fans it out to the registered Python modules.  Disabled cost is
one relaxed load + branch per event point; enabling does NOT require
tracing to be on (and vice versa).

Selection mirrors the reference: the MCA param `runtime.pins` (env
`PTC_MCA_runtime_pins`) holds a comma-separated module-name list applied
at Context init, or modules are attached explicitly with enable_pins().

Port of parsec_tpu/profiling/pins.py.  The CUDA device's manager and
lane threads push their DEVICE_DISPATCH, DEVICE_H2D and DEVICE_H2D_AHEAD
events (and the manager's DEVICE_WAIT/PLAN/COMPLETE, GC_PAUSE) through
the same sink, so a module's callback also runs on those threads (and
takes the interpreter lock there).  Device tasks emit no EXEC span, as
in the reference: TaskCounter, TaskProfiler and StragglerLog see only
host tasks.
"""
from __future__ import annotations

import ctypes as C
import resource
import threading
from typing import Dict, List, Optional, Type

from .. import _native as N
from .trace import (KEY_COMM_RECV, KEY_COMM_SEND, KEY_DEVICE, KEY_EXEC,
                    KEY_H2D, KEY_H2D_AHEAD, KEY_RELEASE, KEY_STREAM)

PINS_CB_T = N.PINS_CB_T


class PinsModule:
    """Base instrumentation module.  Override `mask` (bitmask of event
    keys to receive) and `on_event`.  on_event runs synchronously on
    worker/comm threads — keep it tiny and non-blocking.  Every native
    trace key is subscribable, including the device-pipeline keys
    (KEY_DEVICE dispatch waves, KEY_H2D dispatch-time staging,
    KEY_H2D_AHEAD staging off the dispatch path, KEY_STREAM
    progressive-serve d2h slices) — the device manager pushes
    them through the same ptc_prof_event sink the worker events use."""

    name = "module"
    mask = (1 << KEY_EXEC) | (1 << KEY_RELEASE) | (1 << KEY_COMM_SEND) | \
           (1 << KEY_COMM_RECV) | (1 << KEY_DEVICE)

    def on_event(self, key: int, phase: int, class_id: int, l0: int,
                 l1: int, worker: int, aux: int, t_ns: int) -> None:
        raise NotImplementedError


class TaskCounter(PinsModule):
    """Per-class executed-task counts (reference: mca/pins/task_counter)."""

    name = "task_counter"
    mask = 1 << KEY_EXEC

    def __init__(self):
        self.counts: Dict[int, int] = {}
        # events arrive concurrently from every worker thread; dict RMW
        # spans bytecodes, so a GIL switch between load and store would
        # lose increments without the lock
        self._lock = threading.Lock()

    def on_event(self, key, phase, class_id, l0, l1, worker, aux, t_ns):
        if phase == 1:
            with self._lock:
                self.counts[class_id] = self.counts.get(class_id, 0) + 1

    @property
    def total(self) -> int:
        return sum(self.counts.values())


class TaskProfiler(PinsModule):
    """Per-(worker, class) execution-time accumulation (reference:
    mca/pins/task_profiler)."""

    name = "task_profiler"
    mask = 1 << KEY_EXEC

    def __init__(self):
        self._open: Dict[tuple, int] = {}
        self.stats: Dict[int, dict] = {}  # class_id -> count/total/min/max
        self._lock = threading.Lock()  # see TaskCounter

    def on_event(self, key, phase, class_id, l0, l1, worker, aux, t_ns):
        sig = (worker, class_id, l0, l1)
        with self._lock:
            if phase == 0:
                self._open[sig] = t_ns
                return
            t0 = self._open.pop(sig, None)
            if t0 is None:
                return
            d = t_ns - t0
            s = self.stats.setdefault(
                class_id,
                {"count": 0, "total_ns": 0, "min_ns": d, "max_ns": d})
            s["count"] += 1
            s["total_ns"] += d
            s["min_ns"] = min(s["min_ns"], d)
            s["max_ns"] = max(s["max_ns"], d)


class CommVolume(PinsModule):
    """Bytes + message counts by direction (reference: mca/pins/alperf's
    bandwidth accounting; the check-comms oracle counts the same events)."""

    name = "comm_volume"
    mask = (1 << KEY_COMM_SEND) | (1 << KEY_COMM_RECV)

    def __init__(self):
        self.sent_msgs = 0
        self.sent_bytes = 0
        self.recv_msgs = 0
        self.recv_bytes = 0
        self._lock = threading.Lock()  # see TaskCounter

    def on_event(self, key, phase, class_id, l0, l1, worker, aux, t_ns):
        with self._lock:
            if key == KEY_COMM_SEND:
                self.sent_msgs += 1
                self.sent_bytes += aux
            else:
                self.recv_msgs += 1
                self.recv_bytes += aux


class PrintSteals(PinsModule):
    """Reports per-worker steal counts when the chain uninstalls
    (reference: mca/pins/print_steals).  The counts themselves are native
    (Scheduler.steals, ticked inside select) — this module is the
    report-at-teardown role, so it subscribes to no events."""

    name = "print_steals"
    mask = 0

    def on_event(self, *a):  # pragma: no cover - mask=0, never called
        pass

    def on_uninstall(self, ctx) -> None:
        steals = ctx.worker_steals()
        import sys
        sys.stderr.write(
            f"ptc [pins] print_steals: per-worker steals {steals} "
            f"(total {sum(steals)})\n")


class HwCounters(PinsModule):
    """Per-class OS hardware/software counters over task execution spans
    (reference: mca/pins/papi, which reads PAPI event sets at the same
    hook points).  Without PAPI, the portable equivalents are
    the per-THREAD rusage counters — user/system cpu-time, minor faults,
    voluntary + involuntary context switches — sampled at EXEC begin/end
    on the worker thread itself (RUSAGE_THREAD), so deltas attribute to
    exactly the sampled task.  Like the reference's papi module this is
    opt-in instrumentation: two getrusage syscalls per task (~1µs) — not
    for the ns/task hot-path benches."""

    name = "hwcounters"
    mask = 1 << KEY_EXEC

    def __init__(self):
        self._open: Dict[tuple, tuple] = {}
        # class_id -> [tasks, utime_us, stime_us, minflt, nvcsw, nivcsw]
        self.counters: Dict[int, list] = {}
        self._lock = threading.Lock()  # see TaskCounter

    @staticmethod
    def _sample():
        r = resource.getrusage(resource.RUSAGE_THREAD)
        return (int(r.ru_utime * 1e6), int(r.ru_stime * 1e6),
                r.ru_minflt, r.ru_nvcsw, r.ru_nivcsw)

    def on_event(self, key, phase, class_id, l0, l1, worker, aux, t_ns):
        sig = (worker, class_id, l0, l1)
        if phase == 0:
            with self._lock:
                self._open[sig] = self._sample()
            return
        now = self._sample()
        with self._lock:
            begin = self._open.pop(sig, None)
            if begin is None:
                return
            c = self.counters.setdefault(class_id, [0, 0, 0, 0, 0, 0])
            c[0] += 1
            for i in range(5):
                c[1 + i] += now[i] - begin[i]

    def report(self, class_names: Optional[Dict[int, str]] = None) -> str:
        rows = []
        with self._lock:
            items = sorted(self.counters.items())
        for cid, c in items:
            name = (class_names or {}).get(cid, f"class{cid}")
            rows.append(
                f"{name}: tasks={c[0]} utime={c[1]}us stime={c[2]}us "
                f"minflt={c[3]} vcsw={c[4]} ivcsw={c[5]}")
        return "\n".join(rows)

    def on_uninstall(self, ctx) -> None:
        import sys
        rep = self.report()
        if rep:
            sys.stderr.write("ptc [pins] hwcounters:\n" + rep + "\n")


class DeviceActivity(PinsModule):
    """Device-pipeline accounting at the PINS seam (the device pipeline's counters
    as a live instrumentation module): dispatch waves + lanes, h2d bytes
    split by lane (0 = dispatch-time stall, 1 = prefetch overlap), and
    progressive-serve d2h slices.  The same numbers Context.device_stats
    aggregates, but streamed per event — usable without tracing on."""

    name = "device_activity"
    mask = (1 << KEY_DEVICE) | (1 << KEY_H2D) | (1 << KEY_H2D_AHEAD) | \
        (1 << KEY_STREAM)

    def __init__(self):
        self.waves = 0
        self.lanes = 0
        self.stall_ns = 0          # DEVICE end-aux: dispatch h2d stall
        self.h2d_bytes = [0, 0]    # by lane: [dispatch-stall, prefetch]
        self.stream_slices = 0
        self.stream_bytes = 0
        self._lock = threading.Lock()  # see TaskCounter

    def on_event(self, key, phase, class_id, l0, l1, worker, aux, t_ns):
        with self._lock:
            if key == KEY_DEVICE:
                if phase == 1:
                    self.waves += 1
                    self.lanes += l0
                    self.stall_ns += aux
            elif key == KEY_H2D or key == KEY_H2D_AHEAD:
                if phase == 1:
                    self.h2d_bytes[1 if key == KEY_H2D_AHEAD else 0] += l0
            elif key == KEY_STREAM:
                if phase == 1:
                    self.stream_slices += 1
                    self.stream_bytes += l0


class StragglerLog(PinsModule):
    """Top-k slowest task executions (class, locals, worker, duration) —
    the drill-down companion to the always-on latency histograms: the
    histogram says a class's p99 moved, this module says WHICH task
    instances sat in the tail.  Bounded memory (a k-entry leaderboard),
    so it can stay installed on long serving runs."""

    name = "straggler_log"
    mask = 1 << KEY_EXEC

    def __init__(self, k: int = 16):
        self.k = int(k)
        self._open: Dict[tuple, int] = {}
        self.slowest: List[tuple] = []  # (dur_ns, class_id, l0, l1, worker)
        self._floor = 0  # admission threshold once the board is full
        self._lock = threading.Lock()  # see TaskCounter

    def on_event(self, key, phase, class_id, l0, l1, worker, aux, t_ns):
        sig = (worker, class_id, l0, l1)
        with self._lock:
            if phase == 0:
                self._open[sig] = t_ns
                return
            t0 = self._open.pop(sig, None)
            if t0 is None:
                return
            d = t_ns - t0
            if len(self.slowest) >= self.k and d <= self._floor:
                return
            self.slowest.append((d, class_id, l0, l1, worker))
            self.slowest.sort(reverse=True)
            del self.slowest[self.k:]
            self._floor = self.slowest[-1][0] \
                if len(self.slowest) >= self.k else 0

    def report(self, class_names: Optional[Dict[int, str]] = None) -> str:
        with self._lock:
            rows = list(self.slowest)
        return "\n".join(
            f"{(class_names or {}).get(cid, f'class{cid}')}({l0},{l1}) "
            f"worker={w} {d / 1e6:.3f} ms"
            for d, cid, l0, l1, w in rows)


REGISTRY: Dict[str, Type[PinsModule]] = {
    TaskCounter.name: TaskCounter,
    TaskProfiler.name: TaskProfiler,
    CommVolume.name: CommVolume,
    PrintSteals.name: PrintSteals,
    HwCounters.name: HwCounters,
    DeviceActivity.name: DeviceActivity,
    StragglerLog.name: StragglerLog,
}


class PinsChain:
    """The installed module chain for one Context (reference: the
    pins module linked list walked at each event point)."""

    def __init__(self, ctx, modules: List[PinsModule]):
        self._ctx = ctx
        self.modules = list(modules)
        mask = 0
        for m in self.modules:
            mask |= m.mask
        self._mask = mask

        def _cb(user, words):
            w = words[:8]
            for m in self.modules:
                if (m.mask >> w[0]) & 1:
                    try:
                        m.on_event(*w)
                    except Exception:
                        # exceptions cannot cross the ctypes boundary; a
                        # raising module must not mute the rest of the
                        # chain (same guard as Taskpool._register_call)
                        import traceback
                        traceback.print_exc()

        self._cb = PINS_CB_T(_cb)
        # the trampoline must outlive the context, not just this chain: a
        # worker that loaded the pointer right before an uninstall may
        # still invoke it (see ptc_set_pins_cb ordering note)
        if not hasattr(ctx, "_pins_keepalive"):
            ctx._pins_keepalive = []
        ctx._pins_keepalive.append(self._cb)
        N.lib.ptc_set_pins_cb(ctx._ptr, self._cb, None, mask)
        ctx._pins_on = True
        ctx._refresh_listening()

    def uninstall(self):
        # idempotent: a second call (explicit uninstall then Context
        # destroy) must not re-report or touch a freed native context
        if getattr(self, "_uninstalled", False):
            return
        self._uninstalled = True
        N.lib.ptc_set_pins_cb(self._ctx._ptr, C.cast(None, PINS_CB_T),
                              None, 0)
        self._ctx._pins_on = False
        self._ctx._refresh_listening()
        for m in self.modules:
            hook = getattr(m, "on_uninstall", None)
            if hook is not None:
                try:
                    hook(self._ctx)
                except Exception:
                    import traceback
                    traceback.print_exc()
        self._ctx._pins_chain = None

    def __getitem__(self, name: str) -> PinsModule:
        for m in self.modules:
            if m.name == name:
                return m
        raise KeyError(name)


def enable_pins(ctx, *modules) -> PinsChain:
    """Install instrumentation modules on a Context.  Accepts PinsModule
    instances or registry names; returns the chain (also stored on
    ctx._pins_chain for keep-alive)."""
    insts: List[PinsModule] = []
    for m in modules:
        if isinstance(m, str):
            if m not in REGISTRY:
                raise KeyError(f"unknown pins module {m!r}; "
                               f"have {sorted(REGISTRY)}")
            insts.append(REGISTRY[m]())
        else:
            insts.append(m)
    chain = PinsChain(ctx, insts)
    ctx._pins_chain = chain
    return chain


def enable_from_param(ctx, spec: str) -> Optional[PinsChain]:
    names = [s.strip() for s in spec.split(",") if s.strip()]
    if not names:
        return None
    return enable_pins(ctx, *names)
