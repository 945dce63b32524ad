"""Fault injection + failure-detection harness.

SURVEY.md §5 "Failure detection": the reference's whole story is the
chore protocol — a failing incarnation returns DISABLE, the device/chore
is disabled and the task respawns on the next incarnation
(parsec/scheduling.c:507-509, device_cuda_module.c:2757-2762); tasks out
of incarnations are dropped with a warning (scheduling.c:142-149).  The
survey flags the missing piece: a fault-injection harness to *test* those
paths (mandatory on TPU pods — preemptions, ICI link flaps).  This module
is that harness: wrap any task body to inject chore failures (DISABLE /
NEXT) or hard body errors at chosen invocations, then assert on the
runtime's recovery behavior.

COMM-LAYER faults (the chunk/stream soak knobs): the native comm thread
reads two env knobs at engine init —
  PTC_COMM_FAULT_RECV_MAX   cap every recv() to this many bytes, so
                            frames fragment at arbitrary boundaries
                            (short reads: the parser must reassemble no
                            matter where a chunk header splits)
  PTC_COMM_FAULT_DELAY_US   sleep this long before every recv(), skewing
                            the chunk window / watermark timing so
                            session races (a cross-wiring shape)
                            get hammered
  PTC_COMM_FAULT_DELAY_MAP  per-PEER recv delays, "rank:us,rank:us" —
                            overrides the global delay for those peers
                            only, so a flat in-process mesh emulates
                            latency-separated islands deterministically
                            (ptc-topo: the two-island soak and the RTT
                            auto-classing tests run on loopback)
`comm_fault_env()` builds the env dict; `apply_comm_faults()` applies it
to THIS process (call before Context.comm_init — the engine snapshots
the knobs once).

Port of parsec_tpu/utils/faults.py.
"""
import os
import threading
from typing import Callable, Dict, Mapping, Optional

from .._native import HOOK_DISABLE, HOOK_NEXT


def comm_fault_env(delay_us: int = 0, recv_max: int = 0,
                   delay_map: Optional[Mapping[int, int]] = None
                   ) -> Dict[str, str]:
    """Env dict arming the native comm engine's fault injection: a
    per-recv delay (µs) and/or a recv-size cap (bytes — short reads /
    frame fragmentation), plus an optional per-peer delay map
    ({peer_rank: µs}) that overrides the global delay for those peers —
    the ptc-topo island emulator.  Hand to a spawned rank's
    environment, or to apply_comm_faults() for this process."""
    env: Dict[str, str] = {}
    if delay_us:
        env["PTC_COMM_FAULT_DELAY_US"] = str(int(delay_us))
    if recv_max:
        env["PTC_COMM_FAULT_RECV_MAX"] = str(int(recv_max))
    if delay_map:
        env["PTC_COMM_FAULT_DELAY_MAP"] = ",".join(
            f"{int(r)}:{int(us)}" for r, us in sorted(delay_map.items()))
    return env


def island_delay_map(my_rank: int, topo, delay_us: int
                     ) -> Dict[int, int]:
    """The {peer: µs} delay map that makes a flat in-process mesh look
    like `topo` (comm/topology.py TopologyModel) from `my_rank`'s seat:
    every inter-island peer's recv is delayed by `delay_us`, intra-
    island peers stay fast.  Feed to comm_fault_env(delay_map=...) in
    each spawned rank — RTTs then cluster exactly as the RTT
    auto-classing expects."""
    return {r: int(delay_us) for r in range(topo.nranks)
            if r != my_rank and topo.class_of(my_rank, r) == "dcn"}


def apply_comm_faults(delay_us: int = 0, recv_max: int = 0,
                      delay_map: Optional[Mapping[int, int]] = None
                      ) -> None:
    """Arm comm fault injection for THIS process (before comm_init)."""
    os.environ.update(comm_fault_env(delay_us, recv_max, delay_map))


class InjectedFault(RuntimeError):
    """Raised by a wrapped body in 'error' mode (aborts the taskpool)."""


class FaultInjector:
    """Deterministic fault injection for chore bodies.

    mode:
      "disable"  fail like a broken device: the runtime disables this
                 chore for the whole class and retries the task on the
                 next incarnation (reference: PARSEC_HOOK_RETURN_DISABLE)
      "next"     fail this execution only; the task moves to its next
                 incarnation, the chore stays enabled (HOOK_RETURN_NEXT)
      "error"    raise InjectedFault: the body errors, the runtime aborts
                 the taskpool and waiters observe the failure
      "delay"    the body SLEEPS delay_s before running normally — the
                 stuck-task shape (a wedged accelerator call, a lost
                 lock) the health watchdog's adaptive k*p99 deadline
                 exists to catch.  The task still completes correctly,
                 so recovery assertions can run on the final result.
    at_invocation: fire on the k-th call of the wrapped body (0-based);
                   None = fire on every call.
    """

    def __init__(self, mode: str = "disable",
                 at_invocation: Optional[int] = None,
                 delay_s: float = 0.0):
        assert mode in ("disable", "next", "error", "delay"), mode
        self.mode = mode
        self.at_invocation = at_invocation
        self.delay_s = float(delay_s)
        self.calls = 0
        self.injected = 0
        self.executed = 0
        self._lock = threading.Lock()

    def _should_fire(self) -> bool:
        with self._lock:
            me = self.calls
            self.calls += 1
            fire = (self.at_invocation is None or
                    me == self.at_invocation)
            if fire:
                self.injected += 1
            else:
                self.executed += 1
            return fire

    def wrap(self, fn: Callable) -> Callable:
        def wrapped(view):
            if self._should_fire():
                if self.mode == "disable":
                    return HOOK_DISABLE
                if self.mode == "next":
                    return HOOK_NEXT
                if self.mode == "delay":
                    import time
                    time.sleep(self.delay_s)
                    return fn(view)
                raise InjectedFault("injected body failure")
            return fn(view)
        return wrapped
