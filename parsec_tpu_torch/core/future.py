"""Generic future/promise primitives for DSL bodies and user code.

Reference analog: the parsec future class hierarchy
(parsec/class/parsec_future.h:1-135 — base future with is_ready /
get_or_trigger / set, countable future completing after N sets;
parsec/class/parsec_future.c) and the datacopy future
(parsec/utils/parsec_datacopy_future.c — a future whose value is
materialized by a trigger callback on first demand and then shared by
every consumer).  The native runtime's memoized reshape cache
(native/core.cpp ptc_reshape_get) IS the datacopy-future for dep-typed
data; these classes are the user-facing primitives for everything else
(bodies coordinating out-of-band work, DTD helpers, tools).

concurrent.futures.Future exists, but its cancellation/executor protocol
is the wrong surface for task bodies; this is the reference's minimal
trigger-oriented contract on threading primitives.

Port of parsec_tpu/core/future.py, unchanged: it holds no JAX.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional


class Future:
    """Settable single-value future (parsec_base_future_t role).

    - `set(value)` resolves it (exactly once; later sets raise).
    - `get(timeout)` blocks until resolved; re-raises a failure set via
      `set_exception`.
    - `on_ready(cb)` runs cb(future) after resolution — immediately if
      already resolved (the reference's future_cb_fct chain).
    """

    __slots__ = ("_lock", "_cv", "_done", "_value", "_exc", "_cbs")

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._done = False
        self._value: Any = None
        self._exc: Optional[BaseException] = None
        self._cbs: List[Callable[["Future"], None]] = []

    def is_ready(self) -> bool:
        with self._lock:
            return self._done

    def set(self, value: Any = None):
        with self._lock:
            if self._done:
                raise RuntimeError("future already resolved")
            self._value = value
            self._done = True
            cbs, self._cbs = self._cbs, []
            self._cv.notify_all()
        for cb in cbs:
            cb(self)

    def set_exception(self, exc: BaseException):
        with self._lock:
            if self._done:
                raise RuntimeError("future already resolved")
            self._exc = exc
            self._done = True
            cbs, self._cbs = self._cbs, []
            self._cv.notify_all()
        for cb in cbs:
            cb(self)

    def get(self, timeout: Optional[float] = None) -> Any:
        with self._lock:
            if not self._cv.wait_for(lambda: self._done, timeout):
                raise TimeoutError("future not resolved within timeout")
            if self._exc is not None:
                raise self._exc
            return self._value

    def on_ready(self, cb: Callable[["Future"], None]):
        run_now = False
        with self._lock:
            if self._done:
                run_now = True
            else:
                self._cbs.append(cb)
        if run_now:
            cb(self)


class CountableFuture(Future):
    """Future that resolves after `count` contributions
    (parsec_countable_future_t: the nb_futures countdown).  Each
    `advance()` decrements; the last one resolves the future with the
    list of contributed values (in arrival order)."""

    __slots__ = ("_remaining", "_parts")

    def __init__(self, count: int):
        if count <= 0:
            raise ValueError("count must be positive")
        super().__init__()
        self._remaining = count
        self._parts: List[Any] = []

    def advance(self, value: Any = None):
        cbs = None
        with self._lock:
            if self._done:
                raise RuntimeError("future already resolved")
            self._parts.append(value)
            self._remaining -= 1
            if self._remaining > 0:
                return
            # resolve WITHOUT dropping the lock between the final
            # decrement and the done flip: a racing extra advance must
            # see _done and raise, not append to the resolved value
            self._value = self._parts
            self._done = True
            cbs, self._cbs = self._cbs, []
            self._cv.notify_all()
        for cb in cbs:
            cb(self)


class TriggeredFuture(Future):
    """Future whose value is materialized by `trigger()` on first demand
    and then memoized (the parsec_datacopy_future_t contract: many
    consumers, one conversion).  `get()` runs the trigger at most once
    across threads; concurrent getters block until it resolves."""

    __slots__ = ("_trigger", "_started")

    def __init__(self, trigger: Callable[[], Any]):
        super().__init__()
        self._trigger = trigger
        self._started = False

    def get(self, timeout: Optional[float] = None) -> Any:
        fire = False
        with self._lock:
            if not self._done and not self._started:
                self._started = True
                fire = True
        if fire:
            trigger, self._trigger = self._trigger, None  # fires once;
            # drop the closure so a captured source buffer is not pinned
            # for the resolved future's whole lifetime
            try:
                self.set(trigger())
            except BaseException as e:  # consumers see the failure
                self.set_exception(e)
        return super().get(timeout)
