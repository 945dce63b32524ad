"""Sequential taskpool composition + recursive (nested-taskpool) tasks.

Reference analogs (SURVEY.md §2.4):
  - parsec_compose (parsec/compound.c:25-95): a compound runs its member
    taskpools strictly one after another, chained by on_complete callbacks;
    the whole compound looks like one taskpool to the caller.
  - parsec_recursivecall (parsec/recursive.h:30-80): a task body spawns a
    nested taskpool over sub-tiled data, returns ASYNC, and is completed by
    the inner pool's completion callback — hierarchical/recursive
    parallelism (the PARSEC_DEV_RECURSIVE device type's job).
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from .. import _native as N
from .taskpool import Taskpool


class Compound:
    """Run member taskpools sequentially (each starts when the previous
    completes), presenting the Taskpool run/wait surface."""

    def __init__(self, *pools: Taskpool):
        if not pools:
            raise ValueError("compose needs at least one taskpool")
        self.pools = list(pools)
        ctx = self.pools[0].ctx
        if any(p.ctx is not ctx for p in self.pools):
            raise ValueError("all composed taskpools must share one context")
        self.ctx = ctx
        self._started = False
        self._done = threading.Event()
        self._failed_at: Optional[int] = None

    def then(self, pool: Taskpool) -> "Compound":
        if self._started:
            raise RuntimeError("compound already started")
        self.pools.append(pool)
        return self

    def run(self) -> "Compound":
        """Commit every pool, chain completions, start the first.  The
        chain callback adds pool i+1 before pool i's active count drops,
        so Context.wait() stays blocked across the seams.  A pool that
        aborts (task failure) stops the chain: later pools never start and
        wait() raises."""
        if self._started:
            return self
        self._started = True
        for p in self.pools:
            p.commit()
        for i, p in enumerate(self.pools):
            nxt = self.pools[i + 1] if i + 1 < len(self.pools) else None

            def _chain(i=i, p=p, nxt=nxt):
                if N.lib.ptc_tp_nb_errors(p._ptr) > 0:
                    self._failed_at = i
                    self._done.set()
                elif nxt is None:
                    self._done.set()
                else:
                    N.lib.ptc_context_add_taskpool(nxt.ctx._ptr, nxt._ptr)

            p.on_complete(_chain)
        rc = N.lib.ptc_context_add_taskpool(self.ctx._ptr, self.pools[0]._ptr)
        if rc != 0:
            raise RuntimeError("ptc_context_add_taskpool failed")
        return self

    def wait(self):
        if not self._started:
            raise RuntimeError("compound not started")
        self._done.wait()
        if self._failed_at is not None:
            raise RuntimeError(
                f"compound aborted: taskpool {self._failed_at} failed "
                f"(see stderr); later pools were not started")
        self.pools[-1].wait()

    @property
    def nb_total_tasks(self) -> int:
        return sum(p.nb_total_tasks for p in self.pools)


def compose(*pools: Taskpool) -> Compound:
    """compose(tp1, tp2, ...): sequential composition (reference:
    parsec_compose chains two pools; this takes any number)."""
    return Compound(*pools)


def recursive_call(view, inner: Taskpool,
                   on_done: Optional[Callable[[], None]] = None) -> int:
    """From inside a task body: launch `inner` (a committed-or-not taskpool
    over sub-tiles of this task's data) and complete this task when it
    finishes.  Returns HOOK_ASYNC — return this from the body:

        def body(t):
            inner = build_potrf(ctx, subtiles_of(t))
            return recursive_call(t, inner)

    Reference: parsec_recursivecall (parsec/recursive.h:44-80) — same
    protocol: set inner completion callback, add inner pool, return ASYNC.
    """
    ctx = inner.ctx
    task_ptr = view._ptr

    def _done():
        if N.lib.ptc_tp_nb_errors(inner._ptr) > 0:
            # inner aborted: fail the generator task (its outputs are
            # garbage) so the OUTER pool aborts too instead of consuming it
            N.lib.ptc_task_fail(ctx._ptr, task_ptr)
            return
        try:
            if on_done is not None:
                on_done()
            ctx.task_complete(task_ptr)
        except Exception:
            import traceback
            traceback.print_exc()
            N.lib.ptc_task_fail(ctx._ptr, task_ptr)

    inner.on_complete(_done)
    inner.run()
    return N.HOOK_ASYNC
