"""Device prefetch lane: ahead-of-schedule h2d staging on the h2d stream.

The manager thread (cuda.py) drains ready device tasks into waves and
runs each wave as one launch; every input tile without a current device
mirror costs an h2d at dispatch time.  This lane takes that off the
critical path: it walks the runtime's ready-task lookahead through the
native `ptc_peek_ready` span API (tasks queued but not popped yet: ready,
every input final) and stages the NEXT waves' inputs on the device's h2d
stream while the current wave runs on the exec stream.  A wave whose
inputs were all prefetched dispatches with no h2d of its own.

Port of parsec_tpu/device/prefetch.py (reference analog: the CUDA
module's stage-in stream running ahead of the exec stream,
device_cuda_module.c:2197 ff).

Safety model:
  - `ptc_peek_ready` RETAINS every emitted copy under the queue lock, so
    the host bytes stay valid even if the wave is popped, run and its
    copies released mid-stage; the lane unpins every copy exactly once,
    exceptions included.
  - The bytes go host -> pinned staging buffer -> card (a `non_blocking`
    copy on the h2d stream) and the entry carries that copy's event: the
    launch that reads it makes the exec stream wait on it first.  The
    device tensor is allocated on the h2d stream and record_stream()ed
    for the exec stream.
  - Tiles are staged as RAW flat-uint8 mirrors (`_cache_put_prefetch`),
    reinterpreted at the first typed read: dtype and shape stay with the
    consumer, the lane needs neither.
  - Prefetch puts NEVER displace a cache entry (a dirty entry is newer
    truth; a clean one may be mid-read by the wave in flight), and a tile
    that has a current mirror anywhere in the context is skipped (its
    host bytes may be stale).
  - Budget is RESERVED before staging (`_prefetch_reserve`): the lane
    can evict clean tiles outside the lookahead to make room, never dirty
    ones; a failed reservation skips the tile, which is then staged on
    demand at dispatch.

Staging slots: the lane stages at most `slots` waves (of batch_max tasks
each) beyond the one executing.  A slot is a set of staged uids; it
recycles when every uid has been consumed (pf flag cleared by the first
stage-in) or has left the cache.

Each stage is traced as a DEVICE_H2D span (class -1, l0 = bytes, l1 =
the device's queue, aux 1: the lane), bracketing the host's copy into
pinned staging and the enqueue, as the reference's lane span does.

The reference lane also stages the wave compiler's chain hints
(`_stage_hints`); that compiler (device/fuse.py) is not ported, so the
device's `_pf_chain_hints` list stays empty and the lane stages the
peeked lookahead only.
"""
from __future__ import annotations

import ctypes as C
import threading
import time
import traceback
from typing import Optional

import numpy as np
import torch

from .. import _native as N


class _PrefetchLane:
    def __init__(self, dev, depth: int = 64, slots: int = 2):
        self.dev = dev
        self.depth = max(1, depth)
        self.slots_max = max(1, slots)
        self._buf = N.peek_buffer(self.depth)
        self._slots: list = []  # each: set of staged uids
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the last exception of a sweep: the lane is advisory and goes
        # on, but a caller that must know reads it (dev.prefetch_error)
        self.error: Optional[BaseException] = None

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ptc-cuda-prefetch")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    # ------------------------------------------------------------ loop
    def _loop(self):
        """Sweep whenever there is lookahead to stage.  Idle waits ride
        the device's wake event, so a setter (a remote delivery, once the
        comm engine is ported) gets a sweep now rather than at the end of
        the poll interval.  Sweeps that find nothing to stage back off,
        0.5 ms doubling to 8 ms: a sweep parses the whole lookahead in
        Python, and on a host-bound path whose tiles are all resident (a
        decode loop) back-to-back sweeps would take the interpreter from
        the manager for nothing."""
        dev = self.dev

        def wait(timeout: float) -> None:
            if dev._pf_wake.wait(timeout):
                dev._stats_add("prefetch_wakeups", 1)
            dev._pf_wake.clear()

        idle = 0
        with dev._device_ctx(), torch.no_grad():
            while not self._stop.is_set():
                try:
                    if N.lib.ptc_device_queue_depth(dev.ctx._ptr,
                                                    dev.qid) <= 0:
                        if dev._pf_pin:
                            with dev._lock:
                                dev._pf_pin = set()
                        wait(0.001)
                        continue
                    if self._free_slots() <= 0:
                        wait(0.0005)  # ahead by every slot: one frees soon
                    elif self._sweep():
                        idle = 0
                    else:
                        wait(0.0005 * (1 << idle))
                        idle = min(idle + 1, 4)
                except Exception as e:  # advisory: record, report, go on
                    self.error = e
                    traceback.print_exc()
                    time.sleep(0.01)

    def _free_slots(self) -> int:
        """Recycle slots whose every tile was consumed or dropped."""
        dev = self.dev
        with dev._lock:
            self._slots = [s for s in self._slots
                           if any((e := dev._cache.get(u)) is not None
                                  and e.pf for u in s)]
        return self.slots_max - len(self._slots)

    def _sweep(self) -> bool:
        """One lookahead pass: peek, publish the lookahead pin set, stage
        what fits the free slots.  Returns True if anything was staged
        (the loop sweeps again at once)."""
        dev = self.dev
        ctx = dev.ctx
        free = self._free_slots()
        if free <= 0:
            return False
        # every emitted copy_ptr is retained: unpinned exactly once below
        tasks = N.peek_ready(ctx._ptr, dev.qid, self._buf, self.depth)
        if not tasks:
            return False
        staged_any = False
        try:
            # lookahead pin set: everything the ready window will read,
            # published BEFORE staging so eviction and spill decisions
            # made during this sweep already prefer other tiles
            pin = set()
            uid_of = {}
            for _, recs in tasks:
                for cptr, _, _, _ in recs:
                    uid = uid_of.get(cptr)
                    if uid is None:
                        uid_of[cptr] = uid = dev._copy_uid(cptr)
                    pin.add(uid)
            with dev._lock:
                dev._pf_pin = pin
            # stage up to `free` waves' worth of tasks (batch_max each)
            budget_tasks = free * max(1, dev.batch_max)
            slot_uids = set()
            inflight = set().union(*self._slots) if self._slots else set()
            for _, recs in tasks[:budget_tasks]:
                if self._stop.is_set():
                    break
                for cptr, dptr, size, ver in recs:
                    uid = uid_of[cptr]
                    if uid in slot_uids or uid in inflight:
                        continue
                    # a CURRENT mirror anywhere in the context (the owner
                    # map covers siblings) serves the stage-in, and the
                    # host bytes may be older than it
                    q, v = ctx.device_get_data_owner(uid)
                    if q >= 0 and v == ver:
                        continue
                    if not dev._prefetch_reserve(size):
                        continue  # over budget: on-demand staging wins
                    try:
                        epoch = dev._host_epoch
                        t0 = time.perf_counter_ns()
                        dev._prof_h2d(0, size, -1, 1)
                        host = np.frombuffer(
                            (C.c_uint8 * size).from_address(dptr),
                            dtype=np.uint8, count=size)
                        arr, ev = dev._h2d_async(torch.from_numpy(host))
                        dev._prof_h2d(1, size, -1, 1)
                        dev._stats_add("prefetch_h2d_ns",
                                       time.perf_counter_ns() - t0)
                    except Exception:
                        dev._prefetch_unreserve(size)
                        raise
                    # the bytes crossed whether or not the stage is
                    # installed: h2d_bytes counts a refused (wasted) stage
                    # too, as its DEVICE_H2D span does
                    dev._stats_add("h2d_bytes", size)
                    if dev._cache_put_prefetch(uid, ver, arr, size, ev,
                                               epoch):
                        slot_uids.add(uid)
                        staged_any = True
            if slot_uids:
                self._slots.append(slot_uids)
        finally:
            for _, recs in tasks:
                for cptr, *_ in recs:
                    N.lib.ptc_copy_unpin(ctx._ptr, cptr)
        return staged_any
