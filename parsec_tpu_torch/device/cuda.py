"""CUDA device module: runs device chores as kernels on one card.

Port of parsec_tpu/device/tpu.py (reference analog: the CUDA device
module, parsec/mca/device/cuda/device_cuda_module.c):

  - the native core pushes device-chore tasks onto a device queue
    (PTC_BODY_DEVICE -> ASYNC); a manager thread drains it
    (device_cuda_module.c:2563-2589)
  - a drain groups the ready tasks by class, and each group is ONE kernel
    launch with the lane dimension written out: every read flow arrives
    as a [lanes, *tile] tensor, and a flow that every lane reads
    identically is passed once, as a lane-stride-0 view.  This replaces
    the reference's jit(vmap(kernel)) executables
  - device-resident dataflow: results stay on the card as dirty mirrors
    in a uid-keyed, versioned LRU; successors consume them from device
    memory.  The host copy is written (a) by the writeback lane for
    flows declared sync_mem_out, one stacked d2h per launch's output
    stack, (b) at flush(), same-shape mirrors grouped into stacked d2h
    copies, (c) on a host read (TaskView.data and the native copy-sync
    callback), (d) by an out-of-core spill, or (e) never, if the copy
    dies first
  - three CUDA streams per device, ordered by events: h2d copies run on
    the h2d stream, kernels on the exec stream, d2h copies on the d2h
    stream.  Every cache entry carries the event after which its bytes
    are valid (the h2d copy's, or the launch's that wrote it); a launch
    waits on the events of the entries it reads, and every d2h on its
    producer's.  A tensor allocated on one stream and used on another
    is record_stream()ed for the user, so the caching allocator cannot
    hand its memory out while that stream still reads it.  A task
    completes once its kernel is enqueued
  - the prefetch lane (device/prefetch.py) peeks the ready tasks still
    queued and stages their inputs on the h2d stream while the current
    wave runs; the residency planner reserves budget for it, prefers to
    evict tiles outside the lookahead, and, when dirty mirrors exceed
    the budget, spills them through the writeback lane (out-of-core)
  - speculative epilogues (attach_epilogue): the lane of a wave whose
    output is the next input of a declared consumer class runs that
    class's kernel right after the wave's launch; the consumer task
    then completes from the parked result, version-checked

A failing kernel fails its tasks (ctx.task_fail) and so the pool: there
is no silent fallback to another path.

Trace spans (profiling/trace.py; recorded when ctx.profile_enable is on,
from the manager and lane threads, as worker -1):
  - DEVICE_DISPATCH around each launch (_run_lanes): class = the task
    class id (-1 for a DTD body), l0 = lanes, l1 = the device's queue;
    the END's aux = the launch's dispatch-time h2d stall in ns, the same
    nanoseconds stats["h2d_stall_ns"] counts for it
  - DEVICE_H2D around each dispatch-time staging (_h2d): l0 = bytes,
    l1 = the queue, class = the dispatching task's request scope or -1,
    aux 0; and around each stage off the dispatch path (the prefetch
    lane; _h2d_ahead: stage_collection, the panel DAGs' index segments):
    class -1, aux 1.  Every byte stats["h2d_bytes"] counts is in one
    of these spans.
Both bracket what the HOST does, as the reference's spans do: from the
start of the copy into pinned staging (or of the launch's staging) to
the asynchronous enqueue.  The copies and kernels themselves run on the
card's streams after the span ends; torch.profiler times those.

`CudaDevice(ctx)` runs on the card and raises where there is none;
`CudaDevice(ctx, device="cpu")` runs the same module with torch CPU
tensors, where each kernel wrapper takes its plain PyTorch version and
the streams are None.
"""
from __future__ import annotations

import contextlib
import os
import queue
import sys
import threading
import time
import traceback
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _native as N
from ..core.context import Context
from ..core.taskclass import Mem, TaskClass, TaskView
from ..core.taskpool import Taskpool
from ..dsl.dtd import DtdView
from ..profiling.trace import KEY_DEVICE, KEY_H2D
from ..utils import params as _knobs
from .prefetch import _PrefetchLane

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
}

# largest stacked d2h of one flush/spill chunk: two chunks are in flight
# (one on the copy engine, one landing in its host buffers), so this
# bounds the pinned staging and the device gather stack a write-back holds
_D2H_CHUNK = 256 << 20


class _DeviceBody:
    """A device chore: the kernel and its flows.  A PTG class body (`tc`
    set) is keyed by (pool, class) and its flows are named; a DTD task's
    body (`tc` None) is keyed by the task's tag, its flows are argument
    indices (`nb_flows` of them), its kernel takes and returns single
    tiles, and it runs one task per launch."""

    def __init__(self, kernel: Callable, reads: Sequence,
                 writes: Sequence, shapes: Dict, dtypes: Dict,
                 tc: Optional[TaskClass], tp: Optional[Taskpool],
                 nb_flows: int = 0, batch: bool = True):
        self.kernel = kernel
        self.reads = list(reads)
        self.writes = list(writes)
        self.shapes = shapes
        self.dtypes = dtypes
        self.tc = tc
        self.tp = tp
        self.nb_flows = nb_flows
        self.batch = batch  # kernel is elementwise over lanes
        # speculative epilogue: this class is its source (epilogue) or
        # its destination (spec_src); see CudaDevice.attach_epilogue
        self.epilogue: Optional["_Epilogue"] = None
        self.spec_src: Optional["_Epilogue"] = None
        # flows whose output deps include a memory writeback: their host
        # copy must be coherent at completion (release_deps may memcpy it)
        self.mem_out_flows = set()
        if tc is not None:
            for fl in tc.flows:
                if fl.name in self.writes:
                    for d in fl.deps:
                        if d.direction == 1 and isinstance(d.target, Mem):
                            self.mem_out_flows.add(fl.name)

    @property
    def name(self) -> str:
        if self.tc is not None:
            return self.tc.name
        return f"dtd:{getattr(self.kernel, '__name__', 'kernel')}"

    def flow_index(self, f) -> int:
        return f if isinstance(f, int) else self.tc.flow_index(f)

    def make_view(self, task_ptr):
        if self.tc is not None:
            return TaskView(task_ptr, self.tc, self.tp)
        return DtdView(task_ptr, self.nb_flows)


class _Epilogue:
    """Speculative cross-class fusion config, attached to the SOURCE
    body (see CudaDevice.attach_epilogue)."""
    __slots__ = ("dst_bkey", "kernel", "pick", "dst_params", "ops",
                 "src_flow", "dst_in_flow")

    def __init__(self, dst_bkey, kernel, pick, dst_params, ops,
                 src_flow, dst_in_flow):
        self.dst_bkey = dst_bkey
        self.kernel = kernel
        self.pick = pick
        self.dst_params = dst_params
        self.ops = ops
        self.src_flow = src_flow
        self.dst_in_flow = dst_in_flow


def local_tile_index(coll) -> List[Tuple[int, int]]:
    """Row-major (m, n) list of this rank's stored local tiles."""
    out = []
    for m in range(coll.mt):
        for n in range(getattr(coll, "nt", 1)):
            if coll.rank_of(m, n) != coll.myrank:
                continue
            if not coll.stored(m, n):
                continue
            out.append((m, n))
    return out


# live devices, for copy-handle coherence sync.  Mirror uids come from ONE
# process-wide counter, so a uid names its device unambiguously; it starts
# high so that it never meets a handle stamped by the JAX package's device
# module in the same process.
_ALL_DEVICES: List["CudaDevice"] = []
_UID_LOCK = threading.Lock()
_UID_STATE = {"next": 1 << 40}


# one exec, one h2d and one d2h stream per card, shared by the devices
# built on it: the caching allocator keeps freed device blocks per stream,
# so a device built later on the card reuses its predecessors' memory
# instead of allocating (cudaMalloc) anew
_STREAMS: Dict[int, tuple] = {}


def _card_streams(dev: torch.device) -> tuple:
    with _UID_LOCK:
        streams = _STREAMS.get(dev.index)
        if streams is None:
            streams = tuple(torch.cuda.Stream(device=dev) for _ in range(3))
            _STREAMS[dev.index] = streams
        return streams


def _next_uid() -> int:
    with _UID_LOCK:
        u = _UID_STATE["next"]
        _UID_STATE["next"] += 1
        return u


def sync_copy_handle(handle: int) -> None:
    """Write the dirty device mirror of `handle` (if any) back to its host
    buffer.  Called by CPU-chore data views and, via the native copy-sync
    callback, by collection memcpys."""
    for dev in list(_ALL_DEVICES):
        dev.sync_handle(handle)


def maybe_sync_copy(cptr) -> None:
    """Coherence entry point for host-side reads of a task flow: no-op for
    copies no device ever staged (zero handle), dirty-mirror writeback
    otherwise."""
    h = N.lib.ptc_copy_handle(cptr)
    if h:
        sync_copy_handle(h)


class _CacheEnt:
    __slots__ = ("uid", "version", "arr", "nbytes", "dirty", "host",
                 "persistent", "stack", "idx", "raw", "event", "pf",
                 "spilling")

    def __init__(self, uid, version, arr, nbytes, dirty=False, host=None,
                 persistent=True, stack=None, idx=0, raw=False, event=None):
        self.uid = uid
        self.version = version
        self.arr = arr  # device tensor of the tile's shape (raw: flat uint8)
        self.nbytes = nbytes
        self.dirty = dirty  # device newer than host; host view kept to flush
        self.host = host
        # persistent: backed by user Data (host buffer cannot be freed
        # mid-flush); transient arena copies are never host-flushed
        self.persistent = persistent
        # lane stack this entry is row `idx` of: the stack stays alive (and
        # accounted, once per stack) until its last row entry dies
        self.stack = stack
        self.idx = idx
        # raw: staged by the prefetch lane as flat uint8 bytes; the first
        # typed read reinterprets it to the consumer's dtype and shape
        self.raw = raw
        # CUDA event after which the bytes are valid on the card (the h2d
        # copy's, or the launch's that wrote them); None on the CPU
        self.event = event
        # pf: staged ahead by the prefetch lane, not consumed yet (cleared,
        # and counted as a prefetch hit, at the first stage-in)
        self.pf = False
        # spilling: picked by the residency planner for an out-of-core
        # write-back + evict; whoever lands its d2h evicts it in the same
        # locked step, if it is still THIS object in the cache
        self.spilling = False


class CudaDevice:
    """One CUDA card (or, with device="cpu", the plain versions on the
    host) with a manager thread, a writeback lane and a prefetch lane.

    autostart=False leaves the threads unstarted until start(): tasks
    routed here stay queued (observable with ctx.device_peek).
    prefetch=None reads the device.prefetch knob."""

    def __init__(self, ctx: Context, device="cuda",
                 cache_bytes: Optional[int] = None, autostart: bool = True,
                 prefetch: Optional[bool] = None):
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CudaDevice: no CUDA device is available; pass "
                    "device='cpu' to run the plain versions on the host")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            # exec (kernels), h2d and d2h: three streams ordered by events
            self._stream, self._h2d_stream, self._d2h_stream = \
                _card_streams(dev)
        elif dev.type == "cpu":
            self._stream = self._h2d_stream = self._d2h_stream = None
        else:
            raise ValueError(f"CudaDevice: unsupported device {device!r}")
        self.device = dev
        self.ctx = ctx
        self.qid = ctx.device_queue_new()
        # max tasks fused into one launch, and a byte cap on one launch's
        # lane stacks (the count cap alone is blind to tile size)
        self.batch_max = int(os.environ.get("PTC_DEVICE_BATCH", "128"))
        self.batch_max_bytes = int(
            os.environ.get("PTC_DEVICE_BATCH_BYTES", str(2 << 30)))
        self.bodies: Dict[Tuple[int, int], _DeviceBody] = {}
        # DTD device tasks' bodies by task tag (register_dtd_task); each
        # is popped at its task's dispatch
        self._dtd_bodies: Dict[int, _DeviceBody] = {}
        self._tp_by_ptr: Dict[int, Taskpool] = {}
        # device-copy LRU keyed by uid (stamped into the native copy handle,
        # so freed/reused ptc_copy addresses can't alias — ABA guard)
        self._cache: "OrderedDict[int, _CacheEnt]" = OrderedDict()
        if cache_bytes is None:
            cache_bytes = int(_knobs.get("device.cache_bytes")) or 4 << 30
        self._cache_bytes = cache_bytes
        self._cache_used = 0
        # id(stack) -> [refcount, stack]; the strong ref keeps id() stable
        self._stacks: Dict[int, list] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # ---- device pipeline (prefetch lane + residency planner) ----
        if prefetch is None:
            prefetch = bool(_knobs.get("device.prefetch"))
        self._pf_enabled = prefetch
        self._pf_depth = max(1, int(_knobs.get("device.prefetch_depth")))
        self._pf_slots_max = max(1, int(_knobs.get("device.staging_slots")))
        self._ooc = bool(_knobs.get("device.out_of_core"))
        self._overcommit = max(1.0, float(_knobs.get("device.overcommit")))
        # uids of the current ready-task lookahead: eviction under
        # pressure prefers tiles OUTSIDE this set (they are not about to
        # be consumed), and the planner never spills into it
        self._pf_pin: set = set()
        # bytes the lane has reserved but not installed yet: reservations
        # keep it from staging the cache past budget and thrashing tiles
        # the executing wave still needs
        self._pf_reserved = 0
        self._pf_lane: Optional[_PrefetchLane] = None  # once started
        # wakes the lane's idle wait now instead of at its poll interval
        # (the comm engine's deliveries will set it; tests set it)
        self._pf_wake = threading.Event()
        # chain prefetch hints [(collection name, idx)] of the wave
        # compiler, which is not ported: it stays empty and the lane
        # stages the peeked lookahead only
        self._pf_chain_hints: list = []
        # bumped by every host-side overwrite of a mirrored copy: a lane
        # stage that began before one is discarded (it may have copied
        # the bytes being replaced)
        self._host_epoch = 0
        # the current launch's dispatch-time h2d stall (manager thread
        # only): reset at its DEVICE_DISPATCH begin, read at its end
        self._disp_stall_ns = 0
        # every key pre-populated: the dict never resizes after init, so a
        # concurrent info() copy cannot hit a changed-size error.  Names
        # follow the reference device module's stats.
        self.stats = {"tasks": 0, "h2d_bytes": 0, "d2h_bytes": 0,
                      "h2d_hits": 0, "evictions": 0, "dead_drops": 0,
                      "batches": 0, "batched_tasks": 0,
                      "invalidations": 0, "eager_gathers": 0,
                      "fused_flows": 0, "wb_tasks": 0, "f64_refused": 0,
                      "h2d_stall_ns": 0, "cache_peak_bytes": 0,
                      "d2d_bytes": 0,
                      "spec_store": 0, "spec_hits": 0, "spec_misses": 0,
                      # device pipeline (prefetch lane + residency planner)
                      "prefetch_staged": 0, "prefetch_bytes": 0,
                      "prefetch_hits": 0, "prefetch_misses": 0,
                      "prefetch_wasted": 0, "reserve_fails": 0,
                      "spills": 0, "spill_bytes": 0,
                      "prefetch_h2d_ns": 0, "ooc_waits": 0,
                      "prefetch_wakeups": 0}
        # chore name -> [launches, lanes]: one launch per kernel call of
        # the manager (epilogues included), written under self._lock
        self.launches: Dict[str, List[int]] = {}
        # parked speculative results: (dst body key, dst key) ->
        # (output stacks, src uid, src version); bounded by _spec_put
        self._spec: Dict[tuple, tuple] = {}
        # native hooks, ONE callback per context fanning out to all its
        # devices (a per-device registration would overwrite the slot)
        if getattr(ctx, "_copy_release_cb", None) is None:
            def _ctx_release(user, handle, _ctx=ctx):
                for d in list(_ctx._devices):
                    d._on_copy_released(user, handle)
            ctx._copy_release_cb = N.COPY_RELEASE_CB_T(_ctx_release)
            N.lib.ptc_set_copy_release_cb(ctx._ptr, ctx._copy_release_cb,
                                          None)
        # coherence pull: collection memcpys of a device-dirty copy write
        # the mirror back first
        if getattr(ctx, "_copy_sync_cb", None) is None:
            def _ctx_sync(user, handle, _ctx=ctx):
                for d in list(_ctx._devices):
                    d.sync_handle(handle)
            ctx._copy_sync_cb = N.COPY_SYNC_CB_T(_ctx_sync)
            N.lib.ptc_set_copy_sync_cb(ctx._ptr, ctx._copy_sync_cb, None)
        # host-written invalidation: the runtime just overwrote a copy's
        # host bytes — every device mirror of it is stale and must drop
        if getattr(ctx, "_copy_invalidate_cb", None) is None:
            def _ctx_inval(user, handle, _ctx=ctx):
                for d in list(_ctx._devices):
                    d._drop_mirror(handle)
                N.lib.ptc_device_clear_data_owner(_ctx._ptr, handle, -1)
            ctx._copy_invalidate_cb = N.COPY_INVALIDATE_CB_T(_ctx_inval)
            N.lib.ptc_set_copy_invalidate_cb(ctx._ptr,
                                             ctx._copy_invalidate_cb, None)
        ctx._devices.append(self)  # stopped before the native ctx dies
        _ALL_DEVICES.append(self)
        # writeback lane (reference: the CUDA stage-out stream,
        # device_cuda_module.c:2197): host coherence of sync-mem-out flows
        # and out-of-core spills run here, not in the dispatch loop; the
        # tasks complete from this lane once their host bytes are coherent
        self._wb_q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._wb_thread: Optional[threading.Thread] = None
        if autostart:
            self.start()

    # ------------------------------------------------------------ streams
    def _on_stream(self):
        """Context that makes this device's exec stream current (no-op on
        the CPU): kernels launch on the current stream."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _device_ctx(self):
        """Context that makes this device's card current (for the lanes'
        threads; no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.device(self.device)

    def _record(self, stream=None) -> Optional["torch.cuda.Event"]:
        """An event at the current end of `stream` (the exec stream by
        default); None on the CPU."""
        if self._stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(stream or self._stream)
        return ev

    def _await(self, *events) -> None:
        """Make the current stream wait on each event (no-op on the CPU
        and for None)."""
        if self._stream is None:
            return
        cur = torch.cuda.current_stream()
        seen = set()
        for ev in events:
            if ev is not None and id(ev) not in seen:
                seen.add(id(ev))
                cur.wait_event(ev)

    def _pinned(self, shape, dtype) -> torch.Tensor:
        """A host staging buffer: pinned on a card (the caching host
        allocator hands a block out again only after the copies recorded
        on it have completed), plain memory on the CPU."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self._stream is not None)

    def _h2d_async(self, src: torch.Tensor):
        """Start the copy of a host tensor to the device on the h2d stream
        and return (device tensor, the copy's event).  The bytes go
        through an OWNED pinned buffer first: an asynchronous copy from a
        view over native memory could read it after the copy died at its
        last consumer's completion.  The device tensor is allocated on the
        h2d stream and record_stream()ed for the exec stream, its reader.
        On the CPU: (an owned clone, None)."""
        if self._stream is None:
            return src.clone(), None
        stage = self._pinned(src.shape, src.dtype)
        stage.copy_(src)
        with torch.cuda.stream(self._h2d_stream):
            out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            out.copy_(stage, non_blocking=True)
            ev = self._record(self._h2d_stream)
        out.record_stream(self._stream)
        return out, ev

    def _prof_h2d(self, phase: int, nbytes: int, scope: int,
                  lane: int) -> None:
        """One DEVICE_H2D event: l0 = bytes, l1 = this device's queue,
        class = the request scope (-1: none), aux = the lane (0: a
        dispatch-time stall, 1: staged off the dispatch path)."""
        N.lib.ptc_prof_event(self.ctx._ptr, KEY_H2D, phase, scope, nbytes,
                             self.qid, lane)

    def _h2d(self, host: np.ndarray, scope: int = -1):
        """Dispatch-time h2d of one host array, for the exec stream: the
        copy runs on the h2d stream and the exec stream waits on its
        event.  Returns (device tensor, event).  The host's time from the
        copy into pinned staging to the enqueue is the launch's h2d stall
        (stats["h2d_stall_ns"], and its DEVICE_DISPATCH end's aux), traced
        as a DEVICE_H2D span whose class is the dispatching task's request
        scope (`scope`, -1: none)."""
        t0 = time.perf_counter_ns()
        self._prof_h2d(0, host.nbytes, scope, 0)
        out, ev = self._h2d_async(torch.from_numpy(host))
        if ev is not None:
            self._stream.wait_event(ev)
        self._prof_h2d(1, host.nbytes, scope, 0)
        stall = time.perf_counter_ns() - t0
        self._disp_stall_ns += stall
        with self._lock:
            self.stats["h2d_stall_ns"] += stall
            self.stats["h2d_bytes"] += host.nbytes
        return out, ev

    def _h2d_ahead(self, host: np.ndarray):
        """h2d of one host array off the dispatch path (the caller's
        thread: stage_collection, the panel DAGs' index segments, a check's
        read of a tile with no mirror), for the exec stream.  Counted in
        h2d_bytes and traced as a lane-1 DEVICE_H2D span, not as a
        launch's stall.  Returns (device tensor, event)."""
        self._prof_h2d(0, host.nbytes, -1, 1)
        out, ev = self._h2d_async(torch.from_numpy(host))
        self._prof_h2d(1, host.nbytes, -1, 1)
        self._stats_add("h2d_bytes", host.nbytes)
        if ev is not None:
            self._stream.wait_event(ev)
        return out, ev

    def _d2h_async(self, arrs: Sequence[torch.Tensor], events: Sequence):
        """Start ONE d2h of same-sized device tensors on the d2h stream,
        after each producer's event, into a pinned host stack; returns
        (host [len(arrs), n] tensor, the copy's event; None on the CPU).
        Several tensors are first gathered into one device stack there."""
        if self._stream is None:
            return torch.stack([a.reshape(-1) for a in arrs]), None
        with torch.cuda.stream(self._d2h_stream):
            self._await(*events)
            for a in arrs:
                a.record_stream(self._d2h_stream)
            src = arrs[0].reshape(1, -1) if len(arrs) == 1 else \
                torch.stack([a.reshape(-1) for a in arrs])
            host = self._pinned(src.shape, src.dtype)
            host.copy_(src, non_blocking=True)
            return host, self._record(self._d2h_stream)

    def _land(self, ent: _CacheEnt, row: torch.Tensor) -> None:
        """Write one landed d2h row (host uint8) into the entry's host
        buffer and mark the entry clean; an entry picked for a spill
        leaves the cache in the same locked step (so no eviction can take
        it clean in between and the spill go uncounted).  A torch copy,
        on the intra-op threads: a first write into fresh host pages is
        bound by their page faults, which threads take in parallel."""
        torch.from_numpy(ent.host.reshape(-1).view(np.uint8)).copy_(row)
        with self._lock:
            self.stats["d2h_bytes"] += row.numel()
            ent.dirty = False
            if ent.spilling:
                self._spilled_locked(ent)

    def _land_chunk(self, ents, host: torch.Tensor, ev) -> None:
        if ev is not None:
            ev.synchronize()
        rows = host.reshape(len(ents), -1).view(torch.uint8)
        for e, row in zip(ents, rows):
            self._land(e, row)

    def _write_back(self, ents: Sequence[_CacheEnt]) -> None:
        """Make dirty mirrors host-coherent: same-size mirrors grouped
        into stacked d2h copies of at most _D2H_CHUNK bytes, double-
        buffered (a chunk lands in its host buffers while the next one is
        on the copy engine)."""
        groups: Dict[tuple, list] = {}
        for e in ents:
            groups.setdefault((e.arr.dtype, e.arr.numel()), []).append(e)
        chunks = []
        for g in groups.values():
            per = max(1, _D2H_CHUNK // max(1, g[0].arr.nbytes))
            chunks += [g[i:i + per] for i in range(0, len(g), per)]
        inflight: deque = deque()
        for c in chunks:
            inflight.append((c, *self._d2h_async([e.arr for e in c],
                                                 [e.event for e in c])))
            if len(inflight) > 1:
                self._land_chunk(*inflight.popleft())
        while inflight:
            self._land_chunk(*inflight.popleft())

    # ------------------------------------------------------------ cache
    def _stats_add(self, key: str, n: int = 1) -> None:
        """Counter delta under the lock: stats are written from the
        manager thread, the writeback lane and host-read callers."""
        with self._lock:
            self.stats[key] += n

    def _copy_uid(self, cptr) -> int:
        with self._lock:
            h = N.lib.ptc_copy_handle(cptr)
            if h == 0:
                h = _next_uid()
                N.lib.ptc_copy_set_handle(cptr, h)
            return h

    def _charge(self, ent: _CacheEnt):
        """Account an entry's device bytes.  Rows of a lane stack charge
        the WHOLE stack exactly once (per-stack refcount): evicting one row
        of a live stack frees nothing, and the accounting must say so."""
        if ent.stack is not None:
            rec = self._stacks.get(id(ent.stack))
            if rec is None:
                self._stacks[id(ent.stack)] = [1, ent.stack]
                self._cache_used += ent.stack.nbytes
            else:
                rec[0] += 1
        else:
            self._cache_used += ent.nbytes
        if self._cache_used > self.stats["cache_peak_bytes"]:
            self.stats["cache_peak_bytes"] = self._cache_used

    def _uncharge(self, ent: _CacheEnt):
        if ent.stack is not None:
            key = id(ent.stack)
            rec = self._stacks.get(key)
            if rec is not None:
                rec[0] -= 1
                if rec[0] == 0:
                    del self._stacks[key]
                    self._cache_used -= ent.stack.nbytes
        else:
            self._cache_used -= ent.nbytes

    def _drop_mirror(self, uid: int) -> None:
        """Drop a mirror whose HOST bytes were just overwritten by the
        runtime (the host is authoritative now)."""
        with self._lock:
            self._host_epoch += 1
            ent = self._cache.pop(uid, None)
            if ent is not None:
                self._uncharge(ent)
                self.stats["invalidations"] += 1

    def _on_copy_released(self, user, handle):
        with self._lock:
            ent = self._cache.pop(handle, None)
            if ent is not None:
                self._uncharge(ent)
                self.stats["dead_drops"] += 1
        N.lib.ptc_device_clear_data_owner(self.ctx._ptr, handle, -1)

    def _evict_locked(self, evict) -> None:
        """Drop the (uid, entry) pairs the caller already uncharged
        (caller holds self._lock)."""
        for k, _ in evict:
            del self._cache[k]
            self.stats["evictions"] += 1
            N.lib.ptc_device_clear_data_owner(self.ctx._ptr, k, self.qid)

    def _cache_put(self, uid, version, arr, nbytes, dirty=False, host=None,
                   persistent=True, stack=None, idx=0, event=None):
        spill = []
        with self._lock:
            old = self._cache.pop(uid, None)
            if old is not None:
                self._uncharge(old)
            ent = _CacheEnt(uid, version, arr, nbytes, dirty, host,
                            persistent, stack, idx, event=event)
            self._cache[uid] = ent
            self._charge(ent)
            # affinity stamp: consumers of this copy at this version route
            # here (reference: parsec_get_best_device, device.c:100-117)
            N.lib.ptc_device_set_data_owner(self.ctx._ptr, uid,
                                            self.qid, version)
            # evict under pressure, oldest first: clean tiles OUTSIDE the
            # prefetch lookahead, then clean lookahead tiles (about to be
            # consumed: they would be staged again at once); dirty entries
            # never evict here (their device bytes are the only truth)
            for only_unpinned in (True, False):
                if self._cache_used <= self._cache_bytes:
                    break
                evict = []
                for k, e in self._cache.items():
                    if self._cache_used <= self._cache_bytes:
                        break
                    if e.dirty or k == uid:
                        continue
                    if only_unpinned and k in self._pf_pin:
                        continue
                    evict.append((k, e))
                    self._uncharge(e)
                self._evict_locked(evict)
            if self._ooc and self._cache_used > self._cache_bytes:
                spill = self._spill_pick_locked(uid)
        if spill:
            # out-of-core: the dirty mirrors are written back through the
            # writeback lane (host authoritative, mirror evicted, staged
            # again on demand) instead of pinning memory past the budget
            # until the card runs out (the panel-cyclic residency of the
            # TPU distributed-LA paper, arXiv:2112.09017)
            self._wb_q.put(("spill", [], spill))

    def _spill_pick_locked(self, new_uid: int) -> list:
        """Residency planner, out-of-core leg (caller holds self._lock):
        pick dirty mirrors to spill through the writeback lane until the
        projected usage is back under budget.  Only persistent
        (collection-backed) entries qualify — an arena host buffer can be
        freed by its last consumer while the d2h is in flight — and
        lookahead tiles are skipped (they are about to be consumed).  The
        picked entries are marked `spilling`, so one pressure wave cannot
        queue them twice.  A row of a lane stack frees nothing until its
        stack's last row goes (the stack is charged once), so it does not
        lower the projection, but it is spilled all the same."""
        picked, projected = [], self._cache_used
        for k, e in self._cache.items():
            if projected <= self._cache_bytes:
                break
            if (not e.dirty or e.spilling or not e.persistent
                    or e.host is None or k == new_uid
                    or k in self._pf_pin):
                continue
            e.spilling = True
            picked.append(k)
            projected -= e.nbytes if e.stack is None else 0
        return picked

    def _spilled_locked(self, ent: _CacheEnt) -> None:
        """Evict a host-coherent spill pick if it is still the cache's
        entry for its uid (a put of a newer version since the pick is
        left to its own pressure wave).  Caller holds self._lock."""
        if self._cache.get(ent.uid) is not ent:
            return
        del self._cache[ent.uid]
        self._uncharge(ent)
        self.stats["spills"] += 1
        self.stats["spill_bytes"] += int(ent.nbytes)
        N.lib.ptc_device_clear_data_owner(self.ctx._ptr, ent.uid, self.qid)

    def _spill(self, uids) -> None:
        """Writeback-lane half of the spill: write the picked mirrors back
        (grouped d2h); each is evicted as it lands (_land).  A pick made
        clean meanwhile (a flush) is evicted at once."""
        with self._lock:
            ents = [e for u in uids
                    if (e := self._cache.get(u)) is not None and e.spilling]
            for e in ents:
                if not e.dirty:
                    self._spilled_locked(e)
        self._write_back([e for e in ents if e.dirty])

    # ------------------------------------------------- prefetch lane seam
    def _prefetch_reserve(self, nbytes: int) -> bool:
        """Reserve budget BEFORE the lane stages a lookahead tile (the
        reserve half of the reserve/evict protocol): evicts clean tiles
        outside the lookahead if needed, never dirty ones, never the
        lookahead and never an unconsumed prefetch.  False: the working
        set does not fit, the lane skips the tile and it is staged on
        demand at dispatch instead of thrashing."""
        with self._lock:
            budget = self._cache_bytes - self._pf_reserved - nbytes
            if self._cache_used <= budget:
                self._pf_reserved += nbytes
                return True
            evict = []
            for k, e in self._cache.items():
                if self._cache_used <= budget:
                    break
                if e.dirty or e.pf or k in self._pf_pin:
                    continue
                evict.append((k, e))
                self._uncharge(e)
            self._evict_locked(evict)
            if self._cache_used <= budget:
                self._pf_reserved += nbytes
                return True
            self.stats["reserve_fails"] += 1
            return False

    def _prefetch_unreserve(self, nbytes: int) -> None:
        with self._lock:
            self._pf_reserved = max(0, self._pf_reserved - nbytes)

    def _cache_put_prefetch(self, uid, version, arr, nbytes, event,
                            epoch: int) -> bool:
        """Install a prefetched raw (flat uint8) mirror and release its
        reservation.  NEVER displaces an existing entry: the wave in
        flight may be reading it, and a dirty entry is newer than the
        host bytes this was staged from.  Also refused when a host-side
        overwrite happened since the stage began (`epoch`), or when some
        device holds a mirror of this version or a newer one (its bytes,
        not the host's, are current).  Returns False on a refusal (a
        wasted stage, counted)."""
        with self._lock:
            self._pf_reserved = max(0, self._pf_reserved - nbytes)
            q, v = self.ctx.device_get_data_owner(uid)
            if uid in self._cache or epoch != self._host_epoch \
                    or (q >= 0 and v >= version):
                self.stats["prefetch_wasted"] += 1
                return False
            ent = _CacheEnt(uid, version, arr, nbytes, persistent=False,
                            raw=True, event=event)
            ent.pf = True
            self._cache[uid] = ent
            self._charge(ent)
            self.stats["prefetch_staged"] += 1
            self.stats["prefetch_bytes"] += int(nbytes)
            N.lib.ptc_device_set_data_owner(self.ctx._ptr, uid, self.qid,
                                            version)
        return True

    def _consume_pf(self, uid: int) -> bool:
        """First stage-in of a prefetched tile: clear the flag (so the hit
        counts once and its staging slot can recycle) and report."""
        with self._lock:
            ent = self._cache.get(uid)
            if ent is not None and ent.pf:
                ent.pf = False
                return True
        return False

    def _cache_ent(self, uid, version) -> Optional[_CacheEnt]:
        with self._lock:
            ent = self._cache.get(uid)
            if ent is not None and ent.version == version:
                self._cache.move_to_end(uid)
                return ent
        return None

    def _cache_get_typed(self, uid, version, dtype, shape):
        """The current mirror of (uid, version) as a tensor of the
        consumer's dtype and shape, or None; the current stream waits on
        the entry's event.  A raw prefetched mirror is reinterpreted (a
        view of the same bytes, no copy) and the typed view memoized."""
        with self._lock:
            ent = self._cache.get(uid)
            if ent is None or ent.version != version:
                return None
            self._cache.move_to_end(uid)
            arr, raw = ent.arr, ent.raw
        self._await(ent.event)
        tdt = _NP_TO_TORCH[np.dtype(dtype)]
        if raw:
            arr = arr.view(tdt)
            with self._lock:
                if ent.raw:
                    ent.arr, ent.raw = arr, False
        elif arr.dtype != tdt:
            raise TypeError(
                f"device mirror {uid} holds {arr.dtype}, consumer "
                f"reads {np.dtype(dtype)}")
        return arr if shape is None else arr.reshape(shape)

    def _invalidate_siblings(self, uid: int) -> None:
        """Writer-side invalidation: after this device produces a new
        version of `uid`, sibling mirrors hold a stale version."""
        for sib in list(self.ctx._devices):
            if sib is self:
                continue
            with sib._lock:
                ent = sib._cache.pop(uid, None)
                if ent is not None:
                    sib._uncharge(ent)
                    sib.stats["invalidations"] += 1
                    N.lib.ptc_device_clear_data_owner(self.ctx._ptr, uid,
                                                      sib.qid)

    def set_cache_budget(self, nbytes: int) -> None:
        """Retarget the device byte budget; the residency planner reacts
        at the next insert (evicts, or spills out-of-core)."""
        with self._lock:
            self._cache_bytes = int(nbytes)

    def sync_handle(self, uid: int) -> None:
        """Coherence pull for ONE copy: if its device mirror is dirty,
        write it back to the host buffer (d2h stream) and clear the dirty
        bit."""
        with self._lock:
            ent = self._cache.get(uid)
            if ent is None or not ent.dirty:
                return
        self._write_back([ent])

    @property
    def prefetch_error(self) -> Optional[BaseException]:
        """The prefetch lane's last exception, or None.  The lane is
        advisory: a failed stage leaves its tile to dispatch-time
        staging, so the run goes on; callers that must know read this."""
        lane = self._pf_lane
        return None if lane is None else lane.error

    def info(self) -> dict:
        """Device info object: identity, capacity, live cache state."""
        with self._lock:
            cache_n = len(self._cache)
            cache_b = self._cache_used
            stats = dict(self.stats)
            attached = len(self.bodies)
        on_card = self.device.type == "cuda"
        return {
            "device": str(self.device),
            "kind": torch.cuda.get_device_name(self.device) if on_card
            else "cpu",
            "platform": "gpu" if on_card else "cpu",
            "queue": self.qid,
            "cache_tiles": cache_n,
            "cache_bytes": cache_b,
            "cache_capacity": self._cache_bytes,
            "attached_classes": attached,
            "stats": stats,
        }

    def flush(self):
        """Write every dirty device mirror back to its host copy: same-
        size mirrors move as stacked d2h copies on the d2h stream, into
        pinned staging, then into the host tiles.  Call before bulk host
        reads (to_dense etc.); per-copy coherence for CPU chores is
        automatic via sync_handle()."""
        self._wb_barrier()
        with self._lock:
            # only persistent (user-Data-backed) hosts are written: arena
            # buffers can be freed concurrently by the last consumer
            dirty = [e for e in self._cache.values()
                     if e.dirty and e.persistent]
        self._write_back(dirty)

    # ------------------------------------------------------------ attach
    def attach(self, tc: TaskClass, tp: Taskpool, kernel: Callable,
               reads: Sequence[str], writes: Sequence[str],
               shapes: Dict[str, tuple], dtype=np.float32,
               dtypes: Optional[Dict[str, np.dtype]] = None,
               sync_mem_out: bool = False, batch: bool = True):
        """Attach a device chore: kernel(*read_stacks) -> write stack(s).

        Each read flow arrives as a [lanes, *shape] tensor on this
        device (lane stride 0 when every lane reads the same tile), and
        the kernel returns one [lanes, *shape] tensor per write flow.

        sync_mem_out=True makes flows with memory-output deps host-
        coherent before task completion (the writeback lane), required
        only when the DAG writes a flow into a *different* collection
        tile; same-tile writebacks are satisfied lazily by flush().

        batch=True (default) lets the manager run a group of ready tasks
        of this class as one launch; set False for kernels with
        cross-lane semantics."""
        if dtypes is None:
            dtypes = {f: np.dtype(dtype) for f in set(reads) | set(writes)}
        # float64 is refused as the reference device module refuses it
        # (it cannot hold f64 without x64): the class stays on its host
        # chore, loudly, and the refusal is counted
        if any(np.dtype(d) == np.float64 for d in dtypes.values()):
            sys.stderr.write(
                f"ptc [device]: not attaching {tc.name}: float64 flows "
                "stay on the host chore\n")
            self._stats_add("f64_refused")
            return
        tc.body_device(self.qid, device="cuda")
        body = _DeviceBody(kernel, reads, writes, shapes, dtypes, tc, tp,
                           batch=batch)
        if not sync_mem_out:
            body.mem_out_flows = set()
        self.bodies[(id(tp), tc.id)] = body
        self._tp_by_ptr[tp._ptr] = tp

    def attach_epilogue(self, src_tc: TaskClass, dst_tc: TaskClass, tp,
                        src_flow: str, dst_in_flow: str, pick, dst_params,
                        kernel: Callable, ops,
                        const_flows: Sequence[str] = ()) -> None:
        """Speculative cross-class fusion for factor chains: when a launch
        of `src_tc` holds the lane whose `src_flow` output is the next
        `dst_tc` task's `dst_in_flow` input, run `kernel` (the dst class's
        chore) on that output row on the same stream right after the
        launch, and park the result.  When the dst task arrives it
        completes from the parked result with no launch, provided its
        input copy is the (uid, version) the lane produced; otherwise the
        miss is counted and the task launches normally.

          pick(src_view)   -> dst key tuple if this lane feeds the next
                              dst task, else None
          dst_params(view) -> the same key computed on the dst side
          ops(key)         -> the kernel's other operands, small numpy
                              arrays (each enters as a [1, *shape] lane)

        SINGLE-VARYING-INPUT CONTRACT: the parked result is computed from
        the src lane's output and ops(key) alone, and the hit checks only
        the `dst_in_flow` copy.  Every other read flow of `dst_tc` must be
        constant over the pair's lifetime, folded into `ops`, and
        DECLARED in `const_flows`; any other read flow raises ValueError.

        Both classes must be attach()ed to this device first (a class
        left on its host chore, e.g. refused float64, gets no epilogue).
        PTC_DEVICE_EPILOGUE=0 turns the mechanism off."""
        if os.environ.get("PTC_DEVICE_EPILOGUE", "1") == "0":
            return
        src = self.bodies.get((id(tp), src_tc.id))
        dst = self.bodies.get((id(tp), dst_tc.id))
        if src is None or dst is None:
            return
        uncovered = [f for f in dst.reads
                     if f != dst_in_flow and f not in const_flows]
        if uncovered:
            raise ValueError(
                f"attach_epilogue({src_tc.name} -> {dst_tc.name}): dst read "
                f"flow(s) {uncovered} are neither dst_in_flow nor declared "
                "in const_flows.  The parked result is computed from the "
                "src lane and ops alone; a varying undeclared input would "
                "complete dst tasks with stale data (single-varying-input "
                "contract)")
        epi = _Epilogue((id(tp), dst_tc.id), kernel, pick, dst_params, ops,
                        src_flow, dst_in_flow)
        src.epilogue = epi
        dst.spec_src = epi

    def stage_collection(self, coll) -> None:
        """Pre-stage every local tile of a tiled collection: ONE h2d of
        the stacked tiles, then each tile's mirror is a row of that
        stack (clean: the host copy holds the same bytes)."""
        tiles, keys = [], []
        for m, n in local_tile_index(coll):
            cptr = N.lib.ptc_data_host_copy(coll.data_of(m, n)._ptr)
            keys.append((self._copy_uid(cptr), N.lib.ptc_copy_version(cptr)))
            tiles.append(coll.tile(m, n))
        if not tiles:
            return
        stack, ev = self._h2d_ahead(np.stack(tiles))
        for i, (uid, ver) in enumerate(keys):
            self._cache_put(uid, ver, stack[i], tiles[i].nbytes,
                            stack=stack, idx=i, event=ev)

    # ------------------------------------------------------------ manager
    def start(self):
        """Start the manager, the writeback lane and (device.prefetch)
        the prefetch lane; idempotent."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._manager, daemon=True,
                                        name="ptc-cuda-manager")
        self._wb_thread = threading.Thread(target=self._wb_loop,
                                           daemon=True,
                                           name="ptc-cuda-writeback")
        # the writeback lane first: a manager draining it (_wb_barrier)
        # before it runs would find it not alive and not wait
        self._wb_thread.start()
        self._thread.start()
        if self._pf_enabled:
            self._pf_lane = _PrefetchLane(self, depth=self._pf_depth,
                                          slots=self._pf_slots_max)
            self._pf_lane.start()

    def _wb_loop(self):
        """Writeback lane: make the queued mirrors host-coherent, then
        complete their tasks (coherence before release_deps).  A launch's
        whole output stack moves as ONE d2h ("stack" items); "spill"
        items are the residency planner's write-back + evict; "sync"
        items pull single copies."""
        with self._device_ctx():
            while True:
                item = self._wb_q.get()
                if item is None:
                    return
                if item[0] == "barrier":
                    item[1].set()
                    continue
                kind, tasks, payload = item
                try:
                    if kind == "stack":
                        for ostack, uids, ev in payload:
                            host, hev = self._d2h_async([ostack], [ev])
                            if hev is not None:
                                hev.synchronize()
                            rows = host.reshape(len(uids), -1) \
                                .view(torch.uint8)
                            for i, uid in enumerate(uids):
                                self._wb_write(uid, ostack, i, rows[i])
                    elif kind == "spill":
                        self._spill(payload)
                    else:
                        for uid in payload:
                            self.sync_handle(uid)
                except Exception:
                    traceback.print_exc()
                    for t in tasks:
                        self.ctx.task_fail(t)
                    continue
                self._stats_add("wb_tasks", len(tasks))
                for t in tasks:
                    self.ctx.task_complete(t)

    def _wb_write(self, uid, ostack, i, row: torch.Tensor) -> None:
        """Land row i of a launch's output stack if the cache entry is
        still that row and dirty; anything put or evicted since goes
        through the per-copy sync."""
        with self._lock:
            ent = self._cache.get(uid)
            hit = (ent is not None and ent.dirty and ent.stack is ostack
                   and ent.idx == i)
        if hit:
            self._land(ent, row)
        else:
            self.sync_handle(uid)

    def _wb_barrier(self, timeout: float = 300.0):
        """Block until every queued writeback retired.  A timeout is a
        hard error: proceeding would report mirrors coherent that the
        lane may still be writing."""
        if self._wb_thread is None or not self._wb_thread.is_alive():
            return
        ev = threading.Event()
        self._wb_q.put(("barrier", ev))
        if not ev.wait(timeout=timeout):
            raise RuntimeError(
                f"ptc [device]: writeback barrier timed out after "
                f"{timeout:.0f}s; dirty mirrors are NOT coherent")

    def stop(self):
        """Flush dirty mirrors and stop the lanes and the manager
        (idempotent).  The prefetch lane object stays, stopped, so that
        prefetch_error can still be read."""
        if self._stop.is_set():
            return
        # the prefetch lane first: it peeks the native queue and pins
        # copies, so it must be quiet before the context can tear down
        if self._pf_lane is not None:
            self._pf_lane.stop()
        self.flush()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        # second flush AFTER the join: a task completing between the first
        # flush's dirty snapshot and manager exit is not lost
        self.flush()
        if self._wb_thread is not None:
            self._wb_q.put(None)
            self._wb_thread.join(timeout=30)
        if self in _ALL_DEVICES:
            _ALL_DEVICES.remove(self)
        with self._lock:
            for k in self._cache:
                N.lib.ptc_device_clear_data_owner(self.ctx._ptr, k,
                                                  self.qid)
            self._cache.clear()
            self._stacks.clear()
            self._spec.clear()
            self._dtd_bodies.clear()
            self._cache_used = 0

    def _manager(self):
        """Dispatch loop: drain every ready task, group by class (pop
        order kept), and run each group as one launch."""
        with self._on_stream(), torch.no_grad():
            while not self._stop.is_set():
                task = self.ctx.device_pop(self.qid, timeout_ms=50)
                if not task:
                    continue
                if self._ooc and self._cache_used > \
                        self._cache_bytes * self._overcommit:
                    # out-of-core hard cap: spills ride the writeback
                    # lane, so usage may overshoot the budget for a
                    # while; past overcommit * budget the manager drains
                    # the lane between waves (an unlocked read: an
                    # approximate trigger will do, the barrier is exact)
                    self._stats_add("ooc_waits")
                    self._wb_barrier()
                batch = [task]
                while len(batch) < self.batch_max:
                    t2 = self.ctx.device_pop(self.qid, timeout_ms=0)
                    if not t2:
                        break
                    batch.append(t2)
                groups: List[Tuple[Optional[_DeviceBody], List]] = []
                index: Dict[int, int] = {}
                for t in batch:
                    body = self._body_for(t)
                    gi = index.get(id(body))
                    if gi is None or body is None or not body.batch:
                        index[id(body)] = len(groups)
                        groups.append((body, [t]))
                    else:
                        groups[gi][1].append(t)
                for body, ts in groups:
                    if body is None:
                        for t in ts:
                            self.ctx.task_complete(t)
                    elif len(ts) == 1 or not body.batch:
                        for t in ts:
                            self._run_lanes(body, [t])
                    else:
                        self._dispatch_group(body, ts)

    def register_dtd_task(self, task_ptr, kernel: Callable,
                          reads: Sequence[int], writes: Sequence[int],
                          shapes: Dict[int, tuple], dtype, nb_flows: int,
                          tp: Taskpool) -> int:
        """The body of one DTD device task (dsl/dtd.py insert_cuda_task),
        consumed at its dispatch.  Keyed by a process-unique tag stamped
        on the task, never by its heap address, which a later task can
        reuse (the ABA hazard the copy cache's uids guard too).  Returns
        the tag."""
        dtypes = {i: np.dtype(dtype) for i in range(nb_flows)}
        body = _DeviceBody(kernel, reads, writes, shapes, dtypes, None, tp,
                           nb_flows, batch=False)
        with self._lock:
            tag = _next_uid()
            N.lib.ptc_task_set_tag(task_ptr, tag)
            self._dtd_bodies[tag] = body
        return tag

    def drop_dtd_tasks(self, tp: Taskpool, tag: Optional[int] = None) -> None:
        """Forget DTD bodies that will never dispatch: the one of `tag`
        (an insertion the pool refused), or every one of the pool `tp`
        still held (its wait() returned: they are tasks an abort
        dropped)."""
        with self._lock:
            if tag is not None:
                self._dtd_bodies.pop(tag, None)
                return
            for t in [t for t, b in self._dtd_bodies.items() if b.tp is tp]:
                del self._dtd_bodies[t]

    def _body_for(self, task) -> Optional[_DeviceBody]:
        """A DTD task's body by its tag (popped: a tag dispatches once),
        else its pool's class body."""
        tag = N.lib.ptc_task_get_tag(task)
        if tag:
            with self._lock:
                body = self._dtd_bodies.pop(tag, None)
            if body is not None:
                return body
        tp = self._tp_by_ptr.get(N.lib.ptc_task_taskpool(task))
        if tp is None:
            return None
        return self.bodies.get((id(tp), N.lib.ptc_task_class(task)))

    def _flow_uid_ver(self, view, body, flow):
        cptr = N.lib.ptc_task_copy(view._ptr, body.flow_index(flow))
        return cptr, self._copy_uid(cptr), N.lib.ptc_copy_version(cptr)

    def _flow_shape(self, view, body: _DeviceBody, flow) -> tuple:
        """A flow's tile shape: the declared one, else (a DTD argument
        given no shape) the whole copy as a vector of its dtype."""
        shape = body.shapes.get(flow)
        if shape is not None:
            return tuple(shape)
        cptr = N.lib.ptc_task_copy(view._ptr, body.flow_index(flow))
        return (N.lib.ptc_copy_size(cptr)
                // np.dtype(body.dtypes[flow]).itemsize,)

    def _sibling_mirror(self, uid, ver, dtype, shape):
        """A sibling device's current mirror of (uid, ver), ready to be
        copied on this device's stream, or None.  The producing device
        may hold the only current bytes (a dirty mirror: the host copy is
        stale), so a consumer routed here must stage device to device
        (reference: the CUDA peer stage-in, device_cuda_module.c:1261)."""
        for sib in list(self.ctx._devices):
            if sib is self:
                continue
            sarr = sib._cache_get_typed(uid, ver, dtype, shape)
            if sarr is None:
                continue
            if self._stream is not None and sib._stream is not None:
                # the sibling's producer may still run on its stream
                self._stream.wait_stream(sib._stream)
                sarr.record_stream(self._stream)
            self._stats_add("d2d_bytes", sarr.nbytes)
            return sarr
        return None

    def _hit(self, uid) -> None:
        """Count a stage-in served by the cache (and a prefetch hit at a
        prefetched tile's first read)."""
        self._stats_add("h2d_hits")
        if self._consume_pf(uid):
            self._stats_add("prefetch_hits")

    def _stage_from_host(self, view, body: _DeviceBody, flow):
        """Dispatch-time h2d of one flow's host copy (a prefetch miss when
        the lane runs)."""
        host = view.data(flow, dtype=body.dtypes[flow],
                         shape=body.shapes.get(flow), sync=False)
        if self._pf_lane is not None:
            self._stats_add("prefetch_misses")
        # the dispatching task's request scope names the stall's owner
        return self._h2d(host, int(N.lib.ptc_task_scope(view._ptr)) or -1)

    def _stage_in(self, view, body: _DeviceBody, flow):
        """The current device tile of one task's read flow: a cache hit,
        a copy of a sibling device's mirror, or an h2d of its host copy
        (then cached)."""
        _, uid, ver = self._flow_uid_ver(view, body, flow)
        shape = body.shapes.get(flow)
        dt = body.dtypes[flow]
        arr = self._cache_get_typed(uid, ver, dt, shape)
        if arr is not None:
            self._hit(uid)
            return arr
        sarr = self._sibling_mirror(uid, ver, dt, shape)
        if sarr is not None:
            arr = sarr.to(self.device, copy=True, non_blocking=True)
            self._cache_put(uid, ver, arr, arr.nbytes, event=self._record())
            return arr
        arr, ev = self._stage_from_host(view, body, flow)
        self._cache_put(uid, ver, arr, arr.nbytes, event=ev)
        return arr

    def _lanes_in(self, views, body: _DeviceBody, flow) -> torch.Tensor:
        """One read flow of a wave as a [lanes, *shape] tensor:
          - every lane reads the same tile: that tile, lane stride 0
          - every lane's tile is a row of ONE cached stack: a slice of it
            (or one index_select when the rows are not in lane order)
          - otherwise: a new stack, rows copied from the cache, a sibling
            or a fresh h2d (staged rows are then cached as rows of it); a
            tile several lanes read is staged once and its row copied"""
        n = len(views)
        shape = self._flow_shape(views[0], body, flow)
        keys = [self._flow_uid_ver(v, body, flow)[1:] for v in views]
        if all(k == keys[0] for k in keys):
            if n > 1:
                self._stats_add("fused_flows")
                self._stats_add("h2d_hits", n - 1)
            t = self._stage_in(views[0], body, flow)
            return t.unsqueeze(0).expand(n, *shape)
        ents = [self._cache_ent(uid, ver) for uid, ver in keys]
        stack = ents[0].stack if ents[0] is not None else None
        if stack is not None and all(
                e is not None and e.stack is stack for e in ents):
            self._await(*(e.event for e in ents))
            self._stats_add("fused_flows")
            self._stats_add("h2d_hits", n)
            idxs = [e.idx for e in ents]
            if idxs == list(range(idxs[0], idxs[0] + n)):
                rows = stack[idxs[0]:idxs[0] + n]
            else:
                rows = stack.index_select(
                    0, torch.tensor(idxs, device=stack.device))
            return rows.reshape(n, *shape)
        self._stats_add("eager_gathers")
        dt = body.dtypes[flow]
        out = torch.empty((n, *shape), dtype=_NP_TO_TORCH[np.dtype(dt)],
                          device=self.device)
        staged = []
        first: Dict[tuple, int] = {}  # (uid, ver) staged here -> its row
        for i, (view, (uid, ver)) in enumerate(zip(views, keys)):
            j = first.get((uid, ver))
            if j is not None:
                # an earlier lane of this gather staged the same tile: copy
                # its row rather than moving the bytes across again
                self._stats_add("h2d_hits")
                out[i].copy_(out[j], non_blocking=True)
                continue
            arr = self._cache_get_typed(uid, ver, dt, shape)
            if arr is not None:
                self._hit(uid)
            else:
                arr = self._sibling_mirror(uid, ver, dt, shape)
                if arr is None:
                    arr, _ = self._stage_from_host(view, body, flow)
                staged.append((i, uid, ver))
                first[(uid, ver)] = i
            out[i].copy_(arr.reshape(shape), non_blocking=True)
        ev = self._record() if staged else None
        for i, uid, ver in staged:
            self._cache_put(uid, ver, out[i], out[i].nbytes, stack=out,
                            idx=i, event=ev)
        return out

    def _write_out(self, view, body: _DeviceBody, flow, ostack, i, event):
        """Install lane i of an output stack as the task's dirty mirror,
        valid after `event`, and return (uid, its new version).  Host
        coherence is lazy (flush / sync_handle / a spill); sync-mem-out
        flows ride the writeback lane."""
        cptr, uid, ver = self._flow_uid_ver(view, body, flow)
        host = view.data(flow, dtype=body.dtypes[flow],
                         shape=body.shapes.get(flow), sync=False)
        persistent = bool(N.lib.ptc_copy_is_persistent(cptr))
        self._cache_put(uid, ver + 1, ostack[i], host.nbytes, dirty=True,
                        host=host, persistent=persistent, stack=ostack,
                        idx=i, event=event)
        self._invalidate_siblings(uid)
        return uid, ver + 1

    def _count_launch(self, kernel: Callable, lanes: int) -> None:
        name = getattr(kernel, "__name__", repr(kernel))
        with self._lock:
            rec = self.launches.setdefault(name, [0, 0])
            rec[0] += 1
            rec[1] += lanes

    def _spec_put(self, key, eouts, src) -> None:
        """Park a speculative result.  Bounded: an entry nobody consumes
        (its dst task ran on a sibling device) pins a whole output, so
        only a handful may linger."""
        self._spec[key] = (eouts, src[0], src[1])
        self._stats_add("spec_store")
        while len(self._spec) > 4:
            self._spec.pop(next(iter(self._spec)))

    def _try_spec(self, body: _DeviceBody, task) -> bool:
        """Destination side of an epilogue: complete `task` from a parked
        result when its `dst_in_flow` copy is the (uid, version) the
        source lane produced.  Returns True when the task was disposed of
        (completed, or failed on an exception); False sends it to a
        normal launch (no parked result, or a counted miss)."""
        spec = body.spec_src
        view = body.make_view(task)
        try:
            rec = self._spec.pop((spec.dst_bkey, spec.dst_params(view)),
                                 None)
            if rec is None:
                return False
            arrs, suid, sver = rec
            if len(arrs) != len(body.writes):
                # a misconfigured epilogue kernel: a partial write would
                # corrupt the flows it leaves out
                self._stats_add("spec_misses")
                sys.stderr.write(
                    f"ptc [device]: epilogue kernel returned {len(arrs)} "
                    f"output(s), {body.name} writes {len(body.writes)}; "
                    "ignoring the parked result\n")
                return False
            cptr = N.lib.ptc_task_copy(view._ptr,
                                       body.flow_index(spec.dst_in_flow))
            if N.lib.ptc_copy_handle(cptr) != suid \
                    or N.lib.ptc_copy_version(cptr) != sver:
                self._stats_add("spec_misses")
                return False
            # the parked kernel ran on this stream before now
            ev = self._record()
            wb_uids = []
            for f, arr in zip(body.writes, arrs):
                uid, _ = self._write_out(view, body, f, arr, 0, ev)
                if f in body.mem_out_flows:
                    wb_uids.append(uid)
        except Exception:
            traceback.print_exc()
            self.ctx.task_fail(task)
            return True
        self._stats_add("spec_hits")
        self._stats_add("tasks")
        if wb_uids:
            self._wb_q.put(("sync", [task], wb_uids))
        else:
            self.ctx.task_complete(task)
        return True

    def _run_epilogue(self, epi: _Epilogue, key, row: torch.Tensor,
                      src) -> None:
        """Run the dst chore on one output row (as a 1-lane stack) on this
        device's stream and park its outputs for the dst task `key`."""
        ops = [self._h2d(np.ascontiguousarray(o))[0].unsqueeze(0)
               for o in epi.ops(key)]
        e = epi.kernel(row.unsqueeze(0), *ops)
        self._count_launch(epi.kernel, 1)
        eouts = e if isinstance(e, tuple) else (e,)
        for a in eouts:
            if a.shape[0] != 1 or a.device != self.device:
                raise ValueError(
                    f"epilogue {getattr(epi.kernel, '__name__', '?')}: "
                    f"output {tuple(a.shape)} on {a.device}, expected 1 "
                    f"lane on {self.device}")
        self._spec_put((epi.dst_bkey, key), eouts, src)

    def _dispatch_group(self, body: _DeviceBody, tasks: List):
        """One launch for a group of ready tasks of one class, split so
        that one launch's lane stacks stay under PTC_DEVICE_BATCH_BYTES."""
        per_task = 0
        for f in list(body.reads) + list(body.writes):
            shp = body.shapes.get(f)
            if shp:
                per_task += int(np.prod(shp)) * np.dtype(
                    body.dtypes[f]).itemsize
        chunk = len(tasks)
        if per_task > 0 and chunk * per_task > self.batch_max_bytes:
            chunk = max(1, self.batch_max_bytes // per_task)
        for i in range(0, len(tasks), chunk):
            self._run_lanes(body, tasks[i:i + chunk])

    def _prof(self, phase: int, body: _DeviceBody, lanes: int) -> None:
        """A DEVICE_DISPATCH event: class = the task class id (-1 for a
        DTD body), l0 = lanes, l1 = this device's queue (so same-class
        spans of sibling devices pair apart); the END's aux is the
        launch's dispatch-time h2d stall in ns (0: every input was
        resident or prefetched).  The begin resets that stall."""
        if phase == 0:
            self._disp_stall_ns = 0
        cid = body.tc.id if body.tc is not None else -1
        N.lib.ptc_prof_event(self.ctx._ptr, KEY_DEVICE, phase, cid, lanes,
                             self.qid, self._disp_stall_ns if phase else 0)

    def _run_lanes(self, body: _DeviceBody, tasks: List):
        """Every launch, of one task or a group, comes here: an epilogue's
        destination tasks first try their parked result (no launch, no
        span), the rest launch once inside a DEVICE_DISPATCH span."""
        if body.spec_src is not None:
            tasks = [t for t in tasks if not self._try_spec(body, t)]
            if not tasks:
                return
        self._prof(0, body, len(tasks))
        wb_stacks = None
        try:
            wb_stacks = self._launch(body, tasks)
        finally:
            # the span ends before the tasks complete: a caller that
            # takes the trace after tp.wait() finds every span closed
            self._prof(1, body, len(tasks))
        if wb_stacks is None:
            return  # failed: _launch failed the tasks
        if wb_stacks:
            self._wb_q.put(("stack", list(tasks), wb_stacks))
            return
        for t in tasks:
            self.ctx.task_complete(t)

    def _launch(self, body: _DeviceBody, tasks: List) -> Optional[list]:
        """Stage the lanes' inputs, launch the kernel once, install the
        outputs; returns the output stacks of the sync-mem-out flows
        (empty: none).  A task completes once its launch is enqueued (or,
        for sync-mem-out flows, from the writeback lane, after the
        launch's output stack has landed on the host); any failure fails
        every task of the launch and returns None — no fallback.  An
        epilogue's source lane runs the epilogue inside the launch."""
        views = [body.make_view(t) for t in tasks]
        try:
            ins = [self._lanes_in(views, body, f) for f in body.reads]
            if body.tc is None:
                # a DTD kernel takes one task's tiles, not lane stacks
                out = body.kernel(*(t[0] for t in ins))
            else:
                out = body.kernel(*ins)
            self._count_launch(body.kernel, len(tasks))
            ev = self._record()
            outs = out if isinstance(out, tuple) else (out,)
            if len(outs) != len(body.writes):
                raise ValueError(
                    f"{body.name}: kernel returned {len(outs)} "
                    f"output(s) for {len(body.writes)} write flow(s)")
            if body.tc is None:
                outs = tuple(o.unsqueeze(0) for o in outs)
            epi, epi_lane, epi_key = body.epilogue, None, None
            if epi is not None:
                for i, view in enumerate(views):
                    epi_key = epi.pick(view)
                    if epi_key is not None:
                        epi_lane = i
                        break
            wb_stacks, epi_src = [], None
            for f, ostack in zip(body.writes, outs):
                if ostack.shape[0] != len(tasks) \
                        or ostack.device != self.device:
                    raise ValueError(
                        f"{body.name}.{f}: kernel output "
                        f"{tuple(ostack.shape)} on {ostack.device}, "
                        f"expected {len(tasks)} lanes on {self.device}")
                uids = []
                for i, view in enumerate(views):
                    uid, ver = self._write_out(view, body, f, ostack, i, ev)
                    uids.append(uid)
                    if i == epi_lane and f == epi.src_flow:
                        epi_src = (uid, ver, ostack[i])
                if f in body.mem_out_flows:
                    wb_stacks.append((ostack, uids, ev))
            if epi_src is not None:
                self._run_epilogue(epi, epi_key, epi_src[2], epi_src[:2])
            self._stats_add("tasks", len(tasks))
            if len(tasks) > 1:
                self._stats_add("batches")
                self._stats_add("batched_tasks", len(tasks))
        except Exception:
            # a failed kernel must NOT complete its tasks: successors would
            # consume garbage and the pool would "succeed"
            traceback.print_exc()
            for t in tasks:
                self.ctx.task_fail(t)
            return None
        return wb_stacks
