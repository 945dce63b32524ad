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
  - DTD device tasks (dsl/dtd.py insert_cuda_task) of one signature (pool,
    kernel, access modes, tile shapes, dtype) share one body, so a drain
    groups them too: a group of independent tasks (no member writes a
    copy another reads or writes; a group that is not is split in pop
    order) is ONE launch of torch.func.vmap(kernel) over the lane stacks,
    the kernel keeping its single-tile contract.  A kernel vmap refuses
    (.item(), a branch on a value) runs one task per launch from then on,
    as does a task whose flows declare no shape
  - device-resident dataflow: results stay on the card as dirty mirrors
    in a uid-keyed, versioned LRU; successors consume them from device
    memory.  The host copy is written (a) by the writeback lane for
    flows declared sync_mem_out, one stacked d2h per launch's output
    stack, (b) at flush(), same-shape mirrors grouped into stacked d2h
    copies (stats["flush_bytes"], stats["flush_ns"]), (c) on a host read
    (TaskView.data and the native copy-sync callback), (d) by an
    out-of-core spill, or (e) never, if the copy dies first.  A mirror
    drops where its host bytes change outside a device: the runtime's
    own overwrite (the copy invalidation callback), or a user's write
    declared with Collection.host_wrote() or Context.host_wrote()
    (stats["invalidations"])
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
    the budget, spills them through the writeback lane (out-of-core).
    After a dry sweep (every tile of its lookahead already current) the
    lane rests until a stage from the host, an eviction, a spill or a
    pre-staged collection rouses it (_pf_rouse), or a wake gives it one
    more pass.  A tile's stage from the host is claimed first
    (_staging): the lane leaves a tile the manager is staging, and the
    manager waits for one the lane is staging, so its bytes cross once
  - speculative epilogues (attach_epilogue): the lane of a wave whose
    output is the next input of a declared consumer class runs that
    class's kernel right after the wave's launch; the consumer task
    then completes from the parked result, version-checked
  - wave and chain fusion (device/fuse.py, the device.wave_fuse knob, on
    by default): a popped wave is certified online and, where the static
    chain certificates link it to its consumer waves, those waves' chores
    run right after it on the exec stream and their results are parked;
    the consumer tasks then complete from them with no launch.
    device.wave_fuse=0 restores the per-group batched dispatch bit for
    bit
  - plan_check: the pre-run residency check of a pool's predicted device
    working set against the byte budget (device.plan_check)
  - the data plane (ptc_set_dataplane): a remote dependency whose copy
    has a current mirror here is served from the card, by one d2h into
    pinned memory, or streamed in comm.chunk_size slices from the
    writeback lane (device.stream_serve), or, to a colocated rank, as a
    by-reference token whose tensor is cloned on the consumer's device,
    or, with device.dp_transfer, to a rank in another process on this
    host and card, as a CUDA IPC token the consumer pulls card to card;
    a payload that arrives is staged on the least-loaded device as a raw
    mirror.  A failed callback hands the dependency to the host path,
    as in the reference, and counts in stats["dp_errors"]; a failed pull
    of a CUDA IPC token counts there too and fails the consuming task,
    and so its pool (its bytes were never sent)

Per taskpool a device keeps one record (_PoolRecord), keyed by the
pool's native pointer (what ptc_task_taskpool returns for each of its
tasks): its class bodies, its DTD bodies by signature and by tag, and
the wave compiler's consumed certificates.  The pool's first attach or
register_dtd_task makes it; Taskpool.destroy() drops it (drop_pool),
with the pool's parked epilogue and chain results, before the native
pool is freed and its pointer may name a new pool.  An aborted pool is
never freed, so its record stays until stop().

A failing kernel fails its tasks (ctx.task_fail) and so the pool: there
is no silent fallback to another path.

The manager thread's time, always counted: every instant of its loop
lies in one of four buckets, each a stats counter (ns), written by that
thread alone at the boundaries between them (one clock read each):
  - mgr_wait_ns      inside ctx.device_pop with no device task ready
                     (the blocking pops, the batch-wait polling): the
                     scheduler's, the builders' and the releases' time
  - mgr_plan_ns      grouping a popped batch (its draining pops too),
                     the wave compiler's certification and chain
                     planning before a launch opens its span, the
                     prefetch lane's handoff; cert_ns is the part of it
                     spent having each pool's chain certificates
                     (device/fuse.py), pf_handoff_ns the part inside
                     the lane's handoff() (pf_handoffs of them waited
                     for the lane, pf_handoffs_skipped found it at rest)
  - mgr_dispatch_ns  inside DEVICE_DISPATCH spans, chains included
                     (h2d_stall_ns is a part of it)
  - mgr_complete_ns  ctx.task_complete on this thread (the native
                     release of the tasks' dependencies), and tasks
                     completed from a parked chain or epilogue result
They add up to the loop's wall time (info()["stats"]["mgr_wall_ns"]),
but for the stretch under way when they are read: a wait is credited at
each of its 50 ms polls, and every other stretch lasts a launch or
less.  The writeback and prefetch lanes run on threads of their own,
outside the partition.
Python's collector pauses every thread: gc_pause_ns and gc_full_passes
(process totals, while any CudaDevice runs) overlap whichever bucket a
pause interrupts; they are not a fifth bucket.

Trace spans (profiling/trace.py; recorded when ctx.profile_enable is on,
and handed to PINS, from the manager and lane threads, as worker -1;
while neither listens no span call is made):
  - DEVICE_WAIT, DEVICE_PLAN, DEVICE_DISPATCH, DEVICE_COMPLETE: one span
    per stretch of each bucket above, l1 = the device's queue; their
    durations add up to the counters.  DEVICE_DISPATCH: class = the
    task class id (-1 for a DTD body), l0 = lanes (a chain's: its
    producer wave's); the BEGIN's aux = the fused mark (0 plain, n >= 1
    a certified wave of a chain of n waves); the END's aux = the
    dispatch-time h2d stall in ns since the last END, the same
    nanoseconds stats["h2d_stall_ns"] counts for it.  DEVICE_COMPLETE:
    class = the task class (-1: a DTD body or none), l0 = tasks, aux =
    1 for parked or speculative results
  - DEVICE_CERT inside the DEVICE_PLAN span under way, once a pool: the
    wave compiler having its chain certificates (l0 0, aux of its END 0
    a miss, 1 a cache hit, 2 uncached); their durations add up to
    stats["cert_ns"]
  - GC_PAUSE around each collection (l0 = the generation), on the thread
    that triggered it
  - DEVICE_H2D around each dispatch-time staging (_h2d): l0 = bytes,
    l1 = the queue, class = the dispatching task's request scope or -1,
    aux 0; DEVICE_H2D_AHEAD around each stage off the dispatch path (the
    prefetch lane; _h2d_ahead: stage_collection, the panel DAGs' index
    segments): class -1, aux 1.  Every byte stats["h2d_bytes"] counts
    is in one of these spans; those of the DEVICE_H2D spans alone are
    stats["h2d_dispatch_bytes"], what reached the card at dispatch
    rather than ahead of the task that read it.
  - STREAM around each progressive serve (_stream_serve, on the
    writeback lane): l0 = bytes, l1 = the queue; it brackets the slices'
    d2h copies and their pushes to the wire.
  - DEVICE_DP_SERVE around each pull the data plane serves from this
    device (the dp_serve callback, on the comm thread): the d2h into
    pinned memory, or the token, and the handoff to the engine; l0 =
    the payload's bytes, l1 = the queue, aux = the pulling rank.  Their
    durations add up to stats["dp_serve_ns"].
  - DEVICE_DP_RECV around each remote payload landed in a mirror of this
    device (the dp_deliver callback): the copy into pinned staging and
    the enqueue of the h2d, or the on-card clone or pull of a token;
    l0 = bytes, l1 = the queue, aux -1.  Their durations add up to
    stats["dp_recv_ns"].
  - DEVICE_FLUSH around each flush()'s write-back, on the calling
    thread, once the writeback lane's queue has drained: the stacked
    d2h copies and their landing in the host tiles; l0 = the bytes
    written back (stats["flush_bytes"] sums them), l1 = the queue,
    class -1, aux 0.  Their durations add up to stats["flush_ns"]: the
    caller's wait for its results to reach the host.
The DEVICE_* spans bracket what the HOST does, as the reference's spans
do: from the start of the copy into pinned staging (or of the launch's
staging) to the asynchronous enqueue.  The copies and kernels
themselves run on the card's streams after the span ends;
torch.profiler times those (Trace.to_wall puts the two on one clock).

`CudaDevice(ctx)` runs on the card and raises where there is none;
`CudaDevice(ctx, device="cpu")` runs the same module with torch CPU
tensors, where each kernel wrapper takes its plain PyTorch version and
the streams are None.
"""
from __future__ import annotations

import contextlib
import ctypes as C
import gc
import json
import operator
import os
import queue
import socket
import sys
import threading
import time
import traceback
from collections import OrderedDict, deque
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _native as N
from ..comm.ici import TransferSessionPool, device_transfer
from ..core.context import Context
from ..core.taskclass import Mem, TaskClass, TaskView, register_copy_pull
from ..core.taskpool import Taskpool
from ..dsl.dtd import DtdView
from ..profiling.trace import (KEY_DEVICE, KEY_DEVICE_COMPLETE,
                               KEY_DEVICE_DP_RECV, KEY_DEVICE_DP_SERVE,
                               KEY_DEVICE_FLUSH, KEY_DEVICE_PLAN,
                               KEY_DEVICE_WAIT, KEY_GC_PAUSE, KEY_H2D,
                               KEY_H2D_AHEAD, KEY_STREAM)
from ..utils import params as _knobs
from .fuse import WaveFuser
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

# the longest the manager waits for the prefetch lane's stage of a tile in
# flight before it stages the tile itself (_stage_or_wait)
_STAGE_WAIT_S = 5.0

# _launch's answer for a DTD group whose kernel vmap refused: nothing was
# launched or installed, and the tasks are to launch one by one
_UNBATCHED = object()

# the manager thread's time partition: its buckets, their stats counters
# and their trace keys (see the module's docstring)
_WAIT, _PLAN, _DISPATCH, _COMPLETE = range(4)
_MGR_STATS = ("mgr_wait_ns", "mgr_plan_ns", "mgr_dispatch_ns",
              "mgr_complete_ns")
_MGR_KEYS = (KEY_DEVICE_WAIT, KEY_DEVICE_PLAN, KEY_DEVICE,
             KEY_DEVICE_COMPLETE)


def _dtd_signature(kernel, reads, writes, shapes, dtype,
                   nb_flows) -> Optional[tuple]:
    """What DTD device tasks of one pool share when one launch can run
    them as lanes: their kernel object, access modes, tile shapes, dtype
    and arity.  None where a read or write flow declares no shape, or
    where the task reads nothing (vmap batches over the reads)."""
    flows = set(reads) | set(writes)
    if not reads or any(shapes.get(f) is None for f in flows):
        return None
    return (kernel, tuple(reads), tuple(writes),
            tuple((f, tuple(shapes[f])) for f in sorted(flows)),
            np.dtype(dtype), nb_flows)


def _independent_runs(lanes: Sequence[tuple]) -> List[int]:
    """The lengths of the runs, in order, into which the lanes `lanes`
    ((read copies, written copies) each) split so that no lane of a run
    writes a copy that another lane of it reads or writes: the lanes of
    one launch run in no order."""
    runs, n, rd, wr = [], 0, set(), set()
    for r, w in lanes:
        if n and (w & (rd | wr) or r & wr):
            runs.append(n)
            n, rd, wr = 0, set(), set()
        n += 1
        rd |= r
        wr |= w
    runs.append(n)
    return runs


def _vmapped(kernel: Callable, ins: Sequence[torch.Tensor]):
    """`kernel`, which takes single tiles, called once over the lanes of
    the [lanes, *tile] stacks `ins` by torch.func.vmap.  A flow every lane
    reads identically (a lane-stride-0 view, _lanes_of) goes in once,
    unbatched, but one flow is always batched."""
    dims = [None if t.stride(0) == 0 else 0 for t in ins]
    if 0 not in dims:
        dims[0] = 0
    args = [t if d == 0 else t[0] for t, d in zip(ins, dims)]
    return torch.func.vmap(kernel, in_dims=tuple(dims))(*args)


def _in_one_step(calls: list) -> tuple:
    """Call each of `calls` in turn, with no bytecode between them: the
    interpreter switches threads only between bytecodes, so a clock read
    among span calls that keep the interpreter lock (N.prof_event_held)
    cannot drift from their stamps by another thread's turn."""
    return tuple(map(operator.call, calls))


class _GcClock:
    """The pauses of Python's cyclic collector, process-wide: one
    gc.callbacks hook, installed while any CudaDevice runs (counted by
    attach/detach, from start() and stop()).  It sums every pass's pause
    and counts the full (generation 2) passes, and opens a GC_PAUSE span
    on each listening context of a running device.  A collection stops
    every thread, so its time is not the manager's alone."""

    def __init__(self):
        self.pause_ns = 0
        self.full_passes = 0
        self._t0: Optional[int] = None  # the pass under way's start
        self._devs: tuple = ()  # the running devices
        self._lock = threading.Lock()

    def attach(self, dev) -> None:
        with self._lock:
            self._devs += (dev,)
            if len(self._devs) == 1:
                gc.callbacks.append(self._hook)

    def detach(self, dev) -> None:
        with self._lock:
            if dev not in self._devs:
                return
            self._devs = tuple(d for d in self._devs if d is not dev)
            if not self._devs:
                gc.callbacks.remove(self._hook)

    def _hook(self, phase: str, info: dict) -> None:
        gen = info["generation"]
        begin = phase == "start"
        ctxs = {id(d.ctx): d.ctx for d in self._devs if d.ctx._listening}
        if ctxs:
            # the clock and every listening context's span in one step
            now = _in_one_step([time.perf_counter_ns] + [
                partial(N.prof_event_held, c._ptr, KEY_GC_PAUSE,
                        0 if begin else 1, -1, gen, 0, 0)
                for c in ctxs.values()])[0]
        else:
            now = time.perf_counter_ns()
        if begin:
            self._t0 = now
            return
        if self._t0 is None:
            return  # installed during this pass: its start went unseen
        self.pause_ns += now - self._t0
        self._t0 = None
        if gen == 2:
            self.full_passes += 1


_GC = _GcClock()


class _PoolRecord:
    """What one device holds for one taskpool, from the pool's first
    attach or register_dtd_task until its destroy() (CudaDevice.drop_pool)
    or the device's stop(): the pool, its class bodies by class id, its
    DTD bodies by signature (_dtd_signature) and by task tag (each popped
    at its task's dispatch), and the wave compiler's consumed certificates
    (device/fuse.py; None until its first certified wave).  `key` is the
    pool's native pointer, under which the device and its wave compiler
    file everything else they keep for the pool."""
    __slots__ = ("tp", "key", "bodies", "dtd_sigs", "dtd_tags", "cert")

    def __init__(self, tp: Taskpool):
        self.tp, self.key, self.cert = tp, tp._ptr, None
        self.bodies, self.dtd_sigs, self.dtd_tags = {}, {}, {}


class _DeviceBody:
    """A device chore: the kernel and its flows, held in its pool's
    record (`pool`).  A PTG class body (`tc` set) is filed there by class
    id and its flows are named; a DTD body (`tc` None) is shared by the
    tasks of one signature and found by each task's tag, its flows are
    argument indices (`nb_flows` of them), and its kernel takes and
    returns single tiles: a group of its tasks launches as
    torch.func.vmap(kernel) (CudaDevice.register_dtd_task)."""

    def __init__(self, kernel: Callable, reads: Sequence,
                 writes: Sequence, shapes: Dict, dtypes: Dict,
                 tc: Optional[TaskClass], pool: _PoolRecord,
                 nb_flows: int = 0, batch: bool = True):
        self.kernel = kernel
        self.reads = list(reads)
        self.writes = list(writes)
        self.shapes = shapes
        self.dtypes = dtypes
        self.tc = tc
        self.pool = pool
        self.nb_flows = nb_flows
        # a group launches as one: the kernel is elementwise over lanes
        # (a DTD body: vmap takes its kernel, until a launch finds not)
        self.batch = batch
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
            return TaskView(task_ptr, self.tc, self.pool.tp)
        return DtdView(task_ptr, self.nb_flows)


class _Epilogue:
    """Speculative cross-class fusion config, attached to the SOURCE
    body (see CudaDevice.attach_epilogue).  dst_bkey is (the pool's
    record key, the dst class id): its parked results go with the pool."""
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
    otherwise.  A copy whose transfer-plane pull failed raises."""
    h = N.lib.ptc_copy_handle(cptr)
    if h:
        _check_delivered(h)
        sync_copy_handle(h)


def _check_delivered(uid: int) -> None:
    if _DP_FAILED and uid in _DP_FAILED:
        raise RuntimeError(f"copy {uid}: its transfer-plane pull failed "
                           "after the token was sent; no bytes exist")


register_copy_pull(maybe_sync_copy)


# ---------------------------------------------------------------- data plane
# Device side of the comm engine's PK_DEVICE rendezvous (native seam:
# ptc_set_dataplane; reference: comm-engine put/get on registered memory,
# parsec_comm_engine.h:139-160).  A remote dep whose copy has a current
# device mirror is advertised as a transfer tag; at pull time the payload
# is served EITHER as bytes (one d2h on the d2h stream into pinned memory,
# the host transport carries them; or, streamed, in comm.chunk_size slices
# from the writeback lane) OR, when the pulling rank is colocated (another
# Context of this process), as a 16-byte by-reference token, and the tile
# itself is cloned on the consumer's device.  The consumer's host bytes
# then materialize lazily through the ordinary dirty-mirror coherence
# pull.
#
# A pinned payload is a tensor no later write reaches: an output row is
# cloned out of its launch's stack at registration (a later wave writes a
# fresh stack and installs it as a new cache entry; nothing writes a stack
# in place), and the clone is ordered after the row's event on the d2h
# stream.  Every serve and delivery is ordered by events, never by a
# device-wide synchronize.
_DP_LOCK = threading.Lock()
_DP_STATE = {"next_tag": 1}
# tag -> [payload tensor, refcount, (copy handle, version), raw, owning
# device, event after which the payload is valid (None on the CPU)]; a
# (copy, version) advertised to several ranks or batches shares one tag
_DP_REG: Dict[int, list] = {}
_DP_BY_KEY: Dict[tuple, int] = {}
# tag -> [pinned host buffers], one entry per live serve (two pulls of one
# tag can be mid-serve at once with the chunked rendezvous); popped by
# dp_serve_done
_DP_SERVING: Dict[int, list] = {}
# colocated by-reference handoff: pull id -> (tensor, raw, event)
_DP_XFER: Dict[int, tuple] = {}
_DP_REF_MAGIC = b"PTCDPRF1"


# ------------------------------------------- the cross-process transfer plane
# device.dp_transfer: a payload pulled by a rank in ANOTHER process on this
# host and card is served as a token naming its CUDA IPC handles, and the
# consumer copies it card to card; the payload never exists in either
# host's buffers.  Reference seam: jax.experimental.transfer in
# parsec_tpu/device/tpu.py (_xfer_token, _xfer_pull, the GET-frame bit).
#
# Who gets a token.  The producer decides before the token is on the wire:
# the plane is on here, the consumer set the GET frame's pull bit (its
# device probed the plane, device.dp_pull), and the consumer's identity —
# (host name, card UUID), shared at its device init through the comm
# engine's blob frame, which precedes its GET on the same ordered
# connection — equals this device's.  The engine connects its ranks over
# the loopback interface only (native/comm.cpp), so every peer is on this
# host; the card UUID is what tells a peer on this card from one on
# another.  Every other consumer gets bytes, as in the reference.
#
# Lifetime.  The token is torch's CUDA IPC form of the payload
# (torch.multiprocessing.reductions.reduce_tensor: the allocation's
# memory handle, the storage's place in it, an interprocess event
# recorded after the payload's event on the d2h stream, and a slot of
# torch's IPC ref counter).  The native serve-done callback fires once
# the token is on the wire and drops the producer's pin, but torch keeps
# a freed block whose counter is above zero in its "limbo" until the
# consumer lets go: the plane relies on that counter.  The consumer opens
# the handle on its h2d stream (which waits on the producer's event),
# clones into memory of its own, waits on the clone's event and drops the
# mapping, which releases the counter.  A token whose consumer never pulls
# (it died first) keeps its block in limbo for the producer's lifetime.
# Handles are not cached across pulls: a mapping held open keeps its
# block in limbo, so the producer's allocator could not reuse it and a
# cached handle would never be hit again.
#
# A pull that fails after its token was sent cannot fall back to bytes:
# it counts in dp_errors, and its delivery's uid is marked failed, so the
# consuming task fails at dispatch (or at a host read) and aborts its
# pool.
_DP_XFER_MAGIC = b"PTCDPIP1"
_DP_FAILED: set = set()
_XFER_LOCK = threading.Lock()
_XFER_STATE: Dict[str, object] = {"sessions": None, "can_pull": {}}


def _xfer_enabled() -> bool:
    return bool(_knobs.get("device.dp_transfer"))


def _xfer_sessions(my_rank: int = 0):
    """The process-wide per-peer session pool (comm/ici.py), created at
    the first pull with this process's rank."""
    with _XFER_LOCK:
        pool = _XFER_STATE["sessions"]
        if pool is None:
            pool = _XFER_STATE["sessions"] = TransferSessionPool(
                my_rank=my_rank)
        return pool


def _card_identity(device: torch.device) -> dict:
    """This process's (host, card) identity for `device`."""
    props = torch.cuda.get_device_properties(device)
    return {"host": socket.gethostname(), "card": str(props.uuid)}


def _xfer_can_pull(dev: "CudaDevice") -> bool:
    """One-time probe per card: can this process take part in the plane?
    It checks what one process can check: the card is a CUDA device and a
    tensor on it shares through CUDA IPC under the allocator settings in
    force (expandable_segments refuses it), with the probe's ref-counter
    slot released again.  It does NOT cover opening a handle, which a
    process cannot do on its own memory: a consumer whose open fails
    after a token was sent aborts its pool.  device.dp_pull=0 refuses
    pulls on this rank."""
    if not _knobs.get("device.dp_pull") or dev.device.type != "cuda":
        return False
    idx = dev.device.index
    with _XFER_LOCK:
        cached = _XFER_STATE["can_pull"].get(idx)
    if cached is not None:
        return cached
    ok = False
    try:
        from torch.multiprocessing.reductions import reduce_tensor
        probe = torch.zeros(4, device=dev.device)
        args = reduce_tensor(probe)[1]
        torch.storage.TypedStorage._release_ipc_counter(
            args[11], args[12], device=idx)
        ok = True
    except Exception as e:
        sys.stderr.write(f"ptc [device]: transfer-plane probe failed "
                         f"({e!r}); this rank will request host bytes\n")
    with _XFER_LOCK:
        _XFER_STATE["can_pull"][idx] = ok
    return ok


def _peer_identity(ctx, rank: int) -> Optional[dict]:
    """The (host, card) identity rank `rank` shared through the comm
    engine's blob frame, or None (none received, or the blob has none)."""
    peers = ctx.__dict__.setdefault("_dp_peers", {})
    ident = peers.get(rank)
    if ident is not None:
        return ident
    cap = 1 << 16
    while True:
        buf = C.create_string_buffer(cap)
        n = N.lib.ptc_comm_peer_blob(ctx._ptr, int(rank), buf, cap)
        if n <= cap:
            break
        cap = int(n)
    if n <= 0:
        return None
    try:
        ident = json.loads(buf.raw[:n].decode()).get("dp")
    except (ValueError, AttributeError):
        return None
    if isinstance(ident, dict):
        peers[rank] = ident
        return ident
    return None


def _xfer_peer_ok(ctx, dev: "CudaDevice", from_rank: int) -> bool:
    """The producer's decision: may `from_rank` take a token for a
    payload of `dev`?  (The pull bit and the knob are checked by the
    caller; see the block comment above for what this uses.)"""
    if dev._ident is None:
        return False
    return _peer_identity(ctx, from_rank) == dev._ident


def _xfer_encode(fields: dict) -> bytes:
    """A token: the magic, then the fields as JSON (bytes in hex)."""
    out = {k: (v.hex() if isinstance(v, bytes) else v)
           for k, v in fields.items()}
    return _DP_XFER_MAGIC + json.dumps(out, sort_keys=True).encode()


_XFER_BYTES = ("handle", "ref", "event")


def _xfer_decode(tok: bytes) -> dict:
    if tok[:8] != _DP_XFER_MAGIC:
        raise ValueError("not a transfer-plane token")
    f = json.loads(tok[8:].decode())
    for k in _XFER_BYTES:
        f[k] = bytes.fromhex(f[k])
    return f


def _xfer_token(ctx, dev: "CudaDevice", arr: torch.Tensor, raw: bool,
                event) -> bytes:
    """The token of one pull of `arr`: its CUDA IPC form, shared on the
    d2h stream after the payload's event (torch records its interprocess
    event there), with this rank and identity as the session's key."""
    from torch.multiprocessing.reductions import reduce_tensor
    with torch.cuda.stream(dev._d2h_stream):
        dev._await(event)
        a = reduce_tensor(arr)[1]
    return _xfer_encode({
        "rank": int(ctx.myrank),
        "addr": f"{dev._ident['host']}/{dev._ident['card']}/{os.getpid()}",
        "raw": bool(raw), "dtype": str(arr.dtype).replace("torch.", ""),
        "shape": list(a[1]), "stride": list(a[2]), "offset": int(a[3]),
        "handle": a[7], "size": int(a[8]), "soffset": int(a[9]),
        "ref": a[11], "ref_offset": int(a[12]), "event": a[13],
        "event_sync": bool(a[14])})


def _ipc_open(f: dict, device: torch.device) -> torch.Tensor:
    """The producer's tensor mapped into this process (torch's CUDA IPC
    rebuild: it waits on the producer's event on the current stream)."""
    from torch.multiprocessing.reductions import rebuild_cuda_tensor
    return rebuild_cuda_tensor(
        torch.Tensor, torch.Size(f["shape"]), tuple(f["stride"]),
        f["offset"], torch.storage.TypedStorage,
        getattr(torch, f["dtype"]), device.index, f["handle"], f["size"],
        f["soffset"], False, f["ref"], f["ref_offset"], f["event"],
        f["event_sync"])


class _IpcConnect:
    """The session pool's `server` for one pull.  CUDA keeps no per-peer
    connection (see the lifetime note above): establishing a peer's
    session is its first handle open, so `connect` opens this pull's
    token, keeps the mapped tensor for the caller and returns the peer's
    address as the session."""

    def __init__(self, fields: dict, device: torch.device):
        self.fields, self.device = fields, device
        self.view: Optional[torch.Tensor] = None

    def connect(self, addr: str) -> str:
        self.view = _ipc_open(self.fields, self.device)
        return addr


def _dp_error(ctx, where: str, dev=None,
              outcome: str = "the host path carries this dependency") \
        -> None:
    """A data-plane callback failed: print the traceback, log it and count
    it in dp_errors (of `dev`, else of the context's first device).  The
    callback's return value then hands the dependency to the host path, as
    the reference's does, so a job still finishes (a failed transfer-plane
    pull aborts its pool instead: `outcome`); dp_errors is what makes the
    fallback visible."""
    traceback.print_exc()
    sys.stderr.write(f"ptc [device]: data plane {where} failed; "
                     f"{outcome}\n")
    if dev is None and ctx._devices:
        dev = ctx._devices[0]
    if dev is not None:
        dev._stats_add("dp_errors")


def _dp_pin(dev: "CudaDevice", ent: "_CacheEnt"):
    """(payload tensor, event) for a current mirror: the entry's own tensor
    when it owns its storage, else (a row of a launch's or a gather's
    stack) a clone of the row on the d2h stream after the row's event."""
    arr = ent.arr
    if ent.stack is None:
        return arr, ent.event
    if dev._stream is None:
        return arr.clone(), None
    with torch.cuda.stream(dev._d2h_stream):
        dev._await(ent.event)
        arr.record_stream(dev._d2h_stream)
        row = arr.clone()
        return row, dev._record(dev._d2h_stream)


def _make_dp_callbacks(ctx):
    """Per-context data-plane callbacks (closing over ctx._devices and
    ctx._colocated)."""

    def dp_register(user, copy_handle, version, size) -> int:
        """A remote send asks: is there a current device mirror of this
        copy?  Returns a transfer tag (> 0) or 0 for the host path."""
        try:
            for dev in list(ctx._devices):
                with dev._lock:
                    ent = dev._cache.get(copy_handle)
                    if ent is None or ent.version != version:
                        continue
                key = (copy_handle, version)
                with _DP_LOCK:
                    tag = _DP_BY_KEY.get(key)
                    if tag is not None and tag in _DP_REG:
                        _DP_REG[tag][1] += 1
                        dev._stats_add("dp_sends")
                        return tag
                arr, ev = _dp_pin(dev, ent)
                with _DP_LOCK:
                    tag = _DP_STATE["next_tag"]
                    _DP_STATE["next_tag"] += 1
                    _DP_REG[tag] = [arr, 1, key, ent.raw, dev, ev]
                    _DP_BY_KEY[key] = tag
                dev._stats_add("dp_sends")
                return tag
            return 0
        except Exception:
            _dp_error(ctx, "register")
            return 0

    def dp_serve(user, tag, from_rank, xfer_ok, ptr_out, real_out) -> int:
        """Produce one pull's wire bytes: the payload itself (one d2h into
        pinned memory, waited on by its event only), or, for a colocated
        consumer, a by-reference token, or, for a consumer in another
        process on this card that can pull (device.dp_transfer), a CUDA
        IPC token.  Timed as a DEVICE_DP_SERVE span."""
        dev = span = None
        try:
            with _DP_LOCK:
                rec = _DP_REG.get(tag)
            if rec is None:
                return -1
            arr, dev, ev = rec[0], rec[4], rec[5]
            span = dev._dp_open(KEY_DEVICE_DP_SERVE, arr.nbytes, from_rank)
            if from_rank in ctx._colocated:
                # one handoff slot per PULL: a fan-out to several
                # colocated consumers serves several tokens
                with _DP_LOCK:
                    pull_id = _DP_STATE["next_tag"]
                    _DP_STATE["next_tag"] += 1
                    _DP_XFER[pull_id] = (arr, rec[3], ev)
                buf = torch.frombuffer(bytearray(
                    _DP_REF_MAGIC + int(pull_id).to_bytes(8, "little")),
                    dtype=torch.uint8)
            else:
                buf = None
                if xfer_ok and _xfer_enabled() and \
                        _xfer_peer_ok(ctx, dev, from_rank):
                    try:
                        buf = torch.frombuffer(bytearray(_xfer_token(
                            ctx, dev, arr, rec[3], ev)), dtype=torch.uint8)
                        dev._stats_add("dp_xfer_tokens")
                    except Exception:
                        # before the wire: this pull still gets bytes
                        _dp_error(ctx, "transfer-plane token", dev,
                                  "this pull is served bytes")
                if buf is None:
                    buf = dev._serve_d2h(arr, ev)
            with _DP_LOCK:
                _DP_SERVING.setdefault(tag, []).append(buf)
            ptr_out[0] = buf.data_ptr()
            real_out[0] = arr.nbytes
            return buf.numel()
        except Exception:
            _dp_error(ctx, "serve", dev)
            return -1
        finally:
            if span is not None:
                dev._dp_close(span, "dp_serve_ns")

    def dp_serve_stream(user, tag, from_rank, xfer_ok, stream_id,
                        total) -> int:
        """Progressive-serve offer (wire v4 streaming): accept by
        ENQUEUEING the sliced d2h on the owning device's writeback lane
        (never block: this runs on the comm thread).  Declined for a
        colocated consumer, whose by-ref handoff moves the tile on the
        card, and for one the transfer plane serves a token."""
        dev = None
        try:
            if not _knobs.get("device.stream_serve"):
                return 0
            if from_rank in ctx._colocated:
                return 0
            with _DP_LOCK:
                rec = _DP_REG.get(tag)
            if rec is None:
                return 0
            arr, dev = rec[0], rec[4]
            if xfer_ok and _xfer_enabled() and \
                    _xfer_peer_ok(ctx, dev, from_rank):
                return 0
            if int(arr.nbytes) != int(total):
                return 0
            if dev._wb_thread is None or not dev._wb_thread.is_alive():
                return 0
            with _DP_LOCK:
                # placeholder pin: the engine calls dp_serve_done once per
                # serve, streamed or not; without a matching push the
                # retire would pop a concurrent synchronous serve's buffer
                _DP_SERVING.setdefault(tag, []).append(None)
            dev._wb_q.put(("stream", [], (int(stream_id), int(tag))))
            return 1
        except Exception:
            _dp_error(ctx, "stream offer", dev)
            return 0

    def dp_serve_done(user, tag) -> None:
        with _DP_LOCK:
            pins = _DP_SERVING.get(tag)
            if pins:
                pins.pop()
                if not pins:
                    _DP_SERVING.pop(tag, None)
            rec = _DP_REG.get(tag)
            if rec is not None:
                rec[1] -= 1
                if rec[1] <= 0:
                    _DP_REG.pop(tag, None)
                    _DP_BY_KEY.pop(rec[2], None)

    def dp_deliver(user, ptr, size, tag) -> int:
        """A payload (or a by-ref token) arrived for a device-plane dep:
        place it on this context's least-loaded device and return the
        cache uid stamped on the new host copy.  Timed as a DEVICE_DP_RECV
        span."""
        dev = span = None
        try:
            # a running device: a stopped one stays in ctx._devices (its
            # stats still count) but has no manager to consume from it
            devs = [d for d in ctx._devices if not d._stop.is_set()]
            if not devs or size <= 0:
                return 0
            dev = min(devs, key=lambda d: ctx.device_queue_depth(d.qid))
            span = dev._dp_open(KEY_DEVICE_DP_RECV, size, -1)
            src = (C.c_uint8 * size).from_address(ptr)
            if size == 16 and bytes(src[:8]) == _DP_REF_MAGIC:
                pull_id = int.from_bytes(bytes(src[8:]), "little")
                with _DP_LOCK:
                    hand = _DP_XFER.pop(pull_id, None)
                if hand is None:
                    raise RuntimeError(f"by-ref token {pull_id} unknown")
                arr, was_raw, ev = hand
                darr, dev_ev = dev._clone_in(arr, ev)
                uid = _next_uid()
                # rawness travels with the tensor: a relayed raw mirror
                # stays raw (its consumers reinterpret at stage-in)
                dev._cache_put(uid, 0, darr, darr.nbytes, raw=was_raw,
                               event=dev_ev)
                dev._stats_add("dp_d2d_bytes", darr.nbytes)
                dev._pf_wake.set()
                return uid
            if size > 8 and bytes(src[:8]) == _DP_XFER_MAGIC:
                # a transfer-plane token: pull card to card.  Past this
                # point there is no byte path: a failure fails the
                # consuming task (its uid is marked failed)
                try:
                    darr, dev_ev, was_raw = dev._xfer_pull(bytes(src))
                except Exception:
                    _dp_error(ctx, "transfer-plane pull", dev,
                              "the consuming pool aborts")
                    uid = _next_uid()
                    with _DP_LOCK:
                        _DP_FAILED.add(uid)
                    return uid
                uid = _next_uid()
                dev._cache_put(uid, 0, darr, darr.nbytes, raw=was_raw,
                               event=dev_ev)
                dev._stats_add("dp_xfer_bytes", darr.nbytes)
                dev._pf_wake.set()
                return uid
            darr, dev_ev = dev._h2d_async(
                torch.frombuffer(src, dtype=torch.uint8))
            uid = _next_uid()
            # version 0 matches the fresh wire-materialized copy; raw: the
            # first stage-in reinterprets to the consumer's dtype/shape
            dev._cache_put(uid, 0, darr, size, raw=True, event=dev_ev)
            dev._stats_add("dp_recv_bytes", size)
            # a remote tile just landed: wake the lane now
            dev._pf_wake.set()
            return uid
        except Exception:
            _dp_error(ctx, "deliver", dev)
            return 0
        finally:
            if span is not None:
                dev._dp_close(span, "dp_recv_ns")

    def dp_bound(user, uid, ptr, size, host_valid) -> None:
        """The consumer-side host copy now exists: bind it as the mirror's
        writeback target.  host_valid=0 (a by-ref delivery: the host
        buffer was never written) marks the mirror dirty, so a host read
        materializes it through the coherence pull."""
        try:
            for dev in list(ctx._devices):
                with dev._lock:
                    ent = dev._cache.get(uid)
                    if ent is None:
                        continue
                    ent.host = np.ctypeslib.as_array(
                        (C.c_uint8 * size).from_address(ptr))
                    if not host_valid:
                        ent.dirty = True
                    ent.persistent = False  # a wire copy, not user Data
                    return
        except Exception:
            _dp_error(ctx, "bind")

    return (dp_register, dp_serve, dp_serve_done, dp_deliver, dp_bound,
            dp_serve_stream)


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
        # pf: staged ahead by the prefetch lane (1; 2: a chain hint's
        # stage), not consumed yet (cleared, and counted as a prefetch
        # hit, at the first stage-in)
        self.pf = 0
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
        # (host, card) identity: the transfer plane's peer check
        self._ident = _card_identity(dev) if dev.type == "cuda" else None
        self.ctx = ctx
        self.qid = ctx.device_queue_new()
        # max tasks fused into one launch, and a byte cap on one launch's
        # lane stacks (the count cap alone is blind to tile size)
        self.batch_max = int(os.environ.get("PTC_DEVICE_BATCH", "128"))
        # opt-in coalescing window (ms; a caller sets it): after a
        # MULTI-task drain, keep popping for up to this long so that a
        # wave being released by the workers lands in ONE dispatch (0 =
        # off; a single-task pop never waits, so latency-bound chains are
        # unaffected)
        self.batch_wait_ms = 0.0
        self.batch_max_bytes = int(
            os.environ.get("PTC_DEVICE_BATCH_BYTES", str(2 << 30)))
        # the live pools' records by native pointer (_PoolRecord)
        self._pools: Dict[int, _PoolRecord] = {}
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
        # the lane is at rest after a dry sweep (device/prefetch.py): its
        # handoff() declines; set by the lane, cleared by _pf_rouse, read
        # unlocked
        self._pf_rest = False
        # wakes the lane's idle wait now instead of at its poll interval
        # (the comm engine's deliveries will set it; tests set it)
        self._pf_wake = threading.Event()
        # chain prefetch hints [(collection name, idx)]: the external
        # tiles the wave compiler predicts the NEXT chain segment reads;
        # the prefetch lane stages them beside the peeked lookahead
        self._pf_chain_hints: list = []
        # bytes of the parked chain results' output stacks (fuse.py): they
        # live outside the cache accounting until their tasks consume
        # them, so the wave compiler's planner and the lane's reservation
        # count them, and a chain under residency pressure is refused
        self._chain_pinned = 0
        # the fused mark of the NEXT DEVICE_DISPATCH begin (manager thread
        # only): 0 plain, n >= 1 a certified wave of a chain of n waves
        self._disp_fused = 0
        # bumped by every host-side overwrite of a mirrored copy: a lane
        # stage that began before one is discarded (it may have copied
        # the bytes being replaced)
        self._host_epoch = 0
        # host-to-device stages of tiles in flight, uid -> an Event set
        # once the stage is installed or given up: the prefetch lane
        # leaves a tile the manager is staging, and the manager waits for
        # a tile the lane is staging, so no tile's bytes cross twice
        self._staging: Dict[int, threading.Event] = {}
        # dispatch-time h2d stall since the last DEVICE_DISPATCH end
        # (manager thread only): read and reset at each end, so a chain's
        # staging before its span opens lands in that span's end aux
        self._disp_stall_ns = 0
        # the manager's time partition (manager thread only, _mgr_to):
        # the bucket under way, when it began (perf_counter ns), its
        # span's (class, l0, begin aux), and the loop's start and end
        self._mgr_bucket = _PLAN
        self._mgr_t = 0
        self._mgr_span = (-1, 0, 0)
        self._mgr_traced = False  # whether that span's BEGIN was emitted
        self._mgr_t0 = self._mgr_t1 = 0
        # every key pre-populated: the dict never resizes after init, so a
        # concurrent info() copy cannot hit a changed-size error.  Names
        # follow the reference device module's stats.
        self.stats = {"tasks": 0, "h2d_bytes": 0, "d2h_bytes": 0,
                      # the part of h2d_bytes staged at dispatch (_h2d:
                      # the prefetch lane's misses); the rest reached
                      # the card ahead of the task that read it
                      "h2d_dispatch_bytes": 0,
                      # flush(): the bytes it wrote back to the host and
                      # its time, the DEVICE_FLUSH spans' sum
                      "flush_bytes": 0, "flush_ns": 0,
                      "h2d_hits": 0, "evictions": 0, "dead_drops": 0,
                      "batches": 0, "batched_tasks": 0,
                      "invalidations": 0, "eager_gathers": 0,
                      "fused_flows": 0, "wb_tasks": 0, "f64_refused": 0,
                      "h2d_stall_ns": 0, "cache_peak_bytes": 0,
                      "d2d_bytes": 0,
                      "spec_store": 0, "spec_hits": 0, "spec_misses": 0,
                      # DTD lane batching: launches of more than one DTD
                      # task and their tasks, signatures vmap refused
                      # (then one launch a task), cuts of a group whose
                      # members touch a copy another writes
                      "dtd_batches": 0, "dtd_batched_tasks": 0,
                      "dtd_unbatchable": 0, "dtd_splits": 0,
                      # device pipeline (prefetch lane + residency planner)
                      "prefetch_staged": 0, "prefetch_bytes": 0,
                      "prefetch_hits": 0, "prefetch_misses": 0,
                      "prefetch_wasted": 0, "reserve_fails": 0,
                      "spills": 0, "spill_bytes": 0,
                      "prefetch_h2d_ns": 0, "ooc_waits": 0,
                      "prefetch_wakeups": 0,
                      # the lane's rest (device/prefetch.py): sweeps that
                      # found every lookahead tile current, and returns
                      # from rest to its engaged pace (lane thread); the
                      # manager's handoffs that waited for it and those it
                      # declined at rest, and its time in them, a part of
                      # mgr_plan_ns (manager thread, unlocked as mgr_*)
                      "pf_dry_sweeps": 0, "pf_engagements": 0,
                      "pf_handoffs": 0, "pf_handoffs_skipped": 0,
                      "pf_handoff_ns": 0,
                      # the lane's stages of the wave compiler's chain
                      # hints: staged, served at a stage-in, refused
                      "prefetch_hint_stages": 0, "prefetch_hint_hits": 0,
                      "prefetch_hint_wasted": 0,
                      # the data plane: tags registered for remote sends,
                      # payload bytes delivered over the wire and as on-
                      # card clones (colocated), bytes served by a whole
                      # d2h, its host ns and its copy's ns, callbacks that
                      # failed (the host path then carried the dependency)
                      "dp_sends": 0, "dp_recv_bytes": 0, "dp_d2d_bytes": 0,
                      "dp_serve_bytes": 0, "dp_serve_d2h_ns": 0,
                      "dp_serve_copy_ns": 0, "dp_errors": 0,
                      # the host's time in the serve and deliver
                      # callbacks: the DEVICE_DP_SERVE and DEVICE_DP_RECV
                      # spans' sums
                      "dp_serve_ns": 0, "dp_recv_ns": 0,
                      # the transfer plane (device.dp_transfer): tokens
                      # served, bytes pulled card to card and the pulls'
                      # host ns (the first pull of a peer opens its
                      # session: comm/ici.TransferSessionPool)
                      "dp_xfer_tokens": 0, "dp_xfer_bytes": 0,
                      "dp_xfer_pull_ns": 0,
                      # progressive serve (writeback lane slicing)
                      "stream_serves": 0, "stream_slices": 0,
                      "stream_d2h_ns": 0, "stream_copy_ns": 0,
                      "stream_bytes": 0,
                      # the manager thread's time partition (written by
                      # that thread alone, unlocked: see _mgr_to)
                      "mgr_wait_ns": 0, "mgr_plan_ns": 0,
                      "mgr_dispatch_ns": 0, "mgr_complete_ns": 0,
                      # a part of mgr_plan_ns: the wave compiler's time
                      # having a pool's chain certificates (device/fuse.py)
                      "cert_ns": 0}
        # the comm engine's counters as info() last read them
        self._comm_seen = dict.fromkeys(
            ("comm_msgs_sent", "comm_msgs_recv", "comm_bytes_sent",
             "comm_bytes_recv", "comm_rdv_gets"), 0)
        # chore name -> [launches, lanes]: one launch per kernel call of
        # the manager (epilogues included), written under self._lock
        self.launches: Dict[str, List[int]] = {}
        # parked speculative results: ((pool key, dst class id), dst key)
        # -> (output stacks, src uid, src version); bounded by _spec_put
        self._spec: Dict[tuple, tuple] = {}
        # the wave compiler (device.wave_fuse; None = off: the per-group
        # batched dispatch, bit for bit)
        self._fuser: Optional[WaveFuser] = None
        if bool(_knobs.get("device.wave_fuse")):
            self._fuser = WaveFuser(self)
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
        # device data plane: remote deps with a current device mirror ride
        # PK_DEVICE rendezvous instead of the host eager/GET paths
        if getattr(ctx, "_dp_cbs", None) is None:
            reg, srv, done, dlv, bnd, strm = _make_dp_callbacks(ctx)
            ctx._dp_cbs = (N.DP_REGISTER_CB_T(reg), N.DP_SERVE_CB_T(srv),
                           N.DP_SERVE_DONE_CB_T(done),
                           N.DP_DELIVER_CB_T(dlv), N.DP_BOUND_CB_T(bnd))
            N.lib.ptc_set_dataplane(ctx._ptr, *ctx._dp_cbs, None)
            # the progressive-serve offer hook (kept alive beside the
            # tuple: a ctypes thunk dies with its last reference)
            ctx._dp_stream_cb = N.DP_STREAM_CB_T(strm)
            N.lib.ptc_set_dp_stream(ctx._ptr, ctx._dp_stream_cb)
        # the transfer plane's pull bit follows device.dp_transfer as the
        # newest device on the context reads it
        self._xfer_advertise()
        ctx._devices.append(self)  # stopped before the native ctx dies
        _ALL_DEVICES.append(self)
        # writeback lane (reference: the CUDA stage-out stream,
        # device_cuda_module.c:2197): host coherence of sync-mem-out flows
        # and out-of-core spills run here, not in the dispatch loop; the
        # tasks complete from this lane once their host bytes are coherent
        self._wb_q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._wb_thread: Optional[threading.Thread] = None
        self._dbg(f"device up: {self.device} queue={self.qid} "
                  f"cache={cache_bytes >> 20}MiB batch<= {self.batch_max}")
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

    def _record(self, stream=None,
                timing: bool = False) -> Optional["torch.cuda.Event"]:
        """An event at the current end of `stream` (the exec stream by
        default), one that times when `timing`; None on the CPU."""
        if self._stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=timing)
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
        The staging is pinned with this device's card current (the h2d
        stream's context makes it so), whatever card the calling thread
        has: the data plane delivers on the comm thread, whose card is
        the process's first, and pinning there would open a context on
        a card this device does not use.
        On the CPU: (an owned clone, None)."""
        if self._stream is None:
            return src.clone(), None
        with torch.cuda.stream(self._h2d_stream):
            stage = self._pinned(src.shape, src.dtype)
            stage.copy_(src)
            out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            out.copy_(stage, non_blocking=True)
            ev = self._record(self._h2d_stream)
        out.record_stream(self._stream)
        return out, ev

    def _prof_h2d(self, phase: int, nbytes: int, scope: int,
                  lane: int) -> None:
        """One h2d staging event, l0 = bytes, l1 = this device's queue,
        class = the request scope (-1: none), aux = the lane: DEVICE_H2D
        (0: a dispatch-time stall) or DEVICE_H2D_AHEAD (1: staged off the
        dispatch path).  No call while nothing listens."""
        if self.ctx._listening:
            N.prof_event_held(self.ctx._ptr,
                              KEY_H2D_AHEAD if lane else KEY_H2D, phase,
                              scope, nbytes, self.qid, lane)

    def _h2d(self, host: np.ndarray, scope: int = -1):
        """Dispatch-time h2d of one host array, for the exec stream: the
        copy runs on the h2d stream and the exec stream waits on its
        event.  Returns (device tensor, event).  The host's time from the
        copy into pinned staging to the enqueue is the launch's h2d stall
        (stats["h2d_stall_ns"], and its DEVICE_DISPATCH end's aux), traced
        as a DEVICE_H2D span whose class is the dispatching task's request
        scope (`scope`, -1: none).  Its bytes count in h2d_bytes and in
        h2d_dispatch_bytes."""
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
            self.stats["h2d_dispatch_bytes"] += host.nbytes
        # always-on metrics: the stall joins the native h2d_stall
        # histogram at the span-close instant of its DEVICE_H2D event
        N.lib.ptc_metrics_record(self.ctx._ptr, N.MET_H2D_STALL, -1, stall)
        return out, ev

    def _h2d_ahead(self, host: np.ndarray):
        """h2d of one host array off the dispatch path (the caller's
        thread: stage_collection, the panel DAGs' index segments, a check's
        read of a tile with no mirror), for the exec stream.  Counted in
        h2d_bytes and traced as a DEVICE_H2D_AHEAD span, not as a
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
        if evict:
            self._pf_rouse()

    def _pf_rouse(self) -> None:
        """Re-engage a resting prefetch lane (device/prefetch.py): a tile
        was staged from the host at dispatch, evicted or spilled, or a
        collection pre-staged, so a lookahead tile may want staging.  A
        no-op while the lane is engaged or off.  Takes no lock: callers
        may hold self._lock."""
        if self._pf_rest:
            self._pf_rest = False
            self._pf_wake.set()

    def _cache_put(self, uid, version, arr, nbytes, dirty=False, host=None,
                   persistent=True, stack=None, idx=0, event=None,
                   raw=False):
        spill = []
        with self._lock:
            old = self._cache.pop(uid, None)
            if old is not None:
                self._uncharge(old)
            ent = _CacheEnt(uid, version, arr, nbytes, dirty, host,
                            persistent, stack, idx, raw=raw, event=event)
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
        self._pf_rouse()

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
        lookahead and never an unconsumed prefetch.  The parked chain
        results' bytes count against the budget too.  False: the working
        set does not fit, the lane skips the tile and it is staged on
        demand at dispatch instead of thrashing."""
        with self._lock:
            budget = (self._cache_bytes - self._pf_reserved
                      - self._chain_pinned - nbytes)
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
                            epoch: int, hint: bool = False) -> bool:
        """Install a prefetched raw (flat uint8) mirror and release its
        reservation.  NEVER displaces an existing entry: the wave in
        flight may be reading it, and a dirty entry is newer than the
        host bytes this was staged from.  Also refused when a host-side
        overwrite happened since the stage began (`epoch`), or when some
        device holds a mirror of this version or a newer one (its bytes,
        not the host's, are current).  `hint`: a chain hint's stage.
        Returns False on a refusal (a wasted stage, counted)."""
        with self._lock:
            self._pf_reserved = max(0, self._pf_reserved - nbytes)
            q, v = self.ctx.device_get_data_owner(uid)
            if uid in self._cache or epoch != self._host_epoch \
                    or (q >= 0 and v >= version):
                self.stats["prefetch_wasted"] += 1
                return False
            ent = _CacheEnt(uid, version, arr, nbytes, persistent=False,
                            raw=True, event=event)
            ent.pf = 2 if hint else 1
            self._cache[uid] = ent
            self._charge(ent)
            self.stats["prefetch_staged"] += 1
            self.stats["prefetch_bytes"] += int(nbytes)
            N.lib.ptc_device_set_data_owner(self.ctx._ptr, uid, self.qid,
                                            version)
        return True

    def _consume_pf(self, uid: int) -> int:
        """First stage-in of a prefetched tile: clear the flag (so the hit
        counts once and its staging slot can recycle) and return it (0:
        no unconsumed prefetch)."""
        with self._lock:
            ent = self._cache.get(uid)
            if ent is not None and ent.pf:
                pf, ent.pf = ent.pf, 0
                return pf
        return 0

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

    def plan_check(self, tp, mode: Optional[str] = None, plan=None):
        """Pre-run residency check: compare the pool's predicted per-rank
        DEVICE working set (analysis.plan) against this device's byte
        budget before anything schedules.

          fits            -> silent (counters only)
          over budget,
          out_of_core=0   -> warn to stderr, or raise PlanCheckError with
                             mode="error": the run would hold device
                             memory past budget until it runs out
          over budget,
          out_of_core=1   -> warn with the PREDICTED SPILL COUNT (the run
                             completes out-of-core; the number is the d2h
                             write-back traffic to expect)

        `mode` defaults to the device.plan_check knob; Taskpool.run calls
        this when the knob is armed.  An analysis failure never blocks a
        run (warned, no check counted).  Counts into the Context's
        stats()["plan"].  Returns the (possibly supplied) Plan, or None
        when the pool has no device-chore classes or analysis failed."""
        if mode is None:
            mode = _knobs.get("device.plan_check")
        if not mode or mode == "off":
            return None
        try:
            if plan is None:
                plan = tp.plan()
        except Exception as e:  # analysis must never kill a run
            sys.stderr.write(f"ptc [plan]: plan_check skipped: {e}\n")
            return None
        if not plan.has_device_classes:
            return None
        rank = getattr(self.ctx, "myrank", 0)
        peak = plan.peak_bytes(rank=rank if rank in plan.per_rank
                               else None, device_only=True)
        ps = self.ctx._plan_stats
        with self._lock:
            budget = self._cache_bytes
        ps["checks"] += 1
        ps["last_peak_bytes"] = int(peak or 0)
        ps["last_budget_bytes"] = int(budget)
        if plan.bounded and peak is None:
            sys.stderr.write(
                "ptc [plan]: plan_check inconclusive (symbolic bound "
                "unavailable); proceeding\n")
            return plan
        if peak <= budget:
            return plan
        ps["over_budget"] += 1
        if self._ooc:
            spills = plan.predict_spills(budget, rank=rank,
                                         device_only=True)
            ps["predicted_spills"] += spills
            sys.stderr.write(
                f"ptc [plan]: predicted device working set {peak} B "
                f"exceeds cache budget {budget} B; out-of-core will "
                f"spill (~{spills} predicted write-backs)\n")
            return plan
        msg = (f"predicted device working set {peak} B exceeds the "
               f"cache budget {budget} B with device.out_of_core=0: "
               "the run would hold device memory past budget (raise the "
               "budget, re-enable out-of-core, or shrink the tiling)")
        if mode == "error":
            from ..analysis.plan import PlanCheckError
            raise PlanCheckError(msg)
        sys.stderr.write(f"ptc [plan]: {msg}\n")
        return plan

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
        """Device info object: identity, capacity, live cache state.
        attached_classes counts the device chores of the pools this
        device holds a record of: pools not destroyed yet (and aborted
        ones, until stop())."""
        with self._lock:
            cache_n = len(self._cache)
            cache_b = self._cache_used
            stats = dict(self.stats)
            attached = sum(len(r.bodies) for r in self._pools.values())
        # the manager loop's wall time so far (the four mgr_* buckets'
        # whole), and the collector's process totals
        t0, t1 = self._mgr_t0, self._mgr_t1
        stats["mgr_wall_ns"] = (t1 or time.perf_counter_ns()) - t0 \
            if t0 else 0
        stats["gc_pause_ns"] = _GC.pause_ns
        stats["gc_full_passes"] = _GC.full_passes
        stats.update(self._comm_counters())
        on_card = self.device.type == "cuda"
        fz = self._fuser
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
            # the wave compiler's counters (the same keys when it is off)
            "fuse": fz.snapshot() if fz is not None else {
                "enabled": False, "fused_waves": 0, "fused_tasks": 0,
                "fused_chains": 0, "chain_waves": 0, "chain_parked": 0,
                "chain_hits": 0, "chain_misses": 0, "chain_drops": 0,
                "cache_hits": 0, "cache_misses": 0, "parked": 0,
                "refused": {}, "cert_hits": 0, "cert_misses": 0,
                "cert_uncached": {}},
        }

    def _comm_counters(self) -> dict:
        """The context's comm engine counters, for info()["stats"]: its
        ctx.comm_stats() as comm_msgs_sent, comm_msgs_recv,
        comm_bytes_sent, comm_bytes_recv, and the rendezvous GETs it sent
        as comm_rdv_gets.  Zero until comm_init; the last reading once
        the engine or the context is gone."""
        ctx = self.ctx
        if not ctx._destroyed and ctx.comm_enabled:
            st = ctx.comm_stats()
            self._comm_seen = {
                "comm_msgs_sent": st["msgs_sent"],
                "comm_msgs_recv": st["msgs_recv"],
                "comm_bytes_sent": st["bytes_sent"],
                "comm_bytes_recv": st["bytes_recv"],
                "comm_rdv_gets": ctx.comm_rdv_stats()["gets_sent"]}
        return self._comm_seen

    def _dbg(self, msg: str):
        """Device-subsystem debug stream (PTC_MCA_debug_device >= 1;
        reference: the per-subsystem output streams, parsec/utils/debug.c)."""
        if N.lib.ptc_context_verbose(self.ctx._ptr, N.DBG_DEVICE) >= 1:
            print(f"ptc [device]: {msg}", file=sys.stderr)

    def flush(self):
        """Write every dirty device mirror back to its host copy: same-
        size mirrors move as stacked d2h copies on the d2h stream, into
        pinned staging, then into the host tiles.  Call before bulk host
        reads (to_dense etc.); per-copy coherence for CPU chores is
        automatic via sync_handle().  Once the writeback lane's queue has
        drained, the write-back is a DEVICE_FLUSH span (l0 = its bytes)
        and counts in stats["flush_ns"] and stats["flush_bytes"]."""
        self._wb_barrier()
        with self._lock:
            # only persistent (user-Data-backed) hosts are written: arena
            # buffers can be freed concurrently by the last consumer
            dirty = [e for e in self._cache.values()
                     if e.dirty and e.persistent]
        if dirty:
            self._dbg(f"flush: {len(dirty)} dirty mirrors")
        nbytes = sum(e.arr.nbytes for e in dirty)
        traced = self.ctx._listening
        t0 = time.perf_counter_ns()
        if traced:
            N.prof_event_held(self.ctx._ptr, KEY_DEVICE_FLUSH, 0, -1,
                              nbytes, self.qid, 0)
        try:
            self._write_back(dirty)
        finally:
            if traced:
                N.prof_event_held(self.ctx._ptr, KEY_DEVICE_FLUSH, 1, -1,
                                  nbytes, self.qid, 0)
            with self._lock:
                self.stats["flush_ns"] += time.perf_counter_ns() - t0
                self.stats["flush_bytes"] += nbytes

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
        cross-lane semantics.

        The body is filed in the pool's record (_PoolRecord, made by the
        pool's first attachment here), which tp.destroy() drops."""
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
        with self._lock:
            rec = self._pool(tp)
            body = _DeviceBody(kernel, reads, writes, shapes, dtypes, tc,
                               rec, batch=batch)
            if not sync_mem_out:
                body.mem_out_flows = set()
            rec.bodies[tc.id] = body

    def _pool(self, tp: Taskpool) -> _PoolRecord:
        """The pool's record, made at its first call (under self._lock)."""
        return self._pools.get(tp._ptr) or \
            self._pools.setdefault(tp._ptr, _PoolRecord(tp))

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
        rec = self._pools.get(tp._ptr)
        src = rec and rec.bodies.get(src_tc.id)
        dst = rec and rec.bodies.get(dst_tc.id)
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
        epi = _Epilogue((rec.key, dst_tc.id), kernel, pick, dst_params, ops,
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
        self._pf_rouse()

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
        # before it runs would find it not alive and not wait; and the
        # prefetch lane too, so that the manager hands off to it
        # (handoff) from its first wave on
        self._wb_thread.start()
        if self._pf_enabled:
            self._pf_lane = _PrefetchLane(self, depth=self._pf_depth,
                                          slots=self._pf_slots_max)
            self._pf_lane.start()
        _GC.attach(self)
        self._thread.start()

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
                    elif kind == "stream":
                        # progressive serve: slice a remote-pulled
                        # mirror's d2h through the engine's watermark
                        self._stream_serve(*payload)
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

    # ------------------------------------------------------------ data plane
    def _dp_open(self, key: int, nbytes: int, peer: int) -> tuple:
        """Begin a data-plane callback's stretch: (key, bytes, peer, start
        ns, traced), its span's BEGIN emitted while a trace or a PINS
        chain listens (l0 = bytes, l1 = this device's queue, aux = the
        peer rank or -1)."""
        traced = self.ctx._listening
        t0 = time.perf_counter_ns()
        if traced:
            N.prof_event_held(self.ctx._ptr, key, 0, -1, nbytes, self.qid,
                              peer)
        return key, nbytes, peer, t0, traced

    def _dp_close(self, span: tuple, counter: str) -> None:
        """End a stretch _dp_open began: its END where its BEGIN was
        emitted, and its time into stats[counter]."""
        key, nbytes, peer, t0, traced = span
        if traced:
            N.prof_event_held(self.ctx._ptr, key, 1, -1, nbytes, self.qid,
                              peer)
        self._stats_add(counter, time.perf_counter_ns() - t0)

    def _serve_d2h(self, arr: torch.Tensor, event) -> torch.Tensor:
        """A pull's bytes (the synchronous serve): one d2h of the pinned
        payload on the d2h stream after its event, into a pinned host
        buffer, waited on by that copy's event alone.  Counted in
        dp_serve_bytes, dp_serve_d2h_ns (the host wall, the wait for the
        payload's event included) and dp_serve_copy_ns (the copy alone,
        CUDA events), not in d2h_bytes (no host copy of the tile is
        written).  On the CPU: an owned byte copy."""
        t0 = time.perf_counter_ns()
        flat = arr.reshape(-1).view(torch.uint8)
        copy_ns = 0
        if self._stream is None:
            buf = flat.clone()
        else:
            with torch.cuda.stream(self._d2h_stream):
                self._await(event)
                arr.record_stream(self._d2h_stream)
                buf = self._pinned(flat.shape, torch.uint8)
                began = self._record(self._d2h_stream, timing=True)
                buf.copy_(flat, non_blocking=True)
                done = self._record(self._d2h_stream, timing=True)
            done.synchronize()
            copy_ns = int(began.elapsed_time(done) * 1e6)
        with self._lock:
            self.stats["dp_serve_bytes"] += buf.numel()
            self.stats["dp_serve_d2h_ns"] += time.perf_counter_ns() - t0
            self.stats["dp_serve_copy_ns"] += copy_ns
        return buf

    def _xfer_advertise(self) -> None:
        """The transfer plane's consumer side at device init: probe the
        plane (_xfer_can_pull), share this rank's (host, card) identity
        with every peer through the comm engine's blob frame, and set the
        GET frames' pull bit.  With the plane off, without comm up, or
        where the probe fails, the bit is clear and producers serve this
        rank bytes."""
        ctx = self.ctx
        ok = _xfer_enabled() and ctx.comm_enabled and \
            self._ident is not None and _xfer_can_pull(self)
        if ok:
            ctx._dp_ident = dict(self._ident)
            blob = json.dumps({"rank": ctx.myrank, "dp": self._ident}) \
                .encode()
            ok = N.lib.ptc_comm_share_blob(ctx._ptr, blob, len(blob)) == 0
        N.lib.ptc_set_dp_can_pull(ctx._ptr, 1 if ok else 0)

    def _xfer_pull(self, tok: bytes):
        """Resolve a transfer-plane token: map the producer's tensor
        through its peer's session (the first pull of a peer establishes
        it), clone it into this device's memory on the h2d stream (after
        the producer's event), wait on the clone's event and drop the
        mapping.  Returns (tensor, the clone's event, raw)."""
        t0 = time.perf_counter_ns()
        f = _xfer_decode(tok)
        if self._stream is None:
            raise RuntimeError("a transfer-plane token needs a card")
        with torch.cuda.stream(self._h2d_stream):
            conn = _IpcConnect(f, self.device)
            _xfer_sessions(self.ctx.myrank).get(conn, f["addr"], f["rank"])
            view = conn.view if conn.view is not None else \
                _ipc_open(f, self.device)
            out = view.clone()
            done = self._record(self._h2d_stream)
        done.synchronize()
        del view, conn
        out.record_stream(self._stream)
        self._stats_add("dp_xfer_pull_ns", time.perf_counter_ns() - t0)
        return out, done, bool(f["raw"])

    def _clone_in(self, arr: torch.Tensor, event):
        """A colocated payload onto this device: a clone on the h2d stream
        after the producer's event (comm/ici.py device_transfer), for the
        exec stream.  Returns (tensor, the clone's event)."""
        if self._stream is None:
            return device_transfer(arr, self.device), None
        with torch.cuda.stream(self._h2d_stream):
            out = device_transfer(arr, self.device, event=event)
            done = self._record(self._h2d_stream)
        out.record_stream(self._stream)
        return out, done

    def _stream_serve(self, stream_id: int, tag: int) -> None:
        """Progressive-serve slicer (writeback lane): d2h the registered
        payload in comm.chunk_size slices, pushing each through
        ptc_dp_serve_progress, so the engine's watermark advances and the
        wire starts after the FIRST slice instead of the whole tile.  Two
        pinned slice buffers alternate: slice k+1's copy is on the d2h
        stream while slice k is pushed (the engine copies what it is
        given).  The engine answers 0 when the session is gone (retired,
        or the puller lost): stop; dp_serve_done drops the pin.
        stream_d2h_ns is the loop's host wall (copies, pushes and the
        wire's pace), stream_copy_ns the slices' copies alone (CUDA
        events)."""
        with _DP_LOCK:
            rec = _DP_REG.get(tag)
        if rec is None:
            return  # raced a release; the engine reaps on peer loss
        arr, ev = rec[0], rec[5]
        flat = arr.reshape(-1).view(torch.uint8)
        total = flat.numel()
        item = arr.element_size()
        chunk = int(self.ctx.comm_tuning().get("chunk_size") or (1 << 20))
        step = max(item, chunk // item * item)
        on_card = self._stream is not None
        if on_card:
            bufs = [self._pinned((min(step, total),), torch.uint8)
                    for _ in range(2)]

        def start(k: int):
            off = k * step
            n = min(step, total - off)
            if not on_card:
                return off, flat[off:off + n], None
            with torch.cuda.stream(self._d2h_stream):
                if k == 0:
                    self._await(ev)
                    arr.record_stream(self._d2h_stream)
                b = bufs[k % 2][:n]
                began = self._record(self._d2h_stream, timing=True)
                b.copy_(flat[off:off + n], non_blocking=True)
                return off, b, (began, self._record(self._d2h_stream,
                                                    timing=True))

        if self.ctx._listening:
            N.prof_event_held(self.ctx._ptr, KEY_STREAM, 0, -1, total,
                              self.qid, 0)
        t0 = time.perf_counter_ns()
        nslices = (total + step - 1) // step
        slices = sent = copy_ns = 0
        try:
            nxt = start(0) if nslices else None
            for k in range(nslices):
                off, b, evs = nxt
                nxt = start(k + 1) if k + 1 < nslices else None
                if evs is not None:
                    evs[1].synchronize()
                    copy_ns += int(evs[0].elapsed_time(evs[1]) * 1e6)
                while True:
                    rc = N.lib.ptc_dp_serve_progress(
                        self.ctx._ptr, stream_id, b.data_ptr(), off,
                        b.numel())
                    if rc != -1:
                        break
                    # the session install races the accept callback
                    time.sleep(0.0002)
                if rc == 0:
                    return  # session reaped: stop slicing
                slices += 1
                sent += b.numel()
                if rc == 2:
                    return  # absorbed, and the session completed with it
        finally:
            dt = time.perf_counter_ns() - t0
            if self.ctx._listening:
                N.prof_event_held(self.ctx._ptr, KEY_STREAM, 1, -1, total,
                                  self.qid, 0)
            with self._lock:
                self.stats["stream_serves"] += 1
                self.stats["stream_slices"] += slices
                self.stats["stream_d2h_ns"] += dt
                self.stats["stream_copy_ns"] += copy_ns
                self.stats["stream_bytes"] += sent

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
        """Flush dirty mirrors, stop the lanes and the manager, and drop
        every pool record left (an aborted pool's among them)
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
        _GC.detach(self)
        with self._lock:
            for k in self._cache:
                N.lib.ptc_device_clear_data_owner(self.ctx._ptr, k,
                                                  self.qid)
            self._cache.clear()
            self._stacks.clear()
            self._spec.clear()
            self._pools.clear()
            self._cache_used = 0
        if self._fuser is not None:
            self._fuser.clear()

    def _mgr_to(self, bucket: Optional[int], cid: int = -1, l0: int = 0,
                aux: int = 0) -> None:
        """Manager thread only: close the stretch of its time partition
        under way and open one of `bucket` (None: close only, at the
        loop's end).  One clock read: the stretch's time joins its
        counter, and while something listens its span ends and the new
        one begins there, with class `cid`, l0 `l0`, the device's queue
        and `aux`.  Leaving DEVICE_DISPATCH ends its span with the h2d
        stall as aux and resets the stall and the fused mark.  A move
        to the bucket and span under way is no boundary."""
        old, span = self._mgr_bucket, (cid, l0, aux)
        if bucket == old and span == self._mgr_span:
            return
        ocid, ol0, end_aux = self._mgr_span
        if old == _DISPATCH:
            end_aux, self._disp_stall_ns, self._disp_fused = \
                self._disp_stall_ns, 0, 0
        listening = self.ctx._listening
        if listening:
            ptr, q = self.ctx._ptr, self.qid
            # an END only for a span that began
            seq = [partial(N.prof_event_held, ptr, _MGR_KEYS[old], 1, ocid,
                           ol0, q, end_aux)] if self._mgr_traced else []
            at = len(seq)
            seq.append(time.perf_counter_ns)
            if bucket is not None:
                seq.append(partial(N.prof_event_held, ptr, _MGR_KEYS[bucket],
                                   0, cid, l0, q, aux))
            now = _in_one_step(seq)[at]
        else:
            now = time.perf_counter_ns()
        self.stats[_MGR_STATS[old]] += now - self._mgr_t
        if bucket is not None:
            self._mgr_bucket, self._mgr_t, self._mgr_span = \
                bucket, now, span
            self._mgr_traced = listening

    def _mgr_tick(self) -> None:
        """Manager thread, inside a long stretch (at each empty poll of a
        wait): credit the stretch so far to its counter without ending
        it, so that counters read at any time miss at most one poll of
        it; and where tracing came on during the stretch, begin its span
        now."""
        seq = [time.perf_counter_ns]
        reopen = self.ctx._listening and not self._mgr_traced
        if reopen:
            c, n, a = self._mgr_span
            seq.append(partial(N.prof_event_held, self.ctx._ptr,
                               _MGR_KEYS[self._mgr_bucket], 0, c, n,
                               self.qid, a))
        now = _in_one_step(seq)[0]
        self.stats[_MGR_STATS[self._mgr_bucket]] += now - self._mgr_t
        self._mgr_t = now
        self._mgr_traced = self._mgr_traced or reopen

    def _disp_open(self, body: _DeviceBody, lanes: int) -> None:
        """Open a DEVICE_DISPATCH stretch: class = the task class id
        (-1 for a DTD body), l0 = lanes, l1 = this device's queue (so
        same-class spans of sibling devices pair apart), the BEGIN's aux
        = the fused mark (0 plain, n >= 1 a certified wave of a chain of
        n waves: device/fuse.py).  The next stretch ends it (_mgr_to)."""
        self._mgr_to(_DISPATCH, body.tc.id if body.tc is not None else -1,
                     lanes, self._disp_fused)

    def _disp_close(self, body: _DeviceBody, complete: int) -> None:
        """End a DEVICE_DISPATCH stretch before its tasks complete (a
        caller that takes the trace after tp.wait() finds the span
        closed): into the completion of `complete` tasks, or (0: they
        complete on the writeback lane, or failed) back to planning."""
        if complete:
            self._mgr_to(_COMPLETE,
                         body.tc.id if body.tc is not None else -1,
                         complete)
        else:
            self._mgr_to(_PLAN)

    def _manager(self):
        """Dispatch loop: drain every ready task, group by body (a class,
        or a DTD signature; pop order kept), and run each group as one
        launch.  Its time is partitioned as the module's docstring says
        (_mgr_to)."""
        seq = [time.perf_counter_ns]
        self._mgr_traced = self.ctx._listening
        if self._mgr_traced:
            seq.append(partial(N.prof_event_held, self.ctx._ptr,
                               KEY_DEVICE_PLAN, 0, -1, 0, self.qid, 0))
        self._mgr_t0 = self._mgr_t = _in_one_step(seq)[0]
        try:
            with self._on_stream(), torch.no_grad():
                self._manage()
        finally:
            self._mgr_to(None)
            self._mgr_t1 = time.perf_counter_ns()

    def _manage(self):
        while not self._stop.is_set():
            self._mgr_to(_PLAN)
            task = self.ctx.device_pop(self.qid, timeout_ms=0)
            if not task:
                # one DEVICE_WAIT stretch until a pop returns a task
                self._mgr_to(_WAIT)
                while not task and not self._stop.is_set():
                    task = self.ctx.device_pop(self.qid, timeout_ms=50)
                    if not task:
                        self._mgr_tick()
                self._mgr_to(_PLAN)
                if not task:
                    return
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
            if (len(batch) > 1 and self.batch_wait_ms > 0
                    and len(batch) < self.batch_max):
                self._mgr_to(_WAIT)
                deadline = time.monotonic() + self.batch_wait_ms / 1e3
                while (len(batch) < self.batch_max
                       and time.monotonic() < deadline):
                    t2 = self.ctx.device_pop(self.qid, timeout_ms=1)
                    if t2:
                        batch.append(t2)
                self._mgr_to(_PLAN)
            self._dispatch_front(batch)
            if self._pf_lane is not None and \
                    self.ctx.device_queue_depth(self.qid) > 0:
                # the wave consumed its staged tiles and the queue's
                # head moved: the lane stages the next waves now, on
                # the interpreter this thread yields (device/prefetch);
                # a lane at rest declines at once
                self._mgr_to(_PLAN)
                t0 = time.perf_counter_ns()
                waited = self._pf_lane.handoff()
                self.stats["pf_handoff_ns"] += time.perf_counter_ns() - t0
                self.stats["pf_handoffs" if waited
                           else "pf_handoffs_skipped"] += 1

    def _dispatch_front(self, batch: List) -> None:
        """Group a popped batch by body (a class, or a DTD signature; pop
        order kept) and run each group.  A method of its own so that no
        body, and so no pool record, outlives it in the manager's frame."""
        fz = self._fuser
        groups: List[Tuple[Optional[_DeviceBody], List]] = []
        index: Dict[int, int] = {}
        for t in batch:
            body = self._body_for(t)
            gi = index.get(id(body))
            if gi is None or body is None or not body.batch:
                if gi is not None and body is not None \
                        and body.tc is not None and fz is not None:
                    # >= 2 ready tasks of an unbatchable class: the
                    # wave exists but cannot fuse (counted)
                    fz._refuse("unbatchable-body")
                index[id(body)] = len(groups)
                groups.append((body, [t]))
            else:
                groups[gi][1].append(t)
        if fz is not None and len({id(b) for b, _ in groups
                                   if b is not None
                                   and b.tc is not None}) > 1:
            # the front as popped was not ONE wave of classes
            # (counted as certify()'s heterogeneous refusals are;
            # DTD bodies are no class's wave)
            fz._refuse("heterogeneous-front")
        for body, ts in groups:
            if body is None:
                self._mgr_to(_COMPLETE, -1, len(ts))
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
        the tag.

        Tasks of one signature (_dtd_signature) share one batchable body,
        so that a drain groups them into one vmapped launch (_launch).  A
        task with a read or write flow of no declared shape (the whole
        datum, whose size may differ from task to task) or with no read
        gets a body of its own and runs one task per launch.  Both maps
        are the pool's record's (_PoolRecord, made by its first device
        task here), which tp.destroy() drops."""
        sig = _dtd_signature(kernel, reads, writes, shapes, dtype, nb_flows)
        with self._lock:
            rec = self._pool(tp)
            body = rec.dtd_sigs.get(sig) if sig is not None else None
            if body is None:
                dtypes = {i: np.dtype(dtype) for i in range(nb_flows)}
                body = _DeviceBody(kernel, reads, writes, dict(shapes),
                                   dtypes, None, rec, nb_flows,
                                   batch=sig is not None)
                if sig is not None:
                    rec.dtd_sigs[sig] = body
            tag = _next_uid()
            N.lib.ptc_task_set_tag(task_ptr, tag)
            rec.dtd_tags[tag] = body
        return tag

    def drop_dtd_tasks(self, tp: Taskpool, tag: Optional[int] = None) -> None:
        """Forget DTD bodies of the pool `tp` that will never dispatch:
        the one of `tag` (an insertion the pool refused), or every one
        its record still holds (its wait() returned: they are tasks an
        abort dropped), and its bodies by signature.  The record itself
        stays until tp.destroy()."""
        with self._lock:
            rec = self._pools.get(tp._ptr)
            if rec is not None and tag is not None:
                rec.dtd_tags.pop(tag, None)
            elif rec is not None:
                rec.dtd_tags.clear()
                rec.dtd_sigs.clear()

    def drop_pool(self, tp: Taskpool) -> None:
        """Forget the pool `tp` (Taskpool.destroy, before the native pool
        is freed and its pointer may name a new pool): its record, its
        parked epilogue results and, through the wave compiler, its
        parked chain results (counted as drops) and their pins."""
        key = tp._ptr
        with self._lock:
            self._pools.pop(key, None)
            for k in [k for k in list(self._spec) if k[0][0] == key]:
                self._spec.pop(k, None)
        if self._fuser is not None:
            self._fuser.drop_pool(key)

    def _body_for(self, task) -> Optional[_DeviceBody]:
        """A task's body, from its pool's record: a DTD task's by its tag
        (popped: a tag dispatches once; a PTG task has none), else its
        class's."""
        rec = self._pools.get(N.lib.ptc_task_taskpool(task))
        if rec is None:
            return None
        tag = N.lib.ptc_task_get_tag(task)
        if tag:
            with self._lock:
                return rec.dtd_tags.pop(tag, None)
        return rec.bodies.get(N.lib.ptc_task_class(task))

    def _flow_uid_ver(self, view, body, flow):
        cptr = N.lib.ptc_task_copy(view._ptr, body.flow_index(flow))
        uid = self._copy_uid(cptr)
        _check_delivered(uid)
        return cptr, uid, N.lib.ptc_copy_version(cptr)

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
        pf = self._consume_pf(uid)
        if pf:
            self._stats_add("prefetch_hits")
            if pf == 2:
                self._stats_add("prefetch_hint_hits")

    def _stage_from_host(self, host: np.ndarray, scope: int):
        """Dispatch-time h2d of one host tile (a prefetch miss when the
        lane runs); `scope` is the dispatching task's request scope, the
        stall's owner (-1: none)."""
        if self._pf_lane is not None:
            self._stats_add("prefetch_misses")
            self._pf_rouse()
        return self._h2d(host, scope)

    def _stage_claim(self, uid: int) -> Optional[threading.Event]:
        """Claim the host stage of `uid` (the prefetch lane): the Event
        to hand to _stage_release once the stage is installed or given
        up, or None where another thread's stage of it is in flight."""
        with self._lock:
            if uid in self._staging:
                return None
            ev = self._staging[uid] = threading.Event()
        return ev

    def _stage_release(self, uid: int,
                       claim: Optional[threading.Event]) -> None:
        """End a claim of _stage_claim or _stage_or_wait (None: none)."""
        if claim is None:
            return
        with self._lock:
            if self._staging.get(uid) is claim:
                del self._staging[uid]
        claim.set()

    def _stage_or_wait(self, uid, ver, dt, shape):
        """Manager thread, at a stage-in of (uid, ver) with no current
        mirror: claim its host stage, or, where the prefetch lane's stage
        of it is in flight, wait for that (at most _STAGE_WAIT_S) and
        read its mirror as a hit.  Returns (the lane's mirror, None), or
        (None, the claim or None): stage the tile from the host, then
        _stage_release(uid, claim).  The wait is the manager's dispatch
        time (mgr_dispatch_ns), not an h2d stall: no bytes of its own
        cross."""
        for _ in range(2):
            with self._lock:
                ev = self._staging.get(uid)
                if ev is None:
                    ev = self._staging[uid] = threading.Event()
                    return None, ev
            ev.wait(_STAGE_WAIT_S)
            arr = self._cache_get_typed(uid, ver, dt, shape)
            if arr is not None:
                self._hit(uid)
                return arr, None
        return None, None

    def _view_host(self, view, body: _DeviceBody, flow):
        """A task's read flow as (its host tile, the task's scope)."""
        host = view.data(flow, dtype=body.dtypes[flow],
                         shape=body.shapes.get(flow), sync=False)
        return host, int(N.lib.ptc_task_scope(view._ptr)) or -1

    def _stage_in(self, uid, ver, dt, shape, host_of: Callable):
        """The current device tile of (uid, ver): a cache hit, a copy of a
        sibling device's mirror, or an h2d of host_of()'s (host tile,
        scope) (then cached)."""
        arr = self._cache_get_typed(uid, ver, dt, shape)
        if arr is not None:
            self._hit(uid)
            return arr
        sarr = self._sibling_mirror(uid, ver, dt, shape)
        if sarr is not None:
            arr = sarr.to(self.device, copy=True, non_blocking=True)
            self._cache_put(uid, ver, arr, arr.nbytes, event=self._record())
            return arr
        arr, claim = self._stage_or_wait(uid, ver, dt, shape)
        if arr is not None:
            return arr
        try:
            arr, ev = self._stage_from_host(*host_of())
            self._cache_put(uid, ver, arr, arr.nbytes, event=ev)
        finally:
            self._stage_release(uid, claim)
        return arr

    def _lanes_in(self, views, body: _DeviceBody, flow) -> torch.Tensor:
        """One read flow of a wave as a [lanes, *shape] tensor
        (_lanes_of over the lanes' copies)."""
        keys = [self._flow_uid_ver(v, body, flow)[1:] for v in views]
        return self._lanes_of(
            keys, self._flow_shape(views[0], body, flow), body.dtypes[flow],
            lambda i: self._view_host(views[i], body, flow))

    def _lanes_of(self, keys, shape, dt, host_of: Callable) -> torch.Tensor:
        """The tiles (uid, version) `keys` as a [lanes, *shape] tensor;
        host_of(i) gives lane i's (host tile, scope) for an h2d:
          - every lane reads the same tile: that tile, lane stride 0
          - every lane's tile is a row of ONE cached stack: a slice of it
            (or one index_select when the rows are not in lane order)
          - otherwise: a new stack, rows copied from the cache, a sibling
            or a fresh h2d (staged rows are then cached as rows of it); a
            tile several lanes read is staged once and its row copied
        A dispatch's read flow and a chained level's collection input
        (device/fuse.py) are stacked here alike."""
        n = len(keys)
        shape = tuple(shape)
        if all(k == keys[0] for k in keys):
            if n > 1:
                self._stats_add("fused_flows")
                self._stats_add("h2d_hits", n - 1)
            t = self._stage_in(*keys[0], dt, shape, lambda: host_of(0))
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
        out = torch.empty((n, *shape), dtype=_NP_TO_TORCH[np.dtype(dt)],
                          device=self.device)
        staged = []
        first: Dict[tuple, int] = {}  # (uid, ver) staged here -> its row
        claims = []  # host stages claimed here, released once cached
        try:
            for i, (uid, ver) in enumerate(keys):
                j = first.get((uid, ver))
                if j is not None:
                    # an earlier lane of this gather staged the same tile:
                    # copy its row rather than moving the bytes across
                    # again
                    self._stats_add("h2d_hits")
                    out[i].copy_(out[j], non_blocking=True)
                    continue
                arr = self._cache_get_typed(uid, ver, dt, shape)
                if arr is not None:
                    self._hit(uid)
                else:
                    arr = self._sibling_mirror(uid, ver, dt, shape)
                    if arr is None:
                        # the lane's stage in flight (a hit), or claimed
                        arr, claim = self._stage_or_wait(uid, ver, dt, shape)
                        if arr is None:
                            claims.append((uid, claim))
                            arr, _ = self._stage_from_host(*host_of(i))
                            staged.append((i, uid, ver))
                            first[(uid, ver)] = i
                    else:
                        staged.append((i, uid, ver))
                        first[(uid, ver)] = i
                out[i].copy_(arr.reshape(shape), non_blocking=True)
            ev = self._record() if staged else None
            for i, uid, ver in staged:
                self._cache_put(uid, ver, out[i], out[i].nbytes, stack=out,
                                idx=i, event=ev)
        finally:
            for uid, claim in claims:
                self._stage_release(uid, claim)
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
        # the oldest past 4, over a snapshot (drop_pool pops elsewhere)
        for k in list(self._spec)[:-4]:
            self._spec.pop(k, None)

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
        """One launch for a group of ready tasks of one body, split so
        that one launch's lane stacks stay under PTC_DEVICE_BATCH_BYTES;
        a DTD group is first split into runs of independent tasks
        (_dtd_runs)."""
        per_task = 0
        for f in list(body.reads) + list(body.writes):
            shp = body.shapes.get(f)
            if shp:
                per_task += int(np.prod(shp)) * np.dtype(
                    body.dtypes[f]).itemsize
        chunk = len(tasks)
        if per_task > 0 and chunk * per_task > self.batch_max_bytes:
            chunk = max(1, self.batch_max_bytes // per_task)
        runs = [tasks] if body.tc is not None else self._dtd_runs(body, tasks)
        for run in runs:
            for i in range(0, len(run), chunk):
                self._run_lanes(body, run[i:i + chunk])

    def _dtd_runs(self, body: _DeviceBody, tasks: List) -> List[List]:
        """A DTD group split, in pop order, into runs whose tasks may
        share a launch (_independent_runs over the flows' copies, told
        apart by address as the wave compiler's check does: every copy
        of a popped task is live, so an address names one copy); each
        cut counts in stats["dtd_splits"].  The engine's accessor chains
        order every writer of a tile after its readers and writers, so a
        front never needs a cut: this makes it sure."""
        copy = N.lib.ptc_task_copy
        lanes = [({copy(t, f) for f in body.reads},
                  {copy(t, f) for f in body.writes}) for t in tasks]
        runs, i = [], 0
        for n in _independent_runs(lanes):
            runs.append(tasks[i:i + n])
            i += n
        if len(runs) > 1:
            self._stats_add("dtd_splits", len(runs) - 1)
        return runs

    def _run_lanes(self, body: _DeviceBody, tasks: List):
        """Every launch, of one task or a group, comes here: tasks with a
        parked chain result (device/fuse.py) or an epilogue's parked
        result complete from it first (no launch, no DEVICE_DISPATCH
        span: a DEVICE_COMPLETE one with aux 1); a group of the rest goes
        to the wave compiler, which runs it, with its certified chain, or
        hands it back; what is left launches once inside a
        DEVICE_DISPATCH span.  A DTD body that vmap refused runs one task
        per launch."""
        if len(tasks) > 1 and not body.batch:
            for t in tasks:
                self._run_lanes(body, [t])
            return
        fz = self._fuser
        cid = body.tc.id if body.tc is not None else -1
        if fz is not None and fz.has_parked(body):
            self._mgr_to(_COMPLETE, cid, len(tasks), 1)
            tasks = fz.consume_group(body, tasks)
            if not tasks:
                return
        if body.spec_src is not None:
            if self._spec:
                # a lookup that may complete (none can while nothing is
                # parked: it is then part of the planning)
                self._mgr_to(_COMPLETE, cid, len(tasks), 1)
            tasks = [t for t in tasks if not self._try_spec(body, t)]
            if not tasks:
                return
        self._mgr_to(_PLAN)
        if fz is not None and len(tasks) > 1 \
                and fz.dispatch_group(body, tasks):
            return
        self._disp_open(body, len(tasks))
        wb_stacks = None
        try:
            wb_stacks = self._launch(body, tasks)
        finally:
            self._disp_close(body, len(tasks) if wb_stacks == [] else 0)
        if wb_stacks is None:
            return  # failed: _launch failed the tasks
        if wb_stacks is _UNBATCHED:
            self._run_lanes(body, tasks)  # now one launch a task
            return
        if wb_stacks:
            self._wb_q.put(("stack", list(tasks), wb_stacks))
            return
        for t in tasks:
            self.ctx.task_complete(t)

    def _outputs(self, body: _DeviceBody, out, lanes: int,
                 ins: Sequence[torch.Tensor] = (),
                 tiles: bool = False) -> tuple:
        """A kernel's return value as one [lanes, *tile] stack per write
        flow on this device (`tiles`: single tiles, a one-task DTD
        launch's, which get their lane axis); raises on a count, width
        or device that does not fit.

        An output that shares storage with one of the launch's input
        stacks `ins` (a chore passing a flow through, as ring
        attention's k_att does with Q and KV) is cloned: an input stack
        may be a lane-stride-0 view of one tile or a slice of another
        cached stack, and a mirror installed over it would alias the
        older version's storage and be charged a second time."""
        outs = out if isinstance(out, tuple) else (out,)
        if len(outs) != len(body.writes):
            raise ValueError(
                f"{body.name}: kernel returned {len(outs)} "
                f"output(s) for {len(body.writes)} write flow(s)")
        if tiles:
            outs = tuple(o.unsqueeze(0) for o in outs)
        for f, ostack in zip(body.writes, outs):
            if ostack.shape[0] != lanes or ostack.device != self.device:
                raise ValueError(
                    f"{body.name}.{f}: kernel output "
                    f"{tuple(ostack.shape)} on {ostack.device}, "
                    f"expected {lanes} lanes on {self.device}")
        held = {t.untyped_storage().data_ptr() for t in ins}
        return tuple(o.clone() if o.untyped_storage().data_ptr() in held
                     else o for o in outs)

    def _launch(self, body: _DeviceBody, tasks: List) -> Optional[list]:
        """Stage the lanes' inputs, launch the kernel once, install the
        outputs; returns the output stacks of the sync-mem-out flows
        (empty: none).  A task completes once its launch is enqueued (or,
        for sync-mem-out flows, from the writeback lane, after the
        launch's output stack has landed on the host); any failure fails
        every task of the launch and returns None — no fallback.  An
        epilogue's source lane runs the epilogue inside the launch.

        A DTD kernel takes one task's tiles: a group of its tasks calls
        it once under torch.func.vmap (_vmapped).  Where that raises,
        nothing is installed, the body is marked unbatchable and counted,
        and _UNBATCHED is returned: the caller launches the tasks one by
        one, where an error of the kernel's own fails its task."""
        views = [body.make_view(t) for t in tasks]
        try:
            ins = [self._lanes_in(views, body, f) for f in body.reads]
            dtd_tiles = body.tc is None and len(tasks) == 1
            if body.tc is not None:
                out = body.kernel(*ins)
            elif dtd_tiles:
                out = body.kernel(*(t[0] for t in ins))
            else:
                try:
                    out = _vmapped(body.kernel, ins)
                except Exception as e:
                    # vmap refused the kernel (.item(), a branch on a
                    # value, an op with no batching rule), or the kernel
                    # raised: it is tried once, and its lanes run alone
                    body.batch = False
                    self._stats_add("dtd_unbatchable")
                    self._dbg(f"{body.name}: vmap refused the kernel "
                              f"({type(e).__name__}: {e}); one launch a "
                              "task from now on")
                    return _UNBATCHED
            self._count_launch(body.kernel, len(tasks))
            # the outputs' clones (if any) are enqueued before the event
            # that their mirrors' readers on other streams wait on
            outs = self._outputs(body, out, len(tasks), ins, dtd_tiles)
            ev = self._record()
            epi, epi_lane, epi_key = body.epilogue, None, None
            if epi is not None:
                for i, view in enumerate(views):
                    epi_key = epi.pick(view)
                    if epi_key is not None:
                        epi_lane = i
                        break
            wb_stacks, epi_src = [], None
            for f, ostack in zip(body.writes, outs):
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
                if body.tc is None:
                    self._stats_add("dtd_batches")
                    self._stats_add("dtd_batched_tasks", len(tasks))
        except Exception:
            # a failed kernel must NOT complete its tasks: successors would
            # consume garbage and the pool would "succeed"
            traceback.print_exc()
            for t in tasks:
                self.ctx.task_fail(t)
            return None
        return wb_stacks
