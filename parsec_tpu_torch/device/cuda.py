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
    flows declared sync_mem_out, (b) at flush(), (c) on a host read
    (TaskView.data and the native copy-sync callback), or (d) never, if
    the copy dies first
  - one CUDA stream per device carries the h2d copies, the kernels and
    the d2h copies in order.  A task completes once its kernel is
    enqueued; every host read of a device result synchronises with that
    stream first.  Overlapping h2d/exec/d2h on separate streams is left
    to a later change
  - speculative epilogues (attach_epilogue): the lane of a wave whose
    output is the next input of a declared consumer class runs that
    class's kernel right after the wave's launch; the consumer task
    then completes from the parked result, version-checked

A failing kernel fails its tasks (ctx.task_fail) and so the pool: there
is no silent fallback to another path.

`CudaDevice(ctx)` runs on the card and raises where there is none;
`CudaDevice(ctx, device="cpu")` runs the same module with torch CPU
tensors, where each kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import contextlib
import os
import queue
import sys
import threading
import time
import traceback
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _native as N
from ..core.context import Context
from ..core.taskclass import Mem, TaskClass, TaskView
from ..core.taskpool import Taskpool

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
}


class _DeviceBody:
    def __init__(self, kernel: Callable, reads: Sequence,
                 writes: Sequence, shapes: Dict, dtypes: Dict,
                 tc: TaskClass, tp: Taskpool, batch: bool = True):
        self.kernel = kernel
        self.reads = list(reads)
        self.writes = list(writes)
        self.shapes = shapes
        self.dtypes = dtypes
        self.tc = tc
        self.tp = tp
        self.batch = batch  # kernel is elementwise over lanes
        # speculative epilogue: this class is its source (epilogue) or
        # its destination (spec_src); see CudaDevice.attach_epilogue
        self.epilogue: Optional["_Epilogue"] = None
        self.spec_src: Optional["_Epilogue"] = None
        # flows whose output deps include a memory writeback: their host
        # copy must be coherent at completion (release_deps may memcpy it)
        self.mem_out_flows = set()
        for fl in tc.flows:
            if fl.name in self.writes:
                for d in fl.deps:
                    if d.direction == 1 and isinstance(d.target, Mem):
                        self.mem_out_flows.add(fl.name)

    def make_view(self, task_ptr):
        return TaskView(task_ptr, self.tc, self.tp)


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
    __slots__ = ("version", "arr", "nbytes", "dirty", "host", "persistent",
                 "stack", "idx")

    def __init__(self, version, arr, nbytes, dirty=False, host=None,
                 persistent=True, stack=None, idx=0):
        self.version = version
        self.arr = arr  # device tensor of the tile's shape
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


class CudaDevice:
    """One CUDA card (or, with device="cpu", the plain versions on the
    host) with a manager thread and a writeback lane."""

    def __init__(self, ctx: Context, device="cuda",
                 cache_bytes: Optional[int] = None):
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CudaDevice: no CUDA device is available; pass "
                    "device='cpu' to run the plain versions on the host")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(device=dev)
        elif dev.type == "cpu":
            self._stream = None
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
        self._tp_by_ptr: Dict[int, Taskpool] = {}
        # device-copy LRU keyed by uid (stamped into the native copy handle,
        # so freed/reused ptc_copy addresses can't alias — ABA guard)
        self._cache: "OrderedDict[int, _CacheEnt]" = OrderedDict()
        if cache_bytes is None:
            from ..utils import params as _knobs
            cache_bytes = int(_knobs.get("device.cache_bytes")) or 4 << 30
        self._cache_bytes = cache_bytes
        self._cache_used = 0
        # id(stack) -> [refcount, stack]; the strong ref keeps id() stable
        self._stacks: Dict[int, list] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
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
                      "spec_store": 0, "spec_hits": 0, "spec_misses": 0}
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
        # runs here, not in the dispatch loop; the tasks complete from
        # this lane once their host bytes are coherent
        self._wb_q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._manager, daemon=True,
                                        name="ptc-cuda-manager")
        self._wb_thread = threading.Thread(target=self._wb_loop,
                                           daemon=True,
                                           name="ptc-cuda-writeback")
        self._thread.start()
        self._wb_thread.start()

    # ------------------------------------------------------------ streams
    def _on_stream(self):
        """Context that makes this device's stream current (no-op on the
        CPU): kernels launch on the current stream, and host copies taken
        inside it are ordered after every launch before them."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _h2d(self, host: np.ndarray, out: Optional[torch.Tensor] = None):
        """Copy one host tile (a view over native memory) to the device.
        The bytes go through an OWNED buffer first (pinned on the card):
        an asynchronous copy from the native view could read it after
        the copy died at its last consumer's completion."""
        t0 = time.perf_counter_ns()
        if self._stream is not None:
            src = torch.empty(host.shape, dtype=_NP_TO_TORCH[host.dtype],
                              pin_memory=True)
            src.numpy()[...] = host
            with self._on_stream():
                if out is None:
                    out = src.to(self.device, non_blocking=True)
                else:
                    out.copy_(src.view(out.shape), non_blocking=True)
        elif out is None:
            out = torch.from_numpy(np.array(host, copy=True))
        else:
            out.copy_(torch.from_numpy(host).view(out.shape))
        stall = time.perf_counter_ns() - t0
        self.stats["h2d_stall_ns"] += stall
        self._stats_add("h2d_bytes", host.nbytes)
        return out

    def _host_write(self, ent: _CacheEnt) -> int:
        """Write a device mirror into its bound host buffer; blocks until
        the bytes have landed.  Returns the bytes written."""
        dst = torch.from_numpy(ent.host).view(-1)
        with self._on_stream():
            dst.copy_(ent.arr.reshape(-1))
        return int(ent.host.nbytes)

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

    def _cache_put(self, uid, version, arr, nbytes, dirty=False, host=None,
                   persistent=True, stack=None, idx=0):
        with self._lock:
            old = self._cache.pop(uid, None)
            if old is not None:
                self._uncharge(old)
            ent = _CacheEnt(version, arr, nbytes, dirty, host, persistent,
                            stack, idx)
            self._cache[uid] = ent
            self._charge(ent)
            # affinity stamp: consumers of this copy at this version route
            # here (reference: parsec_get_best_device, device.c:100-117)
            N.lib.ptc_device_set_data_owner(self.ctx._ptr, uid,
                                            self.qid, version)
            # evict clean entries under pressure, oldest first; dirty
            # entries never evict (their device bytes are the only truth)
            if self._cache_used > self._cache_bytes:
                evict = []
                for k, e in self._cache.items():
                    if self._cache_used <= self._cache_bytes:
                        break
                    if e.dirty or k == uid:
                        continue
                    evict.append(k)
                    self._uncharge(e)
                for k in evict:
                    del self._cache[k]
                    self.stats["evictions"] += 1
                    N.lib.ptc_device_clear_data_owner(self.ctx._ptr, k,
                                                      self.qid)

    def _cache_ent(self, uid, version) -> Optional[_CacheEnt]:
        with self._lock:
            ent = self._cache.get(uid)
            if ent is not None and ent.version == version:
                self._cache.move_to_end(uid)
                return ent
        return None

    def _cache_get_typed(self, uid, version, dtype, shape):
        """The current mirror of (uid, version) as a tensor of the
        consumer's shape, or None."""
        ent = self._cache_ent(uid, version)
        if ent is None:
            return None
        if ent.arr.dtype != _NP_TO_TORCH[np.dtype(dtype)]:
            raise TypeError(
                f"device mirror {uid} holds {ent.arr.dtype}, consumer "
                f"reads {np.dtype(dtype)}")
        return ent.arr if shape is None else ent.arr.reshape(shape)

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
        """Retarget the device byte budget; the LRU reacts at the next
        insert."""
        with self._lock:
            self._cache_bytes = int(nbytes)

    def sync_handle(self, uid: int) -> None:
        """Coherence pull for ONE copy: if its device mirror is dirty,
        write it back to the host buffer and clear the dirty bit."""
        with self._lock:
            ent = self._cache.get(uid)
            if ent is None or not ent.dirty:
                return
        nbytes = self._host_write(ent)
        with self._lock:
            self.stats["d2h_bytes"] += nbytes
            ent.dirty = False

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
        """Write every dirty device mirror back to its host copy.  Call
        before bulk host reads (to_dense etc.); per-copy coherence for
        CPU chores is automatic via sync_handle()."""
        self._wb_barrier()
        with self._lock:
            # only persistent (user-Data-backed) hosts are written: arena
            # buffers can be freed concurrently by the last consumer
            dirty = [e for e in self._cache.values()
                     if e.dirty and e.persistent]
        for ent in dirty:
            nbytes = self._host_write(ent)
            with self._lock:
                self.stats["d2h_bytes"] += nbytes
                ent.dirty = False

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
            self.stats["f64_refused"] += 1
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
        stack = self._h2d(np.stack(tiles))
        for i, (uid, ver) in enumerate(keys):
            self._cache_put(uid, ver, stack[i], tiles[i].nbytes,
                            stack=stack, idx=i)

    # ------------------------------------------------------------ manager
    def _wb_loop(self):
        """Writeback lane: make the queued mirrors host-coherent, then
        complete their tasks (coherence before release_deps)."""
        while True:
            item = self._wb_q.get()
            if item is None:
                return
            if item[0] == "barrier":
                item[1].set()
                continue
            _, tasks, uids = item
            try:
                for uid in uids:
                    self.sync_handle(uid)
            except Exception:
                traceback.print_exc()
                for t in tasks:
                    self.ctx.task_fail(t)
                continue
            self._stats_add("wb_tasks", len(tasks))
            for t in tasks:
                self.ctx.task_complete(t)

    def _wb_barrier(self, timeout: float = 300.0):
        """Block until every queued writeback retired.  A timeout is a
        hard error: proceeding would report mirrors coherent that the
        lane may still be writing."""
        if not self._wb_thread.is_alive():
            return
        ev = threading.Event()
        self._wb_q.put(("barrier", ev))
        if not ev.wait(timeout=timeout):
            raise RuntimeError(
                f"ptc [device]: writeback barrier timed out after "
                f"{timeout:.0f}s; dirty mirrors are NOT coherent")

    def stop(self):
        """Flush dirty mirrors and stop the manager (idempotent)."""
        if self._stop.is_set():
            return
        self.flush()
        self._stop.set()
        self._thread.join(timeout=30)
        # second flush AFTER the join: a task completing between the first
        # flush's dirty snapshot and manager exit is not lost
        self.flush()
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
            self._cache_used = 0

    def _manager(self):
        """Dispatch loop: drain every ready task, group by class (pop
        order kept), and run each group as one launch."""
        with self._on_stream(), torch.no_grad():
            while not self._stop.is_set():
                task = self.ctx.device_pop(self.qid, timeout_ms=50)
                if not task:
                    continue
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

    def _body_for(self, task) -> Optional[_DeviceBody]:
        tp = self._tp_by_ptr.get(N.lib.ptc_task_taskpool(task))
        if tp is None:
            return None
        return self.bodies.get((id(tp), N.lib.ptc_task_class(task)))

    def _flow_uid_ver(self, view, body, flow):
        cptr = N.lib.ptc_task_copy(view._ptr, body.tc.flow_index(flow))
        return cptr, self._copy_uid(cptr), N.lib.ptc_copy_version(cptr)

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

    def _stage_in(self, view, body: _DeviceBody, flow):
        """The current device tile of one task's read flow: a cache hit,
        a copy of a sibling device's mirror, or an h2d of its host copy
        (then cached)."""
        _, uid, ver = self._flow_uid_ver(view, body, flow)
        shape = body.shapes.get(flow)
        dt = body.dtypes[flow]
        arr = self._cache_get_typed(uid, ver, dt, shape)
        if arr is not None:
            self.stats["h2d_hits"] += 1
            return arr
        sarr = self._sibling_mirror(uid, ver, dt, shape)
        if sarr is not None:
            arr = sarr.to(self.device, copy=True, non_blocking=True)
            self._cache_put(uid, ver, arr, arr.nbytes)
            return arr
        host = view.data(flow, dtype=dt, shape=shape, sync=False)
        arr = self._h2d(host)
        self._cache_put(uid, ver, arr, host.nbytes)
        return arr

    def _lanes_in(self, views, body: _DeviceBody, flow) -> torch.Tensor:
        """One read flow of a wave as a [lanes, *shape] tensor:
          - every lane reads the same tile: that tile, lane stride 0
          - every lane's tile is a row of ONE cached stack: a slice of it
            (or one index_select when the rows are not in lane order)
          - otherwise: a new stack, rows copied from the cache or staged
            h2d straight into place (staged rows are then cached)"""
        n = len(views)
        shape = tuple(body.shapes[flow])
        keys = [self._flow_uid_ver(v, body, flow)[1:] for v in views]
        if all(k == keys[0] for k in keys):
            if n > 1:
                self.stats["fused_flows"] += 1
                self.stats["h2d_hits"] += n - 1
            t = self._stage_in(views[0], body, flow)
            return t.unsqueeze(0).expand(n, *shape)
        ents = [self._cache_ent(uid, ver) for uid, ver in keys]
        stack = ents[0].stack if ents[0] is not None else None
        if stack is not None and all(
                e is not None and e.stack is stack for e in ents):
            self.stats["fused_flows"] += 1
            self.stats["h2d_hits"] += n
            idxs = [e.idx for e in ents]
            if idxs == list(range(idxs[0], idxs[0] + n)):
                rows = stack[idxs[0]:idxs[0] + n]
            else:
                rows = stack.index_select(
                    0, torch.tensor(idxs, device=stack.device))
            return rows.reshape(n, *shape)
        self.stats["eager_gathers"] += 1
        dt = body.dtypes[flow]
        out = torch.empty((n, *shape), dtype=_NP_TO_TORCH[np.dtype(dt)],
                          device=self.device)
        for i, (view, (uid, ver)) in enumerate(zip(views, keys)):
            arr = self._cache_get_typed(uid, ver, dt, shape)
            if arr is not None:
                self.stats["h2d_hits"] += 1
                out[i].copy_(arr)
                continue
            arr = self._sibling_mirror(uid, ver, dt, shape)
            if arr is not None:
                out[i].copy_(arr, non_blocking=True)
            else:
                host = view.data(flow, dtype=dt, shape=shape, sync=False)
                self._h2d(host, out[i])
            self._cache_put(uid, ver, out[i], out[i].nbytes, stack=out,
                            idx=i)
        return out

    def _write_out(self, view, body: _DeviceBody, flow, ostack, i):
        """Install lane i of an output stack as the task's dirty mirror and
        return (uid, its new version).  Host coherence is lazy (flush /
        sync_handle); sync-mem-out flows ride the writeback lane."""
        cptr, uid, ver = self._flow_uid_ver(view, body, flow)
        host = view.data(flow, dtype=body.dtypes[flow],
                         shape=body.shapes.get(flow), sync=False)
        persistent = bool(N.lib.ptc_copy_is_persistent(cptr))
        self._cache_put(uid, ver + 1, ostack[i], host.nbytes, dirty=True,
                        host=host, persistent=persistent, stack=ostack,
                        idx=i)
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
        self.stats["spec_store"] += 1
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
                self.stats["spec_misses"] += 1
                sys.stderr.write(
                    f"ptc [device]: epilogue kernel returned {len(arrs)} "
                    f"output(s), {body.tc.name} writes {len(body.writes)}; "
                    "ignoring the parked result\n")
                return False
            cptr = N.lib.ptc_task_copy(view._ptr,
                                       body.tc.flow_index(spec.dst_in_flow))
            if N.lib.ptc_copy_handle(cptr) != suid \
                    or N.lib.ptc_copy_version(cptr) != sver:
                self.stats["spec_misses"] += 1
                return False
            wb_uids = []
            for f, arr in zip(body.writes, arrs):
                uid, _ = self._write_out(view, body, f, arr, 0)
                if f in body.mem_out_flows:
                    wb_uids.append(uid)
        except Exception:
            traceback.print_exc()
            self.ctx.task_fail(task)
            return True
        self.stats["spec_hits"] += 1
        self.stats["tasks"] += 1
        if wb_uids:
            self._wb_q.put(("sync", [task], wb_uids))
        else:
            self.ctx.task_complete(task)
        return True

    def _run_epilogue(self, epi: _Epilogue, key, row: torch.Tensor,
                      src) -> None:
        """Run the dst chore on one output row (as a 1-lane stack) on this
        device's stream and park its outputs for the dst task `key`."""
        ops = [self._h2d(np.ascontiguousarray(o)).unsqueeze(0)
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

    def _run_lanes(self, body: _DeviceBody, tasks: List):
        """Stage the lanes' inputs, launch the kernel once, install the
        outputs.  A task completes once its launch is enqueued (or, for
        sync-mem-out flows, from the writeback lane); any failure fails
        every task of the launch — no fallback.  Every launch, of one task
        or a group, comes here: an epilogue's destination tasks first try
        their parked result, and its source lane runs the epilogue."""
        if body.spec_src is not None:
            tasks = [t for t in tasks if not self._try_spec(body, t)]
            if not tasks:
                return
        views = [body.make_view(t) for t in tasks]
        try:
            ins = [self._lanes_in(views, body, f) for f in body.reads]
            out = body.kernel(*ins)
            self._count_launch(body.kernel, len(tasks))
            outs = out if isinstance(out, tuple) else (out,)
            if len(outs) != len(body.writes):
                raise ValueError(
                    f"{body.tc.name}: kernel returned {len(outs)} "
                    f"output(s) for {len(body.writes)} write flow(s)")
            epi, epi_lane, epi_key = body.epilogue, None, None
            if epi is not None:
                for i, view in enumerate(views):
                    epi_key = epi.pick(view)
                    if epi_key is not None:
                        epi_lane = i
                        break
            wb_uids, epi_src = [], None
            for f, ostack in zip(body.writes, outs):
                if ostack.shape[0] != len(tasks) \
                        or ostack.device != self.device:
                    raise ValueError(
                        f"{body.tc.name}.{f}: kernel output "
                        f"{tuple(ostack.shape)} on {ostack.device}, "
                        f"expected {len(tasks)} lanes on {self.device}")
                for i, view in enumerate(views):
                    uid, ver = self._write_out(view, body, f, ostack, i)
                    if f in body.mem_out_flows:
                        wb_uids.append(uid)
                    if i == epi_lane and f == epi.src_flow:
                        epi_src = (uid, ver, ostack[i])
            if epi_src is not None:
                self._run_epilogue(epi, epi_key, epi_src[2], epi_src[:2])
            self.stats["tasks"] += len(tasks)
            if len(tasks) > 1:
                self.stats["batches"] += 1
                self.stats["batched_tasks"] += len(tasks)
        except Exception:
            # a failed kernel must NOT complete its tasks: successors would
            # consume garbage and the pool would "succeed"
            traceback.print_exc()
            for t in tasks:
                self.ctx.task_fail(t)
            return
        if wb_uids:
            self._wb_q.put(("sync", list(tasks), wb_uids))
            return
        for t in tasks:
            self.ctx.task_complete(t)
