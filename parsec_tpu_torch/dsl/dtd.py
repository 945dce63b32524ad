"""DTD — Dynamic Task Discovery interface.

Build the DAG as you go: every inserted task names its data arguments with
access modes (INPUT/OUTPUT/INOUT); dependencies derive from per-tile
last-writer/readers accessor chains maintained natively.  A sliding window
throttles discovery so the DAG never outruns execution.

Reference: parsec/interfaces/dtd/insert_function.{c,h} (SURVEY.md §2.7,
call stack §3.5): parsec_dtd_taskpool_new / parsec_dtd_tile_of /
parsec_dtd_insert_task / parsec_dtd_taskpool_wait, window throttling at
insert_function.c:69,472-509.

Port of parsec_tpu/dsl/dtd.py.  A device task is inserted with
insert_cuda_task and runs its kernel on a CudaDevice (device/cuda.py).
The kernel takes one task's tiles; ready tasks of one kernel, access
modes, tile shapes and dtype that the device finds together run as one
launch of torch.func.vmap(kernel), one lane a task (a kernel vmap
refuses, or a task with an argument of no declared shape, runs one task
per launch).
"""
from __future__ import annotations

import ctypes as C
import traceback
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np

from .. import _native as N
from ..analysis.dtdlint import DtdLinter
from ..analysis.flowgraph import collection_tile_bytes
from ..core.context import Context, Data
from ..core.taskclass import _sync_copy
from ..core.taskpool import Taskpool
from ..utils import params as _mca

INPUT = N_INPUT = 1
OUTPUT = N_OUTPUT = 2
INOUT = N_INOUT = 3

_MODES = {"INPUT": 1, "OUTPUT": 2, "INOUT": 3, "R": 1, "W": 2, "RW": 3}


class DtdView:
    """Body-side view of a DTD task: flows addressed by argument index."""

    __slots__ = ("_ptr", "nb_flows")

    def __init__(self, ptr, nb_flows: int = -1):
        self._ptr = ptr
        # per-task arity from the native side (a cached body callback is
        # shared between insertions of the same fn with different arities)
        self.nb_flows = (nb_flows if nb_flows >= 0
                         else N.lib.ptc_dtask_nb_flows(ptr))

    def data_ptr(self, i: int) -> int:
        return N.lib.ptc_task_data_ptr(self._ptr, i)

    def data(self, i: int, dtype=np.uint8, shape=None,
             sync: bool = True) -> np.ndarray:
        ptr = N.lib.ptc_task_data_ptr(self._ptr, i)
        if not ptr:
            raise RuntimeError(f"dtd task: argument {i} has no data")
        cptr = N.lib.ptc_task_copy(self._ptr, i)
        if sync:
            # a device task may hold this tile's current bytes as a dirty
            # mirror: write it back before the host reads
            _sync_copy(cptr)
        size = N.lib.ptc_copy_size(cptr)
        dt = np.dtype(dtype)
        buf = (C.c_char * size).from_address(ptr)
        arr = np.frombuffer(buf, dtype=dt, count=size // dt.itemsize)
        return arr.reshape(shape) if shape is not None else arr


class DtdTile:
    """Handle to a tracked datum (reference: parsec_dtd_tile_of).  `owner`
    is the rank that executes tasks writing this tile (distributed DTD
    placement; other ranks keep shadow tasks + mirror copies).

    `nbytes`/`coll_stride` carry the tile's actual payload size vs its
    collection's declared stride for the insertion linter's D104
    size-mismatch rule (None when the source declares no geometry)."""

    __slots__ = ("_ptr", "data", "owner", "_lint_finalized", "nbytes",
                 "coll_stride")

    def __init__(self, ctx: Context, data: Data, owner: int = 0,
                 coll_stride: Optional[int] = None):
        self.data = data
        self.owner = owner
        self._lint_finalized = False  # set by the DTD linter on destroy
        self.nbytes = int(data.array.nbytes) \
            if getattr(data, "array", None) is not None else None
        self.coll_stride = coll_stride
        self._ptr = N.lib.ptc_dtile_new(ctx._ptr, data._ptr)
        if owner:
            N.lib.ptc_dtile_set_owner(self._ptr, owner)


class DtdTaskpool:
    def __init__(self, ctx: Context, window: Optional[int] = None,
                 lint=False):
        """`lint=True` (or "error") turns on the insertion linter
        (analysis.dtdlint): undeclared access-mode conflicts and
        use-after-finalize raise DtdLintError at insert time;
        lint="warn" records findings in `self.linter.findings`
        without raising."""
        if window is None:
            window = _mca.get("dtd.window_size")
        self.ctx = ctx
        self.window = window
        self.linter = None
        if lint:
            self.linter = DtdLinter(
                mode="warn" if lint == "warn" else "error")
        self.tp = Taskpool(ctx)
        self.tp.set_open(True)
        self.tp.run()  # zero classes; registers with the context
        self._tiles: Dict[Tuple[int, object], DtdTile] = {}
        # one native body callback per distinct host fn (the context keeps
        # every callback alive, so one per insert would grow without bound)
        self._body_ids: Dict[Callable, int] = {}
        self._closed = False

    # ------------------------------------------------------------- tiles
    def tile_of(self, source, *key, owner: Optional[int] = None) -> DtdTile:
        """Tile for a Data object or a (collection, key...) pair.  The
        owning rank defaults to the collection's rank_of (Data objects
        default to rank 0 unless `owner=` is given)."""
        if isinstance(source, Data):
            k = (id(source), None)
            if k not in self._tiles:
                self._tiles[k] = DtdTile(self.ctx, source, owner or 0)
            return self._tiles[k]
        k = (id(source), key)
        if k not in self._tiles:
            d = source.data_of(*key)
            own = owner if owner is not None else source.rank_of(*key)
            self._tiles[k] = DtdTile(self.ctx, d, own,
                                     coll_stride=collection_tile_bytes(
                                         source))
        return self._tiles[k]

    # ------------------------------------------------------------- insert
    def _body_id(self, fn: Callable) -> int:
        bid = self._body_ids.get(fn)
        if bid is None:
            def _cb(user, task_ptr):
                try:
                    r = fn(DtdView(task_ptr))
                    if isinstance(r, int) and not isinstance(r, bool):
                        return r
                    return N.HOOK_DONE
                except Exception:
                    traceback.print_exc()
                    return N.HOOK_ERROR

            bid = self.ctx.register_body_cb(_cb)
            self._body_ids[fn] = bid
        return bid

    def insert_task(self, fn: Callable, *args, priority: int = 0,
                    rank: Optional[int] = None):
        """insert_task(body, (tile, "INPUT"), (tile2, "INOUT"), ...).

        body(view) runs on a worker; view.data(i) is the i-th argument.
        In distributed mode every rank inserts the same stream; the task
        executes on `rank` (default: first OUTPUT tile's owner) and other
        ranks keep a shadow released by the owner's completion broadcast."""
        if self._closed:
            raise RuntimeError("taskpool already closed")
        if self.linter is not None:
            self.linter.on_insert(
                [(tile, _MODES[mode.upper()] if isinstance(mode, str)
                  else int(mode)) for tile, mode in args])
        bid = self._body_id(fn)
        t = N.lib.ptc_dtask_begin(self.tp._ptr, N.BODY_CB, bid, priority)
        for tile, mode in args:
            m = _MODES[mode.upper()] if isinstance(mode, str) else int(mode)
            if N.lib.ptc_dtask_arg(t, tile._ptr, m) < 0:
                raise ValueError(
                    "insert_task: too many arguments (max 20)")
        if rank is not None:
            N.lib.ptc_dtask_set_rank(t, rank)
        if N.lib.ptc_dtask_submit(self.ctx._ptr, t, self.window) != 0:
            raise RuntimeError("taskpool aborted: insertion refused")
        return t

    def insert_tasks(self, tasks: Iterable, batch: Optional[int] = None
                     ) -> int:
        """Batched insert_task: ONE native crossing (and one GIL bounce)
        per `batch` tasks instead of 2+nargs crossings per task — the
        amortized path for DAG builders that insert thousands of tasks
        in a loop (ptg_to_dtd, redistribute).

        `tasks` yields (fn, args) or (fn, args, priority) or
        (fn, args, priority, rank) tuples, where args is the usual
        ((tile, mode), ...) sequence.  `batch` defaults to the
        dtd.insert_batch MCA param; the window throttle still applies
        per task inside the native batch.  Returns tasks inserted."""
        if self._closed:
            raise RuntimeError("taskpool already closed")
        if batch is None:
            batch = _mca.get("dtd.insert_batch")
        batch = max(1, int(batch))
        spec: list = []
        pending = 0
        inserted = 0

        def flush():
            nonlocal spec, pending, inserted
            if not pending:
                return
            arr = (C.c_int64 * len(spec))(*spec)
            rc = N.lib.ptc_dtask_insert_batch(
                self.ctx._ptr, self.tp._ptr, arr, len(spec), self.window)
            if rc < 0:
                inserted += ~rc
                raise RuntimeError(
                    f"taskpool aborted: insertion refused after "
                    f"{inserted} tasks")
            inserted += rc
            spec = []
            pending = 0

        for item in tasks:
            fn, args = item[0], item[1]
            prio = int(item[2]) if len(item) > 2 else 0
            rank = int(item[3]) if len(item) > 3 and item[3] is not None \
                else -1
            if len(args) > N.MAX_FLOWS:
                raise ValueError(
                    f"insert_tasks: too many arguments (max {N.MAX_FLOWS})")
            spec += [N.BODY_CB, self._body_id(fn), prio, rank, len(args)]
            normed = []
            for tile, mode in args:
                m = _MODES[mode.upper()] if isinstance(mode, str) \
                    else int(mode)
                normed.append((tile, m))
                spec += [tile._ptr, m]
            if self.linter is not None:
                self.linter.on_insert(normed)
            pending += 1
            if pending >= batch:
                flush()
        flush()
        return inserted

    def insert_cuda_task(self, dev, kernel: Callable, *args,
                         shapes=None, dtype=np.float32, priority: int = 0):
        """Insert a device task, run by `dev` (a CudaDevice):
        kernel(*reads) -> writes, where the reads are the arguments whose
        mode reads (INPUT, INOUT) as tensors on the device, in argument
        order, and the kernel returns one tensor per argument whose mode
        writes (OUTPUT, INOUT), in argument order.  `shapes` maps an
        argument index to its tile shape (default: the whole datum as a
        vector); every argument has type `dtype`.

        The kernel sees one task's tiles.  Ready tasks of this pool with
        the same kernel object, modes, `shapes` and `dtype` that the
        device pops together, and that touch no copy another of them
        writes, run as ONE launch of torch.func.vmap(kernel) over their
        stacked tiles, so the kernel must be a function of its tiles
        alone.  A kernel vmap cannot take (.item(), a branch on a
        value) runs one task per launch after its first refusal, as does
        every task whose read or written argument has no entry in
        `shapes`, or that reads nothing.  A failing kernel fails the
        pool; there is no host fallback."""
        if self._closed:
            raise RuntimeError("taskpool already closed")
        modes = [_MODES[mode.upper()] if isinstance(mode, str)
                 else int(mode) for _, mode in args]
        if self.linter is not None:
            self.linter.on_insert([(tile, m) for (tile, _), m
                                   in zip(args, modes)])
        # the device module refuses float64 (CudaDevice.attach), and a
        # DTD device task has no host chore to fall back to: fail loudly
        # at insert
        if np.dtype(dtype) == np.float64:
            raise ValueError(
                "insert_cuda_task: float64 is not run on the device (the "
                "device module refuses float64 flows); use insert_task "
                "with a host body instead")
        t = N.lib.ptc_dtask_begin(self.tp._ptr, N.BODY_DEVICE, dev.qid,
                                  priority)
        reads, writes = [], []
        for i, ((tile, _), m) in enumerate(zip(args, modes)):
            if N.lib.ptc_dtask_arg(t, tile._ptr, m) < 0:
                raise ValueError("insert_cuda_task: too many arguments")
            if m & 1:
                reads.append(i)
            if m & 2:
                writes.append(i)
        tag = dev.register_dtd_task(t, kernel, reads, writes, shapes or {},
                                    dtype, len(args), self.tp)
        if N.lib.ptc_dtask_submit(self.ctx._ptr, t, self.window) != 0:
            dev.drop_dtd_tasks(self.tp, tag)
            raise RuntimeError("taskpool aborted: insertion refused")
        return t

    # ------------------------------------------------------------- finish
    def wait(self):
        """Close the window and wait for every discovered task."""
        self._closed = True
        if self.linter is not None:
            self.linter.on_wait()
        self.tp.set_open(False)
        try:
            self.tp.wait()
        finally:
            # bodies of device tasks an abort dropped never dispatch
            for dev in list(self.ctx._devices):
                dev.drop_dtd_tasks(self.tp)

    def destroy(self):
        if self.linter is not None:
            self.linter.on_destroy()
        for tile in self._tiles.values():
            N.lib.ptc_dtile_destroy(self.ctx._ptr, tile._ptr)
        self._tiles.clear()
        self.tp.destroy()
