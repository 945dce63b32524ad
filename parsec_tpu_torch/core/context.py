"""Context: process-wide runtime handle (reference: parsec_context_t,
parsec/runtime.h parsec_init/parsec_context_*).

Owns the native context (worker threads, scheduler, registries), Python-side
keep-alives for ctypes callbacks and pinned buffers, and the name->id maps
for data collections, arenas and datatypes.

Port of parsec_tpu/core/context.py, with its observability hooks (PINS,
the live sampler, the metrics exporter, the watchdog, the journal), the
metrics accessors, the controller and the comm engine's surface
(comm_init and the rest of the comm_* methods, coll_stats, the clock-
sync estimate, and the comm/coll/clock namespaces of stats(), whose
schema is the same when comm is off).
"""
from __future__ import annotations

import ctypes as C
import os
import re
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from .. import _native as N
from ..utils import params as _mca


def _numa_vpmap(n: int) -> "List[int]":
    """vp per worker from the NUMA topology: worker w round-robin-binds
    to allowed cpu w % ncpu (bind_worker_thread's order), and its vp is
    that cpu's NUMA node, dense-renumbered.  Flat on hosts without
    sysfs NUMA info (reference: the hwloc-fed vpmap init)."""
    import glob as _glob
    import os as _os
    try:
        cpus = sorted(_os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        return [0] * n
    node_of = {}
    for path in _glob.glob("/sys/devices/system/node/node[0-9]*"):
        try:
            node = int(_os.path.basename(path)[4:])
            with open(_os.path.join(path, "cpulist")) as f:
                txt = f.read().strip()
        except (OSError, ValueError):
            continue
        for part in txt.split(","):
            part = part.strip()
            if not part:
                continue
            if "-" in part:
                a, b = part.split("-")
                rng = range(int(a), int(b) + 1)
            else:
                rng = [int(part)]
            for c in rng:
                node_of[c] = node
    if not node_of or not cpus:
        return [0] * n
    nodes_sorted = sorted({node_of.get(c, 0) for c in cpus})
    dense = {nd: i for i, nd in enumerate(nodes_sorted)}
    return [dense[node_of.get(cpus[w % len(cpus)], nodes_sorted[0])]
            for w in range(n)]


class Data:
    """A named datum with a host copy (reference: parsec_data_t +
    parsec_data_copy_t, parsec/data_internal.h:35-83)."""

    def __init__(self, key: int, array: np.ndarray):
        if not array.flags["C_CONTIGUOUS"]:
            array = np.ascontiguousarray(array)
        self.array = array  # keep-alive
        self.key = key
        self._ptr = N.lib.ptc_data_new(
            key, array.ctypes.data_as(C.c_void_p), array.nbytes)

    @property
    def version(self) -> int:
        if self._ptr is None:
            raise RuntimeError("Data already destroyed")
        return N.lib.ptc_copy_version(N.lib.ptc_data_host_copy(self._ptr))

    def destroy(self):
        if self._ptr:
            N.lib.ptc_data_destroy(self._ptr)
            self._ptr = None


class Context:
    def __init__(self, nb_workers: Optional[int] = None,
                 scheduler: Optional[str] = None):
        """Explicit arguments win over the MCA param registry
        (runtime.nb_workers / runtime.sched / runtime.profile), which
        itself resolves file < env < set()."""
        if nb_workers is None:
            nb_workers = _mca.get("runtime.nb_workers")
        if scheduler is None:
            scheduler = _mca.get("runtime.sched")
        self._ptr = N.lib.ptc_context_new(nb_workers)
        # the magazine batch the native core read at creation (it keeps
        # no getter): atoi of the env, kept when in [1, 8192], else 64
        m = re.match(r"\s*[+-]?\d+",
                     os.environ.get("PTC_MCA_runtime_mag_batch", ""))
        mag = int(m.group()) if m else 0
        self.mag_batch = mag if 1 <= mag <= 8192 else 64
        # one rank until set_rank (which mirrors a change into the native
        # core, which keeps no getter)
        self.myrank, self.nodes = 0, 1
        # the rank remap set_rank_map last installed (None: identity)
        self.rank_map: Optional[tuple] = None
        # peer ranks whose devices share this process (comm_set_colocated)
        self._colocated: set = set()
        # the collective builder's op-level records and its name counter
        # (comm/coll.py)
        self._coll_py_stats = None
        self._coll_uid = 0
        # fence epochs completed (the journal's time ruler)
        self._fence_epoch = 0
        if scheduler != "lfq":
            N.lib.ptc_context_set_scheduler(self._ptr, scheduler.encode())
        # whether the device layer's spans have a reader (the trace or a
        # PINS chain; see _refresh_listening), and the wall clock's anchor
        # of the trace to come (profiling/trace.py take_trace)
        self._pins_on = False
        self._listening = False
        self._wall_anchor = None
        if _mca.get("runtime.profile"):
            self.profile_enable(2)
        if _mca.get("runtime.trace_ring"):
            N.lib.ptc_profile_set_ring(self._ptr,
                                       _mca.get("runtime.trace_ring"))
        if _mca.get("runtime.trace_dump"):
            N.lib.ptc_flight_set_dump_path(
                self._ptr, _mca.get("runtime.trace_dump").encode())
        self._pins_chain = None
        # monitors/devices lists exist before any hook can install into
        # them (the live monitor registers for teardown at construction)
        self._devices: List = []  # CudaDevice instances (stopped on destroy)
        self._monitors: List = []  # LiveMonitor instances
        if _mca.get("runtime.pins"):
            from ..profiling.pins import enable_from_param
            enable_from_param(self, _mca.get("runtime.pins"))
        if _mca.get("runtime.live"):
            from ..profiling.live import enable_from_param as _live
            _live(self, _mca.get("runtime.live"))
        N.lib.ptc_metrics_enable(
            self._ptr, 1 if _mca.get("runtime.metrics") else 0)
        N.lib.ptc_metrics_set_release_sample(
            self._ptr, _mca.get("runtime.metrics_relsample"))
        self._metrics_registry = None
        self._metrics_exporter = None
        self._watchdog = None
        if _mca.get("runtime.metrics_port"):
            from ..profiling.metrics import MetricsExporter
            self._metrics_exporter = MetricsExporter(
                self, _mca.get("runtime.metrics_port"))
        if _mca.get("runtime.watchdog"):
            from ..profiling.metrics import enable_from_param as _wd
            self._watchdog = _wd(self, _mca.get("runtime.watchdog"))
        # crash-durable event journal (profiling/blackbox.py)
        self._journal = None
        self._fleetview = None
        self._controller = None
        if _mca.get("runtime.journal"):
            from ..profiling.blackbox import enable_from_param as _jr
            self._journal = _jr(self, _mca.get("runtime.journal"))
        if _mca.get("runtime.bind") == "core":
            N.lib.ptc_context_set_binding(self._ptr, 1)
        N.lib.ptc_context_set_sched_bypass(
            self._ptr, 1 if _mca.get("sched.bypass") else 0)
        N.lib.ptc_context_set_qos_preempt(
            self._ptr, 1 if _mca.get("sched.qos_preempt") else 0)
        # live taskpools; _tp_lock serializes walks against destroy
        self._taskpools: List = []
        self._tp_lock = threading.Lock()
        self._servers: List = []  # serve.Server instances (stats export)
        self._scope_registry = None
        if _mca.get("runtime.vpmap") != "flat":
            self.set_vpmap(_mca.get("runtime.vpmap"))
        N.lib.ptc_device_set_affinity_skew(
            self._ptr, _mca.get("device.affinity_skew"))
        # per-subsystem debug streams (parsec/utils/debug.c analog)
        for i, name in enumerate(N.DBG_SUBSYSTEMS):
            lvl = _mca.get(f"debug.{name}")
            if lvl:
                N.lib.ptc_context_set_verbose(self._ptr, i, lvl)
        # keep-alives: ctypes callbacks must outlive the native context
        self._expr_cbs: List = []
        self._body_cbs: List = []
        self._coll_cbs: List = []
        self._datas: List[Data] = []
        self._buffers: List[np.ndarray] = []
        self.collections: Dict[str, int] = {}
        # name -> Python collection object (or a shim for native linear
        # collections): rank_of + geometry, read by the static analyses
        self.collection_objs: Dict[str, object] = {}
        # the devices' pre-run residency checks (device.plan_check;
        # exported as the stats()["plan"] namespace)
        self._plan_stats: Dict[str, int] = {
            "checks": 0, "over_budget": 0, "predicted_spills": 0,
            "last_peak_bytes": 0, "last_budget_bytes": 0}
        self.arenas: Dict[str, int] = {}
        self.arena_sizes: Dict[str, int] = {}  # name -> elem bytes
        self.datatypes: Dict[str, int] = {}
        # name -> payload bytes of a datatype (None: the whole copy)
        self.datatype_bytes: Dict[str, Optional[int]] = {}
        self._destroyed = False

    # ------------------------------------------------------------ lifecycle
    def start(self):
        N.lib.ptc_context_start(self._ptr)

    def wait(self):
        N.lib.ptc_context_wait(self._ptr)

    def test(self) -> bool:
        return bool(N.lib.ptc_context_test(self._ptr))

    def destroy(self):
        if self._destroyed:
            return
        self._destroyed = True
        if _mca.get("runtime.stats"):
            import sys
            sys.stderr.write("ptc stats:\n" + self.stats_dump() + "\n")
        # uninstall the PINS chain while the native context is still
        # alive: teardown reports (print_steals) read native counters
        if self._pins_chain is not None:
            self._pins_chain.uninstall()
        # the controller restores any knob vector it holds while the
        # registry and env snapshot are still meaningful
        if self._controller is not None:
            self._controller.stop()
        for obj in (self._fleetview, self._journal, self._watchdog,
                    self._metrics_exporter):
            if obj is not None:
                obj.stop()
        for mon in list(self._monitors):
            mon.stop()
        # stop device manager threads first: they block in ptc_device_pop
        # on queues owned by the native context
        for dev in list(self._devices):
            dev.stop()
        N.lib.ptc_context_destroy(self._ptr)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.destroy()

    @property
    def nb_workers(self) -> int:
        return N.lib.ptc_context_nb_workers(self._ptr)

    @property
    def scheduler_name(self) -> str:
        """Canonical name of the scheduler module that runs (unknown
        requests fall back to "lfq")."""
        return N.lib.ptc_context_get_scheduler(self._ptr).decode()

    @property
    def comm_enabled(self) -> bool:
        return bool(N.lib.ptc_comm_enabled(self._ptr))

    def set_rank(self, myrank: int, nodes: int):
        self.myrank, self.nodes = myrank, nodes
        N.lib.ptc_context_set_rank(self._ptr, myrank, nodes)

    def set_rank_map(self, perm) -> None:
        """Install (or clear, with None/empty) the rank remap: a
        permutation applied to every collection rank_of result, so task
        affinity, successor placement and mem owners relabel
        consistently (Plan.remap_ranks computes one).  Set between
        taskpool build and run: rank_of is evaluated lazily at pool
        startup."""
        if not perm:
            N.lib.ptc_context_set_rank_map(self._ptr, None, 0)
            self.rank_map = None
            return
        perm = [int(x) for x in perm]
        if sorted(perm) != list(range(len(perm))):
            raise ValueError(f"rank map must be a permutation of "
                             f"0..{len(perm) - 1}, got {perm}")
        arr = (C.c_int32 * len(perm))(*perm)
        N.lib.ptc_context_set_rank_map(self._ptr, arr, len(perm))
        self.rank_map = tuple(perm)

    # ------------------------------------------------------------ comm (L4)
    def comm_init(self, base_port: Optional[int] = None):
        """Bring up the distributed control plane: a full-mesh loopback
        TCP transport carrying dependency activations, memory write-backs,
        DTD completion broadcasts and fences (reference: the comm engine
        and remote_dep protocol, parsec/parsec_comm_engine.h,
        parsec/remote_dep.c).  Call set_rank first; blocks until all
        ranks are connected.  A no-op on one rank."""
        if base_port is None:
            base_port = _mca.get("comm.base_port")
        if N.lib.ptc_comm_init(self._ptr, base_port) != 0:
            raise RuntimeError("comm engine init failed")
        topo = _mca.get("comm.bcast_topo")
        if topo != "star":
            self.comm_set_topology(topo)

    def comm_set_colocated(self, ranks):
        """Declare peer ranks whose devices live in this process (several
        Contexts over one card, or several cards of one process).  Device-
        resident payloads to and from them are handed off by reference
        and cloned on the card instead of crossing the host transport:
        the colocated peers MUST run a CudaDevice.  Reference seam: comm-
        engine put/get on registered memory, parsec_comm_engine.h:139-160."""
        self._colocated = {int(r) for r in ranks}

    def comm_set_topology(self, topo):
        """Activation-broadcast propagation topology: "star" (direct
        per-rank sends), "chain" (pipeline along the ring), "binomial"
        (log-depth tree).  Reference: runtime_comm_coll_bcast,
        parsec/remote_dep.c:39-47."""
        names = {"star": 0, "chain": 1, "binomial": 2}
        if isinstance(topo, str):
            if topo not in names:
                raise ValueError(
                    f"unknown broadcast topology {topo!r} "
                    f"(comm.bcast_topo): expected one of {sorted(names)}")
            t = names[topo]
        else:
            t = int(topo)
            if t not in (0, 1, 2):
                raise ValueError(
                    f"unknown broadcast topology {topo!r}: expected 0 (star),"
                    " 1 (chain), 2 (binomial)")
        N.lib.ptc_comm_set_topology(self._ptr, t)

    def comm_fence(self):
        """Flush + all-to-all fence: on return, every message sent by any
        rank before its fence has been applied everywhere.  Raises when a
        peer's connection died, or on timeout when
        PTC_MCA_comm_fence_timeout_s is set (default infinite: a slow peer
        is not a dead peer).  Each completed fence is one epoch of the
        journal's time ruler."""
        rc = N.lib.ptc_comm_fence(self._ptr)
        jr = self._journal
        if rc == 0:
            self._fence_epoch += 1
            if jr is not None:
                jr.record("fence", epoch=self._fence_epoch)
        elif jr is not None:
            jr.record("fence", epoch=self._fence_epoch,
                      error="peer_lost" if rc == -2 else "timeout")
        if rc == -2:
            raise RuntimeError("comm fence failed: peer lost")
        if rc != 0:
            raise RuntimeError("comm fence timed out")

    def comm_quiesce(self, tp=None):
        """Counting termination detection (reference: the fourcounter
        termdet module, mca/termdet/fourcounter): blocks until every rank
        is idle (for `tp`, its task count zero; context-wide otherwise)
        with no application message in flight.  For DSLs that cannot
        count tasks a priori (DTD).  Raises like comm_fence."""
        tptr = tp._ptr if tp is not None else None
        rc = N.lib.ptc_comm_quiesce(self._ptr, tptr)
        if rc == -2:
            raise RuntimeError("termdet quiesce failed: peer lost")
        if rc != 0:
            raise RuntimeError("termdet quiesce timed out")

    def comm_fini(self):
        N.lib.ptc_comm_fini(self._ptr)

    def comm_stats(self) -> dict:
        buf = (C.c_int64 * 4)()
        N.lib.ptc_comm_stats(self._ptr, buf)
        return {"msgs_sent": buf[0], "msgs_recv": buf[1],
                "bytes_sent": buf[2], "bytes_recv": buf[3]}

    def comm_rdv_stats(self) -> dict:
        """Rendezvous-protocol counters.  After a fence, registered_bytes
        and pending_pulls must both be 0 (bounded comm memory)."""
        buf = (C.c_int64 * 4)()
        N.lib.ptc_comm_rdv_stats(self._ptr, buf)
        return {"gets_sent": buf[0], "gets_served": buf[1],
                "registered_bytes": buf[2], "pending_pulls": buf[3]}

    def comm_tuning(self) -> dict:
        """The transfer path's tuning in force and the chunk protocol's
        counters: the eager/rendezvous threshold (fixed, or derived by
        the adaptive calibration from the measured RTT and memcpy rate),
        the chunk and window knobs, the chunks moved, and the streaming
        counters under "stream"."""
        buf = (C.c_int64 * 8)()
        N.lib.ptc_comm_tuning(self._ptr, buf)
        out = {"eager_limit": buf[0], "chunk_size": buf[1],
               "inflight": buf[2], "rtt_ns": buf[3],
               "memcpy_bps": buf[4], "chunks_sent": buf[5],
               "chunks_recv": buf[6], "eager_adaptive": bool(buf[7])}
        out["stream"] = self.comm_stream_stats()
        return out

    def comm_stream_stats(self) -> dict:
        """Cross-rank streaming counters (wire v4): progressive-serve
        sessions, ranged GETs parked above the d2h watermark, the per-hop
        span sums (d2h window, wire window, their overlap), peer-loss
        reaps and the rail count.  overlap_fraction is the share of the
        producer's d2h time the wire was already moving under."""
        buf = (C.c_int64 * 8)()
        N.lib.ptc_comm_stream_stats(self._ptr, buf)
        d2h = buf[3]
        return {"sessions": buf[0], "parked_gets": buf[1],
                "overlap_ns": buf[2], "d2h_ns": d2h, "wire_ns": buf[4],
                "reaps": buf[5], "rails": buf[6],
                "stream_enabled": bool(buf[7]),
                "overlap_fraction":
                    round(buf[2] / d2h, 4) if d2h > 0 else None}

    def comm_peer_stats(self) -> list:
        """Per-peer wire counters: one dict per peer rank with bytes and
        messages sent and received, parked streaming GETs, and the min
        probed RTT to that peer (0 until a probe ran).  Empty when comm
        is off."""
        cap = max(1, self.nodes)
        buf = (C.c_int64 * (cap * 6))()
        n = N.lib.ptc_comm_peer_stats(self._ptr, buf, cap)
        out = []
        for r in range(n):
            b = buf[r * 6:r * 6 + 6]
            out.append({"bytes_sent": int(b[0]), "bytes_recv": int(b[1]),
                        "msgs_sent": int(b[2]), "msgs_recv": int(b[3]),
                        "parked_gets": int(b[4]), "rtt_ns": int(b[5])})
        return out

    def comm_probe_rtts(self) -> int:
        """PING every peer and wait (<= 2 s) for per-peer min RTTs (the
        link-class auto-detect input, TopologyModel.from_rtts).  Returns
        the number of peers with a measured RTT."""
        return int(N.lib.ptc_comm_probe_rtts(self._ptr))

    def comm_topo_stats(self) -> dict:
        """Per-link-class wire counters: the per-peer native counters
        folded through the TopologyModel in force, plus the class matrix.
        The schema is the same when comm is off (every class present,
        zeroed; matrix empty)."""
        from ..comm.topology import LINK_CLASSES, default_topology
        keys = ("bytes_sent", "bytes_recv", "msgs_sent", "msgs_recv",
                "parked_gets")
        classes = {c: {k: 0 for k in keys} for c in LINK_CLASSES}
        peers = self.comm_peer_stats()
        rtts = {r: p["rtt_ns"] for r, p in enumerate(peers)
                if p["rtt_ns"] > 0}
        topo = default_topology(self.nodes, rtts_ns=rtts or None,
                                my_rank=self.myrank)
        for r, p in enumerate(peers):
            row = classes[topo.class_of(self.myrank, r)]
            for k in keys:
                row[k] += p[k]
        return {"classes": classes,
                "matrix": topo.matrix() if peers else [],
                "n_islands": topo.n_islands,
                "source": topo.source}

    def coll_stats(self) -> dict:
        """Runtime-native collective counters (the ptc_coll_* task-class
        family built by comm/coll.py): the native step/frame/byte
        counters plus the builder's op-level records (ops built, the
        topology chosen per op)."""
        buf = (C.c_int64 * 6)()
        N.lib.ptc_coll_stats(self._ptr, buf)
        py = self._coll_py_stats or {"ops": 0, "by_kind": {}, "by_topo": {}}
        return {
            "steps": buf[0],
            "send_msgs": buf[1], "send_bytes": buf[2],
            "recv_msgs": buf[3], "recv_bytes": buf[4],
            "ops": py["ops"],
            "by_kind": dict(py["by_kind"]),
            "by_topo": dict(py["by_topo"]),
        }

    def comm_clock(self) -> dict:
        """Clock-sync estimate against rank 0: offset_ns such that
        local_t + offset_ns ~ rank 0's clock, measured from PING/PONG
        midpoints at comm bring-up and refreshed at each fence (the
        minimum-RTT sample wins; err_ns is that RTT).  Trace.merge applies
        it.  measured is False before the first sample (and on one
        rank)."""
        buf = (C.c_int64 * 4)()
        N.lib.ptc_comm_clock_stats(self._ptr, buf)
        return {"offset_ns": buf[0], "err_ns": buf[1],
                "samples": buf[2], "measured": bool(buf[3])}

    def comm_clock_sync(self) -> int:
        """Force a fresh clock-sync probe burst (blocks up to ~2 s for at
        least one sample); returns the samples accumulated."""
        return N.lib.ptc_comm_clock_sync(self._ptr)

    def rusage(self) -> dict:
        """Process resource usage (the reference's per-EU rusage dumps,
        parsec/scheduling.c:45-86 — user/sys time, maxrss, context
        switches; process-wide here, workers being threads)."""
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {
            "utime_s": round(ru.ru_utime, 3),
            "stime_s": round(ru.ru_stime, 3),
            "maxrss_kb": ru.ru_maxrss,
            "vol_ctx_switches": ru.ru_nvcsw,
            "invol_ctx_switches": ru.ru_nivcsw,
            "minor_faults": ru.ru_minflt,
            "major_faults": ru.ru_majflt,
        }

    def sched_victim_order(self, worker: int, cap: int = 64):
        """A hierarchical scheduler's computed steal order for `worker`
        (None for flat modules) — test/debug probe."""
        out = (C.c_int32 * cap)()
        k = N.lib.ptc_sched_victim_order(self._ptr, worker, out, cap)
        return None if k < 0 else list(out[:k])

    def worker_binding(self, worker: int) -> int:
        """CPU the worker thread is pinned to (runtime.bind=core), or -1
        when unbound / not yet started (reference: parsec_hwloc.c)."""
        return N.lib.ptc_worker_binding(self._ptr, worker)

    # ------------------------------------------------------------ counters
    def worker_stats(self) -> list:
        """Selected-task count per worker thread (scheduler pops; ASYNC
        device chores count at dispatch)."""
        cap = max(1, self.nb_workers)
        buf = (C.c_int64 * cap)()
        n = N.lib.ptc_worker_stats(self._ptr, buf, cap)
        return [buf[i] for i in range(n)]

    def worker_steals(self) -> list:
        cap = max(1, self.nb_workers)
        buf = (C.c_int64 * cap)()
        n = N.lib.ptc_worker_steals(self._ptr, buf, cap)
        return [buf[i] for i in range(n)]

    def sched_stats(self) -> dict:
        """Dispatch fast-path counters (same keys as the reference)."""
        buf = (C.c_int64 * 12)()
        n = N.lib.ptc_sched_stats(self._ptr, buf, 12)
        v = [buf[i] for i in range(n)] + [0] * (12 - n)
        return {
            "bypass_hits": v[0],
            "bypass_enabled": bool(v[1]),
            "freelist_hits": v[2],
            "freelist_misses": v[3],
            "arena_hits": v[4],
            "arena_misses": v[5],
            "insert_batches": v[6],
            "insert_batched_tasks": v[7],
            "inject_pushes": v[8],
            "inject_pops": v[9],
            "qos_selects": v[10],
            "qos_preempts": v[11],
            "qos_preempt_enabled": bool(
                N.lib.ptc_context_get_qos_preempt(self._ptr)),
            "pools": self._qos_pool_rows(),
            "steals": self.worker_steals(),
            "executed": self.worker_stats(),
        }

    def device_stats(self) -> dict:
        """Counters aggregated across this context's devices (the keys
        of the device module's stats, the pipeline's included: prefetch
        hits/misses/staged bytes, reserve failures, spill traffic,
        dispatch-time h2d stall, the progressive serve's stream_*
        counters; the data plane's dp_* counters stay per device, in
        "devices"), the counter-level overlap ratio — the
        share of h2d nanoseconds spent on the prefetch lane, overlapping
        compute, rather than stalling a dispatch — the wave compiler's
        counters under "fuse" (summed; `refused` and `cert_uncached`
        merge the per-reason records) and each device's info object under
        "devices"."""
        devs = [dev.info() for dev in self._devices]
        keys = ("tasks", "batches", "batched_tasks", "h2d_hits",
                "h2d_bytes", "d2h_bytes", "h2d_stall_ns", "evictions",
                "dead_drops", "invalidations", "eager_gathers",
                "fused_flows", "wb_tasks", "f64_refused",
                "cache_peak_bytes",
                "prefetch_staged", "prefetch_bytes", "prefetch_hits",
                "prefetch_misses", "prefetch_wasted", "reserve_fails",
                "spills", "spill_bytes", "prefetch_h2d_ns", "ooc_waits",
                "prefetch_wakeups", "stream_serves", "stream_slices",
                "stream_d2h_ns", "stream_bytes")
        agg = {k: sum(d["stats"][k] for d in devs) for k in keys}
        moved = agg["prefetch_h2d_ns"] + agg["h2d_stall_ns"]
        agg["overlap_ratio"] = (
            round(agg["prefetch_h2d_ns"] / moved, 4) if moved else 0.0)
        fuse_keys = ("fused_waves", "fused_tasks", "fused_chains",
                     "chain_waves", "chain_parked", "chain_hits",
                     "chain_misses", "chain_drops", "cache_hits",
                     "cache_misses", "parked", "cert_hits", "cert_misses")
        fuse = {k: sum(d["fuse"][k] for d in devs) for k in fuse_keys}
        fuse["enabled"] = any(d["fuse"]["enabled"] for d in devs)
        for name in ("refused", "cert_uncached"):
            merged: Dict[str, int] = {}
            for d in devs:
                for reason, n in d["fuse"][name].items():
                    merged[reason] = merged.get(reason, 0) + n
            fuse[name] = merged
        agg["fuse"] = fuse
        agg["devices"] = devs
        return agg

    def stats(self) -> dict:
        """Unified counter snapshot of the parts the port has:
          sched   -> sched_stats()
          serve   -> the serving front door's admission/queue/reject
                     counters per tenant (serve.Server.stats());
                     {"enabled": False} when no Server is attached
          device  -> device_stats()
          comm    -> the engine's counter groups (engine, rdv, tuning,
                     stream, topo); present, zeroed, when comm is off
          coll    -> coll_stats()
          trace   -> tracing health: level, the flight recorder's
                     ring/drop state and the clock-sync estimate
          metrics -> always-on histogram subsystem health: enabled
                     flag, interned class count, exporter port and
                     watchdog status
          plan    -> the devices' pre-run residency checks
                     (device.plan_check; CudaDevice.plan_check)
          scope   -> request-scope rollups and plan-vs-measured
                     conformance (profiling/scope.py);
                     {"enabled": False} when no registry is attached
          control -> the feedback controller (analysis/control.py);
                     {"enabled": False} when none is attached
          fleet   -> the fleet view (profiling/blackbox.py FleetView);
                     {"enabled": False} when none is attached"""
        serve_ns = {"enabled": False}
        if self._servers:
            # one Server per context in practice; the last attached wins
            serve_ns = dict(self._servers[-1].stats())
            serve_ns["enabled"] = True
        reg = self._scope_registry
        wd, exp = self._watchdog, self._metrics_exporter
        tuning = self.comm_tuning()
        return {
            "sched": self.sched_stats(),
            "serve": serve_ns,
            "device": self.device_stats(),
            "comm": {
                "enabled": self.comm_enabled,
                "engine": self.comm_stats(),
                "rdv": self.comm_rdv_stats(),
                "tuning": tuning,
                # the same snapshot as tuning["stream"]: one native read
                "stream": tuning["stream"],
                "topo": self.comm_topo_stats(),
            },
            "coll": self.coll_stats(),
            "trace": {
                "level": self.profile_level(),
                "ring_bytes": self.profile_ring(),
                "dropped_events": self.profile_dropped(),
                "clock": self.comm_clock(),
            },
            "metrics": {
                "enabled": self.metrics_enabled,
                "classes": N.lib.ptc_metrics_nclasses(self._ptr),
                "exporter_port": exp.port if exp is not None else 0,
                "watchdog": wd.status() if wd is not None else None,
            },
            "plan": dict(
                enabled=_mca.get("device.plan_check") != "off",
                **self._plan_stats),
            "scope": reg.stats() if reg is not None
            else {"enabled": False},
            "control": (self._controller.stats()
                        if self._controller is not None
                        else {"enabled": False}),
            "fleet": (self._fleetview.snapshot()
                      if self._fleetview is not None
                      else {"enabled": False}),
        }

    def scope_registry(self, create: bool = True):
        """The request-scope registry (one per context;
        profiling/scope.py).  The serve stack attaches one; create=False
        just peeks."""
        if self._scope_registry is None and create:
            from ..profiling.scope import ScopeRegistry
            self._scope_registry = ScopeRegistry(self)
        return self._scope_registry

    def controller(self, create: bool = True, **kwargs):
        """The feedback controller (one per context;
        analysis/control.py).  Consumes the scope registry's
        conformance observations at pool boundaries, retunes knob
        vectors on drift, and drives adaptive speculation depth and
        tenant cache budgets.  create=False just peeks; kwargs
        (clock=, drift_ratio=, window=, ...) apply only on creation."""
        if self._controller is None and create:
            from ..analysis.control import Controller
            Controller(self, **kwargs)
        return self._controller

    def live_taskpools(self) -> list:
        """Live (not destroyed) Taskpool objects created on this
        context, oldest first."""
        with self._tp_lock:
            return [tp for tp in self._taskpools if not tp._destroyed]

    def stats_dump(self) -> str:
        """Human-readable counter dump (the --mca device_show_statistics
        analog)."""
        lines = [f"workers (selected tasks): {self.worker_stats()}"]
        steals = self.worker_steals()
        if any(steals):
            lines.append(f"worker steals: {steals}")
        bindings = [self.worker_binding(w) for w in range(self.nb_workers)]
        if any(b >= 0 for b in bindings):
            lines.append(f"worker cpu bindings: {bindings}")
        for i, dev in enumerate(self._devices):
            lines.append(f"device[{i}] queue={dev.qid} "
                         f"depth={self.device_queue_depth(dev.qid)}")
            lines.append(f"device[{i}] info: {dev.info()}")
        if self.comm_enabled:
            lines.append(f"comm: {self.comm_stats()}")
        return "\n".join(lines)

    # ------------------------------------------------------- QoS taskpools
    def taskpool(self, globals: Optional[Dict[str, int]] = None,
                 priority: Optional[int] = None,
                 weight: Optional[int] = None):
        """Create a Taskpool on this context; `priority`/`weight` arm
        per-pool QoS (see Taskpool)."""
        from .taskpool import Taskpool
        return Taskpool(self, globals=globals, priority=priority,
                        weight=weight)

    def _track_taskpool(self, tp):
        """Strong reference until Taskpool.destroy(): the native pool's
        lifetime anchors the wrapper's (and its ctypes thunks)."""
        with self._tp_lock:
            self._taskpools.append(tp)

    def _untrack_taskpool_locked(self, tp):
        """Caller holds _tp_lock (Taskpool.destroy)."""
        self._taskpools = [p for p in self._taskpools if p is not tp]

    def _qos_pool_rows(self) -> list:
        rows = []
        with self._tp_lock:
            for tp in self._taskpools:
                if tp._destroyed:
                    continue
                st = tp.qos_stats()
                if st is not None:
                    st["id"] = tp.tp_id
                    rows.append(st)
        return rows

    # ------------------------------------------------------------ registries
    def register_expr_cb(self, fn: Callable) -> int:
        cb = N.EXPR_CB_T(fn)
        self._expr_cbs.append(cb)
        return N.lib.ptc_register_expr_cb(self._ptr, cb, None)

    def register_body_cb(self, fn: Callable) -> int:
        cb = N.BODY_CB_T(fn)
        self._body_cbs.append(cb)
        return N.lib.ptc_register_body(self._ptr, cb, None)

    def data(self, key: int, array: np.ndarray) -> Data:
        d = Data(key, array)
        self._datas.append(d)
        return d

    def register_linear_collection(self, name: str, array: np.ndarray,
                                   elem_size: Optional[int] = None,
                                   nodes: int = 1, myrank: int = 0) -> int:
        """Built-in 1-D host collection: key k -> base + k*elem_size,
        rank_of(k) = k % nodes, evaluated fully natively."""
        if not array.flags["C_CONTIGUOUS"]:
            raise ValueError("linear collection array must be C-contiguous")
        if elem_size is None:
            elem_size = array.itemsize * (array.size // max(1, array.shape[0]))
        nb = array.nbytes // elem_size
        self._buffers.append(array)
        dc = N.lib.ptc_register_linear_collection(
            self._ptr, nodes, myrank, array.ctypes.data_as(C.c_void_p),
            nb, elem_size)
        self.collections[name] = dc
        from ..analysis.flowgraph import LinearCollectionShim
        self.collection_objs[name] = LinearCollectionShim(nodes, elem_size)
        return dc

    def register_collection(self, name: str, coll) -> int:
        """Register a Python data collection (duck-typed vtable: rank_of(*idx)
        -> int, data_of(*idx) -> Data)."""
        def _rank_of(user, idx, n):
            return coll.rank_of(*[idx[i] for i in range(n)])

        def _data_of(user, idx, n):
            d = coll.data_of(*[idx[i] for i in range(n)])
            return d._ptr if d is not None else None

        rcb = N.RANK_OF_CB_T(_rank_of)
        dcb = N.DATA_OF_CB_T(_data_of)
        self._coll_cbs.append((rcb, dcb, coll))
        dc = N.lib.ptc_register_collection(
            self._ptr, getattr(coll, "nodes", 1), getattr(coll, "myrank", 0),
            rcb, dcb, None)
        self.collections[name] = dc
        self.collection_objs[name] = coll
        return dc

    def register_arena(self, name: str, elem_size: int) -> int:
        aid = N.lib.ptc_register_arena(self._ptr, elem_size)
        self.arenas[name] = aid
        self.arena_sizes[name] = elem_size
        return aid

    def set_vpmap(self, spec) -> List[int]:
        """Virtual-process map (reference: parsec/vpmap.c): a vp id per
        worker, before the context starts — a list of ints, 'numa' (the
        NUMA node of each worker's round-robin binding cpu) or a
        comma-separated string.  Short specs repeat."""
        n = N.lib.ptc_context_nb_workers(self._ptr)
        if isinstance(spec, (list, tuple)):
            vps = [int(x) for x in spec]
        elif spec == "numa":
            vps = _numa_vpmap(n)
        else:
            vps = [int(x) for x in str(spec).split(",") if x.strip()]
        if not vps:
            vps = [0] * n
        if len(vps) < n:
            vps = (vps * (n // len(vps) + 1))[:n]
        vps = vps[:n]
        arr = (C.c_int32 * n)(*vps)
        if N.lib.ptc_context_set_vpmap(self._ptr, arr, n) != 0:
            raise RuntimeError(
                "set_vpmap: context already started — the scheduler was "
                "installed with the previous map")
        return vps

    def register_datatype(self, name: str, elem_bytes: int, count: int,
                          stride_bytes: Optional[int] = None) -> int:
        """Wire datatype: `count` blocks of `elem_bytes` spaced
        `stride_bytes` apart (default contiguous)."""
        if stride_bytes is None:
            stride_bytes = elem_bytes
        did = N.lib.ptc_register_datatype(self._ptr, elem_bytes, count,
                                          stride_bytes)
        if did < 0:
            raise ValueError(
                f"bad datatype {name!r}: elem={elem_bytes} count={count} "
                f"stride={stride_bytes} (need elem>0, count>0, "
                "stride>=elem)")
        self.datatypes[name] = did
        self.datatype_bytes[name] = elem_bytes * count
        return did

    def register_datatype_indexed(self, name: str, segments) -> int:
        """Indexed datatype: explicit (offset_bytes, len_bytes) segments —
        the MPI_Type_indexed analog (expresses triangles etc.).  Usable as
        a wire type (pack/scatter the segments) or as a dep's LOCAL
        reshape type (In/Out ltype= or JDF `[type = name]`): the dep's
        data is routed through a new datacopy holding only the selected
        bytes, memoized per (source copy, type) — the reference's
        datacopy-future reshape chain (parsec/parsec_reshape.c,
        parsec/utils/parsec_datacopy_future.c)."""
        n = len(segments)
        offs = (C.c_int64 * n)(*[int(o) for o, _ in segments])
        lens = (C.c_int64 * n)(*[int(ln) for _, ln in segments])
        did = N.lib.ptc_register_datatype_indexed(self._ptr, offs, lens, n)
        if did < 0:
            raise ValueError(
                f"bad indexed datatype {name!r}: need >=1 segment, "
                "offsets >= 0, lens > 0")
        self.datatypes[name] = did
        self.datatype_bytes[name] = sum(int(ln) for _, ln in segments)
        return did

    def register_datatype_cast(self, name: str, from_dtype, to_dtype,
                               count: int = -1) -> int:
        """Element-cast datatype: contiguous `count` elements (-1 = the
        whole copy) converted from_dtype -> to_dtype.  As a local reshape
        type this is the arbitrary type->type promise of the reference's
        reshape machinery; on a Mem write-back dep the conversion
        reverses (reference: parsec_reshape.c type conversion futures)."""
        kinds = N.ELEM_KINDS
        fk = kinds.get(np.dtype(from_dtype).name)
        tk = kinds.get(np.dtype(to_dtype).name)
        if fk is None or tk is None:
            raise ValueError(
                f"cast datatype {name!r}: unsupported element type "
                f"(supported: {sorted(kinds)})")
        did = N.lib.ptc_register_datatype_cast(self._ptr, fk, tk, count)
        if did < 0:
            raise ValueError(f"bad cast datatype {name!r}")
        self.datatypes[name] = did
        self.datatype_bytes[name] = (
            None if count < 0 else count * np.dtype(to_dtype).itemsize)
        return did

    def reshape_stats(self):
        """(conversions, hits): local-reshape futures triggered vs
        memoized/identity reuses (avoidable-reshape accounting)."""
        conv = C.c_int64(0)
        hits = C.c_int64(0)
        N.lib.ptc_ctx_reshape_stats(self._ptr, C.byref(conv), C.byref(hits))
        return conv.value, hits.value

    # ------------------------------------------------------------ devices
    def device_queue_set_weight(self, qid: int, weight: float):
        """Relative device speed for best-device routing (reference:
        the per-device flop-rate weights, parsec/mca/device/device.h:137)."""
        N.lib.ptc_device_queue_set_weight(self._ptr, qid, float(weight))

    def device_queue_depth(self, qid: int) -> int:
        return N.lib.ptc_device_queue_depth(self._ptr, qid)

    def device_queue_new(self) -> int:
        return N.lib.ptc_device_queue_new(self._ptr)

    def host_wrote(self, coll, m: int, n: int = 0):
        """A caller rewrote a collection tile's HOST bytes directly
        (numpy, outside the runtime): every device mirror of it is stale
        and must drop — the copy version cannot tell, no runtime write
        happened.  The serving engine's slot and prompt staging and the
        PagePool's copy-on-write clones route through here; a whole
        collection's tiles: Collection.host_wrote()."""
        d = coll._datas.get((m, n))
        if d is not None:
            self._host_wrote_data(d)

    def _host_wrote_data(self, d: Data) -> None:
        """Drop every device mirror of `d`'s host copy and its owner
        stamp, as the runtime's own host overwrite does (the copy
        invalidation callback): host_wrote and Collection.host_wrote."""
        if not self._devices:
            return
        h = N.lib.ptc_copy_handle(N.lib.ptc_data_host_copy(d._ptr))
        if h:
            for dev in list(self._devices):
                dev._drop_mirror(h)
            N.lib.ptc_device_clear_data_owner(self._ptr, h, -1)

    def device_set_data_owner(self, handle: int, qid: int, version: int):
        """Stamp which device queue holds a current mirror of the copy
        with this handle (data-affinity routing; reference:
        parsec_get_best_device's owner pass, device.c:100-117)."""
        N.lib.ptc_device_set_data_owner(self._ptr, handle, qid, version)

    def device_clear_data_owner(self, handle: int, qid: int = -1):
        """Drop the mirror-owner stamp of a copy (only if `qid` holds it;
        -1: whoever does)."""
        N.lib.ptc_device_clear_data_owner(self._ptr, handle, qid)

    def device_set_affinity_skew(self, skew: float):
        """Spill guard for affinity routing: the owning queue loses to
        the least-loaded one when its load exceeds skew * best (<=0
        disables the affinity pass)."""
        N.lib.ptc_device_set_affinity_skew(self._ptr, float(skew))

    def device_get_data_owner(self, handle: int):
        """(qid, version) of the stamped mirror owner, or (-1, 0)."""
        ver = C.c_int32(0)
        q = N.lib.ptc_device_get_data_owner(self._ptr, handle, C.byref(ver))
        return q, ver.value

    def device_pop(self, qid: int, timeout_ms: int = 100):
        return N.lib.ptc_device_pop(self._ptr, qid, timeout_ms)

    def device_peek(self, qid: int, max_tasks: int = 64) -> list:
        """Observational snapshot of the ready tasks queued on a device
        queue (native ptc_peek_ready): [(task_ref, [(handle, size,
        version), ...]), ...], one record per read flow.  A probe for
        tests and tooling: the peek pins are released before returning,
        so records must not be dereferenced; the prefetch lane consumes
        the span directly and holds its pins across the staging copy."""
        tasks = N.peek_ready(self._ptr, qid, N.peek_buffer(max_tasks),
                             max_tasks)
        try:
            return [(tref, [(N.lib.ptc_copy_handle(cptr), size, ver)
                            for cptr, _, size, ver in recs])
                    for tref, recs in tasks]
        finally:
            for _, recs in tasks:
                for cptr, *_ in recs:
                    N.lib.ptc_copy_unpin(self._ptr, cptr)

    def device_peek_front(self, qid: int, max_tasks: int = 256) -> list:
        """Wave-granular ready-front census (native
        ptc_peek_ready_front): [(class_id, taskpool_ptr), ...] for the
        tasks still queued on `qid` — class ids only, nothing popped or
        pinned; DTD tasks report class_id -1."""
        buf = (C.c_int64 * (2 * max_tasks))()
        n = N.lib.ptc_peek_ready_front(self._ptr, qid, buf, max_tasks)
        return [(buf[2 * i], buf[2 * i + 1]) for i in range(n)]

    def task_complete(self, task_ptr):
        N.lib.ptc_task_complete(self._ptr, task_ptr)

    def task_fail(self, task_ptr):
        """Fail an ASYNC-owned task: aborts its taskpool (successors are
        never released; waiters observe the error)."""
        N.lib.ptc_task_fail(self._ptr, task_ptr)

    # ------------------------------------------------------------ profiling
    def profile_enable(self, enable=True):
        """Tracing level: 0/False off; 1 EXEC spans (and the device's
        DEVICE_DISPATCH / DEVICE_H2D spans); 2/True adds RELEASE_DEPS
        spans and dep-EDGE pairs for DAG capture (profiling.to_dot,
        profiling.critical_path)."""
        level = 2 if enable is True else int(enable)
        N.lib.ptc_profile_enable(self._ptr, level)
        if level > 0:
            # the wall clock against the trace clock, as tracing starts
            # (take_trace stamps it beside its own: Trace.to_wall)
            from ..profiling.trace import clock_anchor
            self._wall_anchor = clock_anchor()
        self._refresh_listening()

    def _refresh_listening(self) -> None:
        """Whether anything reads the spans the device layer emits: the
        trace (a level above 0) or a PINS chain.  While nothing does, the
        device skips their native calls; its counters do not depend on
        it."""
        self._listening = self._pins_on or \
            N.lib.ptc_profile_level(self._ptr) > 0

    def profile_level(self) -> int:
        """Current trace level (0 off, 1 spans, 2 +edges)."""
        return N.lib.ptc_profile_level(self._ptr)

    def profile_ring(self, nbytes: Optional[int] = None) -> int:
        """Flight-recorder ring mode (runtime.trace_ring /
        PTC_MCA_runtime_trace_ring): bound each worker's trace buffer to
        `nbytes`, overwriting the OLDEST whole events when full; a
        taskpool abort dumps it (see flight_dump).  With no argument,
        read the configured bytes per worker (0 = unbounded);
        reconfiguring clears buffered events, so arm it before the run."""
        if nbytes is not None:
            N.lib.ptc_profile_set_ring(self._ptr, int(nbytes))
        return N.lib.ptc_profile_ring(self._ptr)

    def profile_dropped(self) -> int:
        """Events overwritten before being taken (ring mode), summed
        across workers — the flight recorder's loss meter."""
        return N.lib.ptc_profile_dropped(self._ptr)

    def flight_dump(self, path: str) -> None:
        """Write the CURRENT trace buffers (without draining them) as a
        loadable .ptt v2 file — the flight-recorder sink.  The runtime
        fires this itself (once) on a taskpool abort, to
        PTC_MCA_runtime_trace_dump or /tmp/ptc_flight.<rank>.ptt."""
        if N.lib.ptc_flight_dump(self._ptr, str(path).encode()) != 0:
            raise OSError(f"flight dump to {path!r} failed")

    # ------------------------------------------------------------ metrics
    @property
    def metrics_enabled(self) -> bool:
        """Always-on latency histograms (runtime.metrics, default on):
        per-class EXEC duration, sampled release latency and the
        device's h2d stall, accumulated natively at the span-close
        paths, independent of the trace level."""
        return bool(N.lib.ptc_metrics_enabled(self._ptr))

    def metrics_enable(self, on: bool = True):
        N.lib.ptc_metrics_enable(self._ptr, 1 if on else 0)

    def metrics_histograms(self, merged: bool = False):
        """Decoded histogram records (profiling.metrics.Hist list);
        merged=True folds the fence-time peer snapshots (none on one
        rank)."""
        from ..profiling.metrics import snapshot_histograms
        return snapshot_histograms(self, merged=merged)

    def metrics_registry(self):
        """The unified MetricsRegistry over this context (lazy,
        cached): histogram quantiles + stats() counters, with
        Prometheus text export."""
        if self._metrics_registry is None:
            from ..profiling.metrics import MetricsRegistry
            self._metrics_registry = MetricsRegistry(self)
        return self._metrics_registry

    def metrics_inflight(self) -> list:
        """Open EXEC bodies as (worker, class_name, begin_ns, scope_id)
        — the watchdog's stuck-task scan input (begin_ns is on the
        native trace clock; scope_id = the owning pool's request scope,
        0 when unscoped)."""
        cap = 4 * (self.nb_workers + 2)
        buf = (C.c_int64 * cap)()
        n = N.lib.ptc_metrics_inflight(self._ptr, buf, cap)
        name_buf = C.create_string_buffer(256)
        out = []
        for i in range(0, n, 4):
            mid = buf[i + 1]
            k = N.lib.ptc_metrics_class_name(self._ptr, mid, name_buf, 256)
            name = name_buf.value.decode() if k > 0 else f"#{mid}"
            out.append((int(buf[i]), name, int(buf[i + 2]),
                        int(buf[i + 3])))
        return out

    def metrics_peer_rtts(self) -> list:
        """Fence-time clock-sync RTT per peer rank (zeros on one rank,
        where no fence runs) — the watchdog's slow-rank input."""
        cap = max(1, self.nodes)
        buf = (C.c_int64 * cap)()
        n = N.lib.ptc_metrics_peer_rtts(self._ptr, buf, cap)
        return [int(buf[i]) for i in range(n)]

    def profile_take(self) -> np.ndarray:
        """Drain the profiling buffers: an (n, 8) int64 array of (key,
        phase, class_id, local0, local1, worker, aux, t_ns), read in
        fixed-size chunks until the native side reports empty.  See
        profiling.trace for the dictionary and the trace tooling."""
        words = 8
        chunk_words = (1 << 16) * words
        buf = (C.c_int64 * chunk_words)()
        parts = []
        while True:
            n = N.lib.ptc_profile_take(self._ptr, buf, chunk_words)
            if n <= 0:
                break
            parts.append(np.ctypeslib.as_array(buf, shape=(chunk_words,))[:n]
                         .copy())
            if n < chunk_words:
                break
        if not parts:
            return np.empty((0, words), dtype=np.int64)
        return np.concatenate(parts).reshape(-1, words)
