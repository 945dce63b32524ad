"""Black-box flight recorder + fleet federation (ptc-blackbox).

Pod-scale fault tolerance is diagnostic before it is
corrective: a survivor can only replay a dead rank's ancestor cone or
re-fetch its frozen prefix pages if somebody durably recorded what that
rank held.  Today watchdog events, scope/control events and admission
decisions live in process memory and die with the process.  This module
is the recorder:

  Journal    schema-versioned per-rank JSONL event journal
             (`PTC_MCA_runtime_journal=<dir>` -> <dir>/journal.<rank>.jsonl)
             unifying watchdog detections, ScopeRegistry decision events,
             serve admission/reject/cancel, fence epochs and peer loss.
             Records are buffered in memory and drained + fsynced by a
             cadence thread (runtime.journal_fsync_s) so the hot path
             never blocks on disk; the sink rotates at
             runtime.journal_max_bytes like the LiveMonitor.  Every
             runtime.journal_checkpoint_s the journal records this
             rank's recovery-relevant INVENTORY (live scope ids, QoS
             pool census, inflight EXEC bodies, registered providers
             such as PagePool.frozen_keys, the comm clock offsets) and
             replicates it to every live peer as a control frame; a
             peer's connection dying outside shutdown is journalled as
             `peer_loss` with that peer's last inventory.  The journal
             also
             arms the native fatal-signal crash dump
             (<dir>/crash.<rank>.ptt; runtime.journal_crash_dump).

  FleetView  scrapes every replica's stats + health on a cadence —
             in-process serve.Server objects or remote /stats.json +
             /healthz URLs — merges tenant histograms fleet-wide (the
             same log2/8-sub-bucket fold as the fence-time MSG_METRICS
             merge), and exposes global per-tenant SLO burn, aggregate
             tokens/s and per-replica occupancy as /fleet.json +
             Prometheus `ptc_fleet_*` samples.  Snapshots append to the
             journal; `ptc_top --fleet` renders them.

tools/ptc_postmortem.py assembles the cross-rank incident report from a
journal directory (see that module).  Schema: every journal record is
one JSON object per line with at least

    {"v": 1, "type": ..., "t_ns": ptc_clock_ns, "rank": r, "seq": n}

`seq` is monotonic per rank per process; `t_ns` is the NATIVE trace
clock so journal records align exactly with .ptt trace spans and the
checkpointed clock offsets make cross-rank merges causally consistent.

Port of parsec_tpu/profiling/blackbox.py.
"""
from __future__ import annotations

import ctypes as C
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from .. import _native as N

SCHEMA_VERSION = 1

#: record types a v1 journal may contain (postmortem tolerates unknown
#: types — the list documents the contract, it does not gate writes)
RECORD_TYPES = (
    "journal_open", "watchdog", "scope_event", "serve", "fence",
    "peer_loss", "checkpoint", "fleet", "monitor", "journal_close",
)


def _now_ns() -> int:
    return int(N.lib.ptc_clock_ns())


class Journal:
    """Crash-durable per-rank event journal (see module docstring).

    `record()` is the hot-path API: it formats the line and appends it
    to an in-memory pending list (bounded; overflow is counted, never
    blocks).  The cadence thread drains pending lines to the sink,
    fsyncs on `fsync_s`, checkpoints inventory on `checkpoint_s`,
    refreshes the preformatted crash-dump header, and polls the comm
    peer-loss flags."""

    _PENDING_CAP = 16384  # lines buffered before drops (cadence wedged)

    def __init__(self, ctx, dirpath: Optional[str] = None,
                 max_bytes: Optional[int] = None,
                 fsync_s: Optional[float] = None,
                 checkpoint_s: Optional[float] = None,
                 arm_crash: Optional[bool] = None,
                 start: bool = True):
        from ..utils import params as _mca
        self.ctx = ctx
        self.dir = str(dirpath if dirpath is not None
                       else _mca.get("runtime.journal"))
        if not self.dir:
            raise ValueError("Journal needs a directory "
                             "(PTC_MCA_runtime_journal)")
        os.makedirs(self.dir, exist_ok=True)
        self.max_bytes = int(_mca.get("runtime.journal_max_bytes")
                             if max_bytes is None else max_bytes)
        self.fsync_s = float(_mca.get("runtime.journal_fsync_s")
                             if fsync_s is None else fsync_s)
        self.checkpoint_s = float(_mca.get("runtime.journal_checkpoint_s")
                                  if checkpoint_s is None else checkpoint_s)
        self.arm_crash = bool(_mca.get("runtime.journal_crash_dump")
                              if arm_crash is None else arm_crash)
        self._lock = threading.Lock()
        self._pending: List[str] = []
        self._seq = 0
        self._dropped = 0
        self._fsyncs = 0
        self._rotations = 0
        self._checkpoints = 0
        self._written = 0          # bytes in the current generation
        self._fh = None            # sink; path resolved at first drain
        self.path: Optional[str] = None
        self._providers: Dict[str, Callable[[], object]] = {}
        self._armed_rank: Optional[int] = None
        self._lost_seen: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        ctx._journal = self
        self.record("journal_open", dir=self.dir,
                    fsync_s=self.fsync_s, checkpoint_s=self.checkpoint_s)
        self._maybe_arm_crash()
        if start:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="ptc-journal")
            self._thread.start()

    # ------------------------------------------------------------ record
    def record(self, type_: str, **fields):
        """Append one schema-v1 record (thread-safe, never blocks on
        disk).  Fields may override the stamped `t_ns` (event sources
        that carry their own native-clock timestamp should)."""
        rec = {"v": SCHEMA_VERSION, "type": str(type_),
               "t_ns": _now_ns(), "rank": self.ctx.myrank}
        rec.update(fields)
        try:
            line = json.dumps(rec, default=str) + "\n"
        except Exception:
            return
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq  # noqa: F841 (kept for parity)
            # seq rides inside the line: re-serialize the tail cheaply
            line = line[:-2] + f', "seq": {self._seq}}}\n'
            if len(self._pending) >= self._PENDING_CAP:
                self._dropped += 1
                return
            self._pending.append(line)

    def emit(self, rec: dict):
        """LiveMonitor-compatible sink API (watchdog fan-out)."""
        self.record("monitor", **rec)

    def register_inventory(self, name: str, fn: Callable[[], object]):
        """Register a checkpoint inventory provider — e.g.
        `jr.register_inventory("frozen_page_keys", pool.frozen_keys)`.
        Called (guarded) at every checkpoint; the result must be
        JSON-serializable."""
        with self._lock:
            self._providers[str(name)] = fn

    # ------------------------------------------------------- checkpoint
    def inventory(self) -> dict:
        """This rank's recovery-relevant inventory: exactly the input a
        lineage-replay recovery pass consumes."""
        ctx = self.ctx
        inv: dict = {"rank": ctx.myrank}
        try:
            reg = getattr(ctx, "_scope_registry", None)
            inv["live_scopes"] = (reg.live_scopes()
                                  if reg is not None else [])
        except Exception:
            inv["live_scopes"] = []
        try:
            inv["qos_pools"] = ctx._qos_pool_rows()
        except Exception:
            inv["qos_pools"] = []
        try:
            inv["inflight"] = [list(q) for q in ctx.metrics_inflight()]
        except Exception:
            inv["inflight"] = []
        try:
            inv["clock"] = ctx.comm_clock()
        except Exception:
            inv["clock"] = {}
        with self._lock:
            providers = dict(self._providers)
        for name, fn in providers.items():
            try:
                inv[name] = fn()
            except Exception:
                pass
        return inv

    def checkpoint(self) -> dict:
        """Record the inventory and replicate it to every live peer as
        a blob control frame (control frames never dirty a fence)."""
        inv = self.inventory()
        self.record("checkpoint", inventory=inv)
        with self._lock:
            self._checkpoints += 1
        if getattr(self.ctx, "comm_enabled", False):
            try:
                rec = {"rank": self.ctx.myrank, "t_ns": _now_ns(),
                       "inventory": inv}
                # the transfer plane's (host, card) identity rides the
                # same latest-blob slot (device/cuda.py): keep it there
                if getattr(self.ctx, "_dp_ident", None):
                    rec["dp"] = self.ctx._dp_ident
                blob = json.dumps(rec, default=str).encode()
                N.lib.ptc_comm_share_blob(self.ctx._ptr, blob, len(blob))
            except Exception:
                pass
        return inv

    # -------------------------------------------------------- peer loss
    def peer_blob(self, rank: int, cap: int = 1 << 20) -> Optional[dict]:
        """The latest inventory blob held for `rank` (parsed JSON),
        None when no blob has been received / comm is off."""
        try:
            buf = C.create_string_buffer(cap)
            n = N.lib.ptc_comm_peer_blob(self.ctx._ptr, int(rank), buf, cap)
            if n <= 0:
                return None
            if n > cap:
                buf = C.create_string_buffer(int(n))
                n = N.lib.ptc_comm_peer_blob(self.ctx._ptr, int(rank),
                                             buf, int(n))
                if n <= 0:
                    return None
            return json.loads(buf.raw[:int(n)].decode(errors="replace"))
        except Exception:
            return None

    def lost_peers(self) -> set:
        """Ranks whose connection died outside shutdown (so far)."""
        self._poll_peers()
        return set(self._lost_seen)

    def _poll_peers(self):
        if not getattr(self.ctx, "comm_enabled", False):
            return
        nodes = int(getattr(self.ctx, "nodes", 1) or 1)
        try:
            buf = (C.c_int64 * nodes)()
            n = N.lib.ptc_comm_peers_lost(self.ctx._ptr, buf, nodes)
        except Exception:
            return
        for r in range(int(n)):
            if not buf[r] or r in self._lost_seen:
                continue
            self._lost_seen.add(r)
            rec = {"peer": r, "inventory": self.peer_blob(r)}
            try:
                rec["rdv"] = self.ctx.comm_rdv_stats()
            except Exception:
                pass
            crash = os.path.join(self.dir,
                                 f"crash.{self.ctx.myrank}.ptt")
            if os.path.exists(crash):
                rec["crash_dump"] = crash
            self.record("peer_loss", **rec)

    # ------------------------------------------------------- crash path
    def _maybe_arm_crash(self):
        if not self.arm_crash:
            return
        rank = self.ctx.myrank
        if self._armed_rank == rank:
            return
        path = os.path.join(self.dir, f"crash.{rank}.ptt")
        try:
            if N.lib.ptc_crash_arm(self.ctx._ptr, path.encode()) == 0:
                self._armed_rank = rank
        except Exception:
            pass

    # ---------------------------------------------------------- cadence
    def _loop(self):
        last_fsync = last_ckpt = time.monotonic()
        tick = max(0.01, min(self.fsync_s if self.fsync_s > 0 else 0.5,
                             self.checkpoint_s
                             if self.checkpoint_s > 0 else 0.5) / 2.0)
        while not self._stop.wait(tick):
            now = time.monotonic()
            # rank may have been assigned after construction: re-arm the
            # crash path so the artifact lands under the right name
            self._maybe_arm_crash()
            try:
                self._poll_peers()
            except Exception:
                pass
            if self.checkpoint_s > 0 and \
                    now - last_ckpt >= self.checkpoint_s:
                last_ckpt = now
                try:
                    self.checkpoint()
                except Exception:
                    pass
                if self._armed_rank is not None:
                    try:  # clock offsets drift between fences
                        N.lib.ptc_crash_update_meta(self.ctx._ptr)
                    except Exception:
                        pass
            do_fsync = self.fsync_s <= 0 or now - last_fsync >= self.fsync_s
            try:
                self.flush(fsync=do_fsync)
            except Exception:
                pass
            if do_fsync:
                last_fsync = now

    def flush(self, fsync: bool = True):
        """Drain pending records to the sink (rotating at the cap); with
        fsync=True the drained bytes are durable on return."""
        with self._lock:
            lines, self._pending = self._pending, []
            self._drain_locked(lines, fsync)

    def _drain_locked(self, lines: List[str], fsync: bool):
        if self._fh is None:
            self.path = os.path.join(
                self.dir, f"journal.{self.ctx.myrank}.jsonl")
            self._fh = open(self.path, "a")
            try:
                self._written = os.fstat(self._fh.fileno()).st_size
            except OSError:
                self._written = 0
        wrote = False
        for line in lines:
            # size-capped rotation, checked BEFORE the write so a line
            # lands whole in exactly one generation (LiveMonitor rule)
            if self.max_bytes > 0 and \
                    self._written + len(line) > self.max_bytes and \
                    self._written > 0:
                self._fh.close()
                self._fh = None
                try:
                    os.replace(self.path, self.path + ".1")
                    self._rotations += 1
                except OSError as e:
                    sys.stderr.write(f"ptc-journal: rotation failed "
                                     f"({e!r}); continuing in place\n")
                self._fh = open(self.path, "a")
                self._written = 0
            self._fh.write(line)
            self._written += len(line)
            wrote = True
        if self._fh is not None and (wrote or fsync):
            self._fh.flush()
            if fsync:
                try:
                    os.fsync(self._fh.fileno())
                    self._fsyncs += 1
                except OSError:
                    pass

    # --------------------------------------------------------- lifecycle
    def stop(self):
        if self._stop.is_set():
            return
        self.record("journal_close", records=self._seq,
                    dropped=self._dropped)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        try:
            self.flush(fsync=True)
        except Exception:
            pass
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
        if self._armed_rank is not None:
            try:
                N.lib.ptc_crash_disarm(self.ctx._ptr)
            except Exception:
                pass
            self._armed_rank = None
        if getattr(self.ctx, "_journal", None) is self:
            self.ctx._journal = None

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": True, "dir": self.dir, "path": self.path,
                    "records": self._seq, "dropped": self._dropped,
                    "fsyncs": self._fsyncs, "rotations": self._rotations,
                    "checkpoints": self._checkpoints,
                    "crash_armed": self._armed_rank is not None,
                    "lost_peers": sorted(self._lost_seen)}


def enable_from_param(ctx, value) -> Optional[Journal]:
    """PTC_MCA_runtime_journal=<dir> hook (Context.__init__)."""
    d = str(value or "").strip()
    if not d:
        return None
    try:
        return Journal(ctx, d)
    except Exception as e:
        sys.stderr.write(f"ptc-journal: enable failed ({e!r})\n")
        return None


# ---------------------------------------------------------------- fleet
def _merge_sparse_hist(dst, sparse: dict):
    """Fold one tenant_export sparse histogram into a ScopeHist (the
    same log2/8-sub-bucket scheme as the fence-time MSG_METRICS merge:
    bucket indices are shared, so merging is pure addition)."""
    dst.count += int(sparse.get("count", 0))
    dst.sum += int(sparse.get("sum", 0))
    for idx, cnt in sparse.get("buckets", []):
        i = int(idx)
        if 0 <= i < dst.buckets.shape[0]:
            dst.buckets[i] += int(cnt)


class FleetView:
    """Fleet-wide metrics federation (see module docstring).  Targets
    are in-process serve.Server objects and/or base URLs of remote
    metrics exporters ("http://host:port").  `scrape_once()` is
    synchronous; with `start=True` and a positive interval a daemon
    thread scrapes on the cadence.  When `ctx` is given the view
    registers as ctx._fleetview: Context.stats() grows a "fleet"
    namespace, /fleet.json serves the snapshot and prometheus_text
    appends the ptc_fleet_* samples."""

    def __init__(self, ctx=None, servers=(), urls=(),
                 interval_s: Optional[float] = None,
                 journal: Optional[Journal] = None, start: bool = True):
        from ..utils import params as _mca
        self.ctx = ctx
        self.servers = list(servers)
        self.urls = list(urls)
        self.interval_s = float(_mca.get("runtime.fleet_scrape_s")
                                if interval_s is None else interval_s)
        self.journal = journal or (getattr(ctx, "_journal", None)
                                   if ctx is not None else None)
        self._lock = threading.Lock()
        self._snap: Optional[dict] = None
        self._scrapes = 0
        self._errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if ctx is not None:
            ctx._fleetview = self
        if start and self.interval_s > 0:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="ptc-fleetview")
            self._thread.start()

    # ---------------------------------------------------------- scraping
    def _scrape_server(self, srv) -> Optional[dict]:
        row = dict(srv.advertise())
        try:
            row["tenants"] = srv.scope.tenant_export()
        except Exception:
            row["tenants"] = {}
        return row

    def _scrape_url(self, base: str) -> Optional[dict]:
        import urllib.request
        base = base.rstrip("/")
        row: dict = {"name": base}
        try:
            with urllib.request.urlopen(base + "/stats.json",
                                        timeout=2) as r:
                snap = json.loads(r.read().decode())
            row["tenants"] = snap.get("scope_hists", {})
            c = snap.get("counters", {})
            for src, dst in (("ptc_serve_totals_active_pools",
                              "active_pools"),
                             ("ptc_serve_totals_queue_depth",
                              "queue_depth")):
                if src in c:
                    row[dst] = c[src]
        except Exception:
            self._errors += 1
            return None
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=2) as r:
                row["healthy"] = r.status == 200
        except Exception:
            # urllib raises on 503: unhealthy, not unreachable
            row["healthy"] = False
        return row

    def scrape_once(self) -> dict:
        """Scrape every target and rebuild the fleet snapshot."""
        from .scope import ScopeHist
        rows = []
        for srv in self.servers:
            try:
                rows.append(self._scrape_server(srv))
            except Exception:
                self._errors += 1
        for url in self.urls:
            row = self._scrape_url(url)
            if row is not None:
                rows.append(row)
        merged: Dict[str, Dict[str, ScopeHist]] = {}
        counters: Dict[str, Dict[str, int]] = {}
        burn_num: Dict[str, float] = {}
        burn_den: Dict[str, int] = {}
        agg_tps: Dict[str, float] = {}
        for row in rows:
            for tname, texp in (row.get("tenants") or {}).items():
                th = merged.setdefault(tname, {})
                tc = counters.setdefault(tname, {})
                for hname, sparse in (texp.get("hists") or {}).items():
                    _merge_sparse_hist(th.setdefault(hname, ScopeHist()),
                                       sparse)
                for k, v in (texp.get("counters") or {}).items():
                    tc[k] = tc.get(k, 0) + int(v)
                slo = texp.get("slo") or {}
                n = int(slo.get("window_n", 0) or 0)
                if n:
                    burn_num[tname] = burn_num.get(tname, 0.0) + \
                        float(slo.get("burn_rate", 0.0)) * n
                    burn_den[tname] = burn_den.get(tname, 0) + n
                tps = (texp.get("hists") or {}).get("tokens_per_s")
                if tps and tps.get("count"):
                    # per-replica mean decode rate, summed fleet-wide:
                    # the aggregate-throughput estimate when each
                    # replica streams one sequence per tenant
                    agg_tps[tname] = agg_tps.get(tname, 0.0) + \
                        tps["sum"] / tps["count"]
        tenants = {}
        for tname, th in merged.items():
            row = {"counters": counters.get(tname, {})}
            for hname, h in th.items():
                row[f"{hname}_p50"] = round(h.quantile(0.50), 1)
                row[f"{hname}_p99"] = round(h.quantile(0.99), 1)
                row[f"{hname}_count"] = h.count
            den = burn_den.get(tname, 0)
            row["slo_burn_rate"] = round(
                burn_num.get(tname, 0.0) / den, 4) if den else 0.0
            row["agg_tokens_per_s"] = round(agg_tps.get(tname, 0.0), 1)
            tenants[tname] = row
        replicas = []
        for row in rows:
            replicas.append({k: row.get(k) for k in
                             ("name", "healthy", "active_pools",
                              "queue_depth", "queued_bytes",
                              "slo_burn_rate", "admission_pressure")
                             if k in row})
        with self._lock:
            self._scrapes += 1
            self._snap = {
                "enabled": True,
                "t": time.time(),
                "scrapes": self._scrapes,
                "errors": self._errors,
                "interval_s": self.interval_s,
                "replicas": replicas,
                "healthy_replicas": sum(1 for r in replicas
                                        if r.get("healthy")),
                "tenants": tenants,
            }
            snap = self._snap
        if self.journal is not None:
            try:
                self.journal.record(
                    "fleet", replicas=len(replicas),
                    healthy=snap["healthy_replicas"],
                    tenants={t: {"slo_burn_rate": v["slo_burn_rate"],
                                 "agg_tokens_per_s":
                                     v["agg_tokens_per_s"]}
                             for t, v in tenants.items()})
            except Exception:
                pass
        return snap

    def snapshot(self) -> dict:
        """The latest fleet snapshot ({"enabled": False} before the
        first scrape) — the /fleet.json + stats()["fleet"] body."""
        with self._lock:
            return dict(self._snap) if self._snap is not None \
                else {"enabled": False}

    # -------------------------------------------------------- prometheus
    def prometheus_lines(self) -> List[str]:
        snap = self.snapshot()
        if not snap.get("enabled"):
            return []
        lines = ["# TYPE ptc_fleet_replicas gauge",
                 f"ptc_fleet_replicas {len(snap['replicas'])}",
                 "# TYPE ptc_fleet_healthy_replicas gauge",
                 f"ptc_fleet_healthy_replicas {snap['healthy_replicas']}"]
        for fam, key in (("ptc_fleet_replica_healthy", "healthy"),
                         ("ptc_fleet_replica_active_pools",
                          "active_pools"),
                         ("ptc_fleet_replica_queue_depth", "queue_depth"),
                         ("ptc_fleet_replica_slo_burn_rate",
                          "slo_burn_rate")):
            rows = [(r.get("name"), r.get(key)) for r in snap["replicas"]
                    if r.get(key) is not None]
            if not rows:
                continue
            lines.append(f"# TYPE {fam} gauge")
            for name, v in rows:
                v = int(v) if isinstance(v, bool) else v
                lines.append(f'{fam}{{replica="{name}"}} {v}')
        for tname, row in sorted(snap["tenants"].items()):
            lbl = f'tenant="{tname}"'
            lines.append("# TYPE ptc_fleet_tenant_slo_burn_rate gauge")
            lines.append(f"ptc_fleet_tenant_slo_burn_rate{{{lbl}}} "
                         f"{row['slo_burn_rate']:.9g}")
            lines.append("# TYPE ptc_fleet_tenant_tokens_per_second "
                         "gauge")
            lines.append(f"ptc_fleet_tenant_tokens_per_second{{{lbl}}} "
                         f"{row['agg_tokens_per_s']:.9g}")
            comp = row.get("counters", {}).get("completed")
            if comp is not None:
                lines.append(
                    "# TYPE ptc_fleet_tenant_completed_total counter")
                lines.append(
                    f"ptc_fleet_tenant_completed_total{{{lbl}}} {comp}")
        return lines

    # --------------------------------------------------------- lifecycle
    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:
                self._errors += 1

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.ctx is not None and \
                getattr(self.ctx, "_fleetview", None) is self:
            self.ctx._fleetview = None
