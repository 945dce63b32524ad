"""Always-on runtime metrics: unified registry, exporters, health watchdog.

Reference role: PaRSEC ships always-on instrumentation (the PINS counter
modules) and live counter streaming (tools/aggregator_visu) alongside its
offline .prof traces.  The trace module covers the offline half;
this module is the other half — the telemetry a serving stack assumes
exists before any QoS or admission-control work:

  MetricsRegistry   folds the native ptc_metrics histograms (per-class
                    EXEC duration, sampled release latency, h2d stall,
                    comm/coll rendezvous wait — log2 buckets with 8
                    linear sub-buckets per octave) with the counters
                    from Context.stats() into one namespaced model with
                    p50/p90/p99 estimates; exports Prometheus text
  MetricsExporter   stdlib http.server scrape endpoint
                    (PTC_MCA_runtime_metrics_port): /metrics prometheus
                    text, /stats.json raw counters, /healthz watchdog
  Watchdog          monitor thread (PTC_MCA_runtime_watchdog=<secs>):
                    stuck tasks (EXEC open past k*p99 per class),
                    starved workers, parked pulls not advancing, slow
                    ranks (fence-time clock-sync RTT outliers).  Every
                    detection emits a structured event into the metrics
                    stream and triggers a flight-recorder dump so the
                    incident leaves a post-mortem artifact.

The histograms are native and lock-free (native/core.cpp MetHist); this
module only snapshots and renders them — safe to call from any thread at
any frequency.

Port of parsec_tpu/profiling/metrics.py.  The watchdog's stalled-pull
check reads the comm engine's rendezvous, chunk and byte counters; its
slow-rank check reads the fence-time RTTs.
"""
from __future__ import annotations

import ctypes as C
import json
import os
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .. import _native as N

# bucket scheme constants (asserted against the native layout at import
# of the first registry — keep in sync with runtime_internal.h)
_SUBBITS = 3
_SUB = 1 << _SUBBITS
_MAX_OCT = 45
_BUCKETS = _SUB + (_MAX_OCT - _SUBBITS) * _SUB
_STRIDE = 4 + _BUCKETS

KIND_NAMES = N.MET_KIND_NAMES  # index == PTC_MET_* kind


def _check_layout():
    buf = (C.c_int64 * 4)()
    N.lib.ptc_metrics_layout(buf)
    assert buf[0] == len(KIND_NAMES) and buf[2] == _BUCKETS \
        and buf[3] == _SUBBITS, (
            "metrics bucket scheme drifted between native and Python: "
            f"native {list(buf)} vs python ({len(KIND_NAMES)}, -, "
            f"{_BUCKETS}, {_SUBBITS})")


def bucket_bounds(idx: int):
    """[lo, hi) nanosecond bounds of histogram bucket `idx`."""
    if idx < _SUB:
        return idx, idx + 1
    o = (idx - _SUB) // _SUB + _SUBBITS
    s = (idx - _SUB) % _SUB
    w = 1 << (o - _SUBBITS)
    lo = (1 << o) + s * w
    return lo, lo + w


class Hist:
    """One aggregated histogram record (kind, optional class name)."""

    __slots__ = ("kind", "mid", "name", "count", "sum_ns", "buckets")

    def __init__(self, kind, mid, name, count, sum_ns, buckets):
        self.kind = int(kind)
        self.mid = int(mid)
        self.name = name
        self.count = int(count)
        self.sum_ns = int(sum_ns)
        self.buckets = buckets  # np.int64[_BUCKETS]

    @property
    def kind_name(self) -> str:
        return KIND_NAMES[self.kind]

    @property
    def mean_ns(self) -> float:
        return self.sum_ns / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Estimated q-quantile in ns (linear interpolation inside the
        12.5%-wide bucket the rank lands in — <=~6% relative error)."""
        if self.count <= 0:
            return 0.0
        rank = q * self.count
        cum = 0
        for idx in range(_BUCKETS):
            c = int(self.buckets[idx])
            if c == 0:
                continue
            if cum + c >= rank:
                lo, hi = bucket_bounds(idx)
                frac = (rank - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        lo, hi = bucket_bounds(_BUCKETS - 1)
        return float(hi)

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum_ns": self.sum_ns,
            "mean_ns": round(self.mean_ns, 1),
            "p50_ns": round(self.quantile(0.50), 1),
            "p90_ns": round(self.quantile(0.90), 1),
            "p99_ns": round(self.quantile(0.99), 1),
        }


def snapshot_histograms(ctx, merged: bool = False) -> List[Hist]:
    """Decode ptc_metrics_snapshot into Hist records.  merged=True folds
    the fence-time peer snapshots (meaningful on rank 0)."""
    _check_layout()
    max_classes = 0
    buf4 = (C.c_int64 * 4)()
    N.lib.ptc_metrics_layout(buf4)
    max_classes = int(buf4[1])
    cap = (max_classes + len(KIND_NAMES) + 1) * _STRIDE
    buf = (C.c_int64 * cap)()
    n = N.lib.ptc_metrics_snapshot(ctx._ptr, buf, cap, 1 if merged else 0)
    arr = np.ctypeslib.as_array(buf, shape=(cap,))[:n].copy()
    out: List[Hist] = []
    name_buf = C.create_string_buffer(256)
    for off in range(0, int(n), _STRIDE):
        kind, mid, count, sum_ns = (int(arr[off]), int(arr[off + 1]),
                                    int(arr[off + 2]), int(arr[off + 3]))
        name = None
        if kind == N.MET_EXEC and mid >= 0:
            k = N.lib.ptc_metrics_class_name(ctx._ptr, mid, name_buf, 256)
            if k > 0:
                name = name_buf.value.decode(errors="replace")
        out.append(Hist(kind, mid, name, count, sum_ns,
                        arr[off + 4:off + 4 + _BUCKETS]))
    return out


def _flatten_counters(prefix: str, obj, out: Dict[str, float]):
    """Numeric leaves of a stats dict -> flat metric names.  Lists,
    strings and None are skipped (per-worker vectors export poorly as
    unlabelled scalars; the JSON endpoint carries them verbatim)."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = f"{prefix}_{k}" if prefix else str(k)
            _flatten_counters(key, v, out)
    elif isinstance(obj, bool):
        out[prefix] = 1 if obj else 0
    elif isinstance(obj, (int, float)):
        out[prefix] = obj


class MetricsRegistry:
    """Unified metrics model over one Context: native histograms +
    Context.stats() counters, rendered as a dict or Prometheus text."""

    def __init__(self, ctx):
        self.ctx = ctx
        _check_layout()

    # ------------------------------------------------------------ model
    def histograms(self, merged: bool = False) -> List[Hist]:
        return snapshot_histograms(self.ctx, merged=merged)

    def counters(self) -> Dict[str, float]:
        """Flattened numeric counters from the unified Context.stats()
        snapshot.  Ring-drop counts (trace_dropped_events) and comm
        stream `reaps` ride along — flight-recorder data loss and
        peer-loss cleanup are dashboard-visible, not trace-meta-only."""
        flat: Dict[str, float] = {}
        _flatten_counters("", self.ctx.stats(), flat)
        out = {}
        for k, v in flat.items():
            name = "ptc_" + k.strip("_").replace(".", "_")
            out[name] = v
        return out

    def snapshot(self, merged: bool = False) -> dict:
        """One namespaced model: histograms (per kind, EXEC per class)
        with quantile summaries + flattened counters."""
        hists: Dict[str, dict] = {k: {} for k in KIND_NAMES}
        for h in self.histograms(merged=merged):
            key = h.name if (h.kind == N.MET_EXEC and h.name) else "_"
            hists[h.kind_name][key] = h.summary()
        reg = getattr(self.ctx, "_scope_registry", None)
        try:
            scope_hists = reg.tenant_export() if reg is not None else {}
        except Exception:
            scope_hists = {}
        return {
            "t": time.time(),
            "rank": self.ctx.myrank,
            "merged": merged,
            "histograms": hists,
            "counters": self.counters(),
            # ptc-blackbox: per-tenant sparse-bucket export so a remote
            # FleetView federates /stats.json scrapes bit-identically
            # to in-process Server scrapes
            "scope_hists": scope_hists,
        }

    # ------------------------------------------------------- prometheus
    _HIST_FAMILY = {
        "exec": "ptc_task_exec_seconds",
        "release": "ptc_release_seconds",
        "h2d_stall": "ptc_h2d_stall_seconds",
        "comm_wait": "ptc_comm_wait_seconds",
        "coll_wait": "ptc_coll_wait_seconds",
    }

    def prometheus_text(self, merged: bool = False) -> str:
        """Prometheus exposition format: each histogram kind as a
        summary family (quantile labels + _sum/_count; EXEC labelled by
        class), each flattened counter as an untyped sample."""
        lines: List[str] = []
        by_kind: Dict[str, List[Hist]] = {}
        for h in self.histograms(merged=merged):
            by_kind.setdefault(h.kind_name, []).append(h)
        for kind, fam in self._HIST_FAMILY.items():
            hs = by_kind.get(kind)
            if not hs:
                continue
            lines.append(f"# HELP {fam} {kind} latency (ptc_metrics "
                         "log2-bucket histogram)")
            lines.append(f"# TYPE {fam} summary")
            for h in hs:
                lbl = ""
                if kind == "exec":
                    cls = (h.name or "_").replace('"', "'")
                    lbl = f'class="{cls}",'
                for q in (0.5, 0.9, 0.99):
                    v = h.quantile(q) / 1e9
                    lines.append(
                        f'{fam}{{{lbl}quantile="{q}"}} {v:.9g}')
                l2 = f"{{{lbl[:-1]}}}" if lbl else ""
                lines.append(f"{fam}_sum{l2} {h.sum_ns / 1e9:.9g}")
                lines.append(f"{fam}_count{l2} {h.count}")
        lines.extend(self._tenant_lines())
        for name, v in sorted(self.counters().items()):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {v:.9g}" if isinstance(v, float)
                         else f"{name} {v}")
        wd = getattr(self.ctx, "_watchdog", None)
        if wd is not None:
            lines.append("# TYPE ptc_watchdog_detections_total counter")
            lines.append(f"ptc_watchdog_detections_total {len(wd.events)}")
        fv = getattr(self.ctx, "_fleetview", None)
        if fv is not None:
            try:
                lines.extend(fv.prometheus_lines())
            except Exception:
                pass
        return "\n".join(lines) + "\n"


    # per-tenant SLO families (ptc-scope): the per-request metrics a
    # tenant dashboard alerts on, labelled tenant="..." — latencies in
    # seconds, tokens/s as-is
    _TENANT_FAMILIES = (
        ("ttft_ns", "ptc_tenant_ttft_seconds", 1e-9,
         "time to first token"),
        ("queue_wait_ns", "ptc_tenant_queue_wait_seconds", 1e-9,
         "submit -> admitted wait"),
        ("latency_ns", "ptc_tenant_request_seconds", 1e-9,
         "submit -> done latency"),
        ("tokens_per_s", "ptc_tenant_tokens_per_second", 1.0,
         "per-request decode rate"),
        ("spec_accept_pct", "ptc_tenant_spec_accept_percent", 1.0,
         "speculative-decode draft acceptance per verify wave"),
    )
    _TENANT_COUNTERS = ("submitted", "completed", "failed", "rejected",
                        "slo_violations", "prefix_hits", "prefix_misses",
                        "spec_proposed", "spec_accepted")
    # derived per-tenant rate gauges off the counters above
    # (ptc-share dashboards): (family, numerator, denominator keys)
    _TENANT_RATES = (
        ("ptc_tenant_prefix_hit_rate", "prefix_hits",
         ("prefix_hits", "prefix_misses"), "prefix-cache page hit rate"),
        ("ptc_tenant_spec_accept_rate", "spec_accepted",
         ("spec_proposed",), "speculative draft acceptance rate"),
    )

    def _tenant_lines(self) -> List[str]:
        """Tenant-dimensioned exposition from the ScopeRegistry (empty
        when no serve stack is attached)."""
        reg = getattr(self.ctx, "_scope_registry", None)
        if reg is None:
            return []
        lines: List[str] = []
        try:
            with reg._lock:
                tenants = {name: ({k: t.hists[k] for k, _, _, _ in
                                   self._TENANT_FAMILIES},
                                  dict(t.counters))
                           for name, t in reg.tenants.items()}
            slo = reg.slo_status()
        except Exception:
            return []
        for key, fam, scale, help_ in self._TENANT_FAMILIES:
            rows = [(n, h[key]) for n, (h, _) in sorted(tenants.items())
                    if h[key].count > 0]
            if not rows:
                continue
            lines.append(f"# HELP {fam} {help_} (per tenant)")
            lines.append(f"# TYPE {fam} summary")
            for name, h in rows:
                lbl = f'tenant="{name}"'
                for q in (0.5, 0.9, 0.99):
                    lines.append(f'{fam}{{{lbl},quantile="{q}"}} '
                                 f"{h.quantile(q) * scale:.9g}")
                lines.append(f"{fam}_sum{{{lbl}}} {h.sum * scale:.9g}")
                lines.append(f"{fam}_count{{{lbl}}} {h.count}")
        for cname in self._TENANT_COUNTERS:
            fam = f"ptc_tenant_{cname}_total"
            rows = [(n, c.get(cname, 0))
                    for n, (_, c) in sorted(tenants.items())]
            if not any(v for _, v in rows):
                continue
            lines.append(f"# TYPE {fam} counter")
            for name, v in rows:
                lines.append(f'{fam}{{tenant="{name}"}} {v}')
        for fam, num, dens, help_ in self._TENANT_RATES:
            rows = []
            for name, (_, c) in sorted(tenants.items()):
                total = sum(c.get(k, 0) for k in dens)
                if total:
                    rows.append((name, c.get(num, 0) / total))
            if not rows:
                continue
            lines.append(f"# HELP {fam} {help_} (per tenant)")
            lines.append(f"# TYPE {fam} gauge")
            for name, v in rows:
                lines.append(f'{fam}{{tenant="{name}"}} {v:.9g}')
        for name, st in sorted(slo.items()):
            lines.append("# TYPE ptc_tenant_slo_burn_rate gauge")
            lines.append(f'ptc_tenant_slo_burn_rate{{tenant="{name}"}} '
                         f"{st['burn_rate']:.9g}")
        return lines


class MetricsExporter:
    """Scrape endpoint on `port` (PTC_MCA_runtime_metrics_port):
      GET /metrics     Prometheus text (the registry's summary render)
      GET /stats.json  raw Context.stats() + histogram summaries (JSON)
      GET /healthz     watchdog status (200 ok / 503 after detections)
    Runs a daemon ThreadingHTTPServer; stop() closes the socket.
    """

    def __init__(self, ctx, port: int, merged: bool = False):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.ctx = ctx
        self.registry = MetricsRegistry(ctx)
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # scrapes must not spam stderr
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    if self.path.startswith("/metrics"):
                        txt = exporter.registry.prometheus_text(
                            merged=exporter.merged)
                        self._send(200, "text/plain; version=0.0.4",
                                   txt.encode())
                    elif self.path.startswith("/stats.json"):
                        body = json.dumps(
                            exporter.registry.snapshot(
                                merged=exporter.merged),
                            default=str).encode()
                        self._send(200, "application/json", body)
                    elif self.path.startswith("/fleet.json"):
                        fv = getattr(exporter.ctx, "_fleetview", None)
                        if fv is None:
                            self._send(404, "text/plain",
                                       b"no fleet view attached\n")
                        else:
                            self._send(200, "application/json",
                                       json.dumps(fv.snapshot(),
                                                  default=str).encode())
                    elif self.path.startswith("/healthz"):
                        wd = getattr(exporter.ctx, "_watchdog", None)
                        st = wd.status() if wd is not None else {
                            "watchdog": "off"}
                        # tenant SLO burn (ptc-scope) degrades health
                        # exactly like a watchdog detection: a scraper
                        # needs ONE endpoint for "is this serving rank
                        # meeting its promises"
                        reg = getattr(exporter.ctx, "_scope_registry",
                                      None)
                        breached = False
                        if reg is not None:
                            try:
                                slo = reg.slo_status()
                                st = dict(st, slo=slo)
                                breached = any(v.get("breached")
                                               for v in slo.values())
                            except Exception:
                                pass
                        code = 503 if (st.get("detections") or breached) \
                            else 200
                        self._send(code, "application/json",
                                   json.dumps(st, default=str).encode())
                    else:
                        self._send(404, "text/plain", b"not found\n")
                except Exception as e:  # scrape must never kill the server
                    try:
                        self._send(500, "text/plain", repr(e).encode())
                    except Exception:
                        pass

        self.merged = merged
        self._srv = ThreadingHTTPServer(("127.0.0.1", int(port)), Handler)
        self.port = self._srv.server_address[1]  # resolved (port=0 ok)
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True,
                                        name="ptc-metrics-exporter")
        self._thread.start()

    def stop(self):
        try:
            self._srv.shutdown()
            self._srv.server_close()
        except Exception:
            pass


class Watchdog:
    """Health monitor thread.  Detections (each a structured event):

      stuck_task     an EXEC body open longer than the per-class
                     adaptive deadline max(k * p99(class), floor_s)
      starved_worker a worker whose selected-task count did not move
                     across `starve_ticks` ticks while the rest of the
                     context retired >= `starve_min_progress` tasks/tick
                     (advisory: no flight dump)
      slow_rank      rank 0 only: a peer's fence-time clock-sync RTT
                     > outlier_factor * the median peer RTT (and above
                     1 ms — loopback noise must not page anyone)

    Every non-advisory detection triggers a flight-recorder dump
    (tracing must be on for the dump to contain anything), so an
    incident always leaves a post-mortem artifact next to the event.
    Dump names carry a per-process run id + a generation seq
    (`<prefix>.watchdog.<run_id>.<rank>.<seq>.ptt`) so repeat
    detections never overwrite an earlier incident's artifact;
    `max_dumps` bounds the generations per run and the emitted event
    (and its journal record) references the exact path it wrote.
    """

    def __init__(self, ctx, interval: float, k: float = 8.0,
                 floor_s: float = 30.0, min_count: int = 20,
                 starve_ticks: int = 3, starve_min_progress: int = 100,
                 outlier_factor: float = 4.0, max_dumps: int = 4):
        self.ctx = ctx
        self.interval = float(interval)
        self.k = float(k)
        self.floor_ns = int(float(floor_s) * 1e9)
        self.min_count = int(min_count)
        self.starve_ticks = int(starve_ticks)
        self.starve_min_progress = int(starve_min_progress)
        self.outlier_factor = float(outlier_factor)
        self.max_dumps = int(max_dumps)
        self.events: List[dict] = []
        self.ticks = 0
        self._dumps = 0
        # per-process run id: repeat runs against the same dump prefix
        # (or repeat detections within one) can never collide on names
        self._run_id = f"{os.getpid():x}-{int(time.time()) & 0xffffff:x}"
        self._reported = set()  # dedup key per incident
        self._prev_exec: Optional[list] = None
        self._starve_count: Dict[int, int] = {}
        self._prev_pull = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ptc-watchdog")
        self._thread.start()

    # ------------------------------------------------------------ events
    def _emit(self, ev: dict, dump: bool = True):
        ev = dict(ev, t=round(time.time(), 3), rank=self.ctx.myrank,
                  source="watchdog")
        key = (ev["type"], ev.get("key"))
        if key in self._reported:
            return
        self._reported.add(key)
        self.events.append(ev)
        sys.stderr.write("ptc-watchdog: " + json.dumps(ev) + "\n")
        for mon in list(getattr(self.ctx, "_monitors", [])):
            emit = getattr(mon, "emit", None)
            if emit is not None:
                try:
                    emit(dict(ev, event=ev["type"]))
                except Exception:
                    pass
        # ptc-pilot interrupt path: a stuck task or slow rank is acted
        # on IMMEDIATELY — the controller closes its observation window
        # and re-evaluates now rather than waiting out control.window
        # more pools
        if ev["type"] in ("stuck_task", "slow_rank"):
            ctrl = getattr(self.ctx, "_controller", None)
            if ctrl is not None:
                try:
                    ctrl.interrupt(ev["type"], key=str(ev.get("key")))
                except Exception:
                    pass
        if dump and self._dumps < self.max_dumps:
            try:
                if self.ctx.profile_level() > 0:
                    from ..utils import params as _mca
                    prefix = (_mca.get("runtime.trace_dump")
                              or os.path.join(tempfile.gettempdir(),
                                              "ptc_flight"))
                    path = (f"{prefix}.watchdog.{self._run_id}."
                            f"{self.ctx.myrank}.{self._dumps}.ptt")
                    self.ctx.flight_dump(path)
                    self._dumps += 1
                    ev["flight_dump"] = path
                    sys.stderr.write(
                        f"ptc-watchdog: flight-recorder dump -> {path}\n")
            except Exception as e:
                sys.stderr.write(f"ptc-watchdog: flight dump failed "
                                 f"({e!r})\n")
        # ptc-blackbox: every detection is a durable journal record that
        # references the dump it corresponds to (after the dump attempt,
        # so flight_dump rides along when one was written)
        jr = getattr(self.ctx, "_journal", None)
        if jr is not None:
            try:
                # the detection's own "type" rides as `kind` so it
                # cannot clobber the journal envelope's record type
                jr.record("watchdog",
                          **{("kind" if k == "type" else k): v
                             for k, v in ev.items()})
            except Exception:
                pass

    # -------------------------------------------------------- detections
    def _exec_p99(self) -> Dict[int, float]:
        out: Dict[int, float] = {}
        for h in snapshot_histograms(self.ctx):
            if h.kind == N.MET_EXEC and h.mid >= 0 and \
                    h.count >= self.min_count:
                out[h.mid] = h.quantile(0.99)
        return out

    def _class_name(self, mid: int) -> str:
        buf = C.create_string_buffer(256)
        k = N.lib.ptc_metrics_class_name(self.ctx._ptr, mid, buf, 256)
        return buf.value.decode(errors="replace") if k > 0 else f"#{mid}"

    def _scope_owner(self, scope: int) -> dict:
        """Name the victim request of a scoped detection: tenant + rid
        from the ScopeRegistry's legend (empty for unscoped work)."""
        if not scope:
            return {}
        out = {"scope_id": int(scope)}
        reg = getattr(self.ctx, "_scope_registry", None)
        if reg is not None:
            try:
                with reg._lock:
                    r = reg.requests.get(int(scope))
                if r is not None:
                    out["tenant"] = r.tenant
                    if r.rid is not None:
                        out["rid"] = r.rid
            except Exception:
                pass
        return out

    def _live_requests(self, cap: int = 8) -> list:
        """The in-flight requests at detection time (for detections —
        stalled pull, starved worker — with no single owning task):
        the flight dump then still names candidate victims."""
        reg = getattr(self.ctx, "_scope_registry", None)
        if reg is None:
            return []
        out = []
        try:
            with reg._lock:
                for sid, r in reg.requests.items():
                    if r.kind == "request" and r.state in ("submitted",
                                                           "running"):
                        out.append({"scope_id": sid, "tenant": r.tenant,
                                    "rid": r.rid})
                        if len(out) >= cap:
                            break
        except Exception:
            pass
        return out

    def _check_stuck(self, now_ns: int):
        cap = 4 * (self.ctx.nb_workers + 2)
        buf = (C.c_int64 * cap)()
        n = N.lib.ptc_metrics_inflight(self.ctx._ptr, buf, cap)
        if n <= 0:
            return
        p99 = self._exec_p99()
        for i in range(0, int(n), 4):
            worker, mid, begin, scope = (buf[i], buf[i + 1], buf[i + 2],
                                         buf[i + 3])
            open_ns = now_ns - begin
            deadline = max(self.k * p99.get(mid, 0.0), self.floor_ns)
            if open_ns > deadline:
                self._emit(dict({
                    "type": "stuck_task",
                    "key": (worker, begin),
                    "task_class": self._class_name(mid),
                    "worker": int(worker),
                    "open_ms": round(open_ns / 1e6, 1),
                    "deadline_ms": round(deadline / 1e6, 1),
                    "class_p99_ms": round(p99.get(mid, 0.0) / 1e6, 3),
                }, **self._scope_owner(scope)))

    def _check_starved(self):
        ex = self.ctx.worker_stats()
        prev = self._prev_exec
        self._prev_exec = ex
        if prev is None or len(prev) != len(ex) or len(ex) < 2:
            return
        deltas = [b - a for a, b in zip(prev, ex)]
        total = sum(deltas)
        if total < self.starve_min_progress:
            self._starve_count.clear()
            return
        for w, d in enumerate(deltas):
            if d == 0:
                self._starve_count[w] = self._starve_count.get(w, 0) + 1
                if self._starve_count[w] >= self.starve_ticks:
                    self._emit({
                        "type": "starved_worker",
                        "key": w,
                        "worker": w,
                        "ticks": self._starve_count[w],
                        "others_progress": total,
                        "live_requests": self._live_requests(),
                    }, dump=False)
            else:
                self._starve_count[w] = 0

    def _check_stalled_pull(self):
        """A pull parked across two ticks with no chunk and no byte
        received in between: the rendezvous is not advancing."""
        if not self.ctx.comm_enabled:
            return
        rdv = self.ctx.comm_rdv_stats()
        tuning = self.ctx.comm_tuning()
        cur = (rdv["pending_pulls"], tuning["chunks_recv"],
               self.ctx.comm_stats()["bytes_recv"])
        prev = self._prev_pull
        self._prev_pull = cur
        if prev is None:
            return
        if cur[0] > 0 and prev[0] > 0 and cur[1] == prev[1] and \
                cur[2] == prev[2]:
            self._emit({
                "type": "stalled_pull",
                "key": cur[1],
                "pending_pulls": int(cur[0]),
                "stalled_for_s": round(self.interval, 3),
                "live_requests": self._live_requests(),
            })

    def _check_slow_ranks(self):
        ctx = self.ctx
        if not ctx.comm_enabled or ctx.myrank != 0 or ctx.nodes < 3:
            return
        rtts = ctx.metrics_peer_rtts()
        peers = [(r, v) for r, v in enumerate(rtts) if r != 0 and v > 0]
        if len(peers) < 2:
            return
        vals = sorted(v for _, v in peers)
        median = vals[len(vals) // 2]
        for r, v in peers:
            if v > max(self.outlier_factor * median, 1_000_000):
                self._emit({
                    "type": "slow_rank",
                    "key": r,
                    "peer_rank": r,
                    "rtt_ms": round(v / 1e6, 3),
                    "median_rtt_ms": round(median / 1e6, 3),
                }, dump=False)

    def _check_slo_burn(self):
        """Tenant SLO burn (ptc-scope): a tenant whose sliding-window
        violation rate reached its burn threshold gets a structured
        event (advisory: the flight dump stays armed for harder
        incidents, /healthz already turns 503)."""
        reg = getattr(self.ctx, "_scope_registry", None)
        if reg is None:
            return
        try:
            status = reg.slo_status()
        except Exception:
            return
        for tenant, st in status.items():
            if st.get("breached"):
                self._emit({
                    "type": "slo_burn",
                    "key": (tenant, st["violations"]),
                    "tenant": tenant,
                    "slo_ms": st["slo_ms"],
                    "burn_rate": st["burn_rate"],
                    "window_n": st["window_n"],
                }, dump=False)

    # --------------------------------------------------------------- run
    def _tick(self):
        self.ticks += 1
        self._check_stuck(_native_now())
        self._check_starved()
        self._check_stalled_pull()
        self._check_slow_ranks()
        self._check_slo_burn()

    def _loop(self):
        warned = False
        while not self._stop.wait(self.interval):
            if getattr(self.ctx, "_destroyed", False):
                return
            try:
                self._tick()
            except Exception as e:
                if not warned:
                    warned = True
                    sys.stderr.write(f"ptc-watchdog: tick failed ({e!r}); "
                                     "will keep trying\n")

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def status(self) -> dict:
        return {
            "watchdog": "on",
            "interval_s": self.interval,
            "ticks": self.ticks,
            "detections": len(self.events),
            "events": self.events[-16:],
        }


def _native_now() -> int:
    """Clock base for comparing against the native inflight begin_ns
    stamps: the runtime's OWN ptc_now_ns (exported as ptc_clock_ns) —
    its TSC fast path drifts from CLOCK_MONOTONIC over long processes,
    so time.monotonic_ns would skew open-duration estimates by
    milliseconds after minutes of uptime."""
    return int(N.lib.ptc_clock_ns())


def enable_from_param(ctx, secs) -> Optional[Watchdog]:
    """`PTC_MCA_runtime_watchdog=<seconds>` hook (Context.__init__)."""
    try:
        iv = float(secs)
    except (TypeError, ValueError):
        sys.stderr.write(f"ptc-watchdog: runtime.watchdog={secs!r} is not "
                         "a number of seconds; watchdog disabled\n")
        return None
    if iv <= 0:
        return None
    from ..utils import params as _mca
    return Watchdog(
        ctx, iv,
        k=_mca.get("runtime.watchdog_k"),
        floor_s=_mca.get("runtime.watchdog_floor_s"),
    )
