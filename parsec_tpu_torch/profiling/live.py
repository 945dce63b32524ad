"""Live metrics monitor — the minimal aggregator_visu analog.

Reference role: tools/aggregator_visu streams per-rank runtime counters
out of a running job for live display.  This package's form: a
sampler thread snapshots the context's counters (worker selected-task
counts, device queue depth / cache occupancy, comm volumes, rusage,
and the always-on latency histograms' per-class p50/p99) at a fixed
interval and appends one JSON line per sample to a sink — a file any
dashboard, `tail -f`, or pandas can consume live.  Enable per process
with `PTC_MCA_runtime_live=<interval_s>` or programmatically:

    mon = LiveMonitor(ctx, path="ptc_live_{rank}.jsonl", interval=1.0)
    ... run taskpools ...
    mon.latest()  # newest sample dict (None before the first)
    mon.stop()    # or it stops with the context

The sink is SIZE-CAPPED (runtime.live_max_bytes, default 64 MiB): when
it grows past the cap it rotates to `<path>.1` (one generation kept),
so a long serving run cannot grow its directory unboundedly.  Watchdog
detections are written into the same stream via `emit()` — one file
carries both the periodic samples and the structured incident events.

The sink path is formatted with the context's rank at FIRST SAMPLE (not
construction), so the env-installed monitor picks up set_rank() done by
comm bring-up.  On shared hosts point `path` somewhere private — the
default lives in the temporary directory for tail-ability.

Port of parsec_tpu/profiling/live.py.  With the comm engine up, a
sample carries the rank's `comm`, `stream` and `topo` rows, and a
context a fleet Router fronts carries the `fleet` row, under the
reference's keys.  `dev{i}_cache_bytes` is the device's live cache
occupancy; the default sink lies in tempfile.gettempdir() (TMPDIR),
where the reference's is /tmp.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from typing import Optional


class LiveMonitor:
    def __init__(self, ctx, path: Optional[str] = None,
                 interval: float = 1.0,
                 max_bytes: Optional[int] = None):
        from ..utils import params as _mca
        self.ctx = ctx
        if path is None:
            path = os.path.join(tempfile.gettempdir(),
                                "ptc_live_{rank}.jsonl")
        self._path_tmpl = path
        self.path: Optional[str] = None  # resolved at first sample
        self.interval = float(interval)
        self.max_bytes = (_mca.get("runtime.live_max_bytes")
                          if max_bytes is None else int(max_bytes))
        self._stop = threading.Event()
        self._t0 = time.time()
        self._fh = None
        self._written = 0  # bytes in the current sink generation
        self._last: Optional[dict] = None
        self._write_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ptc-live-monitor")
        self._thread.start()
        # registered for teardown in its OWN list — _devices is the
        # device-protocol fan-out (stage-in, coherence callbacks) and a
        # monitor must never be visible there
        ctx._monitors.append(self)

    def stop(self):
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            # a wedged sample owns the file handle: do not race it
            sys.stderr.write("ptc-live: sampler did not stop in 5s; "
                             "leaving its file handle open\n")
            return
        try:
            self._sample()  # final snapshot so short runs record something
        except Exception:
            pass
        finally:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def latest(self) -> Optional[dict]:
        """The newest sample record (None before the first sample) —
        the programmatic accessor dashboards-in-process use instead of
        re-parsing their own JSONL sink."""
        return self._last

    def emit(self, rec: dict):
        """Append an arbitrary record to the sink (thread-safe).  The
        watchdog routes its structured detection events here so one
        stream carries samples AND incidents."""
        with self._write_lock:
            self._write_locked(rec)

    def _ensure_sink_locked(self):
        if self._fh is None:
            self.path = self._path_tmpl.format(rank=self.ctx.myrank)
            self._fh = open(self.path, "a", buffering=1)
            try:
                self._written = os.fstat(self._fh.fileno()).st_size
            except OSError:
                self._written = 0

    def _write_locked(self, rec: dict):
        self._ensure_sink_locked()
        line = json.dumps(rec) + "\n"
        # size-capped rotation: never let one generation exceed the cap
        # (checked BEFORE the write, so a line lands whole in exactly
        # one generation — the rotation-boundary contract the test pins)
        if self.max_bytes > 0 and self._fh is not None and \
                self._written + len(line) > self.max_bytes and \
                self._written > 0:
            self._fh.close()
            self._fh = None
            try:
                os.replace(self.path, self.path + ".1")
            except OSError as e:
                sys.stderr.write(f"ptc-live: rotation failed ({e!r}); "
                                 "continuing in place\n")
            self._ensure_sink_locked()
        self._fh.write(line)
        self._written += len(line)

    def _sample(self):
        ctx = self.ctx
        rec = {
            "t": round(time.time() - self._t0, 3),
            "rank": ctx.myrank,
            "workers": ctx.worker_stats(),
            "steals": ctx.worker_steals(),
        }
        for i, dev in enumerate(ctx._devices):
            if not hasattr(dev, "stats"):
                continue
            s = dev.stats
            rec[f"dev{i}_tasks"] = s.get("tasks", 0)
            # the live occupancy (the reference reads a stats key its
            # device never sets, so its row is always 0)
            rec[f"dev{i}_cache_bytes"] = dev.info()["cache_bytes"]
            qid = getattr(dev, "qid", None)
            if qid is not None:
                rec[f"dev{i}_qdepth"] = ctx.device_queue_depth(qid)
        if ctx._devices:
            # device-pipeline counters: prefetch effectiveness +
            # stall/overlap evolution is what a live dashboard watches
            ds = ctx.device_stats()
            rec["device"] = {k: ds[k] for k in
                             ("prefetch_hits", "prefetch_misses",
                              "prefetch_staged", "h2d_stall_ns",
                              "prefetch_h2d_ns", "overlap_ratio",
                              "spills", "reserve_fails")}
        if ctx.comm_enabled:
            rec["comm"] = ctx.comm_stats()
            # streaming-pipeline counters: session count + the d2h/wire
            # overlap fraction, live
            ss = ctx.comm_stream_stats()
            rec["stream"] = {k: ss[k] for k in
                             ("sessions", "parked_gets",
                              "overlap_fraction")}
            # per-link-class wire split: compact rows — the ici/dcn byte
            # balance is the live signal that hierarchical collectives
            # and rank remaps keep bulk traffic off the inter-island
            # links
            try:
                ts = ctx.comm_topo_stats()
                rec["topo"] = {
                    "n_islands": ts["n_islands"],
                    "classes": {c: [row["bytes_sent"],
                                    row["msgs_sent"]]
                                for c, row in ts["classes"].items()
                                if row["msgs_sent"]
                                or row["bytes_sent"]}}
            except Exception:
                pass  # topo rows are best-effort in a live sample
        # always-on latency quantiles: per-class exec p50/p99 +
        # the per-kind p99s — the continuous-serving signal the offline
        # trace can't give.  Compact form: [count, p50_ns, p99_ns].
        if ctx.metrics_enabled:
            try:
                from . import metrics as _m
                lat = {}
                kinds = {}
                for h in _m.snapshot_histograms(ctx):
                    row = [h.count, round(h.quantile(0.5)),
                           round(h.quantile(0.99))]
                    if h.kind == 0 and h.name:  # MET_EXEC
                        lat[h.name] = row
                    elif h.kind != 0:
                        kinds[h.kind_name] = row
                if lat:
                    rec["latency"] = lat
                if kinds:
                    rec["latency_kinds"] = kinds
            except Exception:
                pass  # histograms are best-effort in a live sample
            rec["trace_dropped"] = ctx.profile_dropped()
        # serving rows (ptc-serve + ptc-scope): per-tenant occupancy,
        # TTFT/latency p99, tokens/s, SLO burn and the conformance
        # makespan ratio — the live tenant table tools/ptc_top.py draws
        servers = getattr(ctx, "_servers", None)
        if servers:
            try:
                sv = servers[-1].stats()
                rec["serve"] = {
                    name: {"active": row["active_pools"],
                           "queued": row["queue_depth"],
                           "rejected": row["rejected"]}
                    for name, row in sv["tenants"].items()}
            except Exception:
                pass
        # fleet rows: the Router registers on every replica context it
        # fronts; one stats() snapshot per sample feeds the per-replica
        # table (occupancy, pfx_hit, migrated bytes)
        routers = getattr(ctx, "_routers", None)
        if routers:
            try:
                rt = routers[-1].stats()
                rec["fleet"] = {"router": rt["router"],
                                "replicas": rt["replicas"]}
            except Exception:
                pass
        # ptc-pilot: the self-driving controller's decision snapshot
        # (drift, retunes, hot-swaps, budget shares, per-tenant spec_k)
        ctrl = getattr(ctx, "_controller", None)
        if ctrl is not None:
            try:
                rec["control"] = ctrl.stats()
            except Exception:
                pass
        reg = getattr(ctx, "_scope_registry", None)
        if reg is not None:
            try:
                sc = reg.stats()
                def _rate(row, num, *dens):
                    total = sum(row.get(k, 0) for k in dens)
                    return round(row.get(num, 0) / total, 3) \
                        if total else None

                rec["tenants"] = {
                    name: {"completed": row["completed"],
                           "ttft_p99_ms": round(
                               row["ttft_ns_p99"] / 1e6, 3),
                           "latency_p99_ms": round(
                               row["latency_ns_p99"] / 1e6, 3),
                           "tok_s_p50": row["tokens_per_s_p50"],
                           "slo_burn": (sc["slo"].get(name) or {}).get(
                               "burn_rate"),
                           # ptc-share: prefix-cache hit rate +
                           # speculative draft acceptance per tenant
                           "prefix_hit": _rate(row, "prefix_hits",
                                               "prefix_hits",
                                               "prefix_misses"),
                           "spec_acc": _rate(row, "spec_accepted",
                                             "spec_proposed"),
                           # ptc-shard: p99 stall waiting on the
                           # embedded tensor-parallel collective
                           "coll_wait_p99_ms": round(
                               row.get("coll_wait_ns_p99", 0) / 1e6, 3)}
                    for name, row in sc["tenants"].items()}
                conf = sc["conformance"]
                rec["conformance"] = {
                    "coverage": conf["coverage"],
                    "makespan_ratio_p50": conf["makespan"]["ratio_p50"],
                    "comm_sound": conf["comm_bytes"]["sound"],
                }
            except Exception:
                pass
        ru = ctx.rusage()
        rec["maxrss_kb"] = ru["maxrss_kb"]
        rec["utime_s"] = ru["utime_s"]
        self._last = rec
        with self._write_lock:
            self._write_locked(rec)

    def _loop(self):
        warned = False
        while not self._stop.wait(self.interval):
            if getattr(self.ctx, "_destroyed", False):
                return
            try:
                self._sample()
            except Exception as e:
                # transient errors (device mid-teardown, full disk) must
                # not silently end a multi-hour monitoring run
                if not warned:
                    warned = True
                    sys.stderr.write(f"ptc-live: sample failed ({e!r}); "
                                     "will keep trying\n")


def enable_from_param(ctx, value) -> Optional[LiveMonitor]:
    """`PTC_MCA_runtime_live=<seconds>` hook (Context.__init__)."""
    try:
        iv = float(value)
    except (TypeError, ValueError):
        sys.stderr.write(f"ptc-live: runtime.live={value!r} is not a "
                         "number of seconds; monitoring disabled\n")
        return None
    if iv <= 0:
        sys.stderr.write(f"ptc-live: runtime.live={value!r} must be a "
                         "positive interval; monitoring disabled\n")
        return None
    return LiveMonitor(ctx, interval=iv)
