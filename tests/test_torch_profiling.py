"""The port's observability layer (parsec_tpu_torch.profiling: pins,
metrics with its exporter and watchdog, live, blackbox, the conformance
record and request timeline of scope; utils.faults) and the serving
stack's hooks into it, held against parsec_tpu on the same runs.

Each case runs the same scenario on both packages and compares what is
deterministic exactly: PINS task counts per class, histogram sample
counts (and, on one recorded buffer, the decoded records and every
quantile), Prometheus lines with their values masked, journal record
types and sequence numbers, watchdog events, the live sampler's keys,
the serving stack's conformance coverage and its plans.  Durations are
never compared between the two runs: a timing check is a property that
holds on any run (a histogram's quantile against the exact one of a
trace of the same run, within the bucket the estimate picks, widened by
the nanoseconds by which the histogram's bracket exceeds the trace's).
Device runs: the port's CudaDevice(ctx, device="cpu") against the
reference's TpuDevice on JAX's CPU platform, with the reference's wave
compiler off (device.wave_fuse=0, the port's dispatch).

Mirrors the one-rank cases of tests/profiling/test_pins.py,
test_live.py, test_metrics.py, test_watchdog.py and test_blackbox.py,
tests/serve/test_scope.py, test_serve_watchdog.py and
tests/utils/test_faults.py."""
import glob
import json
import math
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import parsec_tpu as jpt
import parsec_tpu.profiling as jprof
import parsec_tpu.profiling.blackbox as jbb
import parsec_tpu.profiling.live as jlive
import parsec_tpu.profiling.metrics as jmet
import parsec_tpu.profiling.pins as jpins
import parsec_tpu.serve as jserve
import parsec_tpu.utils as jutils
import parsec_tpu.utils.faults as jfaults
import parsec_tpu_torch as tpt
import parsec_tpu_torch.profiling as tprof
import parsec_tpu_torch.profiling.blackbox as tbb
import parsec_tpu_torch.profiling.live as tlive
import parsec_tpu_torch.profiling.metrics as tmet
import parsec_tpu_torch.profiling.pins as tpins
import parsec_tpu_torch.serve as tserve
import parsec_tpu_torch.utils as tutils
import parsec_tpu_torch.utils.faults as tfaults
from parsec_tpu.device import TpuDevice
from parsec_tpu_torch.device import CudaDevice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = SimpleNamespace(
    name="ref", pt=jpt, prof=jprof, pins=jpins, met=jmet, live=jlive,
    bb=jbb, serve=jserve, faults=jfaults, mca=jutils.params, N=jpt._native,
    device=lambda ctx, **kw: TpuDevice(ctx, jax_device=jax.devices()[0],
                                       **kw),
    model=lambda cfg: jserve.PagedLM(jserve.PagedLMConfig(**cfg)))
PORT = SimpleNamespace(
    name="port", pt=tpt, prof=tprof, pins=tpins, met=tmet, live=tlive,
    bb=tbb, serve=tserve, faults=tfaults, mca=tutils.params,
    N=tpt._native,
    device=lambda ctx, **kw: CudaDevice(ctx, device="cpu", **kw),
    model=lambda cfg: tserve.PagedLM(tserve.PagedLMConfig(**cfg),
                                     device="cpu"))


@pytest.fixture(autouse=True)
def _quiet_host(monkeypatch):
    """The reference's wave compiler off (the port's dispatch), and torch
    on one CPU thread: the suite's files run in parallel processes."""
    monkeypatch.setenv("PTC_MCA_device_wave_fuse", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(scenario, *args):
    return scenario(REF, *args), scenario(PORT, *args)


def _chain(P, ctx, nb, name="Task", body=None, arena="int"):
    """An RW chain of nb tasks."""
    pt = P.pt
    ctx.register_arena(arena, 8)
    tp = pt.Taskpool(ctx, globals={"NB": nb - 1})
    k = pt.L("k")
    tc = tp.task_class(name)
    tc.param("k", 0, pt.G("NB"))
    tc.flow("A", "RW",
            pt.In(None, guard=(k == 0)),
            pt.In(pt.Ref(name, k - 1, flow="A")),
            pt.Out(pt.Ref(name, k + 1, flow="A"), guard=(k < pt.G("NB"))),
            arena=arena)
    tc.body(body or (lambda v: None))
    return tp


def _run(tp):
    tp.run()
    tp.wait()
    return tp


def _dev_pool(P, ctx, nb=8, dev_kw=None):
    """nb independent device tasks, each adding 1 to its own 4-float
    tile; returns (device, pool, array)."""
    pt = P.pt
    arr = np.zeros((nb, 4), dtype=np.float32)
    ctx.register_linear_collection("A", arr, elem_size=16, nodes=1,
                                   myrank=0)
    ctx.register_arena("t", 16)
    dev = P.device(ctx, **(dev_kw or {}))
    tp = pt.Taskpool(ctx, globals={"NB": nb - 1})
    k = pt.L("k")
    tc = tp.task_class("T")
    tc.param("k", 0, pt.G("NB"))
    tc.flow("A", "RW", pt.In(pt.Mem("A", k)), pt.Out(pt.Mem("A", k)),
            arena="t")
    dev.attach(tc, tp, kernel=lambda x: x + 1.0, reads=["A"],
               writes=["A"], shapes={"A": (4,)})
    return dev, tp, arr


# ------------------------------------------------------------------ PINS
def test_pins_counter_and_profiler_without_tracing():
    """Modules see every EXEC event with tracing off; a chain that is
    uninstalled sees no more; the same counts on both packages."""
    def run(P):
        with P.pt.Context(nb_workers=2) as ctx:
            chain = P.pins.enable_pins(ctx, P.pins.TaskCounter(),
                                       P.pins.TaskProfiler())
            _run(_chain(P, ctx, 24))
            traced = ctx.profile_take().shape[0]
            seen = chain["task_counter"].total
            chain.uninstall()
            _run(_chain(P, ctx, 5, arena="int2"))
            st = chain["task_profiler"].stats[0]
            return (traced, chain["task_counter"].counts, seen,
                    chain["task_counter"].total, st["count"],
                    0 <= st["min_ns"] <= st["max_ns"] <= st["total_ns"])
    ref, port = both(run)
    assert port == ref == (0, {0: 24}, 24, 24, 24, True)


def test_pins_mca_param_and_unknown_module(monkeypatch):
    monkeypatch.setenv("PTC_MCA_runtime_pins", "task_counter,comm_volume")

    def run(P):
        with P.pt.Context(nb_workers=1) as ctx:
            _run(_chain(P, ctx, 10))
            names = [m.name for m in ctx._pins_chain.modules]
            total = ctx._pins_chain["task_counter"].total
        monkeypatch.delenv("PTC_MCA_runtime_pins")
        with P.pt.Context(nb_workers=1) as ctx:
            try:
                P.pins.enable_pins(ctx, "no_such_module")
            except KeyError as e:
                err = str(e)
        monkeypatch.setenv("PTC_MCA_runtime_pins",
                           "task_counter,comm_volume")
        return names, total, err
    ref, port = both(run)
    assert port == ref
    assert port[:2] == (["task_counter", "comm_volume"], 10)
    assert "no_such_module" in port[2]
    assert sorted(tpins.REGISTRY) == sorted(jpins.REGISTRY)


def test_pins_hwcounters_and_straggler_log():
    """The papi-analog module samples every task of a busy class with
    its thread's rusage; the straggler log keeps the k slowest."""
    def run(P):
        with P.pt.Context(nb_workers=2) as ctx:
            hw, sl = P.pins.HwCounters(), P.pins.StragglerLog(k=4)
            P.pins.enable_pins(ctx, hw, sl)
            tp = P.pt.Taskpool(ctx, globals={"NB": 199})
            tc = tp.task_class("Busy")
            tc.param("k", 0, P.pt.G("NB"))

            def body(view):
                x = 0
                for i in range(4000):
                    x += i * i
            tc.body(body)
            _run(tp)
            ctx._pins_chain.uninstall()
        c = hw.counters[0]
        return (list(hw.counters), c[0], c[1] + c[2] > 0,
                hw.report({0: "Busy"}).split(" utime")[0],
                len(sl.slowest), [r[1] for r in sl.slowest],
                sl.slowest == sorted(sl.slowest, reverse=True))
    ref, port = both(run)
    assert port == ref == ([0], 200, True, "Busy: tasks=200", 4,
                           [0, 0, 0, 0], True)


def test_pins_device_activity_matches_device_stats(monkeypatch):
    """DeviceActivity over a device pool with tracing off: a wave per
    launch, a lane per task, its stall sum equal to the device's
    h2d_stall_ns and its lane-split bytes equal to the device's h2d and
    prefetch bytes, on both packages; the same lanes and bytes."""
    monkeypatch.setenv("PTC_MCA_device_prefetch", "0")
    nb = 8

    def run(P):
        with P.pt.Context(nb_workers=2) as ctx:
            chain = P.pins.enable_pins(ctx, "device_activity", "task_counter")
            dev, tp, arr = _dev_pool(P, ctx, nb)
            _run(tp)
            dev.flush()
            dev.stop()
            st = dict(dev.stats)
            traced = ctx.profile_take().shape[0]
            out = arr.copy()
        m = chain["device_activity"]
        return dict(traced=traced, lanes=m.lanes, waves=m.waves,
                    stall=m.stall_ns == st["h2d_stall_ns"],
                    h2d=m.h2d_bytes, dev_h2d=st["h2d_bytes"],
                    launches=st["batches"] + st["tasks"]
                    - st["batched_tasks"],
                    tasks=chain["task_counter"].total, out=out.tolist())
    ref, port = both(run)
    assert port["lanes"] == ref["lanes"] == nb
    assert port["traced"] == ref["traced"] == 0
    assert port["stall"] and ref["stall"]
    assert port["waves"] == port["launches"]
    assert sum(port["h2d"]) == port["dev_h2d"] == sum(ref["h2d"]) \
        == nb * 16
    # device tasks emit no EXEC span (TaskCounter sees none), as on the
    # reference
    assert port["tasks"] == ref["tasks"] == 0
    assert port["out"] == ref["out"] == [[1.0] * 4] * nb


# -------------------------------------------------------------- metrics
def _diamond_gemm(P, ctx, nb, tiles, tile=48):
    """The reference metrics test's diamond (A -> B, C -> D) plus GEMM
    chain with numpy bodies, in one pool."""
    pt = P.pt
    ctx.register_arena("t", 8)
    rng = np.random.default_rng(3)
    work = [rng.random((tile, tile), dtype=np.float32) for _ in range(2)]
    tp = pt.Taskpool(ctx, globals={"NB": nb - 1, "NT": tiles - 1})
    k = pt.L("k")

    def sleepy(base_us):
        def body(view):
            time.sleep((base_us + 37 * (view["k"] % 7)) / 1e6)
        return body

    a = tp.task_class("DiaA")
    a.param("k", 0, pt.G("NB"))
    a.flow("X", "RW", pt.In(None), pt.Out(pt.Ref("DiaB", k, flow="X")),
           pt.Out(pt.Ref("DiaC", k, flow="X")), arena="t")
    a.body(sleepy(300))
    b = tp.task_class("DiaB")
    b.param("k", 0, pt.G("NB"))
    b.flow("X", "RW", pt.In(pt.Ref("DiaA", k, flow="X")),
           pt.Out(pt.Ref("DiaD", k, flow="X")), arena="t")
    b.body(sleepy(700))
    c = tp.task_class("DiaC")
    c.param("k", 0, pt.G("NB"))
    c.flow("X", "RW", pt.In(pt.Ref("DiaA", k, flow="X")),
           pt.Out(pt.Ref("DiaD", k, flow="Y")), arena="t")
    c.body(sleepy(150))
    d = tp.task_class("DiaD")
    d.param("k", 0, pt.G("NB"))
    d.flow("X", "READ", pt.In(pt.Ref("DiaB", k, flow="X")))
    d.flow("Y", "READ", pt.In(pt.Ref("DiaC", k, flow="X")))
    d.body(sleepy(450))
    g = tp.task_class("GEMM")
    g.param("k", 0, pt.G("NT"))
    g.flow("A", "RW", pt.In(None, guard=(k == 0)),
           pt.In(pt.Ref("GEMM", k - 1, flow="A")),
           pt.Out(pt.Ref("GEMM", k + 1, flow="A"),
                  guard=(k < pt.G("NT"))), arena="t")

    def gemm_body(view):
        acc = work[0]
        for _ in range(2 + view["k"] % 5):
            acc = acc @ work[1]
    g.body(gemm_body)
    _run(tp)
    return {tc.id: tc.name for tc in tp.classes}


def _picked_bucket(h, q):
    """The bucket Hist.quantile interpolates in, and the 1-based rank
    of the sample that lands there."""
    rank = q * h.count
    cum = 0
    for idx in range(tmet._BUCKETS):
        c = int(h.buckets[idx])
        if c and cum + c >= rank:
            return idx, max(1, math.ceil(rank))
        cum += c
    raise AssertionError("rank past the last bucket")


def test_exec_quantiles_against_the_trace_of_the_same_run():
    """The port's always-on EXEC histograms against a level-2 trace of
    the same diamond + GEMM run, by a property that holds on any run:
    each class's sample count equals its span count, and the exact
    quantile (the trace's sample of the estimate's rank) falls in the
    bucket the estimate picks, widened below by the histogram's total
    bracket excess (each sample brackets its span, so no order
    statistic moves more than the summed excess).  The reference's
    snapshot decoder and Hist read the same buffers to the same
    records and quantiles."""
    with tpt.Context(nb_workers=2) as ctx:
        ctx.profile_enable(2)
        names = _diamond_gemm(PORT, ctx, nb=120, tiles=120)
        trace = tprof.take_trace(ctx)
        exact = {}
        for (_, _, key, cid, *_rest, b, e) in trace.spans():
            if key == tprof.KEY_EXEC:
                exact.setdefault(names[cid], []).append(e - b)
        port = {h.name: h for h in tmet.snapshot_histograms(ctx)
                if h.kind == tpt._native.MET_EXEC and h.name}
        ref = {h.name: h for h in jmet.snapshot_histograms(ctx)
               if h.kind == jpt._native.MET_EXEC and h.name}
    assert sorted(exact) == sorted(port) == sorted(ref)
    for name, durs in exact.items():
        h, r = port[name], ref[name]
        durs = np.sort(np.array(durs, dtype=np.int64))
        assert h.count == r.count == len(durs), name
        assert h.sum_ns == r.sum_ns >= int(durs.sum()), name
        np.testing.assert_array_equal(h.buckets, r.buckets)
        rh = jmet.Hist(r.kind, r.mid, r.name, r.count, r.sum_ns,
                       h.buckets)
        slack = h.sum_ns - int(durs.sum())
        for q in (0.5, 0.9, 0.99):
            assert h.quantile(q) == r.quantile(q) == rh.quantile(q)
            idx, j = _picked_bucket(h, q)
            lo, hi = tmet.bucket_bounds(idx)
            assert lo - slack <= durs[j - 1] < hi, (name, q, lo, hi)


def test_histograms_at_level_zero_and_disable_knob():
    def run(P):
        with P.pt.Context(nb_workers=1) as ctx:
            level = ctx.profile_level()
            _diamond_gemm(P, ctx, nb=4, tiles=6)
            counts = {h.name: h.count for h in P.met.snapshot_histograms(ctx)
                      if h.kind == P.N.MET_EXEC and h.name}
            rel = [h.count > 0 for h in P.met.snapshot_histograms(ctx)
                   if h.kind == P.N.MET_RELEASE]
        with P.pt.Context(nb_workers=1) as ctx:
            ctx.metrics_enable(False)
            off = ctx.metrics_enabled
            _diamond_gemm(P, ctx, nb=2, tiles=4)
            empty = P.met.snapshot_histograms(ctx)
        return level, counts, rel, off, empty
    ref, port = both(run)
    assert port == ref
    assert port[1] == {"DiaA": 4, "DiaB": 4, "DiaC": 4, "DiaD": 4,
                       "GEMM": 6}
    assert port[2] == [True] and port[4] == []


def test_bucket_scheme_and_synthetic_quantiles_match_reference():
    assert tmet.KIND_NAMES == jmet.KIND_NAMES
    assert tmet._BUCKETS == jmet._BUCKETS
    assert [tmet.bucket_bounds(i) for i in range(tmet._BUCKETS)] == \
        [jmet.bucket_bounds(i) for i in range(jmet._BUCKETS)]
    rng = np.random.default_rng(7)
    vals = (10 ** rng.uniform(3, 7, size=5000)).astype(np.int64)
    lows = np.array([tmet.bucket_bounds(i)[0]
                     for i in range(tmet._BUCKETS)])
    buckets = np.bincount(np.searchsorted(lows, vals, side="right") - 1,
                          minlength=tmet._BUCKETS).astype(np.int64)
    th = tmet.Hist(0, 0, "syn", len(vals), int(vals.sum()), buckets)
    jh = jmet.Hist(0, 0, "syn", len(vals), int(vals.sum()), buckets)
    for q in (0.5, 0.9, 0.99):
        assert th.quantile(q) == jh.quantile(q)
        ex = float(np.quantile(vals, q))
        assert abs(th.quantile(q) - ex) <= 0.10 * ex
    assert th.summary() == jh.summary()


def test_metrics_record_external_kind():
    def run(P):
        with P.pt.Context(nb_workers=1) as ctx:
            for v in (123456, 234567):
                P.N.lib.ptc_metrics_record(ctx._ptr, P.N.MET_H2D_STALL,
                                           -1, v)
            (h,) = [x for x in P.met.snapshot_histograms(ctx)
                    if x.kind == P.N.MET_H2D_STALL]
            return h.count, h.sum_ns, h.quantile(0.5)
    ref, port = both(run)
    assert port == ref
    assert port[:2] == (2, 123456 + 234567)


def test_h2d_stall_histogram_matches_device_stats(monkeypatch):
    """The repair: every dispatch-time h2d stall of the CUDA device joins
    the native h2d_stall histogram, as the reference's device records
    its stalls — count equal to the reference's on the same pool, sum
    equal to the device's h2d_stall_ns."""
    monkeypatch.setenv("PTC_MCA_device_prefetch", "0")

    def run(P):
        with P.pt.Context(nb_workers=2) as ctx:
            dev, tp, _ = _dev_pool(P, ctx, 8)
            _run(tp)
            dev.flush()
            dev.stop()
            hs = [h for h in ctx.metrics_histograms()
                  if h.kind == P.N.MET_H2D_STALL]
            return (hs[0].count if hs else 0, hs[0].sum_ns if hs else 0,
                    dev.stats["h2d_stall_ns"])
    ref, port = both(run)
    assert port[0] == ref[0] == 8
    assert port[1] == port[2] > 0 and ref[1] == ref[2]


def _prom_keys(text):
    """Prometheus sample lines with their values masked, comments
    dropped."""
    return sorted(line.rsplit(" ", 1)[0] for line in text.splitlines()
                  if line and not line.startswith("#"))


# lines of the reference the port may lack: the comm engine's and the
# collectives' counters, the trace clock sync, the device plan check,
# and the reference's wave-fusion and streamed-serve device keys
_REF_ONLY = re.compile(r"^ptc_(comm|coll|plan)_|^ptc_trace_clock_|"
                       r"^ptc_device_(fuse|stream|dp|wave|chain|plan)")
# device_stats() counters the port's aggregate carries beyond the
# reference's (the device module's own stats keys, summed, and the wave
# compiler's certificate cache counters)
_PORT_ONLY = re.compile(r"^ptc_device_(tasks|batches|batched_tasks|"
                        r"d2h_bytes|dead_drops|eager_gathers|f64_refused|"
                        r"fused_flows|invalidations|wb_tasks|"
                        r"fuse_cert_hits|fuse_cert_misses)$")


def test_prometheus_lines_match_reference():
    """The registry's Prometheus text after the same run, values masked:
    the two packages write the same lines but the namespaces the port
    has not ported (reference only) and the device counters its
    device_stats() adds (port only); the JSON snapshot has the same five
    histogram kinds."""
    def run(P):
        with P.pt.Context(nb_workers=1) as ctx:
            _diamond_gemm(P, ctx, nb=3, tiles=4)
            reg = ctx.metrics_registry()
            snap = reg.snapshot()
            json.dumps(snap)
            return _prom_keys(reg.prometheus_text()), \
                sorted(snap["histograms"]), sorted(reg.counters())
    ref, port = both(run)
    extra = set(port[0]) - set(ref[0])
    assert extra and all(_PORT_ONLY.match(k) for k in extra), sorted(extra)
    missing = set(ref[0]) - set(port[0])
    assert all(_REF_ONLY.match(k) for k in missing), sorted(missing)
    assert 'ptc_task_exec_seconds{class="GEMM",quantile="0.99"}' in port[0]
    assert port[1] == ref[1] == ["coll_wait", "comm_wait", "exec",
                                 "h2d_stall", "release"]
    assert "ptc_trace_dropped_events" in port[2]


def test_exporter_endpoints():
    """/metrics, /stats.json, /healthz and /fleet.json of the port's
    exporter on an ephemeral localhost port."""
    with tpt.Context(nb_workers=1) as ctx:
        _diamond_gemm(PORT, ctx, nb=3, tiles=4)
        exp = tmet.MetricsExporter(ctx, 0)
        try:
            base = f"http://127.0.0.1:{exp.port}"
            body = urllib.request.urlopen(base + "/metrics",
                                          timeout=10).read().decode()
            assert 'class="GEMM"' in body
            doc = json.loads(urllib.request.urlopen(
                base + "/stats.json", timeout=10).read())
            assert "histograms" in doc and "counters" in doc
            assert urllib.request.urlopen(base + "/healthz",
                                          timeout=10).status == 200
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(base + "/fleet.json", timeout=5)
            assert ei.value.code == 404
            fv = tbb.FleetView(ctx=ctx, servers=[], start=False)
            fv.scrape_once()
            snap = json.loads(urllib.request.urlopen(
                base + "/fleet.json", timeout=5).read())
            assert snap["enabled"] and snap["replicas"] == []
            text = urllib.request.urlopen(base + "/metrics",
                                          timeout=5).read().decode()
            assert "ptc_fleet_replicas 0" in text
            fv.stop()
            assert ctx.stats()["metrics"]["exporter_port"] == 0
        finally:
            exp.stop()


def test_unified_stats_namespaces():
    """stats() carries the reference's namespaces, the comm engine's
    (comm, coll) included, with the same keys in each (plan and the
    trace's clock included)."""
    def run(P):
        with P.pt.Context(nb_workers=1) as ctx:
            s = ctx.stats()
            return {k: sorted(v) if isinstance(v, dict) else v
                    for k, v in s.items() if k != "device"}
    ref, port = both(run)
    assert set(ref) == set(port)
    for k in port:
        assert port[k] == ref[k], k


def test_context_rank_identity_from_the_native_core():
    with tpt.Context(nb_workers=1) as ctx:
        assert (ctx.myrank, ctx.nodes, ctx.comm_enabled) == (0, 1, False)
        assert ctx.comm_enabled is bool(
            tpt._native.lib.ptc_comm_enabled(ctx._ptr))
        assert ctx.metrics_peer_rtts() == [0]
        assert ctx.metrics_inflight() == []


# -------------------------------------------------------------- watchdog
def test_stuck_task_detection_and_flight_dump(tmp_path):
    """A delay-injected body trips the k*p99 deadline: the event names
    the class and rank, and a loadable flight-recorder dump lands."""
    def run(P):
        P.mca.set("runtime.trace_dump", str(tmp_path / f"wd_{P.name}"))
        try:
            with P.pt.Context(nb_workers=2) as ctx:
                ctx.profile_enable(1)
                ctx.profile_ring(1 << 16)
                wd = P.met.Watchdog(ctx, interval=0.1, k=8.0, floor_s=0.8,
                                    min_count=10)
                ctx._watchdog = wd
                inj = P.faults.FaultInjector(mode="delay",
                                             at_invocation=60,
                                             delay_s=1.6)
                _run(_chain(P, ctx, 80, "Victim",
                            inj.wrap(lambda v: time.sleep(0.002))))
                stuck = [e for e in wd.events if e["type"] == "stuck_task"]
                wd.stop()
                ev = stuck[0]
                tr = P.prof.Trace.load(ev["flight_dump"])
                return (ev["task_class"], ev["rank"], ev["open_ms"] >= 800,
                        inj.injected, len(tr.events) > 0,
                        ctx.stats()["metrics"]["watchdog"]["detections"])
        finally:
            P.mca.unset("runtime.trace_dump")
    ref, port = both(run)
    assert port == ref == ("Victim", 0, True, 1, True, 1)


def test_watchdog_quiet_run_param_and_live_stream(tmp_path, monkeypatch):
    """No false positive on a healthy run; runtime.watchdog installs it
    with its status in stats(); a detection joins the live stream."""
    def run(P):
        with P.pt.Context(nb_workers=2) as ctx:
            wd = P.met.Watchdog(ctx, interval=0.05)
            _run(_chain(P, ctx, 120, "Healthy",
                        lambda v: time.sleep(0.001)))
            time.sleep(0.2)
            quiet = (wd.events, wd.ticks > 0)
            wd.stop()
        monkeypatch.setenv("PTC_MCA_runtime_watchdog", "0.25")
        with P.pt.Context(nb_workers=1) as ctx:
            st = dict(ctx.stats()["metrics"]["watchdog"])
        monkeypatch.delenv("PTC_MCA_runtime_watchdog")
        path = tmp_path / f"live_{P.name}.jsonl"
        with P.pt.Context(nb_workers=1) as ctx:
            mon = P.live.LiveMonitor(ctx, path=str(path), interval=30.0)
            wd = P.met.Watchdog(ctx, interval=30.0)
            wd._emit({"type": "stuck_task", "key": "synthetic",
                      "task_class": "X"}, dump=False)
            mon.stop()
            wd.stop()
        evs = [json.loads(x) for x in open(path)]
        evs = [(r["event"], r["task_class"]) for r in evs
               if r.get("event")]
        return quiet, (st["watchdog"], st["interval_s"],
                       st["detections"]), evs
    ref, port = both(run)
    assert port == ref == (([], True), ("on", 0.25, 0),
                           [("stuck_task", "X")])


def test_fault_injector_modes():
    """utils.faults on both packages: DISABLE falls back for every task,
    NEXT skips one task, an error aborts the pool and leaves the context
    usable, a delay still runs the body; the env helpers are the
    reference's."""
    def chain(P, ctx, nb, inj_body, fallback=None):
        tp = _chain(P, ctx, nb + 1, body=inj_body,
                    arena=f"t{len(ctx.arenas)}")
        if fallback is not None:
            tp.classes[0].body(fallback)
        return tp

    def run(P):
        out = {}
        with P.pt.Context(nb_workers=1) as ctx:
            inj = P.faults.FaultInjector("disable")
            fb = []
            _run(chain(P, ctx, 10, inj.wrap(lambda v: None),
                       lambda v: fb.append(v["k"])))
            out["disable"] = (sorted(fb), inj.executed)
            inj = P.faults.FaultInjector("next", at_invocation=3)
            prim, fb = [], []
            _run(chain(P, ctx, 10, inj.wrap(lambda v: prim.append(v["k"])),
                       lambda v: fb.append(v["k"])))
            out["next"] = (len(prim), len(fb))
            inj = P.faults.FaultInjector("error", at_invocation=5)
            tp = chain(P, ctx, 10, inj.wrap(lambda v: None))
            tp.run()
            try:
                tp.wait()
            except RuntimeError as e:
                out["error"] = "abort" in str(e)
            done = []
            _run(chain(P, ctx, 5, lambda v: done.append(v["k"])))
            out["after"] = sorted(done)
        inj = P.faults.FaultInjector(mode="delay", at_invocation=2,
                                     delay_s=0.01)
        calls = []
        fn = inj.wrap(lambda v: calls.append(v))
        for i in range(4):
            fn(i)
        out["delay"] = (inj.injected, inj.executed, calls)
        out["env"] = P.faults.comm_fault_env(delay_us=5, recv_max=7,
                                             delay_map={1: 3, 0: 2})
        return out
    ref, port = both(run)
    assert port == ref
    assert port["disable"] == (list(range(11)), 0)
    assert port["next"] == (10, 1) and port["error"]
    assert port["after"] == list(range(6))
    assert port["delay"] == (1, 3, [0, 1, 2, 3])


# ------------------------------------------------------------------ live
def test_live_monitor_samples_latest_rotation(tmp_path):
    def run(P):
        path = str(tmp_path / (P.name + "_{rank}.jsonl"))
        with P.pt.Context(nb_workers=2) as ctx:
            mon = P.live.LiveMonitor(ctx, path=path, interval=0.05)
            tp = P.pt.Taskpool(ctx, globals={"NB": 2000})
            tc = tp.task_class("T")
            tc.param("k", 0, P.pt.G("NB"))
            tc.body_noop()
            _run(tp)
            mon.stop()
        recs = [json.loads(x) for x in open(path.format(rank=0))]
        last = recs[-1]
        with P.pt.Context(nb_workers=1) as ctx:
            mon = P.live.LiveMonitor(ctx, path=path + ".b", interval=30.0)
            first = mon.latest()
            tp = P.pt.Taskpool(ctx, globals={"NB": 30})
            tc = tp.task_class("LiveCls")
            tc.param("k", 0, P.pt.G("NB"))
            tc.body(lambda v: time.sleep(0.001))
            _run(tp)
            mon._sample()
            lat = mon.latest()
            mon.stop()
        rot = path + ".r"
        with P.pt.Context(nb_workers=1) as ctx:
            mon = P.live.LiveMonitor(ctx, path=rot, interval=30.0,
                                     max_bytes=2000)
            for i in range(80):
                mon.emit({"event": "filler", "i": i, "pad": "x" * 100})
            mon.stop()
        gens = [rot.format(rank=0) + ".1", rot.format(rank=0)]
        sizes = [os.path.getsize(g) <= 2000 for g in gens]
        idx = [json.loads(line)["i"] for g in gens for line in open(g)
               if '"filler"' in line]
        return (last["rank"], sum(last["workers"]), last["maxrss_kb"] > 0,
                sorted(last), first, sorted(lat), lat["latency"]["LiveCls"]
                [0], sizes, idx == list(range(idx[0], 80)))
    ref, port = both(run)
    assert port == ref
    assert port[:3] == (0, 2001, True) and port[4] is None
    assert port[6] == 31 and port[7] == [True, True] and port[8]


def test_live_monitor_via_mca_param(tmp_path, monkeypatch):
    """runtime.live installs one monitor that samples the pool; the
    port's default sink is under TMPDIR.  The reference's hook takes no
    path and its default sink is a fixed file under /tmp, so its half
    runs with that default moved under tmp_path."""
    monkeypatch.setenv("PTC_MCA_runtime_live", "0.05")
    monkeypatch.setenv("TMPDIR", str(tmp_path / "port"))
    os.mkdir(tmp_path / "port")
    init = jlive.LiveMonitor.__init__
    monkeypatch.setattr(init, "__defaults__",
                        (str(tmp_path / "ref_{rank}.jsonl"),)
                        + init.__defaults__[1:])

    def run(P):
        with P.pt.Context(nb_workers=1) as ctx:
            tp = P.pt.Taskpool(ctx, globals={"NB": 50})
            tc = tp.task_class("T")
            tc.param("k", 0, P.pt.G("NB"))
            tc.body_noop()
            _run(tp)
            mons = list(ctx._monitors)
        recs = [json.loads(x) for x in open(mons[0].path)]
        return len(mons), sum(recs[-1]["workers"]), mons[0].path
    import tempfile
    tempfile.tempdir = None  # re-read TMPDIR
    try:
        ref, port = both(run)
    finally:
        tempfile.tempdir = None
    assert port[:2] == ref[:2] == (1, 51)
    assert port[2] == str(tmp_path / "port" / "ptc_live_0.jsonl")
    assert ref[2] == str(tmp_path / "ref_0.jsonl")


def test_live_sample_device_rows(tmp_path):
    """A sample over a device pool carries the device rows (tasks, cache
    occupancy, queue depth) and the pipeline's counters, the reference's
    keys; the port's cache row reads the live occupancy (the
    reference's reads a stats key its device never sets)."""
    def run(P):
        path = str(tmp_path / (P.name + "_{rank}.jsonl"))
        with P.pt.Context(nb_workers=2) as ctx:
            mon = P.live.LiveMonitor(ctx, path=path, interval=5.0)
            dev, tp, _ = _dev_pool(P, ctx, 8)
            _run(tp)
            mon._sample()
            dev.flush()
            mon.stop()
            dev.stop()
        recs = [json.loads(x) for x in open(path.format(rank=0))]
        first = recs[0]
        return (sorted(first), sorted(first["device"]),
                first["dev0_tasks"], first["dev0_cache_bytes"],
                "stream" in first)
    ref, port = both(run)
    assert port[:3] == ref[:3]
    assert port[2] == 8 and not port[4] and not ref[4]
    assert ref[3] == 0 and port[3] == 8 * 16


# -------------------------------------------------------------- blackbox
def _journal(path):
    return [json.loads(x) for x in open(path) if x.strip()]


def test_journal_schema_rotation_overflow(tmp_path):
    def run(P):
        d = tmp_path / P.name
        with P.pt.Context(nb_workers=1) as ctx:
            jr = P.bb.Journal(ctx, dirpath=str(d / "a"), start=False,
                              arm_crash=False)
            jr.record("serve", op="admit", tenant="a", scope_id=7)
            jr.record("fence", epoch=1)
            jr.flush(fsync=True)
            jr.stop()
            jr = P.bb.Journal(ctx, dirpath=str(d / "b"), max_bytes=2048,
                              start=False, arm_crash=False)
            for i in range(100):
                jr.record("serve", op="admit", tenant="t", scope_id=i)
            jr.flush(fsync=True)
            jr.stop()
            jr = P.bb.Journal(ctx, dirpath=str(d / "c"), start=False,
                              arm_crash=False)
            for i in range(P.bb.Journal._PENDING_CAP + 50):
                jr.record("serve", op="admit", scope_id=i)
            dropped = jr.stats()["dropped"]
            jr.stop()
        a = _journal(d / "a" / "journal.0.jsonl")
        cur, old = d / "b" / "journal.0.jsonl", d / "b" / "journal.0.jsonl.1"
        recs = _journal(old) + _journal(cur)
        seqs = [r["seq"] for r in recs if r["type"] == "serve"]
        return ([(r["type"], r["v"], r["rank"], r["seq"]) for r in a],
                a[1]["op"], a[1]["scope_id"],
                os.path.getsize(cur) <= 2048 and os.path.getsize(old) <= 2048,
                seqs == sorted(seqs), seqs[-1], dropped >= 50)
    ref, port = both(run)
    assert port == ref
    assert [t for t, *_ in port[0]] == ["journal_open", "serve", "fence",
                                        "journal_close"]
    assert port[3:] == (True, True, 101, True)


def test_journal_fsync_cadence_durable_without_stop(tmp_path):
    with tpt.Context(nb_workers=1) as ctx:
        jr = tbb.Journal(ctx, dirpath=str(tmp_path), fsync_s=0.05,
                         checkpoint_s=0.1, arm_crash=False)
        jr.register_inventory("frozen_page_keys", lambda: ["k1", "k2"])
        jr.record("serve", op="admit", tenant="a", scope_id=1)
        path = tmp_path / "journal.0.jsonl"
        deadline = time.time() + 10
        while time.time() < deadline:
            if path.exists() and jr.stats()["fsyncs"] >= 1 and \
                    jr.stats()["checkpoints"] >= 1 and any(
                        r["type"] == "checkpoint" for r in _journal(path)):
                break
            time.sleep(0.02)
        st = jr.stats()
        recs = _journal(path)
        jr.stop()
    assert st["enabled"] and st["fsyncs"] >= 1 and st["lost_peers"] == []
    assert any(r["type"] == "serve" for r in recs)
    (ck, *_) = [r for r in recs if r["type"] == "checkpoint"]
    inv = ck["inventory"]
    assert inv["rank"] == 0 and inv["frozen_page_keys"] == ["k1", "k2"]
    # the reference's inventory: the comm clock offsets included
    assert set(inv) == {"rank", "live_scopes", "qos_pools", "inflight",
                        "clock", "frozen_page_keys"}


def _serve_pool(P, ctx, n=4, body=None):
    """A pool builder for Server.submit: an RW chain of n tasks with a
    no-op body (or `body`)."""
    def make(priority, weight):
        pt = P.pt
        tp = ctx.taskpool(globals={"N": n - 1}, priority=priority,
                          weight=weight)
        tc = tp.task_class("C")
        tc.param("k", 0, pt.G("N"))
        tc.flow("X", "RW", pt.In(None, guard=(pt.L("k") == 0)),
                pt.In(pt.Ref("C", pt.L("k") - 1, flow="X")),
                pt.Out(pt.Ref("C", pt.L("k") + 1, flow="X"),
                       guard=(pt.L("k") < pt.G("N"))), arena="t")
        if body is None:
            tc.body_noop()
        else:
            tc.body(body)
        return tp
    return make


def test_serve_ops_and_fleet_view_journalled(tmp_path):
    """The server's admission decisions and the fleet view's snapshots
    land in the journal; the fleet view merges two in-process replicas
    and exports ptc_fleet_* lines; the same records on both packages."""
    def run(P):
        d = tmp_path / P.name
        with P.pt.Context(nb_workers=1, scheduler="lws") as ctx:
            jr = P.bb.Journal(ctx, dirpath=str(d), start=False,
                              arm_crash=False)
            ctx.register_arena("t", 8)
            srvs = [P.serve.Server(ctx, [P.serve.TenantConfig("a")],
                                   name=f"r{i}") for i in range(2)]
            for s in srvs:
                s.submit("a", _serve_pool(P, ctx))
                assert s.drain(timeout=30)
            fv = P.bb.FleetView(ctx=ctx, servers=srvs, journal=jr,
                                start=False)
            before = ctx.stats()["fleet"]
            snap = fv.scrape_once()
            after = ctx.stats()["fleet"]["healthy_replicas"]
            lines = "\n".join(fv.prometheus_lines())
            fv.stop()
            for s in srvs:
                s.close()
            jr.flush(fsync=True)
            jr.stop()
        recs = _journal(d / "journal.0.jsonl")
        return (before, after, snap["healthy_replicas"],
                # both replicas export the context's one scope registry
                snap["tenants"]["a"]["counters"]["completed"],
                [r["name"] for r in snap["replicas"]],
                "ptc_fleet_replicas 2" in lines,
                'ptc_fleet_replica_healthy{replica="r0"} 1' in lines,
                [(r["op"], r["server"]) for r in recs
                 if r["type"] == "serve"],
                [r["replicas"] for r in recs if r["type"] == "fleet"])
    ref, port = both(run)
    assert port == ref
    assert port[0] == {"enabled": False} and port[1:4] == (2, 2, 4)
    assert ("admit", "r0") in port[7] and ("done", "r1") in port[7]


def test_watchdog_dump_names_never_collide(tmp_path, monkeypatch):
    def run(P):
        prefix = str(tmp_path / f"{P.name}_wd")
        monkeypatch.setenv("PTC_MCA_runtime_trace_dump", prefix)
        with P.pt.Context(nb_workers=1) as ctx:
            ctx.profile_enable(1)
            jr = P.bb.Journal(ctx, dirpath=str(tmp_path / P.name),
                              start=False, arm_crash=False)
            wd = P.met.Watchdog(ctx, interval=3600.0, max_dumps=4)
            wd._emit({"type": "stuck_task", "key": "a"})
            wd._emit({"type": "stuck_task", "key": "b"})
            dumps = sorted(glob.glob(prefix + ".watchdog.*.ptt"))
            named = all(f".{wd._run_id}.0." in x for x in dumps)
            evs = [e["flight_dump"] for e in wd.events]
            wd.stop()
            jr.flush(fsync=True)
            jr.stop()
        recs = [r["flight_dump"] for r in
                _journal(tmp_path / P.name / "journal.0.jsonl")
                if r["type"] == "watchdog"]
        return len(dumps), named, evs == dumps, recs == dumps
    ref, port = both(run)
    assert port == ref == (2, True, True, True)


def test_crash_dump_now_without_signal(tmp_path):
    def run(P):
        d = tmp_path / P.name
        with P.pt.Context(nb_workers=1) as ctx:
            ctx.profile_enable(1)
            jr = P.bb.Journal(ctx, dirpath=str(d), start=False)
            rcs = [P.N.lib.ptc_crash_dump_now(ctx._ptr),
                   P.N.lib.ptc_crash_dump_now(ctx._ptr)]
            jr.stop()
            rcs.append(P.N.lib.ptc_crash_dump_now(ctx._ptr))
        t = P.prof.Trace.load(str(d / "crash.0.ptt"))
        return rcs, t.meta["crash"], t.meta["flight"], t.rank
    ref, port = both(run)
    assert port == ref == ([0, 1, -1], 1, 1, 0)


CRASH_CHILD = r"""
import os, signal, sys, threading, time
import parsec_tpu_torch as pt
from parsec_tpu_torch.profiling import Journal

d = sys.argv[1]
ctx = pt.Context(nb_workers=1)
ctx.profile_enable(1)
jr = Journal(ctx, dirpath=d, fsync_s=0.05, checkpoint_s=30.0)
gate = threading.Event()
ctx.register_arena("t", 8)
tp = pt.Taskpool(ctx, globals={"NB": 0})
tc = tp.task_class("Blocked")
tc.param("k", 0, pt.G("NB"))
tc.flow("X", "RW", pt.In(None, guard=(pt.L("k") == 0)), arena="t")
tc.body(lambda v: gate.wait(30))
tp.run()
deadline = time.time() + 20
while not ctx.metrics_inflight() and time.time() < deadline:
    time.sleep(0.01)
assert ctx.metrics_inflight(), "task never started"
jr.record("about_to_crash", pid=os.getpid(),
          jax=any(m == "jax" or m.startswith("parsec_tpu.")
                  for m in sys.modules))
jr.flush(fsync=True)
os.kill(os.getpid(), signal.SIGSEGV)
time.sleep(30)
"""


def test_crash_dump_on_fatal_signal(tmp_path):
    """SIGSEGV mid-run in a process that imports only the port: the
    native handler the port's journal arms writes the flight ring and
    the inflight snapshot to crash.0.ptt, the process still dies by the
    signal, and the journal's fsynced tail survives."""
    child = tmp_path / "crash_child.py"
    child.write_text(CRASH_CHILD)
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, str(child), str(tmp_path)],
                       env=env, cwd=REPO, timeout=120,
                       capture_output=True, text=True)
    assert p.returncode == -signal.SIGSEGV, (p.returncode, p.stderr)
    t = tprof.Trace.load(str(tmp_path / "crash.0.ptt"))
    assert t.meta["crash"] == 1
    inflight = t.events[t.events[:, 0] == tprof.KEY_INFLIGHT]
    assert len(inflight) >= 2 and (inflight[:, 1] == 0).any()
    recs = _journal(tmp_path / "journal.0.jsonl")
    (last,) = [r for r in recs if r["type"] == "about_to_crash"]
    assert last["jax"] is False
    assert not any(r["type"] == "journal_close" for r in recs)


# ----------------------------------------------------------------- scope
LM = {"vocab": 32, "d": 8, "page": 4, "seed": 3}


def _engine(P, ctx, slo_ms=None, **kw):
    T = P.serve.TenantConfig
    return P.serve.InferenceEngine(
        ctx, P.model(LM), n_pages=32, max_seqs=8,
        tenants=[T("hi", priority=2, weight=2, slo_ms=slo_ms),
                 T("lo", slo_ms=slo_ms)], **kw)


def test_request_timeline_partitions_latency():
    """With tracing on, every completed request's timeline stages sum
    exactly to its end-to-end latency, its waves name paged-attention
    classes and decode scopes list it as a member; filter_scope keeps one
    request's events; the same stage keys, wave classes and tokens on
    both packages."""
    def run(P):
        with P.pt.Context(nb_workers=2, scheduler="lws") as ctx:
            ctx.profile_enable(1)
            eng = _engine(P, ctx)
            hs = [eng.submit([1, 2, 3, 4, 5, 6], 4, "hi"),
                  eng.submit([2, 3, 4], 3, "lo"),
                  eng.submit([5, 6, 7, 8], 2, "hi")]
            eng.run(timeout_s=120)
            tr = P.prof.take_trace(ctx)
            reg = ctx.scope_registry()
            out = []
            for h in hs:
                tl = reg.request_timeline(tr, h.rid)
                out.append((h.state, h.tokens, sorted(tl["stages"]),
                            tl["stages_sum_ns"] == tl["e2e_ns"],
                            tl["stages"]["exec_ns"] > 0,
                            abs(tl["e2e_ns"] - h.latency_s * 1e9) < 50e6,
                            sorted({w["class"] for w in tl["waves"]}),
                            tl["ttft_ms"] > 0,
                            len(reg.request_scopes(h.rid)) > 1))
            sub = tr.filter_scope(hs[0].scope_id)
            ex = sub.events[sub.events[:, 0] == P.prof.KEY_EXEC]
            iso = (set(np.unique(ex[:, 6])) == {hs[0].scope_id},
                   hs[1].scope_id not in sub.scope_ids(),
                   tr.meta["scopes"][str(hs[0].scope_id)]["rid"]
                   == hs[0].rid)
            stl = reg.scope_timeline(tr, hs[0].scope_id)
            eng.close()
            return out, iso, sorted(stl["stages"])
    ref, port = both(run)
    assert port == ref
    for row in port[0]:
        assert row[0] == "done" and all(row[3:6]) and row[7] and row[8]
        assert set(row[6]) <= {"PFILL", "PATTF", "PATTL", "PUPD"}
    assert port[1] == (True, True, True)


def test_tenant_slo_prometheus_healthz_and_watchdog():
    """An impossible SLO burns: tenant-labelled lines in the Prometheus
    text, /healthz 503, Server.healthy() false, and the watchdog's
    slo_burn event — the same lines (values masked) on both packages."""
    def run(P):
        with P.pt.Context(nb_workers=2, scheduler="lws") as ctx:
            eng = _engine(P, ctx, slo_ms=0.0001)
            exp = P.met.MetricsExporter(ctx, port=0)
            ctx._metrics_exporter = exp
            hs = [eng.submit([1, 2, 3], 2, "hi"),
                  eng.submit([3, 2, 1], 2, "lo")]
            eng.run(timeout_s=120)
            txt = ctx.metrics_registry().prometheus_text()
            tenant = [k for k in _prom_keys(txt) if "tenant=" in k]
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{exp.port}/healthz", timeout=5)
                code = 200
            except urllib.error.HTTPError as e:
                code = e.code
                body = json.loads(e.read().decode())
            wd = P.met.Watchdog(ctx, interval=30.0)
            ctx._watchdog = wd
            wd._tick()
            burns = sorted((e["tenant"], e["burn_rate"])
                           for e in wd.events if e["type"] == "slo_burn")
            healthy = eng.server.healthy()
            adv = eng.server.advertise()
            wd.stop()
            exp.stop()
            ctx._metrics_exporter = None
            eng.close()
            return ([h.state for h in hs], tenant,
                    'ptc_tenant_slo_burn_rate{tenant="hi"} 1' in txt,
                    code, body["slo"]["hi"]["breached"], burns, healthy,
                    sorted(adv), adv["slo_burn_rate"],
                    adv["prefix"]["n"])
    ref, port = both(run)
    assert port == ref
    assert port[0] == ["done", "done"] and port[2]
    assert port[3] == 503 and port[4] is True
    assert port[5] == [("hi", 1.0), ("lo", 1.0)] and port[6] is False


def test_conformance_coverage_one_and_plans_match_reference():
    """Conformance on by default: every serve pool (prefill through the
    server, decode through the engine) is planned — coverage 1.0 — and
    the per-class calibration rows name the same classes; the plans of
    one decode pool are the same on both packages."""
    def run(P):
        with P.pt.Context(nb_workers=2, scheduler="lws") as ctx:
            eng = _engine(P, ctx)
            assert eng.conformance and eng.server.conformance
            hs = [eng.submit([1, 2, 3, 4, 5], 3, "hi"),
                  eng.submit([2, 3, 4], 3, "lo")]
            eng.run(timeout_s=120)
            conf = ctx.stats()["scope"]["conformance"]
            out = ([h.tokens for h in hs], conf["pools"] > 0,
                   conf["coverage"], conf["makespan"]["n"] > 0,
                   conf["makespan"]["ratio_min"] > 0,
                   sorted(conf["per_class"]),
                   conf["comm_bytes"]["measured"],
                   conf["residency"]["predicted_sum"] > 0)
            eng.close()
            return out
    ref, port = both(run)
    assert port == ref
    assert port[2] == 1.0 and port[3] and port[4]
    assert port[6] is None and port[7]


def test_conformance_off_counts_pools_unplanned():
    def run(P):
        with P.pt.Context(nb_workers=2, scheduler="lws") as ctx:
            srv = P.serve.Server(ctx, [P.serve.TenantConfig("hi"),
                                       P.serve.TenantConfig("lo")],
                                 conformance=False)
            eng = _engine(P, ctx, server=srv, conformance=False)
            h = eng.submit([1, 2, 3, 4], 3, "hi")
            eng.run(timeout_s=120)
            conf = ctx.stats()["scope"]["conformance"]
            eng.close()
            srv.close()
            return h.tokens, conf["planned"], conf["coverage"]
    ref, port = both(run)
    assert port == ref
    assert port[1:] == (0, 0.0)


def test_unknown_byte_estimate_takes_the_plan_bound():
    """A submission with no byte estimate under a byte budget and no
    default: the server builds the pool, takes its plan's working-set
    bound, reuses the pool at admission, and rejects what the budget
    cannot queue (the pool built for the bound is destroyed) — the same
    estimates and verdicts on both packages."""
    import threading

    def run(P):
        T = P.serve.TenantConfig
        with P.pt.Context(nb_workers=2, scheduler="lws") as ctx:
            ctx.register_arena("t", 8)
            gate = threading.Event()
            built = []

            def make(priority, weight, body=None):
                tp = _serve_pool(P, ctx, 6, body)(priority, weight)
                built.append(tp)
                return tp

            def blocking(priority, weight):
                # holds tiny's one pool slot until t3 is decided
                return make(priority, weight, lambda v: gate.wait(30))
            srv = P.serve.Server(ctx, [T("big", max_pools=1,
                                         max_queued_bytes=1 << 20),
                                       T("tiny", max_pools=1,
                                         max_queued_bytes=4)])
            t1 = srv.submit("big", make, wait=True)
            t2 = srv.submit("tiny", blocking)
            t3 = srv.submit("tiny", make)
            gate.set()
            assert srv.drain(timeout=30)
            out = (t1.state, t1.est_bytes, t2.state, t2.est_bytes,
                   t3.state, t3.est_bytes, len(built),
                   srv.stats()["tenants"]["tiny"]["rejected"],
                   ctx.stats()["scope"]["conformance"]["coverage"])
            srv.close()
            return out
    ref, port = both(run)
    assert port == ref
    # the chain's one 8-byte datum is its whole working set
    assert port[:6] == ("done", 8, "done", 8, "rejected", 8)
    assert port[6:] == (3, 1, 1.0)


def test_watchdog_stuck_event_names_request():
    def run(P):
        with P.pt.Context(nb_workers=2) as ctx:
            reg = ctx.scope_registry()
            sid = reg.new_scope("acme", rid=7)
            wd = P.met.Watchdog(ctx, interval=0.05, k=8.0, floor_s=0.2,
                                min_count=1000)
            ctx._watchdog = wd
            ctx.register_arena("t_slow", 8)
            tp = P.pt.Taskpool(ctx, globals={"NB": 0})
            k = P.pt.L("k")
            tc = tp.task_class("SlowReq")
            tc.param("k", 0, P.pt.G("NB"))
            tc.flow("A", "RW", P.pt.In(None, guard=(k == 0)),
                    arena="t_slow")
            tc.body(lambda v: time.sleep(0.7))
            reg.stamp(tp, sid)
            _run(tp)
            ev = [e for e in wd.events if e["type"] == "stuck_task"][0]
            wd.stop()
            return ev["scope_id"] == sid, ev["tenant"], ev["rid"], \
                ev["task_class"]
    ref, port = both(run)
    assert port == ref == (True, "acme", 7, "SlowReq")


def test_stuck_decode_step_dumps_flight_recorder(tmp_path):
    """A delay-injected decode step trips the watchdog mid-serve: a
    stuck PATTL event and a loadable dump, and the delayed request still
    emits the oracle's tokens."""
    def run(P):
        P.mca.set("runtime.trace_dump", str(tmp_path / f"sf_{P.name}"))
        try:
            model = P.model({"vocab": 32, "d": 8, "page": 4, "seed": 5})
            inj = P.faults.FaultInjector(mode="delay", at_invocation=2,
                                         delay_s=1.2)
            with P.pt.Context(nb_workers=2, scheduler="lws") as ctx:
                ctx.profile_enable(1)
                ctx.profile_ring(1 << 16)
                wd = P.met.Watchdog(ctx, interval=0.05, k=8.0,
                                    floor_s=0.4)
                ctx._watchdog = wd
                eng = P.serve.InferenceEngine(
                    ctx, model, n_pages=16, max_seqs=4,
                    tenants=[P.serve.TenantConfig("t", priority=2)],
                    body_wrap=inj.wrap)
                h = eng.submit([3, 1, 4, 1, 5], 4, "t")
                eng.run(timeout_s=120)
                rt, _ = model.reference_generate([3, 1, 4, 1, 5], 4)
                ev = [e for e in wd.events if e["type"] == "stuck_task"]
                dumps = glob.glob(str(tmp_path / f"sf_{P.name}")
                                  + ".watchdog.*.ptt")
                loaded = len(P.prof.Trace.load(dumps[0]).events) > 0
                wd.stop()
                eng.close()
                return (h.state, h.tokens == rt, inj.injected,
                        ev[0]["task_class"], loaded)
        finally:
            P.mca.unset("runtime.trace_dump")
    ref, port = both(run)
    assert port == ref == ("done", True, 1, "PATTL", True)


def test_controller_bound_to_the_engine_polls_budgets():
    """A controller created before the engine binds to it; each reaped
    decode step polls it: per-tenant burn pressure reaches the server's
    admission pricing and the spec_k snapshot reaches stats()."""
    def run(P):
        with P.pt.Context(nb_workers=2, scheduler="lws") as ctx:
            ctrl = ctx.controller(clock=P.pt.analysis.control.SimClock())
            eng = _engine(P, ctx, slo_ms=0.0001)
            hs = [eng.submit([1, 2, 3], 3, "hi"),
                  eng.submit([3, 2, 1], 3, "lo")]
            eng.run(timeout_s=120)
            st = ctx.stats()["control"]
            out = ([h.tokens for h in hs], st["pressure"],
                   eng.server.admission_pressure(), st["spec_k"],
                   sorted({d["kind"] for d in ctrl.decision_log()}))
            eng.close()
            return out
    ref, port = both(run)
    assert port == ref
    assert port[1] == {"hi": 1.0, "lo": 1.0} == port[2]
    assert port[4] == ["control_budget", "control_pressure"]
