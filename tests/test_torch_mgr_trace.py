"""The device manager's own time (parsec_tpu_torch/device/cuda.py): its
four counters (stats mgr_wait_ns, mgr_plan_ns, mgr_dispatch_ns,
mgr_complete_ns), the GC pause counters, the spans of the same
boundaries, the wall-clock anchors of a trace (Trace.to_wall) and
lost_time's manager row, on CudaDevice(ctx, device="cpu")."""
import gc
import time

import numpy as np
import pytest

import parsec_tpu_torch as tpt
import parsec_tpu_torch._native as N
import parsec_tpu_torch.profiling as tprof
from parsec_tpu_torch.algos import build_gemm
from parsec_tpu_torch.algos.potrf import build_potrf_panels
from parsec_tpu_torch.data import TwoDimBlockCyclic
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.dsl.dtd import DtdTaskpool
from parsec_tpu_torch.profiling import (KEY_DEVICE, KEY_DEVICE_COMPLETE,
                                        KEY_DEVICE_PLAN, KEY_DEVICE_WAIT,
                                        KEY_GC_PAUSE, KEY_H2D,
                                        KEY_H2D_AHEAD)

BUCKETS = ("mgr_wait_ns", "mgr_plan_ns", "mgr_dispatch_ns",
           "mgr_complete_ns")
KEY_OF = {"mgr_wait_ns": KEY_DEVICE_WAIT, "mgr_plan_ns": KEY_DEVICE_PLAN,
          "mgr_dispatch_ns": KEY_DEVICE,
          "mgr_complete_ns": KEY_DEVICE_COMPLETE}


def _colls(ctx, n, nb, rng, names="ABC"):
    out = []
    for name in names:
        c = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32)
        c.from_dense(rng.standard_normal((n, n)).astype(np.float32))
        c.register(ctx, name)
        out.append(c)
    return out


def k_gemm(a, b, c):
    return c + a @ b


def run_ptg_gemm(ctx, dev_kw=None, n=256, nb=32):
    """A PTG GEMM on a new device: (device, wall ns from before the
    device's start to after its stop)."""
    a, b, c = _colls(ctx, n, nb, np.random.default_rng(0))
    t0 = time.perf_counter_ns()
    dev = CudaDevice(ctx, device="cpu", **(dev_kw or {}))
    tp = build_gemm(ctx, a, b, c, dev)
    tp.run()
    tp.wait()
    dev.stop()
    return dev, time.perf_counter_ns() - t0


def run_dtd_gemm(ctx, n=256, nb=64):
    """A DTD GEMM, one launch a task: (device, wall ns as above)."""
    a, b, c = _colls(ctx, n, nb, np.random.default_rng(1))
    t0 = time.perf_counter_ns()
    dev = CudaDevice(ctx, device="cpu")
    dtd = DtdTaskpool(ctx)
    nt = n // nb
    for m in range(nt):
        for j in range(nt):
            for k in range(nt):
                dtd.insert_cuda_task(
                    dev, k_gemm, (dtd.tile_of(a, m, k), "INPUT"),
                    (dtd.tile_of(b, k, j), "INPUT"),
                    (dtd.tile_of(c, m, j), "INOUT"),
                    shapes={i: (nb, nb) for i in range(3)})
    dtd.wait()
    dev.stop()
    wall = time.perf_counter_ns() - t0
    dtd.destroy()
    return dev, wall


def run_panel_potrf(ctx, n=512, nb=64):
    """The panel Cholesky, whose factor tasks complete from the update
    wave's speculative epilogue."""
    m = np.random.default_rng(2).standard_normal((n, n)).astype(np.float32)
    a = TwoDimBlockCyclic(n, n, n, nb, dtype=np.float32)
    a.from_dense(m @ m.T + n * np.eye(n, dtype=np.float32))
    a.register(ctx, "A")
    dev = CudaDevice(ctx, device="cpu")
    tp = build_potrf_panels(ctx, a, dev=dev)
    tp.run()
    tp.wait()
    dev.stop()
    return dev, 0


def span_sums(tr):
    """Summed span durations by key, and span counts by key."""
    ns, count = {}, {}
    for s in tr.spans():
        ns[s[2]] = ns.get(s[2], 0) + s[8] - s[7]
        count[s[2]] = count.get(s[2], 0) + 1
    return ns, count


@pytest.mark.parametrize("run", [run_ptg_gemm, run_dtd_gemm],
                         ids=["ptg_gemm", "dtd_gemm"])
def test_buckets_add_up_to_the_managers_wall_time(run):
    """The four buckets partition the manager loop: their sum is the
    loop's wall time within 2%, and lies inside the caller's time from
    the device's creation to its stop; every bucket is measured."""
    with tpt.Context(nb_workers=2) as ctx:
        dev, wall = run(ctx)
        st = dev.info()["stats"]
    total = sum(st[b] for b in BUCKETS)
    assert abs(st["mgr_wall_ns"] - total) <= 0.02 * st["mgr_wall_ns"], st
    assert 0.8 * wall <= total <= wall, (wall, st)
    for b in BUCKETS:
        assert st[b] > 0, (b, st)


@pytest.mark.parametrize("run,field", [(run_ptg_gemm, "chain_hits"),
                                       (run_panel_potrf, "spec_hits")],
                         ids=["parked_chain", "speculative_epilogue"])
def test_parked_completions_are_complete_time(run, field):
    """Tasks that complete from a parked chain result or a speculative
    epilogue's result are in DEVICE_COMPLETE spans with aux 1, at least
    as many as completed so, and their time is complete time."""
    with tpt.Context(nb_workers=2) as ctx:
        ctx.profile_enable(1)
        dev, _ = run(ctx)
        st = dev.info()["stats"]
        hits = dev.info()["fuse"]["chain_hits"] if field == "chain_hits" \
            else st["spec_hits"]
        tr = tprof.take_trace(ctx)
    assert hits > 0
    done = [s for s in tr.spans() if s[2] == KEY_DEVICE_COMPLETE]
    parked = [s for s in done if s[6] == 1]
    assert parked and sum(s[4] for s in parked) >= hits
    assert st["mgr_complete_ns"] >= sum(s[8] - s[7] for s in parked) > 0
    # the tasks that launched complete in the aux-0 spans, one stretch a
    # launch or fewer
    launched = sum(s[4] for s in done if s[6] == 0)
    assert launched + hits >= st["tasks"] - hits


def test_span_sums_equal_the_counters():
    """Each manager span key's summed durations equal its counter over
    the device's life, traced whole, as GC_PAUSE's do gc_pause_ns's
    delta: on the wall clock (to_wall corrects the trace clock's rate),
    each span's stamps lie a native call from its counter's clock read
    (the collector is held off but for one forced pass).  All four
    together agree to that; a key alone, to that and the one time slice
    an overloaded host may take from the manager between a stamp and its
    clock read, which moves time between two adjacent buckets."""
    gc.collect()
    gc.disable()
    try:
        with tpt.Context(nb_workers=2) as ctx:
            a, b, c = _colls(ctx, 256, 32, np.random.default_rng(3))
            ctx.profile_enable(1)
            dev = CudaDevice(ctx, device="cpu")
            s0 = dev.info()["stats"]
            tp = build_gemm(ctx, a, b, c, dev)
            tp.run()
            tp.wait()
            gc.collect()
            dev.stop()
            s1 = dev.info()["stats"]
            tr = tprof.take_trace(ctx)
    finally:
        gc.enable()
    ns, count = span_sums(tr.to_wall())
    want = sum(s1[b] - s0[b] for b in BUCKETS)
    got = sum(ns.get(KEY_OF[b], 0) for b in BUCKETS)
    n = sum(count.get(KEY_OF[b], 0) for b in BUCKETS)
    assert abs(got - want) <= 50_000 * n + 0.005 * want, (got, want, n)
    for b in BUCKETS:
        key_want = s1[b] - s0[b]
        key_got = ns.get(KEY_OF[b], 0)
        assert abs(key_got - key_want) <= 50_000 * count.get(KEY_OF[b], 0) \
            + 0.03 * want, (b, key_got, key_want, count)
    want = s1["gc_pause_ns"] - s0["gc_pause_ns"]
    assert want > 0 and count[KEY_GC_PAUSE] >= 1
    assert abs(ns[KEY_GC_PAUSE] - want) <= 50_000 * count[KEY_GC_PAUSE] \
        + 0.005 * want, (ns[KEY_GC_PAUSE], want)


def test_a_long_wait_counts_while_it_lasts():
    """An idle device's wait is in its counter before the wait ends (at
    each 50 ms poll), so the counters read at any time add up to the
    loop's wall time; tracing turned on during the wait begins its span
    at the next poll, and the stop ends it."""
    with tpt.Context(nb_workers=1) as ctx:
        dev = CudaDevice(ctx, device="cpu")
        time.sleep(0.3)
        st = dev.info()["stats"]
        ctx.profile_enable(1)
        on = ctx._wall_anchor[0]
        time.sleep(0.2)
        dev.stop()
        tr = tprof.take_trace(ctx)
    assert st["mgr_wait_ns"] >= 0.8 * st["mgr_wall_ns"] > 0.2e9, st
    waits = [s for s in tr.spans() if s[2] == KEY_DEVICE_WAIT]
    assert len(waits) == 1 and on <= waits[0][7] <= on + 100_000_000


def test_a_forced_collection_is_counted():
    """gc.collect() while a device runs raises gc_pause_ns and counts one
    more full pass, in every running device's stats (process totals)."""
    with tpt.Context(nb_workers=1) as ctx:
        dev = CudaDevice(ctx, device="cpu")
        s0 = dev.info()["stats"]
        gc.collect()
        s1 = dev.info()["stats"]
        dev.stop()
    assert s1["gc_pause_ns"] > s0["gc_pause_ns"]
    assert s1["gc_full_passes"] >= s0["gc_full_passes"] + 1


def test_the_gc_hook_lives_while_a_device_runs():
    """One hook for any number of running devices, installed at the
    first start() and gone after the last stop(); a device never started
    adds none."""
    from parsec_tpu_torch.device.cuda import _GC
    hook = _GC._hook
    assert gc.callbacks.count(hook) == 0
    with tpt.Context(nb_workers=1) as ctx:
        idle = CudaDevice(ctx, device="cpu", autostart=False)
        assert gc.callbacks.count(hook) == 0
        d1 = CudaDevice(ctx, device="cpu")
        d2 = CudaDevice(ctx, device="cpu")
        assert gc.callbacks.count(hook) == 1
        d1.stop()
        assert gc.callbacks.count(hook) == 1
        d2.stop()
        assert gc.callbacks.count(hook) == 0
        idle.stop()
    assert gc.callbacks.count(hook) == 0


def test_the_gc_hook_under_concurrent_starts_and_stops():
    """Devices started and stopped on 8 threads at once, with forced
    collections beside them and a short switch interval: the hook is
    installed once while any runs and gone at the end, and the pause
    total only grows."""
    import sys
    import threading
    from parsec_tpu_torch.device.cuda import _GC
    errors, seen = [], []
    interval = sys.getswitchinterval()

    def churn():
        try:
            for _ in range(3):
                with tpt.Context(nb_workers=1) as ctx:
                    dev = CudaDevice(ctx, device="cpu")
                    seen.append(gc.callbacks.count(_GC._hook))
                    dev.stop()
        except Exception as e:  # pragma: no cover - reported below
            errors.append(repr(e))

    def collect(stop):
        last = 0
        while not stop.is_set():
            gc.collect(0)
            if _GC.pause_ns < last:
                errors.append("pause total went down")
            last = _GC.pause_ns

    sys.setswitchinterval(1e-5)
    try:
        stop = threading.Event()
        col = threading.Thread(target=collect, args=(stop,))
        col.start()
        ts = [threading.Thread(target=churn) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        stop.set()
        col.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not [t for t in ts if t.is_alive()] and not col.is_alive()
    assert not errors, errors
    assert seen and set(seen) == {1}
    assert gc.callbacks.count(_GC._hook) == 0


def test_no_span_call_while_nothing_listens(monkeypatch):
    """With tracing off and no PINS chain the device makes no span call,
    and its counters still run; a PINS chain turns the calls on."""
    calls = []
    real = N.prof_event_held

    def counting(*a):
        calls.append(a[1])
        return real(*a)

    monkeypatch.setattr(N, "prof_event_held", counting)
    with tpt.Context(nb_workers=2) as ctx:
        dev, _ = run_ptg_gemm(ctx, n=128)
        assert not calls
        assert dev.info()["stats"]["mgr_dispatch_ns"] > 0
        tprof.enable_pins(ctx, "device_activity")
        assert ctx._listening
        run_ptg_gemm(ctx, n=128, nb=64)
        ctx._pins_chain.uninstall()
        assert not ctx._listening
    assert KEY_DEVICE in calls and KEY_DEVICE_WAIT in calls


def test_lane_and_dispatch_h2d_spans_pair_apart():
    """A lane's staging span and a dispatch's of the same bytes and queue
    interleave on worker -1: each pairs with its own end, because the
    lane's spans have a key of their own (under one key the lane's
    begin would pair with the dispatch's end)."""
    q, nbytes = 3, 4096
    ev = np.array([
        [KEY_H2D_AHEAD, 0, -1, nbytes, q, -1, 1, 100],   # lane begins
        [KEY_H2D, 0, -1, nbytes, q, -1, 0, 150],         # dispatch begins
        [KEY_H2D, 1, -1, nbytes, q, -1, 0, 170],         # dispatch ends
        [KEY_H2D_AHEAD, 1, -1, nbytes, q, -1, 1, 400],   # lane ends
    ], dtype=np.int64)
    spans = sorted((s[2], s[7], s[8]) for s in tprof.Trace(ev).spans())
    assert spans == [(KEY_H2D, 150, 170), (KEY_H2D_AHEAD, 100, 400)]


def test_to_wall_maps_the_anchors_and_they_survive_save_load(tmp_path):
    """take_trace stamps two (trace clock, wall clock) anchors; to_wall
    maps each exactly onto its wall time and every timestamp between them
    onto the wall clock's range; the anchors survive save/load and a
    merge."""
    with tpt.Context(nb_workers=2) as ctx:
        w_before = time.time_ns()
        ctx.profile_enable(1)
        run_dtd_gemm(ctx, n=128)
        tr = tprof.take_trace(ctx)
        w_after = time.time_ns()
    anchors = tr.meta["wall_anchors"]
    assert len(anchors) == 2
    probe = tprof.Trace(np.array(
        [[KEY_DEVICE_PLAN, p, -1, 0, 0, -1, 0, c] for p, (c, _) in
         enumerate(anchors)], dtype=np.int64),
        meta={"wall_anchors": anchors})
    assert probe.to_wall().events[:, 7].tolist() == [w for _, w in anchors]
    wall = tr.to_wall()
    assert w_before <= wall.events[:, 7].min() <= \
        wall.events[:, 7].max() <= w_after
    assert tr.wall_drift_ns() == (anchors[1][1] - anchors[0][1]) - \
        (anchors[1][0] - anchors[0][0])
    p = str(tmp_path / "t.ptt")
    tr.save(p)
    back = tprof.Trace.load(p)
    assert back.meta["wall_anchors"] == anchors
    np.testing.assert_array_equal(back.to_wall().events, wall.events)
    merged = tprof.Trace.merge([back])
    np.testing.assert_array_equal(merged.to_wall().events[:, 7],
                                  wall.events[:, 7])
    doc = wall.to_perfetto(device_ops=[("k", int(wall.events[0, 7]),
                                        int(wall.events[0, 7]) + 10)])
    assert any(e.get("cat") == "device" for e in doc["traceEvents"])


def test_lost_time_manager_row_and_device_idle_blame():
    """lost_time on a device pool's trace reports the manager's buckets
    (its worker rows unchanged), and given device ops it labels every
    idle gap: the labels add up to the window less the ops' union."""
    with tpt.Context(nb_workers=2) as ctx:
        ctx.profile_enable(1)
        run_dtd_gemm(ctx, n=128)
        tr = tprof.take_trace(ctx)
    lt = tprof.lost_time(tr)
    row = lt["manager"][(0, -1)]
    for b in ("wait", "plan", "dispatch", "complete"):
        assert row[b] > 0, row
    assert sum(row[b] for b in ("wait", "plan", "dispatch", "complete")) \
        <= row["window_ns"]
    assert "device_idle" not in row
    ev = tr.events
    w0, w1 = int(ev[:, 7].min()), int(ev[:, 7].max())
    # synthetic ops: one a DEVICE_DISPATCH span, starting at its middle
    disp = [s for s in tr.spans() if s[2] == KEY_DEVICE]
    ops = [("k", (s[7] + s[8]) // 2, s[8] + 1000) for s in disp]
    busy = tprof.critpath._union_ns([(a, min(b, w1)) for _, a, b in ops])
    idle = tprof.lost_time(tr, device_ops=ops)["manager"][(0, -1)][
        "device_idle"]
    named = sum(v for k, v in idle.items() if k not in ("none", "gc"))
    assert named + idle["none"] == (w1 - w0) - busy
    assert idle["none"] <= 0.05 * (named + idle["none"]), idle
    host = tprof.lost_time(tr)
    assert host["workers"] == lt["workers"]
    # a window of its own: the row counts inside it alone
    half = (w0, (w0 + w1) // 2)
    part = tprof.lost_time(tr, device_ops=ops, window=half)["manager"][
        (0, -1)]
    assert part["window_ns"] == half[1] - half[0]
    assert sum(part[b] for b in ("wait", "plan", "dispatch", "complete")) \
        <= part["window_ns"]
    assert sum(v for k, v in part["device_idle"].items() if k != "gc") \
        <= part["window_ns"]
