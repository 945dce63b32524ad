"""The port's device pipeline — the prefetch lane, the residency planner's
reserve/evict/spill protocol, the overcommit drain and the grouped
write-back — held against the JAX package's on the CPU:
CudaDevice(ctx, device="cpu") on one side and TpuDevice on the JAX CPU
backend on the other, on identical seeded numpy inputs.  The contracts
are those of tests/device/test_prefetch.py, test_ooc.py,
test_eviction.py and test_stream_prefetch.py.  Elementwise outputs are
held bit-identical to the reference's, GEMM at 1e-3 (f32 sums in another
order).

Where a contract needs the lane to have staged a wave before the manager
runs it, the device is built with autostart=False, the tasks are queued,
one lane sweep stages them, and only then does the manager start: the
lane's hit is deterministic, not a race against the manager."""
import threading
import time

import numpy as np
import pytest
import torch

import parsec_tpu as jpt
import parsec_tpu_torch as tpt
from parsec_tpu.algos import build_gemm as jax_build_gemm
from parsec_tpu.data import TwoDimBlockCyclic as JaxBlockCyclic
from parsec_tpu.device import TpuDevice
from parsec_tpu.device.prefetch import _PrefetchLane as JaxLane
from parsec_tpu_torch.algos import build_gemm
from parsec_tpu_torch.convert import to_collection
from parsec_tpu_torch.data import TwoDimBlockCyclic
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.device import cuda as cuda_mod
from parsec_tpu_torch.device.cuda import _next_uid
from parsec_tpu_torch.device.prefetch import _PrefetchLane
from parsec_tpu_torch.ops import build_rms_norm

TILES = 48
ELEMS = 4 * 1024
TB = ELEMS * 4
PORT = (tpt, lambda ctx, **kw: CudaDevice(ctx, device="cpu", **kw),
        _PrefetchLane)
REF = (jpt, TpuDevice, JaxLane)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs its files in parallel
    worker processes, and an intra-op pool per worker would oversubscribe
    the host under the timing-sensitive tests of the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scale_dag(pt, ctx, ntiles, ref_name="O"):
    tp = pt.Taskpool(ctx, globals={"NT": ntiles - 1})
    k = pt.L("k")
    tc = tp.task_class("Scale")
    tc.param("k", 0, pt.G("NT"))
    tc.flow("X", "R", pt.In(pt.Mem("T", k)), arena="t")
    tc.flow("Y", "RW", pt.In(pt.Mem(ref_name, k)),
            pt.Out(pt.Mem(ref_name, k)), arena="t")
    return tp, tc


def _register(ctx, src, dst, tb):
    ctx.register_linear_collection("T", src, elem_size=tb)
    ctx.register_linear_collection("O", dst, elem_size=tb)
    ctx.register_arena("t", tb)


def _queued(ctx, dev, n, timeout=20.0):
    """Wait until the workers routed n ready tasks to the (undrained)
    device queue."""
    deadline = time.monotonic() + timeout
    while ctx.device_queue_depth(dev.qid) < n:
        assert time.monotonic() < deadline, ctx.device_queue_depth(dev.qid)
        time.sleep(0.01)


def _staged_run(side, src, scale, batch, cache_bytes=None,
                sync_mem_out=False):
    """The wave DAG y = x * scale + y over len(src) tiles, its waves
    staged by one lane sweep before the manager starts.  Returns (output,
    device stats, dirty uids left after the flush)."""
    pt, make_dev, lane_cls = side
    n, elems = src.shape
    tb = elems * 4
    dst = np.zeros_like(src)
    with pt.Context(nb_workers=2) as ctx:
        _register(ctx, src, dst, tb)
        kw = {} if cache_bytes is None else {"cache_bytes": cache_bytes}
        dev = make_dev(ctx, autostart=False, prefetch=True, **kw)
        dev.batch_max = batch
        tp, tc = _scale_dag(pt, ctx, n)
        dev.attach(tc, tp, kernel=lambda x, y: x * scale + y,
                   reads=["X", "Y"], writes=["Y"],
                   shapes={"X": (elems,), "Y": (elems,)}, dtype=np.float32,
                   sync_mem_out=sync_mem_out)
        tp.run()
        _queued(ctx, dev, n)
        assert lane_cls(dev, depth=64, slots=2)._sweep()
        dev.start()
        tp.wait()
        dev.flush()
        stats = dict(ctx.device_stats())
        with dev._lock:
            dirty_left = [k for k, e in dev._cache.items() if e.dirty]
        dev.stop()
    return dst, stats, dirty_left


def _tiles(seed, n=TILES, elems=ELEMS):
    return np.random.default_rng(seed).standard_normal(
        (n, elems)).astype(np.float32)


# ------------------------------------------------------ test_prefetch.py
def test_peek_ready_span():
    """ptc_peek_ready snapshots queued tasks without popping: with the
    manager not started, every routed task is visible with its two read
    flows (size, version), a second peek finds the pins balanced, and the
    queue drains normally afterwards — on both packages, to the same
    bits."""
    src = _tiles(0)
    outs = []
    for pt, make_dev, _ in (PORT, REF):
        dst = np.zeros_like(src)
        with pt.Context(nb_workers=1) as ctx:
            _register(ctx, src, dst, TB)
            dev = make_dev(ctx, autostart=False)
            tp, tc = _scale_dag(pt, ctx, TILES)
            dev.attach(tc, tp, kernel=lambda x, y: x * 2.0 + y,
                       reads=["X", "Y"], writes=["Y"],
                       shapes={"X": (ELEMS,), "Y": (ELEMS,)},
                       dtype=np.float32)
            tp.run()
            _queued(ctx, dev, TILES)
            peeked = ctx.device_peek(dev.qid, max_tasks=TILES)
            assert len(peeked) == TILES, len(peeked)
            for tref, recs in peeked:
                assert tref != 0
                assert len(recs) == 2, recs
                for _, size, ver in recs:
                    assert size == TB and ver >= 0
            assert len(ctx.device_peek(dev.qid, max_tasks=8)) == 8
            dev.start()
            tp.wait()
            dev.flush()
            assert dev.stats["tasks"] == TILES
            dev.stop()
        outs.append(dst)
    np.testing.assert_array_equal(outs[0], src * 2.0)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_prefetch_lane_stages_next_waves():
    """Wide wave workload, batch 8: waves staged by the lane hit at their
    stage-in, the lane's h2d time is counted apart from dispatch stalls,
    and the output is the reference's to the bit."""
    src = _tiles(1)
    out, st, _ = _staged_run(PORT, src, 2.0, 8)
    ref, rst, _ = _staged_run(REF, src, 2.0, 8)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, src * 2.0)
    for s in (st, rst):
        assert s["prefetch_staged"] > 0, s
        assert s["prefetch_hits"] > 0, s
        assert s["prefetch_h2d_ns"] > 0, s
        assert 0.0 <= s["overlap_ratio"] <= 1.0


def test_prefetch_off_knob():
    """prefetch=False: no lane, no prefetch traffic — every cold tile is
    staged at dispatch (the staged baseline)."""
    src = _tiles(2)
    outs, stats = [], []
    for pt, make_dev, _ in (PORT, REF):
        dst = np.zeros_like(src)
        with pt.Context(nb_workers=1) as ctx:
            _register(ctx, src, dst, TB)
            dev = make_dev(ctx, prefetch=False)
            tp, tc = _scale_dag(pt, ctx, TILES)
            dev.attach(tc, tp, kernel=lambda x, y: x * 2.0 + y,
                       reads=["X", "Y"], writes=["Y"],
                       shapes={"X": (ELEMS,), "Y": (ELEMS,)},
                       dtype=np.float32)
            tp.run()
            tp.wait()
            dev.flush()
            stats.append(dict(dev.stats))
            dev.stop()
        outs.append(dst)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], src * 2.0)
    for s in stats:
        assert s["prefetch_staged"] == 0 and s["prefetch_hits"] == 0, s
        assert s["prefetch_misses"] == 0, s
        assert s["h2d_stall_ns"] > 0, s


def test_device_stats_export():
    """Context.device_stats() aggregates the pipeline counters and the
    counter-level overlap ratio: every key of the reference's, except
    the streaming and wave-fusion ones whose slices are not ported."""
    src = _tiles(3)
    keys = []
    for pt, make_dev, _ in (PORT, REF):
        dst = np.zeros_like(src)
        with pt.Context(nb_workers=1) as ctx:
            _register(ctx, src, dst, TB)
            dev = make_dev(ctx)
            tp, tc = _scale_dag(pt, ctx, TILES)
            dev.attach(tc, tp, kernel=lambda x, y: x + y, reads=["X", "Y"],
                       writes=["Y"], shapes={"X": (ELEMS,), "Y": (ELEMS,)},
                       dtype=np.float32)
            tp.run()
            tp.wait()
            st = ctx.device_stats()
            dev.stop()
        assert len(st["devices"]) == 1
        keys.append(set(st))
    port, ref = keys
    for key in ("prefetch_staged", "prefetch_hits", "prefetch_misses",
                "reserve_fails", "spills", "spill_bytes", "h2d_stall_ns",
                "prefetch_h2d_ns", "overlap_ratio", "ooc_waits",
                "devices"):
        assert key in port, key
    missing = {k for k in ref - port
               if not k.startswith("stream_") and k != "fuse"}
    assert not missing, missing


# ------------------------------------------------------------ test_ooc.py
def _gemm_run(side, m, n, k, mb, seed, budget_div=2):
    """GEMM with the device budget at tile_set // budget_div; returns
    (C, A @ B in float64, stats, residency at the end, tile_set)."""
    pt, make_dev, _ = side
    coll = TwoDimBlockCyclic if side is PORT else JaxBlockCyclic
    build = build_gemm if side is PORT else jax_build_gemm
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k), dtype=np.float32)
    b = rng.standard_normal((k, n), dtype=np.float32)
    with pt.Context(nb_workers=2) as ctx:
        A = coll(m, k, mb, mb, dtype=np.float32)
        B = coll(k, n, mb, mb, dtype=np.float32)
        C = coll(m, n, mb, mb, dtype=np.float32)
        A.from_dense(a)
        B.from_dense(b)
        C.from_dense(np.zeros((m, n), np.float32))
        for name, c in zip("ABC", (A, B, C)):
            c.register(ctx, name)
        tile_set = (m * k + k * n + m * n) * 4
        dev = make_dev(ctx, cache_bytes=tile_set // budget_div)
        tp = build(ctx, A, B, C, dev=dev)
        tp.run()
        tp.wait()
        dev.flush()
        stats = dict(dev.stats)
        used = dev._cache_used
        dev.stop()
        return (C.to_dense(), a.astype(np.float64) @ b, stats, used,
                tile_set)


def test_ooc_gemm_2x_budget_single_rank():
    """GEMM whose tile set is 2x the device budget (C alone exceeds it:
    clean eviction cannot save the run, dirty mirrors MUST spill): the
    run completes, right, with spills and residency held to the tile
    set by the overcommit drain."""
    c, want, st, used, tile_set = _gemm_run(PORT, 128, 128, 32, 16, 5)
    rc, _, rst, _, _ = _gemm_run(REF, 128, 128, 32, 16, 5)
    np.testing.assert_allclose(c, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(c, rc, rtol=1e-3, atol=1e-3)
    for s in (st, rst):
        assert s["spills"] > 0 and s["spill_bytes"] > 0, s
    assert used <= tile_set, (used, tile_set)


def test_ooc_disabled_knob(monkeypatch):
    """device.out_of_core=0: the planner never spills — dirty mirrors
    stay pinned, and the run is right all the same."""
    monkeypatch.setenv("PTC_MCA_device_out_of_core", "0")
    c, want, st, _, _ = _gemm_run(PORT, 64, 64, 16, 8, 6)
    rc, _, rst, _, _ = _gemm_run(REF, 64, 64, 16, 8, 6)
    np.testing.assert_allclose(c, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(c, rc, rtol=1e-3, atol=1e-3)
    assert st["spills"] == 0 and rst["spills"] == 0, (st, rst)
    assert st["ooc_waits"] == 0, st


# ------------------------------------------------------- test_eviction.py
def test_eviction_under_prefetch_pressure():
    """The lane active with a budget far below the lookahead's working
    set (about 6 tiles for 24 in + 24 out): its reservations evict cold
    tiles, no dirty mirror is dropped (the sync-mem-out writebacks ride
    the writeback lane as stacked d2h copies), and the memory image is
    exact and the reference's."""
    n, elems = 24, 8 * 1024
    src = np.random.default_rng(9).integers(
        0, 100, size=(n, elems)).astype(np.float32)
    runs = [_staged_run(side, src, 3.0, 4, cache_bytes=6 * elems * 4,
                        sync_mem_out=True) for side in (PORT, REF)]
    (out, st, dirty), (ref, rst, _) = runs
    assert st["prefetch_staged"] > 0 and rst["prefetch_staged"] > 0
    assert st["evictions"] > 0, st
    assert st["wb_tasks"] == n, st
    assert dirty == [], dirty
    np.testing.assert_array_equal(out, src * 3.0)
    np.testing.assert_array_equal(out, ref)


# -------------------------------------------------- test_stream_prefetch.py
def test_prefetch_wake_event_exists_and_counts():
    """The device exposes the lane's wake event; setting it makes the
    idle lane's wait return, counted as a wakeup — on both packages."""
    for pt, make_dev, _ in (PORT, REF):
        with pt.Context(nb_workers=1) as ctx:
            dev = make_dev(ctx, prefetch=True)
            try:
                assert isinstance(dev._pf_wake, threading.Event)
                before = dev.stats["prefetch_wakeups"]
                deadline = time.time() + 5.0
                while time.time() < deadline and \
                        dev.stats["prefetch_wakeups"] <= before:
                    dev._pf_wake.set()
                    time.sleep(0.01)
                assert dev.stats["prefetch_wakeups"] > before, dev.stats
            finally:
                dev.stop()


# -------------------------------------------------------------- unit tests
def _cpu_dev(ctx, **kw):
    kw.setdefault("autostart", False)
    return CudaDevice(ctx, device="cpu", **kw)


def _put_dirty(dev, data, persistent=True):
    """A dirty mirror of `data` over a zeroed host buffer; (uid, host)."""
    uid = _next_uid()
    host = np.zeros(data.shape, data.dtype)
    dev._cache_put(uid, 1, torch.from_numpy(data.copy()), data.nbytes,
                   dirty=True, host=host, persistent=persistent)
    return uid, host


def test_raw_mirror_reinterpreted_at_first_typed_read():
    """A prefetched flat uint8 mirror is read as the consumer's dtype and
    shape (the same bytes), the typed view is memoized, and the first
    stage-in consumes the prefetch flag exactly once."""
    with tpt.Context(nb_workers=1) as ctx:
        dev = _cpu_dev(ctx)
        vals = _tiles(4, 1, 32)[0].reshape(4, 8)
        raw = torch.from_numpy(vals.copy().view(np.uint8).reshape(-1))
        uid = _next_uid()
        assert dev._cache_put_prefetch(uid, 0, raw, raw.numel(), None,
                                       dev._host_epoch)
        assert dev._cache_ent(uid, 0).raw
        assert dev._cache_get_typed(uid, 1, np.float32, (4, 8)) is None
        got = dev._cache_get_typed(uid, 0, np.float32, (4, 8))
        assert got.dtype == torch.float32 and tuple(got.shape) == (4, 8)
        np.testing.assert_array_equal(got.numpy(), vals)
        ent = dev._cache_ent(uid, 0)
        assert not ent.raw and ent.arr.dtype == torch.float32
        with pytest.raises(TypeError):
            dev._cache_get_typed(uid, 0, np.int32, (4, 8))
        assert dev._consume_pf(uid) and not dev._consume_pf(uid)
        st = dev.stats
        assert st["prefetch_staged"] == 1 and st["prefetch_bytes"] == 128
        dev.stop()


def test_prefetch_put_never_displaces_an_entry():
    """_cache_put_prefetch skips a slot that holds a mirror (a dirty one
    above all: its bytes are newer than the host's), and a stage that
    began before a host-side overwrite; both count as wasted."""
    with tpt.Context(nb_workers=1) as ctx:
        dev = _cpu_dev(ctx)
        data = _tiles(5, 1, 16)[0]
        uid, _ = _put_dirty(dev, data)
        dirty = dev._cache_ent(uid, 1)
        stale = torch.zeros(64, dtype=torch.uint8)
        assert not dev._cache_put_prefetch(uid, 1, stale, 64, None,
                                           dev._host_epoch)
        assert dev._cache_ent(uid, 1) is dirty and dirty.dirty
        np.testing.assert_array_equal(dirty.arr.numpy(), data)
        other = _next_uid()
        epoch = dev._host_epoch
        dev._drop_mirror(_next_uid())  # a host rewrite somewhere
        assert not dev._cache_put_prefetch(other, 0, stale, 64, None, epoch)
        assert dev._cache_ent(other, 0) is None
        assert dev.stats["prefetch_wasted"] == 2
        assert dev.stats["prefetch_staged"] == 0
        assert dev._pf_reserved == 0
        dev.stop()


def test_spill_pick_skips_transient_pinned_and_clean_entries():
    """The out-of-core planner picks only dirty persistent mirrors outside
    the lookahead pin set and the entry being put, and marks them so that
    a second pressure wave does not queue them again."""
    with tpt.Context(nb_workers=1) as ctx:
        dev = _cpu_dev(ctx, cache_bytes=64)
        dev._ooc = False  # pick by hand below, not from the puts
        data = _tiles(6, 1, 16)[0]
        persistent, _ = _put_dirty(dev, data)
        transient, _ = _put_dirty(dev, data, persistent=False)
        pinned, _ = _put_dirty(dev, data)
        newest, _ = _put_dirty(dev, data)
        clean = _next_uid()
        dev._cache_put(clean, 0, torch.zeros(16), 64)
        dev._pf_pin = {pinned}
        with dev._lock:
            assert dev._spill_pick_locked(newest) == [persistent]
            assert dev._cache[persistent].spilling
            assert dev._spill_pick_locked(newest) == []
        dev.stop()


def test_overcommit_drain_counts_ooc_waits():
    """Past overcommit * budget the manager drains the writeback lane
    before it runs the next wave: with the lane's spill held, the
    manager waits (counted in ooc_waits) until it is released, and the
    run then completes, exact."""
    src = _tiles(7, 8, 64)
    dst = np.zeros_like(src)
    gate = threading.Event()
    with tpt.Context(nb_workers=1) as ctx:
        _register(ctx, src, dst, 256)
        dev = _cpu_dev(ctx, cache_bytes=256, prefetch=False)
        spill = dev._spill
        dev._spill = lambda uids: (gate.wait(20), spill(uids))
        filler = _tiles(8, 1, 256)[0]
        # 4x the budget: the next put picks it for a spill
        _, fhost = _put_dirty(dev, filler)
        _put_dirty(dev, filler[:64])
        tp, tc = _scale_dag(tpt, ctx, 8)
        dev.attach(tc, tp, kernel=lambda x, y: x * 2.0 + y,
                   reads=["X", "Y"], writes=["Y"], shapes={"X": (64,),
                                                           "Y": (64,)},
                   dtype=np.float32)
        tp.run()
        dev.start()
        deadline = time.monotonic() + 20
        while dev.stats["ooc_waits"] == 0:
            assert time.monotonic() < deadline, dev.stats
            time.sleep(0.005)
        tasks_while_held = dev.stats["tasks"]
        gate.set()
        tp.wait()
        dev.flush()
        st = dict(dev.stats)
        dev.stop()
    assert tasks_while_held == 0, st
    assert st["ooc_waits"] >= 1 and st["spills"] >= 1, st
    np.testing.assert_array_equal(fhost, filler)
    np.testing.assert_array_equal(dst, src * 2.0)


def test_grouped_flush_writes_each_dirty_persistent_tile_once(monkeypatch):
    """flush() moves same-size dirty persistent mirrors as one stacked
    d2h per group (split into chunks past _D2H_CHUNK) and lands each
    exactly once; transient and clean entries are left alone."""
    monkeypatch.setattr(cuda_mod, "_D2H_CHUNK", 2 * 64)
    rng = np.random.default_rng(10)
    with tpt.Context(nb_workers=1) as ctx:
        dev = _cpu_dev(ctx)
        dev._ooc = False
        tiles = [rng.standard_normal((4, 4)).astype(np.float32)
                 for _ in range(3)]
        vecs = [rng.standard_normal(8).astype(np.float32) for _ in range(2)]
        dirty = [_put_dirty(dev, t) + (t,) for t in tiles + vecs]
        _, thost = _put_dirty(dev, tiles[0], persistent=False)
        clean_host = np.zeros(16, np.float32)
        dev._cache_put(_next_uid(), 0, torch.ones(16), 64, host=clean_host)
        landed, copies = {}, []
        land, d2h = dev._land, dev._d2h_async

        def count_land(ent, row):
            landed[id(ent.host)] = landed.get(id(ent.host), 0) + 1
            land(ent, row)

        def count_d2h(arrs, events):
            copies.append(len(arrs))
            return d2h(arrs, events)
        dev._land, dev._d2h_async = count_land, count_d2h
        dev.flush()
        st = dict(dev.stats)
        assert all(not e.dirty for e in dev._cache.values() if e.persistent)
        dev.flush()  # nothing dirty is left: nothing moves
        dev.stop()
    # the 3 tiles in chunks of 2 and 1, the 2 vectors in one
    assert sorted(copies) == [1, 2, 2], copies
    assert sorted(landed.values()) == [1] * 5, landed
    for _, host, data in dirty:
        np.testing.assert_array_equal(host, data)
    assert st["d2h_bytes"] == 3 * 64 + 2 * 32, st
    assert not thost.any() and not clean_host.any()


@pytest.mark.parametrize("prefetch", [False, True], ids=["staged",
                                                         "prefetch"])
def test_norm_bit_identical_resident_and_out_of_core(prefetch):
    """NORM (a row-wise chore) gives the bits of one rms_norm call over
    every row, with the prefetch lane on or off, resident or out-of-core
    (a budget of half its O, so that O's dirty mirrors must spill), and
    stays within the reference's 2e-5 of the numpy body."""
    from parsec_tpu_torch.ops import rms_norm
    T, d, rows = 16, 128, 16 * 12
    x = np.random.default_rng(11).standard_normal((rows, d)) \
        .astype(np.float32)
    w = np.random.default_rng(12).standard_normal((1, d)).astype(np.float32)
    want = rms_norm(torch.from_numpy(x).view(-1, T, d),
                    torch.from_numpy(w[0]), 1e-6).reshape(rows, d).numpy()
    spills = []
    for budget in (None, rows * d * 2):
        Xc, Wc = to_collection(x, T, d), to_collection(w, 1, d)
        Oc = to_collection(np.zeros_like(x), T, d)
        with tpt.Context(nb_workers=2) as ctx:
            kw = {} if budget is None else {"cache_bytes": budget}
            dev = CudaDevice(ctx, device="cpu", prefetch=prefetch, **kw)
            dev.batch_max = 2
            tp = build_rms_norm(ctx, Xc, Wc, Oc, 1e-6, dev=dev)
            tp.run()
            tp.wait()
            dev.flush()
            spills.append(dev.stats["spills"])
            dev.stop()
        np.testing.assert_array_equal(Oc.to_dense(), want)
    assert spills[0] == 0 and spills[1] > 0, spills
    ref = x / np.sqrt(np.mean(x * x, -1, keepdims=True) + 1e-6) * w[0]
    np.testing.assert_allclose(want, ref, rtol=2e-5, atol=2e-5)
