"""The port's wave and chain fusion (device/fuse.py), the device's pre-run
plan_check and the prefetch lane's chain hints, held against the JAX
package on the CPU: CudaDevice(ctx, device="cpu") on one side and
TpuDevice on the JAX CPU backend on the other, on identical seeded numpy
inputs.  The cases are the one-rank cases of tests/device/test_wave_fuse.py
and every case of tests/device/test_plan_check.py, at their sizes.

Within the port, fused and unfused (device.wave_fuse=0) results are held
bit for bit, as the reference holds its own.  Against the reference:
GEMM and POTRF at 1e-4 (f32 sums in another order), RMSNorm and flash
attention at 2e-5.  The drain invariant of the parked results holds in
every fused run."""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import parsec_tpu as jpt
import parsec_tpu.analysis as jan
import parsec_tpu.utils as jutils
import parsec_tpu_torch as tpt
import parsec_tpu_torch.analysis as tan
import parsec_tpu_torch.utils as tutils
from parsec_tpu.algos import build_potrf as jax_build_potrf
from parsec_tpu.algos.gemm import build_gemm as jax_build_gemm
from parsec_tpu.data.collections import TwoDimBlockCyclic as JaxBlockCyclic
from parsec_tpu.device import TpuDevice
from parsec_tpu.ops.flash_attention import \
    build_flash_attention as jax_build_fa
from parsec_tpu.ops.rms_norm import build_rms_norm as jax_build_rms
from parsec_tpu.profiling.trace import KEY_DEVICE as JAX_KEY_DEVICE
from parsec_tpu_torch.algos import build_potrf
from parsec_tpu_torch.algos.gemm import build_gemm
from parsec_tpu_torch.data.collections import TwoDimBlockCyclic
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.device.prefetch import _PrefetchLane
from parsec_tpu_torch.ops.flash_attention import build_flash_attention
from parsec_tpu_torch.ops.rms_norm import build_rms_norm
from parsec_tpu_torch.profiling.trace import KEY_DEVICE

PORT = SimpleNamespace(
    name="port", pt=tpt, mca=tutils.params, coll=TwoDimBlockCyclic,
    device=lambda ctx, **kw: CudaDevice(ctx, device="cpu", **kw),
    gemm=build_gemm, potrf=build_potrf, rms=build_rms_norm,
    fa=build_flash_attention, key_device=KEY_DEVICE,
    PlanCheckError=tan.PlanCheckError)
REF = SimpleNamespace(
    name="ref", pt=jpt, mca=jutils.params, coll=JaxBlockCyclic,
    device=TpuDevice, gemm=jax_build_gemm, potrf=jax_build_potrf,
    rms=jax_build_rms, fa=jax_build_fa, key_device=JAX_KEY_DEVICE,
    PlanCheckError=jan.PlanCheckError)

FUSE_KEYS = {"enabled", "fused_waves", "fused_tasks", "fused_chains",
             "chain_waves", "chain_parked", "chain_hits", "chain_misses",
             "chain_drops", "cache_hits", "cache_misses", "parked",
             "refused"}
# the port's certificate cache (device/fuse.py), which the reference lacks
CERT_KEYS = {"cert_hits", "cert_misses", "cert_uncached"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs its files in
    parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_fuse(P, flag, fn, *args):
    P.mca.set("device.wave_fuse", bool(flag))
    try:
        return fn(P, *args)
    finally:
        P.mca.unset("device.wave_fuse")


def _drained(fs, pinned) -> bool:
    """The drain invariant: every parked result was consumed, missed or
    dropped by the end of the pool, and the residency pin went with it."""
    return (fs["chain_parked"] == fs["chain_hits"] + fs["chain_misses"]
            + fs["chain_drops"] + fs["parked"]
            and fs["parked"] == 0 and pinned == 0)


def _queued(ctx, dev, n, timeout=20.0):
    """Wait until the workers routed n ready tasks to the (unstarted)
    device's queue."""
    deadline = time.monotonic() + timeout
    while ctx.device_queue_depth(dev.qid) < n:
        assert time.monotonic() < deadline, ctx.device_queue_depth(dev.qid)
        time.sleep(0.01)


def _spd(n, rng):
    x = rng.standard_normal((n, n)).astype(np.float64)
    return (x @ x.T + n * np.eye(n)).astype(np.float32)


# ------------------------------------------------------------ chains
def _gemm_run(P, N=64, nb=16, K=128, seed=7):
    rng = np.random.default_rng(seed)
    with P.pt.Context(nb_workers=2) as ctx:
        A = P.coll(N, K, nb, nb, dtype=np.float32)
        B = P.coll(K, N, nb, nb, dtype=np.float32)
        C = P.coll(N, N, nb, nb, dtype=np.float32)
        A.from_dense(rng.standard_normal((N, K), dtype=np.float32))
        B.from_dense(rng.standard_normal((K, N), dtype=np.float32))
        C.from_dense(np.zeros((N, N), np.float32))
        A.register(ctx, "A")
        B.register(ctx, "B")
        C.register(ctx, "C")
        ctx.profile_enable(1)
        # the manager starts once the whole first wave (every C tile's
        # k = 0 task) is queued, so its first pop holds the wave on any
        # host load: a pop of one task dispatches alone, unfused, and its
        # k-chain then trickles in one task a pop (a fused run of 9
        # spans against 8 unfused on a loaded host)
        dev = P.device(ctx, autostart=False)
        dev.batch_wait_ms = 2.0  # coalesce whole waves per pop
        tp = P.gemm(ctx, A, B, C, dev=dev)
        tp.run()
        _queued(ctx, dev, C.mt * C.nt)
        dev.start()
        tp.wait()
        dev.flush()
        ev = ctx.profile_take()
        st = ctx.device_stats()
        pinned = dev._chain_pinned
        dev.stop()
        out = C.to_dense().copy()
    spans = int((ev[:, 0] == P.key_device).sum()) // 2
    return out, st["fuse"], spans, pinned


def test_gemm_chain_fused_bit_identical_fewer_launches():
    """A deep-k GEMM's certified wave chain runs as one dispatch a
    segment; downstream waves complete from parked results (chain_hits)
    with no launch, bit-identical to the unfused path within the port,
    at 1e-4 of the reference's C, with >= 3x fewer DEVICE_DISPATCH spans
    (the reference's own gate)."""
    c1, fs1, n1, p1 = _with_fuse(PORT, True, _gemm_run)
    c0, fs0, n0, _ = _with_fuse(PORT, False, _gemm_run)
    cr, fsr, _, _ = _with_fuse(REF, True, _gemm_run)
    assert c1.tobytes() == c0.tobytes()
    np.testing.assert_allclose(c1, cr, rtol=1e-4, atol=1e-3)
    assert fs1["fused_waves"] > 0 and fs1["fused_chains"] > 0
    assert fs1["chain_hits"] > 0 and fs1["chain_misses"] == 0
    assert fsr["chain_hits"] > 0 and fsr["chain_misses"] == 0
    assert _drained(fs1, p1)
    assert fs0["enabled"] is False
    assert fs0["fused_waves"] == 0 and fs0["chain_hits"] == 0
    assert n1 * 3 <= n0, (n1, n0)


def _small_gemm(P):
    rng = np.random.default_rng(3)
    with P.pt.Context(nb_workers=2) as ctx:
        A = P.coll(32, 64, 16, 16, dtype=np.float32)
        B = P.coll(64, 32, 16, 16, dtype=np.float32)
        C = P.coll(32, 32, 16, 16, dtype=np.float32)
        for coll, nm, shape in ((A, "A", (32, 64)), (B, "B", (64, 32)),
                                (C, "C", (32, 32))):
            coll.from_dense(rng.standard_normal(shape).astype(np.float32))
            coll.register(ctx, nm)
        want = A.to_dense() @ B.to_dense() + C.to_dense()
        dev = P.device(ctx)
        dev.batch_wait_ms = 2.0
        tp = P.gemm(ctx, A, B, C, dev=dev)
        tp.run()
        tp.wait()
        dev.flush()
        st = ctx.device_stats()["fuse"]
        pinned = dev._chain_pinned
        dev.stop()
        out = C.to_dense().copy()
    return st, pinned, out, want


def test_chain_parked_results_version_checked():
    """Every parked record is consumed (or missed, or dropped) by the end
    of the run: the parked count drains to zero and the residency pin
    with it, on both packages; C at 1e-4 of A @ B + C."""
    for P in (PORT, REF):
        st, pinned, out, want = _with_fuse(P, True, _small_gemm)
        assert _drained(st, pinned), (P.name, st, pinned)
        assert st["chain_parked"] > 0, (P.name, st)
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


# -------------------------------------------------- bit-exact matrix
def _potrf_run(P, N=128, nb=8):
    """potrf at the NT=16 tiling (816 instances)."""
    rng = np.random.default_rng(11)
    M = _spd(N, rng)
    with P.pt.Context(nb_workers=2) as ctx:
        A = P.coll(N, N, nb, nb, dtype=np.float32)
        A.from_dense(M)
        A.register(ctx, "A")
        dev = P.device(ctx)
        dev.batch_wait_ms = 2.0
        tp = P.potrf(ctx, A, dev=dev)
        tp.run()
        tp.wait()
        dev.flush()
        st = ctx.device_stats()["fuse"]
        pinned = dev._chain_pinned
        dev.stop()
        out = np.tril(A.to_dense()).copy()
    return out, st, pinned


def _rms_norm_run(P, R=6, T=8, d=16):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(R * T, d)).astype(np.float32)
    w = rng.normal(size=(1, d)).astype(np.float32)
    with P.pt.Context(nb_workers=2) as ctx:
        Xc = P.coll(R * T, d, T, d, dtype=np.float32)
        Wc = P.coll(1, d, 1, d, dtype=np.float32)
        Oc = P.coll(R * T, d, T, d, dtype=np.float32)
        dev = P.device(ctx)
        dev.batch_wait_ms = 2.0
        tp = P.rms(ctx, Xc, Wc, Oc, dev=dev)
        Xc.from_dense(x)
        Wc.from_dense(w)
        tp.run()
        tp.wait()
        dev.flush()
        st = ctx.device_stats()["fuse"]
        pinned = dev._chain_pinned
        dev.stop()
        out = Oc.to_dense().copy()
    return out, st, pinned


def _flash_attention_run(P, NQ=6, T=8, d=16):
    rng = np.random.default_rng(6)
    L = NQ * T
    q = rng.normal(size=(L, d)).astype(np.float32)
    k = rng.normal(size=(L, d)).astype(np.float32)
    v = rng.normal(size=(L, d)).astype(np.float32)
    with P.pt.Context(nb_workers=2) as ctx:
        Qc = P.coll(L, d, T, d, dtype=np.float32)
        Kc = P.coll(L, d, L, d, dtype=np.float32)
        Vc = P.coll(L, d, L, d, dtype=np.float32)
        Oc = P.coll(L, d, T, d, dtype=np.float32)
        dev = P.device(ctx)
        dev.batch_wait_ms = 2.0
        tp = P.fa(ctx, Qc, Kc, Vc, Oc, dev=dev)
        Qc.from_dense(q)
        Kc.from_dense(k)
        Vc.from_dense(v)
        tp.run()
        tp.wait()
        dev.flush()
        st = ctx.device_stats()["fuse"]
        pinned = dev._chain_pinned
        dev.stop()
        out = Oc.to_dense().copy()
    return out, st, pinned


@pytest.mark.parametrize("runner,tol", [(_potrf_run, 1e-4),
                                        (_rms_norm_run, 2e-5),
                                        (_flash_attention_run, 2e-5)],
                         ids=["potrf_nt16", "rms_norm", "flash_attention"])
def test_bit_exactness_matrix(runner, tol):
    """Fused against device.wave_fuse=0 bit-identical within the port on
    every graph with certified fusable waves, with fused_waves > 0 (the
    unfused path never sees the compiler); the fused output at `tol` of
    the reference's fused output."""
    out1, st1, p1 = _with_fuse(PORT, True, runner)
    out0, st0, _ = _with_fuse(PORT, False, runner)
    outr, str_, _ = _with_fuse(REF, True, runner)
    assert out1.tobytes() == out0.tobytes()
    np.testing.assert_allclose(out1, outr, rtol=tol, atol=tol)
    assert st1["fused_waves"] > 0, st1
    assert str_["fused_waves"] > 0, str_
    assert st0["enabled"] is False and st0["fused_waves"] == 0
    assert _drained(st1, p1)


# ---------------------------------------------------------- refusals
def _unbatchable_run(P):
    with P.pt.Context(nb_workers=2) as ctx:
        src = np.arange(8 * 32, dtype=np.float32).reshape(8, 32)
        dst = np.zeros_like(src)
        tb = 32 * 4
        ctx.register_linear_collection("T", src, elem_size=tb)
        ctx.register_linear_collection("O", dst, elem_size=tb)
        ctx.register_arena("t", tb)
        dev = P.device(ctx, autostart=False)
        dev.batch_wait_ms = 5.0
        dev.start()
        tp = P.pt.Taskpool(ctx, globals={"NT": 7})
        kv = P.pt.L("k")
        tc = tp.task_class("Raw")
        tc.param("k", 0, P.pt.G("NT"))
        tc.flow("X", "R", P.pt.In(P.pt.Mem("T", kv)), arena="t")
        tc.flow("Y", "RW", P.pt.In(P.pt.Mem("O", kv)),
                P.pt.Out(P.pt.Mem("O", kv)), arena="t")
        dev.attach(tc, tp, kernel=lambda x, y: x + y,
                   reads=["X", "Y"], writes=["Y"],
                   shapes={"X": (32,), "Y": (32,)},
                   dtype=np.float32, batch=False)
        tp.run()
        tp.wait()
        dev.flush()
        st = ctx.device_stats()["fuse"]
        dev.stop()
    return st, dst


def test_fuse_refused_by_reason_no_silent_fallback():
    """An unbatchable (batch=False) class refuses with an explicit reason
    on both packages; its results are those of a plain dispatch."""
    for P in (PORT, REF):
        st, dst = _with_fuse(P, True, _unbatchable_run)
        assert st["refused"].get("unbatchable-body", 0) > 0, (P.name, st)
        np.testing.assert_array_equal(
            dst, np.arange(8 * 32, dtype=np.float32).reshape(8, 32))


def _zero_schema(P):
    with P.pt.Context(nb_workers=1) as ctx:
        dev = P.device(ctx)
        st = ctx.device_stats()["fuse"]
        info = dev.info()["fuse"]
        dev.stop()
    return st, info


def test_wave_fuse_off_exports_zero_schema():
    """Knob off: no compiler, yet the reference's keys and the port's
    certificate cache counters, all zero, enabled False and no refusal."""
    port, port_info = _with_fuse(PORT, False, _zero_schema)
    ref, ref_info = _with_fuse(REF, False, _zero_schema)
    assert set(ref) == set(ref_info) == FUSE_KEYS
    assert set(port) == set(port_info) == FUSE_KEYS | CERT_KEYS
    assert {k: port[k] for k in FUSE_KEYS} == ref and port == port_info
    assert port["enabled"] is False and port["refused"] == {}
    assert port["cert_uncached"] == {}
    for k in FUSE_KEYS - {"enabled", "refused"} | {"cert_hits",
                                                   "cert_misses"}:
        assert port[k] == 0, (k, port)


def test_wave_fuse_knobs_default_on_in_both_registries():
    for P in (PORT, REF):
        assert P.mca.get("device.wave_fuse") is True
        assert P.mca.get("device.wave_fuse_depth") == 8
        assert P.mca.get("device.plan_check") == "off"
    with tpt.Context(nb_workers=1) as ctx:
        dev = CudaDevice(ctx, device="cpu")
        assert dev._fuser is not None
        assert ctx.device_stats()["fuse"]["enabled"] is True
        dev.stop()


# ------------------------------------------------------- plan_check
def _build(P, ctx, dev, m=64, k=16, mb=8, seed=7):
    rng = np.random.default_rng(seed)
    A = P.coll(m, k, mb, mb, dtype=np.float32)
    B = P.coll(k, m, mb, mb, dtype=np.float32)
    C = P.coll(m, m, mb, mb, dtype=np.float32)
    A.from_dense(rng.standard_normal((m, k), dtype=np.float32))
    B.from_dense(rng.standard_normal((k, m), dtype=np.float32))
    C.from_dense(np.zeros((m, m), np.float32))
    A.register(ctx, "A")
    B.register(ctx, "B")
    C.register(ctx, "C")
    return A, B, C, P.gemm(ctx, A, B, C, dev=dev)


def _resident(P):
    with P.pt.Context(nb_workers=2) as ctx:
        dev = P.device(ctx)
        A, B, C, tp = _build(P, ctx, dev)
        plan = tp.plan()
        predicted = plan.peak_bytes(rank=0, device_only=True)
        tp.run()
        tp.wait()
        dev.flush()
        measured = dev.stats["cache_peak_bytes"]
        spills = dev.stats["spills"]
        dev.stop()
        np.testing.assert_allclose(C.to_dense(),
                                   A.to_dense() @ B.to_dense(),
                                   rtol=1e-3, atol=1e-3)
    return measured, predicted, spills, plan.predict_spills(4 << 30,
                                                            rank=0)


def test_resident_gemm_peak_sound_and_tight(monkeypatch):
    """Resident run, batching pinned to 1: the measured device peak <=
    the predicted peak <= 1.25x measured, the predicted peak equals the
    reference's on the same pool, and no spill is predicted or made."""
    monkeypatch.setenv("PTC_DEVICE_BATCH", "1")
    measured, predicted, spills, pred_spills = _resident(PORT)
    _, ref_predicted, _, _ = _resident(REF)
    assert predicted == ref_predicted
    assert measured > 0
    assert measured <= predicted <= 1.25 * measured, (measured, predicted)
    assert spills == 0 and pred_spills == 0


def _ooc(P):
    with P.pt.Context(nb_workers=2) as ctx:
        m, k, mb = 64, 16, 8
        tile_set = (m * k + k * m + m * m) * 4
        dev = P.device(ctx, cache_bytes=tile_set // 2)
        A, B, C, tp = _build(P, ctx, dev)
        plan = tp.plan()
        pred = plan.predict_spills(tile_set // 2, rank=0)
        fits = plan.predict_spills(tile_set, rank=0)
        tp.run()
        tp.wait()
        dev.flush()
        measured = dev.stats["spills"]
        dev.stop()
        np.testing.assert_allclose(C.to_dense(),
                                   A.to_dense() @ B.to_dense(),
                                   rtol=1e-3, atol=1e-3)
    return pred, fits, measured


def test_ooc_gemm_spill_prediction_agrees(monkeypatch):
    """At half the tile set: spills predicted (the reference's count),
    none at the whole set, and the zero/nonzero verdict agrees with the
    measured spills."""
    monkeypatch.setenv("PTC_DEVICE_BATCH", "1")
    pred, fits, measured = _ooc(PORT)
    ref_pred, ref_fits, _ = _ooc(REF)
    assert (pred, fits) == (ref_pred, ref_fits)
    assert pred > 0 and fits == 0
    assert measured > 0, "ooc run did not spill"
    assert (pred > 0) == (measured > 0)


def _modes(P):
    with P.pt.Context(nb_workers=1) as ctx:
        dev = P.device(ctx)
        _A, _B, _C, tp = _build(P, ctx, dev)
        plan = dev.plan_check(tp, mode="warn")
        assert plan is not None and plan.has_device_classes
        first = dict(ctx.stats()["plan"])
        assert first["last_peak_bytes"] == plan.peak_bytes(
            rank=0, device_only=True)
        dev.set_cache_budget(first["last_peak_bytes"] // 2)
        dev.plan_check(tp, mode="warn", plan=plan)
        second = dict(ctx.stats()["plan"])
        off = dev.plan_check(tp)  # the knob's default: off
        dev.stop()
    return first, second, off


def test_plan_check_counters_and_modes(monkeypatch):
    """Fits: silent counters; over budget with out-of-core on: a warning
    and the predicted spills counted; stats()["plan"] equal to the
    reference's after the same checks."""
    monkeypatch.setenv("PTC_DEVICE_BATCH", "1")
    port = _modes(PORT)
    ref = _modes(REF)
    assert port == ref
    first, second, off = port
    assert first["checks"] == 1 and first["over_budget"] == 0
    assert first["enabled"] is False
    assert second["checks"] == 2 and second["over_budget"] == 1
    assert second["predicted_spills"] > 0
    assert off is None


def test_plan_check_error_mode_without_ooc(monkeypatch):
    monkeypatch.setenv("PTC_DEVICE_BATCH", "1")
    monkeypatch.setenv("PTC_MCA_device_out_of_core", "0")
    for P in (PORT, REF):
        with P.pt.Context(nb_workers=1) as ctx:
            m, k, mb = 64, 16, 8
            tile_set = (m * k + k * m + m * m) * 4
            dev = P.device(ctx, cache_bytes=tile_set // 2)
            _A, _B, _C, tp = _build(P, ctx, dev)
            with pytest.raises(P.PlanCheckError):
                dev.plan_check(tp, mode="error")
            # warn mode proceeds (stderr only)
            assert dev.plan_check(tp, mode="warn") is not None
            assert ctx.stats()["plan"]["over_budget"] == 2
            dev.stop()


def test_plan_check_armed_via_run_knob(monkeypatch):
    """Taskpool.run() runs the check when device.plan_check is armed:
    error mode rejects the over-budget pool before anything schedules
    (the pool is not committed), on both packages."""
    monkeypatch.setenv("PTC_DEVICE_BATCH", "1")
    monkeypatch.setenv("PTC_MCA_device_out_of_core", "0")
    monkeypatch.setenv("PTC_MCA_device_plan_check", "error")
    for P in (PORT, REF):
        with P.pt.Context(nb_workers=1) as ctx:
            m, k, mb = 64, 16, 8
            tile_set = (m * k + k * m + m * m) * 4
            dev = P.device(ctx, cache_bytes=tile_set // 2)
            _A, _B, _C, tp = _build(P, ctx, dev)
            with pytest.raises(P.PlanCheckError):
                tp.run()
            assert ctx.stats()["plan"]["enabled"] is True
            dev.stop()
        assert not tp._committed


# ------------------------------------------------------- chain hints
def test_lane_stages_chain_hints_and_refuses_stale_stages():
    """The lane stages the wave compiler's hinted collection tiles as raw
    mirrors at the host copy's version (a later stage-in is a hint hit);
    a hint with a current mirror is skipped; and a hinted tile written on
    the host while its stage is in flight is refused, not installed."""
    rng = np.random.default_rng(9)
    with tpt.Context(nb_workers=1) as ctx:
        A = TwoDimBlockCyclic(32, 32, 16, 16, dtype=np.float32)
        A.from_dense(rng.standard_normal((32, 32), dtype=np.float32))
        A.register(ctx, "A")
        dev = CudaDevice(ctx, device="cpu", autostart=False)
        lane = _PrefetchLane(dev)

        def key(m, n):
            cptr = tpt._native.lib.ptc_data_host_copy(A.data_of(m, n)._ptr)
            return (dev._copy_uid(cptr),
                    tpt._native.lib.ptc_copy_version(cptr))

        dev._pf_chain_hints = [("A", (0, 0)), ("A", (1, 0))]
        assert lane._stage_hints()
        assert dev._pf_chain_hints == []
        for m in (0, 1):
            uid, ver = key(m, 0)
            ent = dev._cache[uid]
            assert ent.pf == 2 and ent.raw and ent.version == ver
            np.testing.assert_array_equal(
                ent.arr.view(torch.float32).numpy().reshape(16, 16),
                A.tile(m, 0))
        assert dev.stats["prefetch_hint_stages"] == 2
        # hinted again: a current mirror serves it, nothing is staged
        dev._pf_chain_hints = [("A", (0, 0))]
        assert not lane._stage_hints()
        assert dev.stats["prefetch_hint_stages"] == 2
        # a stage-in of a hinted tile is a (hint) prefetch hit
        uid, ver = key(0, 0)
        got = dev._stage_in(uid, ver, np.float32, (16, 16), None)
        np.testing.assert_array_equal(got.numpy(), A.tile(0, 0))
        assert dev.stats["prefetch_hits"] == 1
        assert dev.stats["prefetch_hint_hits"] == 1
        # written in between: the host write lands while the stage runs
        uid11, _ = key(1, 1)
        real = dev._h2d_async

        def racing(src):
            A.tile(1, 1)[...] += 1.0
            ctx.host_wrote(A, 1, 1)
            return real(src)
        dev._h2d_async = racing
        dev._pf_chain_hints = [("A", (1, 1))]
        assert not lane._stage_hints()
        dev._h2d_async = real
        assert uid11 not in dev._cache
        assert dev.stats["prefetch_hint_wasted"] == 1
        assert dev.stats["prefetch_wasted"] == 1
        assert dev._pf_reserved == 0
        dev.stop()


def test_chain_publishes_hints_when_depth_cuts_the_chain():
    """With the chain cut short by device.wave_fuse_depth, each chain
    hands the next segment's collection tiles to the lane; the run stays
    bit-identical to the unfused one and drains."""
    def run(P):
        P.mca.set("device.wave_fuse_depth", 3)
        try:
            return _gemm_run(P)
        finally:
            P.mca.unset("device.wave_fuse_depth")
    seen = []
    orig = _PrefetchLane._stage_hints

    def spy(self):
        seen.extend(self.dev._pf_chain_hints)
        return orig(self)
    _PrefetchLane._stage_hints = spy
    try:
        c1, fs1, n1, p1 = _with_fuse(PORT, True, run)
    finally:
        _PrefetchLane._stage_hints = orig
    c0, _, n0, _ = _with_fuse(PORT, False, _gemm_run)
    assert c1.tobytes() == c0.tobytes()
    assert fs1["fused_chains"] > 1 and fs1["chain_misses"] == 0
    assert _drained(fs1, p1)
    assert seen and {name for name, _ in seen} <= {"A", "B"}
    assert n1 < n0


def test_device_peek_front_census():
    """The wave-granular native census the wave compiler reads: queued
    device tasks report their class ids without popping or pinning."""
    with tpt.Context(nb_workers=2) as ctx:
        src = np.arange(6 * 16, dtype=np.float32).reshape(6, 16)
        tb = 16 * 4
        ctx.register_linear_collection("T", src, elem_size=tb)
        ctx.register_arena("t", tb)
        dev = CudaDevice(ctx, device="cpu", autostart=False)
        tp = tpt.Taskpool(ctx, globals={"NT": 5})
        kv = tpt.L("k")
        tc = tp.task_class("Census")
        tc.param("k", 0, tpt.G("NT"))
        tc.flow("X", "RW", tpt.In(tpt.Mem("T", kv)),
                tpt.Out(tpt.Mem("T", kv)), arena="t")
        dev.attach(tc, tp, kernel=lambda x: x * 2.0, reads=["X"],
                   writes=["X"], shapes={"X": (16,)}, dtype=np.float32)
        tp.run()
        deadline = time.time() + 10.0
        front = []
        while time.time() < deadline:
            front = ctx.device_peek_front(dev.qid)
            if len(front) == 6:
                break
            time.sleep(0.01)
        assert len(front) == 6, front
        assert {cid for cid, _tp in front} == {tc.id}
        assert {tpp for _cid, tpp in front} == {tp._ptr}
        dev.start()
        tp.wait()
        dev.flush()
        np.testing.assert_allclose(
            src, np.arange(6 * 16, dtype=np.float32).reshape(6, 16) * 2)
        dev.stop()


@pytest.mark.parametrize("side", [16, 64, 128])
def test_k_gemm_nn_lane_bits_independent_of_wave_width(side):
    """A lone lane of k_gemm_nn runs as a two-lane product: lane 0
    at width 1 is bit for bit the same lane at widths 2 and 8 (on the
    card cuBLAS picks another algorithm for a one-lane batched product,
    so a wave's width decided a GEMM tile's bits), and it is the
    reference's chore's product within f32 rounding."""
    import jax.numpy as jnp

    from parsec_tpu.algos.gemm import k_gemm_nn as jax_k_gemm_nn
    from parsec_tpu_torch.algos.gemm import k_gemm_nn
    rng = np.random.default_rng(side)
    a, b, c = (rng.standard_normal((side, side), dtype=np.float32)
               for _ in range(3))
    lane0 = {}
    for w in (1, 2, 8):
        st = [torch.from_numpy(x).unsqueeze(0).expand(w, side, side)
              .contiguous() for x in (a, b, c)]
        out = k_gemm_nn(*st)
        assert out.shape == (w, side, side) and out.is_contiguous()
        lane0[w] = out[0].clone()
    assert torch.equal(lane0[1], lane0[2])
    assert torch.equal(lane0[1], lane0[8])
    ref = np.asarray(jax_k_gemm_nn(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(c)))
    np.testing.assert_allclose(lane0[1].numpy(), ref, rtol=1e-5,
                               atol=1e-4)
