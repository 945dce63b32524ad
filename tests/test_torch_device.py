"""The port's device path — Context -> Taskpool -> CudaDevice -> chore —
held against the JAX package's, on the CPU: CudaDevice(device="cpu") runs
each kernel's plain PyTorch version, and the reference runs the same
builders under TpuDevice on the JAX CPU backend (its Pallas kernels in
interpret mode where the tile shapes reach them).  Inputs are made from
a numpy seed and carried across by parsec_tpu_torch.convert."""
import gc
import time
import weakref

import numpy as np
import pytest
import torch

import parsec_tpu as jpt
import parsec_tpu_torch as tpt
from parsec_tpu.algos import build_gemm as jax_build_gemm
from parsec_tpu.data import TwoDimBlockCyclic as JaxBlockCyclic
from parsec_tpu.device import TpuDevice
from parsec_tpu.ops.flash_attention import \
    build_flash_attention as jax_build_fatt
from parsec_tpu.ops.rms_norm import build_rms_norm as jax_build_norm
from parsec_tpu_torch.algos import build_gemm, build_potrf
from parsec_tpu_torch.analysis.plan import chain_certificates
from parsec_tpu_torch.convert import to_collection
from parsec_tpu_torch.data import TwoDimBlockCyclic
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.ops import build_flash_attention, build_rms_norm


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs its files in parallel
    worker processes, and an intra-op pool per worker would oversubscribe
    the host under the timing-sensitive tests of the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _jax_coll(dense, mb, nb):
    c = JaxBlockCyclic(dense.shape[0], dense.shape[1], mb, nb,
                       dtype=np.float32)
    c.from_dense(dense)
    return c


def _run_port(build, colls, out_name):
    """Run a builder over port collections on CudaDevice(device='cpu');
    returns (output dense, device stats)."""
    with tpt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx, device="cpu")
        tp = build(ctx, colls, dev)
        tp.run()
        tp.wait()
        dev.flush()
        stats = dict(dev.stats)
        dev.stop()
        return colls[out_name].to_dense(), stats


def _run_ref(build, colls, out_name):
    with jpt.Context(nb_workers=2) as ctx:
        dev = TpuDevice(ctx)
        tp = build(ctx, colls, dev)
        tp.run()
        tp.wait()
        dev.flush()
        stats = dict(dev.stats)
        dev.stop()
        return colls[out_name].to_dense(), stats


def _gemm(builder):
    def build(ctx, c, dev):
        for name in "ABC":
            c[name].register(ctx, name)
        return builder(ctx, c["A"], c["B"], c["C"], dev=dev)
    return build


def test_gemm_matches_reference_device():
    """64x64 GEMM in 16x16 tiles: the port's batched products against the
    reference's XLA executables, at 1e-3 (f32 sums in another order)."""
    a, b = _normal(0, (64, 64)), _normal(1, (64, 64))
    z = np.zeros((64, 64), np.float32)
    out, st = _run_port(_gemm(build_gemm), {
        "A": to_collection(a, 16, 16), "B": to_collection(b, 16, 16),
        "C": to_collection(z, 16, 16)}, "C")
    ref, rst = _run_ref(_gemm(jax_build_gemm), {
        "A": _jax_coll(a, 16, 16), "B": _jax_coll(b, 16, 16),
        "C": _jax_coll(z, 16, 16)}, "C")
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out, a @ b, rtol=1e-3, atol=1e-3)
    assert st["tasks"] == rst["tasks"] == 4 * 4 * 4
    # A/B tiles are reused across the wave: the device cache must hit
    assert st["h2d_hits"] > 0 and st["batches"] > 0


def _norm(builder):
    def build(ctx, c, dev):
        return builder(ctx, c["X"], c["W"], c["O"], dev=dev)
    return build


@pytest.mark.parametrize("T,d", [(128, 128), (8, 16)],
                         ids=["kernel-tiles", "fallback-tiles"])
def test_rms_norm_taskpool_matches_reference_device(T, d):
    """NORM over (2T, d): 128x128 tiles reach the reference's Pallas
    kernel (interpret mode) and the port's kernel path; 8x16 tiles take
    both wrappers' plain expression.  2e-5, the reference's tolerance."""
    x, w = _normal(2, (2 * T, d)), _normal(3, (1, d))
    z = np.zeros_like(x)
    out, st = _run_port(_norm(build_rms_norm), {
        "X": to_collection(x, T, d), "W": to_collection(w, 1, d),
        "O": to_collection(z, T, d)}, "O")
    ref, _ = _run_ref(_norm(jax_build_norm), {
        "X": _jax_coll(x, T, d), "W": _jax_coll(w, 1, d),
        "O": _jax_coll(z, T, d)}, "O")
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    assert st["tasks"] == 2


def _fatt(builder):
    def build(ctx, c, dev):
        return builder(ctx, c["Q"], c["K"], c["V"], c["O"], dev=dev)
    return build


@pytest.mark.parametrize("T,L", [(128, 128), (8, 32)],
                         ids=["flash-tiles", "blockwise-tiles"])
def test_flash_attention_taskpool_matches_reference_device(T, L):
    """FATT: with T == L the chore is the flash kernel over the wave's
    lanes (the reference's Pallas kernel in interpret mode), with T != L
    the blockwise torch form (the reference's jnp form).  2e-5."""
    NQ, d = 3, 32
    q = _normal(4, (NQ * T, d))
    k, v = _normal(5, (L, d)), _normal(6, (L, d))
    z = np.zeros_like(q)
    out, st = _run_port(_fatt(build_flash_attention), {
        "Q": to_collection(q, T, d), "K": to_collection(k, L, d),
        "V": to_collection(v, L, d), "O": to_collection(z, T, d)}, "O")
    ref, _ = _run_ref(_fatt(jax_build_fatt), {
        "Q": _jax_coll(q, T, d), "K": _jax_coll(k, L, d),
        "V": _jax_coll(v, L, d), "O": _jax_coll(z, T, d)}, "O")
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    assert st["tasks"] == NQ


def test_causal_fatt_device_chore_is_refused():
    with tpt.Context(nb_workers=1) as ctx:
        dev = CudaDevice(ctx, device="cpu")
        colls = [to_collection(np.zeros((16, 8), np.float32), 16, 8)
                 for _ in range(4)]
        with pytest.raises(ValueError, match="causal"):
            build_flash_attention(ctx, *colls, causal=True, dev=dev)


def test_cuda_device_without_a_card_raises():
    """The default device is the card; with none there is no silent CPU
    run."""
    with tpt.Context(nb_workers=1) as ctx:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CudaDevice(ctx)
        assert ctx._devices == []


def _one_class(ctx, dev, kernel, dtype=np.float32):
    """X(0,0) -> Y(0,0) through one device class, then a CPU class that
    reads Y back through its host view."""
    X = to_collection(np.full((4, 4), 2.0, dtype), 4, 4, dtype)
    Y = to_collection(np.zeros((4, 4), dtype), 4, 4, dtype)
    X.register(ctx, "X")
    Y.register(ctx, "Y")
    seen = []
    tp = tpt.Taskpool(ctx)
    tc = tp.task_class("Dev")
    tc.flow("X", "READ", tpt.In(tpt.Mem("X", 0, 0)))
    tc.flow("Y", "RW", tpt.In(tpt.Mem("Y", 0, 0)),
            tpt.Out(tpt.Ref("Host", flow="Y")))
    dev.attach(tc, tp, kernel=kernel, reads=["X"], writes=["Y"],
               shapes={"X": (4, 4), "Y": (4, 4)}, dtype=dtype)
    tc.body(lambda t: t.data("Y", dtype, (4, 4)).__setitem__(
        Ellipsis, t.data("X", dtype, (4, 4)) * 3))
    host = tp.task_class("Host")
    host.flow("Y", "READ", tpt.In(tpt.Ref("Dev", flow="Y")))
    host.body(lambda t: seen.append(t.data("Y", dtype, (4, 4)).copy()))
    tp.run()
    return tp, seen


def test_cpu_chore_reads_device_result_coherently():
    with tpt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx, device="cpu")
        tp, seen = _one_class(ctx, dev, lambda x: x * 5.0)
        tp.wait()
        assert dev.stats["tasks"] == 1
        np.testing.assert_array_equal(seen[0], np.full((4, 4), 10.0))


def test_failing_kernel_fails_the_pool():
    def broken(x):
        raise RuntimeError("kernel refused")

    with tpt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx, device="cpu")
        tp, seen = _one_class(ctx, dev, broken)
        with pytest.raises(RuntimeError, match="aborted"):
            tp.wait()
        assert seen == [] and dev.stats["tasks"] == 0


def test_float64_is_refused_as_in_the_reference():
    """f64 flows stay on the host chore, counted in f64_refused."""
    with tpt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx, device="cpu")
        tp, seen = _one_class(ctx, dev, lambda x: x * 5.0, dtype=np.float64)
        tp.wait()
        assert dev.stats["f64_refused"] == 1 and dev.stats["tasks"] == 0
        np.testing.assert_array_equal(seen[0], np.full((4, 4), 6.0))


def test_writeback_lane_completes_sync_mem_out_tasks():
    with tpt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx, device="cpu")
        X = to_collection(np.full((4, 4), 1.5, np.float32), 4, 4)
        Y = to_collection(np.zeros((4, 4), np.float32), 4, 4)
        X.register(ctx, "X")
        Y.register(ctx, "Y")
        tp = tpt.Taskpool(ctx)
        tc = tp.task_class("Dev")
        tc.flow("X", "READ", tpt.In(tpt.Mem("X", 0, 0)))
        tc.flow("Y", "RW", tpt.In(tpt.Mem("Y", 0, 0)),
                tpt.Out(tpt.Mem("Y", 0, 0)))
        dev.attach(tc, tp, kernel=lambda x: x + 1.0, reads=["X"],
                   writes=["Y"], shapes={"X": (4, 4), "Y": (4, 4)},
                   sync_mem_out=True)
        tp.run()
        tp.wait()
        # coherent without a flush: the lane wrote the host copy first
        np.testing.assert_array_equal(Y.tile(0, 0), np.full((4, 4), 2.5))
        assert dev.stats["wb_tasks"] == 1
        info = dev.info()
        assert info["queue"] == dev.qid and info["platform"] == "cpu"
        assert f"queue={dev.qid}" in ctx.stats_dump()


def _port_gemm(n, mb, budget=None, nb_workers=2):
    a, b = _normal(7, (n, n)), _normal(8, (n, n))
    with tpt.Context(nb_workers=nb_workers) as ctx:
        A, B = to_collection(a, mb, mb), to_collection(b, mb, mb)
        C = to_collection(np.zeros((n, n), np.float32), mb, mb)
        for name, c in zip("ABC", (A, B, C)):
            c.register(ctx, name)
        dev = CudaDevice(ctx, device="cpu")
        if budget is not None:
            dev.set_cache_budget(budget)
        tp = build_gemm(ctx, A, B, C, dev=dev)
        tp.run()
        tp.wait()
        dev.flush()
        stats = dict(dev.stats)
        used, cap = dev.info()["cache_bytes"], dev.info()["cache_capacity"]
        dev.stop()
        return C.to_dense(), a @ b, stats, used, cap


def test_cache_budget_evicts_clean_mirrors_only():
    """A budget below the working set evicts clean input mirrors (dirty
    ones are the only copy of the truth and stay); the result holds."""
    out, ref, st, _, cap = _port_gemm(64, 16, budget=4 * 16 * 16 * 4)
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)
    assert cap == 4 * 16 * 16 * 4
    assert st["evictions"] > 0 and st["tasks"] == 64


def test_device_state_under_many_workers():
    """Stress: more workers than cores and a short switch interval, so the
    manager, the native workers and host readers interleave densely; a
    lost update would break the task count or the result."""
    import os
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out, ref, st, used, cap = _port_gemm(
            64, 8, nb_workers=min(10, (os.cpu_count() or 2) + 2))
    finally:
        sys.setswitchinterval(old)
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)
    assert st["tasks"] == 8 ** 3
    assert 0 <= used <= cap


# ------------------------------------------------ the prefetch lane's pace
def _wave_dag(ctx, dev, tiles, elems):
    """y = 2x + y over `tiles` independent tasks, each reading tile k of
    T and O; every task is ready at run()."""
    tb = elems * 4
    src = _normal(7, (tiles, elems))
    dst = np.zeros_like(src)
    ctx.register_linear_collection("T", src, elem_size=tb)
    ctx.register_linear_collection("O", dst, elem_size=tb)
    ctx.register_arena("t", tb)
    tp = tpt.Taskpool(ctx, globals={"NT": tiles - 1})
    k = tpt.L("k")
    tc = tp.task_class("Wave")
    tc.param("k", 0, tpt.G("NT"))
    tc.flow("X", "R", tpt.In(tpt.Mem("T", k)), arena="t")
    tc.flow("Y", "RW", tpt.In(tpt.Mem("O", k)), tpt.Out(tpt.Mem("O", k)),
            arena="t")
    dev.attach(tc, tp, kernel=lambda x, y: x * 2.0 + y, reads=["X", "Y"],
               writes=["Y"], shapes={"X": (elems,), "Y": (elems,)},
               dtype=np.float32)
    tp.run()
    deadline = time.monotonic() + 20.0
    while ctx.device_queue_depth(dev.qid) < tiles:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    return tp, src, dst


def test_prefetch_lane_stages_past_a_staged_head():
    """Two staging slots keep two waves staged beyond the one running.
    Once the manager has run the first staged wave, one sweep stages the
    wave after the next, while the next (staged, not yet popped) still
    heads the queue.  A lane that counted its budget from the head staged
    nothing there, and under load the manager popped waves it had not
    staged."""
    from parsec_tpu_torch.device.prefetch import _PrefetchLane
    with tpt.Context(nb_workers=1) as ctx:
        dev = CudaDevice(ctx, device="cpu", autostart=False, prefetch=True)
        dev.batch_max = 4
        tp, src, dst = _wave_dag(ctx, dev, 16, 1024)
        lane = _PrefetchLane(dev, depth=64, slots=2)
        assert lane._sweep()  # waves 1 and 2
        assert dev.stats["prefetch_staged"] == 16
        # the manager's part for wave 1: pop it and run it, its stage-in
        # consuming the first slot's tiles
        wave = [ctx.device_pop(dev.qid, timeout_ms=0) for _ in range(4)]
        dev._dispatch_group(dev._body_for(wave[0]), wave)
        assert dev.stats["prefetch_hits"] == 8
        assert lane._free_slots() == 1
        assert lane._sweep()  # wave 3, past wave 2 at the head
        assert dev.stats["prefetch_staged"] == 24
        assert lane._free_slots() == 0
        dev.start()
        tp.wait()
        dev.flush()
        # waves 1-3 hit as staged here (the started lane may stage 4)
        assert dev.stats["prefetch_hits"] >= 24
        dev.stop()
    np.testing.assert_array_equal(dst, src * 2.0)


def test_manager_hands_off_to_the_lane_after_a_wave_while_tasks_stay_queued(
        monkeypatch):
    """After each wave it runs while tasks stay queued, the manager hands
    the interpreter to the lane (handoff: wake it, wait for its pass):
    the lane, a Python thread, otherwise gets the interpreter lock back
    only at the 5 ms forced switch while the manager is busy, longer than
    a run of 1 ms waves on the CPU.  Four waves queued before the start:
    three handoffs, none after the last."""
    from parsec_tpu_torch.device import cuda as cuda_mod
    handoffs = []

    class IdleLane:  # a lane that never sweeps: only the manager's calls
        def __init__(self, dev, **kw):
            self.dev = dev

        def start(self):
            pass

        def stop(self):
            pass

        def handoff(self):
            handoffs.append(self.dev.ctx.device_queue_depth(self.dev.qid))

    monkeypatch.setattr(cuda_mod, "_PrefetchLane", IdleLane)
    with tpt.Context(nb_workers=1) as ctx:
        dev = CudaDevice(ctx, device="cpu", autostart=False, prefetch=True)
        dev.batch_max = 4
        tp, src, dst = _wave_dag(ctx, dev, 16, 1024)
        dev.start()
        tp.wait()
        dev.flush()
        assert dev.stats["batches"] == 4
        dev.stop()
    assert handoffs == [12, 8, 4]  # the queue's depth at each
    np.testing.assert_array_equal(dst, src * 2.0)


# ------------------------------------------- a pool's record and its end
def _spd_tiles(ctx, name, n=512, nb=64, seed=0):
    """An SPD matrix in nb x nb tiles, registered as `name`, and the
    float64 matrix its float32 tiles were rounded from."""
    x = np.random.default_rng(seed).standard_normal((n, n))
    s = x @ x.T + n * np.eye(n)
    A = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32)
    A.from_dense(s.astype(np.float32))
    A.register(ctx, name)
    return A, s


def test_a_destroyed_pool_leaves_nothing_on_the_device():
    """Six solves, each a new build_potrf pool (N 512, NB 64) run, waited
    and destroyed: after each the device holds no record, and every pool
    is freed (the manager's last front may hold a body for a moment);
    the certificate cache serves the five pools after the first."""
    refs = []
    with tpt.Context(nb_workers=2) as ctx:
        A, _ = _spd_tiles(ctx, "A")
        dev = CudaDevice(ctx, device="cpu")
        dev.batch_wait_ms = 2.0
        for _ in range(6):
            tp = build_potrf(ctx, A, dev=dev)
            tp.run()
            tp.wait()
            tp.destroy()
            refs.append(weakref.ref(tp))
            assert dev._pools == {}
            assert dev.info()["attached_classes"] == 0
        del tp
        deadline = time.monotonic() + 10.0
        while any(r() is not None for r in refs):
            assert time.monotonic() < deadline, [r() is None for r in refs]
            gc.collect()
            time.sleep(0.01)
        fz = dev.info()["fuse"]
        dev.stop()
    assert (fz["cert_hits"], fz["cert_misses"]) == (5, 1), fz


def test_a_pool_on_a_reused_pointer_runs_on_its_own_record(record_property):
    """A pool destroyed, then one of another structure (the textbook TRSM
    dataflow, over another matrix): the second may get the first's native
    pointer (recorded as pointer_reused); either way its record is new,
    holds its own bodies, and certifies it afresh, and its factor is the
    float64 one's."""
    with tpt.Context(nb_workers=2) as ctx:
        A, _ = _spd_tiles(ctx, "A")
        B, s = _spd_tiles(ctx, "B", seed=1)
        dev = CudaDevice(ctx, device="cpu")
        dev.batch_wait_ms = 2.0
        first = build_potrf(ctx, A, dev=dev)
        first.run()
        first.wait()
        ptr = first._ptr
        first.destroy()
        tp = build_potrf(ctx, B, dev=dev, name="B", trsm_via_inverse=False)
        record_property("pointer_reused", tp._ptr == ptr)
        rec = dev._pools[tp._ptr]
        assert list(dev._pools) == [tp._ptr]
        assert rec.tp is tp and rec.cert is None
        assert {b.tc for b in rec.bodies.values()} <= set(tp.classes)
        tp.run()
        tp.wait()
        dev.flush()
        gemm = next(b for b in rec.bodies.values() if b.tc.name == "GEMM")
        st = dev._fuser._state_for(gemm)
        assert st is rec.cert
        assert st["links"] == chain_certificates(tp).chain_index(0)["links"]
        fz = dev.info()["fuse"]
        out = np.tril(B.to_dense())
        tp.destroy()
        dev.stop()
    assert (fz["cert_hits"], fz["cert_misses"]) == (0, 2), fz
    np.testing.assert_allclose(out, np.linalg.cholesky(s), rtol=1e-4,
                               atol=1e-4)


def test_destroy_drops_the_pools_parked_results():
    """Parked chain results whose consumers never popped here (as when
    they ran on a sibling device), their pending checks and a parked
    epilogue result, filed by hand under two live pools as the wave
    compiler and the epilogue file them: each pool's destroy() drops its
    own, counted as chain_drops, their pins leaving _chain_pinned."""
    with tpt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx, device="cpu")
        fz = dev._fuser
        pools = [build_potrf(ctx, _spd_tiles(ctx, name, 128, 32, i)[0],
                             dev=dev, name=name)
                 for i, name in enumerate("AB")]
        for tp in pools:
            tp.run()
            tp.wait()
        row = torch.zeros(1, 32, 32)
        for tp in pools:
            key, cid = tp._ptr, tp.class_by_name("GEMM").id
            with dev._lock:
                for j in range(3):
                    fz._parked[(key, cid, (j, 0, 0))] = {
                        "outs": {"C": (row, 0)}, "event": None,
                        "pin": row.nbytes, "checks": {},
                        "pending": {"C": True}}
                    fz._parked_classes[(key, cid)] = \
                        fz._parked_classes.get((key, cid), 0) + 1
                    dev._chain_pinned += row.nbytes
            fz._pending[(key, "GEMM", (0, 0, 0), "C")] = [
                ((key, cid, (1, 0, 0)), "C")]
            dev._spec[((key, cid), (1,))] = ((row,), 0, 0)
        drops = fz.stats["chain_drops"]
        pools[0].destroy()
        b = pools[1]._ptr
        assert fz.stats["chain_drops"] == drops + 3
        assert dev._chain_pinned == 3 * row.nbytes
        assert {k[0] for k in fz._parked} == {b} and len(fz._parked) == 3
        assert [k[0] for k in fz._parked_classes] == [b]
        assert [k[0] for k in fz._pending] == [b]
        assert [k[0][0] for k in dev._spec] == [b]
        assert list(dev._pools) == [b]
        pools[1].destroy()
        assert fz.stats["chain_drops"] == drops + 6
        assert dev._chain_pinned == 0
        assert not (fz._parked or fz._parked_classes or fz._pending)
        assert not (dev._spec or dev._pools)
        assert dev.info()["fuse"]["parked"] == 0
        dev.stop()
