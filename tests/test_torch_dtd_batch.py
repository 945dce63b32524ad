"""DTD lane batching in the device manager (parsec_tpu_torch/device/cuda.py):
ready DTD device tasks of one signature run as one torch.func.vmap launch
of their single-tile kernel, on CudaDevice(ctx, device="cpu")."""
import time

import numpy as np
import pytest
import torch

import parsec_tpu_torch as tpt
from parsec_tpu_torch.data import TwoDimBlockCyclic
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.device import cuda as tcuda
from parsec_tpu_torch.dsl.dtd import DtdTaskpool


def k_gemm(a, b, c):
    return c + a @ b


def _colls(ctx, n, nb, rng):
    """A, B standard normal and C zero, n x n in nb x nb tiles."""
    out = []
    for name in "ABC":
        c = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32)
        c.from_dense(np.zeros((n, n), np.float32) if name == "C" else
                     rng.standard_normal((n, n)).astype(np.float32))
        c.register(ctx, name)
        out.append(c)
    return out


def _insert_gemm(dtd, dev, kernel, a, b, c, nb):
    nt = a.mt
    shapes = {i: (nb, nb) for i in range(3)}
    for m in range(nt):
        for n in range(nt):
            for k in range(nt):
                dtd.insert_cuda_task(
                    dev, kernel, (dtd.tile_of(a, m, k), "INPUT"),
                    (dtd.tile_of(b, k, n), "INPUT"),
                    (dtd.tile_of(c, m, n), "INOUT"), shapes=shapes)
    return nt ** 3


def _launches(dev) -> int:
    return sum(rec[0] for rec in dev.launches.values())


def _c_err(a, b, c) -> float:
    ref = a.to_dense().astype(np.float64) @ b.to_dense().astype(np.float64)
    return float(np.linalg.norm(c.to_dense() - ref) / np.linalg.norm(ref))


def _queued(ctx, dev, n, timeout=30.0) -> None:
    """Wait until `n` tasks sit on the unstarted device's queue, so that
    its first drain pops them as one front."""
    end = time.monotonic() + timeout
    while ctx.device_queue_depth(dev.qid) < n:
        assert time.monotonic() < end, ctx.device_queue_depth(dev.qid)
        time.sleep(0.005)


@pytest.fixture
def vmap_calls(monkeypatch):
    """Every torch.func.vmap call the device makes: (kernel name, in_dims,
    lanes)."""
    calls = []
    orig = torch.func.vmap

    def spy(kernel, in_dims=0, **kw):
        f = orig(kernel, in_dims=in_dims, **kw)

        def run(*args):
            lanes = next(a.shape[0] for a, d in zip(args, in_dims)
                         if d == 0)
            calls.append((kernel.__name__, in_dims, lanes))
            return f(*args)
        return run
    monkeypatch.setattr(torch.func, "vmap", spy)
    return calls


def test_dtd_gemm_runs_as_lane_batched_launches():
    """DTD GEMM at N 512, NB 64: C = A @ B within 1e-4, most tasks run as
    lanes of a shared launch, there are fewer launches than tasks, and
    the wave compiler counts no refusal."""
    with tpt.Context(nb_workers=2) as ctx:
        a, b, c = _colls(ctx, 512, 64, np.random.default_rng(0))
        dev = CudaDevice(ctx, device="cpu")
        dtd = DtdTaskpool(ctx)
        tasks = _insert_gemm(dtd, dev, k_gemm, a, b, c, 64)
        dtd.wait()
        dev.flush()
        st = dict(dev.stats)
        fuse = dev.info()["fuse"]
        launches = _launches(dev)
        rec = dev._pools[dtd.tp._ptr]
        assert rec.dtd_tags == {} and rec.dtd_sigs == {}
        dev.stop()
        assert _c_err(a, b, c) < 1e-4
        dtd.destroy()
    assert st["tasks"] == tasks == 512
    assert st["dtd_batched_tasks"] > 0 and st["dtd_batches"] > 0
    assert launches < tasks
    assert launches == st["dtd_batches"] + tasks - st["dtd_batched_tasks"]
    assert st["dtd_unbatchable"] == 0 and st["dtd_splits"] == 0
    # the wave compiler's counters stay PTG's: no DTD front is a wave
    assert fuse["enabled"] and fuse["refused"] == {}
    assert fuse["fused_waves"] == 0


def test_a_kernel_vmap_refuses_runs_one_launch_a_task():
    """A kernel calling .item() gives the same C, one launch a task, after
    one refused attempt that is counted once."""
    def k_item(a, b, c):
        return c + a @ b * (1.0 + 0.0 * float(a.sum().item()))

    with tpt.Context(nb_workers=2) as ctx:
        a, b, c = _colls(ctx, 128, 32, np.random.default_rng(1))
        dev = CudaDevice(ctx, device="cpu", autostart=False)
        dtd = DtdTaskpool(ctx)
        tasks = _insert_gemm(dtd, dev, k_item, a, b, c, 32)
        _queued(ctx, dev, 16)  # the k = 0 task of every C tile
        dev.start()
        dtd.wait()
        dev.flush()
        st = dict(dev.stats)
        launches = _launches(dev)
        dev.stop()
        assert _c_err(a, b, c) < 1e-4
        dtd.destroy()
    assert st["dtd_unbatchable"] == 1
    assert st["dtd_batched_tasks"] == 0
    assert launches == st["tasks"] == tasks


@pytest.mark.parametrize("kind", ["two_kernels", "two_shapes"])
def test_tasks_of_two_signatures_in_one_front_never_share_a_launch(
        kind, vmap_calls):
    """Tasks of two kernels (or of one kernel at two tile shapes),
    inserted in turn and popped as one front, run as two launches, each
    of one signature; the wave compiler's refusals stay unchanged."""
    def k_add(x):
        return x + 1

    def k_mul(x):
        return x * 2

    n = 8
    with tpt.Context(nb_workers=2) as ctx:
        xs = [np.full(8, i, np.float32) for i in range(n)]
        ys = [np.full(8 if kind == "two_kernels" else 4, 10 + i, np.float32)
              for i in range(n)]
        dev = CudaDevice(ctx, device="cpu", autostart=False)
        refused = dict(dev.info()["fuse"]["refused"])
        dtd = DtdTaskpool(ctx)
        k2 = k_mul if kind == "two_kernels" else k_add
        for i in range(n):
            dtd.insert_cuda_task(dev, k_add,
                                 (dtd.tile_of(ctx.data(i, xs[i])), "INOUT"),
                                 shapes={0: (8,)})
            dtd.insert_cuda_task(dev, k2,
                                 (dtd.tile_of(ctx.data(n + i, ys[i])),
                                  "INOUT"), shapes={0: ys[i].shape})
        _queued(ctx, dev, 2 * n)
        dev.start()
        dtd.wait()
        dev.flush()
        fuse = dev.info()["fuse"]
        dev.stop()
        dtd.destroy()
    assert sorted(vmap_calls) == sorted(
        [("k_add", (0,), n), (k2.__name__, (0,), n)])
    for i in range(n):
        np.testing.assert_array_equal(xs[i], np.full(8, i + 1, np.float32))
        want = (10 + i) * 2 if kind == "two_kernels" else 10 + i + 1
        np.testing.assert_array_equal(ys[i], np.full(ys[i].shape, want,
                                                     np.float32))
    assert fuse["enabled"] and fuse["refused"] == refused


def test_a_tile_every_lane_reads_goes_in_once(vmap_calls):
    """O(r) = X(r) * W for every row tile r, W shared: one launch whose
    W flow is one tile at lane stride 0, passed to vmap unbatched."""
    def k_scale(x, w):
        return x * w

    rows, d = 6, 16
    rng = np.random.default_rng(2)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    with tpt.Context(nb_workers=2) as ctx:
        xs = [x[r].copy() for r in range(rows)]
        wd = ctx.data(rows, w.copy())
        dev = CudaDevice(ctx, device="cpu", autostart=False)
        dtd = DtdTaskpool(ctx)
        for r in range(rows):
            dtd.insert_cuda_task(dev, k_scale,
                                 (dtd.tile_of(ctx.data(r, xs[r])), "INOUT"),
                                 (dtd.tile_of(wd), "INPUT"),
                                 shapes={0: (d,), 1: (d,)})
        _queued(ctx, dev, rows)
        dev.start()
        dtd.wait()
        dev.flush()
        st = dict(dev.stats)
        dev.stop()
        dtd.destroy()
    assert vmap_calls == [("k_scale", (0, None), rows)]
    assert st["fused_flows"] >= 1 and st["dtd_batched_tasks"] == rows
    np.testing.assert_allclose(np.stack(xs), x * w, rtol=1e-6)


def test_readers_and_writers_of_one_tile_keep_the_serial_order():
    """W1: T += 1; R_i: O_i += T; W2: T *= 2; R_i: O_i += T, inserted in
    that order: the readers of each version run as one launch, and every
    result equals the serial order's."""
    def k_inc(t):
        return t + 1

    def k_dbl(t):
        return t * 2

    def k_acc(t, o):
        return o + t

    n = 5
    with tpt.Context(nb_workers=2) as ctx:
        t = np.full(4, 3.0, np.float32)
        os_ = [np.full(4, float(i), np.float32) for i in range(n)]
        dev = CudaDevice(ctx, device="cpu", autostart=False)
        dtd = DtdTaskpool(ctx)
        tt = dtd.tile_of(ctx.data(0, t))
        ot = [dtd.tile_of(ctx.data(1 + i, os_[i])) for i in range(n)]
        shapes = {0: (4,), 1: (4,)}
        for writer in (k_inc, k_dbl):
            dtd.insert_cuda_task(dev, writer, (tt, "INOUT"), shapes=shapes)
            for i in range(n):
                dtd.insert_cuda_task(dev, k_acc, (tt, "INPUT"),
                                     (ot[i], "INOUT"), shapes=shapes)
        dev.start()
        dtd.wait()
        dev.flush()
        st = dict(dev.stats)
        dev.stop()
        dtd.destroy()
    t1 = 3.0 + 1
    t2 = t1 * 2
    np.testing.assert_array_equal(t, np.full(4, t2, np.float32))
    for i in range(n):
        np.testing.assert_array_equal(os_[i], np.full(4, i + t1 + t2,
                                                      np.float32))
    assert st["dtd_batched_tasks"] == 2 * n and st["dtd_batches"] == 2
    assert st["dtd_splits"] == 0


@pytest.mark.parametrize("lanes, runs", [
    ([({1}, {2}), ({1}, {3}), ({4}, {5})], [3]),         # shared reads
    ([({1}, {2}), ({2}, {3})], [1, 1]),                  # reads a write
    ([({1}, {2}), ({3}, {2})], [1, 1]),                  # two writers
    # the third writes what the first reads
    ([({1}, {2}), ({4}, {5}), ({6}, {1}), ({2}, {7})], [2, 2]),
    ([({1}, {1}), ({2}, {2}), ({1}, {1})], [2, 1]),      # INOUT chains
])
def test_a_group_that_touches_a_written_copy_splits_in_pop_order(lanes,
                                                                 runs):
    assert tcuda._independent_runs(lanes) == runs


def test_a_raising_kernel_still_fails_the_pool():
    """A kernel that raises on every tile: the vmapped attempt is
    counted as unbatchable, each task then fails alone, and the pool
    fails; no body is left behind."""
    def k_bad(x):
        raise ValueError("bad tile")

    with tpt.Context(nb_workers=2) as ctx:
        bufs = [np.zeros(8, np.float32) for _ in range(4)]
        dev = CudaDevice(ctx, device="cpu", autostart=False)
        dtd = DtdTaskpool(ctx)
        for i, buf in enumerate(bufs):
            dtd.insert_cuda_task(dev, k_bad,
                                 (dtd.tile_of(ctx.data(i, buf)), "INOUT"),
                                 shapes={0: (8,)})
        _queued(ctx, dev, len(bufs))
        dev.start()
        with pytest.raises(RuntimeError, match="aborted"):
            dtd.wait()
        st = dict(dev.stats)
        assert dtd.tp.nb_errors > 0
        rec = dev._pools[dtd.tp._ptr]
        assert rec.dtd_tags == {} and rec.dtd_sigs == {}
        dev.stop()
        dtd.destroy()
    assert st["dtd_unbatchable"] == 1
    assert st["tasks"] == 0 and st["dtd_batched_tasks"] == 0
    for buf in bufs:
        np.testing.assert_array_equal(buf, np.zeros(8, np.float32))
