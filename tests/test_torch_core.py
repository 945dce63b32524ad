"""The rest of the port's one-rank runtime held against parsec_tpu on the
same inputs: futures, compose and recursive tasks, the Context's
scheduler and device-routing probes, the remaining collections, the
matrix ops, redistribute and reshape, and the local reshape matrix.

Each scenario is written once, as a function of a namespace of one
package's entry points, runs on both packages in this process (the same
numpy inputs, seeded), and returns what it observed; the test asserts
the reference's own checks on each and holds the two equal.  Host and
integer DAGs, collections and redistribute compare bit for bit; device
DAGs run on the reference's TpuDevice on JAX's CPU platform and on
CudaDevice(ctx, device="cpu") (the kernels' plain versions), at the
tolerance the reference's own tests use, stated beside each check.  The
scenarios mirror tests/runtime/test_future.py, test_compose_recursive.py,
test_reshape_matrix.py, test_vpmap.py, test_deptable.py,
tests/device/test_load_balance.py, test_affinity.py,
tests/algos/test_matrix_ops.py, test_reshape.py,
tests/data/test_band_redistribute.py and tests/apps/test_miniapps.py."""
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import parsec_tpu as jpt
import parsec_tpu._native as jN
import parsec_tpu.dsl.dtd as jdtd
import parsec_tpu_torch as tpt
import parsec_tpu_torch._native as tN
import parsec_tpu_torch.dsl.dtd as tdtd
from parsec_tpu import algos as jalgos
from parsec_tpu import data as jdata
from parsec_tpu.device import TpuDevice
from parsec_tpu_torch import algos as talgos
from parsec_tpu_torch import data as tdata
from parsec_tpu_torch.device import CudaDevice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_device(ctx, index=0, **kw):
    return TpuDevice(ctx, jax_device=jax.devices()[index], **kw)


def _port_device(ctx, index=0, **kw):
    return CudaDevice(ctx, device="cpu", **kw)


REF = SimpleNamespace(name="ref", pt=jpt, N=jN, dtd=jdtd, data=jdata,
                      algos=jalgos, device=_ref_device, module="parsec_tpu")
PORT = SimpleNamespace(name="port", pt=tpt, N=tN, dtd=tdtd, data=tdata,
                       algos=talgos, device=_port_device,
                       module="parsec_tpu_torch")


def both(scenario, *args):
    """The scenario's observations on the reference and on the port."""
    return scenario(REF, *args), scenario(PORT, *args)


def same(scenario, *args):
    """Run on both packages; the two observations must be equal."""
    ref, port = both(scenario, *args)
    assert port == ref, (ref, port)
    return port


# ------------------------------------------------------------- futures
def fut_set_get(P):
    f = P.pt.Future()
    obs = [f.is_ready()]
    f.set(42)
    obs += [f.is_ready(), f.get()]
    with pytest.raises(RuntimeError):
        f.set(43)
    return obs


def fut_blocking_get_across_threads(P):
    f = P.pt.Future()
    got = []
    t = threading.Thread(target=lambda: got.append(f.get(timeout=5)))
    t.start()
    time.sleep(0.05)
    f.set("x")
    t.join()
    return got


def fut_timeout(P):
    with pytest.raises(TimeoutError):
        P.pt.Future().get(timeout=0.05)
    return True


def fut_exception_propagates(P):
    f = P.pt.Future()
    f.set_exception(ValueError("boom"))
    with pytest.raises(ValueError, match="boom"):
        f.get()
    return True


def fut_on_ready_before_and_after(P):
    f = P.pt.Future()
    order = []
    f.on_ready(lambda fu: order.append(("early", fu.get())))
    f.set(1)
    f.on_ready(lambda fu: order.append(("late", fu.get())))
    return order


def fut_countable(P):
    f = P.pt.CountableFuture(3)
    f.advance("a")
    f.advance("b")
    ready = f.is_ready()
    f.advance("c")
    return ready, f.get()


def fut_triggered_fires_once_concurrently(P):
    fired, lock = [], threading.Lock()

    def trigger():
        with lock:
            fired.append(1)
        time.sleep(0.02)
        return np.arange(4)

    f = P.pt.TriggeredFuture(trigger)
    results, rl = [], threading.Lock()

    def getter():
        v = f.get(timeout=5)
        with rl:
            results.append(v)

    ts = [threading.Thread(target=getter) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    # the SAME materialized value, shared by every consumer
    return len(fired), len(results), all(r is results[0] for r in results)


def fut_triggered_failure_shared(P):
    def trigger():
        raise RuntimeError("conversion failed")

    f = P.pt.TriggeredFuture(trigger)
    for _ in range(2):  # the failure is memoized, not fired again
        with pytest.raises(RuntimeError, match="conversion failed"):
            f.get(timeout=1)
    return True


def fut_body_coordination(P):
    pt = P.pt
    f = pt.Future()
    got = []
    with pt.Context(nb_workers=2) as ctx:
        tp = pt.Taskpool(ctx)
        a = tp.task_class("A")
        a.flow("X", "CTL", pt.Out(pt.Ref("B", flow="X")))
        a.body(lambda t: f.set(7))
        b = tp.task_class("B")
        b.flow("X", "CTL", pt.In(pt.Ref("A", flow="X")))
        b.body(lambda t: got.append(f.get(timeout=5)))
        tp.run()
        tp.wait()
    return got


FUTURES = {
    fut_set_get: [False, True, 42],
    fut_blocking_get_across_threads: ["x"],
    fut_timeout: True,
    fut_exception_propagates: True,
    fut_on_ready_before_and_after: [("early", 1), ("late", 1)],
    fut_countable: (False, ["a", "b", "c"]),
    fut_triggered_fires_once_concurrently: (1, 8, True),
    fut_triggered_failure_shared: True,
    fut_body_coordination: [7],
}


@pytest.mark.parametrize("scenario", list(FUTURES),
                         ids=lambda f: f.__name__)
def test_future(scenario):
    assert same(scenario) == FUTURES[scenario]


# --------------------------------------------- compose, recursive tasks
def _chain_pool(P, ctx, buf, start, count, scale):
    """count tasks appending scaled indices to buf sequentially."""
    pt = P.pt
    tp = pt.Taskpool(ctx, globals={"NB": count - 1})
    k = pt.L("k")
    tc = tp.task_class("T")
    tc.param("k", 0, pt.G("NB"))
    tc.flow("A", "RW",
            pt.In(None, guard=(k == 0)),
            pt.In(pt.Ref("T", k - 1, flow="A")),
            pt.Out(pt.Ref("T", k + 1, flow="A"), guard=(k < pt.G("NB"))),
            arena="t")

    def body(t, base=start):
        buf.append(base + t.local("k") * scale)

    tc.body(body)
    return tp


def compose_sequential_order(P):
    with P.pt.Context(nb_workers=2) as ctx:
        ctx.register_arena("t", 8)
        log = []
        c = P.pt.compose(*[_chain_pool(P, ctx, log, i * 100, 5, 1)
                           for i in range(3)])
        c.run()
        c.wait()
    # all of pool i precedes all of pool i+1
    return log, c.nb_total_tasks


def compose_context_wait_blocks_across_seams(P):
    with P.pt.Context(nb_workers=2) as ctx:
        ctx.register_arena("t", 8)
        log = []
        P.pt.compose(*[_chain_pool(P, ctx, log, i * 100, 4, 1)
                       for i in range(2)]).run()
        ctx.wait()  # returns only when ALL pools are done
        return len(log)


def compose_then(P):
    with P.pt.Context(nb_workers=1) as ctx:
        ctx.register_arena("t", 8)
        log = []
        c = P.pt.compose(_chain_pool(P, ctx, log, 0, 2, 1))
        c.then(_chain_pool(P, ctx, log, 10, 2, 1))
        c.run()
        c.wait()
    return log


def compose_failure_stops_chain(P):
    pt = P.pt
    with pt.Context(nb_workers=1) as ctx:
        ctx.register_arena("t", 8)
        log = []
        bad = pt.Taskpool(ctx, globals={})
        btc = bad.task_class("BAD")
        btc.param("k", 0, 0)

        def boom(t):
            raise RuntimeError("intentional")

        btc.body(boom)
        c = pt.compose(bad, _chain_pool(P, ctx, log, 0, 3, 1))
        c.run()
        with pytest.raises(RuntimeError, match="compound aborted"):
            c.wait()
        return log  # the second pool never started


def recursive_inner_failure_fails_outer(P):
    pt = P.pt
    with pt.Context(nb_workers=2) as ctx:
        tp = pt.Taskpool(ctx, globals={})
        tc = tp.task_class("ROOT")
        tc.param("k", 0, 0)

        def make_bad():
            inner = pt.Taskpool(ctx, globals={})
            itc = inner.task_class("BAD")
            itc.param("k", 0, 0)

            def boom(t):
                raise RuntimeError("inner failure")

            itc.body(boom)
            return inner

        wrote = []
        tc.body(lambda t: pt.recursive_call(
            t, make_bad(), on_done=lambda: wrote.append(1)))
        tp.run()
        with pytest.raises(RuntimeError):
            tp.wait()
        return wrote  # on_done (a writeback) must NOT run


def recursive_two_levels(P):
    pt = P.pt
    with pt.Context(nb_workers=2) as ctx:
        ctx.register_arena("t", 8)
        log = []

        def leaf_pool():
            tp = pt.Taskpool(ctx, globals={})
            tc = tp.task_class("LEAF")
            tc.param("k", 0, 2)
            tc.body(lambda t: log.append(("leaf", t.local("k"))))
            return tp

        def mid_pool():
            tp = pt.Taskpool(ctx, globals={})
            tc = tp.task_class("MID")
            tc.param("k", 0, 0)
            tc.body(lambda t: pt.recursive_call(t, leaf_pool()))
            return tp

        tp = pt.Taskpool(ctx, globals={})
        tc = tp.task_class("ROOT")
        tc.param("k", 0, 0)
        tc.body(lambda t: pt.recursive_call(
            t, mid_pool(), on_done=lambda: log.append("mid-done")))
        tp.run()
        tp.wait()
    return sorted(x for x in log if x != "mid-done"), "mid-done" in log


def sym_band_dense_roundtrip(P):
    M = np.arange(32 * 32, dtype=np.float32).reshape(32, 32)
    out = []
    for cls in (P.data.SymTwoDimBlockCyclic,
                P.data.SymTwoDimBlockCyclicBand):
        S = cls(32, 32, 16, 16, uplo="lower")
        S.from_dense(M)
        got = S.to_dense()
        # lower triangle (by tiles) round-trips; strict-upper tiles zero
        np.testing.assert_array_equal(got[16:, :], M[16:, :])
        np.testing.assert_array_equal(got[:16, :16], M[:16, :16])
        assert got[:16, 16:].sum() == 0.0
        out.append(got.tobytes())
    return out


def redistribute_without_register(P):
    with P.pt.Context(nb_workers=1) as ctx:
        S = P.data.TwoDimBlockCyclic(32, 32, 16, 16, dtype=np.float32)
        S.from_dense(np.ones((32, 32), np.float32))
        D = P.data.TwoDimBlockCyclic(32, 32, 16, 16, dtype=np.float32)
        P.algos.redistribute(ctx, S, D, 32, 32)
        got = D.to_dense()
    np.testing.assert_array_equal(got, np.ones((32, 32), np.float32))
    return got.tobytes()


COMPOSE = {
    compose_sequential_order: (sorted(i * 100 + k for i in range(3)
                                      for k in range(5)), 15),
    compose_context_wait_blocks_across_seams: 8,
    compose_then: [0, 1, 10, 11],
    compose_failure_stops_chain: [],
    recursive_inner_failure_fails_outer: [],
    recursive_two_levels: ([("leaf", 0), ("leaf", 1), ("leaf", 2)], True),
    sym_band_dense_roundtrip: None,
    redistribute_without_register: None,
}


@pytest.mark.parametrize("scenario", list(COMPOSE), ids=lambda f: f.__name__)
def test_compose_recursive(scenario):
    got = same(scenario)
    if COMPOSE[scenario] is not None:
        assert got == COMPOSE[scenario]


def _spd(n, seed=3):
    x = np.random.default_rng(seed).standard_normal((n, n))
    return (x @ x.T + n * np.eye(n)).astype(np.float32)


def nested_potrf(P, on_device):
    """A coarse-tile Cholesky whose one diagonal factorization recurses
    into a nested potrf taskpool over 8x8 sub-tiles (the reference's
    PARSEC_DEV_RECURSIVE pattern); with on_device the inner chores run on
    a device.  Returns the lower triangle of the result and the thread
    the inner pool's completion (the writeback) ran on."""
    pt = P.pt
    n = 32
    M = _spd(n)
    where = []
    with pt.Context(nb_workers=2) as ctx:
        dev = P.device(ctx) if on_device else None
        A = P.data.TwoDimBlockCyclic(n, n, n, n, dtype=np.float32)
        A.from_dense(M)
        A.register(ctx, "A")
        tp = pt.Taskpool(ctx, globals={})
        tc = tp.task_class("FACTOR")
        tc.param("k", 0, 0)
        tc.affinity("A", pt.L("k"), pt.L("k"))
        tc.flow("T", "RW", pt.In(pt.Mem("A", pt.L("k"), pt.L("k"))),
                pt.Out(pt.Mem("A", pt.L("k"), pt.L("k"))))

        def body(t):
            tile = t.data("T", np.float32, (n, n))
            sub = P.data.SubtileView(tile, 8, 8)
            sub.register(ctx, "SUB")
            inner = P.algos.build_potrf(ctx, sub, dev, name="SUB")

            def on_done():
                where.append(threading.current_thread().name)
                sub.writeback()

            return pt.recursive_call(t, inner, on_done=on_done)

        tc.body(body)
        tp.run()
        tp.wait()
        if dev is not None:
            dev.stop()
        got = np.tril(A.to_dense())
    return got, M, where


def test_recursive_task_nested_potrf():
    """Host chores: both packages factor the tile the same, bit for bit,
    within the reference test's 2e-2 of numpy's float64 Cholesky."""
    (ref, M, _), (port, _, _) = both(nested_potrf, False)
    want = np.linalg.cholesky(M.astype(np.float64))
    np.testing.assert_allclose(ref, want, rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(port, ref)


def test_recursive_nested_potrf_over_a_device():
    """The inner chores on a device.  The reference's SubtileView.writeback
    reads the sub-tiles' host arrays while the factors are still dirty
    device mirrors, so the parent tile gets back its INPUT, unchanged
    (recorded in ROADMAP Queue C: the reference is wrong here).  The
    port's writeback pulls each sub-tile's mirror first, on the thread
    that runs the inner pool's completion — the device's manager — and
    gives the factor, within the reference test's 2e-2 of numpy's float64
    Cholesky."""
    (ref, M, _), (port, _, where) = both(nested_potrf, True)
    np.testing.assert_array_equal(ref, np.tril(M))  # stale: the input
    want = np.linalg.cholesky(M.astype(np.float64))
    np.testing.assert_allclose(port, want, rtol=2e-2, atol=2e-2)
    assert where == ["ptc-cuda-manager"], where


# -------------------------------------------- the local reshape matrix
RN = 8  # tile side (ints)


def lower_segments(n, itemsize=4):
    """Row-major lower triangle incl. diagonal as (offset, len) bytes."""
    return [(i * n * itemsize, (i + 1) * itemsize) for i in range(n)]


def upper_segments(n, itemsize=4):
    return [((i * n + i) * itemsize, (n - i) * itemsize) for i in range(n)]


def _reshape_chain(P, ctx, tile, read_out_ltype=None, zero_in_ltype=None,
                   write_back_ltype=None, zero_out_ltype=None,
                   capture=None):
    """READ_A -> SET_ZEROS -> WRITE_A over one tile."""
    pt = P.pt
    ctx.register_linear_collection("descA", tile, elem_size=tile.nbytes)
    tp = pt.Taskpool(ctx)
    read = tp.task_class("READ_A")
    read.flow("A", "RW",
              pt.In(pt.Mem("descA", 0)),
              pt.Out(pt.Ref("SET_ZEROS", flow="A"), ltype=read_out_ltype))
    read.body(lambda t: None)
    zeros = tp.task_class("SET_ZEROS")
    zeros.flow("A", "RW",
               pt.In(pt.Ref("READ_A", flow="A"), ltype=zero_in_ltype),
               pt.Out(pt.Ref("WRITE_A", flow="A"), ltype=zero_out_ltype))

    def zbody(t):
        if capture is not None:
            capture.append(t.data_ptr("A"))
        t.data("A", np.int32)[:] = 0

    zeros.body(zbody)
    write = tp.task_class("WRITE_A")
    write.flow("A", "RW",
               pt.In(pt.Ref("SET_ZEROS", flow="A")),
               pt.Out(pt.Mem("descA", 0), ltype=write_back_ltype))
    write.body(lambda t: None)
    tp.run()
    tp.wait()


def _chain_case(P, types, chain_kw, tile=None):
    tile = np.ones((RN, RN), dtype=np.int32) if tile is None else tile
    ptrs = []
    with P.pt.Context(nb_workers=2) as ctx:
        for name, kind in types:
            if kind == "colT":
                ctx.register_datatype(name, 4, RN, RN * 4)
            elif kind == "full":
                ctx.register_datatype_indexed(name, [(0, tile.nbytes)])
            else:
                ctx.register_datatype_indexed(
                    name, (lower_segments if kind == "lower"
                           else upper_segments)(RN))
        _reshape_chain(P, ctx, tile, capture=ptrs, **chain_kw)
        conv, hits = ctx.reshape_stats()
    return tile.tobytes(), conv, hits > 0, ptrs[0] == tile.ctypes.data


def reshape_local_no_reshape(P):
    return _chain_case(P, [("colT", "colT")], {})


def reshape_local_input(P):
    return _chain_case(P, [("LOWER", "lower")],
                       dict(zero_in_ltype="LOWER", write_back_ltype="LOWER"))


def reshape_local_output(P):
    return _chain_case(P, [("LOWER", "lower")],
                       dict(read_out_ltype="LOWER",
                            write_back_ltype="LOWER"))


def reshape_avoidable(P):
    return _chain_case(P, [("FULL", "full")], dict(zero_in_ltype="FULL"))


def reshape_no_re_reshape_on_forward(P):
    return _chain_case(P, [("LOWER", "lower")],
                       dict(zero_in_ltype="LOWER", zero_out_ltype="LOWER",
                            write_back_ltype="LOWER"))


def reshape_local_read_shared(P):
    pt = P.pt
    tile = np.arange(RN * RN, dtype=np.int32).reshape(RN, RN)
    ptrs, seen = [], []
    with pt.Context(nb_workers=2) as ctx:
        ctx.register_datatype_indexed("LOWER", lower_segments(RN))
        ctx.register_linear_collection("descA", tile, elem_size=tile.nbytes)
        tp = pt.Taskpool(ctx, globals={"NR": 1})
        src = tp.task_class("SRC")
        src.flow("A", "RW", pt.In(pt.Mem("descA", 0)),
                 pt.Out(pt.Ref("RD", pt.Range(0, pt.G("NR")), flow="A")))
        src.body(lambda t: None)
        rd = tp.task_class("RD")
        rd.param("r", 0, pt.G("NR"))
        rd.flow("A", "READ", pt.In(pt.Ref("SRC", flow="A"), ltype="LOWER"))

        def rbody(t):
            ptrs.append(t.data_ptr("A"))
            seen.append(t.data("A", np.int32, shape=(RN, RN)).copy())

        rd.body(rbody)
        tp.run()
        tp.wait()
        conv, hits = ctx.reshape_stats()
    # one shared converted copy; non-selected bytes defined-zero
    return (len(ptrs), ptrs[0] == ptrs[1], conv, hits >= 1,
            [s.tobytes() for s in seen])


def reshape_local_input_LU_LL(P):
    pt = P.pt
    tile = np.arange(1, RN * RN + 1, dtype=np.int32).reshape(RN, RN)
    got = {}
    with pt.Context(nb_workers=2) as ctx:
        ctx.register_datatype_indexed("LOWER", lower_segments(RN))
        ctx.register_datatype_indexed("UPPER", upper_segments(RN))
        ctx.register_linear_collection("descA", tile, elem_size=tile.nbytes)
        tp = pt.Taskpool(ctx)
        src = tp.task_class("SRC")
        src.flow("A", "RW", pt.In(pt.Mem("descA", 0)),
                 pt.Out(pt.Ref("LO", flow="A")),
                 pt.Out(pt.Ref("UP", flow="A")))
        src.body(lambda t: None)
        for name, lt in (("LO", "LOWER"), ("UP", "UPPER")):
            c = tp.task_class(name)
            c.flow("A", "READ", pt.In(pt.Ref("SRC", flow="A"), ltype=lt))
            c.body(lambda t, name=name: got.__setitem__(
                name, t.data("A", np.int32, shape=(RN, RN)).tobytes()))
        tp.run()
        tp.wait()
        conv, _ = ctx.reshape_stats()
    return conv, got["LO"], got["UP"]


def reshape_input_dep_single_copy(P):
    pt = P.pt
    tile = np.arange(RN * RN, dtype=np.int32).reshape(RN, RN)
    got = []
    with pt.Context(nb_workers=2) as ctx:
        ctx.register_datatype_indexed("LOWER", lower_segments(RN))
        ctx.register_linear_collection("descA", tile, elem_size=tile.nbytes)
        tp = pt.Taskpool(ctx)
        tc = tp.task_class("RD")
        tc.flow("A", "RW", pt.In(pt.Mem("descA", 0), ltype="LOWER"))

        def body(t):
            got.append(t.data("A", np.int32, shape=(RN, RN)).tobytes())
            t.data("A", np.int32)[:] = -1  # must not touch the collection

        tc.body(body)
        tp.run()
        tp.wait()
        conv, _ = ctx.reshape_stats()
    return conv, got[0], tile.tobytes()


def reshape_cast_local(P):
    pt = P.pt
    tile = np.linspace(0.0, 1.0, RN * RN, dtype=np.float64)
    got = []
    with pt.Context(nb_workers=1) as ctx:
        ctx.register_datatype_cast("D2S", np.float64, np.float32)
        ctx.register_linear_collection("descA", tile, elem_size=tile.nbytes)
        tp = pt.Taskpool(ctx)
        tc = tp.task_class("RD")
        tc.flow("A", "READ", pt.In(pt.Mem("descA", 0), ltype="D2S"))
        tc.body(lambda t: got.append(t.data("A", np.float32).copy()))
        tp.run()
        tp.wait()
        conv, _ = ctx.reshape_stats()
    np.testing.assert_array_equal(got[0], tile.astype(np.float32))
    return conv, got[0].dtype.name, got[0].tobytes()


def reshape_cast_writeback_reverses(P):
    pt = P.pt
    tile = np.full(RN, 3.0, dtype=np.float64)
    with pt.Context(nb_workers=1) as ctx:
        ctx.register_datatype_cast("D2S", np.float64, np.float32)
        ctx.register_linear_collection("descA", tile, elem_size=tile.nbytes)
        tp = pt.Taskpool(ctx)
        tc = tp.task_class("T")
        tc.flow("A", "RW", pt.In(pt.Mem("descA", 0), ltype="D2S"),
                pt.Out(pt.Mem("descA", 0), ltype="D2S"))

        def body(t):
            a = t.data("A", np.float32)
            a *= 2.0

        tc.body(body)
        tp.run()
        tp.wait()
        conv, _ = ctx.reshape_stats()
    np.testing.assert_array_equal(tile, np.full(RN, 6.0))
    return conv, tile.dtype.name, tile.tobytes()


def reshape_unknown_ltype_rejected(P):
    pt = P.pt
    with pt.Context(nb_workers=1) as ctx:
        tp = pt.Taskpool(ctx)
        tc = tp.task_class("T")
        tc.flow("A", "READ", pt.In(None, ltype="nope"))
        tc.body(lambda t: None)
        with pytest.raises(ValueError, match="ltype 'nope'"):
            tp.run()
    return True


_LOW = np.tril(np.ones((RN, RN), dtype=bool))


def _lower_zeroed():
    t = np.ones((RN, RN), dtype=np.int32)
    t[_LOW] = 0
    return t.tobytes()


RESHAPE = {
    # (tile after, conversions, any hit, the original pointer reached
    # SET_ZEROS)
    reshape_local_no_reshape: (np.zeros((RN, RN), np.int32).tobytes(), 0,
                               False, True),
    reshape_local_input: (_lower_zeroed(), 1, False, False),
    reshape_local_output: (_lower_zeroed(), 1, False, False),
    reshape_avoidable: (np.zeros((RN, RN), np.int32).tobytes(), 0, True,
                        True),
    reshape_no_re_reshape_on_forward: (_lower_zeroed(), 1, True, False),
    reshape_local_read_shared: None,
    reshape_local_input_LU_LL: None,
    reshape_input_dep_single_copy: None,
    reshape_cast_local: None,
    reshape_cast_writeback_reverses: None,
    reshape_unknown_ltype_rejected: True,
}


@pytest.mark.parametrize("scenario", list(RESHAPE), ids=lambda f: f.__name__)
def test_reshape_matrix(scenario):
    got = same(scenario)
    if RESHAPE[scenario] is not None:
        assert got == RESHAPE[scenario]
    if scenario is reshape_local_read_shared:
        n, shared, conv, hit, seen = got
        assert n == 2 and shared and conv == 1 and hit
        want = np.where(_LOW, np.arange(RN * RN, dtype=np.int32)
                        .reshape(RN, RN), 0)
        assert seen == [want.tobytes()] * 2
    elif scenario is reshape_local_input_LU_LL:
        tile = np.arange(1, RN * RN + 1, dtype=np.int32).reshape(RN, RN)
        assert got == (2, np.where(_LOW, tile, 0).tobytes(),
                       np.where(~_LOW.T, 0, tile).tobytes())
    elif scenario is reshape_input_dep_single_copy:
        tile = np.arange(RN * RN, dtype=np.int32).reshape(RN, RN)
        assert got == (1, np.where(_LOW, tile, 0).tobytes(), tile.tobytes())
    elif scenario in (reshape_cast_local, reshape_cast_writeback_reverses):
        assert got[0] == 1


# ------------------------------------------------- vpmap, steal order
def _start(P, ctx):
    """Force context start so the scheduler exists (lazy startup)."""
    pt = P.pt
    ctx.register_arena("t", 8)
    tp = pt.Taskpool(ctx, globals={})
    tc = tp.task_class("Noop")
    tc.param("k", 0, 0)
    tc.body_noop()
    tp.run()
    tp.wait()


def vpmap_lhq_steal_order(P):
    with P.pt.Context(nb_workers=4, scheduler="lhq") as ctx:
        vps = ctx.set_vpmap([0, 0, 1, 1])
        _start(P, ctx)
        return vps, ctx.scheduler_name, [ctx.sched_victim_order(w)
                                         for w in range(4)]


def vpmap_lhq_flat_ring(P):
    with P.pt.Context(nb_workers=3, scheduler="lhq") as ctx:
        _start(P, ctx)
        return [ctx.sched_victim_order(w) for w in range(2)]


def vpmap_victim_order_none_for_flat(P):
    with P.pt.Context(nb_workers=2, scheduler="lws") as ctx:
        _start(P, ctx)
        return ctx.sched_victim_order(0)


def vpmap_string_and_repeat(P):
    with P.pt.Context(nb_workers=4, scheduler="lhq") as ctx:
        vps = ctx.set_vpmap("0,1")
        _start(P, ctx)
        return vps, ctx.sched_victim_order(0)


def vpmap_numa_resolves(P):
    with P.pt.Context(nb_workers=2, scheduler="lhq") as ctx:
        vps = ctx.set_vpmap("numa")
    return len(vps) == 2 and all(v >= 0 for v in vps)


def vpmap_lhq_runs_dags(P):
    pt = P.pt
    n = 120
    done, lock = [], threading.Lock()
    with pt.Context(nb_workers=4, scheduler="lhq") as ctx:
        ctx.set_vpmap([0, 0, 1, 1])
        ctx.register_arena("t", 8)
        tp = pt.Taskpool(ctx, globals={"N": n - 1})
        tc = tp.task_class("Ep")
        tc.param("k", 0, pt.G("N"))
        tc.flow("A", "RW", pt.In(None), arena="t")

        def body(v):
            with lock:
                done.append(v["k"])

        tc.body(body)
        tp.run()
        tp.wait()
    return sorted(done)


def vpmap_set_after_start_raises(P):
    with P.pt.Context(nb_workers=2, scheduler="lhq") as ctx:
        _start(P, ctx)
        with pytest.raises(RuntimeError, match="already started"):
            ctx.set_vpmap([0, 1])
    return True


VPMAP = {
    vpmap_lhq_steal_order: ([0, 0, 1, 1], "lhq",
                            [[1, 2, 3], [0, 2, 3], [3, 0, 1], [2, 0, 1]]),
    vpmap_lhq_flat_ring: [[1, 2], [2, 0]],
    vpmap_victim_order_none_for_flat: None,
    vpmap_string_and_repeat: ([0, 1, 0, 1], [2, 1, 3]),
    vpmap_numa_resolves: True,
    vpmap_lhq_runs_dags: list(range(120)),
    vpmap_set_after_start_raises: True,
}


@pytest.mark.parametrize("scenario", list(VPMAP), ids=lambda f: f.__name__)
def test_vpmap(scenario):
    assert same(scenario) == VPMAP[scenario]


def vpmap_mca_param(P):
    with P.pt.Context(nb_workers=2) as ctx:
        _start(P, ctx)
        return ctx.scheduler_name, ctx.sched_victim_order(0)


def test_vpmap_mca_param(monkeypatch):
    monkeypatch.setenv("PTC_MCA_runtime_vpmap", "0,1")
    monkeypatch.setenv("PTC_MCA_runtime_sched", "lhq")
    assert same(vpmap_mca_param) == ("lhq", [1])


# --------------------------------------------------- dependency table
def deptable_collision_chain(P):
    pt = P.pt
    seen = []
    with pt.Context(nb_workers=2) as ctx:
        ctx.register_arena("t", 8)
        tp = pt.Taskpool(ctx, globals={"NB": 300})
        k = pt.L("k")
        tc = tp.task_class("Task")
        tc.param("k", 0, pt.G("NB"))
        tc.flow("A", "RW",
                pt.In(None, guard=(k == 0)),
                pt.In(pt.Ref("Task", k - 1, flow="A")),
                pt.Out(pt.Ref("Task", k + 1, flow="A"),
                       guard=(k < pt.G("NB"))),
                arena="t")
        tc.body(lambda t: seen.append(t.local("k")))
        tp.run()
        tp.wait()
    return seen


def test_chain_correct_under_universal_hash_collisions(monkeypatch):
    """PTC_DEBUG_WEAK_HASH=1 (read at context creation) collapses the
    dep-key hash to 8 values: every instance collides, and the chain
    still runs each task once, in order, on both packages."""
    monkeypatch.setenv("PTC_DEBUG_WEAK_HASH", "1")
    assert same(deptable_collision_chain) == list(range(301))


_MEMORY_SCRIPT = r"""
import importlib, resource, sys
pt = importlib.import_module(sys.argv[1])
NB = 1_000_000
with pt.Context(nb_workers=2) as ctx:
    ctx.register_arena("t", 8)
    tp = pt.Taskpool(ctx, globals={"NB": NB})
    k = pt.L("k")
    tc = tp.task_class("Task")
    tc.param("k", 0, pt.G("NB"))
    tc.flow("A", "RW",
            pt.In(None, guard=(k == 0)),
            pt.In(pt.Ref("Task", k - 1, flow="A")),
            pt.Out(pt.Ref("Task", k + 1, flow="A"), guard=(k < pt.G("NB"))),
            arena="t")
    tc.body_noop()
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    tp.run()
    tp.wait()
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print("TASKS", tp.nb_total_tasks)
print("MEM_DELTA_MB", (rss1 - rss0) / 1024.0)
"""


def deptable_million_tasks(P):
    r = subprocess.run([sys.executable, "-c", _MEMORY_SCRIPT, P.module],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    words = dict(line.split() for line in r.stdout.splitlines())
    return int(words["TASKS"]), float(words["MEM_DELTA_MB"])


def test_million_task_pool_flat_memory():
    """1M chained tasks with flat memory (promoted instances leave no
    tombstones): both packages under the reference's 30 MB bound."""
    for tasks, delta_mb in both(deptable_million_tasks):
        assert tasks == 1_000_001
        assert delta_mb < 30.0, delta_mb


# ------------------------------------------------ best-device routing
def _drain_manager(ctx, qid, go, stop):
    go.wait()
    while not stop.is_set():
        t = ctx.device_pop(qid, timeout_ms=50)
        if t:
            ctx.task_complete(t)


def load_balance_fan(P, weights, nb=60):
    """An independent fan of nb tasks with a chore on each of two
    queues.  The queues are gated shut until every task is routed, so
    each routing decision sees the depths the earlier ones left (no
    drain race), and the split is read from the queue depths; then the
    queues drain.  Returns (depth q0, depth q1) at the gate."""
    pt = P.pt
    stop, go = threading.Event(), threading.Event()
    routed = (0, 0)
    with pt.Context(nb_workers=1) as ctx:
        ctx.register_arena("t", 8)
        q0 = ctx.device_queue_new()
        q1 = ctx.device_queue_new()
        ctx.device_queue_set_weight(q0, weights[0])
        ctx.device_queue_set_weight(q1, weights[1])
        thr = [threading.Thread(target=_drain_manager,
                                args=(ctx, q, go, stop), daemon=True)
               for q in (q0, q1)]
        for t in thr:
            t.start()
        tp = pt.Taskpool(ctx, globals={"NB": nb - 1})
        tc = tp.task_class("T")
        tc.param("k", 0, pt.G("NB"))
        tc.flow("A", "RW", pt.In(None), arena="t")
        tc.body_device(q0)
        tc.body_device(q1)
        tp.run()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            d0, d1 = ctx.device_queue_depth(q0), ctx.device_queue_depth(q1)
            if d0 + d1 == nb:
                routed = (d0, d1)
                break
            time.sleep(0.005)
        go.set()
        tp.wait()
        stop.set()
        for t in thr:
            t.join(timeout=30)
            assert not t.is_alive()
        assert ctx.device_queue_depth(q0) == ctx.device_queue_depth(q1) == 0
    return routed


def test_balanced_weights_split_work():
    """Equal weights: (depth+1)/weight routing alternates, an even split
    on both packages (the reference's own test floods live managers and
    asks only that neither queue starve)."""
    assert same(load_balance_fan, (1.0, 1.0)) == (30, 30)


def test_skewed_weights_prefer_fast_device():
    assert same(load_balance_fan, (1000.0, 0.001)) == (60, 0)


_UID = [1000]


def _producer_manager(P, ctx, qid, stamp_qid, stop):
    """Fake device manager for the producer class: stamps the mirror
    owner of every output copy it produces at the queue the consumer
    class reaches (what a device's cache put does for a real mirror),
    then completes the task."""
    while not stop.is_set():
        t = ctx.device_pop(qid, timeout_ms=50)
        if not t:
            continue
        cptr = P.N.lib.ptc_task_copy(t, 0)
        h = P.N.lib.ptc_copy_handle(cptr)
        if h == 0:
            _UID[0] += 1
            h = _UID[0]
            P.N.lib.ptc_copy_set_handle(cptr, h)
        # consumers see version+1 (the completion bumps the RW flow)
        ctx.device_set_data_owner(h, stamp_qid,
                                  P.N.lib.ptc_copy_version(cptr) + 1)
        ctx.task_complete(t)


def affinity_route(P, skew, consumer_weights=(1.0, 1.0), nb=12):
    """P(k) [pinned qp] -> C(k) [chores q0 then q1]; the consumer queues
    are gated shut until every C is routed, so the routing shows in the
    queue depths (the single worker makes the load feedback
    deterministic).  Returns (depth q0, depth q1)."""
    pt = P.pt
    stop, go = threading.Event(), threading.Event()
    routed = (0, 0)
    with pt.Context(nb_workers=1) as ctx:
        if skew is not None:
            ctx.device_set_affinity_skew(skew)
        ctx.register_arena("t", 8)
        q0 = ctx.device_queue_new()
        qp = ctx.device_queue_new()
        ctx.device_queue_set_weight(q0, consumer_weights[0])
        q1 = ctx.device_queue_new()
        ctx.device_queue_set_weight(q1, consumer_weights[1])
        thr = [threading.Thread(target=_producer_manager,
                                args=(P, ctx, qp, q1, stop), daemon=True),
               threading.Thread(target=_drain_manager,
                                args=(ctx, q0, go, stop), daemon=True),
               threading.Thread(target=_drain_manager,
                                args=(ctx, q1, go, stop), daemon=True)]
        for th in thr:
            th.start()
        tp = pt.Taskpool(ctx, globals={"NB": nb - 1})
        k = pt.L("k")
        prod = tp.task_class("P")
        prod.param("k", 0, pt.G("NB"))
        prod.flow("A", "RW", pt.In(None), pt.Out(pt.Ref("C", k, flow="A")),
                  arena="t")
        prod.body_device(qp)
        cons = tp.task_class("C")
        cons.param("k", 0, pt.G("NB"))
        cons.flow("A", "RW", pt.In(pt.Ref("P", k, flow="A")), arena="t")
        cons.body_device(q0)  # first chore: the load-tie winner
        cons.body_device(q1)
        tp.run()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            d0, d1 = ctx.device_queue_depth(q0), ctx.device_queue_depth(q1)
            if d0 + d1 == nb:
                routed = (d0, d1)
                break
            time.sleep(0.005)
        go.set()
        tp.wait()
        stop.set()
        for th in thr:
            th.join()
    return routed


@pytest.mark.parametrize("skew,weights,want", [
    (1e9, (1.0, 1.0), (0, 12)),    # every C follows its input's mirror
    (4.0, (1.0, 1e-6), (12, 0)),   # the owner is saturated: spill
    (0.0, (1.0, 1.0), (6, 6)),     # affinity off: alternating load
], ids=["follows_mirror", "spills_when_saturated", "off_at_zero_skew"])
def test_affinity_routing(skew, weights, want):
    assert same(affinity_route, skew, weights) == want


def affinity_stale_version(P):
    with P.pt.Context(nb_workers=1) as ctx:
        ctx.device_set_data_owner(777, 5, 3)
        obs = [ctx.device_get_data_owner(777)]
        ctx.device_set_data_owner(777, 6, 9)  # a re-stamp moves ownership
        obs.append(ctx.device_get_data_owner(777))
        ctx.device_clear_data_owner(777, 5)   # stale qid: no-op
        obs.append(ctx.device_get_data_owner(777))
        ctx.device_clear_data_owner(777)
        obs.append(ctx.device_get_data_owner(777))
    return obs


def test_stale_version_not_routed():
    assert same(affinity_stale_version) == [(5, 3), (6, 9), (6, 9), (-1, 0)]


def two_devices_chain(P, skew=None):
    """P(k) on device 0 -> C(k) on both devices (the sibling attached
    first, so a load tie picks the wrong one) -> P(k+1), k < 4; returns
    the data, the consumer tasks per device and the d2d bytes."""
    pt = P.pt
    nb = 32
    with pt.Context(nb_workers=1) as ctx:
        if skew is not None:
            ctx.device_set_affinity_skew(skew)
        arr = np.ones((nb,), dtype=np.float32)
        ctx.register_linear_collection("A", arr, elem_size=nb * 4,
                                       nodes=1, myrank=0)
        ctx.register_arena("t", nb * 4)
        d0, d1 = P.device(ctx, 0), P.device(ctx, 1)
        tp = pt.Taskpool(ctx, globals={"NB": 3})
        k = pt.L("k")
        prod = tp.task_class("P")
        prod.param("k", 0, 3)
        prod.flow("X", "RW",
                  pt.In(pt.Mem("A", 0), guard=(k == 0)),
                  pt.In(pt.Ref("C", k - 1, flow="X")),
                  pt.Out(pt.Ref("C", k, flow="X")), arena="t")
        cons = tp.task_class("C")
        cons.param("k", 0, 3)
        cons.flow("X", "RW",
                  pt.In(pt.Ref("P", k, flow="X")),
                  pt.Out(pt.Ref("P", k + 1, flow="X"), guard=(k < 3)),
                  pt.Out(pt.Mem("A", 0), guard=(k == 3)), arena="t")
        d0.attach(prod, tp, kernel=lambda x: x + 1.0, reads=["X"],
                  writes=["X"], shapes={"X": (nb,)})
        d1.attach(cons, tp, kernel=lambda x: x * 2.0, reads=["X"],
                  writes=["X"], shapes={"X": (nb,)})
        d0.attach(cons, tp, kernel=lambda x: x * 2.0, reads=["X"],
                  writes=["X"], shapes={"X": (nb,)})
        tp.run()
        tp.wait()
        for d in (d0, d1):
            d.flush()
        obs = (arr.tobytes(), d0.stats["tasks"], d1.stats["tasks"],
               d0.stats["d2d_bytes"] + d1.stats["d2d_bytes"])
        d0.stop()
        d1.stop()
    return obs


def test_two_devices_consumer_zero_d2d():
    """Every consumer follows the mirror to device 0: no d2d staging, the
    sibling runs nothing, and the data is exact (small integers)."""
    expect = np.ones((32,), dtype=np.float32)
    for _ in range(4):
        expect = (expect + 1.0) * 2.0
    assert same(two_devices_chain) == (expect.tobytes(), 8, 0, 0)


def test_two_devices_zero_skew_stages_d2d():
    """Affinity off (skew 0): the consumers tie onto the sibling, and each
    hop of the chain stages the other device's dirty mirror device to
    device (4 consumers on the sibling, 3 producers back on device 0: 7 x
    128 bytes); the data is the same, and both packages route and stage
    alike."""
    expect = np.ones((32,), dtype=np.float32)
    for _ in range(4):
        expect = (expect + 1.0) * 2.0
    assert same(two_devices_chain, 0.0) == (expect.tobytes(), 4, 4, 7 * 128)


def peek_front(P):
    """device_peek_front on a gated queue: (class id, pool) per queued
    task, nothing popped."""
    pt = P.pt
    with pt.Context(nb_workers=1) as ctx:
        ctx.register_arena("t", 8)
        q = ctx.device_queue_new()
        tp = pt.Taskpool(ctx, globals={"NB": 4})
        tc = tp.task_class("T")
        tc.param("k", 0, pt.G("NB"))
        tc.flow("A", "RW", pt.In(None), arena="t")
        tc.body_device(q)
        tp.run()
        deadline = time.monotonic() + 30
        while ctx.device_queue_depth(q) < 5 and time.monotonic() < deadline:
            time.sleep(0.005)
        front = ctx.device_peek_front(q)
        obs = (len(front), {c for c, _ in front},
               {p for _, p in front} == {tp._ptr}, ctx.device_queue_depth(q))
        while True:
            t = ctx.device_pop(q, timeout_ms=0)
            if not t:
                break
            ctx.task_complete(t)
        tp.wait()
    return obs


def test_device_peek_front():
    assert same(peek_front) == (5, {0}, True, 5)


def test_first_touch_makes_one_datum():
    """Workers that touch a tile first at the same time share one array
    and one Data (one copy, one version, one device mirror).  The
    reference's lazy data_of is check-then-set, and two racing workers
    can each make a Data for the tile (ROADMAP Queue C)."""
    with tpt.Context(nb_workers=1) as ctx:
        colls = [tdata.TwoDimBlockCyclic(64, 64, 16, 16),
                 tdata.TwoDimTabular(64, 64, 16, 16, table=np.zeros(16)),
                 tdata.VectorCyclic(64, 16)]
        for i, c in enumerate(colls):
            c.register(ctx, f"C{i}")
        start = threading.Barrier(8)
        got = [[] for _ in colls]

        def touch():
            start.wait()
            for c, seen in zip(colls, got):
                for key in ((3, 1), (0, 0)) if c is not colls[2] else \
                        ((3,), (0,)):
                    seen.append(id(c.data_of(*key)))

        ts = [threading.Thread(target=touch) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    for seen in got:
        assert len(set(seen)) == 2, seen  # one Data per tile


def context_probes(P):
    with P.pt.Context(nb_workers=2) as ctx:
        ru = ctx.rusage()
        return (sorted(ru), ru["maxrss_kb"] > 0,
                [ctx.worker_binding(w) for w in range(2)])


def test_context_probes():
    """rusage keys and the (unbound) worker CPU bindings."""
    keys, rss, bind = same(context_probes)
    assert rss and bind == [-1, -1]
    assert "utime_s" in keys and "invol_ctx_switches" in keys


# ------------------------------------------------------- matrix ops
def _mk(P, ctx, M, N, mb, nb, name="A", seed=0):
    A = P.data.TwoDimBlockCyclic(M, N, mb, nb, dtype=np.float32)
    A.from_dense(np.random.default_rng(seed).standard_normal((M, N))
                 .astype(np.float32))
    A.register(ctx, name)
    return A


def apply_scale(P, uplo):
    with P.pt.Context(nb_workers=2) as ctx:
        A = _mk(P, ctx, 64, 48, 16, 16)
        ref = A.to_dense().copy()

        def op(coll, m, n, tile):
            tile *= 2.0

        tp = P.algos.build_apply(ctx, A, op, uplo=uplo)
        tp.run()
        tp.wait()
        got = A.to_dense()
    for mm in range(4):
        for nn in range(3):
            blk = (slice(mm * 16, mm * 16 + 16), slice(nn * 16, nn * 16 + 16))
            in_region = (mm == nn or
                         (uplo in ("full", "lower") and mm > nn) or
                         (uplo in ("full", "upper") and mm < nn))
            np.testing.assert_array_equal(
                got[blk], ref[blk] * (2.0 if in_region else 1.0))
    return got.tobytes()


@pytest.mark.parametrize("uplo", ["full", "lower", "upper"])
def test_apply(uplo):
    same(apply_scale, uplo)


def map_operator(P):
    with P.pt.Context(nb_workers=2) as ctx:
        S = _mk(P, ctx, 64, 64, 16, 16, name="S", seed=1)
        D = _mk(P, ctx, 64, 64, 16, 16, name="D", seed=2)
        s_ref = S.to_dense().copy()
        tp = P.algos.build_map_operator(
            ctx, S, D, lambda s, d, m, n: s * 3.0 + m + 10 * n)
        tp.run()
        tp.wait()
        got = D.to_dense()
    for mm in range(4):
        for nn in range(4):
            blk = (slice(mm * 16, mm * 16 + 16), slice(nn * 16, nn * 16 + 16))
            np.testing.assert_array_equal(got[blk],
                                          s_ref[blk] * 3.0 + mm + 10 * nn)
    return got.tobytes()


def test_map_operator():
    same(map_operator)


def _acc(acc, b):
    acc += b


def reduce_tiles(P, axis, mt, nt, seed, dest=False):
    """Tree-reduce the tiles of each column (axis 0) or row (axis 1);
    returns the reduced tiles and float64 sums of the input's tiles."""
    mb = 8
    with P.pt.Context(nb_workers=2) as ctx:
        A = _mk(P, ctx, mt * mb, nt * mb, mb, mb, seed=seed)
        ref = A.to_dense().astype(np.float64)
        kw = {}
        if dest:
            Dst = P.data.TwoDimBlockCyclic(mb, nt * mb, mb, mb,
                                           dtype=np.float32)
            Dst.register(ctx, "DST")
            kw["dest_name"] = "DST"
        build = (P.algos.build_reduce_col if axis == 0
                 else P.algos.build_reduce_row)
        tp = build(ctx, A, _acc, **kw)
        tp.run()
        tp.wait()
        got = Dst.to_dense() if dest else A.to_dense()
    tiles = ref.reshape(mt, mb, nt, mb)
    want = tiles.sum(axis=0 if axis == 0 else 2)
    if axis == 0:
        out = got[:mb, :]
        want = want.reshape(mb, nt * mb)
    else:
        out = got[:, :mb]
        want = want.reshape(mt * mb, mb)
    # the reference test's 1e-5 against sums of float32 tiles
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    return out.tobytes()


@pytest.mark.parametrize("mt", [2, 4, 5, 7, 8])
def test_reduce_col(mt):
    """Any tile count, the reference tree's power of two or not."""
    same(reduce_tiles, 0, mt, 3, 3)


@pytest.mark.parametrize("nt", [3, 4, 6])
def test_reduce_row(nt):
    same(reduce_tiles, 1, 2, nt, 4)


def test_reduce_into_dest():
    same(reduce_tiles, 0, 4, 2, 5, True)


# -------------------------------------------------------- reshape
def reshape_dtype(P, dst_dtype, cast, M, mb):
    with P.pt.Context(nb_workers=1) as ctx:
        src = P.data.TwoDimBlockCyclic(M, M, mb, mb, dtype=np.float32)
        dst = P.data.TwoDimBlockCyclic(M, M, mb, mb, dtype=dst_dtype)
        src.register(ctx, "RSsrc")
        dst.register(ctx, "RSdst")
        a = (np.random.default_rng(0).standard_normal((M, M))
             .astype(np.float32) if cast is None else
             np.arange(M * M, dtype=np.float32).reshape(M, M) / 7.0)
        src.from_dense(a)
        tp = P.algos.build_reshape_dtype(ctx, src, dst, cast=cast)
        tp.run()
        tp.wait()
        out = dst.to_dense()
    want = (a if cast is None else cast(a)).astype(dst_dtype)
    np.testing.assert_array_equal(out, want)
    return out.dtype.name, out.tobytes()


def test_dtype_cast_f32_to_f64():
    assert same(reshape_dtype, np.float64, None, 48, 16)[0] == "float64"


def test_dtype_cast_with_transform():
    assert same(reshape_dtype, np.int32, np.floor, 32, 8)[0] == "int32"


def reshape_mismatch(P):
    with P.pt.Context(nb_workers=1) as ctx:
        src = P.data.TwoDimBlockCyclic(32, 32, 8, 8)
        dst = P.data.TwoDimBlockCyclic(32, 32, 16, 16)
        src.register(ctx, "RSsrc")
        dst.register(ctx, "RSdst")
        with pytest.raises(ValueError, match="matching tile grids"):
            P.algos.build_reshape_dtype(ctx, src, dst)
    return True


def test_geometry_mismatch_rejected():
    same(reshape_mismatch)


def regrid(P):
    with P.pt.Context(nb_workers=1) as ctx:
        src = P.data.TwoDimBlockCyclic(40, 40, 8, 8, dtype=np.float32)
        dst = P.data.TwoDimBlockCyclic(40, 40, 16, 16, dtype=np.float32)
        src.register(ctx, "src")
        dst.register(ctx, "dst")
        a = np.arange(1600, dtype=np.float32).reshape(40, 40)
        src.from_dense(a)
        P.algos.reshape_geometry(ctx, src, dst)
        got = dst.to_dense()
    np.testing.assert_array_equal(got, a)
    return got.tobytes()


def test_regrid_via_redistribute():
    same(regrid)


def reshape_over_device_dirty(P):
    """The reshape paths on a factor a device left dirty (its current
    bytes are device mirrors): tile potrf on the device, then regrid,
    cast and a column reduction on the host, each reading the mirrors
    through the task views.  Returns the flushed factor and each
    result."""
    pt = P.pt
    n, nb = 64, 16
    M = _spd(n, seed=7)
    with pt.Context(nb_workers=2) as ctx:
        dev = P.device(ctx)
        A = P.data.TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32)
        A.from_dense(M)
        A.register(ctx, "A")
        tp = P.algos.build_potrf(ctx, A, dev)
        tp.run()
        tp.wait()
        R = P.data.TwoDimBlockCyclic(n, n, nb // 2, nb // 2,
                                     dtype=np.float32)
        R.register(ctx, "R")
        P.algos.reshape_geometry(ctx, A, R)
        H = P.data.TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float16)
        H.register(ctx, "H")
        tp = P.algos.build_reshape_dtype(ctx, A, H, src_name="A",
                                         dst_name="H")
        tp.run()
        tp.wait()
        dev.flush()
        factor = A.to_dense()
        tp = P.algos.build_reduce_col(ctx, A, _acc)
        tp.run()
        tp.wait()
        dev.flush()
        red = A.to_dense()[:nb]
        dev.stop()
    return factor, R.to_dense(), H.to_dense(), red


def test_reshape_paths_read_device_dirty_tiles():
    """Host bodies over a device-dirty factor pull the current mirrors:
    the regrid equals the flushed factor bit for bit, the float16 cast
    equals numpy's astype bit for bit, and the column reduction matches a
    float64 sum of the factor's tiles to 1e-5, on each package; the two
    factors agree to the reference's device tolerance (1e-4)."""
    for factor, regridded, half, red in both(reshape_over_device_dirty):
        np.testing.assert_array_equal(regridded, factor)
        np.testing.assert_array_equal(half, factor.astype(np.float16))
        want = factor.astype(np.float64).reshape(4, 16, 64).sum(axis=0)
        np.testing.assert_allclose(red, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            np.tril(factor), np.linalg.cholesky(_spd(64, seed=7)
                                                .astype(np.float64)),
            rtol=1e-3, atol=1e-3)
    (f_ref, *_), (f_port, *_) = both(reshape_over_device_dirty)
    np.testing.assert_allclose(f_port, f_ref, rtol=1e-4, atol=1e-4)


# ----------------------------------------- band collections, redistribute
def band_dispatch(P):
    B = P.data.TwoDimBlockCyclicBand(64, 64, 16, 16, band_size=1)
    B2 = P.data.TwoDimBlockCyclicBand(64, 64, 16, 16, band_size=2)
    obs = [B.in_band(0, 0), B.in_band(2, 2), B.in_band(0, 1),
           B2.in_band(0, 1), B2.in_band(1, 0), B2.in_band(0, 2)]
    # band and off-band tiles live in distinct descriptors
    obs += [B.tile(1, 1) is B.band.tile(1, 1),
            B.tile(0, 1) is B.off_band.tile(0, 1)]
    M = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
    B.from_dense(M)
    np.testing.assert_array_equal(B.to_dense(), M)
    return obs


def test_band_dispatch():
    assert same(band_dispatch) == [True, True, False, True, True, False,
                                   True, True]


def sym_band_stored(P):
    S = P.data.SymTwoDimBlockCyclicBand(64, 64, 16, 16, band_size=1,
                                        uplo="lower")
    S.tile(2, 1)  # stored
    with pytest.raises(KeyError):
        S.tile(1, 2)
    return True


def test_sym_band_stored():
    same(sym_band_stored)


def band_in_dag(P):
    pt = P.pt
    with pt.Context(nb_workers=2) as ctx:
        B = P.data.TwoDimBlockCyclicBand(32, 32, 16, 16, band_size=1)
        B.from_dense(np.ones((32, 32), np.float32))
        B.register(ctx, "B")
        tp = pt.Taskpool(ctx, globals={"NT": 1})
        m, n = pt.L("m"), pt.L("n")
        tc = tp.task_class("SCALE")
        tc.param("m", 0, pt.G("NT"))
        tc.param("n", 0, pt.G("NT"))
        tc.affinity("B", m, n)
        tc.flow("T", "RW", pt.In(pt.Mem("B", m, n)),
                pt.Out(pt.Mem("B", m, n)))

        def body(t):
            t.data("T", np.float32, (16, 16))[...] *= 5.0

        tc.body(body)
        tp.run()
        tp.wait()
        return B.to_dense().tobytes()


def test_band_as_collection_in_dag():
    assert same(band_in_dag) == np.full((32, 32), 5.0, np.float32).tobytes()


def tabular_and_hash(P):
    """TwoDimTabular's table placement and HashDatadist's keyed arrays as
    a DAG's data."""
    pt = P.pt
    T = P.data.TwoDimTabular(32, 32, 16, 16, table=[[0, 1], [1, 0]],
                             nodes=2, myrank=0)
    ranks = [T.rank_of(m, n) for m in range(2) for n in range(2)]
    H = P.data.HashDatadist()
    arrs = {k: np.full(4, k, dtype=np.int64) for k in (3, 17, 40)}
    for k, a in arrs.items():
        H.add(k, 0, a)
    with pt.Context(nb_workers=2) as ctx:
        H.register(ctx, "H")
        tp = pt.Taskpool(ctx)
        for k in arrs:
            tc = tp.task_class(f"T{k}")
            tc.flow("A", "RW", pt.In(pt.Mem("H", k)), pt.Out(pt.Mem("H", k)))

            def body(t, k=k):
                t.data("A", np.int64)[...] *= 10 + k

            tc.body(body)
        tp.run()
        tp.wait()
    return ranks, H.rank_of(99), H.data_of(99), [a.tolist()
                                                 for a in arrs.values()]


def test_tabular_and_hash_datadist():
    ranks, unknown_rank, unknown, arrs = same(tabular_and_hash)
    assert ranks == [0, 1, 1, 0] and unknown_rank == 0 and unknown is None
    assert arrs == [[k * (10 + k)] * 4 for k in (3, 17, 40)]


def redistribute_case(P, seed):
    """The reference's same-grid (seed None), resized-tiles (-1) and
    randomized geometry (seed) cases; returns the target's bytes."""
    rng = np.random.default_rng(0 if seed is None else
                                1 if seed == -1 else seed)
    if seed is None:
        M = rng.standard_normal((64, 48)).astype(np.float32)
        sgeo, dgeo = (64, 48, 16, 16), (64, 48, 16, 16)
        args = (64, 48)
    elif seed == -1:
        M = rng.standard_normal((60, 60)).astype(np.float32)
        sgeo, dgeo = (60, 60, 13, 9), (70, 70, 17, 11)
        args = (40, 30, 7, 12, 23, 5)
    else:
        sM, sN = int(rng.integers(30, 80)), int(rng.integers(30, 80))
        dM, dN = int(rng.integers(30, 80)), int(rng.integers(30, 80))
        smb, snb = int(rng.integers(4, 20)), int(rng.integers(4, 20))
        dmb, dnb = int(rng.integers(4, 20)), int(rng.integers(4, 20))
        size_r = int(rng.integers(1, min(sM, dM)))
        size_c = int(rng.integers(1, min(sN, dN)))
        dis = [int(rng.integers(0, sM - size_r + 1)),
               int(rng.integers(0, sN - size_c + 1)),
               int(rng.integers(0, dM - size_r + 1)),
               int(rng.integers(0, dN - size_c + 1))]
        M = rng.standard_normal((sM, sN)).astype(np.float32)
        sgeo, dgeo = (sM, sN, smb, snb), (dM, dN, dmb, dnb)
        args = (size_r, size_c, *dis)
    with P.pt.Context(nb_workers=2) as ctx:
        S = P.data.TwoDimBlockCyclic(*sgeo, dtype=np.float32)
        S.from_dense(M)
        S.register(ctx, "S")
        D = P.data.TwoDimBlockCyclic(*dgeo, dtype=np.float32)
        D.register(ctx, "D")
        P.algos.redistribute(ctx, S, D, *args)
        got = D.to_dense()
    r, c = args[:2]
    si, sj, di, dj = (list(args[2:]) + [0, 0, 0, 0])[:4]
    np.testing.assert_array_equal(got[di:di + r, dj:dj + c],
                                  M[si:si + r, sj:sj + c])
    if seed == -1:
        assert got[0:23, :].sum() == 0.0  # untouched region stays zero
    return got.tobytes()


@pytest.mark.parametrize("seed", [None, -1, 2, 3, 4],
                         ids=["same_grid", "resize_tiles", "random2",
                              "random3", "random4"])
def test_redistribute(seed):
    same(redistribute_case, seed)


def redistribute_bounds(P):
    with P.pt.Context(nb_workers=1) as ctx:
        S = P.data.TwoDimBlockCyclic(32, 32, 16, 16)
        S.register(ctx, "S")
        D = P.data.TwoDimBlockCyclic(32, 32, 16, 16)
        D.register(ctx, "D")
        with pytest.raises(ValueError):
            P.algos.redistribute(ctx, S, D, 33, 10)
    return True


def test_redistribute_bounds_check():
    same(redistribute_bounds)


# ------------------------------------------------------------ mini-apps
def stencil_1d(P):
    """T timesteps of a 3-point Jacobi average over tiled 1D data, with
    CTL ghost exchanges between neighbors (tests/apps/stencil)."""
    pt = P.pt
    nt, T, tile = 8, 6, 4
    data = np.arange(nt * tile, dtype=np.float64)
    tiles = {(0, i): data[i * tile:(i + 1) * tile].copy() for i in range(nt)}
    with pt.Context(nb_workers=2) as ctx:
        ctx.register_arena("tile", tile * 8)
        tp = pt.Taskpool(ctx, globals={"NT": nt - 1, "T": T})
        t, i = pt.L("t"), pt.L("i")
        st = tp.task_class("Step")
        st.param("t", 1, pt.G("T")).param("i", 0, pt.G("NT"))
        st.flow("A", "RW",
                pt.In(pt.Ref("Step", t - 1, i, flow="A"), guard=(t > 1)),
                pt.In(None, guard=(t == 1)),
                pt.Out(pt.Ref("Step", t + 1, i, flow="A"),
                       guard=(t < pt.G("T"))), arena="tile")
        st.flow("X", "CTL",
                pt.In(pt.Ref("Step", t - 1, i - 1, flow="X"),
                      guard=(t > 1) & (i > 0)),
                pt.In(pt.Ref("Step", t - 1, i + 1, flow="X"),
                      guard=(t > 1) & (i < pt.G("NT"))),
                pt.Out(pt.Ref("Step", t + 1, i - 1, flow="X"),
                       guard=(t < pt.G("T")) & (i > 0)),
                pt.Out(pt.Ref("Step", t + 1, i + 1, flow="X"),
                       guard=(t < pt.G("T")) & (i < pt.G("NT"))))
        lock = threading.Lock()

        def body(view):
            tt, ii = view["t"], view["i"]
            with lock:
                cur = tiles[(tt - 1, ii)]
                left = tiles[(tt - 1, ii - 1)][-1] if ii > 0 else None
                right = tiles[(tt - 1, ii + 1)][0] if ii < nt - 1 else None
                ext = np.concatenate([[left] if left is not None else [],
                                      cur,
                                      [right] if right is not None else []])
                new = cur.copy()
                off = 1 if ii > 0 else 0
                for j in range(len(cur)):
                    gj = ii * tile + j
                    if 0 < gj < nt * tile - 1:
                        new[j] = (ext[j + off - 1] + ext[j + off] +
                                  ext[j + off + 1]) / 3.0
                tiles[(tt, ii)] = new

        st.body(body)
        tp.run()
        tp.wait()
    got = np.concatenate([tiles[(T, i)] for i in range(nt)])
    expect = data.copy()
    for _ in range(T):
        nxt = expect.copy()
        nxt[1:-1] = (expect[:-2] + expect[1:-1] + expect[2:]) / 3.0
        expect = nxt
    np.testing.assert_allclose(got, expect, rtol=1e-12)
    return got.tobytes()


def priority_ap(P):
    pt = P.pt
    n, order = 12, []
    with pt.Context(nb_workers=1, scheduler="ap") as ctx:
        tp = pt.Taskpool(ctx, globals={"N": n})
        k = pt.L("k")
        gate = tp.task_class("Gate")
        gate.flow("X", "CTL",
                  pt.Out(pt.Ref("Fan", pt.Range(0, pt.G("N")), flow="X")))
        gate.body(lambda v: None)
        fan = tp.task_class("Fan")
        fan.param("k", 0, pt.G("N"))
        fan.priority(k)
        fan.flow("X", "CTL", pt.In(pt.Ref("Gate", flow="X")))
        fan.body(lambda v: order.append(v["k"]))
        tp.run()
        tp.wait()
    return order


def pingpong(P):
    pt = P.pt
    n, order = 20, []
    with pt.Context(nb_workers=1) as ctx:
        ctx.register_arena("t", 8)
        tp = pt.Taskpool(ctx, globals={"N": n})
        k = pt.L("k")
        ping = tp.task_class("Ping")
        ping.param("k", 0, pt.G("N"))
        ping.flow("A", "RW", pt.In(None, guard=(k == 0)),
                  pt.In(pt.Ref("Pong", k - 1, flow="A")),
                  pt.Out(pt.Ref("Pong", k, flow="A")), arena="t")
        ping.body(lambda v: order.append(("ping", v["k"])))
        pong = tp.task_class("Pong")
        pong.param("k", 0, pt.G("N"))
        pong.flow("A", "RW", pt.In(pt.Ref("Ping", k, flow="A")),
                  pt.Out(pt.Ref("Ping", k + 1, flow="A"),
                         guard=(k < pt.G("N"))), arena="t")
        pong.body(lambda v: order.append(("pong", v["k"])))
        tp.run()
        tp.wait()
    return order


def haar_tree_dtd(P):
    leaves = 16
    vals = np.arange(leaves, dtype=np.int64)
    with P.pt.Context(nb_workers=2) as ctx:
        datas = {(0, j): ctx.data(j, np.array([v], dtype=np.int64))
                 for j, v in enumerate(vals)}
        dtp = P.dtd.DtdTaskpool(ctx, window=64)
        tiles = {k: dtp.tile_of(d) for k, d in datas.items()}
        level, width, key = 0, leaves, leaves

        def merge(view):
            a = view.data(0, dtype=np.int64)
            b = view.data(1, dtype=np.int64)
            view.data(2, dtype=np.int64)[0] = a[0] + b[0]

        while width > 1:
            for j in range(width // 2):
                dst = ctx.data(key, np.zeros(1, dtype=np.int64))
                key += 1
                datas[(level + 1, j)] = dst
                tiles[(level + 1, j)] = dtp.tile_of(dst)
                dtp.insert_task(merge, (tiles[(level, 2 * j)], "INPUT"),
                                (tiles[(level, 2 * j + 1)], "INPUT"),
                                (tiles[(level + 1, j)], "OUTPUT"))
            level += 1
            width //= 2
        dtp.wait()
        root = int(datas[(level, 0)].array[0])
        dtp.destroy()
    return root


def all2all_ctl(P):
    pt = P.pt
    n = 6
    produced, consumed, lock = [], [], threading.Lock()
    with pt.Context(nb_workers=2) as ctx:
        tp = pt.Taskpool(ctx, globals={"N": n - 1})
        prod = tp.task_class("Prod")
        prod.param("k", 0, pt.G("N"))
        prod.flow("X", "CTL",
                  pt.Out(pt.Ref("Cons", pt.Range(0, pt.G("N")), flow="X")))

        def pbody(v):
            with lock:
                produced.append(v["k"])

        prod.body(pbody)
        cons = tp.task_class("Cons")
        cons.param("k", 0, pt.G("N"))
        cons.flow("X", "CTL",
                  pt.In(pt.Ref("Prod", pt.Range(0, pt.G("N")), flow="X")))

        def cbody(v):
            with lock:
                assert len(produced) == n, (produced, v["k"])
                consumed.append(v["k"])

        cons.body(cbody)
        tp.run()
        tp.wait()
    return sorted(consumed)


def merge_sort_dtd(P):
    nt, seg = 8, 16
    flat = np.random.default_rng(3).integers(0, 1000, nt * seg) \
        .astype(np.int64)
    with P.pt.Context(nb_workers=2) as ctx:
        datas = {(0, j): ctx.data(j, flat[j * seg:(j + 1) * seg].copy())
                 for j in range(nt)}
        dtp = P.dtd.DtdTaskpool(ctx, window=64)
        tiles = {k: dtp.tile_of(d) for k, d in datas.items()}

        def sort_leaf(view):
            a = view.data(0, dtype=np.int64)
            a[...] = np.sort(a)

        for j in range(nt):
            dtp.insert_task(sort_leaf, (tiles[(0, j)], "INOUT"))
        level, width, key = 0, nt, nt
        while width > 1:
            sz = seg * (nt // width) * 2
            for j in range(width // 2):
                dst = ctx.data(key, np.zeros(sz, dtype=np.int64))
                key += 1
                datas[(level + 1, j)] = dst
                tiles[(level + 1, j)] = dtp.tile_of(dst)

                def merge(view, half=sz // 2):
                    a = view.data(0, dtype=np.int64)[:half]
                    b = view.data(1, dtype=np.int64)[:half]
                    o = view.data(2, dtype=np.int64)
                    o[...] = np.concatenate([a, b])
                    o.sort(kind="mergesort")

                dtp.insert_task(merge, (tiles[(level, 2 * j)], "INPUT"),
                                (tiles[(level, 2 * j + 1)], "INPUT"),
                                (tiles[(level + 1, j)], "OUTPUT"))
            level += 1
            width //= 2
        dtp.wait()
        out = datas[(level, 0)].array.copy()
        dtp.destroy()
    np.testing.assert_array_equal(out, np.sort(flat))
    return out.tobytes()


MINIAPPS = {
    stencil_1d: None,
    priority_ap: list(range(12, -1, -1)),
    pingpong: [(w, k) for k in range(21) for w in ("ping", "pong")],
    haar_tree_dtd: sum(range(16)),
    all2all_ctl: list(range(6)),
    merge_sort_dtd: None,
}


@pytest.mark.parametrize("scenario", list(MINIAPPS), ids=lambda f: f.__name__)
def test_miniapps(scenario):
    got = same(scenario)
    if MINIAPPS[scenario] is not None:
        assert got == MINIAPPS[scenario]
