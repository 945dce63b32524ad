"""The port's DSL front ends (parsec_tpu_torch.dsl: DTD with host and
device tasks, the insertion linter, JDF with host and device bodies, and
ptg_to_dtd) held against parsec_tpu's on the same inputs.

Each scenario is written once and run on both packages (a namespace of
each package's entry points); host-body and integer DAGs must agree bit
for bit, with the same task counts and the same lint findings.  Device
tasks run on the reference's TpuDevice on JAX's CPU platform (its Pallas
kernels in interpret mode) and on CudaDevice(ctx, device="cpu") (the
kernels' plain versions).  The JDF sources of the reference's own tests
are read from its test files, unchanged, and so are the tutorial
examples under examples/."""
import importlib
import importlib.util
import os
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import parsec_tpu as jpt
import parsec_tpu.dsl.dtd as jdtd
import parsec_tpu.dsl.jdf as jjdf
import parsec_tpu.dsl.ptg_to_dtd as jp2d
import parsec_tpu_torch as tpt
import parsec_tpu_torch.dsl.dtd as tdtd
import parsec_tpu_torch.dsl.jdf as tjdf
import parsec_tpu_torch.dsl.ptg_to_dtd as tp2d
from parsec_tpu import algos as jalgos
from parsec_tpu import analysis as janalysis
from parsec_tpu import data as jdata
from parsec_tpu_torch import algos as talgos
from parsec_tpu_torch import analysis as tanalysis
from parsec_tpu_torch import data as tdata
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.ops.flash_attention import attention_reference
from parsec_tpu_torch.ops.flash_attention import flash_fwd as torch_flash
from parsec_tpu_torch.ops.rms_norm import rms_norm as torch_rms_norm
from parsec_tpu_torch.ops.rms_norm import rms_norm_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = SimpleNamespace(name="ref", pt=jpt, dtd=jdtd, jdf=jjdf, p2d=jp2d,
                      LintError=janalysis.DtdLintError, data=jdata,
                      algos=jalgos)
PORT = SimpleNamespace(name="port", pt=tpt, dtd=tdtd, jdf=tjdf, p2d=tp2d,
                       LintError=tanalysis.DtdLintError, data=tdata,
                       algos=talgos)


def _load(relpath: str, name: str):
    """A module of the repo loaded by path under a private name (the
    reference's test files are read for their JDF sources)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_JDF = _load("tests/dsl/test_jdf.py", "_ref_test_jdf")
REF_PORTS = _load("tests/dsl/test_jdf_ports.py", "_ref_test_jdf_ports")


def both(scenario, *args):
    """The scenario's observations on the reference and on the port."""
    return scenario(REF, *args), scenario(PORT, *args)


# ------------------------------------------------------------ DTD, host
def dtd_chain_raw(P):
    with P.pt.Context(nb_workers=2) as ctx:
        buf = np.zeros(1, dtype=np.int64)
        dtd = P.dtd.DtdTaskpool(ctx)
        t = dtd.tile_of(ctx.data(0, buf))

        def add1(v):
            v.data(0, np.int64)[0] += 1

        for _ in range(100):
            dtd.insert_task(add1, (t, "INOUT"))
        dtd.wait()
        n = dtd.tp.nb_total_tasks
        dtd.destroy()
    return buf.tobytes(), n


def _war(P, batched):
    with P.pt.Context(nb_workers=3) as ctx:
        buf = np.array([5], dtype=np.int64)
        seen, lock = [], threading.Lock()
        dtd = P.dtd.DtdTaskpool(ctx)
        t = dtd.tile_of(ctx.data(0, buf))

        def read(v):
            with lock:
                seen.append(int(v.data(0, np.int64)[0]))

        def write(v):
            v.data(0, np.int64)[0] = 99

        stream = [(read, ((t, "INPUT"),))] * 10 + \
            [(write, ((t, "INOUT"),))] + [(read, ((t, "INPUT"),))] * 10
        if batched:
            dtd.insert_tasks(stream)
        else:
            for fn, args in stream:
                dtd.insert_task(fn, *args)
        dtd.wait()
        dtd.destroy()
    return sorted(seen), buf.tobytes()


def dtd_war_readers_before_writer(P):
    return _war(P, batched=False)


def dtd_batch_war_diamond(P):
    return _war(P, batched=True)


def dtd_multi_tile_diamond(P):
    with P.pt.Context(nb_workers=2) as ctx:
        a = ctx.data(0, np.array([3.0], dtype=np.float64))
        b = ctx.data(1, np.array([4.0], dtype=np.float64))
        c = ctx.data(2, np.zeros(1, dtype=np.float64))
        dtd = P.dtd.DtdTaskpool(ctx)
        ta, tb, tc = dtd.tile_of(a), dtd.tile_of(b), dtd.tile_of(c)

        def square(v):
            v.data(0, np.float64)[0] **= 2

        def add(v):
            v.data(2, np.float64)[0] = (v.data(0, np.float64)[0] +
                                        v.data(1, np.float64)[0])

        dtd.insert_task(square, (ta, "INOUT"))
        dtd.insert_task(square, (tb, "INOUT"))
        dtd.insert_task(add, (ta, "INPUT"), (tb, "INPUT"), (tc, "OUTPUT"))
        dtd.wait()
        dtd.destroy()
    return c.array.tobytes()


def dtd_window_throttle(P):
    with P.pt.Context(nb_workers=2) as ctx:
        buf = np.zeros(1, dtype=np.int64)
        dtd = P.dtd.DtdTaskpool(ctx, window=4)
        t = dtd.tile_of(ctx.data(0, buf))

        def add1(v):
            v.data(0, np.int64)[0] += 1

        for _ in range(200):
            dtd.insert_task(add1, (t, "INOUT"))
        dtd.wait()
        dtd.destroy()
    return buf.tobytes()


def dtd_batch_chain_matches_sequential(P):
    with P.pt.Context(nb_workers=2) as ctx:
        buf = np.zeros(1, dtype=np.int64)
        dtd = P.dtd.DtdTaskpool(ctx)
        t = dtd.tile_of(ctx.data(0, buf))

        def fold_k(v, k):
            a = v.data(0, np.int64)
            a[0] = (a[0] * 31 + k) % 1000003  # order-sensitive, bounded

        n = dtd.insert_tasks([(lambda v, k=k: fold_k(v, k), ((t, "INOUT"),))
                              for k in range(200)])
        dtd.wait()
        st = ctx.sched_stats()
        dtd.destroy()
    return n, buf.tobytes(), st["insert_batched_tasks"], \
        st["insert_batches"] >= 1


def dtd_batch_chunking(P):
    with P.pt.Context(nb_workers=2) as ctx:
        buf = np.zeros(1, dtype=np.int64)
        dtd = P.dtd.DtdTaskpool(ctx)
        t = dtd.tile_of(ctx.data(0, buf))

        def add1(v):
            v.data(0, np.int64)[0] += 1

        n = dtd.insert_tasks([(add1, ((t, "INOUT"),))] * 100, batch=16)
        dtd.wait()
        st = ctx.sched_stats()
        dtd.destroy()
    return n, buf.tobytes(), st["insert_batches"]


def dtd_batch_priority_and_too_many_args(P):
    with P.pt.Context(nb_workers=1) as ctx:
        bufs = [np.zeros(1, np.int64) for _ in range(2)]
        dtd = P.dtd.DtdTaskpool(ctx)
        tiles = [dtd.tile_of(ctx.data(i, b)) for i, b in enumerate(bufs)]

        def bump(v):
            v.data(0, np.int64)[0] += 1

        n = dtd.insert_tasks([(bump, ((tiles[0], "INOUT"),), 5),
                              (bump, ((tiles[1], "INOUT"),), 0)])
        with pytest.raises(ValueError, match="too many arguments"):
            dtd.insert_tasks(
                [(bump, tuple((tiles[0], "INPUT") for _ in range(25)))])
        dtd.wait()
        dtd.destroy()
    return n, [b.tobytes() for b in bufs]


def dtd_closed_pool_raises(P):
    with P.pt.Context(nb_workers=1) as ctx:
        dtd = P.dtd.DtdTaskpool(ctx)
        t = dtd.tile_of(ctx.data(0, np.zeros(1, np.int64)))
        dtd.wait()
        msgs = []
        for insert in (lambda: dtd.insert_tasks(
                           [(lambda v: None, ((t, "INPUT"),))]),
                       lambda: dtd.insert_task(lambda v: None,
                                               (t, "INPUT"))):
            with pytest.raises(RuntimeError, match="closed") as ei:
                insert()
            msgs.append(str(ei.value))
        dtd.destroy()
    return msgs


def dtd_host_bodies_share_one_callback(P):
    """One native callback per distinct host fn: a pool inserting the
    same fn many times registers it once."""
    with P.pt.Context(nb_workers=1) as ctx:
        dtd = P.dtd.DtdTaskpool(ctx)
        t = dtd.tile_of(ctx.data(0, np.zeros(1, np.int64)))

        def noop(v):
            pass

        before = len(ctx._body_cbs)
        for _ in range(50):
            dtd.insert_task(noop, (t, "INOUT"))
        dtd.insert_tasks([(noop, ((t, "INPUT"),))] * 50)
        dtd.wait()
        dtd.destroy()
        return len(ctx._body_cbs) - before


DTD_HOST = [dtd_chain_raw, dtd_war_readers_before_writer,
            dtd_batch_war_diamond, dtd_multi_tile_diamond,
            dtd_window_throttle, dtd_batch_chain_matches_sequential,
            dtd_batch_chunking, dtd_batch_priority_and_too_many_args,
            dtd_closed_pool_raises, dtd_host_bodies_share_one_callback]


@pytest.mark.parametrize("scenario", DTD_HOST, ids=lambda f: f.__name__)
def test_dtd_host_matches_reference(scenario):
    ref, port = both(scenario)
    assert port == ref


def test_dtd_oracles():
    """The values the reference's DTD tests pin, on the port."""
    assert dtd_chain_raw(PORT) == (np.int64(100).tobytes(), 100)
    assert dtd_war_readers_before_writer(PORT)[0] == [5] * 10 + [99] * 10
    assert dtd_multi_tile_diamond(PORT) == np.float64(25.0).tobytes()
    assert dtd_batch_chunking(PORT) == (100, np.int64(100).tobytes(), 7)
    assert dtd_host_bodies_share_one_callback(PORT) == 1


# ------------------------------------------------------------- the linter
_KEY = [0]


def _data(ctx, n=16):
    _KEY[0] += 1
    return ctx.data(_KEY[0], np.zeros(n, dtype=np.float32))


def _noop(view):
    pass


class _RaggedTiles:
    """A collection whose tile() allocates HALF the declared stride (the
    size mismatch D104 catches), over the package's TwoDimBlockCyclic."""

    def __init__(self, P, mb=8, nb=8):
        self._good = P.data.TwoDimBlockCyclic(4 * mb, 4 * nb, mb, nb,
                                              dtype=np.float32)
        self.mb, self.nb = mb, nb
        self.dtype = self._good.dtype
        self.nodes, self.myrank = 1, 0
        self._ragged = {}

    def rank_of(self, m, n):
        return 0

    def data_of(self, m, n):
        if (m, n) not in self._ragged:
            arr = np.zeros((self.mb, self.nb // 2), dtype=np.float32)
            self._ragged[(m, n)] = self._ctx.data(100 + m * 4 + n, arr)
        return self._ragged[(m, n)]

    def register(self, ctx, name):
        self._ctx = ctx
        return ctx.register_collection(name, self)


def _lint(P, lint, inserts, pools=1):
    """Run `inserts(P, ctx, pool_index, dtd)` over `pools` linted pools;
    returns (rule raised per insert, findings' rule ids per pool)."""
    raised, found = [], []
    with P.pt.Context(nb_workers=1) as ctx:
        carry = {}
        for i in range(pools):
            dtd = P.dtd.DtdTaskpool(ctx, lint=lint)
            for ins in inserts(P, ctx, i, dtd, carry):
                try:
                    ins()
                    raised.append(None)
                except P.LintError as e:
                    raised.append(e.rule)
            dtd.wait()
            found.append([r for r, _ in dtd.linter.findings]
                         if dtd.linter is not None else None)
            dtd.destroy()
    return raised, found


def _one_tile(modes_per_task, batched=False):
    def inserts(P, ctx, i, dtd, carry):
        t = dtd.tile_of(_data(ctx))
        if batched:
            return [lambda: dtd.insert_tasks(
                [(_noop, tuple((t, m) for m in modes))
                 for modes in modes_per_task])]
        return [lambda modes=modes: dtd.insert_task(
            _noop, *((t, m) for m in modes)) for modes in modes_per_task]
    return inserts


def _d102(P, ctx, i, dtd, carry):
    if i == 0:
        carry["t"] = dtd.tile_of(_data(ctx))
        return [lambda: dtd.insert_task(_noop, (carry["t"], "INOUT"))]
    return [lambda: dtd.insert_task(_noop, (carry["t"], "INPUT"))]


def _d104(P, ctx, i, dtd, carry):
    coll = _RaggedTiles(P)
    coll.register(ctx, "RAG")
    return [lambda: dtd.insert_task(_noop, (dtd.tile_of(coll, 0, 0),
                                            "INPUT"))]


def _d104_clean(P, ctx, i, dtd, carry):
    coll = P.data.TwoDimBlockCyclic(32, 32, 8, 8, dtype=np.float32)
    coll.register(ctx, "OK104")
    t = dtd.tile_of(coll, 0, 0)
    assert t.coll_stride == 8 * 8 * 4 == t.nbytes
    return [lambda: dtd.insert_task(_noop, (t, "INPUT"))]


def _d104_warn_and_data_tiles(P, ctx, i, dtd, carry):
    coll = _RaggedTiles(P)
    coll.register(ctx, "RAG2")
    d = dtd.tile_of(_data(ctx, n=3))  # no geometry: never flagged
    assert d.coll_stride is None
    return [lambda: dtd.insert_task(_noop, (dtd.tile_of(coll, 1, 1),
                                            "INPUT")),
            lambda: dtd.insert_task(_noop, (d, "INPUT"))]


LINT_CASES = {
    "d101_conflicting_duplicate": (True, _one_tile([("INPUT", "OUTPUT")]),
                                   1),
    "d101_same_mode_duplicate": (True, _one_tile([("INPUT", "INPUT")]), 1),
    "d101_inout_declared": (True, _one_tile([("INOUT",), ("INPUT",)]), 1),
    "d102_tile_from_destroyed_pool": (True, _d102, 2),
    "d103_dead_store": ("warn", _one_tile([("OUTPUT",)]), 1),
    "d103_read_back": ("warn", _one_tile([("OUTPUT",), ("INPUT",)]), 1),
    "warn_mode_records": ("warn", _one_tile([("INPUT", "OUTPUT"),
                                             ("INPUT",)]), 1),
    "lint_off_by_default": (False, _one_tile([("INPUT", "OUTPUT")]), 1),
    "batched_insert_linted": ("warn", _one_tile([("INPUT", "OUTPUT")],
                                                batched=True), 1),
    "d104_stride_mismatch": (True, _d104, 1),
    "d104_clean_twin": (True, _d104_clean, 1),
    "d104_warn_and_data_tiles": ("warn", _d104_warn_and_data_tiles, 1),
}


@pytest.mark.parametrize("case", sorted(LINT_CASES))
def test_dtd_lint_matches_reference(case):
    lint, inserts, pools = LINT_CASES[case]
    ref, port = both(_lint, lint, inserts, pools)
    assert port == ref


def test_dtd_lint_oracles():
    """The rule ids the reference's linter tests pin, on the port."""
    def run(case):
        lint, inserts, pools = LINT_CASES[case]
        return _lint(PORT, lint, inserts, pools)

    assert run("d101_conflicting_duplicate")[0] == ["D101"]
    assert run("d102_tile_from_destroyed_pool")[0] == [None, "D102"]
    assert run("d103_dead_store")[1] == [["D103"]]
    assert run("d103_read_back")[1] == [[]]
    assert run("lint_off_by_default")[1] == [None]
    assert run("d104_stride_mismatch")[0] == ["D104"]
    assert "D104" in run("d104_warn_and_data_tiles")[1][0]
    assert set(tanalysis.DTD_RULES) == {"D101", "D102", "D103", "D104"}


# ------------------------------------------------------------- ptg_to_dtd
def _chain_spec(P, ctx, nb):
    pt = P.pt
    arr = np.zeros(1, dtype=np.int64)
    ctx.register_linear_collection("A", arr, elem_size=8, nodes=1,
                                   myrank=0)
    ctx.register_arena("t", 8)
    tp = pt.Taskpool(ctx, globals={"NB": nb})
    k = pt.L("k")
    tc = tp.task_class("T")
    tc.param("k", 0, pt.G("NB"))
    tc.flow("A", "RW",
            pt.In(pt.Mem("A", 0), guard=(k == 0)),
            pt.In(pt.Ref("T", k - 1, flow="A")),
            pt.Out(pt.Ref("T", k + 1, flow="A"), guard=(k < pt.G("NB"))),
            pt.Out(pt.Mem("A", 0), guard=(k == pt.G("NB"))),
            arena="t")

    def body(view):
        view.data("A", dtype=np.int64, shape=(1,))[0] += 1
    tc.body(body)
    return tp, arr


def _fan_spec(P, ctx, nb):
    pt = P.pt
    arr = np.zeros(nb, dtype=np.int64)
    ctx.register_linear_collection("A", arr, elem_size=8, nodes=1,
                                   myrank=0)
    ctx.register_arena("t", 8)
    tp = pt.Taskpool(ctx, globals={"NB": nb - 1})
    k = pt.L("k")
    prod = tp.task_class("P")
    prod.param("k", 0, pt.G("NB"))
    prod.flow("X", "RW", pt.In(pt.Mem("A", k)),
              pt.Out(pt.Ref("C", k, flow="X")), arena="t")
    prod.body(lambda v: v.data("X", dtype=np.int64, shape=(1,))
              .__setitem__(0, 10 + v.local("k")))
    cons = tp.task_class("C")
    cons.param("k", 0, pt.G("NB"))
    cons.flow("X", "RW", pt.In(pt.Ref("P", k, flow="X")),
              pt.Out(pt.Mem("A", k)), arena="t")

    def cbody(view):
        view.data("X", dtype=np.int64, shape=(1,))[0] *= 2
    cons.body(cbody)
    return tp, arr


def _crosstile_spec(P, ctx, n):
    pt = P.pt
    arr = np.zeros(n, dtype=np.int64)
    ctx.register_linear_collection("A", arr, elem_size=8, nodes=1,
                                   myrank=0)
    ctx.register_arena("t", 8)
    tp = pt.Taskpool(ctx, globals={"NB": n - 1})
    k = pt.L("k")
    tc = tp.task_class("T")
    tc.param("k", 0, pt.G("NB"))
    tc.flow("X", "RW",
            pt.In(pt.Mem("A", 0), guard=(k == 0)),
            pt.In(pt.Ref("T", k - 1, flow="X")),
            pt.Out(pt.Ref("T", k + 1, flow="X"), guard=(k < pt.G("NB"))),
            pt.Out(pt.Mem("A", pt.G("NB")), guard=(k == pt.G("NB"))),
            arena="t")
    tc.body(lambda v: v.data("X", dtype=np.int64, shape=(1,))
            .__setitem__(0, v.data("X", dtype=np.int64, shape=(1,))[0] + 5))
    return tp, arr


def _ptg_vs_dtd(P, spec, n):
    """The spec run as PTG and through ptg_to_dtd: both buffers and the
    converted task count."""
    with P.pt.Context(nb_workers=2) as ctx:
        tp, arr = spec(P, ctx, n)
        tp.run()
        tp.wait()
        ptg = arr.tobytes()
    with P.pt.Context(nb_workers=2) as ctx:
        tp, arr = spec(P, ctx, n)
        stats = P.p2d.run_ptg_as_dtd(ctx, tp, {"A": None})
        dtd = arr.tobytes()
    return ptg, dtd, stats


def p2d_potrf(P):
    N, nb = 96, 32
    rng = np.random.default_rng(3)
    M = rng.standard_normal((N, N), dtype=np.float32)
    spd = M @ M.T + N * np.eye(N, dtype=np.float32)
    with P.pt.Context(nb_workers=2) as ctx:
        A = P.data.TwoDimBlockCyclic(N, N, nb, nb, dtype=np.float32)
        A.from_dense(spd)
        A.register(ctx, "A")
        tp = P.algos.build_potrf(ctx, A)
        stats = P.p2d.run_ptg_as_dtd(ctx, tp, {"A": A})
        out = np.tril(A.to_dense())
    return stats, out


@pytest.mark.parametrize("spec,n", [(_chain_spec, 17), (_fan_spec, 9),
                                    (_crosstile_spec, 8)],
                         ids=["chain", "fan", "crosstile_memout"])
def test_ptg_to_dtd_matches_reference(spec, n):
    ref, port = both(_ptg_vs_dtd, spec, n)
    assert port == ref
    ptg, dtd, stats = port
    assert dtd == ptg  # the two front ends agree on the port too
    assert stats["tasks"] >= n


def test_ptg_to_dtd_potrf_matches_reference():
    """The tool's flagship: the dense Cholesky PTG pool re-run through
    DTD, with host chores; the same task count on both packages, the
    factor within the reference's tolerance of numpy and of the
    reference's."""
    (rstats, rout), (pstats, pout) = both(p2d_potrf)
    nt = 3
    assert pstats == rstats
    assert pstats["tasks"] == nt + 2 * (nt * (nt - 1)) // 2 \
        + nt * (nt - 1) * (nt - 2) // 6
    np.testing.assert_allclose(pout, rout, rtol=1e-4, atol=1e-4)
    M = np.random.default_rng(3).standard_normal((96, 96), dtype=np.float32)
    spd = M @ M.T + 96 * np.eye(96, dtype=np.float32)
    np.testing.assert_allclose(pout, np.linalg.cholesky(spd), rtol=1e-4,
                               atol=1e-4)


def test_ptg_to_dtd_eval_expr_matches_reference():
    for P in (REF, PORT):
        k, NB = P.pt.L("k"), P.pt.G("NB")
        cases = [
            ((k + 3) * 2 - (k // 2), {"k": 5}, {"NB": 9}, 14),
            (P.pt.select(k % 2 == 0, k, -k), {"k": 7}, {"NB": 0}, -7),
            (P.pt.minimum(k, 4) + P.pt.maximum(k, 4), {"k": 2}, {"NB": 0},
             6),
            ((k < NB) & (k >= 0), {"k": 3}, {"NB": 4}, 1),
            (~(k == 3), {"k": 3}, {"NB": 0}, 0),
            ((k - 7) // 2 + (k - 7) % 3, {"k": 0}, {"NB": 0}, -4),
        ]
        for e, loc, glb, want in cases:
            assert P.p2d.eval_expr(e, loc, glb) == want, (P.name, e)


def _p2d_rejects(P, which):
    pt = P.pt
    with pt.Context(nb_workers=1) as ctx:
        arr = np.zeros(1, dtype=np.int64)
        ctx.register_linear_collection("A", arr, elem_size=8, nodes=1,
                                       myrank=0)
        ctx.register_arena("t", 8)
        tp = pt.Taskpool(ctx, globals={"NB": 0 if which == "cycle" else 3})
        k = pt.L("k")
        tc = tp.task_class("T")
        tc.param("k", 0, pt.G("NB"))
        if which == "ctl":
            tc.flow("Z", "CTL", pt.In(None), arena="t")
            tc.body_noop()
        else:
            tc.flow("X", "RW",
                    pt.In(pt.Ref("T", k - 1, flow="X"), guard=(k == 0)),
                    pt.In(pt.Ref("T", k * 0 - 1, flow="X"), guard=(k < 0)),
                    pt.Out(pt.Mem("A", 0), guard=(k == pt.G("NB"))),
                    arena="t")
            tc.body(lambda view: None)
        try:
            P.p2d.run_ptg_as_dtd(ctx, tp, {"A": None})
        except (NotImplementedError, ValueError) as e:
            return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("which", ["ctl", "cycle"])
def test_ptg_to_dtd_rejections_match_reference(which):
    ref, port = both(_p2d_rejects, which)
    assert port == ref
    assert port[0] == {"ctl": "NotImplementedError",
                       "cycle": "ValueError"}[which]


# ------------------------------------------------------------ JDF, host
def jdf_ex04(P):
    buf = np.array([300], dtype=np.int64)
    with P.pt.Context(nb_workers=1) as ctx:
        ctx.register_linear_collection("mydata", buf, elem_size=8)
        b = P.jdf.compile_jdf(REF_JDF.EX04, ctx, globals={"NB": 20},
                              dtype=np.int64)
        tp = b.run()
        tp.wait()
    return buf.tobytes(), tp.nb_total_tasks


def jdf_broadcast(P):
    buf = np.zeros(8, dtype=np.int64)
    got = []
    with P.pt.Context(nb_workers=1) as ctx:
        ctx.register_linear_collection("mydata", buf, elem_size=8)
        b = P.jdf.compile_jdf(REF_JDF.EX_BCAST, ctx, globals={"NB": 6},
                              dtype=np.int64)
        b.scope["got"] = got
        tp = b.run()
        tp.wait()
    return sorted(got), buf.tobytes(), tp.nb_total_tasks


def jdf_ctl_gather(P):
    done = []
    with P.pt.Context(nb_workers=2) as ctx:
        b = P.jdf.compile_jdf(REF_JDF.EX_CTL, ctx, globals={"N": 9})
        b.scope["done"] = done
        tp = b.run()
        tp.wait()
    return done, tp.nb_total_tasks


def jdf_inline_escape(P):
    ran = []
    with P.pt.Context(nb_workers=1) as ctx:
        b = P.jdf.compile_jdf(REF_JDF.EX_ESCAPE, ctx, globals={"nodes": 4})
        b.scope["ran"] = ran
        tp = b.run()
        tp.wait()
    return sorted(ran), tp.nb_total_tasks


def jdf_parse_structure(P):
    out = []
    for src in (REF_JDF.EX04, REF_PORTS.COMPLEX_DEPS,
                REF_PORTS.LOCAL_INDICES, REF_PORTS.BRANCHING):
        prog = P.jdf.parse_jdf(src)
        out.append(([g.name for g in prog.globals], prog.options,
                    [(t.name, t.params, t.affinity and t.affinity[0],
                      [(f.access, f.name, len(f.deps),
                        [(d.direction, d.target.kind, d.props)
                         for d in f.deps]) for f in t.flows],
                      [b.props for b in t.bodies]) for t in prog.tasks]))
    return out


def jdf_branching(P):
    NT = 5
    buf = np.zeros(NT, dtype=np.int64)
    counts = {"A": 0, "B": 0, "C": 0}
    with P.pt.Context(nb_workers=2) as ctx:
        ctx.register_linear_collection("A", buf, elem_size=8)
        b = P.jdf.compile_jdf(REF_PORTS.BRANCHING, ctx, globals={"NT": NT},
                              dtype=np.int64)
        b.scope["counts"] = counts
        tp = b.run()
        tp.wait()
    return counts, tp.nb_total_tasks, b.prog.options


def jdf_choice(P):
    """The DAG's shape is decided by each Choice body's random draw: the
    same seed on one worker draws the same decisions on both."""
    NT, NP = 6, 3
    buf = np.zeros(NT + 2, dtype=np.int64)
    decision = [0] * (NT + 1)
    trace = []
    random.seed(1234)
    with P.pt.Context(nb_workers=1) as ctx:
        ctx.register_linear_collection("A", buf, elem_size=8)
        b = P.jdf.compile_jdf(REF_PORTS.CHOICE, ctx,
                              globals={"NT": NT, "P": NP}, dtype=np.int64,
                              late_bound=["decision"])
        b.scope["decision"] = decision
        b.scope["trace"] = trace
        tp = b.run()
        tp.wait()
    return decision, sorted(trace), tp.nb_total_tasks


def jdf_complex_deps(P):
    NI, NK = 3, 4
    buf = np.zeros(NI, dtype=np.int64)
    with P.pt.Context(nb_workers=2) as ctx:
        ctx.register_linear_collection("descA", buf, elem_size=8)
        b = P.jdf.compile_jdf(REF_PORTS.COMPLEX_DEPS, ctx,
                              globals={"NI": NI, "NK": NK}, dtype=np.int64)
        tp = b.run()
        tp.wait()
    return tp.nb_total_tasks, buf.tobytes()


def jdf_udf(P):
    N = 5
    udf_calls = {"startup": [], "nb": 0}
    ran = {"Feeder": [], "Gated": []}
    hits = []
    with P.pt.Context(nb_workers=1) as ctx:
        b = P.jdf.compile_jdf(REF_PORTS.UDF, ctx, globals={"N": N})
        b.scope.update(udf_calls=udf_calls, ran=ran, N=N,
                       bound_hits=lambda: hits.append(1) or N - 1)
        tp = b.run()
        tp.wait()
    return udf_calls, {k: sorted(v) for k, v in ran.items()}, \
        tp.nb_total_tasks, len(hits) >= 1


def jdf_local_indices(P):
    MT, NT = 3, 2
    buf = np.zeros(MT * NT, dtype=np.int64)
    counts = {"STARTUP": 0, "tG": 0, "tA": 0, "tB": 0, "tC": 0}
    with P.pt.Context(nb_workers=2) as ctx:
        ctx.register_linear_collection("descA", buf, elem_size=8)
        b = P.jdf.compile_jdf(REF_PORTS.LOCAL_INDICES, ctx,
                              globals={"MT": MT, "NT": NT}, dtype=np.int64)
        b.scope["counts"] = counts
        tp = b.run()
        tp.wait()
    return counts, tp.nb_total_tasks, buf.tobytes()


# ptgpp write_check.jdf (the reference test's source, which that test
# keeps inside its function)
_WRITE_CHECK = """
NT    [ type = int ]
BLOCK [ type = int ]
STARTUP(k)
k = 0 .. NT
: A(k)
WRITE A1 -> A2 TASK1(k)
BODY
{
import numpy as np
A1[:] = np.arange(BLOCK) + k * BLOCK
}
END

TASK1(k)
k = 0 .. NT
: A(k)
WRITE A3 -> A1 TASK2(k)
RW    A1 <- A(k)
         -> A2 TASK2(k)
READ  A2 <- A1 STARTUP(k)
BODY
{
A1 += 1
A3[:] = A2
}
END

TASK2(k)
k = 0 .. NT
: A(k)
READ A1 <- A3 TASK1(k)
RW   A2 <- A1 TASK1(k)
        -> A(k)
BODY
{
checks.append(bool((A1 + 1 == A2).all()))
A2 += A1
}
END
"""


def jdf_write_check(P):
    NT, BLOCK = 3, 4
    checks = []
    buf = np.arange((NT + 1) * BLOCK, dtype=np.int64).reshape(NT + 1, BLOCK)
    with P.pt.Context(nb_workers=2) as ctx:
        ctx.register_linear_collection("A", buf, elem_size=BLOCK * 8)
        ctx.register_arena("tile", BLOCK * 8)
        b = P.jdf.compile_jdf(_WRITE_CHECK, ctx,
                              globals={"NT": NT, "BLOCK": BLOCK},
                              dtype=np.int64, late_bound=["checks"],
                              arenas={"A1": "tile", "A3": "tile"})
        b.scope["checks"] = checks
        tp = b.run()
        tp.wait()
    return checks, buf.tobytes(), tp.nb_total_tasks


_STARTUP = """
NI [ type = int ]
NJ [ type = int ]
STARTUP(i, j)
i = 0 .. NI - 1
j = 0 .. NJ - 1
valid1 = i == 1 && j == 1
valid2 = (i == 1) && (j == 1)
: descA(i)
READ A <- descA(i)
; i * 10 + j
BODY
{
assert valid1 == valid2
prios.append((i, j, this.priority))
}
END
"""


def jdf_startup_priority_clause(P):
    prios = []
    buf = np.zeros(4, dtype=np.int64)
    with P.pt.Context(nb_workers=1, scheduler="ap") as ctx:
        ctx.register_linear_collection("descA", buf, elem_size=8)
        b = P.jdf.compile_jdf(_STARTUP, ctx, globals={"NI": 2, "NJ": 3},
                              dtype=np.int64, late_bound=["prios"])
        b.scope["prios"] = prios
        b.run().wait()
    return sorted(prios)


_FORWARD_NULL = """
NB [ type = int ]
Task(k)
k = 0 .. NB
: taskdist(k)
{access} A <- (k == 0) ? NULL : A Task(k - 1)
        -> (k < NB) ? A Task(k + 1)
BODY
{{
seen.append((k, A is None))
}}
END
"""


def _forward_null(P, access):
    seen = []
    buf = np.zeros(8, dtype=np.int64)
    with P.pt.Context(nb_workers=1) as ctx:
        ctx.register_linear_collection("taskdist", buf, elem_size=8)
        b = P.jdf.compile_jdf(_FORWARD_NULL.format(access=access), ctx,
                              globals={"NB": 5}, dtype=np.int64,
                              late_bound=["seen"])
        b.scope["seen"] = seen
        b.run().wait()
    return sorted(seen)


def jdf_forward_read_null(P):
    return _forward_null(P, "READ")


def jdf_forward_rw_null(P):
    return _forward_null(P, "RW")


_DYN_GUARD = """
NT [ type="int" ]
state [ type = "int *" ]

C(k)
k = 0 .. NT
: A(k)
RW D <- (k == 0) ? A(k)
     <- %{ return (k > 0) and (state[k-1] == 1) %} ? D C(k-1)
     -> %{ return state[k] == 1 %} ? D C(k+1)
BODY
{
state[k] = 1
ran.append(k)
D[0] += k
}
END
"""


def jdf_dynamic_guard_chain(P):
    out = []
    for _ in range(3):
        buf = np.zeros(8, dtype=np.int64)
        state, ran = [0] * 6, []
        with P.pt.Context(nb_workers=2) as ctx:
            ctx.register_linear_collection("A", buf, elem_size=8)
            b = P.jdf.compile_jdf(_DYN_GUARD, ctx, globals={"NT": 4},
                                  dtype=np.int64, late_bound=["state"])
            b.scope["state"] = state
            b.scope["ran"] = ran
            b.run().wait()
        out.append((ran, buf.tobytes()))
    return out


def jdf_pointer_global(P):
    src = """
arr [ type = "int *" ]
NX  [ type = "int" ]
T(k)
k = 0 .. NX
BODY
{
arr[k] = k * k
}
END
"""
    with P.pt.Context(nb_workers=1) as ctx:
        with pytest.raises(ValueError, match="pointer global 'arr'"):
            P.jdf.compile_jdf(src, ctx, globals={"NX": 2})
        b = P.jdf.compile_jdf(src, ctx, globals={"NX": 2},
                              late_bound=["arr"])
        b.scope["arr"] = [0, 0, 0]
        b.run().wait()
        return b.scope["arr"]


JDF_HOST = [jdf_ex04, jdf_broadcast, jdf_ctl_gather, jdf_inline_escape,
            jdf_parse_structure, jdf_branching, jdf_choice,
            jdf_complex_deps, jdf_udf, jdf_local_indices, jdf_write_check,
            jdf_startup_priority_clause, jdf_forward_read_null,
            jdf_forward_rw_null, jdf_dynamic_guard_chain,
            jdf_pointer_global]


@pytest.mark.parametrize("scenario", JDF_HOST, ids=lambda f: f.__name__)
def test_jdf_host_matches_reference(scenario):
    ref, port = both(scenario)
    assert port == ref


def test_jdf_oracles():
    """The values the reference's JDF tests pin, on the port."""
    assert jdf_ex04(PORT) == (np.int64(321).tobytes(), 21)
    assert jdf_ctl_gather(PORT) == ([1], 11)
    assert jdf_branching(PORT)[:2] == ({"A": 5, "B": 10, "C": 5}, 20)
    ntri = 4 * 5 // 2
    assert jdf_complex_deps(PORT)[0] == 3 * 4 * 3 + 2 * 3 * ntri
    assert jdf_local_indices(PORT)[:2] == (
        {"STARTUP": 25, "tG": 1, "tA": 90, "tB": 90, "tC": 5}, 211)
    checks, buf, _ = jdf_write_check(PORT)
    assert checks == [True] * 4
    assert buf == (2 * np.arange(16, dtype=np.int64) + 1).tobytes()
    assert jdf_dynamic_guard_chain(PORT)[0][0] == [0, 1, 2, 3, 4]
    decision, trace, _ = jdf_choice(PORT)
    ran = {}
    for name, k, _ in trace:
        ran.setdefault(name, []).append(k)
    for k in range(6):
        assert (decision[k] == 1) == (k in ran.get("TA", []))
        assert (decision[k] == 2) == (k in ran.get("TB", []))


_REJECTS = {
    "output_new": ("TASK(k)\nk = 0 .. 10\n: A(k)\nRW A <- A(k)\n"
                   "     -> ( k < 5 ) ? NEW\nBODY\n{\npass\n}\nEND\n",
                   "compile", "NEW only supported in IN dependencies"),
    "output_null": ("TASK(k)\nk = 0 .. 10\n: A(k)\nRW A <- A(k)\n"
                    "     -> NULL\nBODY\n{\npass\n}\nEND\n",
                    "compile", "NULL data only supported in IN "
                    "dependencies"),
    "unknown_class_property": ("NX [ type=\"int\" ]\nT(k) [ bogus_prop = "
                               "zzz ]\nk = 0 .. NX\nBODY\n{\npass\n}\n"
                               "END\n", "compile", "bogus_prop"),
    "unregistered_dep_type": (
        "NX [ type=\"int\" ]\nP(k)\nk = 0 .. NX\n: A(k)\nRW X <- A(k)\n"
        "     -> X Q(k)  [type = colT]\nBODY\n{\npass\n}\nEND\n"
        "Q(k)\nk = 0 .. NX\n: A(k)\nREAD X <- X P(k)  [type = colT]\n"
        "BODY\n{\npass\n}\nEND\n", "compile", "no registered datatype"),
    "too_many_local_vars": (
        "TASK(k)\nk = 0 .. 3\n" + "\n".join(f"l{i} = {i}"
                                            for i in range(25))
        + "\nBODY\n{\npass\n}\nEND\n", "run", "too many local variables"),
    "too_many_flows": (
        "PEER(k)\nk = 0 .. 0\n" + "\n".join(
            f"CTL X{i} <- X{i} PEER(k)" for i in range(21))
        + "\nBODY\n{\npass\n}\nEND\n", "run", "too many flows"),
}


def _reject(P, case):
    src, stage, _ = _REJECTS[case]
    buf = np.zeros(11, dtype=np.int64)
    with P.pt.Context(nb_workers=1) as ctx:
        ctx.register_linear_collection("A", buf, elem_size=8)
        try:
            b = P.jdf.compile_jdf(src, ctx, globals={"NX": 2},
                                  dtype=np.int64)
            if stage == "run":
                b.run()
        except ValueError as e:
            return str(e)
    return None


@pytest.mark.parametrize("case", sorted(_REJECTS))
def test_jdf_rejections_match_reference(case):
    ref, port = both(_reject, case)
    assert port == ref
    assert _REJECTS[case][2] in port


def test_jdf_dep_type_resolves_registered_datatypes():
    """[type = name] binds a registered datatype: plain, indexed and
    cast ones register on the port's Context as on the reference's."""
    def run(P):
        src = _REJECTS["unregistered_dep_type"][0]
        buf = np.zeros(4, dtype=np.int64)
        with P.pt.Context(nb_workers=1) as ctx:
            ctx.register_linear_collection("A", buf, elem_size=8)
            ids = [ctx.register_datatype("colT", 8, 1),
                   ctx.register_datatype_indexed("idx", [(0, 4), (8, 4)]),
                   ctx.register_datatype_cast("f2d", np.float32,
                                              np.float64, 4)]
            b = P.jdf.compile_jdf(src, ctx, globals={"NX": 2},
                                  dtype=np.int64)
            b.run().wait()
            tc = b.tp.class_by_name("P")
            with pytest.raises(ValueError, match="unsupported element"):
                ctx.register_datatype_cast("bad", np.complex64, np.float32)
            return (ids, dict(ctx.datatype_bytes),
                    sorted({d.dtype for f in tc.flows for d in f.deps
                            if d.dtype}), ctx.reshape_stats())
    ref, port = both(run)
    assert port == ref
    assert port[2] == ["colT"]


# ---------------------------------------------------- tutorial examples
EXAMPLES = sorted(f for f in os.listdir(os.path.join(REPO, "examples"))
                  if f.startswith("Ex0") and f.endswith(".jdf"))


def _run_example(P, name):
    """examples/run_example.py's setup, on package P: the buffer, the
    task count and (Ex08) the reshape futures' stats.  Ex06 runs on one
    worker: on more, whether its pool aborts is a race (see below)."""
    with open(os.path.join(REPO, "examples", name)) as f:
        src = f.read()
    reshape = "Reshape" in name
    workers = 1 if name == "Ex06_RAW.jdf" else None
    with P.pt.Context(nb_workers=workers) as ctx:
        if reshape:
            n, nb_tiles = 4, 11
            buf = np.ones(nb_tiles * n * n, dtype=np.int64)
            ctx.register_linear_collection("descA", buf,
                                           elem_size=n * n * 8)
            ctx.register_datatype_indexed(
                "LOWER", [(i * n * 8, (i + 1) * 8) for i in range(n)])
        else:
            buf = np.zeros(64, dtype=np.int64)
            buf[0] = 300
            ctx.register_linear_collection("mydata", buf, elem_size=8)
        ctx.register_arena("default", 64)
        b = P.jdf.compile_jdf(src, ctx, globals={"NB": 10, "N": 10},
                              dtype=np.int64, arenas={"A": "default"})
        tp = b.run()
        try:
            tp.wait()
            aborted = False
        except RuntimeError:  # a body's assertion failed
            aborted = True
        stats = ctx.reshape_stats() if reshape else None
    return buf.tobytes(), tp.nb_total_tasks, stats, aborted


def test_examples_are_all_listed():
    assert len(EXAMPLES) == 8


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_jdf_matches_reference(name):
    ref, port = both(_run_example, name)
    assert port == ref
    # Ex06's readers assert the pre-update value.  On one worker the RW
    # Update runs before the READ readers on BOTH packages (one shared
    # native core) and writes the broadcast copy in place: the readers
    # see 107 and the pool aborts on each
    assert port[3] == (name == "Ex06_RAW.jdf")
    if "Reshape" in name:
        tiles = np.frombuffer(port[0], dtype=np.int64).reshape(11, 4, 4)
        low = np.tril(np.ones((4, 4), dtype=bool))
        assert (tiles[:, low] == 0).all() and (tiles[:, ~low] == 1).all()
        assert port[2][0] > 0


def test_ex10_crosscheck_on_the_port():
    """Ex10 on the port's pools: the builder of the port's example
    (parsec_tpu_torch.examples.Ex10_CrossCheck) against the reference's
    (examples/Ex10_CrossCheck.py), run as PTG under the hwcounters PINS
    module (each class's tasks sampled, as on the reference) and through
    DTD, against the reference's numbers."""
    ex10 = {"ref": _load("examples/Ex10_CrossCheck.py", "_ex10_crosscheck"),
            "port": importlib.import_module(
                "parsec_tpu_torch.examples.Ex10_CrossCheck")}

    def run(P):
        pins = P.pt.profiling.pins
        with P.pt.Context(nb_workers=2) as ctx:
            hw = pins.HwCounters()
            pins.enable_pins(ctx, hw)
            tp, arr = ex10[P.name].build(ctx, 12)
            tp.run()
            tp.wait()
            ptg = arr.tobytes()
            tasks = {cid: c[0] for cid, c in hw.counters.items()}
            rep = [line.split(" utime")[0] for line in
                   hw.report({0: "P", 1: "C"}).splitlines()]
            assert tasks == {0: 12, 1: 12}
            assert rep == ["P: tasks=12", "C: tasks=12"]
        with P.pt.Context(nb_workers=2) as ctx:
            tp, arr = ex10[P.name].build(ctx, 12)
            stats = P.p2d.run_ptg_as_dtd(ctx, tp, {"A": None})
            return ptg, arr.tobytes(), stats

    ref, port = both(run)
    assert port == ref
    assert port[0] == port[1]
    assert port[2] == {"tasks": 24, "classes": 2}


# ------------------------------------------------------- device tasks
def _ref_device(ctx):
    from parsec_tpu.device import TpuDevice
    return TpuDevice(ctx)


def _device(P, ctx, **kw):
    return _ref_device(ctx) if P is REF else CudaDevice(ctx, device="cpu",
                                                        **kw)


def dtd_device_gemm(P):
    """BASELINE rung 2 (the reference's test_dtd_tiled_gemm_on_device):
    C += A @ B as DTD device tasks, an INOUT chain of nt per C tile."""
    nt, nb = 3, 8
    N = nt * nb
    rng = np.random.default_rng(7)
    with P.pt.Context(nb_workers=1) as ctx:
        A, B, C = (P.data.TwoDimBlockCyclic(N, N, nb, nb, dtype=np.float32)
                   for _ in range(3))
        A.from_dense(rng.standard_normal((N, N), dtype=np.float32))
        B.from_dense(rng.standard_normal((N, N), dtype=np.float32))
        C.from_dense(np.zeros((N, N), dtype=np.float32))
        for name, coll in (("A", A), ("B", B), ("C", C)):
            coll.register(ctx, name)
        dev = _device(P, ctx)
        dtd = P.dtd.DtdTaskpool(ctx)
        insert = dtd.insert_tpu_task if P is REF else dtd.insert_cuda_task

        def k_gemm(a, b, c):
            return c + a @ b

        for m in range(nt):
            for n in range(nt):
                for k in range(nt):
                    insert(dev, k_gemm, (dtd.tile_of(A, m, k), "INPUT"),
                           (dtd.tile_of(B, k, n), "INPUT"),
                           (dtd.tile_of(C, m, n), "INOUT"),
                           shapes={i: (nb, nb) for i in range(3)})
        dtd.wait()
        dev.flush()
        tasks = dev.stats["tasks"]
        dev.stop()
        out = C.to_dense()
        ab = A.to_dense() @ B.to_dense()
        dtd.destroy()
    return out, ab, tasks


def test_dtd_device_gemm_matches_reference():
    (rc, _, rtasks), (pc, ab, ptasks) = both(dtd_device_gemm)
    assert ptasks == rtasks == 27
    np.testing.assert_allclose(pc, rc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pc, ab, rtol=1e-5, atol=1e-5)


def _ref_norm_kernel(eps):
    from parsec_tpu.ops.rms_norm import rms_norm

    def k_norm(x, w):
        return rms_norm(x, w[0], eps)
    return k_norm


def _port_norm_kernel(eps):
    def k_norm(x, w):
        return torch_rms_norm(x, w[0], eps)
    return k_norm


def dtd_device_norm(P, R=3, T=128, d=128, eps=1e-6):
    """NORM as DTD device tasks: O(r) = rms_norm(X(r), W), one task per
    row tile, each one launch."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((R * T, d), dtype=np.float32)
    w = rng.standard_normal((1, d), dtype=np.float32)
    with P.pt.Context(nb_workers=2) as ctx:
        X = P.data.TwoDimBlockCyclic(R * T, d, T, d, dtype=np.float32)
        W = P.data.TwoDimBlockCyclic(1, d, 1, d, dtype=np.float32)
        O = P.data.TwoDimBlockCyclic(R * T, d, T, d, dtype=np.float32)
        X.from_dense(x)
        W.from_dense(w)
        O.from_dense(np.zeros_like(x))
        for name, coll in (("X", X), ("W", W), ("O", O)):
            coll.register(ctx, name)
        dev = _device(P, ctx)
        dtd = P.dtd.DtdTaskpool(ctx)
        insert = dtd.insert_tpu_task if P is REF else dtd.insert_cuda_task
        kern = (_ref_norm_kernel if P is REF else _port_norm_kernel)(eps)
        for r in range(R):
            insert(dev, kern, (dtd.tile_of(X, r, 0), "INPUT"),
                   (dtd.tile_of(W, 0, 0), "INPUT"),
                   (dtd.tile_of(O, r, 0), "OUTPUT"),
                   shapes={0: (T, d), 1: (1, d), 2: (T, d)})
        dtd.wait()
        dev.flush()
        tasks = dev.stats["tasks"]
        dev.stop()
        out = O.to_dense()
        dtd.destroy()
    return out, x, w, tasks


def test_dtd_device_norm_matches_reference():
    (rout, _, _, rtasks), (pout, x, w, ptasks) = both(dtd_device_norm)
    assert ptasks == rtasks == 3
    np.testing.assert_allclose(pout, rout, rtol=2e-5, atol=2e-5)
    plain = rms_norm_plain(torch.from_numpy(x), torch.from_numpy(w[0]),
                           1e-6).numpy()
    np.testing.assert_array_equal(pout, plain)


def dtd_device_fatt(P, H=2, L=128, D=32):
    """FATT as DTD device tasks: O(h) = attention(Q(h), K, V), one task
    per query head over one shared K/V tile each."""
    rng = np.random.default_rng(13)
    q = rng.standard_normal((H * L, D), dtype=np.float32)
    k = rng.standard_normal((L, D), dtype=np.float32)
    v = rng.standard_normal((L, D), dtype=np.float32)
    sc = D ** -0.5
    with P.pt.Context(nb_workers=2) as ctx:
        Q, O = (P.data.TwoDimBlockCyclic(H * L, D, L, D, dtype=np.float32)
                for _ in range(2))
        K, V = (P.data.TwoDimBlockCyclic(L, D, L, D, dtype=np.float32)
                for _ in range(2))
        Q.from_dense(q)
        K.from_dense(k)
        V.from_dense(v)
        O.from_dense(np.zeros_like(q))
        for name, coll in (("Q", Q), ("K", K), ("V", V), ("O", O)):
            coll.register(ctx, name)
        dev = _device(P, ctx)
        dtd = P.dtd.DtdTaskpool(ctx)
        if P is REF:
            from parsec_tpu.ops.flash_attention import flash_attention

            def k_fatt(qb, kb, vb):
                return flash_attention(qb[None, :, None, :],
                                       kb[None, :, None, :],
                                       vb[None, :, None, :],
                                       scale=sc)[0, :, 0, :]
            insert = dtd.insert_tpu_task
        else:
            def k_fatt(qb, kb, vb):
                return torch_flash(qb[None], kb[None], vb[None], False,
                                   sc)[0]
            insert = dtd.insert_cuda_task
        for h in range(H):
            insert(dev, k_fatt, (dtd.tile_of(Q, h, 0), "INPUT"),
                   (dtd.tile_of(K, 0, 0), "INPUT"),
                   (dtd.tile_of(V, 0, 0), "INPUT"),
                   (dtd.tile_of(O, h, 0), "OUTPUT"),
                   shapes={0: (L, D), 1: (L, D), 2: (L, D), 3: (L, D)})
        dtd.wait()
        dev.flush()
        tasks = dev.stats["tasks"]
        dev.stop()
        out = O.to_dense()
        dtd.destroy()
    return out, (q, k, v, sc), tasks


def test_dtd_device_fatt_matches_reference():
    (rout, _, rtasks), (pout, (q, k, v, sc), ptasks) = both(dtd_device_fatt)
    assert ptasks == rtasks == 2
    np.testing.assert_allclose(pout, rout, rtol=2e-5, atol=2e-5)
    want = attention_reference(
        torch.from_numpy(q).reshape(2, 128, 32),
        torch.from_numpy(k).expand(2, 128, 32),
        torch.from_numpy(v).expand(2, 128, 32), False, sc)
    np.testing.assert_allclose(pout, want.reshape(-1, 32).numpy(),
                               rtol=2e-5, atol=2e-5)


_NORM_JDF = """
R [ type = "int" ]

NORM(r)
r = 0 .. R
: X( r, 0 )

READ X <- X( r, 0 )
READ W <- W( 0, 0 )
RW   O <- O( r, 0 )
       -> O( r, 0 )

BODY [type={btype} reads=X,W writes=O{batch}]
{{
{body}
}}
END

BODY
{{
raise RuntimeError("the host incarnation must not run")
}}
END
"""


def jdf_device_norm(P, batch, R=3, T=128, d=128, eps=1e-6):
    """A JDF class whose device body calls the package's RMSNorm op (the
    reference's BODY type=TPU with jnp, the port's type=CUDA with
    torch), compiled with dev=."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((R * T, d), dtype=np.float32)
    w = rng.standard_normal((1, d), dtype=np.float32)
    if P is REF:
        from parsec_tpu.ops.rms_norm import rms_norm
        # the reference vmaps a batched body: it sees single tiles
        btype, body = "TPU", "O = rms_norm(X, W[0], eps)"
    else:
        rms_norm = torch_rms_norm
        # the port passes [lanes, *tile] stacks, batched or not
        btype, body = "CUDA", "O = rms_norm(X, W[0, 0], eps)"
    src = _NORM_JDF.format(btype=btype, body=body,
                           batch="" if batch else " batch=0")
    with P.pt.Context(nb_workers=2) as ctx:
        X = P.data.TwoDimBlockCyclic(R * T, d, T, d, dtype=np.float32)
        W = P.data.TwoDimBlockCyclic(1, d, 1, d, dtype=np.float32)
        O = P.data.TwoDimBlockCyclic(R * T, d, T, d, dtype=np.float32)
        X.from_dense(x)
        W.from_dense(w)
        O.from_dense(np.zeros_like(x))
        for name, coll in (("X", X), ("W", W), ("O", O)):
            coll.register(ctx, name)
        dev = _device(P, ctx)
        b = P.jdf.compile_jdf(src, ctx, globals={"R": R - 1},
                              dtype=np.float32,
                              shapes={"X": (T, d), "W": (1, d), "O": (T, d)},
                              dev=dev)
        b.scope.update(rms_norm=rms_norm, eps=eps)
        tp = b.run()
        tp.wait()
        dev.flush()
        tasks = dev.stats["tasks"]
        dev.stop()
        out = O.to_dense()
    return out, x, w, tasks


@pytest.mark.parametrize("batch", [True, False], ids=["batched", "batch0"])
def test_jdf_device_norm_matches_reference(batch):
    (rout, _, _, rtasks), (pout, x, w, ptasks) = both(jdf_device_norm,
                                                      batch)
    assert ptasks == rtasks == 3
    np.testing.assert_allclose(pout, rout, rtol=2e-5, atol=2e-5)
    plain = rms_norm_plain(torch.from_numpy(x), torch.from_numpy(w[0]),
                           1e-6).numpy()
    np.testing.assert_allclose(pout, plain, rtol=2e-5, atol=2e-5)


def jdf_ex_tpu(P):
    """The reference's EX_TPU source, compiled unchanged on both: its
    `type=TPU` body is the port's device incarnation too."""
    with P.pt.Context(nb_workers=1) as ctx:
        vec = P.data.VectorCyclic(16, 4, dtype=np.float32)
        for k in range(4):
            vec.seg(k)[:] = k
        vec.register(ctx, "A")
        dev = _device(P, ctx)
        b = P.jdf.compile_jdf(REF_JDF.EX_TPU, ctx, globals={"MT": 3},
                              dtype=np.float32, shapes={"X": (4,)},
                              dev=dev)
        tp = b.run()
        tp.wait()
        dev.flush()
        tasks = dev.stats["tasks"]
        dev.stop()
        return [vec.seg(k).tobytes() for k in range(4)], tasks


def test_jdf_ex_tpu_source_compiles_unchanged():
    ref, port = both(jdf_ex_tpu)
    assert port == ref
    assert port[0] == [np.full(4, 2.0 * k + 1.0, np.float32).tobytes()
                       for k in range(4)]
    assert port[1] == 4


def test_jdf_device_body_without_device_runs_the_host_body():
    """dev=None skips the device incarnation: the host body runs."""
    def run(P):
        with P.pt.Context(nb_workers=1) as ctx:
            vec = P.data.VectorCyclic(16, 4, dtype=np.float32)
            for k in range(4):
                vec.seg(k)[:] = k
            vec.register(ctx, "A")
            b = P.jdf.compile_jdf(REF_JDF.EX_TPU, ctx, globals={"MT": 3},
                                  dtype=np.float32, shapes={"X": (4,)})
            b.run().wait()
            return [vec.seg(k).tobytes() for k in range(4)]
    ref, port = both(run)
    assert port == ref


def test_dtd_device_f64_refused():
    """A float64 device task is refused at insert (the device module
    refuses float64 and DTD has no host chore to fall back to), with a
    message that points at insert_task and names no JAX."""
    with tpt.Context(nb_workers=1) as ctx:
        d = ctx.data(0, np.zeros(4, dtype=np.float64))
        dev = CudaDevice(ctx, device="cpu")
        dtd = tdtd.DtdTaskpool(ctx)
        with pytest.raises(ValueError, match="float64") as ei:
            dtd.insert_cuda_task(dev, lambda a: a, (dtd.tile_of(d), "INOUT"),
                                 shapes={0: (4,)}, dtype=np.float64)
        assert "insert_task" in str(ei.value)
        assert "JAX" not in str(ei.value) and "jax" not in str(ei.value)
        dtd.wait()
        assert dev._dtd_bodies == {}
        dev.stop()
        dtd.destroy()


def test_dtd_failing_kernel_fails_the_pool():
    """A device task whose kernel raises fails the pool: wait() returns
    (raising the abort), the successors never run, and no body is left
    behind under a tag."""
    ran = []
    with tpt.Context(nb_workers=2) as ctx:
        buf = np.zeros(8, dtype=np.float32)
        dev = CudaDevice(ctx, device="cpu")
        dtd = tdtd.DtdTaskpool(ctx)
        t = dtd.tile_of(ctx.data(0, buf))

        def k_ok(x):
            return x + 1

        def k_bad(x):
            raise RuntimeError("kernel launch failed")

        dtd.insert_cuda_task(dev, k_ok, (t, "INOUT"))
        dtd.insert_cuda_task(dev, k_bad, (t, "INOUT"))
        try:
            for _ in range(4):
                dtd.insert_cuda_task(dev, k_ok, (t, "INOUT"))
            dtd.insert_task(lambda v: ran.append(1), (t, "INPUT"))
        except RuntimeError as e:  # the abort may refuse a late insert
            assert "aborted" in str(e)
        with pytest.raises(RuntimeError, match="aborted"):
            dtd.wait()
        assert dtd.tp.nb_errors > 0
        assert ran == []
        assert dev._dtd_bodies == {}
        dev.stop()
        dtd.destroy()


@pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
def test_dtd_device_window_throttle(P):
    """More device tasks than the window (4): insertion blocks until the
    manager thread drains, and never deadlocks."""
    with P.pt.Context(nb_workers=2) as ctx:
        buf = np.zeros(16, dtype=np.float32)
        dev = _device(P, ctx)
        dtd = P.dtd.DtdTaskpool(ctx, window=4)
        t = dtd.tile_of(ctx.data(0, buf))
        insert = dtd.insert_tpu_task if P is REF else dtd.insert_cuda_task

        def k_inc(x):
            return x + 1

        for _ in range(40):
            insert(dev, k_inc, (t, "INOUT"))
        dtd.wait()
        dev.flush()
        dev.stop()
        dtd.destroy()
    np.testing.assert_array_equal(buf, np.full(16, 40, np.float32))


def dtd_mixed_chain(P):
    """Host and device tasks on one tile in one pool: a host body reads
    the tile a device task has just written (its view syncs the dirty
    device mirror first), writes it, and the next device task reads the
    host's bytes."""
    seen = []
    with P.pt.Context(nb_workers=2) as ctx:
        buf = np.arange(32, dtype=np.float32)
        out = np.zeros(32, dtype=np.float32)
        dev = _device(P, ctx)
        dtd = P.dtd.DtdTaskpool(ctx)
        t, o = dtd.tile_of(ctx.data(0, buf)), dtd.tile_of(ctx.data(1, out))
        insert = dtd.insert_tpu_task if P is REF else dtd.insert_cuda_task

        def k_scale(x):
            return x * 2 + 1

        def host_read(v):
            seen.append(v.data(0, np.float32).copy())
            v.data(1, np.float32)[:] = v.data(0, np.float32) + 0.5

        def host_bump(v):
            v.data(0, np.float32)[:] += 1000

        insert(dev, k_scale, (t, "INOUT"))
        dtd.insert_task(host_read, (t, "INPUT"), (o, "INOUT"))
        dtd.insert_task(host_bump, (t, "INOUT"))
        insert(dev, k_scale, (t, "INOUT"))
        dtd.insert_task(host_read, (t, "INPUT"), (o, "INOUT"))
        dtd.wait()
        dev.flush()
        dev.stop()
        dtd.destroy()
    return seen, buf.copy(), out.copy()


def test_dtd_mixed_host_device_chain():
    (rseen, rbuf, rout), (seen, buf, out) = both(dtd_mixed_chain)
    x0 = np.arange(32, dtype=np.float32)
    x1 = x0 * 2 + 1
    x2 = (x1 + 1000) * 2 + 1
    np.testing.assert_array_equal(seen[0], x1)
    np.testing.assert_array_equal(seen[1], x2)
    np.testing.assert_array_equal(buf, x2)
    np.testing.assert_array_equal(out, x2 + 0.5)
    for a, b in zip((seen[0], seen[1], buf, out),
                    (rseen[0], rseen[1], rbuf, rout)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_dtd_and_ptg_bodies_share_one_device():
    """_body_for looks a DTD tag up before the class bodies: a PTG NORM
    pool and a DTD pool of device tasks on ONE CudaDevice in one context
    both dispatch their own kernels, interleaved."""
    from parsec_tpu_torch.ops.rms_norm import build_rms_norm
    R, T, d, eps = 4, 128, 128, 1e-6
    rng = np.random.default_rng(19)
    x = rng.standard_normal((R * T, d), dtype=np.float32)
    w = rng.standard_normal((1, d), dtype=np.float32)
    with tpt.Context(nb_workers=2) as ctx:
        X = tdata.TwoDimBlockCyclic(R * T, d, T, d, dtype=np.float32)
        W = tdata.TwoDimBlockCyclic(1, d, 1, d, dtype=np.float32)
        O = tdata.TwoDimBlockCyclic(R * T, d, T, d, dtype=np.float32)
        X.from_dense(x)
        W.from_dense(w)
        O.from_dense(np.zeros_like(x))
        vec = np.zeros(64, dtype=np.float32)
        dev = CudaDevice(ctx, device="cpu")
        ptg = build_rms_norm(ctx, X, W, O, eps, dev=dev)
        dtd = tdtd.DtdTaskpool(ctx)
        t = dtd.tile_of(ctx.data(7, vec))

        def k_inc(v):
            return v + 1

        ptg.run()
        for _ in range(10):
            dtd.insert_cuda_task(dev, k_inc, (t, "INOUT"))
        ptg.wait()
        dtd.wait()
        dev.flush()
        launches = dict(dev.launches)
        dev.stop()
        out = O.to_dense()
        dtd.destroy()
    np.testing.assert_array_equal(vec, np.full(64, 10, np.float32))
    np.testing.assert_array_equal(
        out, rms_norm_plain(torch.from_numpy(x), torch.from_numpy(w[0]),
                            eps).numpy())
    assert launches["k_inc"] == [10, 10]
    assert launches["k_norm"][1] == R


def test_dtd_tags_are_never_reused():
    """Two DTD pools in turn on one device, each with its own kernel:
    every task finds its own body, and no body outlives its pool."""
    with tpt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx, device="cpu")
        got = []
        tags = set()
        for step in (1.0, 10.0):
            vec = np.zeros(8, dtype=np.float32)
            dtd = tdtd.DtdTaskpool(ctx)
            t = dtd.tile_of(ctx.data(int(step), vec))

            def k_add(v, _s=step):
                return v + _s

            for _ in range(20):
                task = dtd.insert_cuda_task(dev, k_add, (t, "INOUT"))
                tags.add(tpt._native.lib.ptc_task_get_tag(task))
            dtd.wait()
            dev.flush()
            assert dev._dtd_bodies == {}
            got.append(vec.copy())
            dtd.destroy()
        dev.stop()
    assert len(tags) == 40
    np.testing.assert_array_equal(got[0], np.full(8, 20, np.float32))
    np.testing.assert_array_equal(got[1], np.full(8, 200, np.float32))


def test_dtd_prefetch_lane_stages_dtd_inputs():
    """The prefetch lane keys on copies, not bodies: queued DTD device
    tasks' read tiles are staged by a sweep and consumed as hits."""
    from parsec_tpu_torch.device.prefetch import _PrefetchLane
    n, T = 4, 64
    rng = np.random.default_rng(23)
    xs = [rng.standard_normal(T, dtype=np.float32) for _ in range(n)]
    outs = [np.zeros(T, dtype=np.float32) for _ in range(n)]
    with tpt.Context(nb_workers=1) as ctx:
        dev = CudaDevice(ctx, device="cpu", autostart=False, prefetch=True)
        dtd = tdtd.DtdTaskpool(ctx)
        for i in range(n):
            dtd.insert_cuda_task(dev, lambda x: x * 3,
                                 (dtd.tile_of(ctx.data(10 + i, xs[i])),
                                  "INPUT"),
                                 (dtd.tile_of(ctx.data(20 + i, outs[i])),
                                  "OUTPUT"))
        # a worker routes each ready task to the (undrained) device queue
        deadline = time.monotonic() + 60
        while ctx.device_queue_depth(dev.qid) < n:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        assert _PrefetchLane(dev)._sweep()
        dev.start()
        dtd.wait()
        dev.flush()
        stats = dict(dev.stats)
        dev.stop()
        dtd.destroy()
    assert stats["prefetch_staged"] >= n
    assert stats["prefetch_hits"] >= n
    for x, o in zip(xs, outs):
        np.testing.assert_array_equal(o, x * 3)


def test_dtd_inout_chain_under_the_lane_stays_current():
    """An INOUT chain of device tasks rewrites one tile again and again
    while the prefetch lane runs and a second tile is read by every
    task: the lane never installs an older version of the rewritten
    tile (its stage is refused once a newer mirror exists), so the
    chain's result is exact."""
    for rep in range(3):
        with tpt.Context(nb_workers=2) as ctx:
            acc = np.zeros(256, dtype=np.float32)
            one = np.ones(256, dtype=np.float32)
            dev = CudaDevice(ctx, device="cpu", prefetch=True)
            dtd = tdtd.DtdTaskpool(ctx)
            ta = dtd.tile_of(ctx.data(1, acc))
            tb = dtd.tile_of(ctx.data(2, one))
            for _ in range(60):
                dtd.insert_cuda_task(dev, lambda a, b: a + b,
                                     (ta, "INOUT"), (tb, "INPUT"))
            dtd.wait()
            dev.flush()
            assert dev.prefetch_error is None
            dev.stop()
            dtd.destroy()
        np.testing.assert_array_equal(acc, np.full(256, 60, np.float32))


def test_dtd_view_reads_the_device_bytes():
    """DtdView.data(sync=True) after a device task sees the device's
    bytes; sync=False sees the stale host copy."""
    with tpt.Context(nb_workers=1) as ctx:
        buf = np.zeros(8, dtype=np.float32)
        got = {}
        dev = CudaDevice(ctx, device="cpu")
        dtd = tdtd.DtdTaskpool(ctx)
        t = dtd.tile_of(ctx.data(0, buf))
        dtd.insert_cuda_task(dev, lambda x: x + 5, (t, "INOUT"))

        def host(v):
            got["stale"] = v.data(0, np.float32, sync=False).copy()
            got["synced"] = v.data(0, np.float32).copy()

        dtd.insert_task(host, (t, "INPUT"))
        dtd.wait()
        dev.stop()
        dtd.destroy()
    np.testing.assert_array_equal(got["stale"], np.zeros(8, np.float32))
    np.testing.assert_array_equal(got["synced"], np.full(8, 5, np.float32))

