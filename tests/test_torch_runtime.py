"""The port's runtime layers (parsec_tpu_torch core + data) against the
JAX package's on the same DAGs and data, plus the port's import guard."""
import ast
import os
import threading

import numpy as np
import pytest

import parsec_tpu as jpt
import parsec_tpu_torch as tpt
from parsec_tpu.data import TwoDimBlockCyclic as JaxBlockCyclic
from parsec_tpu_torch.convert import to_collection
from parsec_tpu_torch.data import TwoDimBlockCyclic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _readme_chain(pt, NB=100):
    """The README's chain DAG: Task(k) passes an arena datum to Task(k+1);
    returns the order the bodies ran in and the task count."""
    order, lock = [], threading.Lock()
    with pt.Context(nb_workers=2) as ctx:
        ctx.register_arena("t", 8)
        tp = pt.Taskpool(ctx, globals={"NB": NB})
        k = pt.L("k")
        tc = tp.task_class("Task")
        tc.param("k", 0, pt.G("NB"))
        tc.flow("A", "RW",
                pt.In(None, guard=(k == 0)),
                pt.In(pt.Ref("Task", k - 1, flow="A")),
                pt.Out(pt.Ref("Task", k + 1, flow="A"),
                       guard=(k < pt.G("NB"))),
                arena="t")

        def body(t):
            with lock:
                order.append(t["k"])

        tc.body(body)
        tp.run()
        tp.wait()
    return order, tp.nb_total_tasks


def test_readme_chain_same_in_both_packages():
    assert _readme_chain(tpt) == _readme_chain(jpt) == \
        (list(range(101)), 101)


def _chain_increment(pt, NB=20):
    """A datum threaded through memory, each task incrementing it."""
    buf = np.array([300], dtype=np.int64)
    seen = []
    with pt.Context(nb_workers=1) as ctx:
        ctx.register_linear_collection("mydata", buf, elem_size=8)
        tp = pt.Taskpool(ctx, globals={"NB": NB})
        k = pt.L("k")
        tc = tp.task_class("Task")
        tc.param("k", 0, pt.G("NB"))
        tc.affinity("mydata", k)
        tc.flow("A", "RW",
                pt.In(pt.Mem("mydata", 0), guard=(k == 0)),
                pt.In(pt.Ref("Task", k - 1, flow="A")),
                pt.Out(pt.Mem("mydata", 0), guard=(k == pt.G("NB"))),
                pt.Out(pt.Ref("Task", k + 1, flow="A"),
                       guard=(k < pt.G("NB"))))

        def body(t):
            a = t.data("A", dtype=np.int64)
            a[0] += 1
            seen.append(int(a[0]))

        tc.body(body)
        tp.run()
        tp.wait()
    return seen, int(buf[0])


def test_chain_data_increment_same_in_both_packages():
    assert _chain_increment(tpt) == _chain_increment(jpt) == \
        (list(range(301, 322)), 321)


def _tile_scale(pt, coll, dense):
    """Every tile of a registered collection scaled by 2 + its row index,
    by one CPU task per tile."""
    with pt.Context(nb_workers=2) as ctx:
        coll.register(ctx, "S")
        coll.from_dense(dense)
        tp = pt.Taskpool(ctx, globals={"MT": coll.mt - 1,
                                       "NT": coll.nt - 1})
        m, n = pt.L("m"), pt.L("n")
        tc = tp.task_class("Scale")
        tc.param("m", 0, pt.G("MT"))
        tc.param("n", 0, pt.G("NT"))
        tc.affinity("S", m, n)
        tc.flow("X", "RW", pt.In(pt.Mem("S", m, n)), pt.Out(pt.Mem("S", m, n)))

        def body(t):
            x = t.data("X", np.float32, (coll.mb, coll.nb))
            x *= 2 + t["m"]

        tc.body(body)
        tp.run()
        tp.wait()
        return coll.to_dense()


def test_block_cyclic_round_trip_and_dag_match_reference():
    dense = np.random.default_rng(0).standard_normal((40, 24)) \
        .astype(np.float32)
    port = to_collection(dense, 16, 8)
    ref = JaxBlockCyclic(40, 24, 16, 8, dtype=np.float32)
    ref.from_dense(dense)
    assert (port.mt, port.nt) == (ref.mt, ref.nt) == (3, 3)
    assert port.tile_shape(2, 2) == ref.tile_shape(2, 2) == (8, 8)
    np.testing.assert_array_equal(port.to_dense(), dense)
    np.testing.assert_array_equal(port.to_dense(), ref.to_dense())
    grid = TwoDimBlockCyclic(64, 64, 16, 16, P=2, Q=2, nodes=4)
    jgrid = JaxBlockCyclic(64, 64, 16, 16, P=2, Q=2, nodes=4)
    assert [grid.rank_of(m, n) for m in range(4) for n in range(4)] == \
        [jgrid.rank_of(m, n) for m in range(4) for n in range(4)]
    out_port = _tile_scale(tpt, TwoDimBlockCyclic(40, 24, 16, 8), dense)
    out_ref = _tile_scale(jpt, JaxBlockCyclic(40, 24, 16, 8), dense)
    np.testing.assert_array_equal(out_port, out_ref)


def test_unported_hooks_are_refused(monkeypatch):
    """The hooks this test once found refused are ported now: the
    runtime.pins parameter installs its chain at Context init, as the
    reference's does, and run(verify=True) verifies and runs."""
    monkeypatch.setenv("PTC_MCA_runtime_pins", "print_steals")
    with tpt.Context(nb_workers=1) as ctx:
        assert [m.name for m in ctx._pins_chain.modules] == \
            ["print_steals"]
    monkeypatch.delenv("PTC_MCA_runtime_pins")
    with tpt.Context(nb_workers=1) as ctx:
        assert ctx._pins_chain is None
        tp = tpt.Taskpool(ctx, globals={"NB": 3})
        tc = tp.task_class("Noop")
        tc.param("k", 0, tpt.G("NB"))
        tc.body_noop()
        tp.run(verify=True)
        tp.wait()
        assert tp.nb_total_tasks == 4


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "torch_path_profile.py")]
    for root, _, names in os.walk(os.path.join(REPO, "parsec_tpu_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    return sorted(files)


def test_port_imports_neither_jax_nor_the_jax_package():
    banned = ("jax", "jaxlib", "parsec_tpu")
    found = []
    files = _port_files()
    assert len(files) > 10
    # the walk reaches every subpackage, the serving path's and the DSL
    # front ends' included
    walked = {os.path.relpath(p, REPO) for p in files}
    for sub in ("ops/paged_attention.py", "serve/engine.py",
                "serve/server.py", "profiling/scope.py",
                "profiling/metrics.py", "algos/_util.py", "algos/potrf.py",
                "algos/trsm.py", "algos/lu.py", "algos/inverse.py",
                "algos/qr.py", "device/bench_utils.py",
                "device/prefetch.py", "dsl/__init__.py", "dsl/dtd.py",
                "dsl/jdf.py", "dsl/ptg_to_dtd.py", "analysis/__init__.py",
                "analysis/dtdlint.py", "analysis/flowgraph.py",
                "core/future.py", "core/compose.py",
                "algos/matrix_ops.py", "algos/redistribute.py",
                "algos/reshape.py", "profiling/trace.py",
                "profiling/critpath.py"):
        assert os.path.join("parsec_tpu_torch", sub) in walked, sub
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "attr", getattr(node.func, "id", "")) in (
                        "import_module", "__import__"):
                mods = [a.value for a in node.args[:1]
                        if isinstance(a, ast.Constant)]
            else:
                continue
            for mod in mods:
                if mod.split(".")[0] in banned:
                    found.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert not found, found
