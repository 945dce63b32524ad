"""The port's static analyses (parsec_tpu_torch.analysis: flowgraph,
verify, plan, tune, control) and its copies of comm/economics.py and
comm/topology.py, held against parsec_tpu on the same graphs.

Every case builds the same graph on both packages (the same builder,
the same inputs made from a seed) and compares what the analyses say,
exactly: verifier findings with their rule ids, severities, classes,
flows, source locations, counts and messages; plans by their JSON
rendering (timing fields aside); the schedule simulator's predicted
nanoseconds for the same knob vectors; the controller's decision logs
under a simulated clock.  Nothing here is timing-dependent: where a
run executes, only its results and the plan's structure are compared.

Mirrors the one-rank cases of tests/analysis/* and
tests/ops/test_ops_taskpools.py (the JDF fixtures of
test_verify_rules.py are read from that file), and checks that the
port's own builders verify and plan clean, as
tests/analysis/test_verify_intree.py requires of the reference's."""
import importlib
import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import parsec_tpu as jpt
import parsec_tpu.algos as jalgos
import parsec_tpu.analysis as jan
import parsec_tpu.analysis.control as jcontrol
import parsec_tpu.analysis.flowgraph as jfg
import parsec_tpu.analysis.tune as jtune
import parsec_tpu.comm.economics as jecon
import parsec_tpu.comm.topology as jtopo
import parsec_tpu.utils as jutils
import parsec_tpu_torch as tpt
import parsec_tpu_torch.algos as talgos
import parsec_tpu_torch.analysis as tan
import parsec_tpu_torch.analysis.control as tcontrol
import parsec_tpu_torch.analysis.flowgraph as tfg
import parsec_tpu_torch.analysis.tune as ttune
import parsec_tpu_torch.comm.economics as tecon
import parsec_tpu_torch.comm.topology as ttopo
import parsec_tpu_torch.utils as tutils
from parsec_tpu.data.collections import TwoDimBlockCyclic as JBC
from parsec_tpu.dsl.jdf import compile_jdf as jcompile
from parsec_tpu_torch.data.collections import TwoDimBlockCyclic as TBC
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.dsl.jdf import compile_jdf as tcompile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ops(pkg, name):
    # the ops packages export functions named like their modules
    return importlib.import_module(f"{pkg}.ops.{name}")


jflash, jpaged, jrms = (_ops("parsec_tpu", n) for n in
                        ("flash_attention", "paged_attention", "rms_norm"))
tflash, tpaged, trms = (_ops("parsec_tpu_torch", n) for n in
                        ("flash_attention", "paged_attention", "rms_norm"))

REF = SimpleNamespace(
    name="ref", pt=jpt, an=jan, fg=jfg, tune=jtune, control=jcontrol,
    econ=jecon, topo=jtopo, algos=jalgos, BC=JBC, jdf=jcompile,
    rms=jrms, flash=jflash, paged=jpaged, mca=jutils.params)
PORT = SimpleNamespace(
    name="port", pt=tpt, an=tan, fg=tfg, tune=ttune, control=tcontrol,
    econ=tecon, topo=ttopo, algos=talgos, BC=TBC, jdf=tcompile,
    rms=trms, flash=tflash, paged=tpaged, mca=tutils.params)


def both(scenario, *args):
    return scenario(REF, *args), scenario(PORT, *args)


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


VR = _load("tests/analysis/test_verify_rules.py", "_ref_verify_rules")


def _findings(report):
    return sorted((f.rule, f.severity, f.cls, f.flow, f.dep, f.loc,
                   f.message, f.count) for f in report.findings)


def _plan_doc(plan):
    """A plan's JSON rendering without its wall-clock field."""
    doc = plan.to_json()
    doc["stats"].pop("elapsed_ms", None)
    return json.loads(json.dumps(doc, sort_keys=True, default=str))


def _ctx(P, nb_workers=1):
    ctx = P.pt.Context(nb_workers=nb_workers)
    buf = np.zeros(256, dtype=np.int64)
    ctx.register_linear_collection("mydata", buf, elem_size=8)
    ctx.register_arena("default", 64)
    ctx._keep = buf
    return ctx


# ------------------------------------------------------------ verifier
JDF_FIXTURES = {
    "V001": (VR.BAD_V001, VR.CLEAN_V001),
    "V002": (VR.BAD_V002, VR.CLEAN_V002),
    "V003": (VR.BAD_V003, VR.CLEAN_V003),
    "V004": (VR.BAD_V004, VR.CLEAN_V004),
    "V005": (VR.BAD_V005, VR.CLEAN_V005),
    "V006": (VR.BAD_V006, VR.CLEAN_V006),
    "V007": (VR.BAD_V007, VR.CLEAN_V007),
    "V010": (VR.BAD_V010, VR.CLEAN_V010),
}


def _verify_src(P, src, name, datatypes=(), globs=None,
                max_instances=200_000):
    with _ctx(P) as ctx:
        for dt, elem, cnt in datatypes:
            ctx.register_datatype(dt, elem, cnt)
        b = P.jdf(src, ctx, globals=globs or {"N": 4}, dtype=np.int64,
                  arenas={"A": "default"}, filename=name)
        report, cg = P.an.verify_graph(P.an.extract_flowgraph(b.tp),
                                       max_instances=max_instances)
        return _findings(report), report.ok(), bool(cg.bounded), \
            list(report.notes)


@pytest.mark.parametrize("rule", sorted(JDF_FIXTURES))
@pytest.mark.parametrize("twin", ["bad", "clean"])
def test_verify_jdf_fixture_matches_reference(rule, twin):
    """Each seeded-bad JDF fixture of test_verify_rules.py and its clean
    twin: the same findings (rule, severity, class, flow, location,
    count, message) on both packages, and the reference's verdict."""
    src = JDF_FIXTURES[rule][0 if twin == "bad" else 1]
    dts = [("wide", 8, 8), ("narrow", 8, 4)] if rule == "V007" else ()
    ref, port = both(_verify_src, src, f"{rule.lower()}{twin}.jdf", dts)
    assert port[:3] == ref[:3]
    findings, ok = port[0], port[1]
    if twin == "clean":
        assert ok, findings
    else:
        assert rule in {f[0] for f in findings}, findings


def test_verify_v004_symbolic_when_enumeration_bounded():
    ref, port = both(_verify_src, VR.BAD_V004, "v004big.jdf", (),
                     {"N": 499}, 100)
    assert port == ref
    findings, _, bounded, notes = port
    assert bounded and "V004" in {f[0] for f in findings}
    assert any("skipped" in n for n in notes)


def test_verify_v007_same_layout_rename_is_a_warning():
    ref, port = both(_verify_src, VR.BAD_V007, "v007r.jdf",
                     [("wide", 8, 8), ("narrow", 8, 8)])
    assert port == ref
    (f,) = [f for f in port[0] if f[0] == "V007"]
    assert f[1] == "warning" and "rename" in f[6]


def _arena_mismatch(P):
    with _ctx(P) as ctx:
        pt = P.pt
        ctx.register_arena("small", 32)
        tp = pt.Taskpool(ctx, globals={"N": 3})
        k = pt.L("k")
        a = tp.task_class("Aa")
        a.param("k", 0, pt.G("N"))
        a.flow("X", "W", pt.Out(pt.Ref("Bb", k, flow="X")),
               arena="default")
        a.body_noop()
        b = tp.task_class("Bb")
        b.param("k", 0, pt.G("N"))
        b.flow("X", "READ", pt.In(pt.Ref("Aa", k, flow="X")),
               arena="small")
        b.body_noop()
        return _findings(P.an.verify_taskpool(tp))


def _coll_step(P, guarded):
    with _ctx(P) as ctx:
        pt = P.pt
        tp = pt.Taskpool(ctx, globals={"N": 3})
        i = pt.L("i")
        feed = tp.task_class("Feed")
        feed.param("i", 0, pt.G("N"))
        feed.flow("X", "W",
                  pt.Out(pt.Ref("ptc_coll_9_step", i, flow="A")),
                  arena="default")
        feed.body_noop()
        step = tp.task_class("ptc_coll_9_step")
        step.param("i", 0, pt.G("N"))
        step.flow("A", "READ",
                  pt.In(pt.Ref("Feed", i, flow="X"),
                        guard=(i >= 0) if guarded else None))
        step.body_noop()
        return _findings(P.an.verify_taskpool(tp))


def _rank_mapped(P, through_reader):
    """Two 2-rank collections: T(k) reads B(k+1, 0), owned by the other
    rank; the clean twin routes it through a reader task at the datum."""
    with _ctx(P) as ctx:
        pt = P.pt
        nt, nb = 4, 8
        mk = lambda: P.BC((nt + 1) * nb, nb, nb, nb, P=2, Q=1, nodes=2,
                          myrank=0, dtype=np.float32)
        A, B = mk(), mk()
        A.register(ctx, "VA")
        B.register(ctx, "VB")
        tp = pt.Taskpool(ctx, globals={"N": nt - 1})
        k = pt.L("k")
        t = tp.task_class("T")
        t.param("k", 0, pt.G("N"))
        t.affinity("VA", k, 0)
        if through_reader:
            r = tp.task_class("Rd")
            r.param("k", 0, pt.G("N"))
            r.affinity("VB", k + 1, 0)
            r.flow("X", "READ", pt.In(pt.Mem("VB", k + 1, 0)),
                   pt.Out(pt.Ref("T", k, flow="X")))
            r.body_noop()
            t.flow("X", "READ", pt.In(pt.Ref("Rd", k, flow="X")))
        else:
            t.flow("X", "READ", pt.In(pt.Mem("VB", k + 1, 0)))
        t.body_noop()
        return _findings(P.an.verify_taskpool(tp))


def _single_rank_mem(P):
    with _ctx(P) as ctx:
        pt = P.pt
        A = P.BC(4 * 8, 8, 8, 8, dtype=np.float32)
        A.register(ctx, "V1A")
        tp = pt.Taskpool(ctx, globals={"N": 3})
        k = pt.L("k")
        t = tp.task_class("T")
        t.param("k", 0, pt.G("N"))
        t.affinity("V1A", k, 0)
        t.flow("X", "READ", pt.In(pt.Mem("V1A", (k + 1) % 4, 0)))
        t.body_noop()
        return _findings(P.an.verify_taskpool(tp))


@pytest.mark.parametrize("case,rule", [
    ("arena", "V007"), ("coll_guarded", "V008"), ("coll_clean", None),
    ("remote_mem", "V009"), ("reader_task", None),
    ("single_rank", None)])
def test_verify_builder_graphs_match_reference(case, rule):
    """The builder-API fixtures of test_verify_rules.py (arena payload
    mismatch, a guarded collective input, remote and single-rank Mem
    reads): equal findings on both packages, with the rule expected."""
    fn = {"arena": _arena_mismatch,
          "coll_guarded": lambda P: _coll_step(P, True),
          "coll_clean": lambda P: _coll_step(P, False),
          "remote_mem": lambda P: _rank_mapped(P, False),
          "reader_task": lambda P: _rank_mapped(P, True),
          "single_rank": _single_rank_mem}[case]
    ref, port = both(fn)
    assert port == ref
    if rule is None:
        assert port == []
    else:
        assert rule in {f[0] for f in port}
        assert all(f[5] and f[5].startswith("test_torch_analysis.py:")
                   for f in port if f[0] == rule)


def _verify_run(P, src, mode):
    with _ctx(P, 2) as ctx:
        b = P.jdf(src, ctx, globals={"N": 4}, dtype=np.int64,
                  arenas={"A": "default"}, filename="vrun.jdf")
        if mode == "warn":
            rep = b.tp.verify(mode="warn")
            return [f.rule for f in rep.findings]
        try:
            tp = b.tp.run(verify=mode)
        except (jan.VerifyError, tan.VerifyError) as e:
            return ("raised", type(e).__name__,
                    sorted(f.rule for f in e.report.errors))
        tp.wait()
        return ("ran", tp.nb_total_tasks)


@pytest.mark.parametrize("src,mode", [
    ("BAD_V001", "error"), ("CLEAN_V001", True), ("BAD_V006", "warn")])
def test_taskpool_run_verify_matches_reference(src, mode, capfd):
    """Taskpool.run(verify=...) and Taskpool.verify(mode="warn"): a
    finding raises VerifyError before anything is scheduled, a clean
    graph runs all its tasks, warn mode prints and proceeds."""
    ref, port = both(_verify_run, getattr(VR, src), mode)
    assert port == ref
    if src == "BAD_V001":
        assert port == ("raised", "VerifyError", ["V001"])
    elif mode is True:
        assert port == ("ran", 10)
    else:
        assert "V006" in port
        assert capfd.readouterr().err.count("V006") >= 2


def _certify(P, src, name):
    with _ctx(P) as ctx:
        b = P.jdf(src, ctx, globals={"N": 4}, dtype=np.int64,
                  arenas={"A": "default"}, filename=name)
        fg = P.an.extract_flowgraph(b.tp)
        return json.loads(json.dumps(
            P.an.certify_waves(fg, fg.concretize()), sort_keys=True,
            default=str))


@pytest.mark.parametrize("twin", ["BAD_V010", "CLEAN_V010"])
def test_certify_waves_matches_reference(twin):
    ref, port = both(_certify, getattr(VR, twin), "v010.jdf")
    assert port == ref
    (c,) = port
    assert c["homogeneous"] and c["width"] == 5
    assert c["structural"] == (twin == "BAD_V010")


# ----------------------------------------------------------- flowgraph
def test_expression_evaluator_matches_reference():
    """VM-exact evaluation (C division and modulo, select, min/max,
    shifts, globals and calls) and the interval layer, on both
    packages' ExprCompiler and interval_of."""
    def run(P):
        pt, fg = P.pt, P.fg
        a, b, k, m = pt.L("a"), pt.L("b"), pt.L("k"), pt.L("m")
        cc = fg.ExprCompiler({"NB": 5}, None)
        ab = {"a": 0, "b": 1}
        out = [cc.compile(e, ab)(v) for e in (a // b, a % b)
               for v in ([-7, 2], [7, -2], [5, 0])]
        kn = {"k": 0}
        for e, v in ((pt.select(k > 2, k * 10, k - 1), 3),
                     (pt.select(k > 2, k * 10, k - 1), 1),
                     (pt.minimum(k, 5), 9), (pt.maximum(k, 5), 9),
                     (pt.shl(1, k), 4), (pt.shr(k, 1), 9),
                     (pt.shl(1, k), -3),
                     (pt.call(lambda l, g: l[0] + g["NB"]) + pt.G("NB"),
                      7)):
            out.append(cc.compile(e, kn)([v]))
        names = {"k": 0, "m": 1}
        iv = {0: (0, 9), 1: (2, 4)}
        for e in (k * 2 + m, k - m, pt.minimum(k, m),
                  pt.select(k > m, k, m), pt.call(lambda l, g: 0)):
            out.append(fg.interval_of(e, iv, names, {}))
        pure = pt.call(lambda l, g: 1, pure=True)
        imp = pt.call(lambda l, g: 1)
        out.append((fg.expr_is_dynamic(pure), fg.expr_is_impure(pure),
                    fg.expr_is_impure(imp), fg.expr_is_dynamic(k + 1)))
        return out

    ref, port = both(run)
    assert port == ref
    assert port[:6] == [-3, -3, 0, -1, 1, 0]
    assert port[6:14] == [30, 0, 5, 9, 16, 4, 1, 17]
    assert port[14:19] == [(2, 22), (-4, 7), (0, 4), (0, 9), None]
    assert port[19] == (True, False, True, False)


def _chain_pool(P, ctx, n=4):
    pt = P.pt
    tp = pt.Taskpool(ctx, globals={"NB": n - 1})
    k = pt.L("k")
    tc = tp.task_class("Chain")
    tc.param("k", 0, pt.G("NB"))
    tc.local("twice", k * 2)
    tc.flow("A", "RW",
            pt.In(None, guard=(k == 0)),
            pt.In(pt.Ref("Chain", k - 1, flow="A")),
            pt.Out(pt.Ref("Chain", k + 1, flow="A"),
                   guard=(k < pt.G("NB"))),
            arena="default")
    tc.body_noop()
    return tp


def test_space_and_concrete_graph_match_reference():
    """Execution-space enumeration, derived locals, domains (a chain and
    a triangular space), the concretized edges, the refused (not
    truncated) oversized enumeration, and the DOT rendering."""
    def run(P):
        pt = P.pt
        out = {}
        with _ctx(P) as ctx:
            fg = P.an.extract_flowgraph(_chain_pool(P, ctx))
            cm = fg.by_name["Chain"]
            out["inst"] = cm.instances([100])
            out["locals"] = cm.fill_locals((3,))
            out["dom"] = [cm.in_domain((i,)) for i in (-1, 0, 3, 4)]
            cg = fg.concretize()
            out["cg"] = (cg.nb_instances(), cg.nb_edges,
                         sorted(cg.expected.items()),
                         sorted(cg.ncert.items()))
            report, cg = P.an.verify_graph(fg)
            out["dot"] = P.an.flowgraph_to_dot(cg)
            tp = pt.Taskpool(ctx, globals={"NT": 3})
            k = pt.L("k")
            tri = tp.task_class("Tri")
            tri.param("k", 0, pt.G("NT"))
            tri.param("m", k + 1, pt.G("NT"))
            tri.body_noop()
            cm = P.an.extract_flowgraph(tp).by_name["Tri"]
            out["tri"] = (cm.instances([100]), cm.space_intervals(),
                          cm.in_domain((0, 3)), cm.in_domain((2, 2)))
            tp = pt.Taskpool(ctx, globals={"NB": 10_000_000})
            tc = tp.task_class("Huge")
            tc.param("k", 0, pt.G("NB"))
            tc.body_noop()
            cg = P.an.extract_flowgraph(tp).concretize(max_instances=1000)
            out["huge"] = (cg.bounded, cg.nb_instances(), list(cg.notes))
        return out

    ref, port = both(run)
    assert port == ref
    assert port["inst"] == [(0,), (1,), (2,), (3,)]
    assert port["locals"] == [3, 6]
    assert port["cg"][:2] == (4, 3)
    assert len(port["tri"][0]) == 6
    assert port["huge"][:2] == (True, 0)
    assert "color=red" not in port["dot"] and port["dot"].count("->") == 3


def _dot_overlay(P):
    with _ctx(P) as ctx:
        pt = P.pt
        tp = pt.Taskpool(ctx, globals={"N": 2})
        k = pt.L("k")
        p = tp.task_class("P")
        p.param("k", 0, pt.G("N"))
        p.flow("X", "W", pt.Out(pt.Ref("C", k, flow="X")),
               arena="default")
        p.body_noop()
        c = tp.task_class("C")
        c.param("k", 0, pt.G("N"))
        c.flow("X", "READ", pt.In(None))
        c.body_noop()
        report, cg = P.an.verify_graph(P.an.extract_flowgraph(tp))
        return _findings(report), P.an.flowgraph_to_dot(cg, report.findings)


def test_dot_overlay_marks_findings_as_reference():
    ref, port = both(_dot_overlay)
    assert port == ref
    assert "V006" in {f[0] for f in port[0]}
    assert "color=red" in port[1]


def test_linear_collection_shim_matches_reference():
    """A native linear collection registers a LinearCollectionShim in
    collection_objs (rank_of + geometry for the analyses)."""
    def run(P):
        with P.pt.Context(nb_workers=1) as ctx:
            arr = np.zeros(12, dtype=np.int64)
            ctx.register_linear_collection("L", arr, elem_size=8,
                                           nodes=3, myrank=0)
            sh = ctx.collection_objs["L"]
            return (type(sh).__name__, sh.nodes, sh.elem_size,
                    [sh.rank_of(k) for k in range(6)],
                    P.an.collection_tile_bytes(sh))
    ref, port = both(run)
    assert port == ref
    assert port[3] == [0, 1, 2, 0, 1, 2]


# ---------------------------------------------------------------- plan
def _gemm_pool(P, ctx, m=128, n=128, k=32, mb=16, nodes=1):
    kw = dict(dtype=np.float32)
    if nodes > 1:
        kw.update(nodes=nodes, P=nodes, Q=1, myrank=0)
    A = P.BC(m, k, mb, mb, **kw)
    B = P.BC(k, n, mb, mb, **kw)
    C = P.BC(m, n, mb, mb, **kw)
    for name, M in (("A", A), ("B", B), ("C", C)):
        M.register(ctx, name)
    return P.algos.gemm.build_gemm(ctx, A, B, C)


def _potrf_pool(P, ctx, nt=6, nb=8):
    A = P.BC(nt * nb, nt * nb, nb, nb, dtype=np.float32)
    A.register(ctx, "A")
    return A, P.algos.potrf.build_potrf(ctx, A)


def test_gemm_plan_matches_reference():
    """Single-rank GEMM: the same plan on both packages, and the
    reference's residency contract (working set = the tile set, the
    liveness floor below it, kt waves, no comm)."""
    def run(P):
        with P.pt.Context(nb_workers=1) as ctx:
            plan = _gemm_pool(P, ctx).plan()
            sym = _gemm_pool(P, ctx).plan(max_instances=10)
            return (_plan_doc(plan), plan.peak_bytes(),
                    plan.live_peak_bytes(), plan.text(waves=True)
                    .split("[")[0],
                    [plan.predict_spills(b, 0, device_only=False)
                     for b in (plan.peak_bytes() // 2, plan.peak_bytes(),
                               4 << 30)],
                    _plan_doc(sym), sym.est_bytes())

    ref, port = both(run)
    assert port == ref
    doc, peak, live, _, spills, sym, sym_est = port
    tile_set = (128 * 32 + 32 * 128 + 128 * 128) * 4
    assert peak == doc["est_bytes"] == tile_set
    assert 0 < live < tile_set
    assert doc["stats"]["waves"] == 2 and doc["comm"]["total_bytes"] == 0
    assert spills[0] > 0 and spills[1:] == [0, 0]
    assert sym["bounded"] and sym_est >= tile_set


def test_gemm_chain_certificates_match_reference():
    def run(P):
        with P.pt.Context(nb_workers=1) as ctx:
            tp = _gemm_pool(P, ctx, k=64)
            plan = P.an.plan_taskpool(tp)
            idx = plan.chain_index(0)
            p2 = P.an.chain_certificates(tp)
            return (_plan_doc(plan), repr(sorted(idx["links"].items())),
                    idx["classes"]["Gemm"]["param_slots"],
                    p2.chains == plan.chains)
    ref, port = both(run)
    assert port == ref
    doc = port[0]
    assert doc["fusable_waves"] == 4 and doc["chained_waves"] == 3
    assert port[2] == [0, 1, 2] and port[3]


def test_potrf_waves_match_reference():
    def run(P):
        with P.pt.Context(nb_workers=1) as ctx:
            _, tp = _potrf_pool(P, ctx)
            return _plan_doc(P.an.plan_taskpool(tp))
    ref, port = both(run)
    assert port == ref
    rows = port["waves"]["0"]
    assert rows[0]["classes"] == {"POTRF": 1}
    assert set(rows[2]["classes"]) == {"GEMM", "SYRK"}


def test_comm_volume_rank_mapping_matches_reference():
    """A 4-rank-shaped graph planned on one process (nothing executes):
    two chains hopping between ranks c and c + 2.  The same per-edge
    byte map, eager/rendezvous split and wire bounds on both packages,
    with every hop a crossing."""
    def run(P):
        plan = _pair_chain_plan(P)
        return _plan_doc(plan), plan.edges_bytes, \
            [plan.wire_out_bound(r) for r in range(4)]
    ref, port = both(run)
    assert port == ref
    hop = 8192 * 4
    assert port[1] == {(0, 2): 4 * hop, (2, 0): 4 * hop,
                       (1, 3): 4 * hop, (3, 1): 4 * hop}
    assert all(b > 4 * hop for b in port[2])


def _diamond(P, ctx):
    pt = P.pt
    ctx.register_arena("t", 64)
    tp = pt.Taskpool(ctx)
    src = tp.task_class("Src")
    src.param("k", 0, 0)
    src.flow("X", "W", pt.Out(pt.Ref("Mid", 0, flow="X")),
             pt.Out(pt.Ref("Mid", 1, flow="X")), arena="t")
    mid = tp.task_class("Mid")
    mid.param("j", 0, 1)
    mid.flow("X", "READ", pt.In(pt.Ref("Src", 0, flow="X")), arena="t")
    mid.flow("Y", "W", pt.Out(pt.Ref("Sink", 0, flow="Y")), arena="t")
    sink = tp.task_class("Sink")
    sink.param("k", 0, 0)
    sink.flow("Y", "CTL", pt.In(pt.Ref("Mid", pt.Range(0, 1), flow="Y")))
    return tp


def test_makespan_seeded_cost_model_matches_reference(tmp_path):
    def run(P):
        with P.pt.Context(nb_workers=1) as ctx:
            cost = P.an.CostModel({"Src": 100, "Mid": 1000, "Sink": 10},
                                  source="test")
            plan = P.an.plan_taskpool(_diamond(P, ctx), cost=cost)
        p = tmp_path / f"{P.name}.json"
        p.write_text('{"classes": {"Gemm": 5000.0}, "default_ns": 250}')
        cm = P.an.CostModel.from_json(str(p))
        rec = cm.recalibrated({"Gemm": 2.0}, fallback=3.0)
        return (plan.makespan, plan.stats["waves"], cm.ns("Gemm"),
                cm.ns("Other"), rec.to_json()["classes"], rec.default_ns)
    ref, port = both(run)
    assert port == ref
    m = port[0]
    assert m["critical_path_ns"] == 1110 and m["work_ns"] == 2110
    assert port[2:4] == (5000.0, 250) and port[4] == {"Gemm": 10000.0}


def test_predicted_vs_executed_critpath_on_the_port():
    """Plan a potrf, run it under level-2 tracing, seed the cost model
    from the always-on histograms and compare the predicted critical
    path against the executed one (compare_critpath reads the port's
    profiling.critpath).  The predicted path's structure equals the
    reference's; its nanoseconds are this run's."""
    nt = 6

    def run(P):
        with P.pt.Context(nb_workers=2) as ctx:
            ctx.profile_enable(True)
            A, tp = _potrf_pool(P, ctx, nt)
            rng = np.random.default_rng(0)
            M = rng.standard_normal((nt * 8, nt * 8)).astype(np.float32)
            A.from_dense(M @ M.T + nt * 8 * np.eye(nt * 8,
                                                   dtype=np.float32))
            tp.run()
            tp.wait()
            cost = P.an.CostModel.from_context(ctx)
            plan = P.an.plan_taskpool(tp, cost=cost)
            tr = (jpt.profiling if P is REF else tpt.profiling) \
                .take_trace(ctx)
            cmp = P.an.compare_critpath(plan, tr)
        return cost.source, sorted(cost.costs), cmp

    ref, port = both(run)
    assert port[:2] == ref[:2] == ("metrics", ["GEMM", "POTRF", "SYRK",
                                               "TRSM"])
    cmp = port[2]
    assert cmp["predicted_path_len"] == ref[2]["predicted_path_len"] \
        == 3 * (nt - 1) + 1
    assert cmp["executed_path_len"] > 0 and cmp["ratio"] is not None
    assert cmp["cost_source"] == "metrics"


def test_cost_model_from_context_cold_is_none():
    def run(P):
        with P.pt.Context(nb_workers=1) as ctx:
            return P.an.CostModel.from_context(ctx)
    assert both(run) == (None, None)


# ---------------------------------------------------------------- remap
def _pair_chain_plan(P, hops=8, elems=8192):
    with P.pt.Context(nb_workers=1) as ctx:
        pt = P.pt
        arr = np.zeros((4, elems), dtype=np.float32)
        ctx.register_linear_collection("A", arr, elem_size=elems * 4,
                                       nodes=4, myrank=0)
        ctx.register_arena("t", elems * 4)
        tp = pt.Taskpool(ctx, globals={"NB": hops})
        c, k = pt.L("c"), pt.L("k")
        tc = tp.task_class("Hop")
        tc.param("c", 0, 1)
        tc.param("k", 0, pt.G("NB"))
        tc.affinity("A", c + 2 * (k % 2))
        tc.flow("A", "RW",
                pt.In(pt.Mem("A", c), guard=(k == 0)),
                pt.In(pt.Ref("Hop", c, k - 1, flow="A")),
                pt.Out(pt.Ref("Hop", c, k + 1, flow="A"),
                       guard=(k < pt.G("NB"))),
                arena="t")
        tc.body_noop()
        return tp.plan()


@pytest.mark.parametrize("spec", ["0,1;2,3", "0,2;1,3", "0,3;1,2",
                                  "0;1;2;3", "flat", "0;1"])
def test_remap_ranks_match_reference(spec):
    """The rank-permutation search over the pair-chain traffic matrix
    under each topology: the same permutation, DCN bytes, class split
    and modeled cost on both packages."""
    def run(P):
        plan = _pair_chain_plan(P)
        tm = P.topo.TopologyModel.flat(4) if spec == "flat" \
            else P.topo.TopologyModel.parse(spec)
        econ = P.econ.default_economics()
        perm = plan.remap_ranks(tmodel=tm, econ=econ)
        return (perm, plan.dcn_bytes(tmodel=tm),
                plan.dcn_bytes(tmodel=tm, perm=perm),
                plan.class_bytes(tmodel=tm, perm=perm),
                plan._perm_cost(perm, tm, econ),
                plan._perm_cost(list(range(4)), tm, econ))
    ref, port = both(run)
    assert port == ref
    perm, ident, remapped, _, cost, ident_cost = port
    assert sorted(perm) == [0, 1, 2, 3] and cost <= ident_cost + 1e-12
    if spec == "0,1;2,3":
        assert perm != [0, 1, 2, 3] and ident > 0 and remapped == 0
    if spec in ("flat", "0;1"):
        assert perm == [0, 1, 2, 3]


def test_run_remap_on_one_rank():
    """run(remap=True) on one rank: the search keeps the identity, so no
    map is installed and the pool runs as planned."""
    def run(P):
        with P.pt.Context(nb_workers=2) as ctx:
            A, tp = _potrf_pool(P, ctx)
            rng = np.random.default_rng(1)
            M = rng.standard_normal((48, 48)).astype(np.float32)
            A.from_dense(M @ M.T + 48 * np.eye(48, dtype=np.float32))
            tp.run(remap=True)
            tp.wait()
            return tp.remap_applied, A.to_dense()
    ref, port = both(run)
    assert port[0] is None and ref[0] is None
    np.testing.assert_array_equal(port[1], ref[1])


# ------------------------------------------------------------ economics
def test_economics_and_topology_match_reference():
    """The transfer-economics model (the repo's BENCH_comm.json fits, the
    eager threshold, per-class legs, topology costs and choice) and the
    topology model (parsing, classes, islands)."""
    def run(P):
        e = P.econ.default_economics()
        out = [e.source.endswith("BENCH_comm.json"),
               e.eager_threshold(64 << 10)]
        for path in ("eager", "rdv", "device"):
            for cls in (None, "ici", "dcn"):
                out.append((e.alpha(path, cls), e.beta(path, cls),
                            e.cost(1 << 20, path, cls)))
        for kind in ("reduce", "bcast", "all_gather"):
            for nb, nr in ((1 << 10, 4), (1 << 22, 8)):
                out.append(e.topology_costs(kind, nb, nr))
                out.append(e.choose_topology(kind, nb, nr))
        tm = P.topo.TopologyModel.parse("0,1|2,3;4,5|6,7")
        out.append((tm.n_islands, [[tm.class_of(a, b) for b in range(8)]
                                   for a in range(8)]))
        out.append(P.econ.fit_points([(1 << 16, 1e-4), (1 << 20, 1e-3),
                                      (1 << 22, 4e-3)]))
        return out
    ref, port = both(run)
    assert port == ref
    assert port[0] is True


def test_economics_loads_a_card_fit(tmp_path):
    """A fit written in the BENCH_comm.json schema (as chip_smoke.py's
    phase 10 writes the card's h2d fit) is what coll.econ_path loads
    (default_economics() caches the first load for the process, so a
    caller pricing on the card passes econ= explicitly)."""
    fit = tecon.fit_points([(1 << 20, 1e-4), (1 << 24, 1.2e-3),
                            (1 << 26, 4.7e-3)])
    p = tmp_path / "econ.json"
    p.write_text(json.dumps({"meta": {"platform": "test"},
                             "paths": {"device": {"fit": fit}}}))
    e = tecon.TransferEconomics.load(str(p))
    assert e.source == str(p)
    assert e.beta("device") == pytest.approx(fit["per_byte_ns"] * 1e-9)
    tutils.params.set("coll.econ_path", str(p))
    try:
        assert tecon.TransferEconomics.load().source == str(p)
    finally:
        tutils.params.unset("coll.econ_path")


# ------------------------------------------------------------------ tune
def test_simulator_predictions_match_reference():
    """The schedule simulator prices the same knob vectors to the same
    nanoseconds on both packages (potrf at 1, 2 and 8 workers, across
    the magazine-batch axis and a cache budget)."""
    vectors = [{}, {"runtime.mag_batch": 8}, {"runtime.mag_batch": 512},
               {"device.staging_slots": 1}, {"device.cache_bytes": 4096},
               {"comm.rails": 4, "coll.topo": "ring"}]

    def run(P):
        with P.pt.Context(nb_workers=1) as ctx:
            _, tp = _potrf_pool(P, ctx)
            plan = tp.plan()
        base = P.tune.default_knobs()
        base["device.wave_fuse"] = False
        out = []
        for w in (1, 2, 8):
            sim = P.tune.ScheduleSimulator(plan, workers=w)
            out.append([sim.simulate(dict(base, **v)) for v in vectors])
        return out
    ref, port = both(run)
    assert port == ref
    one, two, eight = port
    assert one[0]["tasks"] == 56
    assert one[2]["makespan_ns"] < one[1]["makespan_ns"]
    assert eight[0]["makespan_ns"] < one[0]["makespan_ns"]


def _fan_plan(P):
    with P.pt.Context(nb_workers=1) as ctx:
        pt = P.pt
        ctx.register_arena("t", 64)
        tp = pt.Taskpool(ctx, globals={"NB": 7, "KT": 3})
        k, b = pt.L("k"), pt.L("b")
        tc = tp.task_class("Fan")
        tc.param("b", 0, pt.G("NB"))
        tc.param("k", 0, pt.G("KT"))
        tc.flow("A", "RW",
                pt.In(None, guard=(k == 0)),
                pt.In(pt.Ref("Fan", b, k - 1, flow="A")),
                pt.Out(pt.Ref("Fan", b, k + 1, flow="A"),
                       guard=(k < pt.G("KT"))), arena="t")
        tc.body_device(0)
        return tp.plan()


def test_simulator_wave_fuse_pricing_matches_reference():
    """A certified fusable device wave: the same price with the wave
    knob on and off on both packages, and both search that axis (the
    port acts on it since device/fuse.py)."""
    def run(P):
        sim = P.tune.ScheduleSimulator(_fan_plan(P), workers=2)
        base = dict(P.tune.default_knobs())
        return (sorted(sim.fused_width.items()),
                sim.simulate(dict(base, **{"device.wave_fuse": True})),
                sim.simulate(dict(base, **{"device.wave_fuse": False})),
                sim.knob_axes()["device.wave_fuse"])
    ref, port = both(run)
    assert port[:3] == ref[:3]
    assert port[1]["makespan_ns"] < port[2]["makespan_ns"]
    assert ref[3] == port[3] == [True, False]


def test_knob_axes_search_only_acted_knobs():
    """propose() on the port moves only the knobs it acts on, opens the
    axes the reference opens on the same one-rank device DAG (its wire
    and collective axes stay closed there), and ranks them by the same
    simulated makespan the reference computes for the same vectors."""
    with tpt.Context(nb_workers=1) as ctx:
        plan = _fan_plan(PORT)
    sim = ttune.ScheduleSimulator(plan, workers=2)
    axes = sim.knob_axes()
    opened = {k for k, v in axes.items() if len(v) > 1}
    assert opened <= set(ttune.ACTED_KNOBS)
    jsim = jtune.ScheduleSimulator(_fan_plan(REF), workers=2)
    jaxes = jsim.knob_axes()
    assert opened == {k for k, v in jaxes.items() if len(v) > 1} == {
        "runtime.mag_batch", "device.staging_slots",
        "device.cache_bytes", "device.wave_fuse"}
    ranked = sim.propose(topk=3)
    dflt = ttune.default_knobs()
    for r in ranked:
        moved = {k for k in ttune.TUNE_KNOBS if r["knobs"][k] != dflt[k]}
        assert moved <= set(ttune.ACTED_KNOBS)
    for r in ranked:
        assert jsim.simulate(r["knobs"])["makespan_ns"] == \
            r["predicted_ns"]


def test_proposals_match_reference_on_a_host_graph():
    """potrf (no device chore, one rank): the reference opens only the
    magazine-batch axis too, so both packages rank the same vectors."""
    def run(P):
        with P.pt.Context(nb_workers=1) as ctx:
            _, tp = _potrf_pool(P, ctx)
            plan = tp.plan()
        sim = P.tune.ScheduleSimulator(plan, workers=1)
        return [(r["knobs"]["runtime.mag_batch"], r["predicted_ns"])
                for r in sim.propose(topk=4)]
    ref, port = both(run)
    assert port == ref


def test_apply_knobs_refuses_knobs_the_port_does_not_act_on():
    before = ttune.default_knobs()["comm.rails"]
    assert before == jtune.default_knobs()["comm.rails"]
    with pytest.raises(ValueError, match="does not act"):
        with ttune.apply_knobs({"comm.rails": before + 1}):
            pass
    assert "PTC_MCA_comm_rails" not in os.environ
    # comm.rails is no parameter of the port (the engine reads its env)
    with pytest.raises(KeyError):
        tutils.params.get("comm.rails")
    assert set(ttune.FIXED_KNOBS) == {"comm.rails", "comm.rails.ici",
                                      "comm.rails.dcn"}
    # the collective knobs are acted: applied, then restored
    topo = ttune.default_knobs()["coll.topo"]
    other = "star" if topo != "star" else "ring"
    with ttune.apply_knobs({"coll.topo": other}) as applied:
        assert applied == {"coll.topo": other}
        assert os.environ["PTC_MCA_coll_topo"] == other
    assert ttune.default_knobs()["coll.topo"] == topo
    # an unchanged value of such a knob passes (a full vector)
    with ttune.apply_knobs(ttune.default_knobs()) as applied:
        assert set(applied) == set(ttune.TUNE_KNOBS)
    with pytest.raises(KeyError):
        with ttune.apply_knobs({"not.a.knob": 1}):
            pass


def test_default_knobs_read_the_registry(monkeypatch):
    """The comm and collective knobs the tuner prices are read from the
    MCA registry, as the engine reads them: a setting in the environment
    moves the port's vector and its per-class resolution as it moves the
    JAX package's; the knobs that are no parameter here answer their
    reference default."""
    for env, val in (("PTC_MCA_comm_eager_limit", "0"),
                     ("PTC_MCA_comm_eager_limit_dcn", "8192"),
                     ("PTC_MCA_comm_chunk_size", "4096"),
                     ("PTC_MCA_coll_topo", "ring")):
        monkeypatch.setenv(env, val)
    port, ref = ttune.default_knobs(), jtune.default_knobs()
    assert port == ref
    assert port["comm.eager_limit"] == 0
    assert port["comm.eager_limit.dcn"] == "8192"
    for name, cls in (("comm.eager_limit", "dcn"),
                      ("comm.eager_limit", "ici"),
                      ("comm.chunk_size", "dcn"), ("coll.topo", None),
                      ("comm.rails", "dcn")):
        assert ttopo.resolve_class_knob(name, cls) == \
            jtopo.resolve_class_knob(name, cls)
    assert ttopo.resolve_class_knob("comm.eager_limit", "dcn") == 8192
    with ttune.apply_knobs({"comm.eager_limit": 0}) as applied:
        assert applied == {"comm.eager_limit": 0}
    # an acted knob: a change applies for the block, then restores
    with ttune.apply_knobs({"comm.eager_limit": 64 * 1024}) as applied:
        assert applied == {"comm.eager_limit": 64 * 1024}
        assert ttune.default_knobs()["comm.eager_limit"] == 64 * 1024
    assert ttune.default_knobs()["comm.eager_limit"] == 0


def test_apply_knobs_acts_on_wave_fuse():
    """device.wave_fuse is an acted knob: a device created under
    apply_knobs({"device.wave_fuse": False}) has no wave compiler, and
    knobs_in_force reads that back, so a tuned run holds its vector to
    it in both directions."""
    assert ttune.default_knobs()["device.wave_fuse"] is True \
        is jtune.default_knobs()["device.wave_fuse"]
    with ttune.apply_knobs({"device.wave_fuse": False}) as applied:
        assert applied == {"device.wave_fuse": False}
        assert os.environ["PTC_MCA_device_wave_fuse"] == "False"
        ctx = tpt.Context(nb_workers=1)
        dev = CudaDevice(ctx, device="cpu")
    assert "PTC_MCA_device_wave_fuse" not in os.environ
    with ctx:
        assert dev._fuser is None
        force = ttune.knobs_in_force(ctx)
        assert force["device.wave_fuse"] == [False]
        ttune.check_tuned(ctx, {"device.wave_fuse": False})
        with pytest.raises(ValueError, match="not in force"):
            ttune.check_tuned(ctx, {"device.wave_fuse": True})
        dev2 = CudaDevice(ctx, device="cpu")
        assert dev2._fuser is not None
        assert ttune.knobs_in_force(ctx)["device.wave_fuse"] == \
            [False, True]
        dev2.stop()
        dev.stop()


def test_apply_knobs_snapshot_restore():
    before = tutils.params.get("device.staging_slots")
    with ttune.apply_knobs({"device.staging_slots": before + 3}):
        assert tutils.params.get("device.staging_slots") == before + 3
        assert os.environ["PTC_MCA_device_staging_slots"] == \
            str(before + 3)
    assert tutils.params.get("device.staging_slots") == before
    assert "PTC_MCA_device_staging_slots" not in os.environ
    assert ttune.knob_env({"runtime.mag_batch": 4}) == \
        jtune.knob_env({"runtime.mag_batch": 4}) == \
        {"PTC_MCA_runtime_mag_batch": "4"}
    assert set(ttune.default_knobs()) == set(ttune.TUNE_KNOBS) == \
        set(jtune.TUNE_KNOBS)


def test_graph_signature_and_host_fingerprint_match_reference():
    def run(P, nt):
        with P.pt.Context(nb_workers=1) as ctx:
            _, tp = _potrf_pool(P, ctx, nt)
            return P.tune.graph_signature(tp)
    assert run(PORT, 6) == run(REF, 6) == run(PORT, 6)
    assert run(PORT, 5) == run(REF, 5) != run(PORT, 6)
    assert ttune.host_fingerprint() == jtune.host_fingerprint()


def test_autotune_persist_and_run_tuned(tmp_path):
    """The loop on the port: model-only proposals persist nothing; a
    validated winner persists under (signature, host) and a new pool
    built the same way applies it through run(tuned=True), restoring
    the registry when run() returns; an empty store is a no-op."""
    store = str(tmp_path / "tuned.json")
    tutils.params.set("tune.cache_path", store)
    try:
        with tpt.Context(nb_workers=1) as ctx:
            _, tp = _potrf_pool(PORT, ctx)
            res = ttune.autotune(tp, measure=None)
        assert res["winner"]["source"] == "model-only"
        assert not res["persisted"] and not os.path.exists(store)

        def measure(knobs):
            return 1.0 - 0.5 * (int(knobs["runtime.mag_batch"]) == 128)

        with tpt.Context(nb_workers=1) as ctx:
            _, tp = _potrf_pool(PORT, ctx)
            sig = ttune.graph_signature(tp)
            res = ttune.autotune(tp, measure=measure, topk=4)
        assert res["persisted"]
        assert res["winner"]["knobs"]["runtime.mag_batch"] == 128
        rec = json.load(open(store))["entries"][sig][
            ttune.host_fingerprint()]
        assert rec["knobs"]["runtime.mag_batch"] == 128
        before = tutils.params.get("runtime.mag_batch")
        rng = np.random.default_rng(2)
        M = rng.standard_normal((48, 48)).astype(np.float32)
        spd = M @ M.T + 48 * np.eye(48, dtype=np.float32)
        # a runtime created without the winner in force: the run raises
        with tpt.Context(nb_workers=2) as ctx:
            A, tp = _potrf_pool(PORT, ctx)
            win = ttune.resolve_tuned(tp, True)
            assert win["runtime.mag_batch"] == 128 != ctx.mag_batch
            with pytest.raises(ValueError, match="not in force"):
                tp.run(tuned=True)
        # one created under it: the run holds the winner, and the
        # registry and env are restored when the block ends
        with ttune.apply_knobs(win):
            with tpt.Context(nb_workers=2) as ctx:
                A, tp = _potrf_pool(PORT, ctx)
                A.from_dense(spd)
                tp.run(tuned=True)
                tp.wait()
                assert ctx.mag_batch == 128
                assert tp.tuned_applied["runtime.mag_batch"] == 128
                L = np.tril(A.to_dense())
        assert tutils.params.get("runtime.mag_batch") == before
        assert "PTC_MCA_runtime_mag_batch" not in os.environ
        np.testing.assert_allclose(L @ L.T, spd, rtol=1e-4, atol=1e-3)
    finally:
        tutils.params.unset("tune.cache_path")
    tutils.params.set("tune.cache_path", str(tmp_path / "empty.json"))
    try:
        with tpt.Context(nb_workers=1) as ctx:
            A, tp = _potrf_pool(PORT, ctx)
            A.from_dense(spd)
            tp.run(tuned=True)
            tp.wait()
            assert tp.tuned_applied is None
    finally:
        tutils.params.unset("tune.cache_path")


def test_two_pools_different_knobs_no_leak():
    """Each runtime holds the vector it was created under: a device
    created under a vector keeps its staging slots after the block, a
    pool's run(tuned=) holds exactly that vector, and nothing leaks
    into the registry, the env or the next runtime."""
    def chain(ctx):
        ctx.register_arena("t", 8)
        tp = tpt.Taskpool(ctx, globals={"NB": 3})
        k = tpt.L("k")
        tc = tp.task_class("Task")
        tc.param("k", 0, tpt.G("NB"))
        tc.flow("A", "RW", tpt.In(None, guard=(k == 0)),
                tpt.In(tpt.Ref("Task", k - 1, flow="A")),
                tpt.Out(tpt.Ref("Task", k + 1, flow="A"),
                        guard=(k < tpt.G("NB"))), arena="t")
        tc.body_noop()
        return tp

    default = tutils.params.get("device.staging_slots")
    seen = {}
    for name, slots in (("a", 4), ("b", 1), ("c", None)):
        vec = {"device.staging_slots": slots} if slots else None
        with ttune.apply_knobs(vec):
            ctx = tpt.Context(nb_workers=1)
            dev = CudaDevice(ctx, device="cpu")
        with ctx:
            tp = chain(ctx)
            tp.run(tuned=vec)
            tp.wait()
            seen[name] = (dev._pf_slots_max, tp.tuned_applied)
            other = {"device.staging_slots": (slots or default) + 1}
            with pytest.raises(ValueError, match="not in force"):
                chain(ctx).run(tuned=other)
            dev.stop()
        assert tutils.params.get("device.staging_slots") == default
        assert "PTC_MCA_device_staging_slots" not in os.environ
    assert seen == {"a": (4, {"device.staging_slots": 4}),
                    "b": (1, {"device.staging_slots": 1}),
                    "c": (default, None)}


# --------------------------------------------------------------- control
class _Store:
    def __init__(self):
        self.puts = []

    def put(self, sig, host, rec):
        self.puts.append((sig, host, dict(rec)))


def _ctrl(P, ctx, **kw):
    kw.setdefault("clock", P.control.SimClock())
    kw.setdefault("window", 4)
    kw.setdefault("cooldown", 4)
    kw.setdefault("drift_ratio", 1.25)
    kw.setdefault("store", _Store())
    return P.control.Controller(ctx, **kw)


SEQ = [2.0, 1.1, 2.4, 1.9, 2.2, 1.0, 3.0, 2.6, 2.1, 1.3, 2.8, 2.2, 1.7,
       2.5, 2.0, 1.9]


def _control_run(P, scenario):
    with P.pt.Context(nb_workers=1) as ctx:
        _, tp = _potrf_pool(P, ctx)
        ctrl = _ctrl(P, ctx, cooldown=16 if scenario == "cooldown" else 4)
        if scenario != "no_target":
            ctrl.attach_target(tp, workers=2)
        knobs = []
        if scenario == "replay":
            for i, r in enumerate(SEQ):
                if i == 6:
                    ctrl.interrupt("slow_rank", key="rank1")
                ctrl.observe_pool(r)
        elif scenario == "interrupt":
            ctrl.observe_pool(2.0)
            ctrl.observe_pool(2.0)
            ctrl.interrupt("stuck_task", key="Pool#1:GEMM(3,2)")
        elif scenario == "swap":
            for _ in range(4):
                ctrl.observe_pool(2.0)
            knobs.append(P.mca.get("runtime.mag_batch"))
            ctrl.observe_pool(1.0)
            knobs.append(P.mca.get("runtime.mag_batch"))
        else:
            for _ in range(12 if scenario == "cooldown" else 4):
                ctrl.observe_pool(9.0 if scenario == "no_target" else 2.0)
        stats = ctrl.stats()
        log = ctrl.decision_log()
        events = ctx.scope_registry().events()
        puts = [(rec["source"], rec["knobs"]["runtime.mag_batch"])
                for _, _, rec in ctrl._store.puts]
        ctrl.stop()
        knobs.append(P.mca.get("runtime.mag_batch"))
        assert ctx.stats()["control"] == {"enabled": False}
    return stats, log, events, puts, knobs


@pytest.mark.parametrize("scenario", ["drift", "swap", "cooldown",
                                      "interrupt", "no_target",
                                      "replay"])
def test_controller_decisions_match_reference(scenario):
    """The controller under a simulated clock: drift retunes and
    persists, the swap lands only at the next pool boundary and stop()
    restores it, the cooldown holds, a watchdog interrupt evaluates at
    once, drift with no target is only logged, and a replay yields one
    decision log — the same log, stats and scope events on both
    packages."""
    ref, port = both(_control_run, scenario)
    # the port's control_apply records carry two fields more: what the
    # live runtime holds after the swap, and the changed knobs it does
    # not hold (they bind when a Context or CudaDevice is created)
    applies = [e for e in port[1] + port[2]
               if e.get("kind", "control_apply") == "control_apply"
               and "not_held" in e]
    extra = [(e.pop("in_force"), e.pop("not_held")) for e in applies]
    assert port == ref
    stats, log, _, puts, knobs = port
    if scenario == "swap":
        assert len(extra) == 2  # the log entry and its scope event
        force, not_held = extra[0]
        assert not_held == ["runtime.mag_batch"]
        assert force["runtime.mag_batch"] == [64] != [knobs[1]]
    assert log
    if scenario == "drift":
        assert stats["retunes"] == 1 and stats["pending"]
        assert puts == [("control", puts[0][1])]
    if scenario == "swap":
        assert stats["swaps"] == 1 and knobs[0] == knobs[2] != knobs[1]
    if scenario == "cooldown":
        assert stats["retunes"] == 1
    if scenario == "interrupt":
        assert log[0]["kind"] == "control_interrupt"
        assert stats["interrupts"] == 1 and stats["retunes"] == 1
    if scenario == "no_target":
        assert stats["retunes"] == 0 and log[0]["target"] is False


def _epochs(P):
    with P.pt.Context(nb_workers=1) as ctx:
        reg = ctx.scope_registry()
        reg.conformance_window = 8
        plan = {"makespan_lb_ns": 1000, "wire_out_bound_sum": 64,
                "est_bytes": 256, "per_class_cost": {"GEMM": 1000.0}}
        for _ in range(50):
            sid = reg.new_scope("t0", kind="decode_step")
            reg.record_pool_done(sid, plan=dict(plan),
                                 measured={"wall_ns": 2000})
        conf = reg.conformance()
        ctrl = _ctrl(P, ctx, window=3)
        for _ in range(3):
            sid = reg.new_scope("t0", kind="decode_step")
            reg.record_pool_done(sid, plan={"makespan_lb_ns": 1000},
                                 measured={"wall_ns": 5000})
        log = ctrl.decision_log()
        ctrl.stop()
        return conf, log


def test_conformance_epochs_and_controller_feed_match_reference():
    ref, port = both(_epochs)
    assert port == ref
    conf, log = port
    assert conf["epochs"] == 6 and 0 < conf["pools"] <= 16
    assert conf["coverage"] == 1.0
    assert conf["makespan"]["ratio_p50"] == pytest.approx(2.0)
    assert [d["kind"] for d in log] == ["control_drift"]
    assert log[0]["makespan_ratio"] == pytest.approx(5.0)


# ------------------------------------------------ the port's own builders
def _sq(P, ctx, name="A", nt=6, nb=8, dtype=np.float32):
    A = P.BC(nt * nb, nt * nb, nb, nb, dtype=dtype)
    A.register(ctx, name)
    return A


def _intree(P, ctx, which):
    """The single-rank generators of tools/verify_graphs.py, built with
    either package."""
    al, BC = P.algos, P.BC
    if which == "potrf":
        return [al.potrf.build_potrf(ctx, _sq(P, ctx))]
    if which == "potrf_textbook":
        return [al.potrf.build_potrf(ctx, _sq(P, ctx),
                                     trsm_via_inverse=False)]
    if which in ("potrf_panels", "getrf_panels", "potrs_panels"):
        A = BC(48, 48, 48, 8, dtype=np.float32)
        A.register(ctx, "A")
        if which == "potrf_panels":
            return [al.potrf.build_potrf_panels(ctx, A)]
        if which == "getrf_panels":
            return [al.lu.build_getrf_panels(ctx, A)]
        B = BC(48, 8, 48, 8, dtype=np.float32)
        B.register(ctx, "B")
        return [al.potrf.build_potrs_panels(ctx, A, B)]
    if which == "gemm":
        return [al.gemm.build_gemm(ctx, _sq(P, ctx, "A", 4),
                                   _sq(P, ctx, "B", 4),
                                   _sq(P, ctx, "C", 4))]
    if which == "trsm":
        L = _sq(P, ctx, "L")
        B = BC(48, 16, 8, 8, dtype=np.float32)
        B.register(ctx, "B")
        return [al.trsm.build_trsm(ctx, L, B)]
    if which == "geqrf":
        return [al.qr.build_geqrf(ctx, _sq(P, ctx))]
    if which == "getrf_nopiv":
        return [al.lu.build_getrf_nopiv(ctx, _sq(P, ctx))]
    if which == "inverse":
        L, W, C = (_sq(P, ctx, n, 5) for n in "LWC")
        return [al.inverse.build_trtri(ctx, L, W),
                al.inverse.build_lauum(ctx, W, C, names=("W", "C"))]
    if which == "matrix_ops":
        A = _sq(P, ctx, "A", 5)
        mo = al.matrix_ops

        def op(coll, m, n, tile):
            tile += 1

        def rop(acc, tile):
            return acc + tile
        return [mo.build_apply(ctx, A, op, uplo=u)
                for u in ("full", "lower", "upper")] + \
            [mo.build_reduce_col(ctx, A, rop),
             mo.build_reduce_row(ctx, A, rop)]
    if which == "map_operator":
        S, D = _sq(P, ctx, "S", 4), _sq(P, ctx, "D", 4)
        return [al.matrix_ops.build_map_operator(
            ctx, S, D, lambda s, d, m, n: s + d)]
    if which == "reshape":
        src = _sq(P, ctx, "RSsrc", 4)
        dst = BC(32, 32, 8, 8, dtype=np.float64)
        dst.register(ctx, "RSdst")
        return [al.reshape.build_reshape_dtype(ctx, src, dst)]
    if which == "rms_norm":
        X = BC(32, 16, 8, 16, dtype=np.float32)
        W = BC(1, 16, 1, 16, dtype=np.float32)
        O = BC(32, 16, 8, 16, dtype=np.float32)
        return [P.rms.build_rms_norm(ctx, X, W, O)]
    if which == "flash_attention":
        Q = BC(32, 16, 8, 16, dtype=np.float32)
        K = BC(32, 16, 32, 16, dtype=np.float32)
        V = BC(32, 16, 32, 16, dtype=np.float32)
        O = BC(32, 16, 8, 16, dtype=np.float32)
        return [P.flash.build_flash_attention(ctx, Q, K, V, O,
                                              causal=True)]
    assert which == "paged_attention"
    pa = P.paged
    pool = pa.PagePool(ctx, 16, 4, 8, name="KV")
    _, _, _, _, names = pa.make_slot_collections(ctx, 4, 8, name="PA")
    S = pa.SeqSpec
    dec = pa.build_paged_decode(
        ctx, pool, [S(0, [0, 1, 2], 1), S(1, [3], 0), S(2, [4, 5], 3)],
        names)
    PR = BC(32, 16, 4, 16, dtype=np.float32)
    PR.register(ctx, "PR")
    pre = pa.build_paged_prefill(ctx, pool, [S(0, [6, 7], 2),
                                             S(1, [8], 4)],
                                 names, "PR", [[0, 1], [2]])
    warm = pa.build_paged_prefill(ctx, pool, [S(0, [9, 10], 3),
                                              S(1, [11, 12], 4)],
                                  names, "PR", [[3, 4], [5, 6]],
                                  warm=[1, 2])
    ver = pa.build_paged_verify(ctx, pool, [S(0, [13, 14], 2),
                                            S(1, [13, 14, 15], 3),
                                            S(2, [13], 4)], names)
    return [dec, pre, warm, ver]


INTREE = ["potrf", "potrf_textbook", "potrf_panels", "potrs_panels",
          "gemm", "trsm", "geqrf", "getrf_nopiv", "getrf_panels",
          "inverse", "matrix_ops", "map_operator", "reshape", "rms_norm",
          "flash_attention", "paged_attention"]


@pytest.mark.parametrize("which", INTREE)
def test_port_builders_verify_and_plan_clean(which):
    """Every single-rank in-tree generator, built by the port: zero
    verifier findings (as the reference's test_verify_intree.py
    requires of its own), and the same findings and plans as the
    reference's builder of the same graph."""
    def run(P):
        with P.pt.Context(nb_workers=1) as ctx:
            out = []
            for tp in _intree(P, ctx, which):
                rep = P.an.verify_taskpool(tp)
                plan = P.an.plan_taskpool(tp)
                out.append((_findings(rep), rep.ok(), _plan_doc(plan)))
            return out
    ref, port = both(run)
    for (pf, pok, pdoc), (rf, rok, rdoc) in zip(port, ref):
        assert pf == rf == [] and pok and rok
        assert pdoc == rdoc
    assert len(port) == len(ref)


# ------------------------------------------------------ ops taskpools
def test_rms_norm_taskpool_runs_verified():
    """tests/ops/test_ops_taskpools.py on the port: the RMSNorm tile DAG
    under run(verify=True), against numpy and the reference's pool."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 16)).astype(np.float32)
    w = rng.normal(size=(1, 16)).astype(np.float32)

    def run(P):
        with P.pt.Context(nb_workers=2) as ctx:
            X = P.BC(32, 16, 8, 16, dtype=np.float32)
            W = P.BC(1, 16, 1, 16, dtype=np.float32)
            O = P.BC(32, 16, 8, 16, dtype=np.float32)
            tp = P.rms.build_rms_norm(ctx, X, W, O)
            X.from_dense(x)
            W.from_dense(w)
            tp.run(verify=True)
            tp.wait()
            return O.to_dense()
    ref, port = both(run)
    expect = x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True) + 1e-6) \
        * w[0]
    np.testing.assert_allclose(port, expect, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_taskpool_runs_verified(causal):
    rng = np.random.default_rng(1)
    L, d = 32, 16
    q, k, v = (rng.normal(size=(L, d)).astype(np.float32)
               for _ in range(3))
    s = (q @ k.T) * d ** -0.5
    if causal:
        s = np.where(np.arange(L)[:, None] >= np.arange(L)[None, :], s,
                     -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    expect = (p / p.sum(axis=-1, keepdims=True)) @ v

    def run(P):
        with P.pt.Context(nb_workers=2) as ctx:
            Q = P.BC(L, d, 8, d, dtype=np.float32)
            K = P.BC(L, d, L, d, dtype=np.float32)
            V = P.BC(L, d, L, d, dtype=np.float32)
            O = P.BC(L, d, 8, d, dtype=np.float32)
            tp = P.flash.build_flash_attention(ctx, Q, K, V, O,
                                               causal=causal)
            Q.from_dense(q)
            K.from_dense(k)
            V.from_dense(v)
            tp.run(verify=True)
            tp.wait()
            return O.to_dense()
    ref, port = both(run)
    np.testing.assert_allclose(port, expect, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(port, ref, rtol=2e-5, atol=2e-5)
