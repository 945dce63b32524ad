"""The port's tools (parsec_tpu_torch.tools) held against the repo's
tools/ on the CPU, both packages in one process.

Each reference tool runs in this process through its main(argv) (tools/
on sys.path, as tests/dsl/test_jdf2dot_sim.py runs jdf2dot), or as a
subprocess under JAX_PLATFORMS=cpu where it sets up JAX itself (the card
probes).  Compared exactly: per in-tree generator the verifier's
reports, the plans' JSON (timing fields aside) and the default vector's
simulated makespan; ptc_verify's exit codes; jdf2dot's DOT, counts and
simulations over examples/*.jdf; the four ptt readers and ptc_plan
--trace with each package reading the other's level-2 traces, one rank
and two ranks merged; the postmortem on tests/data/blackbox_fixture.
The card tools run at tiny sizes with --device cpu (their JSON keys,
DTD GEMM's C against numpy, the economics document's fit), and raise
with their default device where there is no card.
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import parsec_tpu as jpt
import parsec_tpu.profiling as jprof
import parsec_tpu_torch as tpt
import parsec_tpu_torch.profiling as tprof
from parsec_tpu_torch.comm.economics import TransferEconomics
from parsec_tpu_torch.comm.launch import free_port_base
from parsec_tpu_torch.tools import (bench_dataplane, bench_dtd_gemm, jdf2dot,
                                    plan_graphs, probe_la_kernels,
                                    probe_launch_overhead, ptc_plan,
                                    ptc_postmortem, ptc_tune, ptc_verify,
                                    ptt2dot, ptt2tables, ptt_critpath,
                                    ptt_info, testbandwidth, verify_graphs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
sys.path.insert(0, TOOLS)

import jdf2dot as r_jdf2dot  # noqa: E402
import plan_graphs as r_plan_graphs  # noqa: E402
import ptc_plan as r_ptc_plan  # noqa: E402
import ptc_postmortem as r_ptc_postmortem  # noqa: E402
import ptc_tune as r_ptc_tune  # noqa: E402
import ptc_verify as r_ptc_verify  # noqa: E402
import ptt2dot as r_ptt2dot  # noqa: E402
import ptt2tables as r_ptt2tables  # noqa: E402
import ptt_critpath as r_ptt_critpath  # noqa: E402
import ptt_info as r_ptt_info  # noqa: E402
import verify_graphs as r_verify_graphs  # noqa: E402

REF = SimpleNamespace(name="ref", pt=jpt, prof=jprof, verify=r_ptc_verify,
                      plan=r_ptc_plan, tune=r_ptc_tune, jdf2dot=r_jdf2dot,
                      plan_graphs=r_plan_graphs, info=r_ptt_info,
                      tables=r_ptt2tables, dot=r_ptt2dot,
                      critpath=r_ptt_critpath, pm=r_ptc_postmortem)
PORT = SimpleNamespace(name="port", pt=tpt, prof=tprof, verify=ptc_verify,
                       plan=ptc_plan, tune=ptc_tune, jdf2dot=jdf2dot,
                       plan_graphs=plan_graphs, info=ptt_info,
                       tables=ptt2tables, dot=ptt2dot,
                       critpath=ptt_critpath, pm=ptc_postmortem)
FIXTURE = os.path.join(REPO, "tests", "data", "blackbox_fixture")
EXAMPLES = sorted(f for f in os.listdir(os.path.join(REPO, "examples"))
                  if f.endswith(".jdf"))
CARD_TOOLS = {"probe_la_kernels": probe_la_kernels,
              "probe_launch_overhead": probe_launch_overhead,
              "bench_dtd_gemm": bench_dtd_gemm,
              "bench_dataplane": bench_dataplane,
              "testbandwidth": testbandwidth}


def call(main, argv):
    """(exit status, stdout) of a tool's main(argv) in this process; a
    SystemExit (argparse, the reference's usage exits) is its status."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, buf.getvalue()


def both(run, *args):
    return run(REF, *args), run(PORT, *args)


def _no_timing(doc):
    """A JSON document without its wall-clock fields (elapsed_ms)."""
    if isinstance(doc, dict):
        return {k: _no_timing(v) for k, v in doc.items()
                if k != "elapsed_ms"}
    if isinstance(doc, list):
        return [_no_timing(v) for v in doc]
    return doc


def _untimed(text):
    """A report without the analyses' wall times ("[3 ms]")."""
    return re.sub(r"\[\d+ ms\]", "[ms]", text)


def test_generator_tables_match():
    assert list(verify_graphs.GENERATORS) == \
        list(r_verify_graphs.GENERATORS)
    assert len(verify_graphs.GENERATORS) == 21


# ------------------------------------------------- per in-tree generator
GENERATOR_NAMES = list(r_verify_graphs.GENERATORS)


def _tool_json(P, tool, argv, tmp_path):
    out = str(tmp_path / f"{P.name}_{tool}.json")
    rc, text = call(getattr(P, tool).main, argv + ["--json", out])
    with open(out) as f:
        return rc, _no_timing(json.load(f))


@pytest.mark.parametrize("gen", GENERATOR_NAMES)
def test_verify_report_matches_reference(gen, tmp_path):
    """ptc_verify <generator> --json: every graph's findings (rule,
    severity, class, ...) and stats (class and instance counts)."""
    ref, port = both(_tool_json, "verify", [gen], tmp_path)
    assert port == ref
    rc, doc = port
    assert rc == 0 and doc
    for rep in doc.values():
        assert rep["findings"] == [] and rep["stats"]["instances"] > 0


@pytest.mark.parametrize("gen", GENERATOR_NAMES)
def test_plan_json_matches_reference(gen, tmp_path):
    """ptc_plan <generator> --json: residency, waves, fusability, comm
    volume and the makespan bounds of every graph."""
    ref, port = both(_tool_json, "plan", [gen], tmp_path)
    assert port == ref
    rc, doc = port
    assert rc == 0
    for plan in doc.values():
        assert plan["makespan"]["lower_bound_ns"] > 0


@pytest.mark.parametrize("gen", GENERATOR_NAMES)
def test_simulated_makespan_matches_reference(gen, tmp_path):
    """ptc_tune <generator> --json: the default vector's simulated
    makespan bit for bit, the fusable waves and no refusal."""
    ref, port = both(_tool_json, "tune", [gen], tmp_path)
    assert port == ref
    rc, doc = port
    assert rc == 0
    for row in doc.values():
        assert row["issues"] == [] and row["simulated_makespan_ns"] > 0


def test_gates_over_every_generator(tmp_path):
    """plan_graphs (all graphs clean, potrf NT=16 inside its budget) and
    ptc_tune --check (the determinism gate) exit 0 on both packages;
    plan_graphs' rows are the reference's."""
    (rr, rdoc), (pr, pdoc) = both(_tool_json, "plan_graphs", [], tmp_path)
    assert rr == pr == 0
    assert pdoc["graphs"] == rdoc["graphs"] and len(pdoc["graphs"]) == 33
    assert pdoc["potrf_nt16_ms"] < 1e3 * pdoc["potrf_nt16_budget_s"]
    assert set(pdoc["host"]) == {"cpu_count", "platform", "machine",
                                 "fingerprint"}
    (rr, rout), (pr, pout) = both(
        lambda P: call(P.tune.main, ["--check"]))
    assert rr == pr == 0
    assert pout.splitlines()[-1] == rout.splitlines()[-1] == \
        "tune-check: 33 graph(s), 0 with refusals"


def _bad_v001(tmp_path):
    src = open(os.path.join(REPO, "tests", "analysis",
                            "test_verify_rules.py")).read()
    jdf = src.split('BAD_V001 = """', 1)[1].split('"""', 1)[0]
    path = tmp_path / "v001.jdf"
    path.write_text(jdf)
    return str(path)


@pytest.mark.parametrize("case,want", [("clean", 0), ("error", 1),
                                       ("usage", 2)])
def test_ptc_verify_exit_codes(case, want, tmp_path):
    argv = {"clean": lambda: ["gemm"],
            "error": lambda: [_bad_v001(tmp_path)],
            "usage": lambda: ["no_such_graph"]}[case]()
    (rr, rout), (pr, pout) = both(lambda P: call(P.verify.main, argv))
    assert rr == pr == want
    assert _untimed(pout) == _untimed(rout)


# ------------------------------------------------------------- jdf2dot
def _jdf2dot(P, argv, tmp_path):
    out = str(tmp_path / f"{P.name}.dot")
    try:
        rc, text = call(P.jdf2dot.main, [argv[0], out] + argv[1:])
    except ValueError as e:  # enumeration refused: the same error
        return ("raised", str(e))
    return rc, text.replace(out, "OUT"), open(out).read()


@pytest.mark.parametrize("ex", EXAMPLES)
def test_jdf2dot_examples_match_reference(ex, tmp_path):
    """DOT (edge set), task/edge counts, findings and --simulate 2 on
    every examples/*.jdf; a program whose enumeration fails (Ex08's
    datatype needs its runner's registration) fails the same way."""
    argv = [os.path.join(REPO, "examples", ex), "--simulate", "2"]
    ref, port = both(_jdf2dot, argv, tmp_path)
    assert port == ref
    if ex.startswith("Ex08"):
        assert port[0] == "raised"
    else:
        assert port[0] == 0 and "simulate: " in port[1]


FORK_JOIN = open(os.path.join(REPO, "tests", "dsl",
                              "test_jdf2dot_sim.py")).read().split(
    'FORK_JOIN = """', 1)[1].split('"""', 1)[0].replace(
    "     -> A Join(0)\nBODY", "     -> A Join(0)\nCTL X -> X Join(0)\nBODY")


@pytest.mark.parametrize("workers,makespan", [(2, 9), (4, 6)])
def test_jdf2dot_simulate_fork_join(workers, makespan, tmp_path):
    """tests/dsl/test_jdf2dot_sim.py's weighted fork-join on both."""
    jdf = tmp_path / "fj.jdf"
    jdf.write_text(FORK_JOIN)
    ref, port = both(_jdf2dot, [str(jdf), "--global", "N=3", "--simulate",
                                str(workers)], tmp_path)
    assert port == ref
    sim = json.loads([ln for ln in port[1].splitlines()
                      if ln.startswith("simulate: ")][0][10:])
    assert (sim["tasks"], sim["total_work"], sim["critical_path"],
            sim["makespan"]) == (6, 15, 6, makespan)


# ---------------------------------------------------------- trace readers
def _chain(P, ctx, nb, ranks):
    ctx.register_arena("t", 8)
    tp = P.pt.Taskpool(ctx, globals={"NB": nb})
    k = P.pt.L("k")
    tc = tp.task_class("Task")
    tc.param("k", 0, P.pt.G("NB"))
    if ranks > 1:
        tc.affinity("A", k % ranks)
    tc.flow("A", "RW",
            P.pt.In(P.pt.Mem("A", 0) if ranks > 1 else None,
                    guard=(k == 0)),
            P.pt.In(P.pt.Ref("Task", k - 1, flow="A")),
            P.pt.Out(P.pt.Ref("Task", k + 1, flow="A"),
                     guard=(k < P.pt.G("NB"))),
            arena="t")
    tc.body(lambda t: None)
    tp.run()
    tp.wait()


def _write_traces(P, ranks, out_dir):
    """Level-2 traces of a chain: one rank on two workers, or `ranks`
    ranks as threads of this process over the loopback transport (each
    rank's file carries its clock offset).  Returns the files."""
    paths = [os.path.join(out_dir, f"{P.name}_{ranks}r{r}.ptt")
             for r in range(ranks)]
    if ranks == 1:
        with P.pt.Context(nb_workers=2) as ctx:
            ctx.profile_enable(2)
            _chain(P, ctx, 8, 1)
            P.prof.take_trace(ctx, class_names=["Task"]).save(paths[0])
        return paths
    port, errs = free_port_base(ranks), []

    def rank_prog(rank):
        try:
            ctx = P.pt.Context(nb_workers=1)
            ctx.set_rank(rank, ranks)
            ctx.comm_init(port)
            with ctx:
                arr = np.zeros((ranks, 1), dtype=np.int64)
                ctx.register_linear_collection("A", arr, elem_size=8,
                                               nodes=ranks, myrank=rank)
                ctx.comm_fence()
                ctx.profile_enable(2)
                _chain(P, ctx, 8, ranks)
                ctx.comm_fence()
                P.prof.take_trace(ctx, class_names=["Task"]).save(
                    paths[rank])
                ctx.comm_fini()
        except Exception as e:  # pragma: no cover
            errs.append((rank, repr(e)))

    ts = [threading.Thread(target=rank_prog, args=(r,))
          for r in range(ranks)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not [t for t in ts if t.is_alive()] and not errs, errs
    return paths


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("traces"))
    return {(P.name, ranks): _write_traces(P, ranks, d)
            for P in (REF, PORT) for ranks in (1, 2)}


def _read(P, reader, files, out_dir):
    """One reader of `P` over `files`: (exit status, stdout, what it
    wrote)."""
    out = os.path.join(out_dir, f"{P.name}.{reader}")
    argv = {"info": files,
            "tables": [out + ".csv"] + files,
            "dot": [out] + files,
            "critpath": files + ["--json", out],
            "plan": [os.path.join(REPO, "examples", "Ex04_ChainData.jdf"),
                     "--trace", files[0]]}[reader]
    tool = P.plan if reader == "plan" else getattr(P, reader)
    rc, text = call(tool.main, argv)
    written = None
    for path in (out, out + ".csv"):
        if os.path.exists(path):
            with open(path) as f:
                written = f.read()
    return rc, _untimed(text.replace(out, "OUT")), written


@pytest.mark.parametrize("reader", ["info", "tables", "dot", "critpath",
                                    "plan"])
@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("ranks", [1, 2])
def test_trace_readers_cross_packages(reader, writer, ranks, traces,
                                      tmp_path):
    """ptt_info, ptt2tables (CSV), ptt2dot, ptt_critpath (--json) and
    ptc_plan --trace give the reference's output, byte for byte, on a
    level-2 trace written by either package, one rank or two merged on
    their clock offsets."""
    files = traces[(writer, ranks)]
    ref, port = both(_read, reader, files, str(tmp_path))
    assert port == ref
    rc, text, written = port
    assert rc == 0 and text
    if reader == "critpath":
        rep = json.loads(written)
        assert len(rep["critical_path"]["path"]) == 9
        assert rep["ranks"] == list(range(ranks))
        if ranks == 2:
            assert rep["wire_latency"]
    if reader == "tables":
        assert written.count("\n") - 1 == \
            int(text.split(" spans", 1)[0])


# ------------------------------------------------------------ postmortem
def test_postmortem_reproduces_the_fixture():
    """The journal fixture: --expect expected.json holds on the port, and
    both packages' --json reports and text reports are equal."""
    expect = os.path.join(FIXTURE, "expected.json")
    rc, _ = call(ptc_postmortem.main, [FIXTURE, "--expect", expect])
    assert rc == 0
    (rr, rj), (pr, pj) = both(lambda P: call(P.pm.main,
                                             [FIXTURE, "--json"]))
    assert rr == pr == 0 and json.loads(pj) == json.loads(rj)
    (rr, rt), (pr, pt_) = both(lambda P: call(P.pm.main, [FIXTURE]))
    assert rr == pr == 0 and pt_ == rt
    assert call(ptc_postmortem.main, [str(FIXTURE) + "_absent"])[0] == 2


# ------------------------------------------------------------ card tools
def _lines(text):
    return [json.loads(ln) for ln in text.splitlines() if
            ln.startswith("{")]


@pytest.fixture(scope="module")
def ref_probes():
    """The reference's card probes at tiny sizes on JAX's CPU, run as
    subprocesses: {tool: its JSON lines}."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    runs = {"probe_la_kernels": ["--nb", "32", "--batch", "2"],
            "probe_launch_overhead": [],
            "bench_dtd_gemm": ["--n", "128", "--nb", "32"]}
    out = {}
    for name, argv in runs.items():
        p = subprocess.run(
            [sys.executable, os.path.join(TOOLS, name + ".py")] + argv,
            env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr
        out[name] = _lines(p.stdout)
    return out


def test_probe_la_kernels_on_cpu(ref_probes):
    rc, text = call(probe_la_kernels.main, ["--nb", "32", "--batch", "2",
                                            "--device", "cpu"])
    assert rc == 0
    got, want = _lines(text), ref_probes["probe_la_kernels"]
    assert [(r["kernel"], r["nb"], r["batch"]) for r in got] == \
        [(r["kernel"], r["nb"], r["batch"]) for r in want]
    assert all(set(r) == set(want[0]) and r["chip"] == "cpu" and
               r["ms"] >= 0 for r in got)


def test_probe_launch_overhead_on_cpu(ref_probes):
    rc, text = call(probe_launch_overhead.main,
                    ["--device", "cpu", "--big", "64"])
    assert rc == 0
    (got,), (want,) = _lines(text), ref_probes["probe_launch_overhead"]
    assert set(got) == set(want) and got["metric"] == "launch_overhead"
    assert got["dep_us_per_call"] > 0 and got["chip_kind"] == "cpu"


def test_bench_dtd_gemm_on_cpu(ref_probes):
    """C of the DTD GEMM against numpy (1e-4 / 1e-3), and the tool's
    line under the reference's keys."""
    import torch
    dt, a, b, c = bench_dtd_gemm.run(128, 32, torch.device("cpu"),
                                     np.random.default_rng(3))
    assert dt > 0
    np.testing.assert_allclose(c, a.astype(np.float64) @ b, rtol=1e-4,
                               atol=1e-3)
    rc, text = call(bench_dtd_gemm.main, ["--n", "128", "--nb", "32",
                                          "--device", "cpu"])
    assert rc == 0
    (got,), (want,) = _lines(text), ref_probes["bench_dtd_gemm"]
    assert set(got) == set(want) | {"max_abs_err"}
    assert got["config"] == want["config"] == {"N": 128, "nb": 32,
                                               "tasks": 64}


# the reference's row keys (tools/bench_dataplane.py run_rung)
DATAPLANE_KEYS = {"tile_mb", "path", "path_taken", "xfer_ms", "gbps",
                  "d2h_bytes", "h2d_bytes", "dp_xfer_bytes"}


def test_bench_dataplane_on_cpu():
    """Two spawned ranks, 1 MiB: the bytes rung moves the tile over the
    wire; the transfer rung moves nothing over the plane on the CPU (no
    card to pull from), so it is an error row and the exit status is 1 —
    never a bytes row."""
    rc, text = call(bench_dataplane.main, ["--mb", "1", "--reps", "1",
                                           "--device", "cpu"])
    rows = _lines(text)
    assert rc == 1 and len(rows) == 2
    bytes_row, xfer_row = rows
    assert set(bytes_row) == DATAPLANE_KEYS | {"dp_errors"}
    assert bytes_row["path"] == bytes_row["path_taken"] == "bytes"
    assert bytes_row["d2h_bytes"] == 1 << 20
    assert bytes_row["dp_errors"] == 0
    assert xfer_row["path"] == "transfer" and "error" in xfer_row
    assert xfer_row["row"]["dp_xfer_bytes"] == 0


def test_testbandwidth_document_loads(tmp_path):
    """The three paths over two spawned ranks: the document has the
    reference's shape (BENCH_comm.json's keys), every path carries a fit
    of its two sizes, and TransferEconomics.load reads each fit's α and
    β back (clamped at 0, finite).  Their signs are the card's check
    (chip_smoke.py 16d, tests/test_torch_cuda.py): on a loaded CPU host
    the host device path's ms-scale scheduling noise can outweigh its
    per-byte leg, and a fit sloping below zero loads as β = 0."""
    out = str(tmp_path / "econ.json")
    rc, _ = call(testbandwidth.main, ["--quick", "--sizes", "4096,1048576",
                                      "--hops", "4", "--reps", "1",
                                      "--device", "cpu", "--json", out])
    assert rc == 0
    with open(out) as f:
        doc = json.load(f)
    with open(os.path.join(REPO, "BENCH_comm.json")) as f:
        ref = json.load(f)
    assert set(doc) >= set(ref) and set(doc["meta"]) >= set(ref["meta"])
    assert doc["meta"]["platform"] == "cpu-loopback"
    assert doc["meta"]["sizes"] == [4096, 1048576]
    econ = TransferEconomics.load(out)
    for path in ("eager", "rdv", "device"):
        row = doc["paths"][path]
        assert set(row) == set(ref["paths"][path])
        fit = row["fit"]
        assert fit["npoints"] == 2
        assert [r["size_bytes"] for r in row["sizes"]] == [4096, 1048576]
        a, b = econ.alpha(path), econ.beta(path)
        assert a == max(0.0, fit["fixed_overhead_us"]) * 1e-6
        assert b == max(0.0, fit["per_byte_ns"]) * 1e-9
        assert np.isfinite(a) and np.isfinite(b)
    assert doc["paths"]["device"]["device_stats"]["tasks"] > 0


@pytest.mark.parametrize("tool", list(CARD_TOOLS))
def test_card_tools_raise_without_a_card(tool):
    """The default device is the card: with none, each card tool raises
    before it measures anything (no silent CPU run)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(CARD_TOOLS[tool].main, [])


def test_tools_import_neither_jax_nor_the_jax_package():
    """Every module of parsec_tpu_torch.tools and .examples imported in a
    fresh interpreter leaves neither jax nor parsec_tpu in sys.modules,
    and a tool runs as python -m."""
    pkg = os.path.dirname(os.path.dirname(verify_graphs.__file__))
    mods = [f"parsec_tpu_torch.{sub}.{f[:-3]}" for sub in ("tools",
                                                           "examples")
            for f in sorted(os.listdir(os.path.join(pkg, sub)))
            if f.endswith(".py") and f != "__init__.py"]
    assert len(mods) == 16 + 3
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'parsec_tpu.')) or m == 'parsec_tpu']\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    p = subprocess.run([sys.executable, "-m",
                        "parsec_tpu_torch.tools.ptc_postmortem", FIXTURE,
                        "--expect", os.path.join(FIXTURE, "expected.json")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0 and "expectations met" in p.stderr, p.stderr


# -------------------------------------------------------------- examples
def _run_ref_example(name, monkeypatch):
    """examples/run_example.py's main (it reads sys.argv)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_ref_run_example", os.path.join(REPO, "examples", "run_example.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    monkeypatch.setattr(sys, "argv", ["run_example.py", name])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.main()
    return buf.getvalue()


# Ex06's pool aborts on both packages or not, by a race in the shared
# native core (ROADMAP); tests/test_torch_dsl.py holds the two equal
@pytest.mark.parametrize("ex", [e for e in EXAMPLES if e != "Ex06_RAW.jdf"])
def test_run_example_matches_reference(ex, monkeypatch):
    from parsec_tpu_torch.examples import run_example
    rc, out = call(run_example.main, [ex])
    assert rc == 0
    # the bodies print from several workers: the lines, in any order
    assert sorted(out.splitlines()) == \
        sorted(_run_ref_example(ex, monkeypatch).splitlines())
    assert out.splitlines()[-1].startswith("done; ")


def test_ex09_and_ex10_on_the_port():
    """Ex09's tiled and panel Cholesky with the chores' plain versions
    (--device cpu; the default, the card, raises here), and Ex10's PTG
    against DTD cross-check."""
    import torch

    from parsec_tpu_torch.examples import Ex09_PanelCholesky, Ex10_CrossCheck
    rc, out = call(Ex09_PanelCholesky.main, ["128", "32", "--device", "cpu"])
    assert rc == 0
    errs = [float(ln.split("max|err|=")[1]) for ln in out.splitlines()
            if "max|err|=" in ln]
    assert len(errs) == 2 and max(errs) < 1e-4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(Ex09_PanelCholesky.main, ["128", "32"])
    rc, out = call(Ex10_CrossCheck.main, [])
    assert rc == 0 and out.splitlines()[-1] == "cross-check ok"
