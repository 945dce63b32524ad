"""The port's benchmark entry point (parsec_tpu_torch.bench) held against
bench.py on the CPU.

Each suite runs in a subprocess of both packages at the reference
tests' flags (`python bench.py ...` under JAX_PLATFORMS=cpu, `python -m
parsec_tpu_torch.bench ... --device cpu`), three at a time, once per
module: the port's documents are held to what the reference tests
assert (tests/runtime/test_bench_dispatch.py, tests/profiling/
test_bench_trace.py, tests/serve/test_bench_serve.py, tests/device/
test_bench_device.py, tests/comm/test_bench_stream.py, tests/comm/
test_bench_collective.py), and each document's key tree and its
correctness flags to the reference's.  Suites no reference test covers
(--topo, --control, --ep, --ring, --spotrf-child) must exit 0 with the
reference's keys.  The tunnel fallbacks of tests/utils/
test_bench_fallback.py are gone: without a card the headline and a
child exit non-zero with no metric line.
"""
import functools
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from parsec_tpu_torch.comm.launch import free_port_base

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_CMD = [sys.executable, os.path.join(REPO, "bench.py")]
PORT_CMD = [sys.executable, "-m", "parsec_tpu_torch.bench"]
CPU = ["--device", "cpu"]

# keys of the reference's documents the port renames: (reference path,
# port path); a path is "/"-joined keys, "[]" for a list's elements
RENAMED = (("/xla_psum_ms", "/torch_all_reduce_ms"),)
# keys only the port's documents carry: a spotrf line's yardstick, power
# limit and residual, the wave compiler's certificate cache counters; and
# the counters the port's Context.device_stats() sums beside the
# reference's
PORT_ONLY_LEAVES = {"baseline", "power_limit_w", "residual", "cert_hits",
                    "cert_misses", "cert_uncached"}
PORT_ONLY_DEVICE_STATS = {"tasks", "batches", "batched_tasks", "d2h_bytes",
                          "dead_drops", "eager_gathers", "f64_refused",
                          "fused_flows", "invalidations", "wb_tasks"}
# dicts keyed by data (refusal reasons, chosen topologies, tenants): only
# their being dicts is compared
DATA_KEYED = {"refused", "coll_topology_ops", "topology_ops", "k_by_tenant",
              "by_topo", "by_kind"}

_SERVE_KW = ("n_hi=2, n_lo=3, max_new=2, workers=2, seq_check=1, "
             "n_pages=48, max_seqs=6, lo_prompt=(4, 8), hi_prompt=(3, 5), "
             "lo_new=2")
_PORT_SERVE = (
    "import json, sys\n"
    "import parsec_tpu_torch.bench as b\n"
    f"doc = b.bench_serve_suite({_SERVE_KW}, device='cpu')\n"
    "json.dump(doc, open(sys.argv[1], 'w'))\n")
# the reference's tp section binds fixed ports: give it free ones
_REF_SERVE = (
    "import functools, json, sys\n"
    f"sys.path.insert(0, {REPO!r})\n"
    "import bench\n"
    "bench._tp_bench_section = functools.partial(\n"
    "    bench._tp_bench_section, base_port=int(sys.argv[2]))\n"
    f"doc = bench.bench_serve_suite({_SERVE_KW})\n"
    "json.dump(doc, open(sys.argv[1], 'w'))\n")
_REF_TOPO = (
    "import json, sys\n"
    f"sys.path.insert(0, {REPO!r})\n"
    "import bench\n"
    "doc = bench.bench_topo_suite(base=int(sys.argv[2]))\n"
    "json.dump(doc, open(sys.argv[1], 'w'))\n")

_DEVICE_ARGS = ["--tiles", "24", "--elems", "4096", "--batch", "4", "--reps",
                "1", "--gemm-m", "128", "--gemm-k", "32", "--gemm-mb", "16"]
_STREAM_ARGS = ["--size", str(512 * 1024), "--chunk", str(64 * 1024),
                "--hops", "3", "--reps", "1"]
_COLL_ARGS = ["--sizes", f"{64 * 1024},{256 * 1024}", "--reps", "1"]
_CONTROL_ARGS = ["--m", "256", "--reps", "2", "--reqs", "3", "--max-new",
                 "16"]

# suite -> (reference argv, port argv, writes a --json document); "{out}"
# is the document's path, "{port}" a free port base.  Longest first.
SUITES = {
    "stream": (["--stream", "--json", "{out}", *_STREAM_ARGS],
               ["--stream", "--json", "{out}", *_STREAM_ARGS, *CPU], True),
    "control": (["--control", "--json", "{out}", *_CONTROL_ARGS],
                ["--control", "--json", "{out}", *_CONTROL_ARGS, *CPU], True),
    "serve": (["-c", _REF_SERVE, "{out}", "{port}"],
              ["-c", _PORT_SERVE, "{out}"], True),
    "spotrf": (["--spotrf-child", "--n", "1024", "--nb", "256"],
               ["--spotrf-child", "--n", "1024", "--nb", "256", *CPU], False),
    "spotrf_tiled": (["--spotrf-child", "--n", "1024", "--nb", "256",
                      "--tiled"],
                     ["--spotrf-child", "--n", "1024", "--nb", "256",
                      "--tiled", *CPU], False),
    "collective": (["--collective", "--json", "{out}", *_COLL_ARGS],
                   ["--collective", "--json", "{out}", *_COLL_ARGS, *CPU],
                   True),
    "device": (["--device", "--json", "{out}", *_DEVICE_ARGS],
               ["--device", "--json", "{out}", *_DEVICE_ARGS, *CPU], True),
    "ep": (["--ep"], ["--ep"], False),
    "ring": (["--ring", "--s", "2", "--t", "256"],
             ["--ring", "--s", "2", "--t", "256", *CPU], False),
    "topo": (["-c", _REF_TOPO, "{out}", "{port}"],
             ["--topo", "--json", "{out}"], True),
    "dispatch": (["--dispatch", "--json", "{out}", "--tasks", "2000",
                  "--mt-tasks", "600", "--reps", "2"],
                 ["--dispatch", "--json", "{out}", "--tasks", "2000",
                  "--mt-tasks", "600", "--reps", "2"], True),
    "trace": (["--trace", "--json", "{out}", "--tasks", "1500", "--reps",
               "1", "--ring", "4096"],
              ["--trace", "--json", "{out}", "--tasks", "1500", "--reps",
               "1", "--ring", "4096"], True),
    "dispatch_mt": (["--dispatch-mt"], ["--dispatch-mt"], False),
    "profov": (["--profov"], ["--profov"], False),
}


def _run(pkg, suite, tmp):
    """One suite of one package in a subprocess; {"rc", "out", "err",
    "line" (the last stdout JSON line), "doc" (its document or None)}."""
    ref_argv, port_argv, has_doc = SUITES[suite]
    out = os.path.join(tmp, f"{pkg}_{suite}.json")
    env = dict(os.environ, PTC_MCA_tune_cache_path=os.path.join(
        tmp, f"{pkg}_{suite}_tuned.json"))
    port = free_port_base(48)
    if pkg == "ref":
        env["JAX_PLATFORMS"] = "cpu"
        env["PTC_PORT"] = str(port)  # its stream/collective bases
        argv = ref_argv
        cmd = [sys.executable] if argv[0] == "-c" else REF_CMD
    else:
        argv = port_argv
        cmd = [sys.executable] if argv[0] == "-c" else PORT_CMD
    argv = [a.replace("{out}", out).replace("{port}", str(port))
            for a in argv]
    r = subprocess.run(cmd + argv, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    doc = None
    if has_doc and r.returncode == 0:
        with open(out) as f:
            doc = json.load(f)
    return {"rc": r.returncode, "out": r.stdout, "err": r.stderr,
            "line": json.loads(lines[-1]) if lines else None, "doc": doc}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every suite of both packages, three subprocesses at a time;
    runs[(pkg, suite)] blocks until that run has ended."""
    tmp = str(tmp_path_factory.mktemp("bench"))
    pool = ThreadPoolExecutor(max_workers=3)
    futs = {(pkg, s): pool.submit(_run, pkg, s, tmp)
            for s in SUITES for pkg in ("port", "ref")}

    class Runs:
        def __getitem__(self, key):
            r = futs[key].result()
            assert r["rc"] == 0, (key, r["out"][-2000:], r["err"][-4000:])
            return r
    yield Runs()
    pool.shutdown(wait=True)


def _paths(x, pre=""):
    """The key tree of a JSON value as "/"-joined paths."""
    out = set()
    if isinstance(x, dict):
        for k, v in x.items():
            p = f"{pre}/{k}"
            out.add(p)
            if k not in DATA_KEYED:
                out |= _paths(v, p)
    elif isinstance(x, list):
        for v in x:
            out |= _paths(v, pre + "[]")
    return out


def _prune_none(a, b):
    """(a, b) with every subtree where one side is None and the other a
    dict or a list dropped from both (a value the run's data decides,
    e.g. a controller that did not swap), recursively."""
    if isinstance(a, dict) and isinstance(b, dict):
        ka, kb = {}, {}
        for k in set(a) | set(b):
            va, vb = a.get(k, KeyError), b.get(k, KeyError)
            if (va is None and isinstance(vb, (dict, list))) or \
                    (vb is None and isinstance(va, (dict, list))):
                continue
            if va is not KeyError and vb is not KeyError:
                va, vb = _prune_none(va, vb)
            if va is not KeyError:
                ka[k] = va
            if vb is not KeyError:
                kb[k] = vb
        return ka, kb
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        pairs = [_prune_none(x, y) for x, y in zip(a, b)]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    return a, b


def _port_view(paths):
    """The port's paths with the listed renames undone and the port-only
    keys dropped."""
    out = set()
    for p in paths:
        for ref_p, port_p in RENAMED:
            if p == port_p or p.startswith(port_p + "/"):
                p = ref_p + p[len(port_p):]
        keys = p.split("/")
        if keys[-1] in PORT_ONLY_LEAVES or (
                len(keys) > 1 and keys[-2] in PORT_ONLY_LEAVES):
            continue
        if len(keys) > 1 and keys[-2] == "device_stats" and \
                keys[-1] in PORT_ONLY_DEVICE_STATS:
            continue
        out.add(p)
    return out


# ------------------------------------------------- the reference tests
def test_dispatch_suite_schema(runs):
    """tests/runtime/test_bench_dispatch.py's schema on the port."""
    from parsec_tpu_torch.analysis.tune import host_fingerprint
    r = runs[("port", "dispatch")]
    line = r["line"]
    assert line["metric"] == "task_dispatch_p50"
    assert line["value"] > 0
    doc = r["doc"]
    assert doc["bench"] == "dispatch"
    assert doc["host"]["cpu_count"] == os.cpu_count()
    assert doc["budget_us"] == 5.0
    pctl = {"p50_us", "p99_us", "tasks", "reps", "workers", "sched_stats"}
    stats = {"bypass_hits", "bypass_enabled", "freelist_hits",
             "freelist_misses", "arena_hits", "arena_misses",
             "insert_batches", "insert_batched_tasks", "inject_pushes",
             "inject_pops", "steals", "executed"}
    single = doc["single_chain"]
    assert pctl <= set(single)
    assert 0 < single["p50_us"] <= single["p99_us"]
    assert stats <= set(single["sched_stats"])
    assert single["sched_stats"]["bypass_hits"] > 0
    mt = doc["contended"]
    assert pctl <= set(mt)
    assert mt["cpu_count"] == os.cpu_count()
    assert mt["workers"] >= 1 and mt["lanes"] >= 1
    assert mt["oversubscribed"] == (mt["workers"] > mt["cpu_count"])
    if mt["oversubscribed"]:
        assert "caveat" in mt and "timeshare" in mt["caveat"]
        assert "WARNING" in r["err"]
    assert doc["host"]["fingerprint"] == host_fingerprint()
    t = doc["tuned"]
    assert t["workload"] == "single_chain"
    assert t["signature"] and t["host"] == host_fingerprint()
    assert t["default_wall_s"] > 0 and t["winner_wall_s"] > 0
    assert t["tuned_vs_default"] is not None
    assert t["beats_default"] == (t["tuned_vs_default"] <= 1.0)
    assert any(v["knobs"] == t["default_knobs"] for v in t["validated"])
    assert all(v["predicted_ns"] > 0 and v["measured_s"] > 0
               and v["predicted_vs_wall"] is not None
               for v in t["validated"])
    assert t["persisted"] is True


def test_dispatch_mt_line_records_host(runs):
    line = runs[("port", "dispatch_mt")]["line"]
    assert line["metric"] == "task_dispatch_mt_p50"
    cfg = line["config"]
    assert cfg["cpu_count"] == os.cpu_count()
    assert {"workers", "workers_requested", "lanes",
            "oversubscribed"} <= set(cfg)
    if cfg["oversubscribed"]:
        assert "caveat" in line


def test_bench_trace_schema():
    """tests/profiling/test_bench_trace.py on the port, in this process."""
    from parsec_tpu_torch.bench import bench_trace_suite
    doc = bench_trace_suite(tasks=1500, reps=1, ring_bytes=4096)
    assert doc["schema"] == "bench-trace-v1"
    assert doc["knobs"] == {"tasks": 1500, "reps": 1, "ring_bytes": 4096}
    assert set(doc["ns_per_task"]) == {"0", "1", "2"}
    for v in doc["ns_per_task"].values():
        assert v >= 0
    ov = doc["overhead_ns_per_task"]
    assert set(ov) == {"level1", "level2", "ring_level1"}
    ring = doc["ring"]
    assert ring["dropped_events"] > 0
    assert ring["vs_unbounded_level1"] is not None
    assert ring["ns_per_task"] > 0
    assert "host" in doc and "cpu_count" in doc["host"]
    assert doc["pipeline_threads"] == 1
    assert isinstance(doc["oversubscribed"], bool)


def test_bench_serve_schema(runs):
    """tests/serve/test_bench_serve.py's assertions on the port's
    document at the reference test's sizes."""
    doc = runs[("port", "serve")]["doc"]
    assert doc["host"]["cpu_count"] >= 1
    assert "oversubscribed" in doc
    for side in ("qos", "control"):
        sec = doc[side]
        for tenant in ("hi", "lo"):
            for k in ("n", "p50_ms", "p99_ms", "mean_ms"):
                assert isinstance(sec[tenant][k], (int, float)), (side, k)
        assert sec["throughput_tok_s"] > 0
        assert sec["server_totals"]["completed"] == 5
    assert isinstance(doc["qos"]["hi_p99_beats_control"], bool)
    assert doc["hi_p99_improvement"] > 0
    adm = doc["admission"]
    assert adm["submitted"] == 12
    assert adm["rejected"] > 0
    assert adm["admitted"] + adm["rejected"] == adm["submitted"]
    assert doc["decode"]["bit_identical"] is True
    assert doc["decode"]["sequential_engine_checked"] == 1
    assert doc["qos"]["qos_selects"] > 0
    sc = doc["scope"]
    for k in ("ttft_p99_ms", "ttft_p50_ms", "tokens_per_s_p50",
              "queue_wait_p99_ms"):
        assert set(sc[k]) == {"hi", "lo"}, (k, sc[k])
        assert sc[k]["hi"] >= 0
    conf = sc["conformance"]
    assert conf["coverage"] == 1.0, conf
    assert conf["sound"] is True, conf
    assert conf["per_class_classes"] > 0
    pfx = doc["prefix"]
    assert 0.0 < pfx["hit_rate"] <= 1.0
    assert pfx["bit_identical"] is True
    assert pfx["fewer_prefill_than_cold"] is True
    assert pfx["pages_prefilled_warm"] < pfx["pages_prefilled_cold"]
    assert pfx["warm_tokens_per_s"] > 0
    sp = doc["spec"]
    assert sp["bit_identical"] is True
    assert sp["fewer_waves_than_off"] is True
    for k in ("off", "k2", "k4"):
        assert sp[k]["tokens_per_s"] > 0
    assert sp["k4"]["accept_rate"] == 1.0
    vw = sp["verify_wave"]
    assert vw["single_fused_launch"] is True
    assert vw["fused_marked_launches"] > 0
    assert vw["device_launches"] < vw["fused_tasks"]
    assert doc["fleet"]["bit_identical"] is True
    assert doc["tp"]["bit_identical"] is True
    assert doc["tp"]["all_ranks_fused"] is True


def test_device_suite_schema(runs):
    """tests/device/test_bench_device.py's assertions on the port."""
    r = runs[("port", "device")]
    line = r["line"]
    assert line["metric"] == "device_h2d_stall_reduction"
    assert line["config"]["ooc_gemm_correct"] is True
    doc = r["doc"]
    assert doc["bench"] == "device"
    assert doc["host"]["cpu_count"] == os.cpu_count()
    assert {"prefetch_depth", "staging_slots", "out_of_core",
            "overcommit"} <= set(doc["knobs"])
    wp = doc["wave_pipeline"]
    assert {"tiles", "tile_bytes", "batch", "reps", "staged", "prefetched",
            "hit_wave_stall_reduction", "total_stall_reduction"} <= set(wp)
    run_keys = {"waves", "wall_s", "wave_p50_us", "stall_per_wave_us",
                "stall_total_ms", "prefetch_hit_waves", "staged_waves",
                "device_stats"}
    assert run_keys <= set(wp["staged"]), wp
    assert run_keys <= set(wp["prefetched"]), wp
    assert wp["staged"]["stall_total_ms"] > 0, wp
    assert wp["prefetched"]["prefetch_hit_waves"] > 0, wp
    assert wp["hit_wave_stall_reduction"] is not None, wp
    assert wp["hit_wave_stall_reduction"] >= 0.8, wp
    g = doc["out_of_core_gemm"]
    assert {"m", "n", "k", "mb", "tile_set_bytes", "budget_bytes",
            "budget_ratio", "wall_s", "correct", "spills", "spill_bytes",
            "reserve_fails", "end_residency_bytes"} <= set(g), g
    assert g["correct"] is True, g
    assert g["budget_ratio"] >= 2.0, g
    assert g["spills"] > 0 and g["spill_bytes"] > 0, g
    assert doc["wave_fuse"]["bit_identical"] is True, doc["wave_fuse"]
    assert doc["oversubscribed"] == \
        (doc["pipeline_threads"] > doc["host"]["cpu_count"])
    if doc["oversubscribed"]:
        assert "caveat" in doc and "timeshare" in doc["caveat"]
        assert "WARNING" in r["err"]


def test_stream_suite_schema(runs):
    """tests/comm/test_bench_stream.py's assertions on the port: two
    spawned ranks, each with a CudaDevice on the CPU."""
    line = runs[("port", "stream")]["line"]
    assert line["metric"] == "stream_vs_serialized_latency_ratio"
    assert line["value"] is not None
    doc = runs[("port", "stream")]["doc"]
    assert doc["bench"] == "stream"
    assert doc["host"]["cpu_count"] == os.cpu_count()
    assert {"comm_rails", "comm_chunk_size", "comm_inflight",
            "comm_stream"} <= set(doc["knobs"])
    assert "oversubscribed" in doc
    if doc["oversubscribed"]:
        assert "caveat" in doc
    run_keys = {"size_bytes", "stream", "rails", "setup_ms",
                "per_transfer_ms", "per_transfer_ms_all", "gbps",
                "sessions", "parked_gets", "d2h_ns", "wire_ns",
                "overlap_ns", "overlap_fraction", "device"}
    for k in ("serialized", "streamed", "rails1_streamed"):
        assert run_keys <= set(doc[k]), (k, doc[k].keys())
    assert doc["serialized"]["sessions"] == 0
    assert doc["streamed"]["sessions"] > 0
    assert doc["streamed"]["d2h_ns"] > 0
    assert doc["streamed"]["wire_ns"] > 0
    assert doc["streamed"]["overlap_fraction"] is not None
    assert doc["stream_vs_serialized_ratio"] is not None
    assert doc["rails2_vs_rails1_throughput"] is not None
    assert doc["ratio_target"] == 0.6
    t = doc["tuned"]
    assert t["workload"] == "device_tile_chain"
    assert any(v["knobs"] == t["default_knobs"] for v in t["validated"])
    assert all(v["per_transfer_ms"] > 0 and v["predicted_ns"] > 0
               for v in t["validated"])
    assert t["tuned_vs_default"] is not None
    assert t["beats_default"] == (t["tuned_vs_default"] <= 1.0)
    assert t["persisted"] is True


def test_collective_suite_schema(runs):
    """tests/comm/test_bench_collective.py's assertions on the port, its
    library baseline torch_all_reduce_ms."""
    line = runs[("port", "collective")]["line"]
    assert line["metric"] == "coll_vs_chain_reduction_latency_ratio"
    assert line["value"] is not None
    doc = runs[("port", "collective")]["doc"]
    assert doc["bench"] == "collective"
    assert doc["host"]["cpu_count"] == os.cpu_count()
    assert {"coll_topo", "coll_slice", "coll_max_slices",
            "comm_chunk_size", "comm_rails",
            "comm_stream"} <= set(doc["knobs"])
    assert "oversubscribed" in doc
    if doc["oversubscribed"]:
        assert "caveat" in doc
    assert len(doc["sweep"]) == 2
    for entry in doc["sweep"]:
        assert {"size_bytes", "chain_ms", "coll_ms",
                "coll_vs_chain_ratio"} <= set(entry)
        assert entry["chain_ms"] > 0 and entry["coll_ms"] > 0
    gp = doc["gemm_panel"]
    for mode in ("chain", "coll"):
        assert {"lost_time_totals", "comm_plus_coll_wait_ns",
                "wire_inflight_ns", "matched_flows",
                "overlap_fraction"} <= set(gp[mode])
        assert {"compute", "release", "h2d_stall", "comm_wait",
                "coll_wait", "idle"} <= set(gp[mode]["lost_time_totals"])
    assert gp["chain"]["lost_time_totals"]["coll_wait"] == 0
    assert gp["coll"]["lost_time_totals"]["coll_wait"] > 0
    assert gp["coll"]["matched_flows"] > gp["chain"]["matched_flows"]
    assert "wait_reduction" in gp and "overlap_fraction_gain" in gp
    t = doc["tuned"]
    assert t["workload"] == "gemm_panel_reduce"
    assert any(v["knobs"] == t["default_knobs"] for v in t["validated"])
    assert all(v["coll_ms"] > 0 and v["predicted_ns"] > 0
               for v in t["validated"])
    assert t["tuned_vs_default"] is not None
    assert t["beats_default"] == (t["tuned_vs_default"] <= 1.0)
    assert t["persisted"] is True
    assert doc["coll_topology_ops"], doc
    lib = doc["torch_all_reduce_ms"]
    assert set(lib) == {str(64 * 1024), str(256 * 1024)}
    assert all(v > 0 for v in lib.values())
    assert "xla_psum_ms" not in doc


# ----------------------------------------------- both packages, compared
@pytest.mark.parametrize("suite", sorted(SUITES))
def test_keys_match_the_reference(runs, suite):
    """The port's document (or stdout line) has the reference's key tree
    at the same flags, apart from RENAMED, PORT_ONLY_* and values one
    run leaves None where the other holds a section."""
    ref, port = runs[("ref", suite)], runs[("port", suite)]
    # the reference's topology and serve runs are scripts (free ports):
    # they print no line
    fields = [f for f in ("line", "doc") if ref[f] is not None]
    assert fields
    for field in fields:
        a, b = _prune_none(ref[field], port[field])
        want, got = _paths(a), _port_view(_paths(b))
        assert want - got == set() and got - want == set(), \
            (field, sorted(want - got), sorted(got - want))


def _flags(suite, r):
    """The correctness flags and the run's deterministic counts of one
    suite's run, which both packages must give alike."""
    d, ln = r["doc"], r["line"]
    if suite == "device":
        return {"ooc": d["out_of_core_gemm"]["correct"],
                "fuse": d["wave_fuse"]["bit_identical"],
                "tasks": d["wave_fuse"]["tasks"]}
    if suite == "serve":
        return {"decode": d["decode"]["bit_identical"],
                "prefix": (d["prefix"]["bit_identical"],
                           d["prefix"]["hit_rate"],
                           d["prefix"]["pages_prefilled_warm"],
                           d["prefix"]["pages_prefilled_cold"]),
                "spec": (d["spec"]["bit_identical"],
                         d["spec"]["k4"]["accept_rate"],
                         d["spec"]["verify_wave"]["single_fused_launch"]),
                "fleet": d["fleet"]["bit_identical"],
                "tp": (d["tp"]["bit_identical"],
                       d["tp"]["all_ranks_fused"]),
                "submitted": d["admission"]["submitted"]}
    if suite == "topo":
        rm = d["remap"]
        return {"bits": d["bit_identical"], "sound": rm["predicted_sound"],
                "payload": rm["payload_within_25pct"], "perm": rm["perm"],
                "predicted": (rm["predicted_ident"], rm["predicted_remap"])}
    if suite == "control":
        # the scores count decode waves, which the admission timing moves
        return {"bits": d["spec"]["bit_identical"],
                "configs": sorted(d["spec"]["configs"])}
    if suite.startswith("spotrf"):
        return {"config": ln["config"], "tasks": ln["counters"]["tasks"]}
    if suite == "ring":
        return {"config": ln["config"], "err_ok": ln["max_abs_err"] <= 5e-2}
    if suite == "collective":
        return {"sizes": [e["size_bytes"] for e in d["sweep"]],
                "topology_ops": d["coll_topology_ops"]}
    return {"metric": ln["metric"]}


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_correctness_flags_match_the_reference(runs, suite):
    want = _flags(suite, runs[("ref", suite)])
    got = _flags(suite, runs[("port", suite)])
    assert got == want


# ------------------------------------------ suites no reference test runs
def test_topo_suite_on_the_port(runs):
    doc = runs[("port", "topo")]["doc"]
    assert doc["bench"] == "topo" and doc["bit_identical"] is True
    rm = doc["remap"]
    assert rm["dcn_reduction"] >= 0.30
    assert rm["predicted_sound"] is True
    assert doc["allreduce"]["dcn_bytes_hier"] < \
        doc["allreduce"]["dcn_bytes_ring"]


def test_control_suite_on_the_port(runs):
    r = runs[("port", "control")]
    assert r["line"]["metric"] == "control_drift_recovery_ratio"
    sp = r["doc"]["spec"]
    assert sp["bit_identical"] is True
    assert set(sp["configs"]) == {"k1", "k2", "k4", "kauto"}
    assert sp["adaptive_ge_best_fixed"] == \
        (sp["adaptive_score"] >= sp["best_fixed_score"])
    soak = r["doc"]["soak"]
    assert soak["tasks"] == (256 // 32) ** 2 * (64 // 32)
    assert soak["recovered"] == (soak["recovery_ratio"] >= 0.5
                                 and soak["swaps"] >= 1)


def test_ep_line_on_the_port(runs):
    line = runs[("port", "ep")]["line"]
    assert line["metric"] == "ep_tasks_per_sec" and line["value"] > 0
    assert "sched" in runs[("port", "ep")]["err"]  # the table


def test_ring_line_on_the_port(runs):
    line = runs[("port", "ring")]["line"]
    assert line["metric"] == "ring_attention_runtime_over_gspmd"
    assert line["config"] == {"S": 2, "T": 256, "d": 128, "seq": 512}
    assert line["chip_kind"] == "cpu"
    assert line["max_abs_err"] <= 5e-2
    assert line["gspmd_ms"] > 0 and line["runtime_ms"] > 0


@pytest.mark.parametrize("suite,variant", [("spotrf", "panel"),
                                           ("spotrf_tiled", "tile")])
def test_spotrf_child_on_the_port(runs, suite, variant):
    """--spotrf-child at N 1024, NB 256 on the host: the residual gate
    passed, vs_baseline against torch.linalg.cholesky in the same
    process."""
    line = runs[("port", suite)]["line"]
    assert line["metric"] == "spotrf_gflops_per_chip"
    assert line["config"] == {"N": 1024, "NB": 256, "variant": variant}
    assert line["value"] > 0
    assert 0 <= line["residual"] <= 1e-2
    base = line["baseline"]
    assert base["name"] == "torch.linalg.cholesky" and base["gflops"] > 0
    # the quotient of the unrounded rates: within what rounding both to
    # 0.1 GFLOP/s allows
    v, b = line["value"], base["gflops"]
    assert (v - 0.05) / (b + 0.05) - 1e-4 <= line["vs_baseline"] <= \
        (v + 0.05) / (b - 0.05) + 1e-4
    assert line["chip_kind"] == "cpu" and line["power_limit_w"] is None


# ------------------------------------- the headline, no tunnel fallbacks
def _port(argv, env=None, timeout=300):
    return subprocess.run(PORT_CMD + argv, cwd=REPO, capture_output=True,
                          text=True, timeout=timeout,
                          env=dict(os.environ, **(env or {})))


def _metric_lines(stdout):
    return [ln for ln in stdout.splitlines() if ln.startswith("{")]


def test_headline_without_a_card_exits_nonzero(tmp_path):
    """No card, no --device cpu: a non-zero exit and no metric line,
    whatever an old watcher log holds (the port never reads it)."""
    log = tmp_path / "w.jsonl"
    log.write_text(json.dumps({"metric": "spotrf_gflops_per_chip",
                               "value": 100.0, "unit": "GFLOP/s",
                               "config": {"N": 8192, "NB": 512}}) + "\n")
    r = _port([], env={"PTC_WATCH_LOG": str(log), "PTC_BENCH_N": "1024",
                       "PTC_BENCH_NB": "256"})
    assert r.returncode != 0
    assert _metric_lines(r.stdout) == []
    assert "CUDA" in r.stderr


def test_spotrf_child_without_a_card_exits_nonzero():
    r = _port(["--spotrf-child", "--n", "1024", "--nb", "256"])
    assert r.returncode != 0
    assert _metric_lines(r.stdout) == []


def test_headline_climbs_its_rung_on_the_host():
    """PTC_BENCH_N pins the ladder to one rung; with --device cpu the
    child runs on the host and its line is the headline's."""
    r = _port(["--device", "cpu"], env={"PTC_BENCH_N": "1024",
                                        "PTC_BENCH_NB": "256"})
    assert r.returncode == 0, r.stderr[-3000:]
    (line,) = _metric_lines(r.stdout)
    line = json.loads(line)
    assert line["metric"] == "spotrf_gflops_per_chip"
    assert line["config"] == {"N": 1024, "NB": 256, "variant": "panel"}
    assert line["baseline"]["name"] == "torch.linalg.cholesky"


def test_headline_with_a_failed_child_exits_nonzero():
    """A child that fails (NB 0) ends the headline with a non-zero exit
    and no metric line: there is no dispatch fallback."""
    r = _port(["--device", "cpu"], env={"PTC_BENCH_N": "1024",
                                        "PTC_BENCH_NB": "0"})
    assert r.returncode != 0
    assert _metric_lines(r.stdout) == []
    assert "failed" in r.stderr


def test_no_tunnel_fallbacks_in_the_package():
    import importlib

    import parsec_tpu_torch.bench as b
    pkg = os.path.dirname(b.__file__)
    for name in sorted(os.listdir(pkg)):
        if not name.endswith(".py"):
            continue
        mod = importlib.import_module(f"parsec_tpu_torch.bench.{name[:-3]}")
        for attr in ("_best_cached_spotrf", "_probe_tpu"):
            assert not hasattr(mod, attr), (name, attr)
        src = open(os.path.join(pkg, name)).read()
        for word in ("PTC_WATCH_LOG", "pkill", "tpu_watch", "_probe_tpu"):
            assert word not in src, (name, word)
    assert not hasattr(b, "_best_cached_spotrf")


def test_device_suites_need_a_card_by_default():
    """Every device suite's default is the card: without one it raises
    before it runs anything."""
    import torch

    import parsec_tpu_torch.bench as b
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for fn in (b.bench_device_suite, b.bench_stream_suite,
               b.bench_collective_suite, b.bench_serve_suite,
               b.bench_control_suite, b.bench_ring,
               functools.partial(b.bench_spotrf, 512, 128)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


def test_device_flag_parsing():
    from parsec_tpu_torch.bench.common import (device_choice,
                                               device_suite_selected)
    assert device_choice([]) == "cuda"
    assert device_choice(["--ring", "--device", "cpu"]) == "cpu"
    assert device_choice(["--device", "cuda:1"]) == "cuda:1"
    assert device_suite_selected(["--device", "--json", "x"])
    assert device_suite_selected(["--device", "--device", "cpu"])
    assert device_suite_selected(["--json", "x", "--device"])
    assert not device_suite_selected(["--device", "cpu", "--ring"])


def test_bench_imports_neither_jax_nor_the_reference():
    """A fresh interpreter imports every module of parsec_tpu_torch.bench
    with jax, parsec_tpu and the root bench.py absent from
    sys.modules."""
    code = (
        "import importlib, os, sys\n"
        "import parsec_tpu_torch.bench as b\n"
        "pkg = os.path.dirname(b.__file__)\n"
        "for n in sorted(os.listdir(pkg)):\n"
        "    if n.endswith('.py') and n != '__main__.py':\n"
        "        importlib.import_module('parsec_tpu_torch.bench.' + n[:-3])\n"
        "import parsec_tpu_torch.bench.__main__\n"
        "bad = [m for m in sys.modules if m in ('jax', 'bench') or\n"
        "       m.split('.')[0] in ('jax', 'jaxlib', 'parsec_tpu')]\n"
        "print(bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_cholesky_baseline_factors_the_generated_matrix():
    """The yardstick factors the same SPD matrix the runs generate: its
    factor reproduces that matrix."""
    import torch

    from parsec_tpu_torch.bench.spotrf import cholesky_baseline
    from parsec_tpu_torch.device.bench_utils import _spd_blocks
    base = cholesky_baseline(256, 64, "cpu", reps=1)
    assert base["name"] == "torch.linalg.cholesky" and base["gflops"] > 0
    a = np.zeros((256, 256), np.float32)
    for m, n, blk in _spd_blocks(0, 4, 64, 256, torch.device("cpu")):
        a[m * 64:(m + 1) * 64, n * 64:(n + 1) * 64] = blk.numpy()
    np.testing.assert_array_equal(a, a.T)
    assert np.linalg.eigvalsh(a.astype(np.float64)).min() > 0


@pytest.mark.parametrize("spec", ["0,1;2,3", "0|1;2|3", ""])
def test_topology_spec_matches_the_reference(monkeypatch, spec):
    """--topo's islands: the port's comm.topology spec (the
    PTC_MCA_comm_topology spelling) gives the reference's model."""
    import parsec_tpu.comm.topology as jtopo
    import parsec_tpu.utils as jutils
    import parsec_tpu_torch.comm.topology as ttopo
    import parsec_tpu_torch.utils as tutils
    monkeypatch.setenv("PTC_MCA_comm_topology", spec)
    models = []
    for utils, topo in ((jutils, jtopo), (tutils, ttopo)):
        assert utils.params.get("comm.topology") == spec
        tm = topo.default_topology(4)
        models.append((tm.n_islands, tm.matrix(), tm.source))
    assert models[0] == models[1]
    assert models[1][0] == (2 if spec else 1)
