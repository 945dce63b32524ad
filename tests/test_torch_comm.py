"""The port's comm engine against the JAX package's: the Context's comm_*
surface, comm.init and the launcher, the single-rank stats schema, and the
multi-rank host DAGs of tests/comm/test_multirank.py, test_chunked.py,
test_stream.py, test_trace_dist.py and test_plan_dist.py.

Every multi-rank case spawns its ranks over the native engine's loopback
transport, each running the port's counterpart of the reference worker
(tests/test_torch_comm_workers.py), which makes the reference worker's
assertions.  The ranks' results are then held against the JAX package
running the same program on the same numpy-seeded inputs in this process,
on one rank: host bodies bit for bit, and the dense factorizations, whose
host bodies are the same numpy calls, bit for bit too.  A case whose
program has no one-rank form (peer loss, a stray client, a wire datatype,
a clock offset) is held by its worker's own assertions, as the
reference's is.  The device cases are in test_torch_dataplane.py and the
collectives in test_torch_coll.py.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import parsec_tpu as jpt
import parsec_tpu_torch as tpt
import test_torch_comm_workers as W
from parsec_tpu_torch.profiling import KEY_COMM_RECV, KEY_COMM_SEND, Trace

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------- one rank: API
def _schema(d):
    """A nested dict's key structure (values dropped)."""
    if isinstance(d, dict):
        return {k: _schema(v) for k, v in d.items()}
    return type(d).__name__ if isinstance(d, (list, bool)) else "scalar"


def test_single_rank_comm_surface_matches_reference():
    """comm_init is a no-op on one rank, the engine stays off, and every
    comm counter reads the same zeros in both packages."""
    for pkg in (jpt, tpt):
        ctx = pkg.Context(nb_workers=1)
        try:
            ctx.comm_init(0)
            assert ctx.comm_enabled is False
            ctx.comm_fence()
            ctx.comm_quiesce()
            if pkg is jpt:
                ref = (ctx.comm_stats(), ctx.comm_rdv_stats(),
                       ctx.comm_tuning(), ctx.comm_peer_stats(),
                       ctx.comm_topo_stats(), ctx.coll_stats(),
                       ctx.comm_clock())
            else:
                got = (ctx.comm_stats(), ctx.comm_rdv_stats(),
                       ctx.comm_tuning(), ctx.comm_peer_stats(),
                       ctx.comm_topo_stats(), ctx.coll_stats(),
                       ctx.comm_clock())
            ctx.comm_fini()
        finally:
            ctx.destroy()
    assert got == ref


def test_single_rank_stats_namespaces_match_reference():
    """stats()'s comm, coll and trace namespaces keep the reference's
    schema when comm is off (the golden-schema contract)."""
    out = {}
    for pkg in (jpt, tpt):
        ctx = pkg.Context(nb_workers=1)
        try:
            st = ctx.stats()
            out[pkg.__name__] = {k: _schema(st[k])
                                 for k in ("comm", "coll", "trace")}
            out[pkg.__name__ + ".vals"] = (st["comm"], st["coll"],
                                           st["trace"]["clock"])
        finally:
            ctx.destroy()
    assert out["parsec_tpu_torch"] == out["parsec_tpu"]
    assert out["parsec_tpu_torch.vals"] == out["parsec_tpu.vals"]


@pytest.mark.parametrize("topo", ["star", "chain", "binomial", 0, 1, 2,
                                  "ring", 3])
def test_comm_set_topology_validation_matches_reference(topo):
    verdicts = []
    for pkg in (jpt, tpt):
        ctx = pkg.Context(nb_workers=1)
        try:
            try:
                ctx.comm_set_topology(topo)
                verdicts.append("ok")
            except ValueError as e:
                verdicts.append(str(e))
        finally:
            ctx.destroy()
    assert verdicts[0] == verdicts[1]


def test_comm_set_colocated_and_params():
    ctx = tpt.Context(nb_workers=1)
    try:
        assert ctx._colocated == set()
        ctx.comm_set_colocated([1, "2"])
        assert ctx._colocated == {1, 2}
    finally:
        ctx.destroy()
    from parsec_tpu.utils import params as jparams
    from parsec_tpu_torch.utils import params as tparams
    for name in ("comm.base_port", "comm.bcast_topo", "comm.eager_limit",
                 "comm.eager_limit.ici", "comm.eager_limit.dcn",
                 "comm.chunk_size", "comm.chunk_size.ici",
                 "comm.chunk_size.dcn", "comm.inflight", "comm.stream",
                 "coll.topo", "coll.topo.ici", "coll.topo.dcn",
                 "coll.slice", "coll.max_slices", "device.stream_serve"):
        assert tparams.get(name) == jparams.get(name), name
    # the tuner acts on the comm axes (applied for the block, then
    # restored) but the rails, a constant here: apply_knobs refuses them
    from parsec_tpu_torch.analysis.tune import apply_knobs
    before = tparams.get("comm.chunk_size")
    with apply_knobs({"comm.chunk_size": 4096}) as applied:
        assert applied == {"comm.chunk_size": 4096}
        assert tparams.get("comm.chunk_size") == 4096
    assert tparams.get("comm.chunk_size") == before
    with pytest.raises(ValueError):
        with apply_knobs({"comm.rails": 4}):
            pass


def test_comm_init_outside_a_launched_job(monkeypatch):
    from parsec_tpu_torch.comm import init
    for var in ("PTC_RANK", "PTC_WORLD", "PTC_PORT"):
        monkeypatch.delenv(var, raising=False)
    ctx = tpt.Context(nb_workers=1)
    try:
        assert init(ctx) == (0, 1)
        assert ctx.comm_enabled is False
    finally:
        ctx.destroy()


_LAUNCHED = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
import parsec_tpu_torch as pt
from parsec_tpu_torch.comm import init
ctx = pt.Context(nb_workers=1)
rank, world = init(ctx)
arr = np.zeros(world, dtype=np.int64)
ctx.register_linear_collection("A", arr, elem_size=8, nodes=world,
                               myrank=rank)
ctx.register_arena("t", 8)
tp = pt.Taskpool(ctx, globals={{"NB": 9}})
k = pt.L("k")
tc = tp.task_class("Task")
tc.param("k", 0, pt.G("NB"))
tc.affinity("A", k % world)
tc.flow("A", "RW", pt.In(pt.Mem("A", 0), guard=(k == 0)),
        pt.In(pt.Ref("Task", k - 1, flow="A")),
        pt.Out(pt.Ref("Task", k + 1, flow="A"), guard=(k < pt.G("NB"))),
        pt.Out(pt.Mem("A", 0), guard=(k == pt.G("NB"))), arena="t")
tc.body(lambda v: v.data("A", dtype=np.int64).__setitem__(
    0, v.data("A", dtype=np.int64)[0] + 1))
tp.run()
tp.wait()
ctx.comm_fence()
assert ctx.comm_enabled and world == 2
if rank == 0:
    assert arr[0] == 10, arr
print("rank", rank, "of", world, "ok", flush=True)
ctx.comm_fini()
ctx.destroy()
"""


def test_launcher_runs_an_spmd_script(tmp_path):
    """python -m parsec_tpu_torch.comm.launch -n 2 script.py: two ranks
    join through comm.init and run one rank-hopping chain."""
    script = tmp_path / "chain.py"
    script.write_text(_LAUNCHED.format(repo=_REPO))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PTC_RANK", "PTC_WORLD", "PTC_PORT")}
    env["PYTHONPATH"] = _REPO
    out = subprocess.run(
        [sys.executable, "-m", "parsec_tpu_torch.comm.launch", "-n", "2",
         str(script)], cwd=str(tmp_path), env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "rank 0 of 2 ok" in out.stdout and "rank 1 of 2 ok" in out.stdout


# -------------------------------------------------- multi-rank host DAGs
# (case id, worker, ranks, keyword arguments, reference held?, timeout):
# each is the counterpart of the reference test named by its id
_CASES = [
    # tests/comm/test_multirank.py
    ("ptg_chain_2ranks", "ptg_chain", 2, dict(nb=33), True, 90),
    ("ptg_chain_4ranks", "ptg_chain", 4, dict(nb=40), True, 90),
    ("ptg_broadcast_4ranks", "ptg_broadcast", 4, dict(nt=12), True, 90),
    ("ptg_broadcast_topologies[chain]", "ptg_broadcast", 4,
     dict(nt=12, topo="chain"), True, 90),
    ("ptg_broadcast_topologies[binomial]", "ptg_broadcast", 4,
     dict(nt=12, topo="binomial"), True, 90),
    ("ptg_chain_topology_on_chain_dag[chain]", "ptg_chain", 3,
     dict(nb=30, topo="chain"), True, 90),
    ("ptg_chain_topology_on_chain_dag[binomial]", "ptg_chain", 3,
     dict(nb=30, topo="binomial"), True, 90),
    ("dtd_chain_2ranks", "dtd_chain", 2, dict(nb_tiles=4, rounds=6), True,
     90),
    ("dtd_routed_payloads_4ranks", "dtd_routed_payloads", 4, {}, False,
     180),
    ("ptg_chain_rendezvous_2ranks", "ptg_chain_rendezvous", 2, dict(nb=12),
     True, 90),
    ("ptg_chain_rendezvous_3ranks", "ptg_chain_rendezvous", 3, dict(nb=12),
     True, 90),
    ("ptg_bcast_rendezvous_dedup_3ranks", "ptg_bcast_rendezvous_dedup", 3,
     {}, True, 90),
    ("ptg_block_cyclic_scale[2]", "ptg_block_cyclic_scale", 2, {}, True,
     90),
    ("ptg_block_cyclic_scale[4]", "ptg_block_cyclic_scale", 4, {}, True,
     90),
    ("bcast_rendezvous_topologies_4ranks[chain]",
     "ptg_bcast_rendezvous_topo", 4, dict(topo="chain"), True, 150),
    ("bcast_rendezvous_topologies_4ranks[binomial]",
     "ptg_bcast_rendezvous_topo", 4, dict(topo="binomial"), True, 150),
    ("dtd_counting_termdet_3ranks", "dtd_chain_counting_termdet", 3, {},
     True, 150),
    ("datatype_column_eager_2ranks", "ptg_datatype_column", 2, {}, False,
     90),
    ("datatype_column_rendezvous_2ranks", "ptg_datatype_column", 2,
     dict(eager_limit=0), False, 90),
    ("remote_read_reshape_2ranks", "ptg_remote_read_reshape", 2, {}, True,
     90),
    ("remote_cast_2ranks", "ptg_remote_cast", 2, {}, True, 90),
    ("potrf_2ranks", "potrf_dist", 2, dict(N=64, nb=8), True, 180),
    ("potrf_4ranks", "potrf_dist", 4, dict(N=128, nb=16), True, 240),
    ("potrf_2ranks_rendezvous", "potrf_dist", 2, dict(N=512, nb=128), True,
     240),
    ("trtri_2ranks", "trtri_dist", 2, dict(N=64, nb=8), True, 180),
    ("unknown_comm_engine_falls_back_by_priority",
     "ptg_chain_bogus_engine", 2, {}, False, 90),
    ("stray_client_rejected_at_handshake", "ptg_chain_with_stray_client",
     2, {}, False, 90),
    ("jdf_remote_type_cast_2ranks", "jdf_remote_type_cast", 2, {}, True,
     90),
    ("gemm_dist_2ranks", "gemm_dist", 2, dict(N=64, nb=8), True, 180),
    ("gemm_dist_4ranks_topologies[chain]", "gemm_dist", 4,
     dict(N=64, nb=8, topo="chain"), True, 240),
    ("gemm_dist_4ranks_topologies[binomial]", "gemm_dist", 4,
     dict(N=64, nb=8, topo="binomial"), True, 240),
    ("gemm_dist_4ranks_rendezvous", "gemm_dist", 4,
     dict(N=64, nb=16, eager_limit=0), True, 300),
    ("getrf_dist_2ranks", "getrf_dist", 2, dict(N=64, nb=8), True, 180),
    ("getrf_dist_4ranks", "getrf_dist", 4, dict(N=64, nb=8), True, 240),
    ("trsm_dist_2ranks", "trsm_dist", 2, {}, True, 180),
    ("trsm_dist_4ranks", "trsm_dist", 4, {}, True, 240),
    ("geqrf_dist_2ranks", "geqrf_dist", 2, {}, True, 240),
    ("geqrf_dist_4ranks", "geqrf_dist", 4, {}, True, 300),
    ("jdf_ctlgat_2ranks", "jdf_ctlgat", 2, {}, False, 90),
    ("jdf_ctlgat_4ranks", "jdf_ctlgat", 4, {}, False, 90),
    ("potrf_panels_2ranks", "potrf_panels_dist", 2, dict(N=128, nb=16),
     True, 180),
    ("potrf_panels_4ranks", "potrf_panels_dist", 4, dict(N=192, nb=16),
     True, 240),
    ("potrf_panels_2ranks_rendezvous", "potrf_panels_dist", 2,
     dict(N=512, nb=64), True, 240),
    ("getrf_panels_2ranks", "getrf_panels_dist", 2, dict(N=128, nb=16),
     True, 180),
    # tests/comm/test_chunked.py
    ("chunked_rendezvous_chain_2ranks", "chunked_chain", 2, {}, True, 90),
    ("chunked_tiny_chunks_deep_window", "chunked_chain", 2,
     dict(nb=4, elems=1024, chunk=64, inflight=8), True, 90),
    ("chunked_three_ranks", "chunked_chain", 3, dict(nb=6), True, 90),
    ("chunked_single_chunk_window", "chunked_chain", 2,
     dict(nb=4, chunk=1024, inflight=1), True, 90),
    ("adaptive_eager_threshold", "adaptive_eager_chain", 2, {}, False, 90),
    ("chunked_bcast_star_shared_registration", "chunked_bcast", 3, {},
     True, 180),
    ("chunked_bcast_chain_relay", "chunked_bcast", 3, dict(topo="chain"),
     True, 180),
    ("chunked_bcast_binomial", "chunked_bcast", 4, dict(topo="binomial"),
     True, 180),
    # tests/comm/test_stream.py (the host-rendezvous cases)
    ("rails1_vs_rails2_bit_identical_host_chunks[1]", "chunked_chain", 2,
     dict(rails=1), True, 90),
    ("rails1_vs_rails2_bit_identical_host_chunks[2]", "chunked_chain", 2,
     dict(rails=2), True, 90),
    ("fault_soak_short_reads", "chunked_bcast", 3,
     dict(elems=2048, chunk=1024, fault_recv_max=7), True, 300),
    ("fault_soak_delay", "chunked_bcast", 3,
     dict(elems=8192, chunk=1024, fault_delay_us=200), True, 300),
]

# keyword arguments a one-rank run does not take: the wire's knobs (one
# rank sends nothing) and the fault injection
_NO_REF_KW = ("topo", "eager_limit", "rails", "fault_recv_max",
              "fault_delay_us")

# workers whose ranks each hold the broadcast payload plus their rank
_FANOUT = {"chunked_bcast": 1, "ptg_bcast_rendezvous_topo": 0,
           "ptg_bcast_rendezvous_dedup": 0}


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_spmd_case(case):
    _, worker, nodes, kw, held, timeout = case
    results = W.spmd(getattr(W, worker), nodes, timeout=timeout, **kw)
    if not held:
        return
    ref = W.reference(jpt, getattr(W, worker),
                      **{k: v for k, v in kw.items() if k not in _NO_REF_KW})
    if worker in _FANOUT:
        ref = {f"V{r}": ref["V0"] + _FANOUT[worker] * r
               for r in range(nodes)}
    W.hold(results, ref)


def test_rendezvous_reaped_on_peer_loss():
    W.spmd(W.rendezvous_reaped_on_peer_loss, 2)


def test_fence_errors_on_lost_peer():
    W.spmd(W.fence_lost_peer, 2, timeout=120.0)


def test_kill_a_puller_reaps_sessions():
    """Rank 2 dies mid chunked pull; the producer reaps its session
    (reap counter up, registered bytes back to zero).  The dying rank
    reports nothing; the survivors do."""
    W.spmd(W.stream_reap_on_death, 3, timeout=240.0, expect=2)


def test_clean_teardown_silent_4ranks(tmp_path):
    """A clean 4-rank job writes no runtime line to stderr (the
    comm-thread drain discipline, remote_dep_mpi.c:478-537)."""
    W.spmd(W.ptg_chain, 4, timeout=120.0, runner=W.run_capture_stderr,
           stderr_dir=str(tmp_path), nb=24)
    noise = {}
    for r in range(4):
        text = (tmp_path / f"rank{r}.stderr").read_text()
        lines = [ln for ln in text.splitlines() if ln.startswith("ptc")]
        if lines:
            noise[r] = lines
    assert not noise, noise


# ------------------------------------------------------ tracing, planning
def _merged(tmp_path, nodes=2, **kw):
    out = str(tmp_path)
    W.spmd(W.traced_chain, nodes, out_dir=out, **kw)
    traces = [Trace.load(os.path.join(out, f"r{r}.ptt"))
              for r in range(nodes)]
    return traces, Trace.merge(traces)


def test_2rank_trace_roundtrip_causal(tmp_path):
    """take_trace stamps comm_clock's offset; Trace.merge applies it, and
    every matched receive begins at or after its send.  The merged trace
    loads in the JAX package's Trace too (the file format is one)."""
    traces, m = _merged(tmp_path, nb=24)
    assert set(np.unique(m.ranks)) == {0, 1}
    assert "clock_offset_ns" in traces[1].meta
    assert m.meta["clock_offsets_ns"][1] == \
        traces[1].meta["clock_offset_ns"]
    ev = m.events
    sends = ev[(ev[:, 0] == KEY_COMM_SEND) & (ev[:, 1] == 0)
               & (ev[:, 4] > 0)]
    recvs = ev[(ev[:, 0] == KEY_COMM_RECV) & (ev[:, 1] == 0)
               & (ev[:, 4] > 0)]
    assert len(sends) > 0 and len(recvs) > 0
    fl = m.flows()
    assert len(fl) == len(recvs), (len(fl), len(recvs))
    assert len(fl) >= 20
    assert len({(int(r[0]), int(r[2])) for r in fl}) == len(fl)
    assert (fl[:, 6] >= 0).all(), fl[fl[:, 6] < 0]
    assert {(int(r[0]), int(r[1])) for r in fl} == {(0, 1), (1, 0)}
    wl = m.wire_latency()
    assert len(wl) == len(fl)
    assert (wl["latency_ns"] >= 0).all()
    # the reference's merge of the same files finds the same flows
    from parsec_tpu.profiling import Trace as JTrace
    jm = JTrace.merge([JTrace.load(os.path.join(str(tmp_path), f"r{r}.ptt"))
                       for r in range(2)])
    np.testing.assert_array_equal(jm.flows(), fl)


def test_2rank_rendezvous_flows_match(tmp_path):
    traces, m = _merged(tmp_path, nb=16, rendezvous=True)
    fl = m.flows()
    assert len(fl) >= 12
    assert (fl[:, 6] >= 0).all()


def test_merged_perfetto_has_flow_events(tmp_path):
    _, m = _merged(tmp_path, nb=12)
    doc = m.to_perfetto()
    phases = {e["ph"] for e in doc["traceEvents"]}
    assert "s" in phases and "f" in phases
    starts = [e for e in doc["traceEvents"] if e["ph"] == "s"]
    finishes = {e["id"] for e in doc["traceEvents"] if e["ph"] == "f"}
    assert starts and {e["id"] for e in starts} == finishes


def test_gemm_dist_comm_volume_bound_2ranks():
    """plan()'s wire bound on two ranks: the payload term exact, the
    bound at least the measured bytes; the product held against the
    reference's one-rank GEMM on the same inputs."""
    results = [r[0] for r in W.spmd(W.gemm_dist_plan, 2, timeout=240.0)]
    ref = W.reference(jpt, W.gemm_dist, N=256, nb=64)
    rng = np.random.default_rng(11)
    a = rng.normal(size=(256, 256)).astype(np.float32)
    b = rng.normal(size=(256, 256)).astype(np.float32)
    c0 = rng.normal(size=(256, 256)).astype(np.float32)
    got = W.merged(results)
    # gemm_dist's C starts at c0, the plan worker's at zero
    for (m, n), t in got.items():
        np.testing.assert_allclose(
            t + c0[m * 64:(m + 1) * 64, n * 64:(n + 1) * 64], ref[(m, n)],
            rtol=2e-3, atol=2e-3)
    assert len(got) == 16


def test_gemm_dist_plan_follows_the_engines_eager_limit():
    """With the engine's eager limit at 0 (every payload by rendezvous),
    each rank's plan row and wire bound equal the JAX package's run of
    the same program on two ranks, and the products agree at the
    reference's 2e-3: the plan reads the live engine's threshold, then
    the registry."""
    got = W.spmd(W.gemm_dist_plan, 2, timeout=240.0, eager_limit=0)
    ref = W.spmd(W.gemm_dist_plan, 2, timeout=240.0, eager_limit=0,
                 pkg="parsec_tpu")
    for (tiles, row, bound), (rtiles, rrow, rbound) in zip(got, ref):
        assert row == rrow and bound == rbound, (row, rrow)
        assert row["eager_bytes"] == 0 and row["rdv_bytes"] > 0, row
        assert tiles.keys() == rtiles.keys()
        for k, t in tiles.items():
            np.testing.assert_allclose(t, rtiles[k], rtol=2e-3, atol=2e-3)
