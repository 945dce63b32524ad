"""The comm rows of the port's observability, multi-rank: the live
sampler's comm/stream/topo rows on two ranks, the watchdog's
stalled_pull check, the two-rank serve scope round trip of
tests/serve/test_scope_dist.py, the SIGKILL postmortem of
tests/profiling/test_blackbox_dist.py read from the survivors' journals
(by the repo's tools/ptc_postmortem.py and the port's
parsec_tpu_torch.tools.ptc_postmortem, their reports equal), and the
fence-time metrics merge of tests/profiling/test_metrics.py.

Spawned ranks run tests/test_torch_comm_workers.py (numpy and the port
only).  Where a program runs in this process, both packages run it and
their results are held equal: the watchdog's check over the same counter
sequence, the metrics merge over the same two-rank chain.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import parsec_tpu as jpt
import parsec_tpu.profiling.metrics as jmetrics
import parsec_tpu_torch as tpt
import parsec_tpu_torch.profiling.metrics as tmetrics
import test_torch_comm_workers as W
from parsec_tpu_torch.comm.launch import free_port_base

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(REPO, "tests", "test_torch_comm_workers.py")
POSTMORTEM = os.path.join(REPO, "tools", "ptc_postmortem.py")


def test_live_rows_on_two_ranks():
    """Each rank's sample carries the comm, stream and topo rows, equal to
    the engine's counters read at that moment (asserted on the ranks),
    under the reference's keys."""
    res = W.spmd(W.live_rows, 2, timeout=90)
    rows = W.merged(res)
    keys = sorted(tpt.Context(nb_workers=1).comm_stats())
    for r in (0, 1):
        assert rows[r]["comm_keys"] == keys
        assert rows[r]["stream"] == ["overlap_fraction", "parked_gets",
                                     "sessions"]
        assert set(rows[r]["topo"]) == {"n_islands", "classes"}
        assert rows[r]["bytes"] == [True, True]
    assert sum(v[0] for v in rows[0]["topo"]["classes"].values()) > 0


class _FakeCtx:
    """The engine calls _check_stalled_pull reads, replayed from a list of
    (pending_pulls, chunks_recv, bytes_recv)."""

    def __init__(self, seq):
        self.seq = list(seq)
        self.cur = None
        self.comm_enabled = True
        self.myrank = 1
        self._monitors = []

    def step(self):
        self.cur = self.seq.pop(0)

    def comm_rdv_stats(self):
        return {"pending_pulls": self.cur[0]}

    def comm_tuning(self):
        return {"chunks_recv": self.cur[1]}

    def comm_stats(self):
        return {"bytes_recv": self.cur[2]}


def test_stalled_pull_check_matches_reference():
    """Both packages' Watchdog._check_stalled_pull over the same counter
    sequence: the same events (a pull pending across two ticks with no
    chunk and no byte in between; once per chunk count), the same
    fields."""
    seq = [(0, 0, 0), (1, 0, 0), (1, 0, 0), (1, 2, 100), (1, 2, 100),
           (1, 2, 100), (0, 3, 200), (2, 3, 200), (2, 3, 200)]
    out = []
    for mod in (jmetrics, tmetrics):
        fake = _FakeCtx(seq)
        wd = mod.Watchdog.__new__(mod.Watchdog)
        wd.ctx, wd.interval = fake, 0.25
        wd.events, wd._reported, wd._prev_pull = [], set(), None
        wd._dumps, wd.max_dumps = 0, 0
        for _ in seq:
            fake.step()
            wd._check_stalled_pull()
        out.append([{k: v for k, v in e.items() if k != "t"}
                    for e in wd.events])
    assert out[1] == out[0]
    assert [e["key"] for e in out[1]] == [0, 2, 3]
    assert set(out[1][0]) == {"type", "key", "pending_pulls",
                              "stalled_for_s", "live_requests", "rank",
                              "source"}


def test_stalled_pull_on_a_parked_pull():
    """A pull parked on a crawling receiver: the receiver's watchdog
    emits stalled_pull, and the pull still completes."""
    res = W.spmd(W.stalled_pull, 2, timeout=120)
    ev = res[1]["events"]
    assert ev and ev[0]["type"] == "stalled_pull"
    assert ev[0]["pending_pulls"] >= 1 and ev[0]["stalled_for_s"] == 0.05


def test_2rank_serve_scope_roundtrip(tmp_path):
    """Every admitted request's scope rides the wire: the merged trace
    shows its hops both ways, its stage partition sums to its latency,
    and conformance covers every pool (asserted on rank 0)."""
    res = W.spmd(W.scoped_serve, 2, timeout=120, out_dir=str(tmp_path))
    got = res[0]
    assert got["scopes"] is True
    for tenant in ("hi", "lo"):
        assert got[tenant]["flows"] >= 12
        assert "exec_ns" in got[tenant]["stages"]


def _wait_files(paths, timeout, procs):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(os.path.exists(p) for p in paths):
            return
        for p in procs:
            if p.poll() not in (None, 0, -signal.SIGKILL):
                raise AssertionError(f"worker died rc={p.returncode}:\n"
                                     f"{p.stderr.read()}")
        time.sleep(0.05)
    raise AssertionError(f"timeout waiting for {paths}")


def test_sigkill_postmortem_from_survivors_alone(tmp_path):
    """Three port ranks journal and replicate their checkpoints; one is
    SIGKILLed and its own artifacts deleted.  The survivors' journals
    alone let the postmortem name the dead rank, its live scope and its
    frozen page keys, and both survivors recorded the loss."""
    nodes, victim = 3, 2
    port = free_port_base(nodes)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, WORKERS, "blackbox_kill", str(r), str(nodes),
         str(port), str(tmp_path), str(victim)],
        env=env, cwd=REPO, stderr=subprocess.PIPE, text=True)
        for r in range(nodes)]
    try:
        _wait_files([os.path.join(tmp_path, f"ready.{r}")
                     for r in range(nodes)], 120, procs)
        procs[victim].kill()
        procs[victim].wait(timeout=30)
        for r in range(nodes):
            if r != victim:
                assert procs[r].wait(timeout=120) == 0, \
                    procs[r].stderr.read()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    removed = 0
    for name in os.listdir(tmp_path):
        if name.startswith((f"journal.{victim}.jsonl",
                            f"crash.{victim}.ptt")):
            os.remove(os.path.join(tmp_path, name))
            removed += 1
    assert removed >= 1
    reps = []
    for cmd in ([POSTMORTEM], ["-m", "parsec_tpu_torch.tools.ptc_postmortem"]):
        p = subprocess.run([sys.executable, *cmd, str(tmp_path), "--json"],
                           env=dict(env, JAX_PLATFORMS="cpu"), cwd=REPO,
                           timeout=120, capture_output=True, text=True)
        assert p.returncode == 0, p.stderr
        reps.append(json.loads(p.stdout))
    # the port's postmortem reads the port's journal as the reference does
    rep = reps[1]
    assert rep == reps[0]
    assert rep["schema"] == "ptc-postmortem-v1"
    assert rep["dead_ranks"] == [victim]
    assert rep["first_cause"]["rank"] == victim
    assert victim not in rep["ranks"]
    h = rep["holdings"][str(victim)]
    assert any(s["tenant"] == f"t{victim}" and s["rid"] == f"req-{victim}"
               and s["state"] in ("submitted", "running")
               for s in h["live_scopes"]), h["live_scopes"]
    assert set(h["frozen_keys"]) >= {f"page:{victim}:{i}" for i in range(3)}
    losers = {a["rank"] for a in rep["anomalies"]
              if a["type"] == "peer_loss"}
    assert losers == {r for r in range(nodes) if r != victim}


def _merge_run(pkg, nb=12):
    """tests/profiling/test_metrics.py's fence-time merge on `pkg`: two
    ranks as threads over a rank-hopping chain; rank 0's local and merged
    EXEC counts and its per-peer RTTs after the fences."""
    MET_EXEC = 0
    port = free_port_base(2)
    results, errs = {}, []

    def rank_prog(rank):
        try:
            ctx = pkg.Context(nb_workers=1, scheduler="lws")
            ctx.set_rank(rank, 2)
            ctx.comm_init(port)
            with ctx:
                arr = np.zeros((2, 1), dtype=np.int64)
                ctx.register_linear_collection("A", arr, elem_size=8,
                                               nodes=2, myrank=rank)
                ctx.register_arena("t", 8)
                tp = pkg.Taskpool(ctx, globals={"NB": nb})
                k = pkg.L("k")
                tc = tp.task_class("XRank")
                tc.param("k", 0, pkg.G("NB"))
                tc.affinity("A", k % 2)
                tc.flow("A", "RW",
                        pkg.In(pkg.Mem("A", 0), guard=(k == 0)),
                        pkg.In(pkg.Ref("XRank", k - 1, flow="A")),
                        pkg.Out(pkg.Ref("XRank", k + 1, flow="A"),
                                guard=(k < pkg.G("NB"))), arena="t")

                def body(view):
                    time.sleep(0.001)
                    view.data("A", dtype=np.int64)[0] += 1
                tc.body(body)
                tp.run()
                tp.wait()
                ctx.comm_fence()
                if rank == 0:
                    results["local"] = {h.name: h.count for h in
                                        ctx.metrics_histograms()
                                        if h.kind == MET_EXEC}.get("XRank")
                time.sleep(0.3)
                ctx.comm_fence()
                if rank == 0:
                    results["merged"] = {
                        h.name: h.count
                        for h in ctx.metrics_histograms(merged=True)
                        if h.kind == MET_EXEC}.get("XRank")
                    results["rtts"] = ctx.metrics_peer_rtts()
                ctx.comm_fence()
                ctx.comm_fini()
        except Exception as e:  # pragma: no cover
            errs.append((rank, repr(e)))

    ts = [threading.Thread(target=rank_prog, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=240)
    assert not [t for t in ts if t.is_alive()], "deadlocked ranks"
    assert not errs, errs
    return results


def test_fence_merges_metrics_rank_wide_like_reference():
    """After a fence, rank 0's merged snapshot folds both ranks' EXEC
    histograms (the comm_init'd metrics path): the same local and merged
    counts on both packages, and a measured RTT to the peer."""
    ref, port = _merge_run(jpt), _merge_run(tpt)
    assert port["merged"] == ref["merged"] == 13
    assert port["local"] == ref["local"] and 0 < port["local"] < 13
    assert len(port["rtts"]) == 2 and port["rtts"][1] > 0
