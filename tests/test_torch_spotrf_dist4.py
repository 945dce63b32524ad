"""The benchmark's four-rank Cholesky cell (`spotrf.dist4`) on the CPU,
and the device data plane's spans and comm counters it reads.

The cell runs through the harness (`benchmark/harness/core.run_cell`)
on a copy of `benchmark/` at a small size, in a process of its own (the
driver's watchdog ends its process), with `CudaDevice(ctx,
device="cpu")` on every rank: rank 0 in that process, ranks 1-3 started
by the driver (`benchmark/drivers/potrf_dist4.py`).  The span test runs
two spawned ranks through `test_torch_comm_workers.spmd`.
"""
import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import test_torch_comm_workers as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
CELL = "spotrf.dist4"
SEED = 2 ** 31 + 77


# ------------------------------------------------------------ the DAG
def tiles_to_rank(nt: int, p: int, q: int, rank: int,
                  by_flow: bool = True) -> int:
    """The tiles `algos.build_potrf` (TRSM by the inverse) sends to
    `rank` in one solve of an nt x nt tiled matrix over a p x q grid.
    The values that cross ranks: POTRF(k)'s inverse of L(k, k), read by
    TRSM(k, m) at (m, k), m > k, through TRSM's flow L (0); and TRSM(k,
    m)'s L(m, k), read by SYRK(k, m) at (m, m) and GEMM(k, m, n) at (m,
    n), k < n < m, through their flow A (0), and by GEMM(k, i, m) at (i,
    m), i > m, through GEMM's flow B (1).  The runtime sends a value once
    to each rank for each consumer flow index it is read through there
    (its remote sends batch by rank, flow index and copy): `by_flow`.
    Without it: once to each rank that reads it."""
    def owner(m, n):
        return (m % p) * q + (n % q)

    def sends(owner_rank, readers):
        if owner_rank == rank:
            return 0
        flows = {f for r, f in readers if r == rank}
        return len(flows) if by_flow else min(len(flows), 1)
    tiles = 0
    for k in range(nt):
        tiles += sends(owner(k, k), {(owner(m, k), 0)
                                     for m in range(k + 1, nt)})
        for m in range(k + 1, nt):
            readers = {(owner(m, n), 0) for n in range(k + 1, m + 1)}
            readers |= {(owner(i, m), 1) for i in range(m + 1, nt)}
            tiles += sends(owner(m, k), readers)
    return tiles


@pytest.mark.parametrize("nt,once,dup,once3,dup3",
                         [(32, 120, 105, 136, 120), (64, 496, 465, 528, 496)],
                         ids=["n16384", "n32768"])
def test_the_dag_count_at_the_cells_size(nt, once, dup, once3, dup3):
    """At NB 512 over 2 x 2 (the cell's N 16384: nt 32; N 32768: nt 64):
    rank 0 reads the L(m, k) of even m and odd k alone, 1 + 2 + ... +
    (nt/2 - 1) tiles, and those of m < nt - 2 both through flow A and
    through flow B (`dup` more frames); rank 3 the L(m, k) of odd m and
    even k; the off-diagonal ranks read no value through both flows."""
    assert tiles_to_rank(nt, 2, 2, 0, by_flow=False) == once
    assert tiles_to_rank(nt, 2, 2, 0) == once + dup
    assert tiles_to_rank(nt, 2, 2, 3, by_flow=False) == once3
    assert tiles_to_rank(nt, 2, 2, 3) == once3 + dup3
    for r in (1, 2):
        assert tiles_to_rank(nt, 2, 2, r) == \
            tiles_to_rank(nt, 2, 2, r, by_flow=False)


# ------------------------------------------------------------ the cell
def small_root(tmp_path, n: int, nb: int, p: int = 2, q: int = 2) -> str:
    """A checkout-like root holding BENCHMARK.json and a copy of
    benchmark/ whose `spotrf.dist4` runs at N `n` in NB `nb` tiles over a
    p x q grid, with two workers a rank and a small cache."""
    root = str(tmp_path / "root")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    path = os.path.join(root, "benchmark", "workloads", CELL + ".json")
    with open(path) as f:
        w = json.load(f)
    w["N"] = n
    with open(path, "w") as f:
        json.dump(w, f)
    path = os.path.join(root, "benchmark", "configs", "spotrf_dist.json")
    with open(path) as f:
        c = json.load(f)
    c.update(NB=nb, P=p, Q=q)
    c["user_settings"].update(nb_workers=2, cache_bytes=1 << 30)
    with open(path, "w") as f:
        json.dump(c, f)
    return root


def run_cell(root, trace=False, seconds=1.0, perturb=False, kill=0,
             timeout=240):
    """One run of the cell in a process of its own: (exit code, its
    result line or None, its standard error, the time the kill was sent
    or None, the time the process ended)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [x for x in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if x]))
    argv = [sys.executable, os.path.abspath(__file__), root, str(SEED),
            str(seconds), str(int(trace)), str(int(perturb)), str(kill)]
    p = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=timeout)
    ended = time.time()
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    killed = [float(ln.split()[-1]) for ln in p.stderr.splitlines()
              if ln.startswith("killed rank")]
    return (p.returncode, json.loads(lines[-1]) if lines else None,
            p.stderr, killed[0] if killed else None, ended)


@pytest.mark.parametrize("n,nb,trace", [(256, 32, False),
                                        (2048, 256, True)],
                         ids=["n256_nb32", "n2048_nb256_traced"])
def test_four_cpu_ranks_are_correct(tmp_path, n, nb, trace):
    """Four ranks on the 2 x 2 grid come out correct against the
    reference; a traced run reports what rank 0's comm engine received,
    within 10% of the DAG's count, and the time its data plane served
    tiles (of 256 KiB: above the eager limit, so pulled from the device)."""
    rc, r, err, _, _ = run_cell(small_root(tmp_path, n, nb), trace=trace)
    assert rc == 0 and r is not None, err[-3000:]
    assert r["correct"] is True and r["failed"] == 0, err[-3000:]
    assert r["attempted"] >= 1 and r["device"]["count"] == 4
    m = r["metrics"]
    if not trace:
        assert set(m) == {"setup_s", "gflops"}
        return
    # no card: no peak, so no grid_mfu_pct
    assert set(m) == {"comm_mb_per_solve", "dp_serve_ms"}
    want = tiles_to_rank(n // nb, 2, 2, 0) * nb * nb * 4 / 1e6
    assert abs(m["comm_mb_per_solve"]["value"] - want) <= 0.1 * want, \
        (m, want)
    assert m["dp_serve_ms"]["value"] > 0


def test_a_perturbed_gemm_on_one_rank_is_not_correct(tmp_path):
    """Rank 0's GEMM chore alters one entry of each answer: the gathered
    factor comes out not correct, by its limit."""
    rc, r, err, _, _ = run_cell(small_root(tmp_path, 256, 32), perturb=True)
    assert rc == 0 and r is not None, err[-3000:]
    assert r["correct"] is False
    (check,) = r["checks"].values()
    assert check["value"] > check["limit"]


def test_a_killed_rank_ends_the_run(tmp_path):
    """Rank 2 killed in the window: the run ends with the watchdog's exit
    code, no result line, well inside the watchdog's 60 s, and no rank
    process is left."""
    rc, r, err, killed, ended = run_cell(small_root(tmp_path, 256, 32),
                                         seconds=30.0, kill=3)
    assert killed is not None, err[-3000:]
    assert rc == 3 and r is None, err[-3000:]
    assert ended - killed < 60.0
    assert "rank 2 exited" in err
    script = os.path.join(str(tmp_path), "root", "benchmark", "drivers",
                          "potrf_dist4.py")
    left = subprocess.run(["pgrep", "-f", script], capture_output=True,
                          text=True).stdout.split()
    assert not left, left


@pytest.mark.parametrize("finishing", [False, True],
                         ids=["in_the_window", "in_the_finish"])
def test_the_watchdog_and_a_ranks_exit(finishing):
    """A rank that exits in the window ends the run; one that exits in
    the finish (it replied to `fini`, then left) is no death, and the
    watchdog still keeps the finish's deadline."""
    import threading
    sys.path[:0] = [BENCH]
    try:
        from harness import core
        mod = core.load_module(REPO, "drivers", "potrf_dist4")
    finally:
        sys.path.remove(BENCH)

    class Exited:
        returncode = 0

        def poll(self):
            return 0
    fatal = []
    d = object.__new__(mod.Driver)
    d.procs, d._armed = [(1, Exited())], None
    d._closing, d._finishing = False, finishing

    def end(why):
        fatal.append(why)
        d._closing = True
    d._fatal = end
    t = threading.Thread(target=d._watch, daemon=True)
    t.start()
    time.sleep(3 * mod._POLL_S)
    if not finishing:
        t.join(timeout=5)
        assert fatal == ["rank 1 exited with code 0"]
        return
    assert fatal == []
    d._arm("the finish", 0.0)
    t.join(timeout=5)
    assert fatal == ["the finish ran past its deadline"]


def test_the_reference_factor_is_choleskys():
    """The reference's float64 factor is torch.linalg.cholesky's in
    float64 at N 512, the grid's reference is spotrf's, and its check
    passes the float32 factor of the same matrix by its limit."""
    sys.path[:0] = [BENCH]
    try:
        from harness import core
        ref = core.load_module(REPO, "reference", "spotrf_dist")
        one = core.load_module(REPO, "reference", "spotrf")
    finally:
        sys.path.remove(BENCH)
    traffic, config = {"N": 512}, {"NB": 64}
    got = ref._factor64(5, traffic, config, "cpu")
    a = ref.plghe(5, 512, 64, "cpu")
    assert torch.equal(a, one.plghe(5, 512, 64, "cpu"))
    assert got.dtype == torch.float64
    assert torch.equal(got, torch.linalg.cholesky(a.double()))
    assert ref.flops(traffic, config) == one.flops(traffic, config)
    low = torch.linalg.cholesky(a)
    err = ref.check(5, traffic, config, [{"A": low}], "cpu")
    assert 0 < err["l_offdiag_err"] < 1e-5


# ------------------------------------------------- the data plane's spans
def span_worker(rank, nodes, port, n=1024, nb=256):
    """Tiled potrf on two ranks (1 x 2), a CPU device each made before
    the comm engine: the data plane's span sums and counters, the comm
    counters in info() and ctx.comm_stats(), read once the engine is
    still."""
    import parsec_tpu_torch as pt
    import parsec_tpu_torch.profiling as tprof
    from parsec_tpu_torch.algos import build_potrf
    from parsec_tpu_torch.data import TwoDimBlockCyclic
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.profiling import (KEY_DEVICE_DP_RECV,
                                            KEY_DEVICE_DP_SERVE)
    rng = np.random.default_rng(7)
    b = rng.standard_normal((n, n))
    full = (b @ b.T + n * np.eye(n)).astype(np.float32)
    ctx = pt.Context(nb_workers=2)
    dev = CudaDevice(ctx, device="cpu")
    ctx.set_rank(rank, nodes)
    ctx.comm_init(port)
    a = TwoDimBlockCyclic(n, n, nb, nb, P=1, Q=nodes, nodes=nodes,
                          myrank=rank, dtype=np.float32)
    a.register(ctx, "A")
    a.from_dense(full)
    gc.collect()
    gc.disable()
    try:
        ctx.profile_enable(1)
        s0 = dev.info()["stats"]
        tp = build_potrf(ctx, a, dev=dev)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        while True:
            c0 = ctx.comm_stats()
            st = dev.info()["stats"]
            rdv = ctx.comm_rdv_stats()
            if ctx.comm_stats() == c0:
                break
            time.sleep(0.05)
        tr = tprof.take_trace(ctx)
    finally:
        gc.enable()
    sums, counts = {}, {}
    for s in tr.to_wall().spans():
        sums[s[2]] = sums.get(s[2], 0) + s[8] - s[7]
        counts[s[2]] = counts.get(s[2], 0) + 1
    out = {"comm": c0, "rdv_gets": rdv["gets_sent"],
           "stats": {k: v for k, v in st.items()
                     if k.startswith(("comm_", "dp_"))},
           "delta": {k: st[k] - s0[k] for k in ("dp_serve_ns", "dp_recv_ns",
                                                  "dp_serve_bytes",
                                                  "dp_recv_bytes")},
           "sums": {"serve": sums.get(KEY_DEVICE_DP_SERVE, 0),
                    "recv": sums.get(KEY_DEVICE_DP_RECV, 0)},
           "counts": {"serve": counts.get(KEY_DEVICE_DP_SERVE, 0),
                      "recv": counts.get(KEY_DEVICE_DP_RECV, 0)}}
    tp.destroy()
    dev.stop()
    ctx.comm_fini()
    ctx.destroy()
    return out


def test_data_plane_spans_equal_their_counters():
    """On two ranks whose tiles (256 KiB) ride the data plane: the
    DEVICE_DP_SERVE and DEVICE_DP_RECV spans' sums equal dp_serve_ns and
    dp_recv_ns (a native call's time a span), one span a pull served and
    a payload landed; the comm_* stats equal ctx.comm_stats()."""
    for rank, out in enumerate(W.spmd(span_worker, 2, timeout=120)):
        st, d = out["stats"], out["delta"]
        assert st["dp_errors"] == 0
        assert d["dp_serve_bytes"] > 0 and d["dp_recv_bytes"] > 0, out
        for k in ("serve", "recv"):
            got, want = out["sums"][k], d[f"dp_{k}_ns"]
            assert out["counts"][k] >= 1, out
            assert abs(got - want) <= 50_000 * out["counts"][k] \
                + 0.005 * want, (rank, k, got, want)
        c = out["comm"]
        assert (st["comm_msgs_sent"], st["comm_msgs_recv"],
                st["comm_bytes_sent"], st["comm_bytes_recv"]) == \
            (c["msgs_sent"], c["msgs_recv"], c["bytes_sent"],
             c["bytes_recv"]), out
        assert st["comm_rdv_gets"] == out["rdv_gets"] > 0
        assert c["bytes_recv"] >= d["dp_recv_bytes"]


def test_comm_counters_before_the_engine_and_after_it():
    """A device's comm_* stats read 0 before comm_init (one rank: no
    engine), and keep their last reading once the context is gone."""
    import parsec_tpu_torch as pt
    from parsec_tpu_torch.device import CudaDevice
    with pt.Context(nb_workers=1) as ctx:
        dev = CudaDevice(ctx, device="cpu")
        st = dev.info()["stats"]
        dev.stop()
    keys = ("comm_msgs_sent", "comm_msgs_recv", "comm_bytes_sent",
            "comm_bytes_recv", "comm_rdv_gets")
    assert all(st[k] == 0 for k in keys)
    after = dev.info()["stats"]
    assert all(after[k] == 0 for k in keys)


@pytest.mark.cuda
def test_a_delivery_pins_with_its_cards_context():
    """A payload landed from a thread whose current card is the first
    (the data plane's comm thread) for a device on the second card is
    pinned with the device's card current, and lands on that card."""
    import threading
    import parsec_tpu_torch as pt
    from parsec_tpu_torch.device import CudaDevice
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    src = torch.arange(4096, dtype=torch.float32)
    seen, out = [], []
    with pt.Context(nb_workers=1) as ctx:
        dev = CudaDevice(ctx, device="cuda:1")
        pinned = dev._pinned

        def spy(shape, dtype):
            seen.append(torch.cuda.current_device())
            return pinned(shape, dtype)
        dev._pinned = spy
        t = threading.Thread(target=lambda: out.append(dev._h2d_async(src)))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        got, ev = out[0]
        ev.synchronize()
        dev.stop()
    assert seen == [1]
    assert got.device == torch.device("cuda", 1)
    assert torch.equal(got.cpu(), src)


# ------------------------------------------------------------ the runner
def _runner(argv) -> int:
    """The cell's run in this process (see run_cell): argv = root, seed,
    seconds, trace, perturb (rank 0's GEMM alters an entry of each
    answer), kill (rank 2 killed before that solve of the window, 0:
    none).  Prints the result line last."""
    import signal
    root, seed, seconds = argv[0], int(argv[1]), float(argv[2])
    trace, perturb, kill = bool(int(argv[3])), bool(int(argv[4])), \
        int(argv[5])
    sys.path[:0] = [os.path.join(root, "benchmark"), root]
    from harness import core
    import parsec_tpu_torch.algos.potrf as potrf_mod
    if perturb:
        gemm = potrf_mod.k_gemm

        def altered(*args):
            out = gemm(*args).clone()
            (out[0] if out.dim() == 3 else out)[-1, 0] += 1.0
            return out
        potrf_mod.k_gemm = altered
    if kill:
        load = core.load_module

        def load_module(root_, kind, name):
            mod = load(root_, kind, name)
            if kind == "drivers":
                solve, calls = mod.Driver.solve, [0]

                def counted(self):
                    calls[0] += 1
                    if calls[0] == kill + 1:     # the untimed solve first
                        pid = dict(self.procs)[2].pid
                        os.kill(pid, signal.SIGKILL)
                        sys.stderr.write(f"killed rank 2 at {time.time()}\n")
                        sys.stderr.flush()
                    return solve(self)
                mod.Driver.solve = counted
            return mod
        core.load_module = load_module
    r = core.run_cell(core.Cell(root, CELL), seed, seconds, trace, "cpu",
                      time.perf_counter())
    sys.stdout.flush()
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(_runner(sys.argv[1:]))
