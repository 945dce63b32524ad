"""Cholesky with the matrix in host memory (the benchmark's cell
`spotrf.host`) on the CPU: each solve's matrix written into the host
tiles and declared rewritten (`Collection.host_wrote`), staged in by
the device module, factored, and written back by `CudaDevice.flush()`;
the flush's span and counters and the dispatch-time share of the bytes
staged in.

Every solve here is `build_potrf_panels` on `CudaDevice(ctx,
device="cpu")` at N 1024 in panels of 64, the cell's path at a small
size; the last tests run the cell itself through the harness
(`benchmark/harness/core.run_cell`) on a copy of `benchmark/`.
"""
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import parsec_tpu_torch as pt
from parsec_tpu_torch.algos import build_potrf_panels
from parsec_tpu_torch.data import TwoDimBlockCyclic
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.profiling import KEY_DEVICE_FLUSH, take_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
CELL = "spotrf.host"
N, NB = 1024, 64
TILE_BYTES = N * NB * 4
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)
# the cell's limit on l_offdiag_err: a float32 factor of this matrix reads
# ~8e-8 at N 1024, so 1e-5 leaves two orders of room for rounding, and a
# factor of another matrix (a stale mirror's) reads ~1
LIMIT = 1e-5


def _reference():
    sys.path[:0] = [BENCH]
    try:
        from harness import core
        return core.load_module(REPO, "reference", "spotrf_host")
    finally:
        sys.path.remove(BENCH)


REF = _reference()
TRAFFIC, CONFIG = {"N": N}, {"NB": NB}


def _matrix(seed) -> torch.Tensor:
    return REF.inputs(seed, TRAFFIC, CONFIG, "cpu")["A"]


def _error(coll, seed) -> float:
    """l_offdiag_err of the factor in the host tiles against the float64
    Cholesky factor (torch.linalg.cholesky) of the seed's matrix."""
    got = torch.from_numpy(coll.to_dense())
    return REF.check(seed, TRAFFIC, CONFIG, [{"A": got}], "cpu")[
        "l_offdiag_err"]


class HostCholesky:
    """The cell's loop at a small size: a panel collection in host
    memory, one device, solves of build_potrf_panels ended by flush()."""

    def __init__(self, ctx, dev):
        self.ctx, self.dev = ctx, dev
        self.A = TwoDimBlockCyclic(N, N, N, NB, dtype=np.float32)
        self.A.register(ctx, "A")

    def hand(self, seed, declare=True) -> None:
        """Write the seed's matrix into the host tiles (numpy, outside
        the runtime) and, with `declare`, declare them rewritten."""
        self.A.from_dense(_matrix(seed).numpy())
        if declare:
            self.A.host_wrote()

    def solve(self) -> dict:
        """One solve; the device's counters it moved."""
        s0 = dict(self.dev.stats)
        tp = build_potrf_panels(self.ctx, self.A, dev=self.dev)
        tp.run()
        tp.wait()
        self.dev.flush()
        tp.destroy()
        return {k: v - s0[k] for k, v in self.dev.stats.items()}


@pytest.fixture
def host():
    with pt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx, device="cpu")
        yield HostCholesky(ctx, dev), dev
        dev.stop()


def test_each_solve_factors_the_matrix_handed_to_it(host):
    """Three solves in a row, each on another seed's matrix handed
    through Collection.host_wrote: the factor each leaves in the host
    tiles is that matrix's (by the cell's limit); each solve stages
    every tile once (the 16 panels, nothing again: the cache evicts
    nothing) and writes every panel back; from the second solve on, the
    declaration drops the 16 mirrors the last solve left."""
    h, dev = host
    for i, seed in enumerate(SEEDS):
        inv0 = dev.stats["invalidations"]
        h.hand(seed)
        assert dev.stats["invalidations"] - inv0 == (0 if i == 0 else 16)
        d = h.solve()
        assert _error(h.A, seed) <= LIMIT, (i, seed)
        assert d["evictions"] == 0
        # the matrix, each tile once; beside it only the panel indices
        # and the epilogue's scalars (bytes, not a tile)
        assert N * N * 4 <= d["h2d_bytes"] < N * N * 4 + TILE_BYTES, d
        assert d["h2d_dispatch_bytes"] <= d["h2d_bytes"]
        assert d["flush_bytes"] == d["d2h_bytes"] == N * N * 4
        assert d["flush_ns"] > 0


def test_without_the_declaration_a_solve_reads_the_last_factor(host):
    """The hazard the declaration removes: a write into host tiles moves
    no copy version, so without host_wrote the second solve finds the
    first one's factor current on the device, factors it again, and its
    host tiles miss the second matrix; no mirror was dropped."""
    h, dev = host
    h.hand(SEEDS[0], declare=False)
    h.solve()
    assert _error(h.A, SEEDS[0]) <= LIMIT
    inv0 = dev.stats["invalidations"]
    h.hand(SEEDS[1], declare=False)
    d = h.solve()
    assert dev.stats["invalidations"] == inv0
    assert d["h2d_bytes"] < TILE_BYTES   # no panel staged from the host
    assert _error(h.A, SEEDS[1]) > 0.1


def test_host_wrote_before_register_and_on_no_device():
    """Nothing to drop before register() (no device can mirror the
    tiles) or on a context with no device."""
    a = TwoDimBlockCyclic(64, 64, 64, 16, dtype=np.float32)
    a.host_wrote()
    with pt.Context(nb_workers=1) as ctx:
        a.register(ctx, "A")
        a.data_of(0, 0)
        a.host_wrote()


def test_flush_spans_sum_to_flush_ns():
    """While a trace listens, each flush() is one DEVICE_FLUSH span on
    the device's queue (class -1) whose l0 is the bytes it wrote back:
    the spans' l0 add up to stats["flush_bytes"] and their durations, on
    the wall clock, to stats["flush_ns"]; a flush with nothing dirty is a
    span of 0 bytes."""
    with pt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx, device="cpu")
        h = HostCholesky(ctx, dev)
        ctx.profile_enable(1)
        s0 = dict(dev.stats)
        for seed in SEEDS[:2]:
            h.hand(seed)
            h.solve()
        dev.flush()
        st = dict(dev.stats)
        tr = take_trace(ctx)
        dev.stop()
    spans = [s for s in tr.to_wall().spans() if s[2] == KEY_DEVICE_FLUSH]
    assert [s[4] for s in spans] == [N * N * 4, N * N * 4, 0]
    assert {(s[3], s[5]) for s in spans} == {(-1, dev.qid)}
    want = st["flush_ns"] - s0["flush_ns"]
    got = sum(s[8] - s[7] for s in spans)
    assert abs(got - want) <= 50_000 * len(spans) + 0.005 * want, (got, want)
    assert st["flush_bytes"] - s0["flush_bytes"] == 2 * N * N * 4


@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["lane_off", "lane_on"])
def test_dispatch_bytes_are_a_part_of_the_bytes_staged(prefetch):
    """The bytes staged from the host at dispatch are a part of
    h2d_bytes; the rest are the prefetch lane's installed stages
    (prefetch_bytes; none with the lane off) and the panel indices
    staged at the build.  Each tile crosses once a solve either way."""
    with pt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx, device="cpu", prefetch=prefetch)
        h = HostCholesky(ctx, dev)
        for seed in SEEDS[:2]:
            h.hand(seed)
            d = h.solve()
            assert _error(h.A, seed) <= LIMIT
            assert N * N * 4 <= d["h2d_bytes"] < N * N * 4 + TILE_BYTES
            ahead = d["h2d_bytes"] - d["h2d_dispatch_bytes"]
            assert 0 <= ahead - d["prefetch_bytes"] < TILE_BYTES, d
            assert d["prefetch_wasted"] == 0
            if not prefetch:
                assert d["prefetch_bytes"] == 0
        dev.stop()


def test_a_tile_whose_stage_is_in_flight_crosses_once():
    """Both sides of a stage's claim, on a queued panel Cholesky (the
    device not started, so that nothing races the test): a lane sweep
    leaves panel 0 while another thread has its stage in flight (the
    manager's, for a task popped since the peek); and the manager,
    missing panel 0 while the lane's stage of it is in flight, waits for
    that stage and reads its mirror as a prefetch hit, moving no bytes
    of its own.  The solve then factors the matrix from that mirror."""
    from parsec_tpu_torch import _native as nat
    from parsec_tpu_torch.device.prefetch import _PrefetchLane
    with pt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx, device="cpu", autostart=False, prefetch=True)
        h = HostCholesky(ctx, dev)
        h.hand(SEEDS[0])
        tp = build_potrf_panels(ctx, h.A, dev=dev)
        tp.run()
        deadline = time.monotonic() + 30
        while ctx.device_queue_depth(dev.qid) < 1:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        cptr = nat.lib.ptc_data_host_copy(h.A.data_of(0, 0)._ptr)
        uid, ver = dev._copy_uid(cptr), nat.lib.ptc_copy_version(cptr)
        # the lane leaves a tile whose stage is claimed
        claim = dev._stage_claim(uid)
        b0 = dev.stats["h2d_bytes"]
        _PrefetchLane(dev)._sweep()
        assert dev.stats["h2d_bytes"] == b0
        assert dev.stats["prefetch_staged"] == 0
        dev._stage_release(uid, claim)

        # the manager waits for the lane's stage in flight
        claim = dev._stage_claim(uid)
        tile = h.A.tile(0, 0)

        def lane_stage():
            time.sleep(0.2)
            raw = torch.from_numpy(tile.reshape(-1).view(np.uint8))
            arr, ev = dev._h2d_async(raw)
            assert dev._cache_put_prefetch(uid, ver, arr, raw.numel(), ev,
                                           dev._host_epoch)
            dev._stage_release(uid, claim)
        t = threading.Thread(target=lane_stage)
        t0 = time.monotonic()
        t.start()
        got, mine = dev._stage_or_wait(uid, ver, np.float32, (N, NB))
        waited = time.monotonic() - t0
        t.join()
        assert mine is None and waited >= 0.15
        assert torch.equal(got, torch.from_numpy(tile))
        assert dev.stats["prefetch_hits"] == 1
        assert dev.stats["h2d_dispatch_bytes"] == 0
        dev.start()
        tp.wait()
        dev.flush()
        tp.destroy()
        assert _error(h.A, SEEDS[0]) <= LIMIT
        dev.stop()


# ------------------------------------------------------------ the cell
def small_root(tmp_path, n: int = N, nb: int = 128,
               deadline_s: float = 120.0) -> str:
    """A checkout-like root holding BENCHMARK.json and a copy of
    benchmark/ whose `spotrf.host` runs at N `n` in panels of `nb`, each
    step within `deadline_s`, with two workers and a small cache."""
    root = str(tmp_path / "root")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    path = os.path.join(root, "benchmark", "workloads", CELL + ".json")
    with open(path) as f:
        w = json.load(f)
    w["N"], w["deadline_s"] = n, deadline_s
    with open(path, "w") as f:
        json.dump(w, f)
    path = os.path.join(root, "benchmark", "configs", "spotrf_host.json")
    with open(path) as f:
        c = json.load(f)
    c["NB"] = nb
    c["user_settings"].update(nb_workers=2, cache_bytes=1 << 30)
    with open(path, "w") as f:
        json.dump(c, f)
    return root


def _run_cell(root, trace=False, declare=True, seconds=0.5):
    """One run of the cell in a process of its own (the harness refuses a
    process that holds JAX, as this one does): (exit code, its result
    line or None, its standard error)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [x for x in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if x]))
    argv = [sys.executable, os.path.abspath(__file__), root,
            str(2 ** 31 + 77), str(seconds), str(int(trace)),
            str(int(declare))]
    p = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    return p.returncode, json.loads(lines[-1]) if lines else None, p.stderr


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_the_cell_runs_and_is_correct(tmp_path, trace):
    """The cell through the harness: correct by its limit, judged on the
    factor read from the host tiles; untraced it reports its end-to-end
    metrics, traced its two per-layer metrics, read from the program's
    counters (no CUDA timeline on the host)."""
    rc, r, err = _run_cell(small_root(tmp_path), trace=trace)
    assert rc == 0 and r is not None, err[-3000:]
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    m = r["metrics"]
    if not trace:
        assert set(m) == {"setup_s", "gflops"}
        return
    assert set(m) == {"flush_ms", "stage_ahead_pct"}
    assert m["flush_ms"]["value"] > 0
    assert 0 <= m["stage_ahead_pct"]["value"] <= 100


def test_the_cell_without_the_declaration_is_not_correct(tmp_path):
    """With Collection.host_wrote doing nothing, every timed solve
    factors the last one's factor again: the run comes out not correct,
    by its limit."""
    rc, r, err = _run_cell(small_root(tmp_path), declare=False)
    assert rc == 0 and r is not None, err[-3000:]
    assert r["correct"] is False
    (check,) = r["checks"].values()
    assert check["value"] > check["limit"]


def test_a_step_past_its_deadline_ends_the_run(tmp_path):
    """A step that outlasts the workload's deadline (here 1 ms, so the
    first re-install does) ends the run at once: the driver's exit code,
    no result line."""
    t0 = time.monotonic()
    rc, r, err = _run_cell(small_root(tmp_path, deadline_s=0.001))
    assert rc == 3 and r is None, err[-3000:]
    assert "ran past its deadline" in err
    assert time.monotonic() - t0 < 120


# ------------------------------------------------------------ the runner
def _runner(argv) -> int:
    """The cell's run in this process (see _run_cell): argv = root,
    seed, seconds, trace, declare (0: Collection.host_wrote does
    nothing).  Prints the result line last."""
    root, seed, seconds = argv[0], int(argv[1]), float(argv[2])
    trace, declare = bool(int(argv[3])), bool(int(argv[4]))
    sys.path[:0] = [os.path.join(root, "benchmark"), root]
    from harness import core
    if not declare:
        TwoDimBlockCyclic.host_wrote = lambda self: None
    r = core.run_cell(core.Cell(root, CELL), seed, seconds, trace, "cpu",
                      time.perf_counter())
    sys.stdout.flush()
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(_runner(sys.argv[1:]))
