"""The port's runtime-native collectives (comm/coll.py), the k-split GEMM
panel reduction (algos/gemm.py gemm_panel_reduce) and comm/ici.py against
the JAX package's: the non-slow cases of tests/comm/test_coll.py and the
cases of tests/comm/test_ici.py, ici's over a list of CPU devices.

A multi-rank case runs the port's worker on its spawned ranks, which hold
the reference worker's assertions (numpy's rank-order sums, bit for bit,
on integer-valued float32 data), and then the same worker driving the
JAX package on as many ranks: each rank's results are held bit for bit
against the JAX package's rank of the same number.
"""
import os

import numpy as np
import pytest
import torch

import parsec_tpu as jpt
import parsec_tpu_torch as tpt
import test_torch_comm_workers as W
from parsec_tpu_torch.comm import coll
from parsec_tpu_torch.comm.ici import PermuteEngine, device_transfer


def _held(worker, nodes, timeout=90.0, **kw):
    """Run `worker` on the port and on the JAX package, `nodes` ranks
    each, and hold every rank's results bit for bit."""
    got = W.spmd(worker, nodes, timeout=timeout, **kw)
    ref = W.spmd(worker, nodes, timeout=timeout, pkg="parsec_tpu", **kw)
    assert len(got) == len(ref) == nodes
    for r, (g, f) in enumerate(zip(got, ref)):
        assert set(g) == set(f), (r, set(g), set(f))
        for k in f:
            np.testing.assert_array_equal(g[k], f[k], err_msg=f"{r} {k}")
    return got


@pytest.mark.parametrize("nodes", [2, 4])
def test_coll_primitives(nodes):
    _held(W.coll_primitives, nodes)


@pytest.mark.parametrize("topo", ["ring", "binomial", "star"])
def test_coll_topology_override(topo):
    """Every topology the override accepts gives the same bits."""
    _held(W.coll_primitives, 3, topo=topo)


def test_coll_stream_off_bit_exact():
    """comm.stream=0 reproduces the streamed collective's results bit for
    bit (rendezvous forced, several slices)."""
    on = W.spmd(W.coll_primitives, 2, eager_limit=0, slice_bytes=2048,
                elems=8192)
    off = _held(W.coll_primitives, 2, stream=0, eager_limit=0,
                slice_bytes=2048, elems=8192)
    for a, b in zip(on, off):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k


def test_coll_rendezvous_sliced():
    _held(W.coll_primitives, 2, eager_limit=0, slice_bytes=2048,
          elems=8192)


@pytest.mark.slow
def test_coll_fault_soak_4rank():
    """4-rank streamed all-reduce under comm fault injection."""
    got = W.spmd(W.coll_allreduce_stream_soak, 4, timeout=240.0)
    alls = [np.random.default_rng(7 + r).integers(-9, 9, size=65536)
            .astype(np.float32) for r in range(4)]
    total = np.sum(np.stack(alls), axis=0, dtype=np.float32)
    for g in got:
        np.testing.assert_array_equal(g["all_reduce"], total)


def test_coll_faults_small():
    """Two ranks, short reads and a per-receive delay."""
    _held(W.coll_primitives, 2, faults=True, elems=2048, timeout=180.0)


def test_coll_stats_schema():
    """The `coll` namespace of stats(): present and zeroed on one rank,
    the reference's keys and values."""
    out = []
    for pkg in (jpt, tpt):
        ctx = pkg.Context(nb_workers=1)
        try:
            out.append(ctx.stats()["coll"])
        finally:
            ctx.destroy()
    assert out[1] == out[0]
    assert out[1]["steps"] == 0 and out[1]["ops"] == 0


def test_coll_single_rank_local_fallback():
    """One rank (or comm off): each primitive is its local semantics, as
    in the reference, and builds no taskpool."""
    x = np.arange(10, dtype=np.float32)
    for pkg, mod in ((tpt, coll), (jpt, None)):
        if mod is None:
            from parsec_tpu.comm import coll as mod
        ctx = pkg.Context(nb_workers=1)
        try:
            for fn in (mod.all_reduce, mod.reduce_scatter, mod.all_gather,
                       mod.broadcast):
                np.testing.assert_array_equal(fn(ctx, x), x)
            assert ctx.coll_stats()["ops"] == 0
        finally:
            ctx.destroy()


def test_topology_selector_economics():
    """The economics selector as the reference's test states it, and the
    same choice as the JAX package's on a grid of sizes and ranks."""
    from parsec_tpu.comm.economics import TransferEconomics as JE
    from parsec_tpu_torch.comm.economics import TransferEconomics as TE

    fit = {"rdv": {"fixed_overhead_us": 100.0, "per_byte_ns": 1.0}}
    econ, jecon = TE(fit, source="synthetic"), JE(fit, source="synthetic")
    assert econ.choose_topology("reduce", 256, 8) == "star"
    assert econ.choose_topology("fanout", 256, 8) == "star"
    assert econ.choose_topology("reduce", 64 << 20, 8) == "binomial"
    assert econ.choose_topology("fanout", 64 << 20, 8) == "ring"
    assert econ.choose_topology("reduce", 64 << 20, 8,
                                override="star") == "star"
    with pytest.raises(ValueError):
        econ.choose_topology("reduce", 1, 4, override="hypercube")
    for kind in ("reduce", "fanout"):
        for nbytes in (64, 4096, 1 << 20, 64 << 20):
            for ranks in (2, 3, 4, 8, 16):
                assert econ.choose_topology(kind, nbytes, ranks) == \
                    jecon.choose_topology(kind, nbytes, ranks)


def test_gemm_panel_reduce_2rank():
    """The k-split GEMM panel reduction, DAG-chain baseline and
    runtime-native collective, bit for bit against numpy (the worker)
    and against the JAX package's two ranks."""
    _held(W.gemm_panel_reduce_modes, 2)


@pytest.mark.slow
def test_gemm_panel_reduce_4rank():
    _held(W.gemm_panel_reduce_modes, 4, timeout=240.0)


def test_gemm_panel_reduce_single_rank_matches_reference():
    rng = np.random.default_rng(3)
    a = rng.integers(-4, 4, size=(48, 32)).astype(np.float32)
    b = rng.integers(-4, 4, size=(32, 40)).astype(np.float32)
    from parsec_tpu.algos.gemm import gemm_panel_reduce as jgpr
    from parsec_tpu_torch.algos.gemm import gemm_panel_reduce as tgpr
    for pkg, fn in ((jpt, jgpr), (tpt, tgpr)):
        ctx = pkg.Context(nb_workers=1)
        try:
            out = fn(ctx, a, b, reduce="coll")
        finally:
            ctx.destroy()
        np.testing.assert_array_equal(out, a @ b)


def test_coll_wait_lost_time_2rank(tmp_path):
    """The coll_wait lost-time category: a 2-rank panel reduction traced
    at level 2 and merged.  The collective mode's trace carries
    COLL_RECV instants and a nonzero coll_wait; the chain baseline none.
    The reference's lost_time reads the port's files to the same
    totals."""
    from parsec_tpu.profiling import Trace as JTrace
    from parsec_tpu.profiling import lost_time as jlost_time
    from parsec_tpu_torch.profiling import KEY_COLL, Trace, lost_time

    out = str(tmp_path)
    W.spmd(W.gemm_panel_reduce_modes, 2, trace_dir=out)
    for mode, expect_coll in (("chain", False), ("coll", True)):
        paths = [os.path.join(out, f"{mode}_r{r}.ptt") for r in range(2)]
        m = Trace.merge([Trace.load(p) for p in paths])
        ev = m.events
        n_coll = int(((ev[:, 0] == KEY_COLL) & (ev[:, 1] == 0)).sum())
        lt = lost_time(m)
        assert "coll_wait" in lt["totals"]
        for b in lt["workers"].values():
            assert set(b) >= {"compute", "release", "h2d_stall",
                              "comm_wait", "coll_wait", "idle"}
        if expect_coll:
            assert n_coll > 0, "no COLL_RECV instants in coll mode"
            assert lt["totals"]["coll_wait"] > 0, lt["totals"]
        else:
            assert n_coll == 0
            assert lt["totals"]["coll_wait"] == 0, lt["totals"]
        jm = JTrace.merge([JTrace.load(p) for p in paths])
        assert jlost_time(jm)["totals"] == lt["totals"]


# --------------------------------------------------------------- comm.ici
_DEVS = [torch.device("cpu")] * 8


def _gather(shards):
    return torch.cat(list(shards)).numpy()


def test_device_transfer_no_alias():
    """device_transfer is a copy, never an alias: a later write of the
    source does not reach it."""
    x = torch.arange(16, dtype=torch.float32)
    y = device_transfer(x, torch.device("cpu"))
    assert y.device == torch.device("cpu")
    x += 100
    np.testing.assert_array_equal(y.numpy(), np.arange(16))


def test_permute_engine_ring():
    eng = PermuteEngine(_DEVS)
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    y = eng.permute(eng.shard(x), 1)
    # device i's shard came from device i-1: row block rotates down by 1
    np.testing.assert_array_equal(_gather(y), np.roll(x, 1, axis=0))


def test_permute_engine_exchange_and_cache():
    eng = PermuteEngine(_DEVS)
    x = np.arange(8 * 2, dtype=np.float32).reshape(8, 2)
    xs = eng.shard(x)
    prev, nxt = eng.exchange(xs)
    np.testing.assert_array_equal(_gather(prev), np.roll(x, 1, axis=0))
    np.testing.assert_array_equal(_gather(nxt), np.roll(x, -1, axis=0))
    # the reference reuses a cached program per shift; the port computes
    # the index map inline: a second exchange gives the same shards,
    # copies that leave the inputs untouched
    prev2, nxt2 = eng.exchange(xs)
    for a, b in zip(prev + nxt, prev2 + nxt2):
        assert a is not b
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(_gather(xs), x)


def test_permute_multiple_shifts():
    eng = PermuteEngine(_DEVS)
    x = np.arange(8, dtype=np.int32).reshape(8, 1)
    xs = eng.shard(x)
    for shift in (2, 3, 7):
        y = eng.permute(xs, shift)
        np.testing.assert_array_equal(_gather(y), np.roll(x, shift, 0))
