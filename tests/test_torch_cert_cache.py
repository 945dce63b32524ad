"""The wave compiler's certificate cache (device/fuse.py): a pool whose
structure matches one already certified on the device takes its
consumed chain certificates from the cache instead of running
analysis.plan.chain_certificates again.

Held on the CPU (CudaDevice(ctx, device="cpu")): for each rank of a
2 x 2 grid at NT 8, the second pool's cached state equals a fresh pass
over it; each part of the structure the certificates read, changed,
misses; a pool the key cannot render runs the pass uncached, counted by
reason; the counters and the DEVICE_CERT spans count as documented; and
two solves through one device give the same tiles and the same chains
whether the second pool hits or the cache was cleared before it."""
import threading
import time

import numpy as np
import pytest
import torch

import parsec_tpu_torch as pt
from parsec_tpu_torch.algos import build_potrf
from parsec_tpu_torch.algos.gemm import build_gemm
from parsec_tpu_torch.analysis.plan import chain_certificates
from parsec_tpu_torch.data import HashDatadist, TwoDimBlockCyclic
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.profiling.trace import KEY_DEVICE_CERT, take_trace

NT, NB = 8, 8
RANKS = range(4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs its files in
    parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(rank):
    """A rank of a 2 x 2 grid, its matrix registered as "A", and an
    unstarted device: pools are built and certified, never run."""
    ctx = pt.Context(nb_workers=1)
    ctx.set_rank(rank, 4)
    A = TwoDimBlockCyclic(NT * NB, NT * NB, NB, NB, P=2, Q=2, nodes=4,
                          myrank=rank)
    A.register(ctx, "A")
    dev = CudaDevice(ctx, device="cpu", autostart=False)
    return ctx, A, dev


def _certify(dev, tp):
    """The fuser's state for `tp`, had as a popped wave of its first
    device class has it."""
    cid = next(tc.id for tc in tp.classes
               if (id(tp), tc.id) in dev.bodies)
    return dev._fuser._state_for(dev.bodies[(id(tp), cid)])


def _fuse(dev):
    return dev.info()["fuse"]


@pytest.mark.parametrize("rank", RANKS)
def test_cached_state_equals_a_fresh_pass(rank):
    """The second pool of one structure hits, and its state is what the
    pass computes over that pool for this rank."""
    ctx, A, dev = _grid(rank)
    try:
        first = _certify(dev, build_potrf(ctx, A, dev=dev))
        tp = build_potrf(ctx, A, dev=dev)
        got = _certify(dev, tp)
        fz = _fuse(dev)
        assert (fz["cert_misses"], fz["cert_hits"]) == (1, 1), fz
        assert fz["cert_uncached"] == {}
        want = chain_certificates(tp).chain_index(rank)
        assert got["failed"] is False
        assert got["links"] == want["links"]
        assert got["classes"] == want["classes"]
        assert got["slots"] == {r["id"]: r["param_slots"]
                                for r in want["classes"].values()}
        assert got["by_name"] == {nm: r["id"]
                                  for nm, r in want["classes"].items()}
        assert got["links"] == first["links"]
        # the pool's own entry: a second pop of it looks nothing up
        assert _certify(dev, tp) is got
        assert _fuse(dev)["cert_hits"] == 1
    finally:
        dev.stop()
        ctx.destroy()


def _grow(ctx, A, dev):
    A.M = A.N = (NT + 1) * NB
    A.mt = A.nt = NT + 1

    def undo():
        A.M = A.N = NT * NB
        A.mt = A.nt = NT
    return undo


def _regrid(ctx, A, dev):
    A.P, A.Q = 4, 1

    def undo():
        A.P, A.Q = 2, 2
    return undo


def _rerank(ctx, A, dev):
    mine = ctx.myrank
    ctx.set_rank((mine + 1) % 4, 4)
    A.myrank = (mine + 1) % 4

    def undo():
        ctx.set_rank(mine, 4)
        A.myrank = mine
    return undo


def _remap(ctx, A, dev):
    ctx.set_rank_map([1, 0, 3, 2])
    return lambda: ctx.set_rank_map(None)


CHANGES = {"nt": _grow, "p_q": _regrid, "myrank": _rerank,
           "rank_map": _remap}


@pytest.mark.parametrize("change", sorted(CHANGES) + [
    "trsm_via_inverse", "chore_shape", "chore_dtype"])
@pytest.mark.parametrize("rank", RANKS)
def test_a_changed_structure_misses(rank, change):
    """Each part of the structure the certificates read, changed, misses;
    the structure as it was still hits after it."""
    ctx, A, dev = _grid(rank)
    try:
        _certify(dev, build_potrf(ctx, A, dev=dev))
        undo = lambda: None  # noqa: E731
        if change in CHANGES:
            undo = CHANGES[change](ctx, A, dev)
            tp = build_potrf(ctx, A, dev=dev)
        elif change == "trsm_via_inverse":
            tp = build_potrf(ctx, A, dev=dev, trsm_via_inverse=False)
        else:
            tp = build_potrf(ctx, A, dev=dev)
            body = next(b for (t, _), b in dev.bodies.items()
                        if t == id(tp) and b.tc.name == "GEMM")
            if change == "chore_shape":
                body.shapes["C"] = (NB, NB // 2)
            else:
                body.dtypes["C"] = np.dtype(np.float16)
        _certify(dev, tp)
        fz = _fuse(dev)
        assert (fz["cert_misses"], fz["cert_hits"]) == (2, 0), (change, fz)
        assert len(dev._fuser._cert_cache) == 2
        undo()
        _certify(dev, build_potrf(ctx, A, dev=dev))
        fz = _fuse(dev)
        assert (fz["cert_misses"], fz["cert_hits"]) == (2, 1), (change, fz)
    finally:
        dev.stop()
        ctx.destroy()


def _call_guard(ctx, A, dev):
    """A pool whose class reads its tile under a guard that calls into
    Python."""
    tp = pt.Taskpool(ctx, globals={"NT": NT - 1})
    k = pt.L("k")
    tc = tp.task_class("T")
    tc.param("k", 0, pt.G("NT"))
    tc.affinity("A", k, k)
    tc.flow("X", "RW",
            pt.In(pt.Mem("A", k, k), guard=pt.call(lambda l, g: 1)),
            pt.Out(pt.Mem("A", k, k)))
    dev.attach(tc, tp, kernel=lambda x: x, reads=["X"], writes=["X"],
               shapes={"X": (NB, NB)})
    return tp


def _hash_collection(ctx, A, dev):
    """A pool over a collection whose placement is a table of keys."""
    H = HashDatadist(nodes=4, myrank=ctx.myrank)
    for key in range(NT):
        H.add(key, key % 4, np.zeros((NB, NB), np.float32))
    H.register(ctx, "H")
    tp = pt.Taskpool(ctx, globals={"NT": NT - 1})
    k = pt.L("k")
    tc = tp.task_class("T")
    tc.param("k", 0, pt.G("NT"))
    tc.affinity("H", k)
    tc.flow("X", "RW", pt.In(pt.Mem("H", k)), pt.Out(pt.Mem("H", k)))
    dev.attach(tc, tp, kernel=lambda x: x, reads=["X"], writes=["X"],
               shapes={"X": (NB, NB)})
    return tp


@pytest.mark.parametrize("build,reason", [
    (_call_guard, "python-call"),
    (_hash_collection, "collection:HashDatadist")],
    ids=["python_call", "hash_collection"])
def test_an_unkeyable_pool_runs_the_pass_uncached(build, reason):
    """A pool the key cannot render exactly runs the pass every time,
    counted by reason, and is never cached."""
    ctx, A, dev = _grid(0)
    try:
        for n in (1, 2):
            st = _certify(dev, build(ctx, A, dev))
            fz = _fuse(dev)
            assert fz["cert_uncached"] == {reason: n}, fz
            assert (fz["cert_hits"], fz["cert_misses"]) == (0, 0)
            assert not dev._fuser._cert_cache
            assert "error" not in str(st["failed"]), st["failed"]
        assert ctx.device_stats()["fuse"]["cert_uncached"] == {reason: 2}
    finally:
        dev.stop()
        ctx.destroy()


def test_cert_counters_and_spans_count_as_documented():
    """cert_misses and cert_hits count pools, cert_ns their time; while a
    trace listens, one DEVICE_CERT span a pool (END aux 0 a miss, 1 a
    hit), their durations adding up to cert_ns; clear() empties the
    cache, so the next pool misses again."""
    ctx, A, dev = _grid(0)
    try:
        ctx.profile_enable(1)
        ns = []
        for i in range(4):
            if i == 2:
                dev._fuser.clear()
            _certify(dev, build_potrf(ctx, A, dev=dev))
            ns.append(dev.info()["stats"]["cert_ns"])
        fz = _fuse(dev)
        assert (fz["cert_misses"], fz["cert_hits"]) == (2, 2), fz
        steps = np.diff([0] + ns)
        assert (steps > 0).all(), ns
        # a hit renders a key and copies a dict: far under a pass
        assert max(steps[1], steps[3]) < min(steps[0], steps[2]), steps
        spans = [s for s in take_trace(ctx).spans()
                 if s[2] == KEY_DEVICE_CERT]
        assert [s[6] for s in spans] == [0, 1, 0, 1]
        assert all(s[1] == -1 and s[5] == dev.qid for s in spans)
        dur = sum(s[8] - s[7] for s in spans)
        assert abs(dur - ns[-1]) <= 50_000 * len(spans) + 0.01 * ns[-1], \
            (dur, ns[-1])
        st = ctx.device_stats()["fuse"]
        assert (st["cert_misses"], st["cert_hits"]) == (2, 2)
    finally:
        dev.stop()
        ctx.destroy()


class _Gate:
    """Holds the device manager out of its queue while a pool's first
    wave gathers, so that it pops the wave whole: a pop of part of it
    would dispatch that part alone, and the chain counts would follow
    the host's load."""

    def __init__(self, ctx):
        self.open = threading.Event()
        self.open.set()
        self._pop = ctx.device_pop
        ctx.device_pop = self.pop

    def pop(self, qid, timeout_ms=100):
        self.open.wait()
        return self._pop(qid, timeout_ms=timeout_ms)

    def run(self, ctx, dev, tp, first_wave):
        self.open.clear()
        time.sleep(0.2)  # a pop under way (50 ms at most) returns
        tp.run()
        deadline = time.monotonic() + 20.0
        while ctx.device_queue_depth(dev.qid) < first_wave:
            assert time.monotonic() < deadline, \
                ctx.device_queue_depth(dev.qid)
            time.sleep(0.01)
        self.open.set()
        tp.wait()


def _two_gemms(clear: bool):
    """C += A @ B twice through one device, each a chain of its whole
    depth (K / nb = 8 waves, wave_fuse_depth 8); `clear` empties the
    certificate cache between the two."""
    rng = np.random.default_rng(7)
    N, nb, K = 64, 16, 128
    with pt.Context(nb_workers=2) as ctx:
        A = TwoDimBlockCyclic(N, K, nb, nb)
        B = TwoDimBlockCyclic(K, N, nb, nb)
        C = TwoDimBlockCyclic(N, N, nb, nb)
        A.from_dense(rng.standard_normal((N, K), dtype=np.float32))
        B.from_dense(rng.standard_normal((K, N), dtype=np.float32))
        C.from_dense(np.zeros((N, N), np.float32))
        for coll, nm in ((A, "A"), (B, "B"), (C, "C")):
            coll.register(ctx, nm)
        dev = CudaDevice(ctx, device="cpu")
        dev.batch_wait_ms = 2.0
        gate = _Gate(ctx)
        per_solve = []
        for i in range(2):
            if i == 1 and clear:
                dev._fuser.clear()
            before = _fuse(dev)
            gate.run(ctx, dev, build_gemm(ctx, A, B, C, dev=dev),
                     C.mt * C.nt)
            after = _fuse(dev)
            per_solve.append({k: after[k] - before[k] for k in (
                "fused_chains", "chain_hits", "chain_misses",
                "cert_hits", "cert_misses")})
        dev.flush()
        dev.stop()
        return C.to_dense().copy(), per_solve, \
            (A.to_dense() @ B.to_dense()) * 2


def test_two_solves_agree_whether_the_second_hits_or_misses():
    """The second pool taken from the cache and the second pool certified
    anew give the same tiles bit for bit and the same chains."""
    c_hit, hit, want = _two_gemms(clear=False)
    c_new, new, _ = _two_gemms(clear=True)
    assert [s["cert_hits"] for s in hit] == [0, 1]
    assert [s["cert_misses"] for s in new] == [1, 1]
    assert c_hit.tobytes() == c_new.tobytes()
    np.testing.assert_allclose(c_hit, want, rtol=1e-4, atol=1e-3)
    for a, b in zip(hit, new):
        assert (a["fused_chains"], a["chain_hits"]) == \
            (b["fused_chains"], b["chain_hits"]), (hit, new)
    assert hit[1]["fused_chains"] > 0 and hit[1]["chain_hits"] > 0, hit
    assert hit[1]["chain_misses"] == 0, hit
