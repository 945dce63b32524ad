"""The port's multi-rank taskpools and Taskpool.drain/dense_classes held
against parsec_tpu on the CPU: the counterparts of
tests/algos/test_ring_attention_taskpool.py, test_moe_taskpool.py,
tests/runtime/test_dense_deps.py, test_coherence_failure.py's
test_ptg_drain_returns, and the ring attention, MoE and front-door
collective cases of tests/comm/test_multirank.py and test_coll.py.

Both packages run in one process on the same numpy-seeded inputs.  Host
bodies are the reference's numpy code, so a host-body run is held bit for
bit against the reference taskpool's; device chores run on
CudaDevice(ctx, device="cpu") (the lane-batched torch chores on the
host) and are held at the reference's device tolerances.  Multi-rank
cases spawn their ranks (tests/test_torch_comm_workers.py) and hold each
rank's owned results against the JAX package's run of the same worker.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import parsec_tpu as jpt
import parsec_tpu_torch as tpt
import test_torch_comm_workers as W
from parsec_tpu.algos import build_potrf as jax_build_potrf
from parsec_tpu.algos import moe as jmoe
from parsec_tpu.algos import ring_attention as jra
from parsec_tpu.data import TwoDimBlockCyclic as JaxBlockCyclic
from parsec_tpu_torch.algos import build_potrf
from parsec_tpu_torch.algos import moe as tmoe
from parsec_tpu_torch.algos.moe import (build_moe, make_moe_collections,
                                        moe_oracle)
from parsec_tpu_torch.algos.ring_attention import (dense_reference, k_att,
                                                   k_fin,
                                                   run_ring_attention)
from parsec_tpu_torch.data import TwoDimBlockCyclic
from parsec_tpu_torch.device import CudaDevice

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs its files in
    parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_dev(ctx, **kw):
    return CudaDevice(ctx, device="cpu", **kw)


# ------------------------------------------------- dense deps and drain
def _potrf_dense(pkg, coll, build):
    N, nb = 128, 16
    rng = np.random.default_rng(0)
    M = rng.standard_normal((N, N), dtype=np.float32)
    spd = M @ M.T + N * np.eye(N, dtype=np.float32)
    with pkg.Context(nb_workers=2) as ctx:
        A = coll(N, N, nb, nb, dtype=np.float32)
        A.from_dense(spd)
        A.register(ctx, "A")
        tp = build(ctx, A)
        tp.run()
        tp.wait()
        return tp.dense_classes, np.tril(A.to_dense()), spd


def test_dense_engine_selected_for_potrf():
    """All four potrf classes are affine boxes: every one runs dense, in
    both packages, and the factor is the reference's bit for bit."""
    n, L, spd = _potrf_dense(tpt, TwoDimBlockCyclic, build_potrf)
    rn, rL, _ = _potrf_dense(jpt, JaxBlockCyclic, jax_build_potrf)
    assert n == rn == 4, (n, rn)
    np.testing.assert_allclose(L, np.linalg.cholesky(spd), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(L, rL)


def _chain(pkg, ctx, nb, body=None):
    ctx.register_arena("t", 8)
    tp = pkg.Taskpool(ctx, globals={"NB": nb})
    k = pkg.L("k")
    tc = tp.task_class("Task")
    tc.param("k", 0, pkg.G("NB"))
    tc.flow("A", "RW",
            pkg.In(None, guard=(k == 0)),
            pkg.In(pkg.Ref("Task", k - 1, flow="A")),
            pkg.Out(pkg.Ref("Task", k + 1, flow="A"),
                    guard=(k < pkg.G("NB"))),
            arena="t")
    if body is None:
        tc.body(lambda t: None)
    else:
        tc.body(body)
    return tp


@pytest.mark.parametrize("pkg", [tpt, jpt], ids=["port", "ref"])
def test_dense_duplicate_detection_whole_run(pkg):
    """Promoted slots keep an exact duplicate record for the whole run —
    chain results exact, every task fires once."""
    with pkg.Context(nb_workers=2) as ctx:
        seen = set()

        def body(t):
            kk = t.local("k")
            assert kk not in seen
            seen.add(kk)

        tp = _chain(pkg, ctx, 2000, body)
        tp.run()
        tp.wait()
        assert tp.dense_classes == 1
        assert len(seen) == 2001


_ENV_SCRIPT = r"""
import parsec_tpu_torch as pt
with pt.Context(nb_workers=1) as ctx:
    ctx.register_arena("t", 8)
    tp = pt.Taskpool(ctx, globals={"NB": 50})
    k = pt.L("k")
    tc = tp.task_class("Task")
    tc.param("k", 0, pt.G("NB"))
    tc.flow("A", "RW",
            pt.In(None, guard=(k == 0)),
            pt.In(pt.Ref("Task", k - 1, flow="A")),
            pt.Out(pt.Ref("Task", k + 1, flow="A"), guard=(k < pt.G("NB"))),
            arena="t")
    tc.body_noop()
    tp.run()
    tp.wait()
    print("DENSE=%d" % tp.dense_classes)
"""


def _run_env(**env):
    e = dict(os.environ, **env)
    e["PYTHONPATH"] = _REPO + os.pathsep + e.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _ENV_SCRIPT], env=e,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-500:]
    return r.stdout


def test_dense_opt_out_env():
    assert "DENSE=0" in _run_env(PTC_MCA_deptable_dense_max="0")
    assert "DENSE=1" in _run_env()
    # the weak-hash sanitizer must exercise the HASH engine
    assert "DENSE=0" in _run_env(PTC_DEBUG_WEAK_HASH="1")


def test_ptg_drain_returns():
    """drain() on a PTG pool returns once its tasks complete."""
    with tpt.Context(nb_workers=2) as ctx:
        tp = _chain(tpt, ctx, 50)
        tp.run()
        done = threading.Event()
        got = []

        def _drain():
            got.append(tp.drain())
            done.set()

        th = threading.Thread(target=_drain, daemon=True)
        th.start()
        assert done.wait(timeout=30), "drain() hung on a PTG taskpool"
        th.join(timeout=5)
        tp.wait()
        assert got and isinstance(got[0], bool)
        assert tp.nb_errors == 0


# ------------------------------------------------------- ring attention
def _qkv(S, T, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((S * T, d)).astype(np.float32)
            for _ in range(3)]


def test_ring_attention_cpu_chores():
    """Host bodies: the dense float64 oracle at 2e-4 / 2e-5, and the
    reference taskpool's O bit for bit."""
    S, T, d = 4, 16, 8
    q, k, v = _qkv(S, T, d)
    with tpt.Context(nb_workers=2) as ctx:
        out = run_ring_attention(ctx, S, T, d, q, k, v).to_dense()
    with jpt.Context(nb_workers=2) as ctx:
        ref = jra.run_ring_attention(ctx, S, T, d, q, k, v).to_dense()
    np.testing.assert_allclose(out, dense_reference(q, k, v),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(dense_reference(q, k, v),
                                  jra.dense_reference(q, k, v))


def test_ring_attention_device_chores():
    """k_att/k_fin on CudaDevice(device="cpu"): every ATT and FIN task
    ran on the device (S*S + S), the oracle holds at 2e-4 / 2e-5, and so
    does the reference's TpuDevice run."""
    from parsec_tpu.device import TpuDevice

    S, T, d = 4, 16, 8
    q, k, v = _qkv(S, T, d, seed=1)
    with tpt.Context(nb_workers=1) as ctx:
        dev = _cpu_dev(ctx)
        out = run_ring_attention(ctx, S, T, d, q, k, v, dev=dev).to_dense()
        assert dev.stats["tasks"] == S * S + S, dev.stats
        assert dev.launches["k_att"][1] == S * S, dev.launches
        assert dev.launches["k_fin"][1] == S, dev.launches
        dev.stop()
    with jpt.Context(nb_workers=1) as ctx:
        jdev = TpuDevice(ctx)
        ref = jra.run_ring_attention(ctx, S, T, d, q, k, v,
                                     dev=jdev).to_dense()
        assert jdev.stats["tasks"] == S * S + S
        jdev.stop()
    np.testing.assert_allclose(out, dense_reference(q, k, v),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)


def test_ring_attention_chores_match_reference_chores():
    """k_att/k_fin on lane stacks against the reference's jnp chores
    (jax.vmap over the lanes), from a first step (running max -inf: the
    rescale must be 0, never NaN) and from a mid-ring state."""
    import jax
    import jax.numpy as jnp

    T, d, n = 8, 16, 3
    rng = np.random.default_rng(5)
    q = rng.standard_normal((n, T, d)).astype(np.float32)
    kv = rng.standard_normal((n, 2 * T, d)).astype(np.float32)
    acc = np.zeros((n, T, d + 2), np.float32)
    acc[..., d] = -np.inf
    for _ in range(2):
        tq, tkv, tacc = k_att(*(torch.from_numpy(a) for a in (q, kv, acc)))
        rq, rkv, racc = jax.vmap(jra.k_att)(*(jnp.asarray(a)
                                              for a in (q, kv, acc)))
        assert torch.isfinite(tacc).all()
        np.testing.assert_array_equal(tq.numpy(), q)
        np.testing.assert_array_equal(tkv.numpy(), kv)
        np.testing.assert_allclose(tacc.numpy(), np.asarray(racc),
                                   rtol=2e-5, atol=2e-6)
        acc = tacc.numpy()
        kv = rng.standard_normal((n, 2 * T, d)).astype(np.float32)
    np.testing.assert_allclose(
        k_fin(torch.from_numpy(acc)).numpy(),
        np.asarray(jax.vmap(jra.k_fin)(jnp.asarray(acc))),
        rtol=2e-5, atol=2e-6)


def test_ring_attention_matches_gspmd_library():
    """Same math as the JAX package's GSPMD ring attention on a
    4-device virtual mesh."""
    import jax
    from jax.sharding import Mesh
    from parsec_tpu.parallel.ring_attention import ring_attention

    S, T, d = 4, 16, 8
    q, k, v = _qkv(S, T, d, seed=2)
    with tpt.Context(nb_workers=2) as ctx:
        out_tp = run_ring_attention(ctx, S, T, d, q, k, v).to_dense()
    mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    shp = (1, S * T, 1, d)
    out_lib = np.asarray(ring_attention(q.reshape(shp), k.reshape(shp),
                                        v.reshape(shp), mesh))
    np.testing.assert_allclose(out_tp, out_lib.reshape(S * T, d),
                               rtol=2e-4, atol=2e-5)


def test_pass_through_outputs_never_alias_their_inputs():
    """A chore that returns an input stack as a write flow (k_att's Q and
    KV) gets its output cloned: the new version's mirror owns storage of
    its own, never a lane-stride-0 view of the old tile or a slice of
    another cached stack, and the cache charges it once."""
    with tpt.Context(nb_workers=1) as ctx:
        src = np.arange(4 * 8, dtype=np.float32).reshape(4, 8)
        tb = 8 * 4
        ctx.register_linear_collection("X", src, elem_size=tb)
        ctx.register_arena("t", tb)
        dev = _cpu_dev(ctx)
        seen = []

        def k_pass(x):
            seen.append(x)
            return x

        tp = tpt.Taskpool(ctx, globals={"NT": 3})
        kv = tpt.L("k")
        tc = tp.task_class("Pass")
        tc.param("k", 0, tpt.G("NT"))
        tc.flow("X", "RW", tpt.In(tpt.Mem("X", kv)),
                tpt.Out(tpt.Mem("X", kv)), arena="t")
        dev.attach(tc, tp, kernel=k_pass, reads=["X"], writes=["X"],
                   shapes={"X": (8,)}, dtype=np.float32)
        tp.run()
        tp.wait()
        with dev._lock:
            ents = list(dev._cache.values())
            used = dev._cache_used
            held = {id(e.stack): e.stack for e in ents if e.stack is not None}
            charged = sum(s.nbytes for s in held.values()) + sum(
                e.nbytes for e in ents if e.stack is None)
        assert ents and used == charged
        inputs = {t.untyped_storage().data_ptr() for t in seen}
        for e in ents:
            assert e.version == 1
            assert e.arr.untyped_storage().data_ptr() not in inputs
        dev.flush()
        dev.stop()
    np.testing.assert_array_equal(
        src, np.arange(4 * 8, dtype=np.float32).reshape(4, 8))


# ------------------------------------------------------------------ MoE
S_, T_, d_, f_, E_, K_ = 2, 8, 4, 6, 3, 2


def _moe_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S_ * T_, d_)).astype(np.float32)
    wg = rng.normal(size=(d_, E_)).astype(np.float32)
    wu = rng.normal(size=(E_, d_, f_)).astype(np.float32) / np.sqrt(d_)
    wd = rng.normal(size=(E_, f_, d_)).astype(np.float32) / np.sqrt(f_)
    return x, wg, wu, wd


def _run_moe(pkg, mod, inputs, dev_of=None, nb_workers=2, **kw):
    x, wg, wu, wd = inputs
    with pkg.Context(nb_workers=nb_workers) as ctx:
        cs = mod.make_moe_collections(S_, T_, d_, f_, E_, x=x, w_gate=wg,
                                      w_up=wu, w_down=wd)
        dev = dev_of(ctx) if dev_of else None
        tp = mod.build_moe(ctx, *cs, E_, k=K_, dev=dev, **kw)
        tp.run()
        tp.wait()
        tasks = None
        if dev is not None:
            dev.flush()
            tasks = dev.stats["tasks"]
            dev.stop()
        return np.concatenate([cs[1].tile(s, 0) for s in range(S_)]), tasks


def test_moe_taskpool_matches_numpy_oracle():
    inputs = _moe_inputs()
    y, _ = _run_moe(tpt, tmoe, inputs)
    yr, _ = _run_moe(jpt, jmoe, inputs)
    np.testing.assert_allclose(y, moe_oracle(*inputs, k=K_), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(y, yr)
    np.testing.assert_array_equal(moe_oracle(*inputs, k=K_),
                                  jmoe.moe_oracle(*inputs, k=K_))


def test_moe_taskpool_matches_gspmd_library():
    """The runtime taskpool and the JAX package's GSPMD reference give
    the same tokens-out for the same weights (relu on both)."""
    import jax
    import jax.numpy as jnp
    from parsec_tpu.parallel.expert import moe_ffn_reference

    x, wg, wu, wd = inputs = _moe_inputs(seed=3)
    y, _ = _run_moe(tpt, tmoe, inputs)
    y_jax = moe_ffn_reference(
        jnp.asarray(x[None]), jnp.asarray(wg), jnp.asarray(wu),
        jnp.asarray(wd), k=K_, activation=jax.nn.relu)
    np.testing.assert_allclose(y, np.asarray(y_jax)[0], rtol=3e-4,
                               atol=3e-4)


def test_moe_taskpool_device_offload():
    """EXP's FFN on the device chore gives the CPU bodies' result at
    3e-4 and ran every EXP task (no CPU fallback); so does the
    reference's TpuDevice run.  A custom activation needs its torch form:
    without one it is rejected before the pool is built; with one it
    runs on the device."""
    from parsec_tpu.device import TpuDevice

    inputs = _moe_inputs(seed=9)
    ref = moe_oracle(*inputs, k=K_)
    y, tasks = _run_moe(tpt, tmoe, inputs, _cpu_dev, nb_workers=1)
    assert tasks == S_ * E_, tasks
    np.testing.assert_allclose(y, ref, rtol=3e-4, atol=3e-4)
    yr, rtasks = _run_moe(jpt, jmoe, inputs, TpuDevice, nb_workers=1)
    assert rtasks == S_ * E_
    np.testing.assert_allclose(y, yr, rtol=3e-4, atol=3e-4)

    x, wg, wu, wd = inputs
    with tpt.Context(nb_workers=1) as ctx:
        cs = make_moe_collections(S_, T_, d_, f_, E_, x=x, w_gate=wg,
                                  w_up=wu, w_down=wd)
        dev = _cpu_dev(ctx)
        with pytest.raises(ValueError, match="activation_torch"):
            build_moe(ctx, *cs, E_, k=K_,
                      activation=lambda v: np.tanh(v), dev=dev)
        dev.stop()
    yt, tasks = _run_moe(tpt, tmoe, inputs, _cpu_dev, nb_workers=1,
                         activation=np.tanh, activation_torch=torch.tanh)
    assert tasks == S_ * E_
    np.testing.assert_allclose(
        yt, moe_oracle(*inputs, k=K_, activation=np.tanh), rtol=3e-4,
        atol=3e-4)


def test_moe_exp_chore_matches_reference_chore():
    """_k_exp_relu on lane stacks (distinct experts per lane, and one
    expert's weights at lane stride 0) against the reference's jnp chore
    under jax.vmap; the (token id, weight) columns pass through bit for
    bit."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    n, C, d, f = 3, 5, 8, 12
    D = rng.normal(size=(n, C, d + 2)).astype(np.float32)
    wu = rng.normal(size=(n, d, f)).astype(np.float32)
    wd = rng.normal(size=(n, f, d)).astype(np.float32)
    got = _exp_chore(D, wu, wd)
    ref = np.asarray(jax.vmap(jmoe._k_exp_relu)(
        jnp.asarray(D), jnp.asarray(wu), jnp.asarray(wd)))
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=3e-5)
    np.testing.assert_array_equal(got[..., d:], D[..., d:])
    shared = _exp_chore(D, np.broadcast_to(wu[:1], wu.shape),
                   np.broadcast_to(wd[:1], wd.shape), stride0=True)
    np.testing.assert_allclose(
        shared, np.stack([_exp_chore(D[i:i + 1], wu[:1], wd[:1])[0]
                          for i in range(n)]), rtol=1e-6, atol=1e-6)


def _exp_chore(D, wu, wd, stride0=False):
    """The port's EXP chore on numpy lane stacks (stride0: every lane
    reads lane 0's weights through one tile at lane stride 0)."""
    tw = [torch.from_numpy(np.array(w[:1] if stride0 else w))
          for w in (wu, wd)]
    if stride0:
        tw = [t.expand(D.shape[0], *t.shape[1:]) for t in tw]
    return tmoe._k_exp_relu(torch.from_numpy(D), *tw).numpy()


def test_moe_capacity_drops_tokens():
    """capacity=1: each expert keeps one token per shard, the rest are
    dropped (zero contribution), exactly as in the reference taskpool."""
    inputs = _moe_inputs(seed=5)
    y, _ = _run_moe(tpt, tmoe, inputs, nb_workers=1, capacity=1)
    yr, _ = _run_moe(jpt, jmoe, inputs, nb_workers=1, capacity=1)
    ref = moe_oracle(*inputs, k=K_)
    assert not np.allclose(y, ref)
    assert np.isfinite(y).all()
    np.testing.assert_array_equal(y, yr)


def test_moe_unknown_combine_raises():
    inputs = _moe_inputs()
    with pytest.raises(ValueError, match="combine"):
        _run_moe(tpt, tmoe, inputs,
                 combine="tree")


# ----------------------------------------------------------- multi-rank
def _held(worker, nodes, ref_kw=None, tol=None, timeout=150.0, **kw):
    """Run `worker` on `nodes` spawned port ranks (each makes the
    reference worker's assertions) and hold the ranks' owned results
    against the JAX package's one-rank run of the same program."""
    got = W.spmd(worker, nodes, timeout=timeout, **kw)
    ref = W.reference(jpt, worker, **(kw if ref_kw is None else ref_kw))
    W.hold(got, ref, tol)
    assert len(W.merged(got)) == len(ref)


@pytest.mark.parametrize("nodes", [2, 4])
def test_ring_attention_ranks(nodes):
    """K/V blocks hop between ranks through the comm engine; the owned O
    shards equal the reference's one-rank run bit for bit (host bodies)."""
    _held(W.ring_attention_spmd, nodes)


def test_ring_attention_2ranks_device():
    """K/V hops between ranks with device-resident production: the
    blocks travel via the data plane (dp_errors == 0 on every rank);
    held against the reference's host-body run at 2e-4 / 2e-5."""
    _held(W.ring_attention_spmd, 2, ref_kw={}, tol=(2e-4, 2e-5),
          timeout=180.0, device=True)


@pytest.mark.parametrize("nodes", [2, 4])
def test_moe_taskpool_ranks(nodes):
    """MoE dispatch/combine all-to-all legs across ranks (shards on
    s%nodes, experts on e%nodes), bit for bit the reference's run."""
    _held(W.moe_taskpool_spmd, nodes)


def test_moe_combine_coll_2rank():
    """The expert combine over the runtime-native reduction (coll steps
    recorded), against the reference's one-rank run at 3e-5 (the partial
    sums associate by rank)."""
    _held(W.moe_taskpool_spmd, 2, ref_kw={}, tol=(3e-5, 3e-5),
          combine="coll")


@pytest.mark.slow
def test_moe_combine_coll_4rank():
    _held(W.moe_taskpool_spmd, 4, ref_kw={}, tol=(3e-5, 3e-5),
          timeout=240.0, combine="coll")


def test_coll_parallel_dispatch_runtime():
    """parallel.collectives' front door routes to the runtime-native path
    with a live multi-rank Context, bit for bit the JAX package's front
    door on as many ranks."""
    got = W.spmd(W.coll_dispatch_runtime, 2)
    ref = W.spmd(W.coll_dispatch_runtime, 2, pkg="parsec_tpu")
    for r, (g, f) in enumerate(zip(got, ref)):
        assert set(g) == set(f)
        for k in f:
            np.testing.assert_array_equal(g[k], f[k], err_msg=f"{r} {k}")
