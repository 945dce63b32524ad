"""The port's mesh libraries (parsec_tpu_torch.parallel) held against
parsec_tpu.parallel on the CPU: the counterparts of every test of
tests/parallel/ (test_coll_dispatch, test_expert, test_pipeline,
test_pipeline_grad, test_seq_parallel).

Both packages get the same numpy-seeded inputs.  The JAX package runs in
this process on its virtual 8-device mesh; the port runs on 8 spawned
gloo ranks (tests/test_torch_mesh_workers.py), spawned once for the
module with every case run inside, each rank holding its shard and
returning the gathered result.  Tolerances are stated per case.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import parsec_tpu as jpt
import parsec_tpu_torch as tpt
import test_torch_comm_workers as W
import test_torch_mesh_workers as M
from parsec_tpu import parallel as jpar
from parsec_tpu.parallel.pipeline import gpipe as jax_gpipe
from parsec_tpu_torch import parallel as tpar


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _contribs(n=8, elems=192):
    # the reference test's recipe: integer-valued float32, so every
    # reduction order sums bit-exactly
    return np.stack([np.random.default_rng(100 + r)
                     .integers(-50, 50, size=elems).astype(np.float32)
                     for r in range(n)])


def _qkv(seed=7, b=2, l=128, h=8, d=16):
    return tuple(_normal(seed + i, (b, l, h, d)) for i in range(3))


def _moe_inputs(seed, b, s, d, f, e, wscale=None):
    x = _normal(seed, (b, s, d))
    wg = _normal(seed + 1, (d, e), 0.1)
    wu = _normal(seed + 2, (e, d, f), wscale or d ** -0.5)
    wd = _normal(seed + 3, (e, f, d), wscale or f ** -0.5)
    return x, wg, wu, wd


def _pipe_inputs(seed, d, n_mb, mb, b_zero=False):
    w = _normal(seed, (4, d, d), d ** -0.5)
    b = np.zeros((4, d), np.float32) if b_zero else \
        _normal(seed + 1, (4, d), 0.1)
    return w, b, _normal(seed + 2, (n_mb, mb, d))


MOE = {1: _moe_inputs(3, 8, 16, 32, 64, 16),
       2: _moe_inputs(3, 8, 16, 32, 64, 16),
       "drop": _moe_inputs(5, 8, 8, 16, 32, 8, wscale=0.1)}
PIPE = {"mb4": _pipe_inputs(0, 16, 4, 8), "mb8": _pipe_inputs(0, 16, 8, 8),
        "dp": _pipe_inputs(1, 8, 4, 6, b_zero=True),
        "grad": _pipe_inputs(0, 8, 4, 6)}


def _cases():
    q, k, v = _qkv()
    cases = [("coll", "coll", {"xs": _contribs(), "root": 3}),
             ("seq", "seq", {
                 "x_perm": np.arange(32, dtype=np.float32).reshape(8, 4),
                 "x_ag": np.arange(16, dtype=np.float32).reshape(16, 1),
                 "x_a2a": _normal(0, (2, 16, 8, 4))}),
             ("ring_grad", "ring_grad",
              dict(zip("qkv", _qkv(11, b=1, l=64, h=2, d=8))))]
    for causal in (False, True):
        for kind in ("ring", "ulysses"):
            cases.append((f"{kind}_{causal}", "attn",
                          {"q": q, "k": k, "v": v, "causal": causal,
                           "kind": kind}))
    for key, kk, cap in ((1, 1, 16), (2, 2, 16), ("drop", 1, 1)):
        x, wg, wu, wd = MOE[key]
        cases.append((f"moe_{key}", "moe", {"x": x, "wg": wg, "wu": wu,
                                            "wd": wd, "k": kk,
                                            "capacity": cap}))
    for key, axes, grad in (("mb4", {"pp": 4}, False),
                            ("mb8", {"pp": 4}, False),
                            ("dp", {"dp": 2, "pp": 4}, False),
                            ("grad", {"pp": 4}, True)):
        w, b, x = PIPE[key]
        cases.append((f"pipe_{key}", "gpipe", {"w": w, "b": b, "x": x,
                                               "axes": axes, "grad": grad}))
    return cases


@pytest.fixture(scope="module")
def ranks():
    """Every case's result on each of the 8 ranks (rank order)."""
    return W.spmd(M.mesh_cases, 8, timeout=300.0, cases=_cases())


@pytest.fixture(scope="module")
def sp8():
    return jpar.make_mesh(sp=8)


def _each(ranks, label):
    return [r[label] for r in ranks]


# ------------------------------------------------------ test_coll_dispatch
@pytest.mark.parametrize("op", ["all_reduce", "reduce_scatter", "all_gather",
                                "broadcast"])
def test_mesh_collectives_bit_exact(ranks, sp8, op):
    """Counterparts of test_xla_{all_reduce,reduce_scatter,all_gather,
    broadcast}_bit_exact: every rank returns the reference's result bit
    for bit (integer-valued float32)."""
    xs = _contribs()
    kw = {"root": 3} if op == "broadcast" else {}
    want = np.asarray(getattr(jpar, op)(xs, mesh=sp8, axis="sp", **kw))
    for got in _each(ranks, "coll"):
        np.testing.assert_array_equal(got[op], want)


def test_mesh_stacking_contract(ranks):
    """Counterpart of test_xla_stacking_contract: the same ValueError."""
    for got in _each(ranks, "coll"):
        assert "stacked on dim 0" in got["stack_error"]


def test_local_fallback_no_mesh_no_ctx():
    """Counterpart of test_local_fallback_no_mesh_no_ctx, on both
    packages."""
    x = np.arange(12, dtype=np.float32)
    for pkg in (jpar, tpar):
        for op in (pkg.all_reduce, pkg.reduce_scatter, pkg.all_gather,
                   pkg.broadcast):
            np.testing.assert_array_equal(op(x), x)


def test_runtime_routing_single_rank():
    """Counterpart of test_runtime_routing_single_rank: a live single-rank
    Context does not take the runtime path; the call is local and no
    collective is recorded, on both packages."""
    for pkg, par in ((jpt, jpar), (tpt, tpar)):
        with pkg.Context(nb_workers=1) as ctx:
            x = np.arange(8, dtype=np.float32)
            np.testing.assert_array_equal(par.all_reduce(x, ctx=ctx), x)
            assert ctx.coll_stats()["ops"] == 0


# ------------------------------------------------------ test_seq_parallel
def test_ring_permute(ranks, sp8):
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    want = np.asarray(jpar.ring_permute(jnp.asarray(x), sp8, "sp", shift=1,
                                        shard_dim=0))
    np.testing.assert_array_equal(want, np.roll(x, 1, 0))
    for got in _each(ranks, "seq"):
        np.testing.assert_array_equal(got["ring_permute"], want)


def test_seq_all_gather_reduce_scatter(ranks, sp8):
    x = np.arange(16, dtype=np.float32).reshape(16, 1)
    g = np.asarray(jpar.seq_all_gather(jnp.asarray(x), sp8, "sp"))
    rs = np.asarray(jpar.seq_reduce_scatter(jnp.asarray(x), sp8, "sp"))
    for got in _each(ranks, "seq"):
        np.testing.assert_array_equal(got["all_gather"], g)
        np.testing.assert_array_equal(got["reduce_scatter"], rs)
        np.testing.assert_array_equal(got["reduce_scatter"], 8 * x)


def test_seq_all_to_all(ranks, sp8):
    x = _normal(0, (2, 16, 8, 4))
    y = np.asarray(jpar.seq_all_to_all(jnp.asarray(x), sp8, "sp",
                                       split_dim=2, concat_dim=1))
    for got in _each(ranks, "seq"):
        # a reshard moves bits: exact
        np.testing.assert_array_equal(got["all_to_all"], y)
        np.testing.assert_array_equal(got["all_to_all_back"], x)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_seq_attention_exact(ranks, sp8, kind, causal):
    """Counterparts of test_ring_attention_exact and
    test_ulysses_attention_exact: the port's sharded attention against
    the reference's sharded attention and against the reference's oracle
    at the reference's 2e-5 (f32, sums in another order)."""
    q, k, v = _qkv()
    fn = jpar.ring_attention if kind == "ring" else jpar.ulysses_attention
    want = np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         sp8, "sp", causal=causal))
    ref = np.asarray(jpar.blockwise_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    for got in _each(ranks, f"{kind}_{causal}"):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_blockwise_attention_reference_matches():
    """The one-rank oracle, the port's against the reference's (2e-5)."""
    q, k, v = _qkv(b=1, l=64)
    for causal in (False, True):
        want = np.asarray(jpar.blockwise_attention_reference(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
        got = tpar.blockwise_attention_reference(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_ring_attention_jit_grad(ranks, sp8):
    """Counterpart of test_ring_attention_jit_grad: the ring's gradients
    (each rank backprops its shard) against the reference's gradient of
    its sharded ring, at the reference's 1e-4."""
    import jax
    q, k, v = (jnp.asarray(a) for a in _qkv(11, b=1, l=64, h=2, d=8))

    def loss(q, k, v):
        return jnp.sum(jpar.ring_attention(q, k, v, sp8, "sp",
                                           causal=True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for got in _each(ranks, "ring_grad"):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-4)


# ------------------------------------------------------------ test_expert
@pytest.mark.parametrize("k", [1, 2])
def test_moe_matches_dense(ranks, k):
    """Counterpart of test_moe_matches_dense: capacity = every local token
    (no drops); the port's ep=8 MoE against the reference's ep=8 MoE and
    the reference's dense oracle at the reference's 1e-4, and the port's
    dense oracle against the reference's."""
    x, wg, wu, wd = MOE[k]
    mesh = jpar.make_mesh(ep=8)
    want = np.asarray(jpar.moe_ffn(x, wg, wu, wd, mesh, "ep", k=k,
                                   capacity=(8 // 8) * 16))
    ref = np.asarray(jpar.moe_ffn_reference(x, wg, wu, wd, k=k))
    dense = tpar.moe_ffn_reference(*(torch.from_numpy(a)
                                     for a in (x, wg, wu, wd)), k=k)
    np.testing.assert_allclose(dense.numpy(), ref, rtol=1e-4, atol=1e-4)
    for got in _each(ranks, f"moe_{k}"):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_moe_capacity_drops(ranks):
    """Counterpart of test_moe_capacity_drops: capacity 1 drops most
    tokens; the port drops exactly the reference's (the same rows are
    zero) and the kept rows agree at 1e-5."""
    x, wg, wu, wd = MOE["drop"]
    mesh = jpar.make_mesh(ep=8)
    want = np.asarray(jpar.moe_ffn(x, wg, wu, wd, mesh, "ep", k=1,
                                   capacity=1)).reshape(-1, 16)
    for got in _each(ranks, "moe_drop"):
        flat = got.reshape(-1, 16)
        assert np.isfinite(flat).all()
        zero = np.abs(flat).sum(axis=1) == 0
        assert zero.any()
        np.testing.assert_array_equal(zero, np.abs(want).sum(axis=1) == 0)
        np.testing.assert_allclose(flat, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------- test_pipeline(_grad)
def _stage(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _members(ranks, label):
    got = [r for r in _each(ranks, label) if r is not None]
    assert got
    return got


@pytest.mark.parametrize("key", ["mb4", "mb8", "dp"])
def test_gpipe_matches_sequential(ranks, key):
    """Counterparts of test_gpipe_matches_sequential (n_mb 4, 8; pp=4)
    and test_gpipe_composes_with_dp (dp=2 x pp=4): the port's pipeline
    against the reference's and against the sequential stack, at the
    reference's 1e-5."""
    w, b, x = PIPE[key]
    mesh = jpar.make_mesh(**({"dp": 2, "pp": 4} if key == "dp"
                             else {"pp": 4}))
    want = np.asarray(jax_gpipe(_stage, (w, b), x, mesh, "pp"))
    ref = x
    for i in range(4):
        ref = np.tanh(ref @ w[i] + b[i])
    got_all = _members(ranks, f"pipe_{key}")
    assert len(got_all) == (8 if key == "dp" else 4)
    for got in got_all:
        np.testing.assert_allclose(got["out"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["out"], ref, rtol=1e-5, atol=1e-5)


def test_gpipe_gradients_match_sequential(ranks):
    """Counterpart of test_gpipe_gradients_match_sequential: gradients
    through the pipeline (each stage's on its rank) against the
    reference's gradients through its pipeline, at 1e-5."""
    import jax
    w, b, x = PIPE["grad"]
    mesh = jpar.make_mesh(pp=4)

    def loss_pipe(w, b):
        return jnp.sum(jax_gpipe(_stage, (w, b), x, mesh, "pp") ** 2)

    gw, gb = jax.grad(loss_pipe, argnums=(0, 1))(w, b)
    for got in _members(ranks, "pipe_grad"):
        np.testing.assert_allclose(got["grads"][0], np.asarray(gw),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["grads"][1], np.asarray(gb),
                                   rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ mesh and multihost
def test_entry_points_need_a_card_or_the_cpu():
    """make_mesh with no device needs a card (raises on a CPU-only
    machine); without a job it raises, telling the caller to init; one
    process needs no job."""
    with pytest.raises((AssertionError, RuntimeError)):
        tpar.make_mesh(sp=1)
    with pytest.raises(RuntimeError, match="init_distributed"):
        tpar.make_mesh(sp=1, device="cpu")
    assert tpar.init_distributed(num_processes=1) == 1
    assert tpar.process_info()[:2] == (0, 1)
    spec = tpar.MeshSpec(dp=2, tp=2, sp=2)
    assert spec.size == 8 == jpar.MeshSpec(dp=2, tp=2, sp=2).size
