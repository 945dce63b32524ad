"""The port's training loop and checkpoints (parsec_tpu_torch.models
.training, parsec_tpu_torch.checkpoint) held against the JAX package on
the CPU: the counterparts of every test of tests/models/test_training.py
and tests/checkpoint/test_checkpoint.py, the optimizer against optax's
chain, and collection checkpoints crossing between the packages.

The JAX package's parameters reach the port through
convert.transformer_params; tokens are numpy-seeded.  The sharded case
runs the port on 8 spawned gloo ranks (tests/test_torch_mesh_workers.py)
and the JAX package on its virtual 8-device mesh of the same shape.
Tolerances are stated per case.
"""
import jax
import numpy as np
import optax
import pytest
import torch

import parsec_tpu as jpt
import parsec_tpu_torch as tpt
import test_torch_comm_workers as W
import test_torch_mesh_workers as M
from parsec_tpu import checkpoint as jck
from parsec_tpu.data import TwoDimBlockCyclic as JaxBlockCyclic
from parsec_tpu.models import training as jtr
from parsec_tpu.models import transformer as jtf
from parsec_tpu.parallel import make_mesh as jax_mesh
from parsec_tpu_torch import checkpoint as tck
from parsec_tpu_torch.convert import transformer_params, transformer_tree
from parsec_tpu_torch.data import TwoDimBlockCyclic
from parsec_tpu_torch.models import training as ttr
from parsec_tpu_torch.models import transformer as T

CFG = dict(vocab=64, d_model=32, n_heads=2, head_dim=16, n_layers=2,
           d_ff=64)
MESH = {"dp": 2, "tp": 2, "sp": 2}
SHARDED_TC = dict(lr=1e-2, warmup_steps=2, total_steps=10)


def _params(seed, cfg_kw=CFG):
    p = jtf.init_params(jtf.TransformerConfig(**cfg_kw),
                        jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, p)


def _batches(n, b=8, s=16, seed=0, fixed=True):
    """fixed=True repeats one batch (memorization: loss must descend);
    fixed=False draws fresh tokens each step."""
    out = []
    for i in range(n):
        toks = np.random.default_rng(seed + (0 if fixed else i)) \
            .integers(0, 64, (b, s)).astype(np.int32)
        out.append((toks, np.roll(toks, -1, axis=1)))
    return out


def _tb(batches):
    return [tuple(torch.from_numpy(a).long() for a in b) for b in batches]


def _port_state(params, tc):
    model = T.Transformer(T.TransformerConfig(**CFG), device="cpu")
    model.load_state_dict(transformer_params(params))
    return {"params": model, "opt": ttr.make_optimizer(tc).init(model),
            "step": 0}


def _jax_state(params, tc):
    return {"params": params,
            "opt": jtr.make_optimizer(tc).init(params),
            "step": jax.numpy.zeros((), jax.numpy.int32)}


# ------------------------------------------------------- the sharded case
@pytest.fixture(scope="module")
def ranks():
    return W.spmd(M.mesh_cases, 8, timeout=300.0, cases=[
        ("train", "train", {"params": _params(3), "batches": _batches(10),
                            "cfg_kw": CFG, "tc_kw": SHARDED_TC,
                            "axes": MESH})])


def test_sharded_training_runs(ranks):
    """train over dp=2 x tp=2 x sp=2 (AdamW, clip, schedule over shards):
    finite, descending, each loss against the reference's sharded run of
    the same parameters and batches at 1e-4 relative, the final
    parameters at 1e-4 (f32 gradients summed in another order, through
    ten Adam steps), and the ranks that hold the same shards hold the
    same bits."""
    tc = jtr.TrainConfig(**SHARDED_TC)
    cfg = jtf.TransformerConfig(**CFG)
    params = _params(3)
    state, want = jtr.train(cfg, tc, _batches(10), mesh=jax_mesh(**MESH),
                            state=_jax_state(params, tc))
    final = dict(T.tree_items(jax.tree.map(np.asarray, state["params"])))
    groups = {}
    for got in [r["train"] for r in ranks]:
        assert np.isfinite(got["losses"]).all()
        assert got["losses"][-1] < got["losses"][0]
        assert got["step"] == 10
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
        for path, a in T.tree_items(got["params"]):
            np.testing.assert_allclose(a, final[path], rtol=1e-4,
                                       atol=1e-4, err_msg=path)
        groups.setdefault(got["local"]["coords"]["tp"], []).append(
            got["local"]["leaves"])
    for leaves in groups.values():
        for other in leaves[1:]:
            for path, a in leaves[0].items():
                np.testing.assert_array_equal(other[path], a, err_msg=path)


# ----------------------------------------------------- test_training.py
def test_loss_descends_single_device():
    """Counterpart of test_loss_descends_single_device: 40 steps on one
    memorized batch; the loss descends by more than 0.5, the step counts
    40, and the losses follow the reference's run from the same
    parameters (1e-3 relative: forty Adam steps in f32)."""
    tc = ttr.TrainConfig(lr=2e-2, warmup_steps=2, total_steps=40)
    params = _params(0)
    state, losses = ttr.train(T.TransformerConfig(**CFG), tc,
                              _tb(_batches(40)),
                              state=_port_state(params, tc))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert state["step"] == 40
    _, want = jtr.train(jtf.TransformerConfig(**CFG), tc, _batches(40),
                        state=_jax_state(params, tc))
    np.testing.assert_allclose(losses, want, rtol=1e-3)


def test_checkpoint_resume_bitexact(tmp_path):
    """Counterpart of test_checkpoint_resume_bitexact: 10 steps with a
    checkpoint at 10, resume into a fresh state and run 10 more, against
    20 straight steps over the same batches: bit for bit."""
    cfg = T.TransformerConfig(**CFG)
    p = str(tmp_path / "ck")
    tc = ttr.TrainConfig(lr=5e-3, warmup_steps=2, total_steps=20,
                         ckpt_path=p, ckpt_every=10)
    first, second = _tb(_batches(10)), _tb(_batches(10, seed=99))
    g = torch.Generator().manual_seed(1)
    ttr.train(cfg, tc, first, key=g, device="cpu")
    resumed = ttr.resume_train_state(cfg, tc, p, device="cpu")
    assert resumed["step"] == 10 and resumed["opt"]["count"] == 10
    state_b, _ = ttr.train(cfg, tc, second, state=resumed)
    g = torch.Generator().manual_seed(1)
    state_c, _ = ttr.train(cfg, tc, first + second, key=g, device="cpu")
    for (k, a), (_, b) in zip(T.tree_items(state_b["params"].tree()),
                              T.tree_items(state_c["params"].tree())):
        assert torch.equal(a, b), k
    for which in ("mu", "nu"):
        for (k, a), (_, b) in zip(T.tree_items(state_b["opt"][which]),
                                  T.tree_items(state_c["opt"][which])):
            assert torch.equal(a, b), (which, k)


def test_optimizer_matches_optax():
    """5 updates of the port's AdamW + clip + warmup-cosine schedule
    against optax's chain (the reference's make_optimizer) on the same
    parameters and gradients, with weight decay and a clip that fires:
    parameters at 1e-6 relative (f32; pow and cos may round apart by an
    ulp)."""
    tc = ttr.TrainConfig(lr=3e-2, warmup_steps=2, total_steps=5,
                         clip_norm=1.0, weight_decay=0.1)
    params = _params(4)
    jopt = jtr.make_optimizer(jtr.TrainConfig(**vars(tc)))
    jstate = jopt.init(params)
    jp = params
    model = _port_state(params, tc)["params"]
    opt = ttr.make_optimizer(tc)
    ostate = opt.init(model)
    rng = np.random.default_rng(5)
    for i in range(5):
        grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) *
                                        (3.0 if i % 2 else 0.01))
                             .astype(np.float32), params)
        upd, jstate = jopt.update(grads, jstate, jp)
        jp = jax.tree.map(np.asarray, optax.apply_updates(jp, upd))
        opt.step(model, T.as_tree(transformer_params(grads)), ostate)
        for path, a in T.tree_items(transformer_tree(model)):
            np.testing.assert_allclose(a, dict(T.tree_items(jp))[path],
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i} {path}")
    assert ostate["count"] == 5


def test_schedule_matches_optax():
    """warmup_cosine_lr against optax.warmup_cosine_decay_schedule, every
    count from 0 past the end, with and without warmup (float32; 1e-6
    relative)."""
    for tc in (ttr.TrainConfig(lr=3e-4, warmup_steps=2, total_steps=8),
               ttr.TrainConfig(lr=1e-2, warmup_steps=0, total_steps=5),
               ttr.TrainConfig(lr=1e-3, warmup_steps=100,
                               total_steps=1000)):
        sched = optax.warmup_cosine_decay_schedule(
            0.0, tc.lr, tc.warmup_steps,
            max(tc.total_steps, tc.warmup_steps + 1))
        lr = ttr.warmup_cosine_lr(tc)
        if tc.warmup_steps:
            assert lr(0) == 0.0      # the first update runs at lr 0
        for c in list(range(0, 12)) + [tc.total_steps, tc.total_steps + 3]:
            np.testing.assert_allclose(lr(c), float(sched(c)), rtol=1e-6,
                                       atol=1e-12, err_msg=str(c))


# --------------------------------------------------- test_checkpoint.py
def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    return a @ a.T + n * np.eye(n, dtype=np.float32)


def test_collection_roundtrip(tmp_path):
    A = TwoDimBlockCyclic(64, 64, 16, 16, dtype=np.float32)
    dense = _spd(64)
    A.from_dense(dense)
    tck.save_collections(str(tmp_path / "ck"), {"A": A})
    B = TwoDimBlockCyclic(64, 64, 16, 16, dtype=np.float32)
    tck.load_collections(str(tmp_path / "ck"), {"A": B})
    np.testing.assert_array_equal(B.to_dense(), dense)


def test_geometry_mismatch_rejected(tmp_path):
    A = TwoDimBlockCyclic(64, 64, 16, 16)
    A.from_dense(_spd(64))
    tck.save_collections(str(tmp_path / "ck"), {"A": A})
    B = TwoDimBlockCyclic(64, 64, 32, 32)
    with pytest.raises(ValueError, match="geometry mismatch"):
        tck.load_collections(str(tmp_path / "ck"), {"A": B})


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_collection_checkpoint_crosses_packages(tmp_path, direction):
    """A collection checkpoint written by either package loads in the
    other, bit for bit; a geometry mismatch is refused across too."""
    dense = _spd(64, seed=2)
    src, dst = ((JaxBlockCyclic, jck), (TwoDimBlockCyclic, tck))
    if direction == "port_to_jax":
        src, dst = dst, src
    A = src[0](64, 64, 16, 16, dtype=np.float32)
    A.from_dense(dense)
    src[1].save_collections(str(tmp_path / "ck"), {"A": A})
    B = dst[0](64, 64, 16, 16, dtype=np.float32)
    dst[1].load_collections(str(tmp_path / "ck"), {"A": B})
    np.testing.assert_array_equal(B.to_dense(), dense)
    with pytest.raises(ValueError, match="geometry mismatch"):
        dst[1].load_collections(str(tmp_path / "ck"),
                                {"A": dst[0](64, 64, 32, 32)})


def test_resume_equals_uninterrupted(tmp_path):
    """Counterpart of test_resume_equals_uninterrupted: the port's potrf,
    checkpointed, restored into a fresh Context and collection; the
    factor equals the straight run's and the reference's (host bodies:
    the same numpy code, bit for bit)."""
    from parsec_tpu.algos import build_potrf as jax_build_potrf
    from parsec_tpu_torch.algos import build_potrf
    n, nb = 64, 16
    dense = _spd(n, seed=3)
    factors = []
    for pkg, coll, build in ((tpt, TwoDimBlockCyclic, build_potrf),
                             (jpt, JaxBlockCyclic, jax_build_potrf)):
        with pkg.Context(nb_workers=1) as ctx:
            A = coll(n, n, nb, nb, dtype=np.float32)
            A.register(ctx, "A")
            A.from_dense(dense)
            tp = build(ctx, A)
            tp.run()
            tp.wait()
            factors.append(A.to_dense())
            if pkg is tpt:
                tck.save_collections(str(tmp_path / "ck"), {"A": A})
    with tpt.Context(nb_workers=1) as ctx2:
        A2 = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32)
        A2.register(ctx2, "A")
        tck.load_collections(str(tmp_path / "ck"), {"A": A2})
        np.testing.assert_array_equal(A2.to_dense(), factors[0])
    np.testing.assert_array_equal(factors[0], factors[1])


def test_train_state_roundtrip(tmp_path):
    """Counterpart of test_train_state_roundtrip: a module, its optimizer
    state and the step saved and loaded into a fresh structure, bit for
    bit; the parameters' keys are the reference's keystr paths, so the
    reference's params-only checkpoint loads into the port's module."""
    cfg = T.TransformerConfig(vocab=32, d_model=16, n_heads=2, head_dim=8,
                              n_layers=2, d_ff=32)
    tc = ttr.TrainConfig()
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = {"params": model, "opt": ttr.make_optimizer(tc).init(model),
             "step": 7}
    state["opt"]["mu"]["embed"].normal_()
    tck.save_train_state(str(tmp_path / "m"), state)
    fresh = T.Transformer(cfg, device="cpu")
    like = {"params": fresh, "opt": ttr.make_optimizer(tc).init(fresh),
            "step": 0}
    back = tck.load_train_state(str(tmp_path / "m"), like)
    assert back["step"] == 7 and back["params"] is fresh
    for (k, a), (_, b) in zip(T.tree_items(model.tree()),
                              T.tree_items(fresh.tree())):
        assert torch.equal(a, b), k
    assert torch.equal(back["opt"]["mu"]["embed"],
                       state["opt"]["mu"]["embed"])
    with pytest.raises(ValueError, match="missing leaf"):
        tck.load_train_state(str(tmp_path / "m"), {"other": 0})
    # the reference's params-only checkpoint into the port's module
    jparams = jtf.init_params(jtf.TransformerConfig(
        vocab=32, d_model=16, n_heads=2, head_dim=8, n_layers=2, d_ff=32),
        jax.random.PRNGKey(0))
    jck.save_train_state(str(tmp_path / "j"), {"params": jparams})
    loaded = tck.load_train_state(str(tmp_path / "j"), {"params": fresh})
    for path, a in T.tree_items(transformer_tree(loaded["params"])):
        np.testing.assert_array_equal(
            a, dict(T.tree_items(jax.tree.map(np.asarray, jparams)))[path])
