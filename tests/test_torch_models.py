"""The port's transformer LM (parsec_tpu_torch.models.transformer) held
against parsec_tpu.models on the CPU: the counterparts of every test of
tests/models/test_transformer.py, and convert's transformer round trip.

The JAX package's parameters (drawn by its init_params) reach the port
through convert.transformer_params; tokens are numpy-seeded.  Sharded
cases run the port on 8 spawned gloo ranks (tests/test_torch_mesh_workers
.py), spawned once for the module, and the JAX package on its virtual
8-device mesh of the same shape.  The kernel flags run the port's plain
versions on the CPU and the reference's Pallas kernels in interpret mode,
as its own tests run them.  Tolerances are stated per case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_comm_workers as W
import test_torch_mesh_workers as M
from parsec_tpu import models as jm
from parsec_tpu.parallel import make_mesh as jax_mesh
from parsec_tpu_torch import models as tm
from parsec_tpu_torch.convert import transformer_params, transformer_tree
from parsec_tpu_torch.models import transformer as T

DENSE = dict(vocab=64, d_model=64, n_heads=4, head_dim=16, n_layers=2,
             d_ff=128)
MOE = dict(vocab=64, d_model=32, n_heads=2, head_dim=16, n_layers=2,
           d_ff=64, n_experts=4, moe_k=2, ep_axis="dp")
PIPE = dict(vocab=64, d_model=32, n_heads=2, head_dim=16, n_layers=4,
            d_ff=64)
MESH = {"dp": 2, "tp": 2, "sp": 2}


def _params(cfg_kw, seed):
    """The JAX package's init_params, as numpy."""
    p = jm.init_params(jm.TransformerConfig(**cfg_kw),
                       jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, p)


def _tokens(vocab, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _port(cfg_kw, params):
    cfg = tm.TransformerConfig(**cfg_kw)
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(transformer_params(params))
    return cfg, model


def _cases():
    return [
        ("fwd", "forward", {"params": _params(DENSE, 0),
                            "tokens": _tokens(64, 8, 32, 0)[0],
                            "cfg_kw": DENSE, "axes": MESH}),
        ("sgd", "sgd", {"params": _params(DENSE, 1),
                        "tokens": _tokens(64, 8, 32, 1)[0],
                        "targets": _tokens(64, 8, 32, 1)[1],
                        "cfg_kw": DENSE, "axes": MESH, "lr": 0.05,
                        "steps": 8}),
        ("moe", "loss", {"params": _params(MOE, 2),
                         "tokens": _tokens(64, 4, 16, 3)[0],
                         "targets": _tokens(64, 4, 16, 3)[1],
                         "cfg_kw": MOE, "axes": MESH}),
        ("pipe", "pipelined", {"params": _params(PIPE, 4),
                               "tokens": _tokens(64, 8, 16, 5)[0],
                               "cfg_kw": PIPE, "n_mb": 4}),
    ]


@pytest.fixture(scope="module")
def ranks():
    return W.spmd(M.mesh_cases, 8, timeout=300.0, cases=_cases())


def _each(ranks, label):
    got = [r[label] for r in ranks if r[label] is not None]
    assert got
    return got


def test_forward_parity_dp_tp_sp(ranks):
    """dp=2 x tp=2 x sp=2: the port's sharded forward (ring attention on
    sp, column/row-parallel tp, rotary offsets per sequence shard) against
    the reference's sharded forward and its unsharded one, at the
    reference's 2e-4."""
    cfg = jm.TransformerConfig(**DENSE)
    params, (toks, _) = _params(DENSE, 0), _tokens(64, 8, 32, 0)
    ref = np.asarray(jm.forward(params, toks, cfg, mesh=None))
    want = np.asarray(jm.forward(params, toks, cfg,
                                 mesh=jax_mesh(**MESH)))
    for got in _each(ranks, "fwd"):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_train_step_descends(ranks):
    """make_sharded_train_step over dp x tp x sp: the loss descends as the
    reference test asks; one step's loss and parameters against the
    reference's sharded step (loss 1e-5, parameters 1e-5 after lr 0.05:
    f32 gradients summed in another order); the ranks that hold the same
    shard hold the same bits after 8 steps."""
    cfg = jm.TransformerConfig(**DENSE)
    params = _params(DENSE, 1)
    batch = _tokens(64, 8, 32, 1)
    step = jm.make_sharded_train_step(cfg, jax_mesh(**MESH), lr=0.05)
    new, loss = step(params, batch)
    new = jax.tree.map(np.asarray, new)
    results = _each(ranks, "sgd")
    for got in results:
        losses = got["losses"]
        assert losses[-1] < losses[0] - 0.1, losses
        np.testing.assert_allclose(losses[0], float(loss), rtol=1e-5)
        for path, a in T.tree_items(got["first"]):
            np.testing.assert_allclose(a, dict(T.tree_items(new))[path],
                                       rtol=1e-5, atol=1e-5, err_msg=path)
    groups = {}
    for got in results:
        key = got["local"]["coords"]["tp"]
        groups.setdefault(key, []).append(got["local"]["leaves"])
    for leaves in groups.values():
        for other in leaves[1:]:
            for path, a in leaves[0].items():
                np.testing.assert_array_equal(other[path], a, err_msg=path)


def test_moe_transformer_runs(ranks):
    """ep rides dp: the port's sharded MoE loss against the reference's
    sharded MoE loss (the same capacity drops; 1e-5 relative, f32 sums in
    another order), finite, and the no-drop oracle loss of both packages
    agrees at 1e-5."""
    cfg = jm.TransformerConfig(**MOE)
    params, batch = _params(MOE, 2), _tokens(64, 4, 16, 3)
    want = float(jm.loss_fn(params, batch, cfg, jax_mesh(**MESH)))
    ref = float(jm.loss_fn(params, batch, cfg, mesh=None))
    tcfg, model = _port(MOE, params)
    with torch.no_grad():
        port_ref = float(tm.loss_fn(model, tuple(torch.from_numpy(a).long()
                                                 for a in batch), tcfg))
    np.testing.assert_allclose(port_ref, ref, rtol=1e-5)
    for got in _each(ranks, "moe"):
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert abs(got - ref) < 0.5


def test_pipelined_forward_parity(ranks):
    """pipelined_forward over pp=4, 4 microbatches, against the
    reference's pipelined forward and its unpipelined one (2e-4)."""
    cfg = jm.TransformerConfig(**PIPE)
    params, (toks, _) = _params(PIPE, 4), _tokens(64, 8, 16, 5)
    ref = np.asarray(jm.forward(params, toks, cfg))
    want = np.asarray(jm.pipelined_forward(params, toks, cfg,
                                           jax_mesh(pp=4), "pp",
                                           n_microbatch=4))
    got_all = _each(ranks, "pipe")
    assert len(got_all) == 4
    for got in got_all:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def _grads(model, cfg, toks):
    lg = tm.forward(model, toks, cfg)
    loss = torch.mean((lg - 1.0) ** 2)
    names = [n for n, _ in model.named_parameters()]
    gs = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss), dict(zip(names, gs))


def test_remat_matches_plain_gradients():
    """cfg.remat (torch.utils.checkpoint per block): the same loss and
    gradients as without (1e-6 / 1e-5, the reference test's), and both
    against the reference's gradients (1e-5)."""
    base = dict(vocab=64, d_model=32, n_heads=2, head_dim=16, n_layers=3,
                d_ff=64)
    params = _params(base, 0)
    toks = np.random.default_rng(1).integers(0, 64, (2, 16)).astype(
        np.int32)
    cfg, model = _port(base, params)
    cfg_r = tm.TransformerConfig(**base, remat=True)
    tt = torch.from_numpy(toks).long()
    l0, g0 = _grads(model, cfg, tt)
    l1, g1 = _grads(model, cfg_r, tt)
    assert abs(l0 - l1) < 1e-6

    def loss(p):
        lg = jm.forward(p, toks, jm.TransformerConfig(**base))
        return jnp.mean((lg - 1.0) ** 2)

    lj, gj = jax.value_and_grad(loss)(params)
    assert abs(l0 - float(lj)) < 1e-5
    gj = {k: np.asarray(v) for k, v in
          transformer_params(jax.tree.map(np.asarray, gj)).items()}
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(g0[name].numpy(), gj[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("flag", ["use_pallas_norm", "use_flash"])
def test_kernel_flags_match_plain(flag):
    """use_pallas_norm (the reference test's case) and use_flash: the
    port's forward with the flag (the kernels' plain versions on the CPU)
    against its forward without and against the reference's forward with
    the flag (its Pallas kernel in interpret mode), at the reference
    test's 2e-4."""
    base = dict(vocab=64, d_model=128, n_heads=2, head_dim=32, n_layers=2,
                d_ff=128)
    params = _params(base, 0)
    toks = np.random.default_rng(1).integers(0, 64, (2, 128)).astype(
        np.int32)
    want = np.asarray(jm.forward(params, toks,
                                 jm.TransformerConfig(**base, **{flag: True})))
    cfg, model = _port(base, params)
    tt = torch.from_numpy(toks).long()
    plain = tm.forward(model, tt, cfg).detach().numpy()
    got = tm.forward(model, tt, tm.TransformerConfig(**base, **{flag: True}))
    np.testing.assert_allclose(got.detach().numpy(), plain, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4,
                               atol=2e-4)


def test_forward_and_loss_match_reference():
    """The one-rank forward and loss against the reference's (2e-4 on the
    logits, 1e-5 relative on the loss)."""
    params, batch = _params(DENSE, 3), _tokens(64, 4, 32, 7)
    cfg = jm.TransformerConfig(**DENSE)
    tcfg, model = _port(DENSE, params)
    tb = tuple(torch.from_numpy(a).long() for a in batch)
    np.testing.assert_allclose(
        tm.forward(model, tb[0], tcfg).detach().numpy(),
        np.asarray(jm.forward(params, batch[0], cfg)), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(tm.loss_fn(model, tb, tcfg)),
                               float(jm.loss_fn(params, batch, cfg)),
                               rtol=1e-5)


def test_train_step_matches_reference():
    """One SGD train_step on one rank against the reference's (loss 1e-5
    relative, parameters 1e-5)."""
    params, batch = _params(DENSE, 5), _tokens(64, 4, 32, 9)
    cfg = jm.TransformerConfig(**DENSE)
    new, loss = jm.train_step(params, batch, cfg, lr=0.05)
    tcfg, model = _port(DENSE, params)
    got, tloss = tm.train_step(model, tuple(torch.from_numpy(a).long()
                                            for a in batch), tcfg, lr=0.05)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    want = transformer_params(jax.tree.map(np.asarray, new))
    for path, t in T.tree_items(got):
        np.testing.assert_allclose(t.numpy(), want[path].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=path)


def test_convert_round_trip_and_shapes():
    """transformer_params / transformer_tree: the JAX tree to a state_dict
    and back bit for bit, the Transformer's names and shapes the tree's,
    param_shardings mirroring the reference's specs."""
    for cfg_kw in (DENSE, MOE):
        params = _params(cfg_kw, 6)
        cfg, model = _port(cfg_kw, params)
        back = transformer_tree(model)
        assert sorted(T.tree_items(back)) and \
            [k for k, _ in T.tree_items(back)] == \
            [k for k, _ in T.tree_items(params)]
        for (k, a), (_, b) in zip(T.tree_items(back),
                                  T.tree_items(params)):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        jspecs = jm.transformer.param_shardings(
            jm.TransformerConfig(**cfg_kw), jax_mesh(dp=2, tp=2, sp=2))
        for (k, spec), (_, ns) in zip(
                T.tree_items(T.param_shardings(cfg)),
                T.tree_items(jax.tree.map(lambda s: s.spec, jspecs))):
            assert tuple(spec) == tuple(ns) + (None,) * (len(spec) -
                                                         len(ns)), k


def test_entry_points_default_to_the_card():
    """Transformer and init_params with no device need a card; a
    generator draws the reference's shapes and the norms' ones."""
    cfg = tm.TransformerConfig(**DENSE)
    g = torch.Generator().manual_seed(0)
    with pytest.raises((AssertionError, RuntimeError)):
        tm.init_params(cfg, g)
    with pytest.raises((AssertionError, RuntimeError)):
        T.Transformer(cfg)
    model = tm.init_params(cfg, g, device="cpu")
    for path, t in T.tree_items(model.tree()):
        assert tuple(t.shape) == T.param_shapes(cfg)[path]
    assert torch.equal(model.ln_f, torch.ones(64))
