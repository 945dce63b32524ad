"""The port's dense linear algebra (parsec_tpu_torch.algos: potrf, trsm,
lu, inverse, qr; the device module's speculative epilogue;
device.bench_utils) held against the JAX package on the CPU, on the same
numpy inputs, at the reference tests' sizes.

  - every device chore on lane stacks against the reference's chore
    (jax.vmap over the lanes, a flow every lane reads passed once):
    max |port - reference| <= 1e-4 * max |reference|
  - every builder under host bodies and under CudaDevice(device="cpu"):
    at the reference test's own tolerance against numpy, and within
    1e-4 * max |result| of parsec_tpu's result under TpuDevice
  - the epilogue's contract, as tests/device/test_epilogue.py pins it
  - the generators, the residual and the no-in-place rule for chores
"""
import jax
import numpy as np
import pytest
import torch

import parsec_tpu as jpt
import parsec_tpu_torch as tpt
from parsec_tpu.algos import inverse as j_inv
from parsec_tpu.algos import lu as j_lu
from parsec_tpu.algos import potrf as j_potrf
from parsec_tpu.algos import qr as j_qr
from parsec_tpu.algos import trsm as j_trsm
from parsec_tpu.data import TwoDimBlockCyclic as JaxBlockCyclic
from parsec_tpu.device import TpuDevice
from parsec_tpu_torch.algos import inverse as t_inv
from parsec_tpu_torch.algos import lu as t_lu
from parsec_tpu_torch.algos import potrf as t_potrf
from parsec_tpu_torch.algos import qr as t_qr
from parsec_tpu_torch.algos import trsm as t_trsm
from parsec_tpu_torch.data import TwoDimBlockCyclic
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.device import bench_utils as bu


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread (the suite runs files in parallel
    worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


def _spd(n, seed):
    x = _rng(seed).standard_normal((n, n))
    return (x @ x.T + n * np.eye(n)).astype(np.float32)


def _dominant(n, seed):
    return (_rng(seed).standard_normal((n, n)) + n * np.eye(n)) \
        .astype(np.float32)


def _lower(n, seed):
    """Well-conditioned lower-triangular factor, garbage above the
    diagonal (the chores must read the lower triangle only)."""
    chol = np.linalg.cholesky(_spd(n, seed).astype(np.float64))
    upper = np.triu(_rng(seed + 1).standard_normal((n, n)), 1)
    return (chol + upper).astype(np.float32)


def _orth(n, seed):
    return np.linalg.qr(_rng(seed).standard_normal((n, n)))[0] \
        .astype(np.float32)


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max(), (what, err, np.abs(want).max())


# ------------------------------------------------------------ the chores
LANES, NB, NP = 3, 16, 64  # lanes, tile edge, panel height (4 blocks)


def _stack(fn):
    return np.stack([fn(i) for i in range(LANES)])


def _panel_inputs(matrix_fn, seed):
    """Panels k = 1, 3, 2 of a (NP, NP) matrix as lanes, with their
    block-row indices (lanes of one launch carry different offsets)."""
    ks = [1, 3, 2]
    full = matrix_fn(NP, seed)
    p = np.stack([full[:, k * NB:(k + 1) * NB] for k in ks])
    return p, np.asarray(ks, np.int32).reshape(LANES, 1)


def _qr_canon(q, r, nb):
    """Per lane: Q's first nb columns and R's rows with diag(R) made
    positive, and the projector onto Q's remaining columns (a complete QR
    is unique only up to those signs and that basis)."""
    out_q, out_r, proj = [], [], []
    for qi, ri in zip(np.asarray(q, np.float64), np.asarray(r, np.float64)):
        d = np.sign(np.diag(ri[:nb, :nb]))
        out_q.append(qi[:, :nb] * d)
        out_r.append(ri * d[:, None] if ri.shape[0] == nb
                     else np.vstack([ri[:nb] * d[:, None], ri[nb:]]))
        rest = qi[:, nb:]
        proj.append(rest @ rest.T)
    return np.stack(out_q), np.stack(out_r), np.stack(proj)


def _chore_cases():
    """name -> (port chore, reference chore, inputs, shared flags)."""
    spd_t = _stack(lambda i: _spd(NB, 10 + i))
    low = _lower(NB, 20)
    rnd = lambda s: _stack(lambda i: _rng(s + i).standard_normal(  # noqa
        (NB, NB)).astype(np.float32))
    lu_t = _stack(lambda i: _dominant(NB, 30 + i))
    packed = j_lu.getrf_nopiv_reference(_dominant(NB, 40)) \
        .astype(np.float32)
    p_spd, ks = _panel_inputs(_spd, 50)
    p_dom, ks_dom = _panel_inputs(_dominant, 60)
    chol = np.linalg.cholesky(_spd(NP, 70).astype(np.float64)) \
        .astype(np.float32)
    p_l = np.stack([chol[:, k * NB:(k + 1) * NB] for k in (1, 3, 2)])
    rhs = _stack(lambda i: _rng(80 + i).standard_normal(
        (NP, 8)).astype(np.float32))
    pk = np.asarray(j_potrf.k_panel_factor(p_spd[0], ks[0]))
    pk_lu = np.asarray(j_lu.k_panel_getrf(p_dom[0], ks_dom[0])[0])
    ki = ks_dom[:1].repeat(LANES, 0)
    pj = _stack(lambda i: _rng(90 + i).standard_normal(
        (NP, NB)).astype(np.float32))
    q2 = _orth(2 * NB, 100)
    S, P = True, False  # shared (lane stride 0) / per lane
    return {
        "k_potrf": (t_potrf.k_potrf, j_potrf.k_potrf, [spd_t], [P]),
        "k_trsm": (t_potrf.k_trsm, j_potrf.k_trsm,
                   [np.tril(low), rnd(1)], [S, P]),
        "k_potrf_inv": (t_potrf.k_potrf_inv, j_potrf.k_potrf_inv,
                        [spd_t], [P]),
        "k_trsm_mm": (t_potrf.k_trsm_mm, j_potrf.k_trsm_mm,
                      [np.tril(low), rnd(2)], [S, P]),
        "k_syrk": (t_potrf.k_syrk, j_potrf.k_syrk, [rnd(3), spd_t],
                   [P, P]),
        "k_gemm": (t_potrf.k_gemm, j_potrf.k_gemm,
                   [rnd(4), rnd(5), rnd(6)], [P, P, P]),
        "k_panel_factor": (t_potrf.k_panel_factor, j_potrf.k_panel_factor,
                           [p_spd, ks], [P, P]),
        "k_panel_update": (t_potrf.k_panel_update, j_potrf.k_panel_update,
                           [pk, ks, pj], [S, P, P]),
        "k_panel_fwd": (t_potrf.k_panel_fwd, j_potrf.k_panel_fwd,
                        [p_l, ks, rhs], [P, P, P]),
        "k_panel_bwd": (t_potrf.k_panel_bwd, j_potrf.k_panel_bwd,
                        [p_l, ks, rhs], [P, P, P]),
        "k_solve": (t_trsm.k_solve, j_trsm.k_solve, [low, rnd(7)], [S, P]),
        "k_update": (t_trsm.k_update, j_trsm.k_update,
                     [rnd(8), rnd(9), rnd(10)], [P, P, P]),
        "k_getrf_nopiv": (t_lu.k_getrf_nopiv, j_lu.k_getrf_nopiv,
                          [lu_t], [P]),
        "k_trsm_l": (t_lu.k_trsm_l, j_lu.k_trsm_l, [packed, rnd(11)],
                     [S, P]),
        "k_trsm_u": (t_lu.k_trsm_u, j_lu.k_trsm_u, [packed, rnd(12)],
                     [S, P]),
        "k_gemm_lu": (t_lu.k_gemm_lu, j_lu.k_gemm_lu,
                      [rnd(13), rnd(14), rnd(15)], [P, P, P]),
        "k_panel_getrf": (t_lu.k_panel_getrf, j_lu.k_panel_getrf,
                          [p_dom, ks_dom], [P, P]),
        "k_panel_getrf_update": (t_lu.k_panel_getrf_update,
                                 j_lu.k_panel_getrf_update,
                                 [pk_lu, ki[0], pj], [S, S, P]),
        "k_tri_inv": (t_inv.k_tri_inv, j_inv.k_tri_inv,
                      [_stack(lambda i: _lower(NB, 110 + i))], [P]),
        "k_acc_ab": (t_inv.k_acc_ab, j_inv.k_acc_ab,
                     [rnd(16), rnd(17), rnd(18)], [P, P, P]),
        "k_mul_ab": (t_inv.k_mul_ab, j_inv.k_mul_ab, [rnd(19), rnd(20)],
                     [P, P]),
        "k_neg_mul": (t_inv.k_neg_mul, j_inv.k_neg_mul,
                      [np.tril(low), rnd(21)], [S, P]),
        "k_acc_atb": (t_inv.k_acc_atb, j_inv.k_acc_atb,
                      [rnd(22), rnd(23), rnd(24)], [P, P, P]),
        "k_geqrt": (t_qr.k_geqrt, j_qr.k_geqrt, [rnd(25)], [P]),
        "k_unmqr": (t_qr.k_unmqr, j_qr.k_unmqr, [_orth(NB, 26), rnd(27)],
                    [S, P]),
        "k_tsqrt": (t_qr.k_tsqrt, j_qr.k_tsqrt,
                    [np.triu(rnd(28)), rnd(29)], [P, P]),
        "k_tsmqr": (t_qr.k_tsmqr, j_qr.k_tsmqr, [q2, rnd(30), rnd(31)],
                    [S, P, P]),
    }


# the names only: the cases (which run reference chores) are built in
# the test, never while the module is collected
CHORES = ["k_acc_ab", "k_acc_atb", "k_gemm", "k_gemm_lu", "k_geqrt",
          "k_getrf_nopiv", "k_mul_ab", "k_neg_mul", "k_panel_bwd",
          "k_panel_factor", "k_panel_fwd", "k_panel_getrf",
          "k_panel_getrf_update", "k_panel_update", "k_potrf",
          "k_potrf_inv", "k_solve", "k_syrk", "k_tri_inv", "k_trsm",
          "k_trsm_l", "k_trsm_mm", "k_trsm_u", "k_tsmqr", "k_tsqrt",
          "k_unmqr", "k_update"]


def test_every_chore_of_the_port_is_covered():
    assert sorted(_chore_cases()) == CHORES


@pytest.mark.parametrize("name", CHORES)
def test_chore_on_lane_stacks_matches_reference_chore(name):
    port, ref, ins, shared = _chore_cases()[name]
    lanes = [torch.from_numpy(np.array(a)).unsqueeze(0).expand(
        LANES, *a.shape) if s else torch.from_numpy(np.array(a))
        for a, s in zip(ins, shared)]
    before = [t.clone() for t in lanes]
    got = port(*lanes)
    got = got if isinstance(got, tuple) else (got,)
    want = jax.vmap(ref, in_axes=tuple(None if s else 0 for s in shared))(
        *[np.asarray(a) for a in ins])
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for t, b in zip(lanes, before):  # no chore writes an input
        assert torch.equal(t, b), name
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    if name == "k_geqrt":
        for g, w in zip(_qr_canon(*got, NB), _qr_canon(*want, NB)):
            _close(g, w, name)
        return
    if name == "k_tsqrt":
        (gr, gv, gq), (wr, wv, wq) = got, want
        for g, w in zip(_qr_canon(gq, gr, NB), _qr_canon(wq, wr, NB)):
            _close(g, w, name)
        assert not gv.any()
        return
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"{name} output {i}")


def test_chores_refuse_tf32_on_the_card_only():
    """The guard acts on CUDA tensors; a CPU tensor runs whatever the
    flag says (the CPU has no TF32)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        a = torch.from_numpy(_stack(lambda i: _spd(NB, i)))
        assert t_potrf.k_potrf(a).shape == a.shape
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# ------------------------------------------------------------ builders
PKG = {"port": (tpt, TwoDimBlockCyclic,
                lambda ctx: CudaDevice(ctx, device="cpu"),
                dict(potrf=t_potrf, lu=t_lu, trsm=t_trsm, inv=t_inv,
                     qr=t_qr)),
       "jax": (jpt, JaxBlockCyclic, lambda ctx: TpuDevice(ctx),
               dict(potrf=j_potrf, lu=j_lu, trsm=j_trsm, inv=j_inv,
                    qr=j_qr))}


def _tiled(cls, dense, nb):
    c = cls(dense.shape[0], dense.shape[1], nb, nb, dtype=np.float32)
    c.from_dense(dense)
    return c


def _panels(cls, dense, nb):
    n = dense.shape[0]
    c = cls(n, n, n, nb, dtype=dense.dtype)
    for j in range(c.nt):
        c.tile(0, j)[...] = dense[:, j * nb:(j + 1) * nb]
    return c


def _panel_dense(c):
    return np.concatenate([c.tile(0, j) for j in range(c.nt)], axis=1)


def _potrf_tile(via, N, nb):
    def case(ctx, cls, devs, m):
        A = _tiled(cls, _spd(N, 42), nb)
        A.register(ctx, "A")
        tp = m["potrf"].build_potrf(ctx, A, dev=devs,
                                    trsm_via_inverse=via)
        return tp, lambda: np.tril(A.to_dense())
    return case, lambda: np.linalg.cholesky(_spd(N, 42).astype(np.float64)),\
        2e-2


def _potrf_panels(ctx, cls, devs, m):
    A = _panels(cls, _spd(192, 0), 32)
    A.register(ctx, "A")
    return (m["potrf"].build_potrf_panels(ctx, A, dev=devs),
            lambda: np.tril(_panel_dense(A)))


def _posv_panels(ctx, cls, devs, m):
    A = _panels(cls, _spd(128, 5), 32)
    A.register(ctx, "A")
    B = cls(128, 4, 128, 4, dtype=np.float32)
    B.tile(0, 0)[...] = _rng(6).standard_normal((128, 4))
    B.register(ctx, "B")
    tp = m["potrf"].build_potrf_panels(ctx, A, dev=devs)
    tp.run()
    tp.wait()
    return (m["potrf"].build_potrs_panels(ctx, A, B, dev=devs),
            lambda: B.tile(0, 0).copy())


def _posv_ref():
    rhs = _rng(6).standard_normal((128, 4)).astype(np.float32)
    return np.linalg.solve(_spd(128, 5).astype(np.float64), rhs)


def _getrf_tile(ctx, cls, devs, m):
    A = _tiled(cls, _dominant(32, 0), 8)
    A.register(ctx, "A")
    return m["lu"].build_getrf_nopiv(ctx, A, dev=devs), A.to_dense


def _getrf_panels(ctx, cls, devs, m):
    A = _panels(cls, _dominant(192, 11), 32)
    A.register(ctx, "A")
    return (m["lu"].build_getrf_panels(ctx, A, dev=devs),
            lambda: _panel_dense(A))


def _trsm_l():
    l = np.tril(_rng(0).normal(size=(48, 48))).astype(np.float32)
    return l + 96 * np.eye(48, dtype=np.float32)


def _trsm(ctx, cls, devs, m):
    L, B = _tiled(cls, _trsm_l(), 8), _tiled(
        cls, _rng(1).normal(size=(48, 16)).astype(np.float32), 8)
    L.register(ctx, "L")
    B.register(ctx, "B")
    return m["trsm"].build_trsm(ctx, L, B, dev=devs), B.to_dense


def _trsm_ref():
    b = _rng(1).normal(size=(48, 16)).astype(np.float32)
    return np.linalg.solve(_trsm_l().astype(np.float64), b)


def _chol96(seed):
    return np.linalg.cholesky(_spd(96, seed).astype(np.float64)) \
        .astype(np.float32)


def _trtri(ctx, cls, devs, m):
    L, W = _tiled(cls, _chol96(7), 32), _tiled(
        cls, np.zeros((96, 96), np.float32), 32)
    L.register(ctx, "L")
    W.register(ctx, "W")
    return (m["inv"].build_trtri(ctx, L, W, dev=devs),
            lambda: np.tril(W.to_dense()))


def _lauum_w():
    return np.tril(_rng(8).standard_normal((96, 96))).astype(np.float32)


def _lauum(ctx, cls, devs, m):
    W, C = _tiled(cls, _lauum_w(), 32), _tiled(
        cls, np.zeros((96, 96), np.float32), 32)
    W.register(ctx, "W")
    C.register(ctx, "C")
    return (m["inv"].build_lauum(ctx, W, C, dev=devs),
            lambda: np.tril(C.to_dense()))


def _potri(ctx, cls, devs, m):
    z = np.zeros((96, 96), np.float32)
    A, W, C = (_tiled(cls, _spd(96, 9), 32), _tiled(cls, z, 32),
               _tiled(cls, z, 32))
    for name, c in zip("AWC", (A, W, C)):
        c.register(ctx, name)

    class _Done:  # run_potri runs its three pools itself
        def run(self):
            m["inv"].run_potri(ctx, A, W, C, dev=devs)

        def wait(self):
            pass
    return _Done(), lambda: np.tril(C.to_dense())


def _geqrf(ctx, cls, devs, m):
    A = _tiled(cls, _rng(0).normal(size=(32, 32)).astype(np.float32), 8)
    A.register(ctx, "A")
    return m["qr"].build_geqrf(ctx, A, dev=devs), A.to_dense


def _row_signs(r):
    """R with each row's sign set by its diagonal entry."""
    return r * np.sign(np.diag(r))[:, None]


BUILDERS = {
    # name: (case, numpy reference, tolerance against it)
    "potrf_tile_inverse": _potrf_tile(True, 96, 32),
    "potrf_tile_solve": _potrf_tile(False, 64, 16),
    "potrf_panels": (_potrf_panels, lambda: np.linalg.cholesky(
        _spd(192, 0).astype(np.float64)), 2e-3),
    "posv_panels": (_posv_panels, _posv_ref, 5e-3),
    "getrf_tile": (_getrf_tile, lambda: j_lu.getrf_nopiv_reference(
        _dominant(32, 0)), 3e-3),
    "getrf_panels": (_getrf_panels, lambda: j_lu.getrf_nopiv_reference(
        _dominant(192, 11)), 5e-3),
    "trsm": (_trsm, _trsm_ref, 2e-3),
    "trtri": (_trtri, lambda: np.linalg.inv(_chol96(7).astype(np.float64)),
              2e-2),
    "lauum": (_lauum, lambda: np.tril(_lauum_w().astype(np.float64).T
                                      @ _lauum_w()), 2e-2),
    "potri": (_potri, lambda: np.tril(np.linalg.inv(
        _spd(96, 9).astype(np.float64))), 5e-2),
    "geqrf": (_geqrf, None, 2e-2),
}


def _run_builder(name, pkg, on_device):
    mod, cls, make_dev, algos = PKG[pkg]
    with mod.Context(nb_workers=2) as ctx:
        dev = make_dev(ctx) if on_device else None
        tp, result = BUILDERS[name][0](ctx, cls, dev, algos)
        tp.run()
        tp.wait()
        stats = None
        if dev is not None:
            dev.flush()
            stats = dict(dev.stats)
            dev.stop()
        return result(), stats


@pytest.fixture(scope="module")
def reference_results():
    """parsec_tpu's (result, device stats) of each builder under
    TpuDevice, computed once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run_builder(name, "jax", True)
        return cache[name]
    return get


@pytest.mark.parametrize("on_device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_matches_numpy_and_reference(name, on_device,
                                             reference_results):
    got, stats = _run_builder(name, "port", on_device)
    ref, ref_stats = reference_results(name)
    _, oracle, tol = BUILDERS[name]
    if on_device:  # the same DAG: as many device tasks as the reference
        assert stats["tasks"] == ref_stats["tasks"] > 0
        assert stats["f64_refused"] == 0
    if name == "geqrf":
        a0 = _rng(0).normal(size=(32, 32)).astype(np.float64)
        np.testing.assert_allclose(np.tril(got, -1), 0, atol=2e-4)
        np.testing.assert_allclose(got.astype(np.float64).T @ got,
                                   a0.T @ a0, rtol=tol, atol=tol)
        _close(_row_signs(got), _row_signs(ref), name)
        return
    want = oracle()
    if name == "posv_panels":
        assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < tol
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    _close(got, ref, name)


def test_float64_panels_stay_on_the_host_chore():
    """f64 classes are refused (counted), run their host chores, and get
    no epilogue."""
    N, nb = 224, 32
    spd = _spd(N, 0).astype(np.float64)
    with tpt.Context(nb_workers=2) as ctx:
        A = _panels(TwoDimBlockCyclic, spd, nb)
        A.register(ctx, "A")
        dev = CudaDevice(ctx, device="cpu")
        tp = t_potrf.build_potrf_panels(ctx, A, dev=dev)
        tp.run()
        tp.wait()
        st = dict(dev.stats)
        dev.stop()
        out = np.tril(_panel_dense(A))
    assert st["tasks"] == 0 and st["f64_refused"] == 2
    assert st["spec_store"] == 0
    np.testing.assert_allclose(out, np.linalg.cholesky(spd), rtol=1e-8,
                               atol=1e-8)


# ------------------------------------------------------------ epilogue
def _epilogue_run(N, nb, n_devices=1):
    spd = _spd(N, 0)
    with tpt.Context(nb_workers=2) as ctx:
        A = _panels(TwoDimBlockCyclic, spd, nb)
        A.register(ctx, "A")
        devs = [CudaDevice(ctx, device="cpu") for _ in range(n_devices)]
        tp = t_potrf.build_potrf_panels(ctx, A, dev=devs)
        tp.run()
        tp.wait()
        for d in devs:
            d.flush()
        stats = [dict(d.stats) for d in devs]
        for d in devs:
            d.stop()
        out = np.tril(_panel_dense(A))
    np.testing.assert_allclose(out, np.linalg.cholesky(spd.astype(
        np.float64)), rtol=2e-3, atol=2e-3)
    return stats


def test_epilogue_every_chained_factor_is_free():
    s, = _epilogue_run(256, 32)  # nt = 8
    assert s["spec_store"] == 7 and s["spec_hits"] == 7, s
    assert s["spec_misses"] == 0, s
    assert s["tasks"] == 8 + 28


def test_epilogue_disabled_by_env(monkeypatch):
    monkeypatch.setenv("PTC_DEVICE_EPILOGUE", "0")
    s, = _epilogue_run(192, 32)
    assert s["spec_store"] == 0 and s["spec_hits"] == 0, s


def test_epilogue_two_devices():
    """Two devices: data affinity routes F(k+1) to the device whose wave
    parked its result; a task that lands elsewhere is a normal launch,
    so the result is right either way."""
    stats = _epilogue_run(256, 32, n_devices=2)
    hits = sum(s["spec_hits"] for s in stats)
    misses = sum(s["spec_misses"] for s in stats)
    assert hits + misses <= 7 and hits >= 1, stats
    assert sum(s["tasks"] for s in stats) == 8 + 28
    if all(s["tasks"] for s in stats):
        # a panel produced on one device and read on the other moved
        # device to device: its host copy was stale
        assert sum(s["d2d_bytes"] for s in stats) > 0, stats


def test_epilogue_getrf_two_outputs():
    """getrf's factor returns (panel, KI): both dst write flows come from
    the parked result."""
    N, nb = 192, 32
    M = _dominant(N, 0)
    with tpt.Context(nb_workers=2) as ctx:
        A = _panels(TwoDimBlockCyclic, M, nb)
        A.register(ctx, "G")
        dev = CudaDevice(ctx, device="cpu")
        tp = t_lu.build_getrf_panels(ctx, A, dev=dev, name="G")
        tp.run()
        tp.wait()
        dev.flush()
        st = dict(dev.stats)
        dev.stop()
        out = _panel_dense(A)
    assert st["spec_hits"] == N // nb - 1 and st["spec_misses"] == 0, st
    np.testing.assert_allclose(out, j_lu.getrf_nopiv_reference(M),
                               rtol=2e-2, atol=2e-2)


def test_epilogue_rejects_undeclared_varying_read_flow():
    with tpt.Context(nb_workers=1) as ctx:
        A = _tiled(TwoDimBlockCyclic, np.zeros((8, 8), np.float32), 8)
        A.register(ctx, "A")
        dev = CudaDevice(ctx, device="cpu")
        tp = tpt.Taskpool(ctx)
        src = tp.task_class("Src")
        src.flow("X", "RW", tpt.In(tpt.Mem("A", 0, 0)),
                 tpt.Out(tpt.Mem("A", 0, 0)))
        dst = tp.task_class("Dst")
        dst.flow("P", "RW", tpt.In(tpt.Mem("A", 0, 0)),
                 tpt.Out(tpt.Mem("A", 0, 0)))
        dst.flow("Q", "READ", tpt.In(tpt.Mem("A", 0, 0)))
        dev.attach(src, tp, kernel=lambda x: x, reads=["X"], writes=["X"],
                   shapes={"X": (8, 8)})
        dev.attach(dst, tp, kernel=lambda p, q: p + q, reads=["P", "Q"],
                   writes=["P"], shapes={"P": (8, 8), "Q": (8, 8)})
        kw = dict(src_flow="X", dst_in_flow="P", pick=lambda v: None,
                  dst_params=lambda v: (), kernel=lambda x: x,
                  ops=lambda key: [])
        with pytest.raises(ValueError, match="single-varying-input"):
            dev.attach_epilogue(src, dst, tp, **kw)
        dev.attach_epilogue(src, dst, tp, const_flows=("Q",), **kw)
        assert dev._pools[tp._ptr].bodies[dst.id].spec_src is not None
        dev.stop()


def test_epilogue_mismatched_version_is_a_counted_miss():
    """A parked result whose source version is not the dst task's input
    copy is a miss and the task launches normally."""
    with tpt.Context(nb_workers=2) as ctx:
        A = _panels(TwoDimBlockCyclic, _spd(128, 3), 32)
        A.register(ctx, "A")
        dev = CudaDevice(ctx, device="cpu")
        put = dev._spec_put

        def stale(key, eouts, src):
            put(key, eouts, (src[0], src[1] + 100))
        dev._spec_put = stale
        tp = t_potrf.build_potrf_panels(ctx, A, dev=dev)
        tp.run()
        tp.wait()
        dev.flush()
        st = dict(dev.stats)
        dev.stop()
        out = np.tril(_panel_dense(A))
    assert st["spec_store"] == 3 and st["spec_misses"] == 3
    assert st["spec_hits"] == 0 and st["tasks"] == 4 + 6
    np.testing.assert_allclose(out, np.linalg.cholesky(
        _spd(128, 3).astype(np.float64)), rtol=2e-3, atol=2e-3)


# --------------------------------------------- inputs, generators, checks
def test_u_wave_leaves_its_stride_zero_input_mirror_unchanged():
    """PK reaches every lane of a U wave as ONE mirror at lane stride 0;
    the wave must not write it (it is F(k)'s output, read by every
    other lane and by the host at flush)."""
    seen = {}

    def watch(pk, js, pj):
        before = pk.clone()
        out = t_potrf.k_panel_update(pk, js, pj)
        if pk.shape[0] > 1:
            assert pk.stride(0) == 0
            seen["lanes"] = max(seen.get("lanes", 0), pk.shape[0])
            assert torch.equal(pk, before)
        return out
    spd = _spd(128, 1)
    with tpt.Context(nb_workers=2) as ctx:
        A = _panels(TwoDimBlockCyclic, spd, 32)
        A.register(ctx, "A")
        dev = CudaDevice(ctx, device="cpu")
        tp = t_potrf._build_panel_factorization(
            ctx, A, dev, "A", t_potrf.k_panel_factor, watch,
            t_potrf._potrf_b_factor, t_potrf._potrf_b_update)
        tp.run()
        tp.wait()
        dev.flush()
        dev.stop()
        out = np.tril(_panel_dense(A))
    assert seen.get("lanes", 0) > 1
    np.testing.assert_allclose(out, np.linalg.cholesky(spd.astype(
        np.float64)), rtol=2e-3, atol=2e-3)


def _generated(N, nb, panels):
    with tpt.Context(nb_workers=1) as ctx:
        if panels:
            A = TwoDimBlockCyclic(N, N, N, nb)
        else:
            A = TwoDimBlockCyclic(N, N, nb, nb)
        A.register(ctx, "A")
        dev = CudaDevice(ctx, device="cpu")
        gen = bu.generate_spd_panels_on_device if panels \
            else bu.generate_spd_on_device
        st = gen(dev, A, seed=3)
        dense = bu.assemble_dense(st, A.mt, A.nt, nb, A.mb).numpy().copy()
        # the mirrors are installed: a gather returns the same stack
        assert torch.equal(bu.gather_device_tiles(dev, A), st)
        dev.stop()
    return dense


def test_tiled_and_panel_generators_agree_block_for_block():
    N, nb = 128, 32
    tiled, panel = _generated(N, nb, False), _generated(N, nb, True)
    assert tiled.tobytes() == panel.tobytes()
    np.testing.assert_array_equal(tiled, tiled.T)
    assert np.linalg.eigvalsh(tiled.astype(np.float64)).min() > 0
    np.testing.assert_allclose(np.diag(tiled), 2 * N, atol=5.0)


def test_potrf_residual_matches_numpy():
    """bench_utils.potrf_residual: the generated matrix factored by the
    panel DAG on the device leaves a float32-rounding residual, and on
    the unfactored mirrors (tril(A) as "L") it equals numpy's float64
    residual of the same matrices."""
    N, nb = 128, 32
    with tpt.Context(nb_workers=2) as ctx:
        A = TwoDimBlockCyclic(N, N, N, nb)
        A.register(ctx, "A")
        dev = CudaDevice(ctx, device="cpu")
        a_st = bu.generate_spd_panels_on_device(dev, A, seed=0)
        a = bu.assemble_dense(a_st, 1, A.nt, nb, N).numpy().astype(
            np.float64)
        tp = t_potrf.build_potrf_panels(ctx, A, dev=dev)
        tp.run()
        tp.wait()
        bu.wait_device_tiles(dev, A)
        resid = bu.potrf_residual(dev, A, a_st, block_rows=48)
        dev.flush()
        L = np.tril(_panel_dense(A)).astype(np.float64)
        assert dev.stats["spec_hits"] == A.nt - 1
        dev.stop()
    assert resid < 1e-5
    assert np.linalg.norm(L @ L.T - a) / np.linalg.norm(a) < 1e-5
    with tpt.Context(nb_workers=1) as ctx:
        A = TwoDimBlockCyclic(N, N, N, nb)
        A.register(ctx, "A")
        dev = CudaDevice(ctx, device="cpu")
        a_st = bu.generate_spd_panels_on_device(dev, A, seed=0)
        resid = bu.potrf_residual(dev, A, a_st, block_rows=48)
        dev.stop()
    t = np.tril(a)
    want = np.linalg.norm(t @ t.T - a) / np.linalg.norm(a)
    assert want > 1.0 and abs(resid - want) <= 1e-4 * want


def test_stage_collection_installs_clean_rows_of_one_stack():
    dense = _rng(4).standard_normal((64, 64)).astype(np.float32)
    with tpt.Context(nb_workers=1) as ctx:
        A = _tiled(TwoDimBlockCyclic, dense, 16)
        A.register(ctx, "A")
        dev = CudaDevice(ctx, device="cpu")
        dev.stage_collection(A)
        assert dev.stats["h2d_bytes"] == dense.nbytes
        ents = list(dev._cache.values())
        assert len(ents) == 16 and len({id(e.stack) for e in ents}) == 1
        assert not any(e.dirty for e in ents)
        got = bu.assemble_dense(bu.gather_device_tiles(dev, A), 4, 4, 16)
        np.testing.assert_array_equal(got.numpy(), dense)
        dev.stop()
