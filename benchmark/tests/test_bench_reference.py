"""Each plain reference against NumPy at a small size, its comparison on
known errors, and its lower-precision control failing the cell's
limit."""
import numpy as np
import pytest
import torch

from harness import core, lowp
from conftest import REPO


def _ref(name):
    return core.load_module(REPO, "reference", name)


def test_spotrf_inputs_are_the_seeds_spd_matrix():
    ref = _ref("spotrf")
    a = ref.inputs(7, {"N": 256}, {"NB": 64}, "cpu")["A"]
    b = ref.inputs(7, {"N": 256}, {"NB": 64}, "cpu")["A"]
    c = ref.inputs(8, {"N": 256}, {"NB": 64}, "cpu")["A"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, a.mT)
    assert np.linalg.eigvalsh(a.double().numpy()).min() > 0
    # a seed past 32 bits (the driver's are) makes inputs as well
    big = ref.inputs(2 ** 33 + 5, {"N": 128}, {"NB": 64}, "cpu")["A"]
    assert torch.isfinite(big).all()


def test_spotrf_inputs_follow_plghe():
    """dplasma_splghe with the bump N: off the diagonal uniform in
    (-0.5, 0.5], on it N plus such an entry; NB need not divide N."""
    ref = _ref("spotrf")
    n = 300
    a = ref.inputs(2 ** 31 + 9, {"N": n}, {"NB": 128}, "cpu")["A"].double()
    off = a[~torch.eye(n, dtype=torch.bool)]
    assert off.min() > -0.5 and off.max() <= 0.5
    assert abs(float(off.mean())) < 0.01
    assert float(off.var()) == pytest.approx(1 / 12, rel=0.02)
    d = a.diagonal() - n
    assert d.min() > -0.5 and d.max() <= 0.5
    assert torch.equal(a, a.mT)


def test_spotrf_reference_against_numpy():
    ref = _ref("spotrf")
    tr, cfg = {"N": 384}, {"NB": 128}
    a = ref.inputs(3, tr, cfg, "cpu")["A"].double().numpy()
    want = np.linalg.cholesky(a)
    got = ref._factor64(3, tr, cfg, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # the comparison reads 0 on the exact factor, the ratio of norms of
    # the strictly lower parts on a known one (rows blocked unevenly)
    l64 = torch.from_numpy(want)
    assert ref.offdiag_error(l64.float(), l64, rows=100) < 1e-6
    off = np.tril(want, -1)
    bad = want + 1e-3 * off
    assert ref.offdiag_error(torch.from_numpy(bad), l64, rows=100) == \
        pytest.approx(1e-3, rel=1e-9)
    # the upper triangle is not judged
    assert ref.offdiag_error(torch.from_numpy(want + np.triu(
        np.ones_like(want))), l64, rows=100) == 0.0


def test_sgemm_reference_against_numpy():
    ref = _ref("sgemm")
    tr = {"N": 256}
    x = ref.inputs(5, tr, {}, "cpu")
    want = x["A"].double().numpy() @ x["B"].double().numpy()
    got = ref._product64(5, tr, {}, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    c = torch.from_numpy(want)
    assert ref.rel_error(c * (1 + 1e-4), c) == pytest.approx(1e-4)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -13,
                      -3.0 - 2 ** -12], dtype=torch.float32)
    got = lowp.to_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]


@pytest.mark.parametrize("cell,n", [("spotrf.panel", 1024),
                                    ("spotrf.tile", 1024),
                                    ("sgemm.ptg", 512), ("sgemm.dtd", 512)])
def test_control_fails_the_cell_limit(small, cell, n):
    """The control (TF32 products, emulated on the host) reads above the
    cell's limit at a size a test run holds."""
    c = core.Cell(small, cell)
    tr, cfg = dict(c.traffic, N=n), dict(c.config, NB=128)
    ref = core.load_module(small, "reference", c.config_name)
    got = ref.control(11, tr, cfg, "cpu")
    for k, limit in c.traffic["limits"].items():
        assert got[k] > limit, (cell, k, got[k], limit)
