"""The port's ops (parsec_tpu_torch.ops) against the JAX package's
(parsec_tpu.ops, Pallas kernels in interpret mode) on identical inputs
made from a numpy seed and carried across by parsec_tpu_torch.convert.
On the CPU each port wrapper runs its kernel's plain PyTorch version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsec_tpu.ops import flash_attention as jax_flash
from parsec_tpu.ops import rms_norm as jax_rms
from parsec_tpu_torch.convert import to_numpy, to_tensor
from parsec_tpu_torch.ops import flash_attention, rms_norm


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs its files in parallel
    worker processes, and an intra-op pool per worker would oversubscribe
    the host under the timing-sensitive tests of the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# ----------------------------------------------------------------- RMSNorm
def test_rms_norm_f32_matches_jax():
    x, w = _normal(0, (256, 128)), _normal(1, (128,))
    ref = jax_rms(jnp.asarray(x), jnp.asarray(w), interpret=True)
    out = rms_norm(to_tensor(x), to_tensor(w))
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_rms_norm_bf16_matches_jax():
    """bf16 in both, to 1.6e-2 relative (two bf16 ulps): the f32 row sums
    are taken in another order, which can move one bf16 rounding."""
    x = jnp.asarray(_normal(2, (2, 128, 256)), jnp.bfloat16)
    w = jnp.asarray(_normal(3, (256,)), jnp.bfloat16)
    ref = jax_rms(x, w, interpret=True)
    out = rms_norm(to_tensor(np.asarray(x)), to_tensor(np.asarray(w)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(out),
                               np.asarray(ref, np.float32),
                               rtol=1.6e-2, atol=1e-2)


@pytest.mark.parametrize("shape", [(3, 33, 64), (5, 128), (256, 96),
                                   (2, 64, 256)])
def test_rms_norm_fallback_and_leading_shapes(shape):
    """Row count not a block multiple, or d % 128: the plain expression;
    otherwise the kernel path — any leading shape, as the reference."""
    x, w = _normal(4, shape), _normal(5, shape[-1:])
    ref = jax_rms(jnp.asarray(x), jnp.asarray(w), interpret=True)
    out = rms_norm(to_tensor(x), to_tensor(w))
    assert tuple(out.shape) == shape
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d", [128, 64])
def test_rms_norm_gradients_match_jax(d):
    x, w = _normal(6, (256, d)), _normal(7, (d,)) + 1.0

    def jloss(x, w):
        return jnp.sum(jnp.sin(jax_rms(x, w, interpret=True)))

    gx, gw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = to_tensor(x).requires_grad_()
    wt = to_tensor(w).requires_grad_()
    torch.sin(rms_norm(xt, wt)).sum().backward()
    np.testing.assert_allclose(to_numpy(xt.grad), np.asarray(gx),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_numpy(wt.grad), np.asarray(gw),
                               rtol=1e-4, atol=1e-5)


# --------------------------------------------------------- flash attention
def _qkv(shape, seed):
    return tuple(_normal(seed + i, shape) for i in range(3))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax(causal):
    q, k, v = _qkv((1, 256, 2, 64), 10)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, block_q=128, block_k=128, interpret=True)
    out = flash_attention(to_tensor(q), to_tensor(k), to_tensor(v),
                          causal=causal, block_q=128, block_k=128)
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_flash_attention_small_seq_fallback():
    q, k, v = _qkv((2, 32, 2, 64), 20)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, interpret=True)
    out = flash_attention(to_tensor(q), to_tensor(k), to_tensor(v),
                          causal=True)
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_flash_attention_non_dividing_blocks_raise():
    q, k, v = _qkv((1, 200, 1, 32), 30)
    with pytest.raises(ValueError):
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  interpret=True)
    with pytest.raises(ValueError, match="must divide by blocks"):
        flash_attention(to_tensor(q), to_tensor(k), to_tensor(v))


def test_flash_attention_gradients_match_jax():
    q, k, v = _qkv((1, 128, 1, 32), 40)

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=True, interpret=True) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [to_tensor(a).requires_grad_() for a in (q, k, v)]
    (flash_attention(*ts, causal=True) ** 2).sum().backward()
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(to_numpy(t.grad), np.asarray(g),
                                   rtol=1e-4, atol=1e-4)


def test_flash_lanes_with_shared_kv_match_jax():
    """The FATT chore's form: query blocks as lanes over ONE K/V passed at
    lane stride 0 — each lane equals the JAX kernel on that block."""
    from parsec_tpu_torch.ops.flash_attention import flash_fwd
    q = _normal(50, (3, 128, 32))
    k, v = _normal(51, (128, 32)), _normal(52, (128, 32))
    kt = to_tensor(k).unsqueeze(0).expand(3, 128, 32)
    vt = to_tensor(v).unsqueeze(0).expand(3, 128, 32)
    assert kt.stride(0) == 0
    out = to_numpy(flash_fwd(to_tensor(q), kt, vt, False, 32 ** -0.5))
    for i in range(3):
        ref = jax_flash(jnp.asarray(q[i])[None, :, None, :],
                        jnp.asarray(k)[None, :, None, :],
                        jnp.asarray(v)[None, :, None, :], interpret=True)
        np.testing.assert_allclose(out[i], np.asarray(ref)[0, :, 0, :],
                                   rtol=2e-5, atol=2e-5)


# ------------------------------------- the flash kernel's split-TF32 products
def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest, ties
    away from zero, on the 13 low mantissa bits of the float32 view."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, passes):
    """a @ b with TF32 operands and f32 sums.  One pass is big*big; three
    add small*big and big*small, x = big + small with big = tf32(x) and
    small = tf32(x - big): the kernel's 3xTF32 products."""
    ab, bb = _tf32(a), _tf32(b)
    out = torch.matmul(ab, bb)
    if passes == 3:
        a_s, b_s = _tf32(a - ab), _tf32(b - bb)
        out = torch.matmul(a_s, bb) + torch.matmul(ab, b_s) + out
    return out


def _tf32_attention(q, k, v, scale, passes):
    """The kernel's arithmetic over one kv tile: S and P V as TF32
    products, the softmax in f32, P normalised by its row sum last."""
    s = _tf32_matmul(q, k.transpose(-1, -2), passes) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return _tf32_matmul(p, v, passes) / p.sum(dim=-1, keepdim=True)


@pytest.mark.parametrize("q_scale", [1.0, 4.0])
def test_split_tf32_attention_holds_the_reference_tolerance(q_scale):
    """Three TF32 passes hold the JAX reference's 2e-5 on [2 lanes, 256,
    128], with q as drawn and scaled by 4 (peaked rows); one pass, which
    keeps 11 bits of each operand, misses it: the reason for the split."""
    q, k, v = _qkv((1, 256, 2, 128), 60)
    q = q * np.float32(q_scale)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), block_q=128, block_k=128,
                               interpret=True))[0].transpose(1, 0, 2)
    qt, kt, vt = (to_tensor(a)[0].transpose(0, 1).contiguous()
                  for a in (q, k, v))
    three = to_numpy(_tf32_attention(qt, kt, vt, 128 ** -0.5, 3))
    np.testing.assert_allclose(three, ref, rtol=2e-5, atol=2e-5)
    one = to_numpy(_tf32_attention(qt, kt, vt, 128 ** -0.5, 1))
    assert not np.allclose(one, ref, rtol=2e-5, atol=2e-5)


def test_wrappers_refuse_cuda_kernels_on_cpu_tensors():
    """The CUDA entry points take only tensors on the card: a CPU tensor
    is refused, never run some other way."""
    from parsec_tpu_torch.ops.flash_attention import flash_attention_cuda
    from parsec_tpu_torch.ops.rms_norm import rms_norm_cuda
    x = torch.zeros(128, 128)
    with pytest.raises(ValueError):
        rms_norm_cuda(x, torch.ones(128), 1e-6)
    with pytest.raises(ValueError):
        flash_attention_cuda(x[None], x[None], x[None], False, 1.0)
