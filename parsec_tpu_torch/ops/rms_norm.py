"""Fused RMSNorm: a hand-written CUDA kernel (kernels/rms_norm.cu) for
tensors on the card, its plain PyTorch version for tensors on the CPU.

Port of parsec_tpu/ops/rms_norm.py, whose Pallas kernel _rms_kernel the
CUDA kernel replaces.  Forward is the kernel; backward is torch ops
through a torch.autograd.Function, as the reference's backward is plain
jnp (_rms_vjp_bwd).  The kernel is CUDA C++ rather than Triton so that
the port keeps one toolchain (nvcc) for all of its kernels.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def rms_norm_plain(x2d: torch.Tensor, w: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch: per row,
    y = (x * rsqrt(mean(x^2) + eps)) cast to x's type, times w, in x's
    type (the order of the reference kernel)."""
    xf = x2d.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return ((xf * r).to(x2d.dtype) * w).to(x2d.dtype)


def rms_norm_cuda(x2d: torch.Tensor, w: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Launch the CUDA kernel on x2d [n, d] and w [d] (both on the card,
    contiguous; w of x's type or float32) on the current stream."""
    if x2d.dim() != 2 or w.dim() != 1 or w.shape[0] != x2d.shape[1]:
        raise ValueError(f"rms_norm_cuda: x {tuple(x2d.shape)}, "
                         f"w {tuple(w.shape)}")
    if x2d.device.type != "cuda" or w.device != x2d.device:
        raise ValueError("rms_norm_cuda: x and w must be on one card")
    if x2d.dtype not in _DTYPE_CODES or w.dtype not in (x2d.dtype,
                                                        torch.float32):
        raise TypeError(f"rms_norm_cuda: x {x2d.dtype}, w {w.dtype}")
    x2d = x2d.contiguous()
    w = w.contiguous()
    y = torch.empty_like(x2d)
    lib = kernels.load("rms_norm")
    fn = lib.ptc_rms_norm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    rc = fn(x2d.data_ptr(), w.data_ptr(), y.data_ptr(), x2d.shape[0],
            x2d.shape[1], eps, _DTYPE_CODES[x2d.dtype],
            _DTYPE_CODES[w.dtype],
            torch.cuda.current_stream(x2d.device).cuda_stream)
    kernels.check(lib, "rms_norm", rc)
    kernels.count_launch("rms_norm")
    return y


def _rms_fwd(x2d, w, eps):
    """The kernel for tensors on the card, the plain version for tensors
    on the CPU; anything else raises."""
    if x2d.device.type == "cuda":
        return rms_norm_cuda(x2d, w, eps)
    if x2d.device.type == "cpu":
        return rms_norm_plain(x2d, w, eps)
    raise ValueError(f"rms_norm: unsupported device {x2d.device}")


class _RMS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w, eps):
        ctx.save_for_backward(x2d, w)
        ctx.eps = eps
        return _rms_fwd(x2d, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        xf, gf, wf = x.float(), g.float(), w.float()
        r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + ctx.eps)
        gw = gf * wf
        d = x.shape[-1]
        # dx = r*gw - x * (sum(gw*x)/d) * r^3   (d/dx of x*rsqrt(mean x^2))
        dx = r * gw - xf * ((gw * xf).sum(dim=-1, keepdim=True) / d) \
            * r ** 3
        dw = (gf * (xf * r)).sum(dim=0)
        return dx.to(x.dtype), dw.to(w.dtype), None


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             block_rows: int = 128) -> torch.Tensor:
    """y = x / sqrt(mean(x^2, -1) + eps) * w over the last dim.

    Any leading shape.  Takes the plain expression (not the kernel) when
    the row count does not fill whole blocks of `block_rows` or the last
    dim is not a multiple of 128, as the reference wrapper does."""
    d = x.shape[-1]
    lead = x.shape[:-1]
    n = 1
    for s in lead:
        n *= s
    if n % block_rows or d % 128:
        xf = x.float()
        ms = xf.square().mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * w
    out = _RMS.apply(x.reshape(n, d), w, eps)
    return out.reshape(*lead, d)


# ------------------------------------------------------------ PTG builder
def build_rms_norm(ctx, Xc, Wc, Oc, eps: float = 1e-6, dev=None,
                   names=("RNX", "RNW", "RNO")):
    """Tile-granular RMSNorm as a PTG taskpool: NORM(r) normalizes row
    tile r of `Xc` against the shared scale tile `Wc` into `Oc` (one task
    per row block, fully parallel).

    Xc/Oc: (R*T, d) collections tiled (T, d); Wc: one (1, d) tile.
    Registers the collections under `names`.  With `dev` (a CudaDevice),
    the chore is rms_norm over a wave's lanes — one kernel launch for
    the wave, the scale tile shared at lane stride 0; the CPU body is the
    numpy reference."""
    import numpy as np

    import parsec_tpu_torch as pt

    assert Xc.mt == Oc.mt and Xc.mb == Oc.mb and Xc.nb == Oc.nb
    xn, wn, on = names
    Xc.register(ctx, xn)
    Wc.register(ctx, wn)
    Oc.register(ctx, on)
    tp = pt.Taskpool(ctx, globals={"R": Xc.mt - 1})
    r = pt.L("r")
    shp = (Xc.mb, Xc.nb)
    wshp = (Wc.mb, Wc.nb)
    dt = Xc.dtype

    tc = tp.task_class("NORM")
    tc.param("r", 0, pt.G("R"))
    tc.affinity(xn, r, 0)
    tc.flow("X", "READ", pt.In(pt.Mem(xn, r, 0)))
    tc.flow("W", "READ", pt.In(pt.Mem(wn, 0, 0)))
    tc.flow("O", "RW", pt.In(pt.Mem(on, r, 0)),
            pt.Out(pt.Mem(on, r, 0)))

    if dev is not None:
        def k_norm(x, w):
            # x [lanes, T, d]; w [lanes, 1, d], the one scale tile
            return rms_norm(x, w[0, 0], eps)

        dev.attach(tc, tp, kernel=k_norm, reads=["X", "W"],
                   writes=["O"],
                   shapes={"X": shp, "W": wshp, "O": shp}, dtype=dt)

    def body(t):
        x = t.data("X", dt, shp).astype(np.float32)
        w = t.data("W", dt, wshp)[0].astype(np.float32)
        o = t.data("O", dt, shp)
        ms = np.mean(np.square(x), axis=-1, keepdims=True)
        o[...] = (x / np.sqrt(ms + eps) * w).astype(dt)

    tc.body(body, pure=True)
    return tp
