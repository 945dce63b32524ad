"""Flash attention: a hand-written CUDA kernel (kernels/flash_attention.cu)
for tensors on the card, its plain PyTorch version for tensors on the CPU.

Port of parsec_tpu/ops/flash_attention.py, whose Pallas kernel _fa_kernel
the CUDA kernel replaces.  The kernel computes softmax(QK^T * scale
[+ causal mask]) V blockwise with the online-softmax recurrence in f32;
no [L, L] score matrix is materialised.  `flash_attention` is
differentiable: backward recomputes through the plain reference, as the
reference's _flash_vjp_bwd does.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (32, 64, 128)
_KERNEL_BLOCK = 64  # Lq and Lk must be multiples of this


def attention_reference(q, k, v, causal: bool, scale: float):
    """Plain softmax attention over lanes: q [n, Lq, D], k/v [n, Lk, D],
    f32 math, result in q's type (the reference's _reference)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        mask = torch.arange(lk, device=s.device)[None, :] > \
            torch.arange(lq, device=s.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def flash_attention_cuda(q, k, v, causal: bool, scale: float):
    """Launch the CUDA kernel: q [n, Lq, D], k/v [n, Lk, D] on one card,
    one dtype, Lq and Lk multiples of 64, D in (32, 64, 128).  The kernel
    reads each lane as a contiguous [L, D] block at a lane stride, which
    may be 0 (k/v shared by every lane), 16-byte aligned (it stages K/V
    with 16-byte async copies); other layouts are copied into that one
    first.  Returns o [n, Lq, D]."""
    n, lq, d = q.shape
    lk = k.shape[1]
    qkv = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3 or t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} must be 3-D on "
                             f"q's card, got {tuple(t.shape)} on {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash_attention_cuda: {name} is {t.dtype}")
        if t.stride(2) != 1 or t.stride(1) != t.shape[2]:
            t = t.contiguous()
        if t.data_ptr() % 16 or t.stride(0) * t.element_size() % 16:
            t = t.clone(memory_format=torch.contiguous_format)
        qkv.append(t)
    q, k, v = qkv
    if k.shape != v.shape or k.shape[0] != n or k.shape[2] != d:
        raise ValueError("flash_attention_cuda: k/v shapes "
                         f"{tuple(k.shape)}/{tuple(v.shape)} vs q "
                         f"{tuple(q.shape)}")
    if d not in _HEAD_DIMS or lq % _KERNEL_BLOCK or lk % _KERNEL_BLOCK:
        raise ValueError(f"flash_attention_cuda: head dim {d} (need one "
                         f"of {_HEAD_DIMS}), lengths {lq}/{lk} (need "
                         f"multiples of {_KERNEL_BLOCK})")
    o = torch.empty((n, lq, d), dtype=q.dtype, device=q.device)
    lib = kernels.load("flash_attention")
    fn = lib.ptc_flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), n, lq,
            lk, d, q.stride(0), k.stride(0), v.stride(0), scale,
            1 if causal else 0, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(lib, "flash_attention", rc)
    kernels.count_launch("flash_attention")
    return o


def kernel_occupancy(dtype, d: int):
    """(shared memory bytes a block, threads a block, blocks resident on
    one SM) of the kernel's instantiation for `dtype` and head dim `d`,
    from the CUDA runtime on the current card."""
    lib = kernels.load("flash_attention")
    fn = lib.ptc_flash_attention_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + \
        [ctypes.POINTER(ctypes.c_int)] * 3
    smem, threads, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    kernels.check(lib, "flash_attention",
                  fn(d, _DTYPE_CODES[dtype], ctypes.byref(smem),
                     ctypes.byref(threads), ctypes.byref(blocks)))
    return smem.value, threads.value, blocks.value


def flash_fwd(q, k, v, causal: bool, scale: float):
    """The kernel for tensors on the card, the plain version for tensors
    on the CPU; anything else raises."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal, scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return flash_fwd(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        # recompute-backward through the mathematically identical reference
        with torch.enable_grad():
            qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
            out = attention_reference(qr, kr, vr, ctx.causal, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (qr, kr, vr), g)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128):
    """Fused blockwise attention.  q,k,v: [B, L, H, D] -> [B, L, H, D].

    Takes the plain reference when L is smaller than one block, and
    raises ValueError when L does not divide by the blocks, as the
    reference wrapper does."""
    b, l, h, d = q.shape
    scale = (d ** -0.5) if scale is None else scale

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, l, d)

    if l < block_q or l < block_k:
        return attention_reference(fold(q), fold(k), fold(v), causal,
                                   scale).reshape(b, h, l, d) \
            .permute(0, 2, 1, 3)
    if l % block_q or l % block_k:
        raise ValueError(f"seq len {l} must divide by blocks "
                         f"({block_q}, {block_k})")
    out = _Flash.apply(fold(q), fold(k), fold(v), causal, scale)
    return out.reshape(b, h, l, d).permute(0, 2, 1, 3)


# ------------------------------------------------------------ PTG builder
def build_flash_attention(ctx, Qc, Kc, Vc, Oc, causal: bool = False,
                          scale: Optional[float] = None, dev=None,
                          names=("FAQ", "FAK", "FAV", "FAO")):
    """Blockwise attention as a PTG taskpool: FATT(q) attends row block
    q of `Qc` over the full `Kc`/`Vc` into `Oc` (one task per query
    block, fully parallel; block-level causality masks by absolute row).

    Qc/Oc: (B*L, d) collections tiled (T, d); Kc/Vc: one (L, d) tile
    each.  Registers the collections under `names`.  With `dev` (a
    CudaDevice), the chore runs a wave of FATT tasks as ONE flash-kernel
    launch, the wave's query blocks as lanes over the shared K/V (lane
    stride 0); the CPU body is the numpy reference."""
    import numpy as np

    import parsec_tpu_torch as pt

    assert Qc.mt == Oc.mt and Qc.mb == Oc.mb and Qc.nb == Oc.nb
    qn, kn, vn, on = names
    Qc.register(ctx, qn)
    Kc.register(ctx, kn)
    Vc.register(ctx, vn)
    Oc.register(ctx, on)
    tp = pt.Taskpool(ctx, globals={"NQ": Qc.mt - 1})
    q = pt.L("q")
    T, d = Qc.mb, Qc.nb
    L = Kc.mb
    sc = (d ** -0.5) if scale is None else scale
    qshp, kshp = (T, d), (L, d)
    dt = Qc.dtype

    tc = tp.task_class("FATT")
    tc.param("q", 0, pt.G("NQ"))
    tc.affinity(qn, q, 0)
    tc.flow("Q", "READ", pt.In(pt.Mem(qn, q, 0)))
    tc.flow("K", "READ", pt.In(pt.Mem(kn, 0, 0)))
    tc.flow("V", "READ", pt.In(pt.Mem(vn, 0, 0)))
    tc.flow("O", "RW", pt.In(pt.Mem(on, q, 0)),
            pt.Out(pt.Mem(on, q, 0)))

    if dev is not None:
        if causal:
            raise ValueError(
                "build_flash_attention: causal device chores need the "
                "per-block row offset; use the CPU bodies (dev=None)")

        def k_fatt(qb, kb, vb):
            # qb [lanes, T, d]; kb/vb [lanes, L, d]
            if qb.shape[1] == kb.shape[1]:
                # the lanes as heads: [1, T, lanes, d] through the wrapper
                o = flash_attention(qb.unsqueeze(0).transpose(1, 2),
                                    kb.unsqueeze(0).transpose(1, 2),
                                    vb.unsqueeze(0).transpose(1, 2),
                                    causal=False, scale=sc)
                return o[0].transpose(0, 1)
            # T != L (a multi-block Q attending the full K/V tile): the
            # blockwise softmax runs directly — the op order of the CPU
            # reference body
            s = torch.matmul(qb, kb.transpose(-1, -2)) * sc
            s = s - s.amax(dim=-1, keepdim=True)
            p = torch.exp(s)
            p = p / p.sum(dim=-1, keepdim=True)
            return torch.matmul(p, vb).to(qb.dtype)

        dev.attach(tc, tp, kernel=k_fatt, reads=["Q", "K", "V"],
                   writes=["O"],
                   shapes={"Q": qshp, "K": kshp, "V": kshp, "O": qshp},
                   dtype=dt)

    def body(t):
        qb = t.data("Q", dt, qshp).astype(np.float32)
        kb = t.data("K", dt, kshp).astype(np.float32)
        vb = t.data("V", dt, kshp).astype(np.float32)
        o = t.data("O", dt, qshp)
        s = (qb @ kb.T) * sc
        if causal:
            off = t.local("q") * T
            rows = off + np.arange(T)[:, None]
            s = np.where(rows >= np.arange(L)[None, :], s, -np.inf)
        s = s - s.max(axis=-1, keepdims=True)
        p = np.exp(s)
        p /= p.sum(axis=-1, keepdims=True)
        o[...] = (p @ vb).astype(dt)

    tc.body(body, pure=True)
    return tp
