"""Ring attention: exact long-context attention over a sequence-sharded
ring of ranks.

Port of parsec_tpu/parallel/ring_attention.py.  The communication shape
is the reference's chain-pipeline broadcast topology
(parsec/remote_dep.c:39-47): each step every rank computes blockwise
attention of its local Q against the resident K/V block while
`ppermute` rotates the K/V blocks one neighbour around the ring.
Softmax is accumulated online (running max / running sum), so the
result is exact.  Differentiable: the backward of each rotation is the
inverse rotation (parallel/collectives.py).
"""
from __future__ import annotations

from typing import Optional

import torch

from .collectives import ppermute

_NEG_BIG = -1.0e30


def blockwise_attention_reference(q, k, v, causal: bool = False,
                                  scale: Optional[float] = None):
    """Plain full attention on one device — the test oracle.

    q,k,v: [B, L, H, D] -> [B, L, H, D]; f32 math (float64 stays
    float64), the result in q's type."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("blhd,bshd->bhls", q.to(ct), k.to(ct)) * scale
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        mask = torch.arange(lk, device=s.device)[None, :] > \
            torch.arange(lq, device=s.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhls,bshd->blhd", p, v.to(ct)).to(q.dtype)


def _ring_block_step(q, k_blk, v_blk, o, m, l, q_off: int, k_off: int,
                     causal: bool, scale: float):
    """One online-softmax accumulation of q against a K/V block.

    q: [B,Lq,H,D]; k_blk,v_blk: [B,Lk,H,D]; o: [B,Lq,H,D] f32;
    m,l: [B,H,Lq] f32.  q_off/k_off are the blocks' global sequence
    offsets, for causal masking."""
    s = torch.einsum("blhd,bshd->bhls", q.float(), k_blk.float()) * scale
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        qpos = q_off + torch.arange(lq, device=s.device)
        kpos = k_off + torch.arange(lk, device=s.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))                # [B,H,Lq]
    p = torch.exp(s - m_new[..., None])                     # masked -> 0
    corr = torch.exp(m - m_new)                             # [B,H,Lq]
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhls,bshd->blhd", p, v_blk.float())
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = False,
                   scale: Optional[float] = None):
    """Exact attention with q,k,v sequence-sharded on mesh axis `axis`.

    q,k,v: this rank's shard [B, L/n, H, D] (batch and heads may be
    sharded over other axes too; the ring only rotates along `axis`).
    Returns this rank's shard of the output, [B, L/n, H, D]."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    n = mesh.shape[axis]
    r = mesh.index(axis)
    b, lc, h, _ = q.shape
    q_off = r * lc
    perm = [(i, (i + 1) % n) for i in range(n)]
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lc), _NEG_BIG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, lc), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    # n-1 compute+rotate steps, then the last block's accumulation: no
    # trailing rotation whose result is dropped
    for t in range(n - 1):
        src = (r - t) % n                 # origin block of resident K/V
        o, m, l = _ring_block_step(q, k_cur, v_cur, o, m, l, q_off,
                                   src * lc, causal, scale)
        k_cur = ppermute(k_cur, mesh, axis, perm)
        v_cur = ppermute(v_cur, mesh, axis, perm)
    o, m, l = _ring_block_step(q, k_cur, v_cur, o, m, l, q_off,
                               ((r - (n - 1)) % n) * lc, causal, scale)
    l_t = l.transpose(1, 2)[..., None]                      # [B,Lq,H,1]
    return (o / l_t.clamp_min(1e-30)).to(q.dtype)
