"""Expert parallelism: MoE feed-forward with experts sharded over an
`ep` mesh axis.

Port of parsec_tpu/parallel/expert.py: the GShard dispatch/combine
pattern — capacity-bounded top-k routing, one all-to-all to ship token
slices to expert owners (redistribute.jdf's collection->collection
reshard), batched expert products, and the inverse all-to-all home.
Overflow tokens are dropped, exactly as GShard capacity semantics
prescribe, in the reference's order (positions by cumsum over tokens,
choice s=0 of every token before choice s=1).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F

from .collectives import all_to_all

# jax.nn.gelu's default form
gelu = partial(F.gelu, approximate="tanh")


def _top_k(probs, k: int):
    """lax.top_k: the k largest, descending, ties to the lower index (a
    stable sort; torch.topk leaves the order of ties open)."""
    vals, idxs = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idxs[..., :k]


def _dispatch_combine(logits, k: int, capacity: int):
    """Top-k capacity-bounded routing tables.

    logits: [T, E] -> dispatch [T, E, C] (0/1), combine [T, E, C] (gate
    weights).  Tokens beyond an expert's capacity are dropped (their
    combine rows are zero)."""
    t_, e_ = logits.shape
    probs = torch.softmax(logits, dim=-1)
    vals, idxs = _top_k(probs, k)                       # [T, k]
    vals = vals / vals.sum(dim=-1, keepdim=True)

    dispatch = logits.new_zeros((t_, e_, capacity), dtype=torch.float32)
    combine = logits.new_zeros((t_, e_, capacity), dtype=torch.float32)
    counts = torch.zeros((e_,), dtype=torch.int64, device=logits.device)
    for s in range(k):                                  # k is tiny
        e_sel = idxs[:, s]                              # [T]
        onehot = F.one_hot(e_sel, e_)                   # [T, E] int64
        # position of each token within its expert's buffer
        pos = counts[None, :] + torch.cumsum(onehot, dim=0) - onehot
        pos_t = (pos * onehot).sum(dim=-1)              # [T]
        keep = (pos_t < capacity).to(torch.float32)
        slot = (onehot.to(torch.float32) * keep[:, None])[:, :, None] * \
            F.one_hot(pos_t.clamp(max=capacity - 1),
                      capacity).to(torch.float32)[:, None, :]
        dispatch = dispatch + slot
        combine = combine + slot * vals[:, s, None, None].float()
        counts = counts + onehot.sum(dim=0)
    return dispatch, combine


def moe_ffn(x, w_gate, w_up, w_down, mesh, axis: str = "ep", k: int = 2,
            capacity_factor: float = 1.25, activation=gelu,
            capacity: Optional[int] = None):
    """Mixture-of-experts FFN, expert-parallel over mesh axis `axis`.

    x:      this rank's tokens [B_loc, S_loc, D] (routing is local per
            rank, hierarchical EP when sequence is sp-sharded too)
    w_gate: [D, E]          the router, replicated
    w_up:   [E/n, D, F]     this rank's experts (E = n * E_loc)
    w_down: [E/n, F, D]
    Returns this rank's [B_loc, S_loc, D]."""
    n = mesh.shape[axis]
    e_total = w_up.shape[0] * n
    bl, sl, dm = x.shape
    t_loc = max(1, bl * sl)
    cap = capacity if capacity is not None else max(
        1, int(capacity_factor * k * t_loc / e_total))
    tok = x.reshape(bl * sl, dm)
    dispatch, combine = _dispatch_combine(tok @ w_gate, k, cap)
    # [T,E,C] x [T,D] -> [E,C,D]: per-expert send buffers
    send = torch.einsum("tec,td->ecd", dispatch.to(tok.dtype), tok)
    # ship slices to expert owners: [E, C, D] -> [E_loc, n*C, D]
    recv = all_to_all(send, mesh, axis, split_dim=0, concat_dim=1)
    h = activation(torch.einsum("ecd,edf->ecf", recv, w_up))
    out = torch.einsum("ecf,efd->ecd", h, w_down)
    # inverse all-to-all: [E_loc, n*C, D] -> [E, C, D]
    back = all_to_all(out, mesh, axis, split_dim=1, concat_dim=0)
    y = torch.einsum("tec,ecd->td", combine.to(back.dtype), back)
    return y.reshape(bl, sl, dm).to(x.dtype)


def moe_ffn_reference(x, w_gate, w_up, w_down, k: int = 2,
                      activation=gelu):
    """Dense single-device oracle: every token runs its top-k experts with
    no capacity limit."""
    b, s_len, d = x.shape
    tok = x.reshape(-1, d)
    probs = torch.softmax(tok @ w_gate, dim=-1)
    vals, idxs = _top_k(probs, k)
    vals = vals / vals.sum(dim=-1, keepdim=True)
    h = activation(torch.einsum("td,edf->tef", tok, w_up))
    outs = torch.einsum("tef,efd->ted", h, w_down)      # [T, E, D]
    y = torch.zeros_like(tok)
    for s in range(k):
        y = y + vals[:, s, None] * torch.gather(
            outs, 1, idxs[:, s, None, None].expand(-1, 1, d))[:, 0]
    return y.reshape(b, s_len, d)
