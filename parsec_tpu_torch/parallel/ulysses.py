"""Ulysses (all-to-all) sequence parallelism.

Port of parsec_tpu/parallel/ulysses.py.  Instead of rotating K/V around a
ring, reshard with one all-to-all so each rank holds the FULL sequence
for a subset of heads, run dense local attention, and all-to-all back to
sequence sharding: the reference's generic redistribute
(parsec/data_dist/matrix/redistribute/redistribute.jdf) specialized to
the uniform head<->sequence exchange.  Requires n_heads % n_sp == 0.
"""
from __future__ import annotations

from typing import Optional

from .collectives import all_to_all
from .ring_attention import blockwise_attention_reference


def ulysses_attention(q, k, v, mesh, axis: str = "sp",
                      causal: bool = False, scale: Optional[float] = None,
                      local_attn=None):
    """Exact attention with q,k,v sequence-sharded on mesh axis `axis`.

    q,k,v: this rank's shard [B, L/n, H, D]; H % mesh.shape[axis] == 0.
    `local_attn(q, k, v, causal=..., scale=...)` overrides the per-rank
    attention over the gathered sequence (e.g. ops.flash_attention, the
    CUDA kernel).  Returns this rank's shard [B, L/n, H, D]."""
    n = mesh.shape[axis]
    h = q.shape[2]
    if h % n != 0:
        raise ValueError(f"ulysses needs n_heads ({h}) divisible by "
                         f"mesh axis '{axis}' size ({n})")
    attn = local_attn if local_attn is not None else \
        blockwise_attention_reference

    # [B, L/n, H, D] -> [B, L, H/n, D]: gather sequence, split heads
    def fwd(x):
        return all_to_all(x, mesh, axis, split_dim=2, concat_dim=1)

    of = attn(fwd(q), fwd(k), fwd(v), causal=causal, scale=scale)
    # [B, L, H/n, D] -> [B, L/n, H, D]: back to sequence sharding
    return all_to_all(of, mesh, axis, split_dim=1, concat_dim=2)
