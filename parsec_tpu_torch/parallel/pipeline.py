"""Pipeline parallelism: a GPipe-style microbatch pipeline over a `pp`
mesh axis.

Port of parsec_tpu/parallel/pipeline.py.  The reference gets pipelining
from dependency chains across ranks (SURVEY.md §2.10); this is the
explicit SPMD schedule: each pipeline stage owns a contiguous slab of
layers (its rank on `pp`), activations hop stage->stage+1 by `ppermute`,
and microbatches keep every stage busy after the fill phase —
n_microbatch + n_stages - 1 ticks, the classic GPipe schedule.  Every
rank runs every tick and selects with tensor masks, so the graph (and
the backward's collectives) is the same on every rank.
"""
from __future__ import annotations

from typing import Callable

import torch

from .collectives import ppermute, psum


def tree_map(fn, tree):
    """fn over the tensors of a nested dict / list / tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def gpipe(stage_fn: Callable, stage_params, x_mb, mesh, axis: str = "pp"):
    """Run a shape-preserving stage function as a GPipe pipeline.

    stage_fn(params_i, x) -> y   (same shape as x; one stage's layers)
    stage_params: this rank's stage, a pytree whose tensors keep the
                  leading stage dim of size 1 (stage i on pp rank i).
    x_mb:         [n_microbatch, mb, ...], the same on every pp rank.
    Returns [n_microbatch, mb, ...] — the output of the last stage, the
    same on every pp rank.
    """
    n_stages = mesh.shape[axis]
    n_mb = x_mb.shape[0]
    params_i = tree_map(lambda a: a[0], stage_params)
    s = mesh.index(axis)
    first = torch.tensor(s == 0, device=x_mb.device)
    last = torch.tensor(s == n_stages - 1, device=x_mb.device)
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    act = torch.zeros_like(x_mb[0])
    outs = torch.zeros_like(x_mb)
    for t in range(n_mb + n_stages - 1):
        # stage 0 injects microbatch t during the fill+steady phase
        if t < n_mb:
            act = torch.where(first, x_mb[t], act)
        y = stage_fn(params_i, act)
        # the last stage banks its result for microbatch t-(n_stages-1)
        if t >= n_stages - 1:
            idx = torch.tensor([t - (n_stages - 1)], device=x_mb.device)
            outs = torch.where(last, outs.index_copy(0, idx, y[None]),
                               outs)
        act = ppermute(y, mesh, axis, perm)
    # replicate the last stage's banked outputs to every pp rank
    return psum(outs * last.to(outs.dtype), mesh, axis)
