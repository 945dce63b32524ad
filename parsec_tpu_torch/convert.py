"""Carry state across from the JAX package: its arrays, as numpy, become
this package's tensors and collections, so that both packages compute on
identical inputs.

  to_tensor(a)              numpy (incl. bfloat16 from JAX) -> tensor
  to_numpy(t)               tensor -> numpy (bfloat16 widened to float32)
  to_collection(dense, mb, nb)
                            dense matrix -> TwoDimBlockCyclic (tiles filled)
  paged_lm_params(model)    a PagedLM's weights as numpy, for
                            serve.PagedLM.from_params
  transformer_params(tree)  the JAX transformer's parameter tree (numpy)
                            -> a models.transformer.Transformer state_dict
  transformer_tree(params)  its inverse: a Transformer (or its tree or
                            state_dict) -> the JAX package's nested tree
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .data.collections import TwoDimBlockCyclic


def to_tensor(a, device="cpu", dtype: Optional[torch.dtype] = None):
    """A tensor holding `a`'s values bit for bit (JAX's bfloat16 arrays,
    which numpy holds as ml_dtypes.bfloat16, keep their bits), then cast
    to `dtype` if given."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a, copy=True).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a tensor; bfloat16 is widened to float32 (numpy
    has no bfloat16 of its own)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def paged_lm_params(model) -> Dict[str, np.ndarray]:
    """The weights of a PagedLM — the JAX package's (numpy arrays) or
    this package's (tensors) — as float32 numpy arrays keyed by name
    (embed, wq, wk, wv, wo), bit for bit: what
    serve.PagedLM.from_params(cfg, params, device) loads."""
    out = {}
    for name in ("embed", "wq", "wk", "wv", "wo"):
        w = getattr(model, name)
        a = to_numpy(w) if isinstance(w, torch.Tensor) else np.asarray(w)
        out[name] = np.array(a, dtype=np.float32, copy=True)
    return out


def transformer_params(tree, device="cpu",
                       dtype: Optional[torch.dtype] = None
                       ) -> Dict[str, torch.Tensor]:
    """The JAX package's transformer parameter tree ({"embed", "ln_f",
    "blocks": {...}}, arrays as numpy) as the state_dict of this
    package's Transformer (dotted names, "blocks.wqkv"), bit for bit
    unless `dtype` casts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": to_tensor(vv, device, dtype)
                        for kk, vv in v.items()})
        else:
            out[k] = to_tensor(v, device, dtype)
    return out


def transformer_tree(params) -> dict:
    """transformer_params' inverse: a Transformer, its tree or its
    state_dict as the JAX package's nested tree of numpy arrays."""
    from .models.transformer import as_tree
    tree = as_tree(params.state_dict() if hasattr(params, "state_dict")
                   else params)
    return {k: ({kk: to_numpy(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else to_numpy(v))
            for k, v in tree.items()}


def to_collection(dense, mb: int, nb: int, dtype=None) -> TwoDimBlockCyclic:
    """A single-rank TwoDimBlockCyclic tiled (mb, nb) holding `dense`."""
    dense = np.asarray(dense)
    if dense.ndim == 1:
        dense = dense[None, :]
    c = TwoDimBlockCyclic(dense.shape[0], dense.shape[1], mb, nb,
                          dtype=dtype or dense.dtype)
    c.from_dense(dense)
    return c
