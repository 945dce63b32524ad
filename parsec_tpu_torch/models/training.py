"""Training harness for the model families: optimization, gradient
clipping, LR schedules, periodic checkpointing.

Port of parsec_tpu/models/training.py.  The reference's optimizer is
optax's chain clip_by_global_norm -> adamw(warmup_cosine_decay_schedule);
`AdamW` rebuilds it in torch with the same arithmetic, in the same order:
  clip  scale every gradient by max_norm / norm (as (g / norm) * max_norm)
        only when the global norm >= max_norm
  adam  mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, bias-corrected
        by 1 - b^(count+1); update mu_hat / (sqrt(nu_hat) + eps)
  wd    + weight_decay * param (decoupled)
  lr    * -schedule(count): linear warmup from 0, then cosine decay to 0
        (the first update runs at lr 0)
It updates the parameters and moments in place, where they lie, for
memory.  With a mesh the state holds this rank's shards
(transformer.shard_params), the gradients are synced over the data axes
and the clip's global norm sums each shard's squares over the axes that
shard it, so every rank applies the same update to its shards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..checkpoint import load_train_state, save_train_state
from ..parallel.collectives import _all_reduce
from ..parallel.mesh import rank_device
from .transformer import (Transformer, TransformerConfig, as_tree,
                          init_params, param_shardings, shard_params,
                          tree_from_items, tree_items, value_and_grad)


@dataclass
class TrainConfig:
    lr: float = 1e-3
    warmup_steps: int = 100
    total_steps: int = 1000
    clip_norm: float = 1.0
    weight_decay: float = 0.0
    ckpt_path: Optional[str] = None
    ckpt_every: int = 0          # 0 = never


def warmup_cosine_lr(tc: TrainConfig) -> Callable[[int], np.float32]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1)) in float32: count -> learning rate."""
    f32 = np.float32
    warm = tc.warmup_steps
    decay = max(tc.total_steps, warm + 1) - warm

    def lr(count: int) -> np.float32:
        if count < warm:
            frac = f32(1) - f32(max(count, 0)) / f32(warm)
            return f32(0.0 - tc.lr) * frac + f32(tc.lr)
        c = f32(min(count - warm, decay))
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
        return f32(tc.lr) * cos

    return lr


class AdamW:
    """optax.chain(clip_by_global_norm(clip_norm), adamw(schedule,
    weight_decay)) over a parameter tree (see the module docstring).

    `leaf_sq(path, g)`: a gradient leaf's share of the squared global
    norm (by default its sum of squares; with a mesh, summed over the
    axes that shard the leaf)."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, tc: TrainConfig,
                 leaf_sq: Optional[Callable] = None):
        self.tc = tc
        self.lr = warmup_cosine_lr(tc)
        self.leaf_sq = leaf_sq or (lambda path, g: g.square().sum())

    def init(self, params) -> dict:
        items = list(tree_items(as_tree(params)))
        return {"count": 0,
                "mu": tree_from_items((k, torch.zeros_like(t))
                                      for k, t in items),
                "nu": tree_from_items((k, torch.zeros_like(t))
                                      for k, t in items)}

    @torch.no_grad()
    def step(self, params, grads: dict, state: dict) -> None:
        """One update of `params` and `state` in place."""
        f32 = np.float32
        g = dict(tree_items(grads))
        norm = torch.sqrt(sum(self.leaf_sq(k, v) for k, v in g.items()))
        clip = not bool(norm < self.tc.clip_norm)
        mu, nu = dict(tree_items(state["mu"])), dict(tree_items(state["nu"]))
        n = state["count"] + 1
        bc1 = f32(1) - f32(self.b1) ** f32(n)
        bc2 = f32(1) - f32(self.b2) ** f32(n)
        step_size = -self.lr(state["count"])
        for k, p in tree_items(as_tree(params)):
            gk = g[k]
            if clip:
                gk = (gk / norm.to(gk.dtype)) * self.tc.clip_norm
            mu[k].mul_(self.b1).add_((1 - self.b1) * gk)
            nu[k].mul_(self.b2).add_((1 - self.b2) * gk.square())
            u = (mu[k] / float(bc1)) / (torch.sqrt(nu[k] / float(bc2))
                                        + self.eps)
            u = u + self.tc.weight_decay * p
            p.add_(float(step_size) * u)
        state["count"] = n


def make_optimizer(tc: TrainConfig, cfg: Optional[TransformerConfig] = None,
                   mesh=None) -> AdamW:
    """The optimizer; with a mesh (and the model's cfg), its clip sums
    each shard's squares over the axes that shard it."""
    if mesh is None:
        return AdamW(tc)
    specs = dict(tree_items(param_shardings(cfg)))

    def leaf_sq(path, g):
        sq = g.square().sum()
        for a in specs[path]:
            if a is not None and mesh.shape.get(a, 1) > 1:
                sq = _all_reduce(sq, mesh, a)
        return sq

    return AdamW(tc, leaf_sq)


def init_train_state(cfg: TransformerConfig, tc: TrainConfig,
                     key: torch.Generator, device=None, mesh=None) -> dict:
    """{"params", "opt", "step"}: params drawn from `key` on `device` (by
    default this process's card); with a mesh, every rank draws the same
    and keeps its shards."""
    if mesh is not None:
        params = shard_params(init_params(cfg, key, mesh.device), cfg, mesh)
    else:
        params = init_params(cfg, key, device)
    return {"params": params, "opt": make_optimizer(tc).init(params),
            "step": 0}


def make_train_step(cfg: TransformerConfig, tc: TrainConfig, mesh=None):
    """step(state, batch) -> (state, loss): the gradient of loss_fn, the
    optimizer's update of `state` in place.  With a mesh, state and
    batch are this rank's (tokens [B/dp, S/sp])."""
    opt = make_optimizer(tc, cfg, mesh)

    def step(state, batch):
        loss, grads = value_and_grad(state["params"], batch, cfg, mesh)
        opt.step(state["params"], grads, state["opt"])
        state["step"] += 1
        return state, loss

    return step


def train(cfg: TransformerConfig, tc: TrainConfig, batches: Iterable,
          mesh=None, key: Optional[torch.Generator] = None, state=None,
          on_step: Optional[Callable[[int, float], None]] = None,
          device=None):
    """Run the loop over `batches`; returns the final state and losses.

    Resume: pass `state` (e.g. from resume_train_state).  Checkpoints are
    written every tc.ckpt_every steps to tc.ckpt_path."""
    if state is None:
        if key is None:
            key = torch.Generator(device=rank_device(
                mesh.device if mesh is not None else device))
            key.manual_seed(0)
        state = init_train_state(cfg, tc, key, device, mesh)
    step_fn = make_train_step(cfg, tc, mesh)
    losses = []
    n = state["step"]
    for batch in batches:
        state, loss = step_fn(state, batch)
        losses.append(loss)
        n += 1
        if on_step:
            on_step(n, float(loss))
        if tc.ckpt_path and tc.ckpt_every and n % tc.ckpt_every == 0:
            save_train_state(tc.ckpt_path, state)
    return state, [float(l) for l in losses]


def resume_train_state(cfg: TransformerConfig, tc: TrainConfig, path: str,
                       device=None) -> dict:
    """A state of init_train_state's structure (on `device`, by default
    this process's card) loaded from a checkpoint; no weights drawn."""
    params = Transformer(cfg, device=device)
    like = {"params": params, "opt": make_optimizer(tc).init(params),
            "step": 0}
    return load_train_state(path, like)
