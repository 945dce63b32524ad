"""Per-rank programs of the port's mesh tests (tests/test_torch_parallel.py,
test_torch_models.py, test_torch_training.py).

`mesh_cases` joins a spawned rank to a gloo job on the CPU
(parallel.init_distributed) and runs the named cases in turn, each on
meshes it builds over the job's ranks; every case takes numpy inputs made
by the parent and returns numpy results (global tensors gathered back
with parallel.mesh.unshard, so the parent can hold them against the JAX
package's run on its virtual 8-device mesh).  Spawned through
test_torch_comm_workers.spmd, which asserts that no rank imported jax.
This file imports numpy, torch and parsec_tpu_torch only.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from parsec_tpu_torch import parallel as pp
from parsec_tpu_torch.convert import transformer_params, transformer_tree
from parsec_tpu_torch.models import transformer as T
from parsec_tpu_torch.models import training as TR
from parsec_tpu_torch.parallel.mesh import shard, unshard
from parsec_tpu_torch.parallel.pipeline import gpipe

def mesh_cases(rank: int, nodes: int, port: int, cases) -> dict:
    """Run `cases` ([(label, case name, kwargs)]) on this rank of a
    `nodes`-rank gloo job; returns {label: the case's result}."""
    torch.set_num_threads(1)
    pp.init_distributed(f"127.0.0.1:{port}", nodes, rank, device="cpu")
    try:
        return {label: globals()[f"case_{name}"](**kw)
                for label, name, kw in cases}
    finally:
        dist.destroy_process_group()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _mesh(**axes):
    return pp.make_mesh(device="cpu", **axes)


# ------------------------------------------------------------ parallel/*
def case_coll(xs, root: int) -> dict:
    """The front door's mesh path over sp=8: x stacks every rank's
    contribution on dim 0."""
    mesh = _mesh(sp=8)
    out = {"all_reduce": _np(pp.all_reduce(xs, mesh=mesh, axis="sp")),
           "reduce_scatter": _np(pp.reduce_scatter(xs, mesh=mesh,
                                                   axis="sp")),
           "all_gather": _np(pp.all_gather(xs, mesh=mesh, axis="sp")),
           "broadcast": _np(pp.broadcast(xs, root=root, mesh=mesh,
                                         axis="sp"))}
    try:
        pp.all_reduce(np.zeros((3, 4), np.float32), mesh=mesh, axis="sp")
        out["stack_error"] = None
    except ValueError as e:
        out["stack_error"] = str(e)
    return out


def case_seq(x_perm, x_ag, x_a2a) -> dict:
    """ring_permute, seq_all_gather / seq_reduce_scatter and
    seq_all_to_all over sp=8, each shard in and out."""
    mesh = _mesh(sp=8)
    sp0 = ("sp",)
    y = pp.ring_permute(shard(_t(x_perm), mesh, sp0), mesh, "sp", shift=1)
    g = pp.seq_all_gather(shard(_t(x_ag), mesh, sp0), mesh, "sp")
    rs = pp.seq_reduce_scatter(_t(x_ag), mesh, "sp")
    a_loc = shard(_t(x_a2a), mesh, (None, "sp"))
    a2 = pp.seq_all_to_all(a_loc, mesh, "sp", split_dim=2, concat_dim=1)
    back = pp.seq_all_to_all(a2, mesh, "sp", split_dim=1, concat_dim=2)
    return {"ring_permute": _np(unshard(y, mesh, sp0)),
            "all_gather": _np(g),
            "reduce_scatter": _np(unshard(rs, mesh, sp0)),
            "all_to_all": _np(unshard(a2, mesh, (None, None, "sp"))),
            "all_to_all_back": _np(unshard(back, mesh, (None, "sp")))}


def case_attn(q, k, v, causal: bool, kind: str) -> np.ndarray:
    """ring or ulysses attention over sp=8, q/k/v [B, L, H, D] sharded on
    L; returns the gathered output."""
    mesh = _mesh(sp=8)
    spec = (None, "sp")
    ql, kl, vl = (shard(_t(a), mesh, spec) for a in (q, k, v))
    fn = pp.ring_attention if kind == "ring" else pp.ulysses_attention
    return _np(unshard(fn(ql, kl, vl, mesh, "sp", causal=causal), mesh,
                       spec))


def case_ring_grad(q, k, v) -> list:
    """d/d(q,k,v) of sum(ring_attention(q, k, v, causal)^2): each rank
    backprops its shard's share of the sum."""
    mesh = _mesh(sp=8)
    spec = (None, "sp")
    loc = [shard(_t(a), mesh, spec).requires_grad_() for a in (q, k, v)]
    out = pp.ring_attention(*loc, mesh, "sp", causal=True)
    (out ** 2).sum().backward()
    return [_np(unshard(t.grad, mesh, spec)) for t in loc]


def case_moe(x, wg, wu, wd, k: int, capacity: int) -> np.ndarray:
    """moe_ffn over ep=8: tokens batch-sharded, experts sharded."""
    mesh = _mesh(ep=8)
    out = pp.moe_ffn(shard(_t(x), mesh, ("ep",)), _t(wg),
                     shard(_t(wu), mesh, ("ep",)),
                     shard(_t(wd), mesh, ("ep",)), mesh, "ep", k=k,
                     capacity=capacity)
    return _np(unshard(out, mesh, ("ep",)))


def _stage(params, x):
    w, b = params
    return torch.tanh(x @ w + b)


def case_gpipe(w, b, x, axes: dict, grad: bool):
    """gpipe over pp (on the first prod(axes) ranks; the others return
    None): the output, and with `grad` the gradients of sum(out^2) with
    respect to every stage's (w, b), gathered over pp."""
    mesh = _mesh(**axes)
    if not mesh.member:
        return None
    loc = [shard(_t(a), mesh, ("pp",)).requires_grad_(grad)
           for a in (w, b)]
    out = gpipe(_stage, tuple(loc), _t(x), mesh, "pp")
    res = {"out": _np(out)}
    if grad:
        (out ** 2).sum().backward()
        res["grads"] = [_np(unshard(t.grad, mesh, ("pp",))) for t in loc]
    return res


# -------------------------------------------------------------- models/*
def _model(params_np, cfg_kw):
    cfg = T.TransformerConfig(**cfg_kw)
    return cfg, transformer_params(params_np)


def _batch(mesh, cfg, tokens, targets=None):
    spec = (cfg.dp_axis, cfg.sp_axis)
    spec = tuple(a if a in mesh.shape else None for a in spec)
    toks = shard(_t(tokens).long(), mesh, spec)
    if targets is None:
        return toks
    return toks, shard(_t(targets).long(), mesh, spec)


def case_forward(params, tokens, cfg_kw, axes: dict) -> np.ndarray:
    """The sharded forward over `axes`: this rank's shards and tokens in,
    the logits gathered over (dp, sp)."""
    mesh = _mesh(**axes)
    cfg, sd = _model(params, cfg_kw)
    loc = T.shard_params(sd, cfg, mesh)
    logits = T.forward(loc, _batch(mesh, cfg, tokens), cfg, mesh)
    spec = tuple(a if a in mesh.shape else None
                 for a in (cfg.dp_axis, cfg.sp_axis))
    return _np(unshard(logits, mesh, spec))


def case_loss(params, tokens, targets, cfg_kw, axes: dict) -> float:
    """loss_fn over the mesh (the global token mean, on every rank)."""
    mesh = _mesh(**axes)
    cfg, sd = _model(params, cfg_kw)
    loc = T.shard_params(sd, cfg, mesh)
    return float(T.loss_fn(loc, _batch(mesh, cfg, tokens, targets), cfg,
                           mesh))


def _local(tree, mesh) -> dict:
    """This rank's coordinates and shards, for the parent to check that
    ranks holding the same shards hold the same bits."""
    return {"coords": {a: mesh.index(a) for a in mesh.axis_names},
            "leaves": {k: _np(t) for k, t in T.tree_items(tree)}}


def case_sgd(params, tokens, targets, cfg_kw, axes: dict, lr: float,
             steps: int) -> dict:
    """make_sharded_train_step over the mesh, `steps` times on one batch:
    the losses, the parameters after the first step (gathered) and this
    rank's shards after the last."""
    mesh = _mesh(**axes)
    cfg, sd = _model(params, cfg_kw)
    loc = T.shard_params(sd, cfg, mesh)
    step = T.make_sharded_train_step(cfg, mesh, lr=lr)
    batch = _batch(mesh, cfg, tokens, targets)
    losses, first = [], None
    for i in range(steps):
        loc, loss = step(loc, batch)
        losses.append(float(loss))
        if i == 0:
            first = transformer_tree(T.unshard_params(loc, cfg, mesh))
    return {"losses": losses, "first": first, "local": _local(loc, mesh)}


def case_pipelined(params, tokens, cfg_kw, n_mb: int):
    """pipelined_forward over pp=4 (ranks 0-3)."""
    mesh = _mesh(pp=4)
    if not mesh.member:
        return None
    cfg, sd = _model(params, cfg_kw)
    return _np(T.pipelined_forward(sd, _t(tokens).long(), cfg, mesh, "pp",
                                   n_microbatch=n_mb))


def case_train(params, batches, cfg_kw, tc_kw, axes: dict) -> dict:
    """training.train over the mesh from the given parameters: the losses,
    the final parameters (gathered) and this rank's final shards."""
    mesh = _mesh(**axes)
    cfg, sd = _model(params, cfg_kw)
    tc = TR.TrainConfig(**tc_kw)
    loc = T.shard_params(sd, cfg, mesh)
    state = {"params": loc, "opt": TR.make_optimizer(tc).init(loc),
             "step": 0}
    state, losses = TR.train(cfg, tc, [_batch(mesh, cfg, t, g)
                                       for t, g in batches], mesh=mesh,
                             state=state)
    return {"losses": losses, "step": state["step"],
            "params": transformer_tree(T.unshard_params(state["params"],
                                                        cfg, mesh)),
            "local": _local(state["params"], mesh)}
