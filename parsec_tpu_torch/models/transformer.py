"""Decoder-only transformer LM, mesh-native.

Port of parsec_tpu/models/transformer.py.  The parameters keep the
reference's tree: every block tensor is STACKED on a leading n_layers
dim, and `Transformer`'s parameter names are the tree's paths (`embed`,
`ln_f`, `blocks.wqkv`, ...), so weights convert one-to-one
(convert.transformer_params) and the pipeline restacks them as the
reference does.  The functions take either a Transformer or its tree
(nested dicts of tensors, `as_tree`).

Parallelism is explicit per-rank SPMD code over a Mesh
(parallel/mesh.py), where the reference lets GSPMD derive tp from
`param_shardings`:
  dp  batch sharding: each rank holds B/dp sequences
  tp  heads and d_ff sharded: column-parallel wqkv and w1 (their input
      through `pbroadcast`), row-parallel wo and w2 followed by a psum
  sp  sequence sharding via ring attention (rotary positions offset by
      the rank's sequence shard)
  ep  experts sharded via all-to-all MoE, riding the dp axis
  pp  GPipe over the block stack (pipelined_forward)
With a mesh, `forward` and `loss_fn` take this rank's parameter shards
(`shard_params`) and its tokens [B/dp, S/sp], and `forward` returns its
logits [B/dp, S/sp, vocab]; the loss is the global token mean, the same
on every rank.  `sync_grads` sums each gradient over the data axes (dp,
sp) that do not shard its parameter.

`use_flash` and `use_pallas_norm` select the hand-written kernels
(ops.flash_attention, ops.rms_norm; their plain versions on the CPU);
`remat` recomputes each block in the backward pass
(torch.utils.checkpoint).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import _all_reduce, pbroadcast, psum
from ..parallel.expert import gelu, moe_ffn, moe_ffn_reference
from ..parallel.mesh import rank_device, shard, unshard
from ..parallel.pipeline import gpipe
from ..parallel.ring_attention import (blockwise_attention_reference,
                                       ring_attention)


@dataclass
class TransformerConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 8
    head_dim: int = 16
    n_layers: int = 4
    d_ff: int = 512
    n_experts: int = 0          # 0 = dense FFN; >0 = MoE every layer
    moe_k: int = 2
    dtype: torch.dtype = torch.float32
    use_flash: bool = False     # the flash-attention kernel, local attention
    use_pallas_norm: bool = False  # the RMSNorm kernel (ops/rms_norm)
    remat: bool = False         # recompute each block in the backward pass
    # mesh axis names (None = strategy unused)
    dp_axis: Optional[str] = "dp"
    tp_axis: Optional[str] = "tp"
    sp_axis: Optional[str] = "sp"
    ep_axis: Optional[str] = "ep"   # commonly == dp_axis


def param_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Every parameter's shape by its path, in the reference's draw
    order."""
    L, D, H, Dh, F_ = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
                       cfg.d_ff)
    shapes = {"embed": (cfg.vocab, D), "ln_f": (D,),
              "blocks.ln1": (L, D), "blocks.ln2": (L, D),
              "blocks.wqkv": (L, D, 3, H, Dh), "blocks.wo": (L, H, Dh, D)}
    if cfg.n_experts:
        E = cfg.n_experts
        shapes.update({"blocks.wg": (L, D, E), "blocks.wu": (L, E, D, F_),
                       "blocks.wd": (L, E, F_, D)})
    else:
        shapes.update({"blocks.w1": (L, D, F_), "blocks.w2": (L, F_, D)})
    return shapes


def _init_scale(cfg: TransformerConfig, path: str):
    """The reference's draw: None for ones, else the normal's scale."""
    D, H, Dh, F_ = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    return {"embed": 0.02, "ln_f": None, "blocks.ln1": None,
            "blocks.ln2": None, "blocks.wqkv": D ** -0.5,
            "blocks.wo": (H * Dh) ** -0.5, "blocks.w1": D ** -0.5,
            "blocks.w2": F_ ** -0.5, "blocks.wg": 0.02,
            "blocks.wu": D ** -0.5, "blocks.wd": F_ ** -0.5}[path]


class Transformer(nn.Module):
    """The LM's stacked parameters, named by the reference tree's paths.

    `device`: where they live, by default this process's card (raises
    without one).  With `generator` (a torch.Generator) the weights are
    drawn as the reference's init_params draws them (normals at its
    scales, ones for the norms); without, they are left uninitialized
    for a load (checkpoint.load_train_state, load_state_dict)."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dev = rank_device(device)
        self.blocks = nn.Module()
        for path, shape in param_shapes(cfg).items():
            mod, name = (self.blocks, path[7:]) if \
                path.startswith("blocks.") else (self, path)
            mod.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=cfg.dtype, device=dev)))
        if generator is not None:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for path, p in self.named_parameters():
            sc = _init_scale(self.cfg, path)
            if sc is None:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device) * sc)

    def tree(self) -> dict:
        """The parameters as the reference's nested tree."""
        out: dict = {"blocks": {}}
        for path, p in self.named_parameters():
            if path.startswith("blocks."):
                out["blocks"][path[7:]] = p
            else:
                out[path] = p
        return out

    def forward(self, tokens, mesh=None):
        return forward(self, tokens, self.cfg, mesh)


def as_tree(params) -> dict:
    """A Transformer, its nested tree or a flat state_dict as the nested
    tree {"embed", "ln_f", "blocks": {...}}."""
    if isinstance(params, Transformer):
        return params.tree()
    if isinstance(params.get("blocks"), dict):
        return params
    out: dict = {"blocks": {}}
    for k, v in params.items():
        if k.startswith("blocks."):
            out["blocks"][k[7:]] = v
        else:
            out[k] = v
    return out


def tree_items(tree):
    """(path, tensor) of a nested tree, dict keys sorted at every level
    (jax.tree_util's leaf order)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            for sub, t in tree_items(v):
                yield f"{k}.{sub}", t
        else:
            yield k, v


def tree_from_items(items) -> dict:
    out: dict = {}
    for path, t in items:
        node = out
        *head, last = path.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = t
    return out


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """Block params stacked on a leading n_layers dim, drawn from
    `generator` onto `device` (by default this process's card)."""
    return Transformer(cfg, device=device, generator=generator)


def param_shardings(cfg: TransformerConfig) -> dict:
    """PartitionSpec-like tuples mirroring the tree: tp on heads/ffn, ep
    on experts, everything else replicated."""
    tp, ep = cfg.tp_axis, cfg.ep_axis
    blocks = {"ln1": (None, None), "ln2": (None, None),
              "wqkv": (None, None, None, tp, None),
              "wo": (None, tp, None, None)}
    if cfg.n_experts:
        blocks.update({"wg": (None, None, None),
                       "wu": (None, ep, None, None),
                       "wd": (None, ep, None, None)})
    else:
        blocks.update({"w1": (None, None, tp), "w2": (None, tp, None)})
    return {"embed": (None, None), "ln_f": (None,), "blocks": blocks}


def _spec_on(spec, mesh):
    """spec with the axes the mesh lacks dropped."""
    return tuple(a if a in mesh.shape else None for a in spec)


def shard_params(params, cfg: TransformerConfig, mesh) -> dict:
    """This rank's shards of the (global) parameters, as a tree."""
    specs = dict(tree_items(param_shardings(cfg)))
    return tree_from_items(
        (path, shard(t.detach(), mesh, _spec_on(specs[path], mesh)))
        for path, t in tree_items(as_tree(params)))


def unshard_params(params_loc, cfg: TransformerConfig, mesh) -> dict:
    """The global parameters from every rank's shards (every rank calls
    it and gets the whole tree)."""
    specs = dict(tree_items(param_shardings(cfg)))
    return tree_from_items(
        (path, unshard(t.detach(), mesh, _spec_on(specs[path], mesh)))
        for path, t in tree_items(as_tree(params_loc)))


def _size(mesh, axis) -> int:
    return mesh.shape.get(axis, 1) if mesh is not None and axis else 1


def _rms_norm(x, scale, use_pallas: bool = False):
    if use_pallas:
        from ..ops import rms_norm
        return rms_norm(x, scale)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var = xf.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


def _rotary(q, k, offset: int = 0):
    """Rotary position embedding at global positions offset + [0, s)."""
    b, s, h, d = q.shape
    half = d // 2
    ct = torch.promote_types(q.dtype, torch.float32)
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=ct,
                                            device=q.device) / half))
    pos = torch.arange(offset, offset + s, dtype=ct, device=q.device)
    ang = pos[:, None] * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]

    def rot(x):
        x1, x2 = x[..., :half], x[..., half:]
        xr = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
        return xr.to(x.dtype)

    return rot(q), rot(k)


def _mm(eq: str, a, b):
    """einsum with f32 accumulation (preferred_element_type=float32), the
    result in a's type."""
    if a.dtype in (torch.float16, torch.bfloat16):
        return torch.einsum(eq, a.float(), b.float()).to(a.dtype)
    return torch.einsum(eq, a, b)


def _attention(q, k, v, cfg: TransformerConfig, mesh):
    if _size(mesh, cfg.sp_axis) > 1:
        return ring_attention(q, k, v, mesh, cfg.sp_axis, causal=True)
    if cfg.use_flash:
        from ..ops import flash_attention
        return flash_attention(q, k, v, causal=True)
    return blockwise_attention_reference(q, k, v, causal=True)


def _block(x, bp, cfg: TransformerConfig, mesh):
    tp = cfg.tp_axis if _size(mesh, cfg.tp_axis) > 1 else None
    sp = _size(mesh, cfg.sp_axis)
    h = _rms_norm(x, bp["ln1"], cfg.use_pallas_norm)
    if tp:
        h = pbroadcast(h, mesh, tp)
    qkv = _mm("bsd,dchn->bschn", h, bp["wqkv"])
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q, k = _rotary(q, k, mesh.index(cfg.sp_axis) * x.shape[1]
                   if sp > 1 else 0)
    o = _attention(q, k, v, cfg, mesh)
    a = _mm("bshn,hnd->bsd", o, bp["wo"])
    x = x + (psum(a, mesh, tp) if tp else a)
    h = _rms_norm(x, bp["ln2"], cfg.use_pallas_norm)
    if cfg.n_experts:
        if _size(mesh, cfg.ep_axis) > 1:
            if cfg.ep_axis != cfg.dp_axis:
                raise ValueError(
                    "expert parallelism rides the dp axis (tokens are "
                    f"batch-local there); got ep_axis={cfg.ep_axis!r} != "
                    f"dp_axis={cfg.dp_axis!r}")
            f = moe_ffn(h, bp["wg"], bp["wu"], bp["wd"], mesh, cfg.ep_axis,
                        k=cfg.moe_k)
        else:
            f = moe_ffn_reference(h, bp["wg"], bp["wu"], bp["wd"],
                                  k=cfg.moe_k).to(x.dtype)
    else:
        if tp:
            h = pbroadcast(h, mesh, tp)
        u = gelu(_mm("bsd,df->bsf", h, bp["w1"]))
        f = _mm("bsf,fd->bsd", u, bp["w2"])
        if tp:
            f = psum(f, mesh, tp)
    return x + f


def _blocks(x, blocks: dict, cfg: TransformerConfig, mesh):
    """Every layer of the stacked `blocks` in turn (the reference's
    lax.scan), each recomputed in backward under cfg.remat."""
    for i in range(next(iter(blocks.values())).shape[0]):
        bp = {k: v[i] for k, v in blocks.items()}
        if cfg.remat:
            x = checkpoint(_block, x, bp, cfg, mesh, use_reentrant=False)
        else:
            x = _block(x, bp, cfg, mesh)
    return x


def _logits(x, params: dict, cfg: TransformerConfig):
    x = _rms_norm(x, params["ln_f"], cfg.use_pallas_norm)
    ct = torch.promote_types(x.dtype, torch.float32)
    return torch.einsum("bsd,vd->bsv", x.to(ct), params["embed"].to(ct))


def forward(params, tokens, cfg: TransformerConfig, mesh=None):
    """tokens [B, S] int64 -> logits [B, S, vocab] (f32; float64 stays
    float64).  With a mesh: this rank's shards and tokens in, its logits
    out (module docstring)."""
    p = as_tree(params)
    x = F.embedding(tokens, p["embed"])
    x = _blocks(x, p["blocks"], cfg, mesh)
    return _logits(x, p, cfg)


def pipelined_forward(params, tokens, cfg: TransformerConfig, mesh,
                      pp_axis: str = "pp", n_microbatch: int = 4):
    """forward() with the block stack run as a GPipe pipeline over
    `pp_axis`: every pp rank passes the whole tree and tokens, runs its
    n_layers/n_stages layers, and gets the whole logits.  The embedding
    and final norm run replicated outside the pipeline."""
    p = as_tree(params)
    n_stages = mesh.shape[pp_axis]
    L = cfg.n_layers
    if L % n_stages:
        raise ValueError(f"n_layers {L} must divide over {pp_axis!r} "
                         f"({n_stages})")
    per = L // n_stages
    x = F.embedding(tokens, p["embed"])
    b = x.shape[0]
    if b % n_microbatch:
        raise ValueError(f"batch {b} must divide into {n_microbatch} "
                         "microbatches")
    x_mb = x.reshape(n_microbatch, b // n_microbatch, *x.shape[1:])
    s = mesh.index(pp_axis)
    # this rank's stage of the restacked blocks: [1, per, ...]
    stage = {k: v[s * per:(s + 1) * per][None]
             for k, v in p["blocks"].items()}

    def stage_fn(bp_stage, xc):
        return _blocks(xc, bp_stage, cfg, None)

    y = gpipe(stage_fn, stage, x_mb, mesh, pp_axis)
    return _logits(y.reshape(b, *y.shape[2:]), p, cfg)


def loss_fn(params, batch, cfg: TransformerConfig, mesh=None):
    """Next-token cross-entropy, the mean over every token of the batch;
    batch = (tokens, targets) [B, S] (with a mesh, this rank's
    [B/dp, S/sp]; the loss is then the global mean on every rank)."""
    tokens, targets = batch
    logits = forward(params, tokens, cfg, mesh)
    nll = torch.logsumexp(logits, dim=-1) - \
        torch.gather(logits, -1, targets[..., None])[..., 0]
    data = [a for a in (cfg.dp_axis, cfg.sp_axis) if _size(mesh, a) > 1]
    if not data:
        return nll.mean()
    n = nll.numel()
    for a in data:
        n *= mesh.shape[a]
    loss = nll.sum() / n
    for a in data:
        loss = psum(loss, mesh, a)
    return loss


@torch.no_grad()
def sync_grads(grads: dict, cfg: TransformerConfig, mesh) -> dict:
    """Each gradient summed over the data axes (dp, sp) of the mesh that
    do not shard its parameter: a replicated parameter's gradient is the
    sum of every data shard's (tp-sharded ones were summed over tp by
    the collectives' backward)."""
    specs = dict(tree_items(param_shardings(cfg)))
    out = []
    for path, g in tree_items(grads):
        for a in (cfg.dp_axis, cfg.sp_axis):
            if _size(mesh, a) > 1 and a not in specs[path]:
                g = _all_reduce(g, mesh, a)
        out.append((path, g))
    return tree_from_items(out)


def value_and_grad(params, batch, cfg: TransformerConfig, mesh=None):
    """(loss, grads as a tree): the gradient of loss_fn at `params`, each
    synced over the mesh's data axes."""
    items = [(k, t.detach().requires_grad_())
             for k, t in tree_items(as_tree(params))]
    loss = loss_fn(tree_from_items(items), batch, cfg, mesh)
    grads = torch.autograd.grad(loss, [t for _, t in items])
    tree = tree_from_items((k, g) for (k, _), g in zip(items, grads))
    if mesh is not None:
        tree = sync_grads(tree, cfg, mesh)
    return loss.detach(), tree


def train_step(params, batch, cfg: TransformerConfig, mesh=None,
               lr: float = 1e-2):
    """One SGD step; returns (new params as a tree, loss).  Real training
    loops use models.training."""
    loss, grads = value_and_grad(params, batch, cfg, mesh)
    g = dict(tree_items(grads))
    new = tree_from_items((k, (t.detach() - lr * g[k].to(t.dtype)))
                          for k, t in tree_items(as_tree(params)))
    return new, loss


def make_sharded_train_step(cfg: TransformerConfig, mesh, lr: float = 1e-2):
    """train_step over the mesh: step(params_loc, batch_loc) ->
    (new params_loc, global loss), with this rank's shards in and out."""
    def step(params, batch):
        return train_step(params, batch, cfg, mesh, lr)

    return step
