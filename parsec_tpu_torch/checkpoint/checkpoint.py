"""Quiescent-point collection checkpoints + torch train-state save/restore.

Port of parsec_tpu/checkpoint/checkpoint.py; the collection half is the
reference's numpy code unchanged, so the files are the same.

Format: one .npz per (path, collection name) holding every *local* tile
keyed "m_n", plus a JSON-ish meta array (geometry, rank) used to validate
the resume target — mismatched geometry is an error, not silent
corruption.  Multi-rank runs write per-rank files (path.rank<k>.npz), the
same per-rank-file scheme as the reference's dbp profiles
(parsec/parsec_binary_profile.h) and standard for pod checkpoints.
"""
import json
from typing import Dict

import numpy as np


def _coll_meta(coll) -> dict:
    return {
        "M": coll.M, "N": coll.N, "mb": coll.mb, "nb": coll.nb,
        "P": getattr(coll, "P", 1), "Q": getattr(coll, "Q", 1),
        "nodes": coll.nodes, "myrank": coll.myrank,
        "dtype": np.dtype(coll.dtype).str,
    }


def _path_for(path: str, name: str, rank: int, nodes: int) -> str:
    base = f"{path}.{name}"
    return f"{base}.rank{rank}.npz" if nodes > 1 else f"{base}.npz"


def save_collections(path: str, named_colls: Dict[str, object]):
    """Checkpoint local tiles of each collection.  Call at a quiescent
    point (after tp.wait() / ctx.wait()) — tile buffers are then the
    complete algorithm state."""
    for name, coll in named_colls.items():
        arrays = {}
        # Enumerate through the public API (the same walk Collection.fill
        # uses) so band/sym collections — whose tiles live in nested
        # descriptors, not a flat _tiles dict — checkpoint correctly, and
        # lazily-allocated tiles materialize instead of being dropped.
        for m in range(coll.mt):
            for n in range(coll.nt):
                if not coll.stored(m, n):
                    continue
                if coll.rank_of(m, n) != coll.myrank:
                    continue
                arrays[f"{m}_{n}"] = coll.tile(m, n)
        arrays["__meta__"] = np.frombuffer(
            json.dumps(_coll_meta(coll)).encode(), dtype=np.uint8)
        np.savez(_path_for(path, name, coll.myrank, coll.nodes), **arrays)


def load_collections(path: str, named_colls: Dict[str, object]):
    """Restore local tiles into freshly-constructed collections with the
    same geometry.  Raises ValueError on geometry mismatch."""
    for name, coll in named_colls.items():
        f = np.load(_path_for(path, name, coll.myrank, coll.nodes))
        meta = json.loads(bytes(f["__meta__"]).decode())
        want = _coll_meta(coll)
        for k in ("M", "N", "mb", "nb", "P", "Q", "nodes", "dtype"):
            if meta[k] != want[k]:
                raise ValueError(
                    f"checkpoint {name}: geometry mismatch on {k}: "
                    f"saved {meta[k]!r} vs target {want[k]!r}")
        for key in f.files:
            if key == "__meta__":
                continue
            m, n = (int(x) for x in key.split("_"))
            coll.tile(m, n)[...] = f[key]


# ------------------------------------------------------------------ model


def _leaves(tree, prefix: str = ""):
    """(key, leaf) over a state: an nn.Module by its state_dict (each
    dotted name one level), dicts by key, lists and tuples by index;
    keys in jax.tree_util.keystr's form ("['params']['blocks']['wo']")."""
    import torch
    if isinstance(tree, torch.nn.Module):
        for name, t in tree.state_dict().items():
            yield prefix + "".join(f"[{p!r}]" for p in name.split(".")), t
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_train_state(path: str, state):
    """Save a train state (module or state_dict, optimizer state, step)
    to one .npz, a leaf an array keyed by its path.  Tensors on a card are
    copied to the host first; bfloat16 is widened to float32 (exact, and
    narrowed back on load)."""
    import torch
    from ..convert import to_numpy
    arrays = {}
    for key, leaf in _leaves(state):
        arrays[key] = to_numpy(leaf) if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf)
    np.savez(_npz(path), **arrays)


def load_train_state(path: str, like):
    """Restore into the structure of `like`: a module's tensors are
    copied into it in place, a tensor leaf comes back with its like's
    dtype and device, a Python number as its type.  Raises ValueError on
    a leaf the file lacks."""
    import torch
    f = np.load(_npz(path))

    def get(key):
        if key not in f.files:
            raise ValueError(f"checkpoint missing leaf {key}")
        return f[key]

    def load(tree, prefix):
        if isinstance(tree, torch.nn.Module):
            with torch.no_grad():
                for key, t in _leaves(tree, prefix):
                    t.copy_(torch.from_numpy(get(key)))
            return tree
        if isinstance(tree, dict):
            return {k: load(v, f"{prefix}[{k!r}]") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(load(v, f"{prefix}[{i}]")
                              for i, v in enumerate(tree))
        a = get(prefix)
        if isinstance(tree, torch.Tensor):
            return torch.from_numpy(a).to(tree.device, tree.dtype)
        return type(tree)(a.item()) if isinstance(tree, (int, float)) else a

    return load(like, "")
