"""Device-mesh construction over torch.distributed.

Port of parsec_tpu/parallel/mesh.py.  The reference partitions work with
a PxQ process grid (parsec/data_dist/matrix/grid_2Dcyclic.c); the JAX
package's analog is a named `jax.sharding.Mesh`.  Here a Mesh names the
axes of a grid of torch.distributed ranks, one card a rank, with one
process group per axis (torch.distributed.device_mesh.DeviceMesh).
`shard` and `unshard` cut a global tensor into this rank's piece under a
PartitionSpec-like tuple and gather it back.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist


class MeshSpec:
    """Named axis sizes, e.g. MeshSpec(dp=2, tp=2, sp=2).

    Axis order matters: earlier axes vary slowest over the ranks, so put
    the highest-bandwidth-need axis LAST (neighbouring ranks) — the way
    the reference's chain broadcast walks rank+1 (parsec/remote_dep.c:43).
    """

    def __init__(self, **axes: int):
        self.axes = {k: int(v) for k, v in axes.items()}

    @property
    def size(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= v
        return n


def rank_device(device=None) -> torch.device:
    """The device this rank computes on: `device` when given, else its
    current card (raises where torch has no CUDA)."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", torch.cuda.current_device())


class Mesh:
    """Named axes over the ranks of a torch.distributed job.

    `shape[axis]` is the axis size, `group(axis)` its process group,
    `index(axis)` this rank's coordinate on it, `rank_at(axis, i)` the
    global rank at coordinate i (the other coordinates this rank's).
    `device` is where this rank's tensors live; `staged` counts, per op,
    the bytes the collectives staged through pinned host memory."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              device_mesh.mesh.shape))
        self.device = device
        self.staged: Dict[str, int] = {}
        self._coord = device_mesh.get_coordinate()

    @property
    def member(self) -> bool:
        """Whether this rank is on the mesh (a mesh may take a subset of
        the job's ranks)."""
        return self._coord is not None

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        return self._coord[self.axis_names.index(axis)]

    def rank_at(self, axis: str, i: int) -> int:
        coord = list(self._coord)
        coord[self.axis_names.index(axis)] = i
        return int(self.device_mesh.mesh[tuple(coord)])

    def count_staged(self, op: str, nbytes: int) -> None:
        self.staged[op] = self.staged.get(op, 0) + nbytes


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[int]] = None,
              device=None, **axes: int) -> Mesh:
    """Build a Mesh from a MeshSpec (or keyword axis sizes) over the ranks
    of the torch.distributed job (parallel.init_distributed first).

    `make_mesh(dp=2, sp=4)` -> Mesh over ranks 0-7 with axes ('dp','sp').
    `devices`: the ranks to lay out (ascending; default every rank of the
    job); the mesh takes the first spec.size of them.  `device`: where
    this rank's tensors live, by default its card (raises without one).
    Every rank of the job calls make_mesh, members or not."""
    if spec is None:
        spec = MeshSpec(**axes)
    dev = rank_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no torch.distributed job; call "
                           "parallel.init_distributed first")
    ranks = sorted(devices) if devices is not None else \
        list(range(dist.get_world_size()))
    if spec.size > len(ranks):
        raise ValueError(
            f"mesh needs {spec.size} devices, only {len(ranks)} available")
    from torch.distributed.device_mesh import DeviceMesh
    grid = torch.tensor(ranks[:spec.size]).reshape(
        tuple(spec.axes.values()))
    return Mesh(DeviceMesh(dev.type, grid,
                           mesh_dim_names=tuple(spec.axes.keys())), dev)


def _axes_of(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """This rank's piece of the global tensor `x` under `spec` (one entry
    per dim: None, an axis name or a tuple of names, the first varying
    slowest), as a contiguous tensor of its own on mesh.device."""
    out = x
    for dim, entry in enumerate(spec):
        idx, n = 0, 1
        for a in _axes_of(entry):
            idx = idx * mesh.shape[a] + mesh.index(a)
            n *= mesh.shape[a]
        if n > 1:
            if out.shape[dim] % n:
                raise ValueError(f"shard: dim {dim} of {tuple(x.shape)} "
                                 f"does not divide over {entry!r} ({n})")
            step = out.shape[dim] // n
            out = out.narrow(dim, idx * step, step)
    return out.to(mesh.device).clone(memory_format=torch.contiguous_format)


def unshard(x_loc: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """The global tensor whose pieces the ranks hold (shard's inverse;
    every rank of the mesh calls it and gets the whole)."""
    from .collectives import _all_gather
    out = x_loc
    for dim, entry in enumerate(spec):
        for a in reversed(_axes_of(entry)):
            if mesh.shape[a] > 1:
                out = _all_gather(out, mesh, a, dim)
    return out
