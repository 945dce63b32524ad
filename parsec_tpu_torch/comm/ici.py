"""Device-to-device transfers between the devices of one process.

The task runtime's multi-process data plane rides the comm engine's
PK_DEVICE rendezvous (native/comm.cpp and device/cuda.py).  When ONE
process holds several devices (several Contexts colocated on one card,
or several cards), tile movement between them never touches the host:

- `device_transfer(t, device)`: a copy of `t` onto `device`, ordered after
  the source's event.  Between two cards it is a peer copy (NVLink where
  the cards have it); on one card it is a clone in device memory, never an
  alias, so the consumer owns bytes that no later write of the producer
  can reach.
- `PermuteEngine`: the ring permute over a list of per-device shards (the
  neighbor exchange of ring attention and halo swaps; the chain broadcast
  topology's rank+1 walk, parsec/remote_dep.c:43).

Port of parsec_tpu/comm/ici.py.  The reference's `TransferSessionPool`
(persistent sessions of the cross-process device transfer plane) has no
counterpart here yet: that plane does not exist in this package.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def device_transfer(t: torch.Tensor, device, event=None) -> torch.Tensor:
    """A copy of `t` on `device`.  On a card the copy runs on the
    destination's current stream after `event` (the source's
    write-completion event; None: the source is complete), and the source
    is record_stream()ed for that stream, so the allocator keeps its
    memory until the copy has read it.  The caller records the event its
    consumers wait on.  On the CPU: an owned clone."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device, copy=True)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        if event is not None:
            stream.wait_event(event)
        if t.is_cuda:
            t.record_stream(stream)
        return t.to(device, copy=True, non_blocking=True)


class PermuteEngine:
    """Ring permute over a list of devices.

    A distributed tensor is a list of shards, shard i on devices[i].
    permute(shards, shift) returns the list whose shard j is shards
    [(j - shift) % n] moved onto devices[j] (device_transfer)."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.n = len(self.devices)

    def permute(self, shards: Sequence[torch.Tensor],
                shift: int = 1) -> List[torch.Tensor]:
        if len(shards) != self.n:
            raise ValueError(f"PermuteEngine: {len(shards)} shards for "
                             f"{self.n} devices")
        return [device_transfer(shards[(j - shift) % self.n],
                                self.devices[j]) for j in range(self.n)]

    def exchange(self, shards: Sequence[torch.Tensor]):
        """Bidirectional halo exchange: (from_prev, from_next), each
        device holding its ring neighbors' shards."""
        return self.permute(shards, 1), self.permute(shards, self.n - 1)

    def shard(self, x, shard_dim: int = 0) -> List[torch.Tensor]:
        """Lay a host array onto the devices, split evenly on
        shard_dim."""
        t = torch.as_tensor(np.ascontiguousarray(x)) \
            if isinstance(x, np.ndarray) else x
        if t.shape[shard_dim] % self.n:
            raise ValueError(f"PermuteEngine.shard: dim {shard_dim} of "
                             f"{tuple(t.shape)} does not split {self.n} ways")
        return [c.to(d, copy=True) for c, d in
                zip(torch.chunk(t, self.n, dim=shard_dim), self.devices)]
