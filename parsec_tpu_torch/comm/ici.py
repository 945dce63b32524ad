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

- `TransferSessionPool`: the per-peer sessions of the cross-process
  device transfer plane (device.dp_transfer; CUDA IPC between processes
  on one host and card, device/cuda.py), with each peer's setup cost
  kept apart from its reuse.

Port of parsec_tpu/comm/ici.py.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Sequence

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


class TransferSessionPool:
    """Persistent per-peer transfer-plane sessions.

    A session carries the cross-process card-to-card pulls of the
    PK_DEVICE data plane from one peer (device/cuda.py: CUDA IPC between
    processes on one host and card).  It is established ONCE per peer
    address — `server.connect(addr)`, whose cost is the peer's first
    handle open — and reused for every later pull.  The pool records
    establishment cost per peer (`setup_ms`) separately from use counts:
    first-transfer setup against steady-state pulls.

    Thread-safe: pulls arrive on the comm thread while probes run on
    the caller's thread.  A lost race establishes two connections and
    keeps the first registered (the loser is dropped; connections are
    cheap to leak once, unlike per-pull setup).

    When the caller knows the peer's RANK it passes it to get(); the
    pool classes the session against the process topology model
    (comm/topology.py) and reports setup cost per link class in
    `stats()["by_class"]`.
    """

    def __init__(self, topo=None, my_rank: int = 0):
        self._lock = threading.Lock()
        self._conns: Dict[str, object] = {}
        self._setup_ms: Dict[str, float] = {}
        self._cls: Dict[str, str] = {}
        self._established = 0
        self._reused = 0
        self._topo = topo
        self._my_rank = int(my_rank)

    def _class_of(self, peer_rank) -> str:
        if peer_rank is None:
            return "ici"
        topo = self._topo
        if topo is None:
            from .topology import default_topology
            topo = self._topo = default_topology(
                max(self._my_rank, int(peer_rank)) + 1)
        return topo.class_of(self._my_rank, int(peer_rank))

    def get(self, server, addr: str, peer_rank=None):
        """The session for `addr`, establishing it on first use."""
        with self._lock:
            conn = self._conns.get(addr)
            if conn is not None:
                self._reused += 1
                return conn
        t0 = time.perf_counter()
        conn = server.connect(addr)
        dt_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            prior = self._conns.get(addr)
            if prior is not None:  # lost an establishment race
                self._reused += 1
                return prior
            self._conns[addr] = conn
            self._setup_ms[addr] = dt_ms
            self._cls[addr] = self._class_of(peer_rank)
            self._established += 1
        return conn

    def stats(self) -> dict:
        with self._lock:
            by_class: Dict[str, dict] = {}
            for addr, ms in self._setup_ms.items():
                c = by_class.setdefault(self._cls.get(addr, "ici"),
                                        {"peers": 0, "setup_ms": 0.0})
                c["peers"] += 1
                c["setup_ms"] += ms
            return {
                "peers": len(self._conns),
                "established": self._established,
                "reused": self._reused,
                "setup_ms": dict(self._setup_ms),
                "by_class": by_class,
            }
