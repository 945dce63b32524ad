"""Communication layer, Python side.

The native comm engine (native/comm.cpp: the transport, the ACTIVATE/GET
rendezvous, the device data plane) is driven through Context.comm_init.
This package adds:

- `init(ctx)`: join the multi-rank job described by PTC_RANK / PTC_WORLD /
  PTC_PORT (set by `python -m parsec_tpu_torch.comm.launch`, the mpirun
  analog of the reference's test harness)
- `launch`: that launcher
- `ici`: device-to-device transfers between the devices of one process
  (a clone on one card, a peer copy between cards) and the ring permute
  over a list of per-device shards
- `coll`: the runtime-native collectives (ptc_coll_* task classes)
- `economics` and `topology`: the fitted transfer economics and the
  hosts-and-islands topology the collectives and the analyses price with
- `migrate`: content-hash KV page migration between PagePools, in
  process and over the wire (the fleet router's handoff)

Port of parsec_tpu/comm.
"""
import os


def init(ctx, base_port=None):
    """Initialize the native comm engine from the launcher's env.  A
    no-op (returns rank 0, world 1) outside a launched job."""
    rank = int(os.environ.get("PTC_RANK", "0"))
    world = int(os.environ.get("PTC_WORLD", "1"))
    port = base_port if base_port is not None else int(
        os.environ.get("PTC_PORT", "29650"))
    if world > 1:
        ctx.set_rank(rank, world)
        ctx.comm_init(port)
    return rank, world
