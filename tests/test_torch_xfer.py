"""The port's cross-process device transfer plane (device.dp_transfer:
CUDA IPC between processes on one host and card, device/cuda.py) and its
session pool (comm/ici.TransferSessionPool) on the CPU, where no handle
can be opened: the token's encoding, the producer's decision over a live
two-rank engine, the pool's stats against the JAX package's over the
same fake connect, the probe's verdict without a card, and a pull that
fails after its token was sent (dp_errors, the consuming pool aborts, no
byte path).  The plane's pulls themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 14c).
"""
import os

import numpy as np
import pytest

import parsec_tpu_torch as tpt
import test_torch_comm_workers as W
from parsec_tpu.comm.ici import TransferSessionPool as JPool
from parsec_tpu_torch.comm.ici import TransferSessionPool as TPool
from parsec_tpu_torch.comm.topology import TopologyModel
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.device import cuda as dc


def test_token_encodes_and_decodes():
    fields = {"rank": 3, "addr": "h/c/12", "raw": True, "dtype": "float32",
              "shape": [4, 8], "stride": [8, 1], "offset": 16,
              "handle": bytes(range(64)), "size": 1 << 20, "soffset": 512,
              "ref": b"/torch_123_456", "ref_offset": 7,
              "event": bytes(range(64, 128)), "event_sync": True}
    tok = dc._xfer_encode(fields)
    assert tok[:8] == dc._DP_XFER_MAGIC != dc._DP_REF_MAGIC
    assert dc._xfer_decode(tok) == fields
    with pytest.raises(ValueError):
        dc._xfer_decode(dc._DP_REF_MAGIC + tok[8:])


@pytest.mark.parametrize("same_card,advertise,want", [
    (True, True, True), (False, True, False), (True, False, False)])
def test_producer_decides_from_the_consumers_identity(same_card, advertise,
                                                      want):
    """A token only to a consumer that shared its (host, card) identity
    and holds this device's card; no identity (the consumer's plane is
    off, or its probe failed) means bytes."""
    res = W.spmd(W.xfer_decision, 2, timeout=60, same_card=same_card,
                 advertise=advertise)
    assert res[0]["decision"] is want
    if advertise:
        assert res[0]["identity"] == {"host": "this-host", "card": "card-a"}
    else:
        assert res[0]["identity"] is None


def test_decision_needs_the_plane_the_bit_and_a_card():
    """dp_serve serves a token only with the plane on and the pull bit
    set; a CPU device has no identity, so never."""
    with tpt.Context(nb_workers=1) as ctx:
        dev = CudaDevice(ctx, device="cpu")
        assert dev._ident is None
        assert dc._xfer_peer_ok(ctx, dev, 1) is False
        assert dc._xfer_enabled() is False
        assert dc._xfer_can_pull(dev) is False
        dev.stop()


def test_session_pool_stats_match_reference_schema():
    """The same fake connect and the same sequence of gets on both
    packages' pools: the same peers, establishments, reuses and classes
    (setup_ms is each run's own timing)."""
    class Server:
        def __init__(self):
            self.connects = []

        def connect(self, addr):
            self.connects.append(addr)
            return ("session", addr)

    topo = TopologyModel.parse("0,1;2,3")
    from parsec_tpu.comm.topology import TopologyModel as JTopo
    seq = [("a", 1), ("a", 1), ("b", 2), ("a", 1), ("c", None), ("b", 2)]
    out = []
    for pool, srv in ((JPool(topo=JTopo.parse("0,1;2,3"), my_rank=0),
                       Server()),
                      (TPool(topo=topo, my_rank=0), Server())):
        got = [pool.get(srv, a, r) for a, r in seq]
        st = pool.stats()
        assert got[0] is got[1] is got[3]
        assert sorted(st["setup_ms"]) == ["a", "b", "c"]
        assert all(v >= 0 for v in st["setup_ms"].values())
        out.append({"srv": srv.connects, "peers": st["peers"],
                    "established": st["established"],
                    "reused": st["reused"],
                    "by_class": {c: v["peers"]
                                 for c, v in st["by_class"].items()},
                    "keys": sorted(st)})
    assert out[1] == out[0]
    assert out[1]["established"] == 3 and out[1]["reused"] == 3
    assert out[1]["by_class"] == {"host": 1, "dcn": 1, "ici": 1}


def test_plane_knobs_registered_with_the_reference_defaults():
    import parsec_tpu as jpt
    for k in ("device.dp_transfer", "device.dp_pull"):
        assert tpt.utils.params.get(k) == jpt.utils.params.get(k)
    assert "CUDA IPC" in tpt.utils.params._reg["device.dp_transfer"].help


@pytest.mark.parametrize("host_consumer", [False, True])
def test_failed_pull_counts_and_aborts_the_pool(host_consumer):
    """A token whose pull fails (here: no card to open it on) counts in
    the consumer's dp_errors and fails the consuming task, a device chore
    at dispatch or a host body at its read: the pool aborts and A(1) is
    never written from bytes that do not exist.  The producer's pool
    completes; nothing falls back to the byte path."""
    res = W.spmd(W.xfer_failed_pull, 2, timeout=90,
                 host_consumer=host_consumer)
    assert res[1]["dp_errors"] == 1
