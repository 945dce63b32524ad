"""Fleet KV page migration over the wire in the port
(comm/migrate.build_page_migration): the six cases of
tests/comm/test_migrate_wire.py.  Frozen content-keyed pages ride the
ordinary remote-dep pull; with eager off and the page above chunk_size,
every page streams as ranged chunk frames (no new frame type).

Each case spawns its ranks (tests/test_torch_comm_workers.py, which
imports numpy and the port only) and makes the reference worker's
assertions.  The chunked 2-rank transfer is also run by the JAX package
on two ranks, and rank 1's imported pages are held to it bit for bit.
The pricing functions run in this process on both packages.
"""
import numpy as np

import test_torch_comm_workers as W
from parsec_tpu.comm import economics as jecon
from parsec_tpu.comm import migrate as jmig
from parsec_tpu.comm import topology as jtopo
from parsec_tpu_torch.comm import economics as tecon
from parsec_tpu_torch.comm import migrate as tmig
from parsec_tpu_torch.comm import topology as ttopo


def test_migrate_pages_chunked_2ranks():
    """4 frozen pages rank 0 -> rank 1, all cold at the receiver: every
    payload streams chunked and the import is bit-exact and warm; the
    JAX package's run of the same program imports the same bytes."""
    port = W.spmd(W.migrate_pages_wire, 2, timeout=120, n_keys=4)[1]
    ref = W.spmd(W.migrate_pages_wire, 2, timeout=240, n_keys=4,
                 pkg="parsec_tpu")[1]
    assert port["keys"] == ref["keys"] and port["imported"] == 4
    np.testing.assert_array_equal(port["pages"], ref["pages"])


def test_migrate_pages_partial_dedup():
    """The receiver holds the first 2 of 4 keys: only the wanted tail
    moves (imported == 2)."""
    res = W.spmd(W.migrate_pages_wire, 2, timeout=120, n_keys=4, held=2)
    assert res[1]["imported"] == 2 and res[1]["built"]


def test_migrate_pages_full_dedup_zero_bytes():
    """The receiver holds everything: no pool, no GET, no payload chunk
    on the wire."""
    res = W.spmd(W.migrate_pages_wire, 2, timeout=120, n_keys=3, held=3)
    assert res[1]["imported"] == 0 and not res[1]["built"]


def test_migrate_kill_receiver_reaps_session():
    """Rank 1 dies mid-chunked-page-pull; rank 0 reaps its streaming
    session (reaps >= 1, registered bytes back to zero).  Only rank 0
    reports."""
    res = W.spmd(W.migrate_kill_receiver, 2, timeout=150, expect=1)
    assert res == [{"reaps": res[0]["reaps"]}] and res[0]["reaps"] >= 1


def test_migration_class_and_cost_classed():
    """Cross-island migrations price at the DCN fit, strictly above the
    intra-island leg, the same on both packages."""
    out = []
    for mig, topo, econ in ((jmig, jtopo, jecon), (tmig, ttopo, tecon)):
        tm = topo.TopologyModel.parse("0,1;2,3")
        e = econ.TransferEconomics(
            {"rdv": {"fixed_overhead_us": 50.0, "per_byte_ns": 1.0}},
            source="synthetic")
        nb = 1 << 20
        out.append(([mig.migration_class(s, d, tm)
                     for s, d in ((0, 1), (0, 2), (2, 2))],
                    mig.migration_cost(nb, 0, 1, tm, e),
                    mig.migration_cost(nb, 0, 2, tm, e)))
    assert out[1] == out[0]
    assert out[1][0] == ["host", "dcn", "loopback"]
    assert out[1][2] > out[1][1]


def test_relay_rank_for_prefers_dst_leader():
    """Bulk follower -> follower DCN pulls route through the destination
    island's leader; legs that are a leader endpoint stay direct."""
    got = []
    for mig, topo in ((jmig, jtopo), (tmig, ttopo)):
        tm = topo.TopologyModel.parse("0,1;2,3")
        nb = 1 << 24
        got.append([mig.relay_rank_for(nb, s, d, tm)
                    for s, d in ((1, 3), (0, 2), (0, 1))])
    assert got[1] == got[0] == [2, None, None]
