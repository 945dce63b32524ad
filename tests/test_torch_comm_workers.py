"""Per-rank worker programs of the port's multi-rank tests
(tests/test_torch_comm.py, test_torch_dataplane.py, test_torch_coll.py).

Each worker is the port's counterpart of the reference worker of the same
name in tests/comm/_workers.py: it runs the same SPMD program on its rank
over the native comm engine's loopback transport, makes the same
assertions, and RETURNS its result (the values its rank owns), so that
the parent test can hold it against the JAX package's run of the same
program on the same numpy-seeded inputs.  A worker asserts at its end
that jax was never imported, and that no data-plane callback failed
(dp_errors == 0) wherever a device took part.

The package a worker drives is parsec_tpu_torch.  A parent computes the
reference by running the same worker with the JAX package instead:
`reference()` in its own process at one rank, or `spmd(..., pkg=...)` on
as many ranks (the collectives, whose one-rank form is the identity).
This file imports only numpy, torch (inside the device workers) and
parsec_tpu_torch; the JAX package reaches a worker only by name, from a
parent.
"""
from __future__ import annotations

import contextlib
import importlib
import multiprocessing as mp
import os
import sys
import traceback

import numpy as np

import parsec_tpu_torch
from parsec_tpu_torch.comm.launch import free_port_base

# the package the workers drive (a parent sets it to compute a reference)
PKG = parsec_tpu_torch


def _imp(mod: str, *names):
    """Names from a submodule of the package in use."""
    m = importlib.import_module(f"{PKG.__name__}.{mod}" if mod
                                else PKG.__name__)
    out = [getattr(m, n) if hasattr(m, n) else
           importlib.import_module(f"{m.__name__}.{n}") for n in names]
    return out[0] if len(out) == 1 else tuple(out)


def _is_port() -> bool:
    return PKG is parsec_tpu_torch


def _device(ctx, **kw):
    """The port's CUDA device module on the CPU (the plain versions of
    its kernels: these tests run where there is no card); with the
    reference package, its own device module."""
    if not _is_port():
        return _imp("device.tpu", "TpuDevice")(ctx, **kw)
    from parsec_tpu_torch.device import CudaDevice
    return CudaDevice(ctx, device="cpu", **kw)


def _stop(dev) -> None:
    """Stop a device, holding the port's to a data plane with no failed
    callback (a failure hands the dependency to the host path, silently
    but for this counter)."""
    if _is_port():
        assert dev.stats["dp_errors"] == 0, dev.stats
    dev.stop()


def _mk_ctx(rank: int, nodes: int, port: int, nb_workers: int = 2,
            scheduler: str = "lfq", topo: str = "star"):
    pt = PKG
    ctx = pt.Context(nb_workers=nb_workers, scheduler=scheduler)
    ctx.set_rank(rank, nodes)
    ctx.comm_init(port)
    if topo != "star":
        ctx.comm_set_topology(topo)
    return pt, ctx


def run_capture_stderr(worker_fn, rank, nodes, port, q, stderr_dir, **kw):
    """run() with the child's fd 2 redirected to a per-rank file, so a
    test can assert that a clean SPMD job logs nothing (the native
    runtime writes its warnings to C stderr)."""
    path = os.path.join(stderr_dir, f"rank{rank}.stderr")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 2)
    os.close(fd)
    sys.stderr = os.fdopen(2, "w", buffering=1, closefd=False)
    run(worker_fn, rank, nodes, port, q, **kw)


def _owned(coll, lower: bool = False) -> dict:
    """This rank's tiles of a tiled collection ((m, n) -> a copy); with
    lower=True, the lower triangle's only, each diagonal tile's upper part
    (untouched input) zeroed."""
    out = {}
    for m in range(coll.mt):
        for n in range(coll.nt):
            if coll.rank_of(m, n) != coll.myrank or (lower and n > m):
                continue
            t = coll.tile(m, n).copy()
            out[(m, n)] = np.tril(t) if lower and m == n else t
    return out


def run(worker_fn, rank, nodes, port, q, pkg=None, **kw):
    """Spawned entry point: run the worker and push ("ok", rank, result)
    or ("err", rank, traceback) onto the queue.  `pkg` names another
    package for the worker to drive (a parent's reference run of the
    same program on as many ranks); a port worker must not import jax."""
    global PKG
    try:
        if pkg is not None:
            PKG = importlib.import_module(pkg)
        res = worker_fn(rank, nodes, port, **kw)
        if _is_port():
            assert "jax" not in sys.modules, "a port worker imported jax"
        q.put(("ok", rank, res))
    except Exception:
        q.put(("err", rank, traceback.format_exc()))


def ptg_chain(rank: int, nodes: int, port: int, nb: int = 32,
              topo: str = "star"):
    """Ex04-style RW chain where consecutive tasks live on different ranks:
    Task(k) runs on rank k%nodes; the datum hops rank-to-rank via remote
    ACTIVATE; the last task writes back to A(0) (a remote PUT when
    nb % nodes != 0)."""
    pt, ctx = _mk_ctx(rank, nodes, port, topo=topo)
    with ctx:
        arr = np.zeros(nodes, dtype=np.int64)  # element r owned by rank r
        ctx.register_linear_collection("A", arr, elem_size=8, nodes=nodes,
                                       myrank=rank)
        ctx.register_arena("t", 8)
        tp = pt.Taskpool(ctx, globals={"NB": nb})
        k = pt.L("k")
        tc = tp.task_class("Task")
        tc.param("k", 0, pt.G("NB"))
        tc.affinity("A", k % nodes)
        tc.flow("A", "RW",
                pt.In(pt.Mem("A", 0), guard=(k == 0)),
                pt.In(pt.Ref("Task", k - 1, flow="A")),
                pt.Out(pt.Ref("Task", k + 1, flow="A"), guard=(k < pt.G("NB"))),
                pt.Out(pt.Mem("A", 0), guard=(k == pt.G("NB"))),
                arena="t")

        def body(view):
            view.data("A", dtype=np.int64)[0] += 1

        tc.body(body)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        mine = sum(1 for i in range(nb + 1) if i % nodes == rank)
        assert tp.nb_total_tasks == mine, (tp.nb_total_tasks, mine)
        if rank == 0:
            assert arr[0] == nb + 1, arr
        stats = ctx.comm_stats()
        assert stats["msgs_sent"] > 0 or nodes == 1
        ctx.comm_fini()
        return {"A0": arr[0].copy()} if rank == 0 else {}


def ptg_broadcast(rank: int, nodes: int, port: int, nt: int = 12,
                  topo: str = "star"):
    """Ex05-style broadcast: Root (rank 0) produces a value; Recv(k) for
    k=0..nt-1 runs on rank k%nodes and stores the value into its local
    element.  topo="star": one ACTIVATE per rank (batched targets);
    "chain"/"binomial": one ACTIVATE_BCAST propagated rank-to-rank along
    the topology (reference: remote_dep.c:39-47)."""
    pt, ctx = _mk_ctx(rank, nodes, port, topo=topo)
    with ctx:
        arr = np.zeros(nt, dtype=np.int64)
        ctx.register_linear_collection("V", arr, elem_size=8, nodes=nodes,
                                       myrank=rank)
        ctx.register_arena("t", 8)
        tp = pt.Taskpool(ctx, globals={"NT": nt})
        k = pt.L("k")
        root = tp.task_class("Root")
        root.affinity("V", 0)
        recv = tp.task_class("Recv")
        recv.param("k", 0, pt.G("NT") - 1)
        recv.affinity("V", k)

        def root_body(view):
            view.data("X", dtype=np.int64)[0] = 42

        root.flow("X", "W",
                  pt.Out(pt.Ref("Recv", pt.Range(0, pt.G("NT") - 1),
                                flow="X")),
                  arena="t")
        root.body(root_body)

        def recv_body(view):
            assert view.data("X", dtype=np.int64)[0] == 42
            view.data("Y", dtype=np.int64)[0] = 42 + view["k"]

        recv.flow("X", "R", pt.In(pt.Ref("Root", flow="X")), arena="t")
        recv.flow("Y", "W", pt.Out(pt.Mem("V", k)), arena="t")
        recv.body(recv_body)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        for i in range(nt):
            if i % nodes == rank:
                assert arr[i] == 42 + i, (i, arr)
        ctx.comm_fini()
        return {f"V{i}": arr[i].copy() for i in range(nt) if i % nodes == rank}


def dtd_chain(rank: int, nodes: int, port: int, nb_tiles: int = 4,
              rounds: int = 6):
    """Distributed DTD: every rank inserts the same stream; task r writes
    tile t (owner t%nodes) reading tile t-1 — a wavefront crossing ranks.
    Shadows release via the owner's completion broadcast."""
    pt, ctx = _mk_ctx(rank, nodes, port)
    DtdTaskpool = _imp("dsl.dtd", "DtdTaskpool")

    with ctx:
        datas = [ctx.data(i, np.zeros(4, dtype=np.int64))
                 for i in range(nb_tiles)]
        dtp = DtdTaskpool(ctx, window=64)
        tiles = [dtp.tile_of(d, owner=i % nodes)
                 for i, d in enumerate(datas)]

        def step(view):
            src = view.data(0, dtype=np.int64)
            dst = view.data(1, dtype=np.int64)
            dst[0] = src[0] + 1

        # wavefront: each round bumps every tile to prev tile's value + 1
        for _ in range(rounds):
            for t in range(1, nb_tiles):
                dtp.insert_task(step, (tiles[t - 1], "INPUT"),
                                (tiles[t], "INOUT"))
        dtp.wait()
        ctx.comm_fence()
        # tile k's final value: after each round tile k = tile[k-1]+1 at
        # time of execution; sequentially that converges to k per round
        # count >= nb_tiles; with rounds >= nb_tiles, tile k == k.
        for i, d in enumerate(datas):
            if i % nodes == rank and rounds >= nb_tiles:
                v = np.frombuffer(d.array, dtype=np.int64)[0]
                assert v == i, (i, v, d.array)
        dtp.destroy()
        ctx.comm_fini()
        return {f"T{i}": np.frombuffer(d.array, dtype=np.int64).copy()
                for i, d in enumerate(datas) if i % nodes == rank}


def dtd_routed_payloads(rank: int, nodes: int, port: int,
                        elems: int = 32768, rounds: int = 4):
    """Distributed DTD with LARGE tiles: written-tile bytes must ride to
    the ranks that actually read them, not broadcast to everyone.  Each
    rank owns one big tile (elems*4 bytes > the 64KiB eager limit); only
    rank (r+1)%nodes reads rank r's tile.  Completions carry size-only
    markers; the single reader pulls.  Asserts result values AND that
    per-rank received bytes are far below the broadcast-all volume
    (reference: shadow pruning, insert_function_internal.h:110-139)."""
    pt, ctx = _mk_ctx(rank, nodes, port)
    DtdTaskpool = _imp("dsl.dtd", "DtdTaskpool")

    with ctx:
        big_datas = [ctx.data(i, np.zeros(elems, dtype=np.float32))
                     for i in range(nodes)]
        small_datas = [ctx.data(100 + i, np.zeros(4, dtype=np.float32))
                       for i in range(nodes)]
        dtp = DtdTaskpool(ctx, window=64)
        big = [dtp.tile_of(d, owner=i) for i, d in enumerate(big_datas)]
        small = [dtp.tile_of(d, owner=i)
                 for i, d in enumerate(small_datas)]

        def mk_writer(val):
            def w(view):
                view.data(0, dtype=np.float32)[:] = val
            return w

        def reader(view):
            src = view.data(0, dtype=np.float32)
            dst = view.data(1, dtype=np.float32)
            dst[0] = src[0]
            dst[1] = src[-1]

        for j in range(rounds):
            for r in range(nodes):
                dtp.insert_task(mk_writer(float(j * nodes + r)),
                                (big[r], "INOUT"))
            for r in range(nodes):
                dtp.insert_task(reader, (big[r], "INPUT"),
                                (small[(r + 1) % nodes], "INOUT"))
        dtp.wait()
        ctx.comm_fence()
        src_rank = (rank - 1 + nodes) % nodes
        expect = float((rounds - 1) * nodes + src_rank)
        mine = np.frombuffer(small_datas[rank].array, dtype=np.float32)
        assert mine[0] == expect and mine[1] == expect, (rank, mine, expect)
        st = ctx.comm_stats()
        tile_bytes = elems * 4
        # routed: this rank pulls its one source tile `rounds` times (plus
        # small eager payloads + frame overhead).  Broadcast-all would be
        # nodes*rounds*tile_bytes received per rank.
        budget = int(1.5 * rounds * tile_bytes)
        bcast_all = nodes * rounds * tile_bytes
        assert st["bytes_recv"] < budget, (rank, st, budget, bcast_all)
        dtp.destroy()
        ctx.comm_fini()
        return {}


def ptg_chain_rendezvous(rank: int, nodes: int, port: int, nb: int = 12,
                         elems: int = 4096):
    """RW chain with payloads far above the eager limit: every hop rides
    the GET rendezvous (ACTIVATE advertises a handle, the consumer pulls,
    PUT_DATA answers — reference: remote_dep.h:59-65).  After the fence,
    no snapshot bytes or pending pulls may remain (bounded comm memory)."""
    import os

    os.environ["PTC_MCA_comm_eager_limit"] = "1024"
    pt, ctx = _mk_ctx(rank, nodes, port)
    with ctx:
        esize = elems * 8
        arr = np.zeros((nodes, elems), dtype=np.int64)
        ctx.register_linear_collection("A", arr, elem_size=esize,
                                       nodes=nodes, myrank=rank)
        ctx.register_arena("t", esize)
        tp = pt.Taskpool(ctx, globals={"NB": nb})
        k = pt.L("k")
        tc = tp.task_class("Task")
        tc.param("k", 0, pt.G("NB"))
        tc.affinity("A", k % nodes)
        tc.flow("A", "RW",
                pt.In(pt.Mem("A", 0), guard=(k == 0)),
                pt.In(pt.Ref("Task", k - 1, flow="A")),
                pt.Out(pt.Ref("Task", k + 1, flow="A"), guard=(k < pt.G("NB"))),
                pt.Out(pt.Mem("A", 0), guard=(k == pt.G("NB"))),
                arena="t")

        def body(view):
            d = view.data("A", dtype=np.int64)
            d[0] += 1
            d[-1] = d[0]  # tail must survive every rendezvous hop intact

        tc.body(body)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        if rank == 0:
            assert arr[0, 0] == nb + 1, arr[0, 0]
            assert arr[0, -1] == nb + 1, arr[0, -1]
        rdv = ctx.comm_rdv_stats()
        # every inter-rank hop pulled (nodes>1 => most hops are remote)
        assert rdv["gets_sent"] > 0 or rdv["gets_served"] > 0 \
            or nodes == 1, rdv
        assert rdv["registered_bytes"] == 0, rdv
        assert rdv["pending_pulls"] == 0, rdv
        ctx.comm_fini()
        return {"A0": arr[0].copy()} if rank == 0 else {}


def ptg_bcast_rendezvous_dedup(rank: int, nodes: int, port: int,
                               elems: int = 2048):
    """Star fan-out of ONE big payload to every rank: the source must keep
    a single registered snapshot (per-rank payload dedup), served once per
    peer rank, and drop it after the last pull."""
    import os

    os.environ["PTC_MCA_comm_eager_limit"] = "1024"
    pt, ctx = _mk_ctx(rank, nodes, port)
    with ctx:
        esize = elems * 8
        arr = np.zeros((nodes, elems), dtype=np.int64)
        ctx.register_linear_collection("V", arr, elem_size=esize,
                                       nodes=nodes, myrank=rank)
        ctx.register_arena("t", esize)
        tp = pt.Taskpool(ctx, globals={"NR": nodes - 1})
        k = pt.L("k")
        root = tp.task_class("Root")
        root.affinity("V", 0)
        recv = tp.task_class("Recv")
        recv.param("k", 0, pt.G("NR"))
        recv.affinity("V", k)

        def root_body(view):
            d = view.data("X", dtype=np.int64)
            d[0] = 7
            d[-1] = 7

        root.flow("X", "W",
                  pt.Out(pt.Ref("Recv", pt.Range(0, pt.G("NR")), flow="X")),
                  arena="t")
        root.body(root_body)

        def recv_body(view):
            d = view.data("X", dtype=np.int64)
            assert d[0] == 7 and d[-1] == 7, (d[0], d[-1])
            view.data("Y", dtype=np.int64)[0] = 7

        recv.flow("X", "R", pt.In(pt.Ref("Root", flow="X")), arena="t")
        recv.flow("Y", "W", pt.Out(pt.Mem("V", k)), arena="t")
        recv.body(recv_body)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        if rank == 0:
            rdv = ctx.comm_rdv_stats()
            # one snapshot served once per remote rank, then dropped
            assert rdv["gets_served"] == nodes - 1, rdv
            assert rdv["registered_bytes"] == 0, rdv
        assert arr[rank, 0] == 7, arr[rank, 0]
        ctx.comm_fini()
        # element 0 only: the rest of the row is the Y arena's unwritten
        # bytes
        return {f"V{rank}": arr[rank, 0]}


def device_dataplane(rank: int, nodes: int, port: int, elems: int = 1024,
                     stream: int = 1):
    """Device-produced tile consumed by a device chore on another rank via
    the PK_DEVICE data plane: the producing host copy is never written
    (no d2h on rank 0) and the consumer stages nothing (no h2d on rank
    1): the payload moves mirror to mirror through the comm engine's
    rendezvous.  (The reference's transfer=True legs, its cross-process
    transfer plane, have no counterpart in the port yet.)"""
    os.environ["PTC_MCA_comm_eager_limit"] = "1024"
    os.environ["PTC_MCA_comm_stream"] = str(stream)
    pt, ctx = _mk_ctx(rank, nodes, port, nb_workers=1)

    with ctx:
        esize = elems * 4
        arr = np.zeros((nodes, elems), dtype=np.float32)
        if rank == 0:
            arr[0, :] = 2.0
        ctx.register_linear_collection("A", arr, elem_size=esize,
                                       nodes=nodes, myrank=rank)
        ctx.register_arena("t", esize)
        dev = _device(ctx)
        tp = pt.Taskpool(ctx)
        k = pt.L("k")
        prod = tp.task_class("Prod")
        prod.param("k", 0, 0)
        prod.affinity("A", 0)
        cons = tp.task_class("Cons")
        cons.param("k", 0, 0)
        cons.affinity("A", 1)
        prod.flow("X", "RW", pt.In(pt.Mem("A", 0)),
                  pt.Out(pt.Ref("Cons", k, flow="X")))
        cons.flow("X", "R", pt.In(pt.Ref("Prod", k, flow="X")), arena="t")
        cons.flow("Y", "W", pt.Out(pt.Mem("A", 1)), arena="t")
        dev.attach(prod, tp, kernel=lambda x: x * 3.0, reads=["X"],
                   writes=["X"], shapes={"X": (elems,)}, dtype=np.float32)
        dev.attach(cons, tp, kernel=lambda x: x + 1.0, reads=["X"],
                   writes=["Y"], shapes={"X": (elems,), "Y": (elems,)},
                   dtype=np.float32)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        if rank == 0:
            assert dev.stats.get("dp_sends", 0) >= 1, dev.stats
            # payload was served from the device mirror: the producing
            # host copy was never written back
            assert dev.stats["d2h_bytes"] == 0, dev.stats
            assert arr[0, 0] == 2.0, arr[0, 0]  # host tile untouched
        if rank == 1:
            assert dev.stats["dp_recv_bytes"] == esize, dev.stats
            # consumer read the delivered mirror straight from the cache
            assert dev.stats["h2d_bytes"] == 0, dev.stats
        _stop(dev)
        if rank == 1:
            np.testing.assert_allclose(arr[1], 7.0)  # 2*3 + 1
        ctx.comm_fini()
        return {"A1": arr[1].copy()} if rank == 1 else {}


def _xfer_pool(ctx, pt, dev, elems: int, cons_body=None):
    """Prod(0) on rank 0 writes X = 3 * A(0) on its device; Cons(0) on
    rank 1 reads X through the data plane and writes A(1) = X + 1 (on its
    device, or with `cons_body` on the host).  Returns (pool, A)."""
    nodes = ctx.nodes
    esize = elems * 4
    arr = np.zeros((nodes, elems), dtype=np.float32)
    if ctx.myrank == 0:
        arr[0, :] = np.arange(elems, dtype=np.float32)
    ctx.register_linear_collection("A", arr, elem_size=esize, nodes=nodes,
                                   myrank=ctx.myrank)
    ctx.register_arena("t", esize)
    tp = pt.Taskpool(ctx)
    k = pt.L("k")
    prod = tp.task_class("Prod")
    prod.param("k", 0, 0)
    prod.affinity("A", 0)
    cons = tp.task_class("Cons")
    cons.param("k", 0, 0)
    cons.affinity("A", 1)
    prod.flow("X", "RW", pt.In(pt.Mem("A", 0)),
              pt.Out(pt.Ref("Cons", k, flow="X")))
    cons.flow("X", "R", pt.In(pt.Ref("Prod", k, flow="X")), arena="t")
    cons.flow("Y", "W", pt.Out(pt.Mem("A", 1)), arena="t")
    dev.attach(prod, tp, kernel=lambda x: x * 3.0, reads=["X"],
               writes=["X"], shapes={"X": (elems,)}, dtype=np.float32)
    if cons_body is None:
        dev.attach(cons, tp, kernel=lambda x: x + 1.0, reads=["X"],
                   writes=["Y"], shapes={"X": (elems,), "Y": (elems,)},
                   dtype=np.float32)
    else:
        cons.body(cons_body)
    return tp, arr


def xfer_tile(rank: int, nodes: int, port: int, elems: int = 1 << 18,
              device: str = "cuda"):
    """The transfer plane (device.dp_transfer) between two processes on
    one card: rank 0's device-produced tile reaches rank 1's device chore
    as a CUDA IPC token, pulled card to card (dp_xfer_bytes), with no
    byte on the wire's host path (no producer d2h, no dp_recv_bytes, no
    consumer h2d).  Returns rank 1's A(1), its pull counters and the
    session pool's stats."""
    os.environ["PTC_MCA_comm_eager_limit"] = "1024"
    os.environ["PTC_MCA_device_dp_transfer"] = "1"
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.device import cuda as dc
    pt, ctx = _mk_ctx(rank, nodes, port, nb_workers=1)
    with ctx:
        dev = CudaDevice(ctx, device=device)
        tp, arr = _xfer_pool(ctx, pt, dev, elems)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        st = dict(dev.stats)
        _stop(dev)
        ctx.comm_fini()
    esize = elems * 4
    if rank == 0:
        assert st["dp_xfer_tokens"] == 1 and st["d2h_bytes"] == 0, st
        return {}
    assert st["dp_xfer_bytes"] == esize and st["dp_recv_bytes"] == 0, st
    assert st["h2d_bytes"] == 0, st
    pool = dc._xfer_sessions().stats()
    return {"A1": arr[1].copy(), "dev": {k: st[k] for k in (
        "dp_xfer_bytes", "dp_recv_bytes", "dp_xfer_pull_ns")},
        "pool": pool}


def xfer_failed_pull(rank: int, nodes: int, port: int, elems: int = 1 << 16,
                     host_consumer: bool = False):
    """A transfer-plane pull that fails after its token was sent: the
    consumer's pull bit is forced on, the producer's decision is forced to
    serve a token naming no memory, so the consumer's pull fails.  That
    counts in the consumer's dp_errors and fails the consuming task — its
    pool aborts (no byte path is left: the bytes were never sent) and
    A(1) is never written.  The producer's pool completes."""
    os.environ["PTC_MCA_comm_eager_limit"] = "1024"
    os.environ["PTC_MCA_device_dp_transfer"] = "1"
    from parsec_tpu_torch import _native as N
    from parsec_tpu_torch.device import cuda as dc
    if rank == 0:
        dc._xfer_peer_ok = lambda ctx, dev, from_rank: True
        dc._xfer_token = lambda ctx, dev, arr, raw, ev: dc._xfer_encode({
            "rank": 0, "addr": "nowhere", "raw": bool(raw),
            "dtype": "float32", "shape": [int(arr.numel())], "stride": [1],
            "offset": 0, "handle": b"\0" * 64, "size": int(arr.nbytes),
            "soffset": 0, "ref": b"none", "ref_offset": 0,
            "event": b"\0" * 64, "event_sync": True})
    pt, ctx = _mk_ctx(rank, nodes, port, nb_workers=1)
    with ctx:
        dev = _device(ctx)
        if rank == 1:
            N.lib.ptc_set_dp_can_pull(ctx._ptr, 1)

        def host_cons(view):
            x = view.data("X", np.float32, (elems,))
            view.data("Y", np.float32, (elems,))[...] = x + 1.0

        tp, arr = _xfer_pool(ctx, pt, dev, elems,
                             cons_body=host_cons if host_consumer else None)
        tp.run()
        aborted = False
        try:
            tp.wait()
        except RuntimeError:
            aborted = True
        ctx.comm_fence()
        st = dict(dev.stats)
        dev.stop()
        ctx.comm_fini()
    if rank == 0:
        assert not aborted and st["dp_xfer_tokens"] == 1, (aborted, st)
        return {}
    assert aborted, "the consuming pool completed after a failed pull"
    assert st["dp_errors"] == 1 and st["dp_xfer_bytes"] == 0, st
    assert not arr[1].any(), "A(1) was written from no bytes"
    return {"dp_errors": st["dp_errors"]}


def xfer_decision(rank: int, nodes: int, port: int, same_card: bool = True,
                  advertise: bool = True):
    """The producer's token decision over a live engine: rank 1 shares a
    (host, card) identity through the comm engine's blob frame at device
    init (the CPU device has none, so one is given and the probe forced);
    rank 0, whose device claims the same card or another, then decides
    whether rank 1 may take a token.  Returns rank 0's decision and the
    identity it read."""
    os.environ["PTC_MCA_device_dp_transfer"] = "1"
    from parsec_tpu_torch.device import cuda as dc
    dc._xfer_can_pull = lambda dev: True
    pt, ctx = _mk_ctx(rank, nodes, port, nb_workers=1)
    with ctx:
        dev = _device(ctx)
        card = "card-a" if rank == 1 or same_card else "card-b"
        dev._ident = {"host": "this-host", "card": card}
        if rank == 1 and advertise:
            dev._xfer_advertise()
        ctx.comm_fence()
        out = {}
        if rank == 0:
            out = {"decision": dc._xfer_peer_ok(ctx, dev, 1),
                   "identity": dc._peer_identity(ctx, 1)}
        ctx.comm_fence()
        dev.stop()
        ctx.comm_fini()
    return out


def _author_page(pool, key, seed, page, d):
    """Freeze one page whose bytes are a pure function of `seed` (the
    content-hash contract: same key, same bytes)."""
    p = pool.alloc()
    assert p is not None
    rng = np.random.RandomState(seed)
    pool.k_tile(p)[...] = rng.randn(page, d).astype(np.float32)
    pool.v_tile(p)[...] = rng.randn(page, d).astype(np.float32)
    pool.host_wrote(p)
    assert pool.freeze(p, key)
    pool.release([p])


def migrate_pages_wire(rank: int, nodes: int, port: int, n_keys: int = 4,
                       held: int = 0, page: int = 16, d: int = 16,
                       chunk: int = 1024):
    """Fleet handoff over the wire (tests/comm/_workers.py's worker of the
    same name): rank 0's PagePool holds `n_keys` frozen content-keyed
    pages, rank 1 the first `held` of them; build_page_migration moves
    only the wanted tail, each page's k|v payload a remote-dep pull that,
    with eager off and chunk_size below the page, streams as chunks.  The
    receiver asserts bit-exact imports and, when it held everything,
    that no payload chunk moved.  Returns rank 1's pages and counters."""
    build_page_migration, wanted_keys = _imp(
        "comm.migrate", "build_page_migration", "wanted_keys")
    PagePool, prefix_page_keys = _imp("ops.paged_attention", "PagePool",
                                      "prefix_page_keys")
    os.environ["PTC_MCA_comm_eager_limit"] = "0"
    os.environ["PTC_MCA_comm_chunk_size"] = str(chunk)
    os.environ["PTC_MCA_comm_inflight"] = "3"
    pt, ctx = _mk_ctx(rank, nodes, port)
    with ctx:
        pool = PagePool(ctx, n_keys + 2, page, d, name="MIGP")
        keys = prefix_page_keys("wire-model", list(range(n_keys * page)),
                                page)
        if rank == 0:
            for j, key in enumerate(keys):
                _author_page(pool, key, 1000 + j, page, d)
        elif held:
            for j in range(held):
                _author_page(pool, keys[j], 1000 + j, page, d)
        # both ranks agree on the execution space; the receiver's own
        # dedup decision is this plan
        wanted = list(range(held, n_keys))
        if rank == 1:
            assert wanted_keys(pool, keys) == keys[held:]
        tp = build_page_migration(pt, ctx, keys, wanted, src_pool=pool,
                                  dst_pool=pool, src_rank=0, dst_rank=1,
                                  page=page, d=d)
        if tp is None:
            assert held == n_keys
        else:
            tp.run()
            tp.wait()
        ctx.comm_fence()
        tune = ctx.comm_tuning()
        out = {}
        if rank == 1:
            st = pool.stats()
            assert st["imported"] == n_keys - held, st
            assert st["migrated_in_bytes"] == \
                (n_keys - held) * pool.bytes_per_page, st
            assert pool.probe(keys) == n_keys, st
            for j, key in enumerate(keys):
                rng = np.random.RandomState(1000 + j)
                p = pool._index[key]
                assert (pool.k_tile(p) ==
                        rng.randn(page, d).astype(np.float32)).all(), j
                assert (pool.v_tile(p) ==
                        rng.randn(page, d).astype(np.float32)).all(), j
            if wanted:
                assert page * 2 * d * 4 > chunk
                assert tune["chunks_recv"] > 0, tune
            else:
                assert tune["chunks_recv"] == 0, tune
            out = {"pages": np.stack([np.concatenate(
                [pool.k_tile(pool._index[k]), pool.v_tile(pool._index[k])])
                for k in keys]), "keys": list(keys),
                "imported": st["imported"], "built": tp is not None}
        if rank == 0 and wanted:
            assert pool.stats()["exported"] == len(wanted), pool.stats()
        rd = ctx.comm_rdv_stats()
        assert rd["pending_pulls"] == 0 and rd["registered_bytes"] == 0, rd
        ctx.comm_fini()
    return out


def migrate_kill_receiver(rank: int, nodes: int, port: int,
                          page: int = 512, d: int = 128,
                          chunk: int = 4096, die_after_s: float = 1.0):
    """Kill-a-receiver on the migration stream (tests/comm/_workers.py's
    worker of the same name): rank 1 crawls (a recv delay) and dies
    mid-chunked-page-pull; rank 0 must REAP its streaming session (reap
    counter up, registered bytes back to zero) instead of pinning the
    exported page.  Rank 1 pushes nothing."""
    import threading
    import time as _time
    build_page_migration = _imp("comm.migrate", "build_page_migration")
    PagePool = _imp("ops.paged_attention", "PagePool")
    apply_comm_faults = _imp("utils.faults", "apply_comm_faults")
    os.environ["PTC_MCA_comm_eager_limit"] = "0"
    os.environ["PTC_MCA_comm_chunk_size"] = str(chunk)
    os.environ["PTC_MCA_comm_inflight"] = "2"
    if rank == 1:
        apply_comm_faults(delay_us=20000)
    pt, ctx = _mk_ctx(rank, nodes, port)
    with ctx:
        pool = PagePool(ctx, 2, page, d, name="MIGP")
        key = "victim-page"
        if rank == 0:
            _author_page(pool, key, 7, page, d)
        tp = build_page_migration(pt, ctx, [key], [0], src_pool=pool,
                                  dst_pool=pool, src_rank=0, dst_rank=1,
                                  page=page, d=d)
        if rank == 1:
            threading.Timer(die_after_s, lambda: os._exit(0)).start()
        tp.run()
        if rank == 1:
            tp.wait()  # never finishes: the timer kills the process
            return None
        tp.wait()
        deadline = _time.time() + 90.0
        st = rd = None
        while _time.time() < deadline:
            st = ctx.comm_stream_stats()
            rd = ctx.comm_rdv_stats()
            if st["reaps"] >= 1 and rd["registered_bytes"] == 0:
                break
            _time.sleep(0.1)
        assert st is not None and st["reaps"] >= 1, (st, rd)
        assert rd["registered_bytes"] == 0, rd
        ctx.comm_fini()
    return {"reaps": st["reaps"]}


def live_rows(rank: int, nodes: int, port: int, elems: int = 16384,
              chunk: int = 4096):
    """The live sampler's comm rows on a rank: a chunked host broadcast
    from rank 0, a fence, then one LiveMonitor sample whose comm, stream
    and topo rows equal the engine's counters read at that moment.
    Returns the rows (their keys, and the byte counts of this SPMD
    program)."""
    LiveMonitor = _imp("profiling.live", "LiveMonitor")
    os.environ["PTC_MCA_comm_eager_limit"] = "0"
    os.environ["PTC_MCA_comm_chunk_size"] = str(chunk)
    pt, ctx = _mk_ctx(rank, nodes, port)
    with ctx:
        size = elems * 8
        arr = np.zeros((nodes, elems), dtype=np.int64)
        ctx.register_linear_collection("V", arr, elem_size=size,
                                       nodes=nodes, myrank=rank)
        ctx.register_arena("t", size)
        tp = pt.Taskpool(ctx, globals={"NT": nodes - 1})
        k = pt.L("k")
        root = tp.task_class("Root")
        root.affinity("V", 0)
        recv = tp.task_class("Recv")
        recv.param("k", 1, pt.G("NT"))
        recv.affinity("V", k)

        def root_body(view):
            view.data("X", dtype=np.int64, shape=(elems,))[:] = \
                np.arange(elems, dtype=np.int64)

        def recv_body(view):
            x = view.data("X", dtype=np.int64, shape=(elems,))
            assert (x == np.arange(elems, dtype=np.int64)).all()
        root.flow("X", "W", pt.Out(pt.Ref("Recv", pt.Range(1, pt.G("NT")),
                                          flow="X")), arena="t")
        root.body(root_body)
        recv.flow("X", "R", pt.In(pt.Ref("Root", flow="X")), arena="t")
        recv.body(recv_body)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        mon = LiveMonitor(ctx, path=os.devnull, interval=3600.0)
        # the peer's control frames (its fence, clock sync) may land
        # while sampling: a sample is held to the counters read right
        # before and after it once they agree
        for _ in range(50):
            before = ctx.comm_stats()
            mon._sample()
            rec = mon.latest()
            comm, ss, ts = (ctx.comm_stats(), ctx.comm_stream_stats(),
                            ctx.comm_topo_stats())
            if comm == before:
                break
        mon.stop()
        assert rec["comm"] == comm, (rec["comm"], comm)
        assert rec["stream"] == {k_: ss[k_] for k_ in (
            "sessions", "parked_gets", "overlap_fraction")}, rec["stream"]
        assert rec["topo"]["n_islands"] == ts["n_islands"]
        assert rec["topo"]["classes"] == {
            c: [r["bytes_sent"], r["msgs_sent"]]
            for c, r in ts["classes"].items()
            if r["msgs_sent"] or r["bytes_sent"]}, rec["topo"]
        if rank == 1:
            assert ctx.comm_tuning()["chunks_recv"] > 0
        ctx.comm_fini()
    return {rank: {"comm_keys": sorted(rec["comm"]),
                   "stream": sorted(rec["stream"]),
                   "topo": rec["topo"],
                   "bytes": [rec["comm"]["bytes_sent"] > 0,
                             rec["comm"]["bytes_recv"] > 0]}}


def stalled_pull(rank: int, nodes: int, port: int, elems: int = 2048,
                 chunk: int = 4096, delay_us: int = 300000):
    """A parked pull: rank 1's receives crawl (a recv delay per frame), so
    its chunked pull of rank 0's payload sits pending across watchdog
    ticks with no chunk and no byte arriving in between: the watchdog
    emits `stalled_pull`.  Returns rank 1's events."""
    Watchdog = _imp("profiling.metrics", "Watchdog")
    apply_comm_faults = _imp("utils.faults", "apply_comm_faults")
    os.environ["PTC_MCA_comm_eager_limit"] = "0"
    os.environ["PTC_MCA_comm_chunk_size"] = str(chunk)
    if rank == 1:
        apply_comm_faults(delay_us=delay_us)
    pt, ctx = _mk_ctx(rank, nodes, port)
    with ctx:
        size = elems * 8
        arr = np.zeros((nodes, elems), dtype=np.int64)
        ctx.register_linear_collection("V", arr, elem_size=size,
                                       nodes=nodes, myrank=rank)
        ctx.register_arena("t", size)
        tp = pt.Taskpool(ctx)
        prod = tp.task_class("Prod")
        prod.affinity("V", 0)
        cons = tp.task_class("Cons")
        cons.affinity("V", 1)

        def pbody(view):
            view.data("X", dtype=np.int64, shape=(elems,))[:] = 5

        def cbody(view):
            assert (view.data("X", dtype=np.int64, shape=(elems,)) == 5).all()
        prod.flow("X", "W", pt.Out(pt.Ref("Cons", flow="X")), arena="t")
        prod.body(pbody)
        cons.flow("X", "R", pt.In(pt.Ref("Prod", flow="X")), arena="t")
        cons.body(cbody)
        wd = Watchdog(ctx, interval=0.05) if rank == 1 else None
        tp.run()
        tp.wait()
        if wd is not None:
            wd.stop()
        ctx.comm_fence()
        ctx.comm_fini()
    if wd is None:
        return {}
    return {"events": [e for e in wd.events if e["type"] == "stalled_pull"]}


def scoped_serve(rank: int, nodes: int, port: int, out_dir: str,
                 nb: int = 14):
    """The two-rank serve round trip of tests/serve/_scope_workers.py's
    worker of the same name: two tenants each submit one rank-hopping RW
    chain through an admission-controlled Server (max_pools=1 keeps the
    admission order, and so the SPMD scope ids, deterministic).  Every
    rank saves its trace; rank 0 merges them and asserts that scope tags
    cross the wire, each request's flows match in both directions, its
    EXEC spans land on both ranks, its stage partition sums to the
    ticket's latency, its critical path lies inside its window, and the
    conformance record covers every pool with a sound wire bound.
    Returns rank 0's per-request figures."""
    Trace, take_trace = _imp("profiling", "Trace", "take_trace")
    Server, TenantConfig = _imp("serve", "Server", "TenantConfig")
    pt, ctx = _mk_ctx(rank, nodes, port)
    out = {}
    with ctx:
        ctx.profile_enable(2)
        srv = Server(ctx, [
            TenantConfig("hi", priority=2, weight=2, max_pools=1,
                         slo_ms=60_000),
            TenantConfig("lo", max_pools=1, slo_ms=60_000)])
        arr = np.zeros(nodes, dtype=np.int64)
        ctx.register_linear_collection("A", arr, elem_size=8, nodes=nodes,
                                       myrank=rank)
        ctx.register_arena("t", 8)

        def build(priority, weight):
            tp = pt.Taskpool(ctx, globals={"NB": nb}, priority=priority,
                             weight=weight)
            k = pt.L("k")
            tc = tp.task_class("Hop")
            tc.param("k", 0, pt.G("NB"))
            tc.affinity("A", k % nodes)
            tc.flow("A", "RW",
                    pt.In(pt.Mem("A", 0), guard=(k == 0)),
                    pt.In(pt.Ref("Hop", k - 1, flow="A")),
                    pt.Out(pt.Ref("Hop", k + 1, flow="A"),
                           guard=(k < pt.G("NB"))),
                    pt.Out(pt.Mem("A", 0), guard=(k == pt.G("NB"))),
                    arena="t")

            def body(view):
                view.data("A", dtype=np.int64)[0] += 1
            tc.body(body)
            return tp

        tickets = [srv.submit("hi", build, est_bytes=64),
                   srv.submit("lo", build, est_bytes=64)]
        assert srv.drain(timeout=60), [t.state for t in tickets]
        assert all(t.state == "done" and t.scope_id is not None
                   for t in tickets)
        sids = [t.scope_id for t in tickets]
        assert len(set(sids)) == 2, sids
        ctx.comm_fence()
        take_trace(ctx).save(os.path.join(out_dir, f"r{rank}.ptt"))
        ctx.comm_fence()
        if rank == 0:
            traces = [Trace.load(os.path.join(out_dir, f"r{r}.ptt"))
                      for r in range(nodes)]
            m = Trace.merge(traces)
            reg = ctx.scope_registry()
            sf = m.scope_flows()
            assert sf and set(sf.values()) == set(sids), sf
            for tkt in tickets:
                sub = m.filter_scope(tkt.scope_id)
                fl = sub.flows()
                assert len(fl) >= nb - 2, (tkt.tenant, len(fl))
                assert (fl[:, 6] >= 0).all()
                assert {(int(r[0]), int(r[1])) for r in fl} == \
                    {(0, 1), (1, 0)}
                phases = {e["ph"] for e in
                          sub.to_perfetto()["traceEvents"]}
                assert "s" in phases and "f" in phases, phases
                ev, rk = sub.events, sub.ranks
                assert set(int(r) for r in np.unique(
                    rk[(ev[:, 0] == 0) & (ev[:, 1] == 0)])) == {0, 1}
                tl = reg.scope_timeline(m, tkt.scope_id)
                assert tl["stages_sum_ns"] == tl["e2e_ns"], tl
                measured_ns = tkt.latency_s * 1e9
                assert abs(tl["e2e_ns"] - measured_ns) <= \
                    max(0.05 * measured_ns, 5e6), (tl["e2e_ns"],
                                                   measured_ns)
                assert tl["stages"]["exec_ns"] > 0
                assert tl["stages"]["wire_ns"] >= 0
                cp = sub.critical_path()
                assert cp["nodes"] >= nb // nodes, cp
                assert 0 < cp["total_ns"] <= tl["window_ns"]
                out[tkt.tenant] = {"flows": len(fl),
                                   "stages": sorted(tl["stages"]),
                                   "cp_nodes": cp["nodes"]}
            conf = ctx.stats()["scope"]["conformance"]
            assert conf["coverage"] == 1.0, conf
            assert conf["comm_bytes"]["sound"] is True, conf
            out["scopes"] = sorted(set(sf.values())) == sorted(sids)
        srv.close()
        ctx.comm_fini()
    return out


def blackbox_kill(rank: int, nodes: int, port: int, jdir: str,
                  victim: int) -> None:
    """One rank of the SIGKILL postmortem (tests/profiling/
    _blackbox_kill_worker.py on the port): every rank journals into
    `jdir`, registers a frozen-page-key inventory provider, opens a live
    request scope (admitted, never done) and checkpoints, replicating its
    inventory to every peer; the victim then spins until its parent
    SIGKILLs it; a survivor waits until its journal's peer-loss poll
    names the victim, stops the journal and exits 0."""
    import time as _time
    Journal = _imp("profiling", "Journal")
    pt = PKG
    ctx = pt.Context(nb_workers=2)
    ctx.set_rank(rank, nodes)
    ctx.comm_init(port)
    jr = Journal(ctx, dirpath=jdir, fsync_s=0.05, checkpoint_s=0.15)
    jr.register_inventory("frozen_page_keys",
                          lambda: [f"page:{rank}:{i}" for i in range(3)])
    reg = ctx.scope_registry()
    reg.tenant(f"t{rank}")
    sid = reg.new_scope(tenant=f"t{rank}", kind="request", rid=f"req-{rank}")
    reg.record_admitted(sid)
    ctx.comm_fence()
    jr.checkpoint()
    _time.sleep(0.5)
    with open(os.path.join(jdir, f"ready.{rank}"), "w") as f:
        f.write("1")
    if rank == victim:
        while True:
            _time.sleep(0.05)
    deadline = _time.time() + 60
    while _time.time() < deadline:
        if victim in jr.lost_peers():
            break
        _time.sleep(0.05)
    assert victim in jr.lost_peers(), "peer loss never detected"
    assert "jax" not in sys.modules, "a port worker imported jax"
    jr.stop()
    os._exit(0)


def ptg_block_cyclic_scale(rank: int, nodes: int, port: int, mt: int = 4,
                           nt: int = 4):
    """Owner-computes over a 2D block-cyclic collection: Scale(m,n) doubles
    its tile in place on the owning rank; pure local compute, validates
    affinity enumeration + collection vtables across ranks."""
    pt, ctx = _mk_ctx(rank, nodes, port)
    TwoDimBlockCyclic = _imp("data.collections", "TwoDimBlockCyclic")

    with ctx:
        P = 2 if nodes % 2 == 0 else 1
        Q = nodes // P
        A = TwoDimBlockCyclic(M=mt * 8, N=nt * 8, mb=8, nb=8, P=P, Q=Q,
                              nodes=nodes, myrank=rank, dtype=np.float32,
                              init=lambda c, m, n: np.full((8, 8), m + n + 1,
                                                           np.float32))
        A.register(ctx, "A")
        tp = pt.Taskpool(ctx, globals={"MT": mt - 1, "NT": nt - 1})
        m, n = pt.L("m"), pt.L("n")
        tc = tp.task_class("Scale")
        tc.param("m", 0, pt.G("MT")).param("n", 0, pt.G("NT"))
        tc.affinity("A", m, n)
        tc.flow("A", "RW", pt.In(pt.Mem("A", m, n)),
                pt.Out(pt.Mem("A", m, n)))

        def body(view):
            view.data("A", dtype=np.float32)[:] *= 2.0

        tc.body(body)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        for mm in range(mt):
            for nn in range(nt):
                if A.rank_of(mm, nn) == rank:
                    np.testing.assert_allclose(A.tile(mm, nn),
                                               2.0 * (mm + nn + 1))
        ctx.comm_fini()
        return _owned(A)


def potrf_dist(rank: int, nodes: int, port: int, N: int = 64, nb: int = 8,
               use_device: bool = False):
    """Distributed tiled Cholesky over a P×Q 2D block-cyclic grid — the
    DPLASMA shape the whole stack exists for (reference:
    two_dim_rectangle_cyclic.c:24 + remote_dep.c:454).  Cross-rank
    TRSM→SYRK/GEMM panel flows ride the remote-dep protocol (eager or
    rendezvous depending on tile size); the result is validated per-rank
    against a single-process numpy Cholesky of the same matrix."""
    pt, ctx = _mk_ctx(rank, nodes, port)
    build_potrf = _imp("algos", "build_potrf")
    TwoDimBlockCyclic = _imp("data.collections", "TwoDimBlockCyclic")

    with ctx:
        P = 2 if nodes % 2 == 0 else 1
        Q = nodes // P
        # same SPD matrix on every rank, deterministically
        rng = np.random.default_rng(7)
        B = rng.normal(size=(N, N)).astype(np.float64)
        full = (B @ B.T + N * np.eye(N)).astype(np.float32)
        A = TwoDimBlockCyclic(N, N, nb, nb, P=P, Q=Q, nodes=nodes,
                              myrank=rank, dtype=np.float32)
        A.register(ctx, "A")
        A.from_dense(full)
        dev = None
        if use_device:
            dev = _device(ctx)
        tp = build_potrf(ctx, A, dev=dev)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        if dev is not None:
            dev.flush()
            _stop(dev)
        L = np.linalg.cholesky(full.astype(np.float64))
        nt = A.mt
        for m in range(nt):
            for n in range(m + 1):  # lower triangle only: potrf_L touches it
                if A.rank_of(m, n) != rank:
                    continue
                ref = L[m * nb:(m + 1) * nb, n * nb:(n + 1) * nb]
                got = A.tile(m, n)
                if m == n:  # diagonal tiles: upper part is untouched input
                    got = np.tril(got)
                    ref = np.tril(ref)
                np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
        st = ctx.comm_stats()
        # panels really crossed ranks (none at one rank)
        assert st["msgs_sent"] > 0 or nodes == 1, st
        rdv = ctx.comm_rdv_stats()
        assert rdv["registered_bytes"] == 0, rdv
        assert rdv["pending_pulls"] == 0, rdv
        ctx.comm_fini()
        return _owned(A, lower=True)


def trtri_dist(rank: int, nodes: int, port: int, N: int = 64, nb: int = 8):
    """Distributed tiled triangular inversion over a P×Q grid (the
    dtrtri role): DIAG inverses broadcast along their row/column and the
    column chains' GEMM flows cross ranks.  Validated per-rank against
    numpy inv of the same lower-triangular factor."""
    pt, ctx = _mk_ctx(rank, nodes, port)
    build_trtri = _imp("algos", "build_trtri")
    TwoDimBlockCyclic = _imp("data.collections", "TwoDimBlockCyclic")

    with ctx:
        P = 2 if nodes % 2 == 0 else 1
        Q = nodes // P
        rng = np.random.default_rng(11)
        B = rng.normal(size=(N, N)).astype(np.float64)
        full = np.linalg.cholesky(B @ B.T + N * np.eye(N)) \
            .astype(np.float32)
        L = TwoDimBlockCyclic(N, N, nb, nb, P=P, Q=Q, nodes=nodes,
                              myrank=rank, dtype=np.float32)
        L.register(ctx, "L")
        L.from_dense(full)
        W = TwoDimBlockCyclic(N, N, nb, nb, P=P, Q=Q, nodes=nodes,
                              myrank=rank, dtype=np.float32)
        W.register(ctx, "W")
        tp = build_trtri(ctx, L, W)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        ref = np.linalg.inv(full.astype(np.float64))
        nt = W.mt
        for m in range(nt):
            for n in range(m + 1):
                if W.rank_of(m, n) != rank:
                    continue
                np.testing.assert_allclose(
                    W.tile(m, n), ref[m * nb:(m + 1) * nb,
                                      n * nb:(n + 1) * nb],
                    rtol=2e-3, atol=2e-3)
        st = ctx.comm_stats()
        # inverses really crossed ranks (none at one rank)
        assert st["msgs_sent"] > 0 or nodes == 1, st
        ctx.comm_fini()
        return _owned(W, lower=True)


def ptg_bcast_rendezvous_topo(rank: int, nodes: int, port: int,
                              topo: str = "chain", elems: int = 2048,
                              device: bool = False):
    """ONE payload far above the eager limit broadcast to every rank along
    a chain/binomial topology: the ACTIVATE_BCAST frames carry only a
    handle; every hop pulls from its parent and re-registers what it
    pulled for its own children (re-rooted rendezvous broadcast,
    reference: remote_dep.c:39-47, remote_dep_mpi.c:241-253).  Post-fence
    every rank's registration table must be empty (bounded comm memory).
    With device=True the root produces the tile on its device and the
    broadcast must never materialize it on the producing host."""
    import os

    os.environ["PTC_MCA_comm_eager_limit"] = "1024"
    pt, ctx = _mk_ctx(rank, nodes, port, nb_workers=1, topo=topo)
    dev = None
    if device:
        dev = _device(ctx)
    with ctx:
        esize = elems * 4
        arr = np.zeros((nodes, elems), dtype=np.float32)
        ctx.register_linear_collection("V", arr, elem_size=esize,
                                       nodes=nodes, myrank=rank)
        ctx.register_arena("t", esize)
        tp = pt.Taskpool(ctx, globals={"NR": nodes - 1})
        k = pt.L("k")
        root = tp.task_class("Root")
        root.affinity("V", 0)
        recv = tp.task_class("Recv")
        # device variant: no local consumer on the root — a rank-0 CPU
        # read would (correctly) pull the mirror and the d2h==0 assertion
        # below is specifically about the BROADCAST not materializing it
        k0 = 1 if dev is not None else 0
        recv.param("k", k0, pt.G("NR"))
        recv.affinity("V", k)
        root.flow("X", "W",
                  pt.Out(pt.Ref("Recv", pt.Range(k0, pt.G("NR")), flow="X")),
                  arena="t")
        if dev is not None:
            import torch

            # one Root task: a launch of one lane
            dev.attach(root, tp,
                       kernel=lambda: torch.full((1, elems), 7.0),
                       reads=[], writes=["X"], shapes={"X": (elems,)},
                       dtype=np.float32)

        def root_body(view):
            d = view.data("X", dtype=np.float32)
            d[...] = 7.0

        root.body(root_body)

        def recv_body(view):
            d = view.data("X", dtype=np.float32)
            assert d[0] == 7.0 and d[-1] == 7.0, (d[0], d[-1])
            view.data("Y", dtype=np.float32)[0] = float(d[elems // 2])

        recv.flow("X", "R", pt.In(pt.Ref("Root", flow="X")), arena="t")
        recv.flow("Y", "W", pt.Out(pt.Mem("V", k)), arena="t")
        recv.body(recv_body)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        rdv = ctx.comm_rdv_stats()
        # bounded comm memory on EVERY rank (root and relays alike)
        assert rdv["registered_bytes"] == 0, (rank, rdv)
        assert rdv["pending_pulls"] == 0, (rank, rdv)
        if rank >= k0:
            assert arr[rank, 0] == 7.0, arr[rank, 0]
        if dev is not None:
            if rank == 0:
                # device-resident broadcast: producer host copy untouched
                assert dev.stats["d2h_bytes"] == 0, dev.stats
                assert dev.stats.get("dp_sends", 0) >= 1, dev.stats
            _stop(dev)
        ctx.comm_fini()
        # element 0 only: the rest of the row is the Y arena's unwritten
        # bytes
        return {f"V{rank}": arr[rank, 0]} if rank >= k0 else {}


def dtd_chain_counting_termdet(rank: int, nodes: int, port: int,
                               nb_tiles: int = 4, rounds: int = 6,
                               device: bool = False):
    """Distributed DTD quiesced by the COUNTING termdet module instead of
    the fence (reference: fourcounter global TD for DSLs that cannot
    count tasks a priori, termdet_fourcounter.h:16-59) — with optional
    device-async completion (device chores complete from the manager
    thread while the wave runs)."""
    pt, ctx = _mk_ctx(rank, nodes, port)
    DtdTaskpool = _imp("dsl.dtd", "DtdTaskpool")
    dev = None
    if device:
        dev = _device(ctx)
    with ctx:
        datas = [ctx.data(i, np.zeros(4, dtype=np.float32))
                 for i in range(nb_tiles)]
        dtp = DtdTaskpool(ctx, window=64)
        tiles = [dtp.tile_of(d, owner=i % nodes)
                 for i, d in enumerate(datas)]

        def step(view):
            src = view.data(0, dtype=np.float32)
            dst = view.data(1, dtype=np.float32)
            dst[0] = src[0] + 1.0

        for _ in range(rounds):
            for t in range(1, nb_tiles):
                if dev is not None and t % 2 == 0:
                    dtp.insert_cuda_task(
                        dev, lambda a, b: a + 1.0,
                        (tiles[t - 1], "INPUT"), (tiles[t], "INOUT"),
                        shapes={0: (4,), 1: (4,)}, dtype=np.float32)
                else:
                    dtp.insert_task(step, (tiles[t - 1], "INPUT"),
                                    (tiles[t], "INOUT"))
        dtp.wait()
        ctx.comm_quiesce(dtp.tp)
        if dev is not None:
            dev.flush()
        for i, d in enumerate(datas):
            if i % nodes == rank and rounds >= nb_tiles:
                v = np.frombuffer(d.array, dtype=np.float32)[0]
                assert v == i, (i, v)
        if dev is not None:
            _stop(dev)
        dtp.destroy()
        ctx.comm_fini()
        # element 0: the host step writes it alone, a device task the
        # whole tile
        return {f"T{i}": np.frombuffer(d.array, dtype=np.float32)[0]
                for i, d in enumerate(datas) if i % nodes == rank}


def ptg_datatype_column(rank: int, nodes: int, port: int,
                        eager_limit: int | None = None):
    """Wire-datatype layer (reference: parsec/datatype/datatype_mpi.c —
    per-dep MPI types for non-contiguous cross-rank movement): rank 0
    owns a row-major 8x8 int64 tile and sends its COLUMN 0 (elem 8 B,
    count 8, stride 64 B) to rank 1, whose IN dep scatters the 8 packed
    values into a strided receive layout (stride 16 B: every other
    int64).  eager_limit=0 forces the GET rendezvous path so both wire
    forms are covered."""
    import os

    if eager_limit is not None:
        os.environ["PTC_MCA_comm_eager_limit"] = str(eager_limit)
    pt, ctx = _mk_ctx(rank, nodes, port)
    with ctx:
        n = 8
        tile_bytes = n * n * 8
        buf = np.zeros(n * n, dtype=np.int64)
        if rank == 0:
            buf[:] = np.arange(n * n)  # value at (i, j) = i*n + j
        ctx.register_linear_collection("A", buf, elem_size=tile_bytes,
                                       nodes=nodes, myrank=rank)
        # SPMD-ordered datatype registration (ids must match across ranks)
        ctx.register_datatype("colT", 8, n, n * 8)   # column of the tile
        ctx.register_datatype("recvT", 8, n, 16)     # every other slot
        tp = pt.Taskpool(ctx, globals={})
        prod = tp.task_class("Prod")
        prod.param("z", 0, 0)
        prod.affinity("A", 0)
        prod.flow("T", "RW",
                  pt.In(pt.Mem("A", 0)),
                  pt.Out(pt.Ref("Cons", 1, flow="X"), dtype="colT"))
        prod.body(lambda view: None)
        cons = tp.task_class("Cons")
        cons.param("z", 1, 1)
        cons.affinity("A", 1)
        cons.flow("X", "READ",
                  pt.In(pt.Ref("Prod", 0, flow="T"), dtype="recvT"))
        got = []

        def cons_body(view):
            got.append(view.data("X", dtype=np.int64).copy())

        cons.body(cons_body)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        if rank == 1 % nodes:
            assert len(got) == 1, got
            x = got[0]
            # extent = (8-1)*16 + 8 = 120 B -> 15 int64 slots
            assert x.size == 15, x.size
            col = np.arange(n) * n  # column 0 of the row-major tile
            np.testing.assert_array_equal(x[0::2], col)
            np.testing.assert_array_equal(x[1::2], 0)
        if eager_limit == 0:
            # the payload must have ridden the rendezvous, not the frame
            st = ctx.comm_rdv_stats()
            key = "gets_sent" if rank == 1 % nodes else "gets_served"
            assert st.get(key, 0) >= 1 or nodes == 1, st
        ctx.comm_fini()
        return {"X": got[0]} if rank == 1 % nodes else {}


def ptg_chain_bogus_engine(rank: int, nodes: int, port: int):
    """An unknown comm.engine name falls back to MCA priority selection
    (highest-priority available component = tcp) and the job still runs —
    the open/query protocol of the reference's component framework."""
    import os

    os.environ["PTC_MCA_comm_engine"] = "no_such_transport"
    return ptg_chain(rank, nodes, port, nb=8)


def ptg_chain_with_stray_client(rank: int, nodes: int, port: int):
    """A stray client with a bad handshake (wrong magic — e.g. a port
    scanner or a mismatched build) must be rejected without consuming a
    peer slot; the real mesh then forms and runs normally."""
    import socket
    import time

    if rank == 1:
        s = socket.socket()
        for _ in range(100):
            try:
                s.connect(("127.0.0.1", port))  # rank 0's listen port
                break
            except OSError:
                time.sleep(0.05)
        s.send(b"NOTPTC_HANDSHK")  # 12+ bytes, wrong magic
        s.close()
    return ptg_chain(rank, nodes, port, nb=8)


def rendezvous_reaped_on_peer_loss(rank: int, nodes: int, port: int):
    """Rank 0 advertises a big tile to rank 1 via the GET rendezvous;
    rank 1 dies without ever pulling.  The registration must be REAPED
    when the loss is detected (a crashed consumer must not pin the
    snapshot forever), leaving registered_bytes == 0."""
    import os
    import time

    os.environ["PTC_MCA_comm_eager_limit"] = "1024"  # force rendezvous
    pt, ctx = _mk_ctx(rank, nodes, port)
    arr = np.zeros(nodes * 64 * 1024, dtype=np.uint8)
    ctx.register_linear_collection("A", arr, elem_size=64 * 1024,
                                   nodes=nodes, myrank=rank)
    if rank == 1:
        time.sleep(2.0)  # stay connected long enough to receive ACTIVATE
        ctx.destroy()    # die without pulling: no fence, no goodbye
        return
    tp = pt.Taskpool(ctx, globals={})
    prod = tp.task_class("Prod")
    prod.param("z", 0, 0)
    prod.affinity("A", 0)
    prod.flow("T", "RW", pt.In(pt.Mem("A", 0)),
              pt.Out(pt.Ref("Cons", 1, flow="X")))
    prod.body(lambda v: None)
    cons = tp.task_class("Cons")
    cons.param("z", 1, 1)
    cons.affinity("A", 1)
    cons.flow("X", "READ", pt.In(pt.Ref("Prod", 0, flow="T")))
    cons.body(lambda v: None)
    tp.run()
    tp.wait()  # local Prod completes; the 64K payload is now registered
    deadline = time.monotonic() + 2
    st = ctx.comm_rdv_stats()
    while st["registered_bytes"] < 64 * 1024 and \
            time.monotonic() < deadline:
        time.sleep(0.05)
        st = ctx.comm_rdv_stats()
    assert st["registered_bytes"] >= 64 * 1024, st
    # wait for the loss to be detected and the registration reaped
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        st = ctx.comm_rdv_stats()
        if st["registered_bytes"] == 0:
            break
        time.sleep(0.2)
    assert st["registered_bytes"] == 0, st
    ctx.destroy()


def fence_lost_peer(rank: int, nodes: int, port: int):
    """Rank 1 tears down without fencing (crash stand-in: its connection
    just closes); rank 0's fence must ERROR (peer-lost detection) instead
    of spinning forever."""
    import time

    pt, ctx = _mk_ctx(rank, nodes, port)
    arr = np.zeros(nodes, dtype=np.int64)
    ctx.register_linear_collection("A", arr, elem_size=8,
                                   nodes=nodes, myrank=rank)
    if rank == 1:
        time.sleep(1.0)  # let rank 0 reach its fence first
        ctx.destroy()    # abrupt teardown: no fence, no goodbye
        return
    t0 = time.monotonic()
    try:
        ctx.comm_fence()
        raise AssertionError("fence returned despite dead peer")
    except RuntimeError as e:
        # fail-FAST detection, not a timeout fallback
        assert "peer lost" in str(e), e
        assert time.monotonic() - t0 < 30.0, "detection too slow"
    finally:
        ctx.destroy()


def ptg_remote_read_reshape(rank: int, nodes: int, port: int):
    """Ported remote_read_reshape.jdf (reference
    tests/collections/reshape/): rank 0's tile travels raw over the wire
    to rank 1, whose IN dep declares [type = LOWER] — the reshape future
    resolves at delivery on the consumer rank.  The consumer zeroes its
    (new) copy and writes back with [type_data = LOWER]: a typed remote
    PUT that updates only the selected region of the owner's tile."""
    pt, ctx = _mk_ctx(rank, nodes, port)
    with ctx:
        n = 8
        tile = np.ones((n, n), dtype=np.int32)
        ctx.register_linear_collection("A", tile, elem_size=tile.nbytes,
                                       nodes=nodes, myrank=rank)
        # SPMD registration order: ids match across ranks
        segs = [(i * n * 4, (i + 1) * 4) for i in range(n)]  # lower+diag
        ctx.register_datatype_indexed("LOWER", segs)
        tp = pt.Taskpool(ctx, globals={})
        prod = tp.task_class("Prod")
        prod.param("z", 0, 0)
        prod.affinity("A", 0)
        prod.flow("T", "RW",
                  pt.In(pt.Mem("A", 0)),
                  pt.Out(pt.Ref("Cons", 1, flow="X")))
        prod.body(lambda view: None)
        cons = tp.task_class("Cons")
        cons.param("z", 1, 1)
        cons.affinity("A", 1)
        cons.flow("X", "RW",
                  pt.In(pt.Ref("Prod", 0, flow="T"), ltype="LOWER"),
                  pt.Out(pt.Mem("A", 0), ltype="LOWER"))

        def cons_body(view):
            x = view.data("X", dtype=np.int32, shape=(n, n))
            m = np.tril(np.ones((n, n), dtype=bool))
            assert (x[m] == 1).all(), "selected bytes must arrive"
            assert (x[~m] == 0).all(), "non-selected bytes defined-zero"
            x[:] = 0

        cons.body(cons_body)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        if rank == 1 % nodes:
            conv, _ = ctx.reshape_stats()
            assert conv == 1, conv  # one future, on the consumer rank
        if rank == 0:
            m = np.tril(np.ones((n, n), dtype=bool))
            assert (tile[m] == 0).all(), tile
            assert (tile[~m] == 1).all(), tile  # typed PUT left upper alone
        ctx.comm_fini()
        return {"A0": tile.copy()} if rank == 0 else {}


def ptg_remote_cast(rank: int, nodes: int, port: int):
    """Cross-rank dtype conversion through the dep type system, with no
    manual apply-taskpool detour: rank 0 produces float64, rank 1's IN
    dep declares [type = f64->f32] — the wire carries raw f64 and the
    consumer's reshape future converts at delivery."""
    pt, ctx = _mk_ctx(rank, nodes, port)
    with ctx:
        n = 16
        buf = np.linspace(0.0, 2.0, n, dtype=np.float64)
        ctx.register_linear_collection("A", buf, elem_size=buf.nbytes,
                                       nodes=nodes, myrank=rank)
        ctx.register_datatype_cast("D2S", np.float64, np.float32)
        tp = pt.Taskpool(ctx, globals={})
        prod = tp.task_class("Prod")
        prod.param("z", 0, 0)
        prod.affinity("A", 0)
        prod.flow("T", "RW",
                  pt.In(pt.Mem("A", 0)),
                  pt.Out(pt.Ref("Cons", 1, flow="X")))
        prod.body(lambda view: None)
        cons = tp.task_class("Cons")
        cons.param("z", 1, 1)
        cons.affinity("A", 1)
        cons.flow("X", "READ",
                  pt.In(pt.Ref("Prod", 0, flow="T"), ltype="D2S"))
        got = []

        def cons_body(view):
            got.append(view.data("X", dtype=np.float32).copy())

        cons.body(cons_body)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        if rank == 1 % nodes:
            assert len(got) == 1
            x = got[0]
            assert x.size == n and x.dtype == np.float32
            np.testing.assert_allclose(
                x, np.linspace(0.0, 2.0, n, dtype=np.float64).astype(
                    np.float32))
        ctx.comm_fini()
        return {"X": got[0]} if rank == 1 % nodes else {}


def jdf_remote_type_cast(rank: int, nodes: int, port: int):
    """The combined JDF [type = X] cross-rank path: the
    front-end maps [type] to BOTH the local reshape and the wire type, so
    the producer converts pre-send (its reshape future), ships the
    converted bytes marked shaped-as-X, and the consumer must NOT
    re-apply the cast (the frame's shaped field suppresses it)."""
    compile_jdf = _imp("dsl.jdf", "compile_jdf")

    pt, ctx = _mk_ctx(rank, nodes, port)
    with ctx:
        n = 8
        src_buf = np.zeros((2, n), dtype=np.float64)
        src_buf[0] = np.linspace(1.0, 2.0, n)
        sink = np.zeros((2, n), dtype=np.float32)
        ctx.register_linear_collection("A", src_buf, elem_size=n * 8,
                                       nodes=nodes, myrank=rank)
        ctx.register_linear_collection("B", sink, elem_size=n * 4,
                                       nodes=nodes, myrank=rank)
        ctx.register_datatype_cast("D2S", np.float64, np.float32)
        jsrc = """
P(z)
z = 0 .. 0
: A(0)
RW T <- A(0)
     -> X C(1)      [type = D2S]
BODY
{
pass
}
END

C(z)
z = 1 .. 1
: A(1)
RW X <- T P(0)      [type = D2S]
     -> B(1)
BODY
{
pass
}
END
"""
        b = compile_jdf(jsrc, ctx, globals={}, dtype=np.float32)
        b.run().wait()
        ctx.comm_fence()
        if rank == 1 % nodes:
            conv, _ = ctx.reshape_stats()
            # the conversion ran ONCE, on the producer rank; this rank
            # received already-converted bytes (shaped suppression)
            expect = np.linspace(1.0, 2.0, n, dtype=np.float64).astype(
                np.float32)
            np.testing.assert_allclose(sink[1], expect)
        ctx.comm_fini()
        return {"B1": sink[1].copy()} if rank == 1 % nodes else {}


def gemm_dist(rank: int, nodes: int, port: int, N: int = 64, nb: int = 8,
              topo: str = "star", use_device: bool = False,
              eager_limit: int | None = None):
    """Distributed GEMM with reader-task broadcasts placed at A/B's
    owners (the DPLASMA read_A/read_B shape): every A tile fans out to a
    Gemm row, every B tile to a Gemm column, riding the collective
    propagation machinery; C stays owner-computes.  Validated per owned
    tile against numpy."""
    import os

    if eager_limit is not None:
        os.environ["PTC_MCA_comm_eager_limit"] = str(eager_limit)
    pt, ctx = _mk_ctx(rank, nodes, port, topo=topo)
    build_gemm_dist = _imp("algos.gemm", "build_gemm_dist")
    TwoDimBlockCyclic = _imp("data.collections", "TwoDimBlockCyclic")

    with ctx:
        P = 2 if nodes % 2 == 0 else 1
        Q = nodes // P
        rng = np.random.default_rng(11)
        a = rng.normal(size=(N, N)).astype(np.float32)
        b = rng.normal(size=(N, N)).astype(np.float32)
        c0 = rng.normal(size=(N, N)).astype(np.float32)
        mk = lambda: TwoDimBlockCyclic(N, N, nb, nb, P=P, Q=Q, nodes=nodes,
                                       myrank=rank, dtype=np.float32)
        A, B, C = mk(), mk(), mk()
        A.register(ctx, "A"); A.from_dense(a)
        B.register(ctx, "B"); B.from_dense(b)
        C.register(ctx, "C"); C.from_dense(c0)
        dev = None
        if use_device:
            dev = _device(ctx)
        tp = build_gemm_dist(ctx, A, B, C, dev=dev)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        if dev is not None:
            dev.flush()
            _stop(dev)
        ref = c0.astype(np.float64) + a.astype(np.float64) @ b.astype(
            np.float64)
        nt = C.mt
        for m in range(nt):
            for n in range(nt):
                if C.rank_of(m, n) != rank:
                    continue
                np.testing.assert_allclose(
                    C.tile(m, n),
                    ref[m * nb:(m + 1) * nb, n * nb:(n + 1) * nb],
                    rtol=2e-3, atol=2e-3)
        st = ctx.comm_stats()
        # panels really crossed ranks (none at one rank)
        assert st["msgs_sent"] > 0 or nodes == 1, st
        if eager_limit == 0:
            # the broadcasts must have ridden the GET rendezvous, and the
            # registration tables must be fully drained post-fence
            rdv = ctx.comm_rdv_stats()
            assert rdv.get("gets_sent", 0) + rdv.get("gets_served", 0) > 0 \
                or nodes == 1, rdv
            assert rdv.get("registered_bytes", 0) == 0, rdv
        ctx.comm_fini()
        return _owned(C)


def getrf_dist(rank: int, nodes: int, port: int, N: int = 64, nb: int = 8):
    """Distributed LU-nopiv over a PxQ block-cyclic grid: like potrf, all
    collection reads are affine with placement, so the single-rank
    taskpool runs distributed as-is — row/column panel flows cross ranks
    on the remote-dep protocol (reference: dplasma dgetrf_nopiv over
    two_dim_rectangle_cyclic)."""
    pt, ctx = _mk_ctx(rank, nodes, port)
    build_getrf_nopiv, getrf_nopiv_reference = _imp(
        "algos.lu", "build_getrf_nopiv", "getrf_nopiv_reference")
    TwoDimBlockCyclic = _imp("data.collections", "TwoDimBlockCyclic")

    with ctx:
        P = 2 if nodes % 2 == 0 else 1
        Q = nodes // P
        rng = np.random.default_rng(13)
        full = (rng.normal(size=(N, N)) + N * np.eye(N)).astype(np.float32)
        A = TwoDimBlockCyclic(N, N, nb, nb, P=P, Q=Q, nodes=nodes,
                              myrank=rank, dtype=np.float32)
        A.register(ctx, "A")
        A.from_dense(full)
        tp = build_getrf_nopiv(ctx, A)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        ref = getrf_nopiv_reference(full)
        for m in range(A.mt):
            for n in range(A.nt):
                if A.rank_of(m, n) != rank:
                    continue
                np.testing.assert_allclose(
                    A.tile(m, n),
                    ref[m * nb:(m + 1) * nb, n * nb:(n + 1) * nb],
                    rtol=3e-3, atol=3e-3)
        st = ctx.comm_stats()
        assert st["msgs_sent"] > 0 or nodes == 1, st
        ctx.comm_fini()
        return _owned(A)


def trsm_dist(rank: int, nodes: int, port: int, N: int = 48, nb: int = 8,
              nrhs: int = 16):
    """Distributed triangular solve with L and B on DIFFERENT grids
    (L on PxQ, B on 1xnodes): every ReadDiag/ReadL broadcast crosses
    ranks to reach the solve/update rows — the reader-task pattern is
    what makes mixed distributions legal at all."""
    pt, ctx = _mk_ctx(rank, nodes, port)
    build_trsm = _imp("algos.trsm", "build_trsm")
    TwoDimBlockCyclic = _imp("data.collections", "TwoDimBlockCyclic")

    with ctx:
        P = 2 if nodes % 2 == 0 else 1
        Q = nodes // P
        rng = np.random.default_rng(17)
        l = np.tril(rng.normal(size=(N, N))).astype(np.float32)
        l += 2 * N * np.eye(N, dtype=np.float32)
        b = rng.normal(size=(N, nrhs)).astype(np.float32)
        L = TwoDimBlockCyclic(N, N, nb, nb, P=P, Q=Q, nodes=nodes,
                              myrank=rank, dtype=np.float32)
        B = TwoDimBlockCyclic(N, nrhs, nb, nb, P=1, Q=nodes, nodes=nodes,
                              myrank=rank, dtype=np.float32)
        L.register(ctx, "L")
        B.register(ctx, "B")
        L.from_dense(l)
        B.from_dense(b)
        tp = build_trsm(ctx, L, B)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        ref = np.linalg.solve(np.tril(l).astype(np.float64),
                              b.astype(np.float64))
        for m in range(B.mt):
            for n in range(B.nt):
                if B.rank_of(m, n) != rank:
                    continue
                np.testing.assert_allclose(
                    B.tile(m, n),
                    ref[m * nb:(m + 1) * nb, n * nb:(n + 1) * nb],
                    rtol=2e-3, atol=2e-3)
        st = ctx.comm_stats()
        assert st["msgs_sent"] > 0 or nodes == 1, st
        ctx.comm_fini()
        return _owned(B)


def geqrf_dist(rank: int, nodes: int, port: int, N: int = 48, nb: int = 8):
    """Distributed tiled QR: GEQRT/UNMQR panel broadcasts and the TSQRT
    R-chain cross ranks over the remote-dep protocol; arena-allocated Q
    blocks travel as ordinary flow payloads (the third dense-LA
    factorization through the runtime)."""
    pt, ctx = _mk_ctx(rank, nodes, port)
    build_geqrf = _imp("algos.qr", "build_geqrf")
    TwoDimBlockCyclic = _imp("data.collections", "TwoDimBlockCyclic")

    with ctx:
        P = 2 if nodes % 2 == 0 else 1
        Q = nodes // P
        rng = np.random.default_rng(19)
        a0 = rng.normal(size=(N, N)).astype(np.float32)
        A = TwoDimBlockCyclic(N, N, nb, nb, P=P, Q=Q, nodes=nodes,
                              myrank=rank, dtype=np.float32)
        A.register(ctx, "A")
        A.from_dense(a0)
        tp = build_geqrf(ctx, A)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        ref = np.linalg.qr(a0.astype(np.float64), mode="r")
        # per-rank partial check: owned below-diagonal tiles must be zero
        for m in range(A.mt):
            for n in range(m):
                if A.rank_of(m, n) == rank:
                    np.testing.assert_allclose(A.tile(m, n), 0, atol=2e-4)
        # R is unique up to ROW signs; a rank on a 2D grid may own no
        # diagonal tile of a row, so derive each row's sign from its
        # largest oracle entry WITHIN the owned tile and compare the
        # whole row slice under that sign
        for m in range(A.mt):
            for n in range(m, A.nt):
                if A.rank_of(m, n) != rank:
                    continue
                got = A.tile(m, n).astype(np.float64)
                want = ref[m * nb:(m + 1) * nb, n * nb:(n + 1) * nb]
                for r in range(nb):
                    j = int(np.argmax(np.abs(want[r])))
                    if abs(want[r, j]) < 1e-6:
                        np.testing.assert_allclose(got[r], 0, atol=2e-2)
                        continue
                    sg = np.sign(got[r, j]) * np.sign(want[r, j])
                    np.testing.assert_allclose(got[r] * sg, want[r],
                                               rtol=2e-2, atol=2e-2)
        st = ctx.comm_stats()
        assert st["msgs_sent"] > 0 or nodes == 1, st
        ctx.comm_fini()
        return _owned(A)


def jdf_ctlgat(rank: int, nodes: int, port: int, nt: int = 8):
    """Ported ctlgat.jdf (reference tests/dsl/ptg/controlgather): TA(k)
    and TB(k) run on rank k%nodes and their CTL flows gather into TC(0)
    on rank 0 — pure cross-rank control dependencies (no payloads),
    including the reference's `; 0` priority clause."""
    compile_jdf = _imp("dsl.jdf", "compile_jdf")

    pt, ctx = _mk_ctx(rank, nodes, port)
    with ctx:
        buf = np.zeros(max(nodes, nt), dtype=np.int64)
        ctx.register_linear_collection("A", buf, elem_size=8,
                                       nodes=nodes, myrank=rank)
        src = """
NT [ type = int ]

TA(k)
k = 0 .. NT - 1
: A(k)
CTL X -> X TC(0)
; 0
BODY
{
ran.append(("TA", k))
}
END

TB(k)
k = 0 .. NT - 1
: A(k)
CTL X -> Y TC(0)
; 0
BODY
{
ran.append(("TB", k))
}
END

TC(k)
k = 0 .. 0
: A(0)
CTL X <- X TA(0 .. NT - 1)
CTL Y <- X TB(0 .. NT - 1)
; 0
BODY
{
ran.append(("TC", k))
}
END
"""
        ran = []
        b = compile_jdf(src, ctx, globals={"NT": nt}, dtype=np.int64,
                        late_bound=["ran"])
        b.scope["ran"] = ran
        b.run().wait()
        ctx.comm_fence()
        mine_a = [("TA", k) for k in range(nt) if k % nodes == rank]
        mine_b = [("TB", k) for k in range(nt) if k % nodes == rank]
        got_ab = [x for x in ran if x[0] != "TC"]
        assert sorted(got_ab) == sorted(mine_a + mine_b), (rank, ran)
        if rank == 0:
            assert ran.count(("TC", 0)) == 1, ran
            # the gather fired LAST on this rank's local order for the
            # producers rank 0 owns
            idx = ran.index(("TC", 0))
            assert all(i < idx for i, x in enumerate(ran)
                       if x[0] != "TC"), ran
        else:
            assert ("TC", 0) not in ran, ran
        ctx.comm_fini()
        return {"ran": sorted(x for x in ran if x[0] != "TC")}


def potrf_panels_dist(rank: int, nodes: int, port: int, N: int = 128,
                      nb: int = 16, use_device: bool = False,
                      scheduler: str = "lfq"):
    """Distributed PANEL-granular Cholesky: full-height N x nb panels
    cyclic over ranks (the ScaLAPACK-style 1-D panel distribution).
    Every factored panel F(k) broadcasts to the ranks owning later
    panels (big payloads: the whole panel rides the remote-dep protocol,
    eager or rendezvous by size); validated per-rank against numpy."""
    pt, ctx = _mk_ctx(rank, nodes, port, scheduler=scheduler)
    assert ctx.scheduler_name == scheduler  # no silent fallback
    build_potrf_panels = _imp("algos", "build_potrf_panels")
    TwoDimBlockCyclic = _imp("data.collections", "TwoDimBlockCyclic")

    with ctx:
        rng = np.random.default_rng(7)
        B = rng.normal(size=(N, N)).astype(np.float64)
        full = (B @ B.T + N * np.eye(N)).astype(np.float32)
        A = TwoDimBlockCyclic(N, N, N, nb, P=1, Q=nodes, nodes=nodes,
                              myrank=rank, dtype=np.float32)
        A.register(ctx, "A")
        A.from_dense(full)
        dev = None
        if use_device:
            dev = _device(ctx)
        tp = build_potrf_panels(ctx, A, dev=dev)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        if dev is not None:
            dev.flush()
            _stop(dev)
        L = np.tril(np.linalg.cholesky(full.astype(np.float64)))
        for j in range(A.nt):
            if A.rank_of(0, j) != rank:
                continue
            ref = L[:, j * nb:(j + 1) * nb]
            np.testing.assert_allclose(A.tile(0, j), ref,
                                       rtol=2e-3, atol=2e-3)
        st = ctx.comm_stats()
        # panels really crossed ranks (none at one rank)
        assert st["msgs_sent"] > 0 or nodes == 1, st
        rdv = ctx.comm_rdv_stats()
        assert rdv["registered_bytes"] == 0, rdv
        assert rdv["pending_pulls"] == 0, rdv
        ctx.comm_fini()
        return _owned(A)


def getrf_panels_dist(rank: int, nodes: int, port: int, N: int = 128,
                      nb: int = 16):
    """Distributed panel-granular no-pivot LU: the factored panel AND its
    index ride the broadcast to later-panel owners (the KI arena flow —
    U solves at row block k, which is not derivable on rank j)."""
    pt, ctx = _mk_ctx(rank, nodes, port)
    build_getrf_panels, getrf_nopiv_reference = _imp(
        "algos", "build_getrf_panels", "getrf_nopiv_reference")
    TwoDimBlockCyclic = _imp("data.collections", "TwoDimBlockCyclic")

    with ctx:
        rng = np.random.default_rng(13)
        full = (rng.normal(size=(N, N)) + N * np.eye(N)).astype(np.float32)
        ref = getrf_nopiv_reference(full.astype(np.float64))
        A = TwoDimBlockCyclic(N, N, N, nb, P=1, Q=nodes, nodes=nodes,
                              myrank=rank, dtype=np.float32)
        A.register(ctx, "A")
        A.from_dense(full)
        tp = build_getrf_panels(ctx, A)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        for j in range(A.nt):
            if A.rank_of(0, j) != rank:
                continue
            np.testing.assert_allclose(
                A.tile(0, j), ref[:, j * nb:(j + 1) * nb],
                rtol=5e-3, atol=5e-3)
        st = ctx.comm_stats()
        assert st["msgs_sent"] > 0 or nodes == 1, st
        ctx.comm_fini()
        return _owned(A)


def chunked_chain(rank: int, nodes: int, port: int, nb: int = 8,
                  elems: int = 8192, chunk: int = 4096, inflight: int = 3,
                  rails: int = 0):
    """RW chain whose datum is a multi-KiB int64 tile forced through the
    CHUNKED rendezvous (eager off, chunk_size << payload): every hop's
    payload streams as a pipelined window of ranged GET/PUT_CHUNK
    frames and is reassembled before delivery.  Every task verifies the
    FULL payload (all elements == k), so a mis-assembled, reordered or
    short chunk is a hard failure, not a perf blip."""
    import os

    os.environ["PTC_MCA_comm_eager_limit"] = "0"
    os.environ["PTC_MCA_comm_chunk_size"] = str(chunk)
    os.environ["PTC_MCA_comm_inflight"] = str(inflight)
    if rails:
        os.environ["PTC_MCA_comm_rails"] = str(rails)
    pt, ctx = _mk_ctx(rank, nodes, port)
    with ctx:
        size = elems * 8
        arr = np.zeros((nodes, elems), dtype=np.int64)
        ctx.register_linear_collection("A", arr, elem_size=size,
                                       nodes=nodes, myrank=rank)
        ctx.register_arena("t", size)
        tp = pt.Taskpool(ctx, globals={"NB": nb})
        k = pt.L("k")
        tc = tp.task_class("Task")
        tc.param("k", 0, pt.G("NB"))
        tc.affinity("A", k % nodes)
        tc.flow("A", "RW",
                pt.In(pt.Mem("A", 0), guard=(k == 0)),
                pt.In(pt.Ref("Task", k - 1, flow="A")),
                pt.Out(pt.Ref("Task", k + 1, flow="A"),
                       guard=(k < pt.G("NB"))),
                pt.Out(pt.Mem("A", 0), guard=(k == pt.G("NB"))),
                arena="t")

        def body(view):
            a = view.data("A", dtype=np.int64, shape=(elems,))
            kk = view["k"]
            assert (a == kk).all(), (kk, a[:4], a[-4:])
            a += 1

        tc.body(body)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        if rank == 0:
            assert (arr[0] == nb + 1).all(), arr[0][:4]
        tune = ctx.comm_tuning()
        # every rank consumed at least one cross-rank hop above the
        # chunk size, so the pipelined protocol must have engaged
        assert tune["chunks_recv"] > 0 or nodes == 1, tune
        st = ctx.comm_rdv_stats()
        assert st["pending_pulls"] == 0 and st["registered_bytes"] == 0, st
        ctx.comm_fini()
        return {"A0": arr[0].copy()} if rank == 0 else {}


def adaptive_eager_chain(rank: int, nodes: int, port: int, nb: int = 8):
    """eager_limit=auto: the comm engine derives the eager/rendezvous
    threshold at init from PING/PONG RTT probes + a memcpy calibration.
    The job must run normally and report a clamped, measured-based
    threshold via comm_tuning()."""
    import os

    os.environ["PTC_MCA_comm_eager_limit"] = "auto"
    pt, ctx = _mk_ctx(rank, nodes, port)
    with ctx:
        arr = np.zeros(nodes, dtype=np.int64)
        ctx.register_linear_collection("A", arr, elem_size=8, nodes=nodes,
                                       myrank=rank)
        ctx.register_arena("t", 8)
        tp = pt.Taskpool(ctx, globals={"NB": nb})
        k = pt.L("k")
        tc = tp.task_class("Task")
        tc.param("k", 0, pt.G("NB"))
        tc.affinity("A", k % nodes)
        tc.flow("A", "RW",
                pt.In(pt.Mem("A", 0), guard=(k == 0)),
                pt.In(pt.Ref("Task", k - 1, flow="A")),
                pt.Out(pt.Ref("Task", k + 1, flow="A"),
                       guard=(k < pt.G("NB"))),
                arena="t")

        def body(view):
            view.data("A", dtype=np.int64)[0] += 1

        tc.body(body)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        tune = ctx.comm_tuning()
        assert tune["eager_adaptive"], tune
        assert 16 * 1024 <= tune["eager_limit"] <= 16 * 1024 * 1024, tune
        assert tune["rtt_ns"] > 0, tune        # at least one pong landed
        assert tune["memcpy_bps"] > 0, tune
        ctx.comm_fini()
        return {}


def chunked_bcast(rank: int, nodes: int, port: int, elems: int = 4096,
                  topo: str = "star", chunk: int = 2048,
                  fault_delay_us: int = 0, fault_recv_max: int = 0):
    """Root broadcasts one multi-KiB tile to every rank through the
    chunked rendezvous: with star topology the consumers pull the SAME
    shared registration concurrently (mem_by_copy dedup + chunk_refs
    pinning), with chain/binomial each relay re-registers and re-serves
    what it pulled.  Every consumer verifies the full payload.

    fault_delay_us / fault_recv_max arm the native comm engine's fault
    injection (utils.faults) — the multi-puller soak for the
    chunk-session state machine (concurrent pullers presenting equal
    cookies): payloads must still reassemble bit-exactly and every session must
    drain (rdv stats at zero) under skewed timing and short reads."""
    import os

    apply_comm_faults = _imp("utils.faults", "apply_comm_faults")

    if fault_delay_us or fault_recv_max:
        apply_comm_faults(delay_us=fault_delay_us,
                          recv_max=fault_recv_max)
    os.environ["PTC_MCA_comm_eager_limit"] = "0"
    os.environ["PTC_MCA_comm_chunk_size"] = str(chunk)
    os.environ["PTC_MCA_comm_inflight"] = "3"
    pt, ctx = _mk_ctx(rank, nodes, port, topo=topo)
    with ctx:
        size = elems * 8
        arr = np.zeros((nodes, elems), dtype=np.int64)
        ctx.register_linear_collection("V", arr, elem_size=size,
                                       nodes=nodes, myrank=rank)
        ctx.register_arena("t", size)
        tp = pt.Taskpool(ctx, globals={"NT": nodes - 1})
        k = pt.L("k")
        root = tp.task_class("Root")
        root.affinity("V", 0)
        recv = tp.task_class("Recv")
        recv.param("k", 0, pt.G("NT"))
        recv.affinity("V", k)

        def root_body(view):
            x = view.data("X", dtype=np.int64, shape=(elems,))
            x[:] = np.arange(elems, dtype=np.int64) + 7

        root.flow("X", "W",
                  pt.Out(pt.Ref("Recv", pt.Range(0, pt.G("NT")),
                                flow="X")),
                  arena="t")
        root.body(root_body)

        def recv_body(view):
            x = view.data("X", dtype=np.int64, shape=(elems,))
            expect = np.arange(elems, dtype=np.int64) + 7
            assert (x == expect).all(), (view["k"], x[:4], x[-4:])
            y = view.data("Y", dtype=np.int64, shape=(elems,))
            y[:] = x + view["k"]

        recv.flow("X", "R", pt.In(pt.Ref("Root", flow="X")), arena="t")
        recv.flow("Y", "W", pt.Out(pt.Mem("V", k)), arena="t")
        recv.body(recv_body)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        expect = np.arange(elems, dtype=np.int64) + 7
        for i in range(nodes):
            if i % nodes == rank:
                assert (arr[i] == expect + i).all(), (i, arr[i][:4])
        if rank != 0:
            tune = ctx.comm_tuning()
            assert tune["chunks_recv"] > 0 or nodes == 1, tune
        st = ctx.comm_rdv_stats()
        assert st["pending_pulls"] == 0 and st["registered_bytes"] == 0, st
        ctx.comm_fini()
        return {f"V{rank}": arr[rank].copy()}


def device_chain_flush(rank: int, nodes: int, port: int, nb: int = 8,
                       elems: int = 16384, chunk: int = 4096):
    """Device-chore RW chain over the PK_DEVICE data plane ending in a
    collection write-back, then flush().  Regression for the
    stale-mirror clobber: hop 0's flow copy IS the collection tile's
    host copy; its dirty device mirror was never synced (PK_DEVICE
    sends do not touch host bytes), so before the host-written
    invalidation hook, dev.flush() wrote hop 0's value (1.0) over the
    final result.  chunk=0 runs the whole-payload pull, chunk>0 the
    pipelined chunked pull."""
    import os

    os.environ["PTC_MCA_comm_eager_limit"] = "0"
    os.environ["PTC_MCA_comm_chunk_size"] = str(chunk)
    pt, ctx = _mk_ctx(rank, nodes, port, nb_workers=1)

    with ctx:
        size = elems * 4
        arr = np.zeros((nodes, elems), dtype=np.float32)
        ctx.register_linear_collection("A", arr, elem_size=size,
                                       nodes=nodes, myrank=rank)
        ctx.register_arena("t", size)
        dev = _device(ctx)
        tp = pt.Taskpool(ctx, globals={"NB": nb})
        k = pt.L("k")
        tc = tp.task_class("Hop")
        tc.param("k", 0, pt.G("NB"))
        tc.affinity("A", k % nodes)
        tc.flow("A", "RW",
                pt.In(pt.Mem("A", 0), guard=(k == 0)),
                pt.In(pt.Ref("Hop", k - 1, flow="A")),
                pt.Out(pt.Ref("Hop", k + 1, flow="A"),
                       guard=(k < pt.G("NB"))),
                pt.Out(pt.Mem("A", 0), guard=(k == pt.G("NB"))),
                arena="t")

        def kern(x):
            return x + 1.0

        dev.attach(tc, tp, kernel=kern, reads=["A"], writes=["A"],
                   shapes={"A": (elems,)}, dtype=np.float32)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        dev.flush()  # must NOT clobber the written-back tile
        if rank == (nb % nodes):
            pass  # final task ran here; tile owner asserts below
        if rank == 0:
            assert np.allclose(arr[0], float(nb + 1)), arr[0][:4]
            # the final write-back must have dropped the stale mirror
            assert dev.stats["invalidations"] >= 1, dev.stats
        if chunk and nodes > 1:
            tune = ctx.comm_tuning()
            assert tune["chunks_recv"] > 0, tune
        _stop(dev)
        ctx.comm_fini()
        return {"A0": arr[0].copy()} if rank == 0 else {}


def gemm_dist_ooc(rank: int, nodes: int, port: int, N: int = 64,
                  nb: int = 8):
    """2-rank SPMD GEMM under out-of-core pressure: run once resident
    (ample device budget), then re-run on a fresh device whose budget is
    far below the per-rank working set.  The pressured run must COMPLETE
    (dirty C mirrors spill through the writeback lane and re-stage on
    demand instead of OOM/thrash), produce the BIT-IDENTICAL owned tiles
    of the resident run, and show nonzero spill counters.  batch_max=1
    pins both runs to identical single-task XLA programs, so bitwise
    equality is well-defined on the deterministic CPU backend."""
    import os

    os.environ["PTC_DEVICE_BATCH"] = "1"
    pt, ctx = _mk_ctx(rank, nodes, port)
    build_gemm_dist = _imp("algos.gemm", "build_gemm_dist")
    TwoDimBlockCyclic = _imp("data.collections", "TwoDimBlockCyclic")

    with ctx:
        P = 2 if nodes % 2 == 0 else 1
        Q = nodes // P
        rng = np.random.default_rng(11)
        a = rng.normal(size=(N, N)).astype(np.float32)
        b = rng.normal(size=(N, N)).astype(np.float32)
        c0 = rng.normal(size=(N, N)).astype(np.float32)
        mk = lambda: TwoDimBlockCyclic(N, N, nb, nb, P=P, Q=Q, nodes=nodes,
                                       myrank=rank, dtype=np.float32)
        A, B, C = mk(), mk(), mk()
        A.register(ctx, "A"); A.from_dense(a)
        B.register(ctx, "B"); B.from_dense(b)
        C.register(ctx, "C"); C.from_dense(c0)
        owned = [(m, n) for m in range(C.mt) for n in range(C.nt)
                 if C.rank_of(m, n) == rank]

        # resident reference run
        dev = _device(ctx)
        tp = build_gemm_dist(ctx, A, B, C, dev=dev)
        tp.run(); tp.wait(); ctx.comm_fence()
        dev.flush()
        assert dev.stats["spills"] == 0, dev.stats
        ref_tiles = {mn: C.tile(*mn).copy() for mn in owned}
        _stop(dev)  # drops every mirror: run 2 restages from host truth

        # pressured run: budget below this rank's dirty C set alone
        C.from_dense(c0)
        budget = max(2 * nb * nb * 4, len(owned) * nb * nb * 4 // 2)
        dev2 = _device(ctx, cache_bytes=budget)
        tp2 = build_gemm_dist(ctx, A, B, C, dev=dev2)
        tp2.run(); tp2.wait(); ctx.comm_fence()
        dev2.flush()
        stats = dict(dev2.stats)
        used = dev2._cache_used
        _stop(dev2)

        assert stats["spills"] > 0, stats
        assert stats["spill_bytes"] > 0, stats
        # residency bounded: the planner kept (or brought) the cache
        # within overcommit of budget once the spills drained
        assert used <= budget * 2, (used, budget)
        ref = c0.astype(np.float64) + a.astype(np.float64) @ b.astype(
            np.float64)
        for m, n in owned:
            got = C.tile(m, n)
            # bit-identical to the resident run: spilling must not
            # change a single ulp of any tile
            assert np.array_equal(got, ref_tiles[(m, n)]), (m, n)
            np.testing.assert_allclose(
                got, ref[m * nb:(m + 1) * nb, n * nb:(n + 1) * nb],
                rtol=2e-3, atol=2e-3)
        ctx.comm_fini()
        return {mn: C.tile(*mn).copy() for mn in owned}


def stream_chain(rank: int, nodes: int, port: int, nb: int = 8,
                 elems: int = 16384, chunk: int = 4096, inflight: int = 4,
                 stream: int = 1, rails: int = 2, prefetch: bool = False,
                 expect_stream=None, expect_parked: bool = False,
                 check_wakeups: bool = False):
    """Device-chore RW chain over the PK_DEVICE data plane with the wire
    v4 streaming knobs pinned: every cross-rank hop is a chunked pull of
    a device-resident tile, served progressively (stream=1) or through
    the serialized d2h-then-wire path (stream=0), striped over
    `rails` connections.  The arithmetic assertion at the end covers
    every element of every hop, so a mis-assembled, reordered or
    watermark-violating chunk is a hard failure on ANY knob setting —
    which is what makes rails=1 vs rails=2 and stream on/off
    bit-identical-by-assertion, not by luck.

    expect_stream=True/False asserts the progressive serve did / did not
    engage; expect_parked asserts ranged GETs actually parked above the
    watermark (watermark-ordered answers); check_wakeups asserts the
    consumer prefetch lane was woken event-driven by remote deliveries.
    """
    import os

    os.environ["PTC_MCA_comm_eager_limit"] = "0"
    os.environ["PTC_MCA_comm_chunk_size"] = str(chunk)
    os.environ["PTC_MCA_comm_inflight"] = str(inflight)
    os.environ["PTC_MCA_comm_stream"] = str(stream)
    os.environ["PTC_MCA_comm_rails"] = str(rails)
    if not prefetch:
        os.environ["PTC_MCA_device_prefetch"] = "0"
    pt, ctx = _mk_ctx(rank, nodes, port, nb_workers=1)

    with ctx:
        size = elems * 4
        arr = np.zeros((nodes, elems), dtype=np.float32)
        ctx.register_linear_collection("A", arr, elem_size=size,
                                       nodes=nodes, myrank=rank)
        ctx.register_arena("t", size)
        dev = _device(ctx)
        tp = pt.Taskpool(ctx, globals={"NB": nb})
        k = pt.L("k")
        tc = tp.task_class("Hop")
        tc.param("k", 0, pt.G("NB"))
        tc.affinity("A", k % nodes)
        tc.flow("A", "RW",
                pt.In(pt.Mem("A", 0), guard=(k == 0)),
                pt.In(pt.Ref("Hop", k - 1, flow="A")),
                pt.Out(pt.Ref("Hop", k + 1, flow="A"),
                       guard=(k < pt.G("NB"))),
                pt.Out(pt.Mem("A", 0), guard=(k == pt.G("NB"))),
                arena="t")

        def kern(x):
            return x + 1.0

        dev.attach(tc, tp, kernel=kern, reads=["A"], writes=["A"],
                   shapes={"A": (elems,)}, dtype=np.float32)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        dev.flush()
        if rank == 0:
            assert np.allclose(arr[0], float(nb + 1)), arr[0][:4]
        st = ctx.comm_stream_stats()
        if expect_stream is True:
            # every rank produced hops the other pulled: progressive
            # sessions must have run, with span evidence recorded
            assert st["sessions"] > 0, st
            assert st["d2h_ns"] > 0 and st["wire_ns"] > 0, st
            assert dev.stats["stream_serves"] > 0, dev.stats
            assert dev.stats["stream_bytes"] > 0, dev.stats
            # unified export surfaces the same counters
            agg = ctx.device_stats()
            assert agg["stream_serves"] == dev.stats["stream_serves"]
        elif expect_stream is False:
            assert st["sessions"] == 0, st
            assert dev.stats["stream_serves"] == 0, dev.stats
        if expect_parked:
            assert st["parked_gets"] > 0, st
        if check_wakeups:
            # remote deliveries must have woken the lane event-driven
            assert dev.stats["prefetch_wakeups"] > 0, dev.stats
        assert st["rails"] == rails, st
        rd = ctx.comm_rdv_stats()
        assert rd["pending_pulls"] == 0 and rd["registered_bytes"] == 0, rd
        _stop(dev)
        ctx.comm_fini()
        return {"A0": arr[0].copy()} if rank == 0 else {}


def stream_reap_on_death(rank: int, nodes: int, port: int,
                         elems: int = 262144, chunk: int = 4096,
                         die_rank: int = 2, die_after_s: float = 1.0):
    """Kill-a-puller reap coverage: rank 0 star-broadcasts one large
    host tile through the chunked rendezvous; `die_rank` arms a recv
    delay (so its pull crawls) and hard-exits mid-pull; the survivors
    must observe the producer REAP the dead puller's chunk session and
    expectation records — registered bytes back to zero, reap counter
    up — instead of pinning the snapshot for the life of the engine.

    The dying rank pushes nothing to the result queue; the test runner
    only collects from survivors."""
    import os
    import threading
    import time as _time

    apply_comm_faults = _imp("utils.faults", "apply_comm_faults")

    os.environ["PTC_MCA_comm_eager_limit"] = "0"
    os.environ["PTC_MCA_comm_chunk_size"] = str(chunk)
    os.environ["PTC_MCA_comm_inflight"] = "2"
    if rank == die_rank:
        # crawl: ~20 ms per recv makes the 64-chunk pull take far longer
        # than die_after_s, so death lands mid-session deterministically
        apply_comm_faults(delay_us=20000)
    pt, ctx = _mk_ctx(rank, nodes, port)
    with ctx:
        size = elems * 8
        arr = np.zeros((nodes, elems), dtype=np.int64)
        ctx.register_linear_collection("V", arr, elem_size=size,
                                       nodes=nodes, myrank=rank)
        ctx.register_arena("t", size)
        tp = pt.Taskpool(ctx, globals={"NT": nodes - 1})
        k = pt.L("k")
        root = tp.task_class("Root")
        root.affinity("V", 0)
        recv = tp.task_class("Recv")
        recv.param("k", 0, pt.G("NT"))
        recv.affinity("V", k)

        def root_body(view):
            x = view.data("X", dtype=np.int64, shape=(elems,))
            x[:] = np.arange(elems, dtype=np.int64)

        root.flow("X", "W",
                  pt.Out(pt.Ref("Recv", pt.Range(0, pt.G("NT")),
                                flow="X")),
                  arena="t")
        root.body(root_body)

        def recv_body(view):
            x = view.data("X", dtype=np.int64, shape=(elems,))
            assert (x == np.arange(elems, dtype=np.int64)).all()

        recv.flow("X", "R", pt.In(pt.Ref("Root", flow="X")), arena="t")
        recv.body(recv_body)
        if rank == die_rank:
            threading.Timer(die_after_s, lambda: os._exit(0)).start()
        tp.run()
        if rank == die_rank:
            tp.wait()  # never finishes: the timer kills the process
            return
        tp.wait()
        if rank == 0:
            # poll until the dead puller's session/expectation records
            # are reaped and the snapshot pin is gone
            deadline = _time.time() + 90.0
            st = rd = None
            while _time.time() < deadline:
                st = ctx.comm_stream_stats()
                rd = ctx.comm_rdv_stats()
                if st["reaps"] >= 1 and rd["registered_bytes"] == 0:
                    break
                _time.sleep(0.1)
            assert st is not None and st["reaps"] >= 1, (st, rd)
            assert rd["registered_bytes"] == 0, rd
        ctx.comm_fini()


def traced_chain(rank: int, nodes: int, port: int, out_dir: str,
                 nb: int = 24, rendezvous: bool = False):
    """Tracing-v2 round-trip worker: run the rank-hopping RW chain with
    level-1 tracing on, fence (which refreshes the clock-sync probe),
    and save this rank's .ptt (v2 header: clock offset + flow-corr COMM
    events) for the parent to merge and assert causality on."""
    import os

    take_trace = _imp("profiling", "take_trace")

    if rendezvous:
        os.environ["PTC_MCA_comm_eager_limit"] = "0"  # force GET pulls
    pt, ctx = _mk_ctx(rank, nodes, port)
    with ctx:
        ctx.profile_enable(1)
        arr = np.zeros(nodes, dtype=np.int64)
        ctx.register_linear_collection("A", arr, elem_size=8, nodes=nodes,
                                       myrank=rank)
        ctx.register_arena("t", 8)
        tp = pt.Taskpool(ctx, globals={"NB": nb})
        k = pt.L("k")
        tc = tp.task_class("Task")
        tc.param("k", 0, pt.G("NB"))
        tc.affinity("A", k % nodes)
        tc.flow("A", "RW",
                pt.In(pt.Mem("A", 0), guard=(k == 0)),
                pt.In(pt.Ref("Task", k - 1, flow="A")),
                pt.Out(pt.Ref("Task", k + 1, flow="A"),
                       guard=(k < pt.G("NB"))),
                pt.Out(pt.Mem("A", 0), guard=(k == pt.G("NB"))),
                arena="t")

        def body(view):
            view.data("A", dtype=np.int64)[0] += 1

        tc.body(body)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        ck = ctx.comm_clock()
        assert ck["measured"], ck  # rank 0 by definition, peers probed
        if rank != 0:
            assert ck["samples"] > 0, ck
        tr = take_trace(ctx, class_names=["Task"])
        assert tr.rank == rank  # take_trace defaults to ctx.myrank
        if rank != 0:
            assert "clock_offset_ns" in tr.meta, tr.meta
        tr.save(os.path.join(out_dir, f"r{rank}.ptt"))
        ctx.comm_fini()
        return {"A0": arr[0].copy()} if rank == 0 else {}


def coll_primitives(rank: int, nodes: int, port: int, topo=None,
                    stream=None, elems: int = 4096, slice_bytes=None,
                    eager_limit=None, faults: bool = False):
    """All four runtime-native collectives vs in-process numpy references.
    Integer-valued float32 data: every reduction order yields bit-exact
    sums, so ring/binomial/star and stream on/off must all match the
    reference EXACTLY.  Knobs: topo overrides the
    economics selector; slice_bytes forces multi-slice pipelining;
    eager_limit=0 forces the GET rendezvous/streaming wire; faults=True
    soaks under PTC_COMM_FAULT_* (short reads + per-recv delay)."""
    import math
    import os

    if stream is not None:
        os.environ["PTC_MCA_comm_stream"] = str(stream)
    if slice_bytes is not None:
        os.environ["PTC_MCA_coll_slice"] = str(slice_bytes)
    if eager_limit is not None:
        os.environ["PTC_MCA_comm_eager_limit"] = str(eager_limit)
    if faults:
        os.environ["PTC_COMM_FAULT_RECV_MAX"] = "1500"
        os.environ["PTC_COMM_FAULT_DELAY_US"] = "50"
    pt, ctx = _mk_ctx(rank, nodes, port)
    coll = _imp("comm", "coll")
    with ctx:
        alls = [np.random.default_rng(100 + r)
                .integers(-50, 50, size=elems).astype(np.float32)
                for r in range(nodes)]
        local = alls[rank]
        total = np.sum(np.stack(alls), axis=0, dtype=np.float32)

        outs = {}
        got = outs["all_reduce"] = coll.all_reduce(ctx, local, topo=topo)
        np.testing.assert_array_equal(got, total)

        got = outs["reduce_scatter"] = coll.reduce_scatter(ctx, local,
                                                            topo=topo)
        seg = math.ceil(elems / nodes)
        lo = rank * seg
        np.testing.assert_array_equal(got, total[lo:lo + seg])

        got = outs["all_gather"] = coll.all_gather(ctx, local, topo=topo)
        np.testing.assert_array_equal(got, np.concatenate(alls))

        root = 1 % nodes
        got = outs["broadcast"] = coll.broadcast(ctx, local.copy(),
                                                 root=root, topo=topo)
        np.testing.assert_array_equal(got, alls[root])

        st = ctx.stats()["coll"]
        assert st["steps"] > 0, st
        assert st["ops"] == 4, st
        if topo is not None:
            assert st["by_topo"].get(topo, 0) >= 1, (topo, st)
        ctx.comm_fence()
        if faults or eager_limit == 0:
            # streamed/rendezvous sessions must drain (bounded comm
            # memory even under fault injection)
            rdv = ctx.comm_rdv_stats()
            assert rdv["registered_bytes"] == 0, rdv
            assert rdv["pending_pulls"] == 0, rdv
        ctx.comm_fini()
        return outs


def coll_allreduce_stream_soak(rank: int, nodes: int, port: int,
                               elems: int = 65536):
    """4-rank streamed all-reduce under comm fault injection: payloads
    far above the eager limit ride the chunked/streamed wire while every
    recv is capped + delayed; the result must stay bit-exact and every
    session drained."""
    import os

    os.environ["PTC_MCA_comm_eager_limit"] = "1024"
    os.environ["PTC_MCA_comm_chunk_size"] = "16384"
    os.environ["PTC_MCA_coll_slice"] = "65536"
    os.environ["PTC_COMM_FAULT_RECV_MAX"] = "2000"
    os.environ["PTC_COMM_FAULT_DELAY_US"] = "20"
    pt, ctx = _mk_ctx(rank, nodes, port)
    coll = _imp("comm", "coll")
    with ctx:
        alls = [np.random.default_rng(7 + r)
                .integers(-9, 9, size=elems).astype(np.float32)
                for r in range(nodes)]
        total = np.sum(np.stack(alls), axis=0, dtype=np.float32)
        got = coll.all_reduce(ctx, alls[rank], topo="ring")
        np.testing.assert_array_equal(got, total)
        ctx.comm_fence()
        rdv = ctx.comm_rdv_stats()
        assert rdv["registered_bytes"] == 0, rdv
        assert rdv["pending_pulls"] == 0, rdv
        st = ctx.coll_stats()
        assert st["steps"] > 0 and st["recv_msgs"] > 0, st
        ctx.comm_fini()
        return {"all_reduce": got}


def gemm_panel_reduce_modes(rank: int, nodes: int, port: int,
                            M: int = 48, K: int = 32, Nc: int = 40,
                            trace_dir=None):
    """k-split GEMM panel reduction: C = sum_r A_r @ B_r with rank r
    holding k-slab r.  Runs the DAG-dependency chain baseline and the
    runtime-native panel-streamed collective, asserts both equal the
    numpy reference bit-for-bit (integer-valued inputs), and (with
    trace_dir) saves level-2 traces of both modes for lost-time
    comparison."""
    import os

    pt, ctx = _mk_ctx(rank, nodes, port)
    gemm_panel_reduce = _imp("algos.gemm", "gemm_panel_reduce")
    with ctx:
        rng = np.random.default_rng(3)
        a = rng.integers(-4, 4, size=(M, K)).astype(np.float32)
        b = rng.integers(-4, 4, size=(K, Nc)).astype(np.float32)
        ks = K // nodes
        ref = sum(a[:, r * ks:(r + 1) * ks] @ b[r * ks:(r + 1) * ks]
                  for r in range(nodes))
        a_slab = a[:, rank * ks:(rank + 1) * ks].copy()
        b_slab = b[rank * ks:(rank + 1) * ks].copy()
        outs = {}
        for mode in ("chain", "coll"):
            if trace_dir:
                ctx.profile_enable(2)
            c = gemm_panel_reduce(ctx, a_slab, b_slab, reduce=mode,
                                  panel_rows=8)
            np.testing.assert_array_equal(c, ref)
            outs[mode] = c
            ctx.comm_fence()
            if trace_dir:
                take_trace = _imp("profiling.trace", "take_trace")
                tr = take_trace(ctx)
                tr.save(os.path.join(trace_dir,
                                     f"{mode}_r{rank}.ptt"))
        np.testing.assert_array_equal(outs["chain"], outs["coll"])
        st = ctx.coll_stats()
        assert st["steps"] > 0, st
        ctx.comm_fini()
        return outs


def gemm_dist_plan(rank: int, nodes: int, port: int, N: int = 256,
                   nb: int = 64, eager_limit=None):
    """ptc-plan comm-volume bound vs measured wire traffic: plan the
    2-rank gemm_dist BEFORE running it, then assert per rank that
      payload bound     == the hand-computed B-panel crossings (exact)
      measured bytes    >= the payload bound (the payload really moved)
      wire_out_bound    >= measured bytes_sent (the BOUND is sound
                           against everything the wire counts —
                           activations, fences, clock sync, metrics)
    P=2/Q=1 puts every ReadA at its consumer row's rank (A never
    crosses) while every B tile crosses exactly once.  `eager_limit`
    sets the engine's threshold, which the plan's eager/rendezvous
    split must follow.  Returns the owned C tiles (C starts at zero),
    this rank's plan row and its wire bound."""
    if eager_limit is not None:
        os.environ["PTC_MCA_comm_eager_limit"] = str(eager_limit)
    pt, ctx = _mk_ctx(rank, nodes, port)
    build_gemm_dist = _imp("algos.gemm", "build_gemm_dist")
    TwoDimBlockCyclic = _imp("data.collections", "TwoDimBlockCyclic")

    with ctx:
        assert nodes == 2
        rng = np.random.default_rng(11)
        a = rng.normal(size=(N, N)).astype(np.float32)
        b = rng.normal(size=(N, N)).astype(np.float32)
        mk = lambda: TwoDimBlockCyclic(N, N, nb, nb, P=2, Q=1,
                                       nodes=nodes, myrank=rank,
                                       dtype=np.float32)
        A, B, C = mk(), mk(), mk()
        A.register(ctx, "A"); A.from_dense(a)
        B.register(ctx, "B"); B.from_dense(b)
        C.register(ctx, "C"); C.from_dense(np.zeros((N, N), np.float32))
        tp = build_gemm_dist(ctx, A, B, C)
        plan = tp.plan()
        nt = N // nb
        tile = nb * nb * 4
        expect_payload = (nt * nt // 2) * tile
        row = plan.per_rank[rank]
        assert row["comm_out_bytes"] == expect_payload, row
        assert plan.edges_bytes[(rank, 1 - rank)] == expect_payload
        bound = plan.wire_out_bound(rank)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        measured = ctx.comm_stats()["bytes_sent"]
        assert measured >= expect_payload, (measured, expect_payload)
        assert bound >= measured, (bound, measured)
        # correctness spot check on the owned tiles
        ref = a.astype(np.float64) @ b.astype(np.float64)
        for m in range(C.mt):
            for n_ in range(C.nt):
                if C.rank_of(m, n_) == rank:
                    np.testing.assert_allclose(
                        C.tile(m, n_),
                        ref[m * nb:(m + 1) * nb,
                            n_ * nb:(n_ + 1) * nb],
                        rtol=2e-3, atol=2e-3)
        ctx.comm_fini()
        return _owned(C), dict(row), bound


def gemm_dist_wave_fuse(rank: int, nodes: int, port: int, N: int = 64,
                        nb: int = 8):
    """ptc-fuse bit-exactness matrix, distributed leg: the SAME 2-rank
    GEMM runs with the wave compiler on and with device.wave_fuse=0
    (one device per pass — the knob binds at device creation), and
    every owned C tile must match BITWISE.  The fused pass must
    certify waves (fused_waves > 0: gemm_dist records 4 fusable waves
    in PLAN_graphs.json); chains legitimately refuse — the A/B panels
    arrive from reader-broadcast tasks, not collection reads."""
    pt, ctx = _mk_ctx(rank, nodes, port)
    build_gemm_dist = _imp("algos.gemm", "build_gemm_dist")
    TwoDimBlockCyclic = _imp("data.collections", "TwoDimBlockCyclic")
    _mca = _imp("utils", "params")

    with ctx:
        P = 2 if nodes % 2 == 0 else 1
        Q = nodes // P
        rng = np.random.default_rng(11)
        a = rng.normal(size=(N, N)).astype(np.float32)
        b = rng.normal(size=(N, N)).astype(np.float32)
        c0 = rng.normal(size=(N, N)).astype(np.float32)
        mk = lambda: TwoDimBlockCyclic(N, N, nb, nb, P=P, Q=Q,
                                       nodes=nodes, myrank=rank,
                                       dtype=np.float32)
        outs = {}
        for fuse, tag in ((True, "f"), (False, "u")):
            _mca.set("device.wave_fuse", fuse)
            try:
                A, B, C = mk(), mk(), mk()
                A.register(ctx, "A" + tag); A.from_dense(a)
                B.register(ctx, "B" + tag); B.from_dense(b)
                C.register(ctx, "C" + tag); C.from_dense(c0)
                dev = _device(ctx)
                dev.batch_wait_ms = 2.0
                tp = build_gemm_dist(ctx, A, B, C, dev=dev,
                                     names=("A" + tag, "B" + tag,
                                            "C" + tag))
                tp.run()
                tp.wait()
                ctx.comm_fence()
                dev.flush()
                # per-device snapshot: ctx.device_stats() would fold
                # the previous pass's (stopped) device back in
                st = dev.info()["fuse"]
                _stop(dev)
                tiles = {}
                nt = C.mt
                for m in range(nt):
                    for n in range(nt):
                        if C.rank_of(m, n) == rank:
                            tiles[(m, n)] = C.tile(m, n).tobytes()
                outs[tag] = (tiles, st)
            finally:
                _mca.unset("device.wave_fuse")
        tiles_f, st_f = outs["f"]
        tiles_u, st_u = outs["u"]
        assert st_f["enabled"] is True and st_f["fused_waves"] > 0, st_f
        assert st_u["enabled"] is False and st_u["fused_waves"] == 0
        assert set(tiles_f) == set(tiles_u)
        for key in tiles_f:
            assert tiles_f[key] == tiles_u[key], \
                f"tile {key} differs fused vs unfused"
        ctx.comm_fence()
        ctx.comm_fini()
        return {k: np.frombuffer(v, np.float32).reshape(nb, nb).copy()
                for k, v in tiles_f.items()}


def ring_attention_spmd(rank: int, nodes: int, port: int, S: int = 4,
                        T: int = 32, d: int = 8, device: bool = False):
    """Ring attention taskpool with shards distributed across ranks: every
    K/V ring hop crosses a rank boundary through the comm engine (eager or
    rendezvous by size; with `device`, the K/V blocks are device-resident
    and ride the data plane), ACC stays rank-local.  Oracle: dense
    float64 softmax.  Returns the owned O shards."""
    os.environ["PTC_MCA_comm_eager_limit"] = "1024"
    pt, ctx = _mk_ctx(rank, nodes, port, nb_workers=1)
    run_ring_attention, dense_reference = _imp(
        "algos.ring_attention", "run_ring_attention", "dense_reference")
    dev = _device(ctx) if device else None
    with ctx:
        rng = np.random.default_rng(7)
        q, k, v = (rng.standard_normal((S * T, d)).astype(np.float32)
                   for _ in range(3))
        Oc = run_ring_attention(ctx, S, T, d, q, k, v, dev=dev,
                                nodes=nodes, myrank=rank)
        ctx.comm_fence()
        ref = dense_reference(q, k, v)
        out = {}
        for m in range(S):
            if Oc.rank_of(m, 0) == rank:
                out[m] = Oc.tile(m, 0).copy()
                np.testing.assert_allclose(out[m], ref[m * T:(m + 1) * T],
                                           rtol=2e-4, atol=2e-5)
        rdv = ctx.comm_rdv_stats()
        assert rdv["registered_bytes"] == 0, (rank, rdv)
        if dev is not None:
            assert dev.stats["tasks"] > 0, dev.stats
            _stop(dev)
        ctx.comm_fini()
        return out


def moe_taskpool_spmd(rank: int, nodes: int, port: int, S: int = 4,
                      T: int = 8, d: int = 4, f: int = 6, E: int = 4,
                      k: int = 2, combine: str = "chain"):
    """MoE through the runtime across ranks: token shards live on rank
    s%nodes, experts on rank e%nodes — the dispatch tiles moving to the
    expert ranks and the results moving back are the two all-to-all legs,
    ordinary runtime dependencies over the comm engine.  Validated
    against the dense numpy oracle on each owned shard; returns them."""
    build_moe, make_moe_collections, moe_oracle = _imp(
        "algos.moe", "build_moe", "make_moe_collections", "moe_oracle")
    pt, ctx = _mk_ctx(rank, nodes, port)
    with ctx:
        rng = np.random.default_rng(7)
        x = rng.normal(size=(S * T, d)).astype(np.float32)
        wg = rng.normal(size=(d, E)).astype(np.float32)
        wu = (rng.normal(size=(E, d, f)) / np.sqrt(d)).astype(np.float32)
        wd = (rng.normal(size=(E, f, d)) / np.sqrt(f)).astype(np.float32)
        Xc, Yc, WGc, WUc, WDc = make_moe_collections(
            S, T, d, f, E, nodes=nodes, myrank=rank, x=x, w_gate=wg,
            w_up=wu, w_down=wd)
        tp = build_moe(ctx, Xc, Yc, WGc, WUc, WDc, E, k=k, combine=combine)
        tp.run()
        tp.wait()
        ctx.comm_fence()
        if combine == "coll":
            st = ctx.coll_stats()
            assert st["steps"] > 0, st
        ref = moe_oracle(x, wg, wu, wd, k=k)
        out = {}
        for s_ in range(S):
            if s_ % nodes != rank:
                continue  # not my shard
            out[s_] = Yc.tile(s_, 0).copy()
            np.testing.assert_allclose(out[s_], ref[s_ * T:(s_ + 1) * T],
                                       rtol=3e-5, atol=3e-5)
        ctx.comm_fini()
        return out


def coll_dispatch_runtime(rank: int, nodes: int, port: int,
                          elems: int = 1024):
    """parallel.collectives front door with a live multi-rank Context:
    every primitive routes to the runtime-native ptc_coll_* path
    (coll_stats ops recorded) and matches the numpy references bit for
    bit.  Returns the four results."""
    import math

    pt, ctx = _mk_ctx(rank, nodes, port)
    pp = importlib.import_module(f"{PKG.__name__}.parallel")
    with ctx:
        alls = [np.random.default_rng(100 + r)
                .integers(-50, 50, size=elems).astype(np.float32)
                for r in range(nodes)]
        local = alls[rank]
        total = np.sum(np.stack(alls), axis=0, dtype=np.float32)
        outs = {}
        outs["all_reduce"] = pp.all_reduce(local, ctx=ctx)
        np.testing.assert_array_equal(outs["all_reduce"], total)
        seg = math.ceil(elems / nodes)
        outs["reduce_scatter"] = pp.reduce_scatter(local, ctx=ctx)
        np.testing.assert_array_equal(outs["reduce_scatter"],
                                      total[rank * seg:rank * seg + seg])
        outs["all_gather"] = pp.all_gather(local, ctx=ctx)
        np.testing.assert_array_equal(outs["all_gather"],
                                      np.concatenate(alls))
        outs["broadcast"] = pp.broadcast(local.copy(), root=0, ctx=ctx)
        np.testing.assert_array_equal(outs["broadcast"], alls[0])
        st = ctx.coll_stats()
        assert st["ops"] == 4, st  # every call took the runtime path
        ctx.comm_fence()
        ctx.comm_fini()
        return outs


# ------------------------------------------------------ the parent's side
def spmd(worker, nodes: int, timeout: float = 90.0, expect: int = None,
         runner=None, **kw) -> list:
    """Run `worker` on `nodes` spawned ranks (spawned, never forked: a
    forked child would inherit the parent's CUDA and thread state) and
    return the ranks' results in rank order; raises with every failing
    rank's traceback.  `expect`: how many ranks report (default all; a
    rank that dies on purpose reports nothing)."""
    port = free_port_base(nodes)
    mpctx = mp.get_context("spawn")
    q = mpctx.Queue()
    procs = [mpctx.Process(target=runner or run,
                           args=(worker, r, nodes, port, q), kwargs=kw)
             for r in range(nodes)]
    for p in procs:
        p.start()
    results = []
    try:
        for _ in range(nodes if expect is None else expect):
            results.append(q.get(timeout=timeout))
    finally:
        for p in procs:
            p.join(timeout=15)
            if p.is_alive():
                p.terminate()
    errs = [r for r in results if r[0] != "ok"]
    assert not errs, "\n".join(str(e) for e in errs)
    return [r[2] for r in sorted(results, key=lambda r: r[1])]


@contextlib.contextmanager
def _env_kept():
    """Restore os.environ (the workers set PTC_MCA_* knobs) on exit."""
    saved = dict(os.environ)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def reference(pkg, worker, **kw):
    """The worker's program run by package `pkg` (the JAX package, passed
    in by the parent) in this process, on one rank, with the parent's
    environment restored afterwards."""
    global PKG
    prev, PKG = PKG, pkg
    try:
        with _env_kept():
            return worker(0, 1, 0, **kw)
    finally:
        PKG = prev


def merged(results: list) -> dict:
    """The ranks' result dicts merged (each rank returns what it owns)."""
    out: dict = {}
    for r in results:
        for k, v in (r or {}).items():
            assert k not in out, f"{k!r} returned by two ranks"
            out[k] = v
    return out


def hold(results: list, ref: dict, tol=None) -> None:
    """Hold the port's merged results against the reference's on the keys
    both have (there must be some): bit for bit, or within `tol` =
    (rtol, atol)."""
    got = merged(results)
    common = sorted(set(got) & set(ref), key=repr)
    assert common, (sorted(got, key=repr), sorted(ref, key=repr))
    for k in common:
        a, b = got[k], ref[k]
        if isinstance(b, (list, tuple)) and not isinstance(b, np.ndarray):
            assert list(a) == list(b), k
        elif tol is None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=repr(k))
        else:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=tol[0], atol=tol[1],
                                       err_msg=repr(k))


if __name__ == "__main__":
    # python tests/test_torch_comm_workers.py blackbox_kill <rank> <nodes>
    #     <port> <dir> <victim>: a process its parent may SIGKILL
    if sys.argv[1] == "blackbox_kill":
        blackbox_kill(*(int(a) for a in sys.argv[2:5]), sys.argv[5],
                      int(sys.argv[6]))
