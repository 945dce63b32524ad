"""The port's device data plane (device/cuda.py, ptc_set_dataplane) on the
CPU: device-resident dependencies between ranks served from the device
module's mirrors by bytes, by chunked and by streamed pulls, and between
colocated ranks (two Contexts of one process) as by-reference handoffs
cloned on the consumer's device.  The devices are CudaDevice(ctx,
device="cpu"), whose kernels take their plain versions.

Each case is the counterpart of a reference test (named by its id) and
holds the reference worker's assertions, dp_errors == 0 on every device
among them (a failed callback would otherwise hand its dependency to the
host path unseen).  Results are held against the JAX package's run of the
same program on the same numpy-seeded inputs, on one rank, in this
process: the device GEMM and factorizations at the reference's 2e-3 (the
device chores are torch products, the reference's one-rank run numpy
host bodies), and the data-plane chains against their arithmetic, which
is what the reference's own workers assert.
"""
import os
import threading

import numpy as np
import pytest

import parsec_tpu as jpt
import test_torch_comm_workers as W

_TOL = (2e-3, 2e-3)

# (case id, worker, ranks, keyword arguments, reference run or None,
# timeout)
_CASES = [
    # tests/comm/test_multirank.py
    ("device_dataplane_2ranks", "device_dataplane", 2, {}, None, 180),
    ("bcast_rendezvous_device_resident[chain]", "ptg_bcast_rendezvous_topo",
     3, dict(topo="chain", device=True), None, 150),
    ("bcast_rendezvous_device_resident[binomial]",
     "ptg_bcast_rendezvous_topo", 3, dict(topo="binomial", device=True),
     None, 150),
    ("dtd_counting_termdet_device_async", "dtd_chain_counting_termdet", 2,
     dict(device=True), ("dtd_chain_counting_termdet", {}), 150),
    ("potrf_2ranks_device", "potrf_dist", 2,
     dict(N=64, nb=8, use_device=True), ("potrf_dist", dict(N=64, nb=8)),
     240),
    ("gemm_dist_2ranks_device", "gemm_dist", 2,
     dict(N=64, nb=8, use_device=True), ("gemm_dist", dict(N=64, nb=8)),
     240),
    ("potrf_panels_2ranks_device", "potrf_panels_dist", 2,
     dict(N=128, nb=16, use_device=True),
     ("potrf_panels_dist", dict(N=128, nb=16)), 240),
    # tests/comm/test_chunked.py
    ("device_chain_flush_not_clobbered_chunked", "device_chain_flush", 2,
     {}, None, 180),
    ("device_chain_flush_not_clobbered_whole_pull", "device_chain_flush",
     2, dict(chunk=0), None, 180),
    # tests/comm/test_stream.py
    ("stream_chain_2ranks", "stream_chain", 2, dict(expect_stream=True),
     None, 240),
    ("stream_off_reproduces_serialized", "stream_chain", 2,
     dict(stream=0, expect_stream=False), None, 240),
    ("stream_watermark_parked_answers", "stream_chain", 2,
     dict(chunk=1024, inflight=8, expect_stream=True, expect_parked=True),
     None, 240),
    ("stream_single_rail", "stream_chain", 2,
     dict(rails=1, expect_stream=True), None, 240),
    # tests/device/test_stream_prefetch.py: remote deliveries wake the
    # prefetch lane, which keeps refusing stale stages of the delivered
    # mirrors (the chain's values are the check)
    ("remote_delivery_wakes_prefetch", "stream_chain", 2,
     dict(prefetch=True, expect_stream=True, check_wakeups=True), None,
     240),
]


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_dataplane_case(case):
    _, worker, nodes, kw, ref_run, timeout = case
    results = W.spmd(getattr(W, worker), nodes, timeout=timeout, **kw)
    got = W.merged(results)
    if ref_run is not None:
        ref = W.reference(jpt, getattr(W, ref_run[0]), **ref_run[1])
        W.hold(results, ref, tol=_TOL if kw.get("use_device") else None)
    elif worker in ("device_chain_flush", "stream_chain"):
        # nb = 8 hops of x + 1 over a zero tile
        np.testing.assert_array_equal(got["A0"], np.full(16384, 9.0,
                                                         np.float32))
    elif worker == "device_dataplane":
        np.testing.assert_array_equal(got["A1"], np.full(1024, 7.0,
                                                         np.float32))
    else:
        assert {k: float(v) for k, v in got.items()} == \
            {f"V{r}": 7.0 for r in range(1, nodes)}


def test_stream_on_off_bit_identical():
    """comm.stream=0 reproduces the streamed chain's bytes exactly."""
    on = W.merged(W.spmd(W.stream_chain, 2, timeout=240.0,
                         expect_stream=True))
    off = W.merged(W.spmd(W.stream_chain, 2, timeout=240.0, stream=0,
                          expect_stream=False))
    assert on["A0"].tobytes() == off["A0"].tobytes()


def test_gemm_dist_2rank_out_of_core():
    """The 2-rank GEMM under a device budget below the per-rank working
    set: dirty C mirrors spill and re-stage, and the owned tiles are bit
    for bit the resident run's (the worker's check), and within the
    reference's 2e-3 of the JAX package's one-rank GEMM."""
    results = W.spmd(W.gemm_dist_ooc, 2, timeout=240.0)
    ref = W.reference(jpt, W.gemm_dist, N=64, nb=8)
    W.hold(results, ref, tol=_TOL)
    assert len(W.merged(results)) == 64


def test_gemm_dist_2rank_fused_bit_identical():
    """The 2-rank GEMM with wave fusion on and with device.wave_fuse=0:
    every owned tile bit for bit (the worker's check), and within 2e-3 of
    the JAX package's one-rank GEMM."""
    results = W.spmd(W.gemm_dist_wave_fuse, 2, timeout=240.0)
    ref = W.reference(jpt, W.gemm_dist, N=64, nb=8)
    W.hold(results, ref, tol=_TOL)


# ------------------------------------------------------------ colocated
def _colocated(prog, elems: int, seed: float):
    """Two ranks as two Contexts of this process, each with its own
    CudaDevice on the CPU, declared colocated: returns each rank's
    (device stats, its tile of A)."""
    import parsec_tpu_torch as pt
    from parsec_tpu_torch.device import CudaDevice

    results = {}
    port = W.free_port_base(2)

    def worker(rank, nodes=2):
        try:
            ctx = pt.Context(nb_workers=1)
            ctx.set_rank(rank, nodes)
            ctx.comm_init(port)
            ctx.comm_set_colocated([r for r in range(nodes) if r != rank])
            with ctx:
                esize = elems * 4
                arr = np.zeros((nodes, elems), dtype=np.float32)
                if rank == 0:
                    arr[0, :] = seed
                ctx.register_linear_collection("A", arr, elem_size=esize,
                                               nodes=nodes, myrank=rank)
                ctx.register_arena("t", esize)
                dev = CudaDevice(ctx, device="cpu")
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
                cons.flow("X", "R", pt.In(pt.Ref("Prod", k, flow="X")),
                          arena="t")
                cons.flow("Y", "W", pt.Out(pt.Mem("A", 1)), arena="t")
                prog(dev, tp, prod, cons)
                tp.run()
                tp.wait()
                ctx.comm_fence()
                stats = dict(dev.stats)
                dev.stop()
                ctx.comm_fini()
            results[rank] = ("ok", stats, arr[rank].copy())
        except Exception:
            import traceback
            results[rank] = ("err", traceback.format_exc(), None)

    saved = os.environ.get("PTC_MCA_comm_eager_limit")
    os.environ["PTC_MCA_comm_eager_limit"] = "1024"
    try:
        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=170)
    finally:
        if saved is None:
            os.environ.pop("PTC_MCA_comm_eager_limit", None)
        else:
            os.environ["PTC_MCA_comm_eager_limit"] = saved
    for r in range(2):
        assert results.get(r, ("missing",))[0] == "ok", results.get(r)
        assert results[r][1]["dp_errors"] == 0, results[r][1]
    return results


def test_colocated_dataplane_rides_device_clone():
    """Colocated PK_DEVICE payload: the producer serves a by-reference
    token, the consumer clones the producer's tensor on its own device
    (dp_d2d_bytes), and no byte of it crosses the host: no producer d2h,
    no consumer delivery or h2d."""
    elems = 1024

    def prog(dev, tp, prod, cons):
        dev.attach(prod, tp, kernel=lambda x: x * 3.0, reads=["X"],
                   writes=["X"], shapes={"X": (elems,)}, dtype=np.float32)
        dev.attach(cons, tp, kernel=lambda x: x + 1.0, reads=["X"],
                   writes=["Y"], shapes={"X": (elems,), "Y": (elems,)},
                   dtype=np.float32)

    res = _colocated(prog, elems, 2.0)
    s0, s1 = res[0][1], res[1][1]
    esize = elems * 4
    assert s0["dp_sends"] >= 1 and s0["d2h_bytes"] == 0, s0
    assert s1["dp_d2d_bytes"] == esize, s1
    assert s1["dp_recv_bytes"] == 0 and s1["h2d_bytes"] == 0, s1
    np.testing.assert_array_equal(res[1][2], np.full(elems, 7.0,
                                                     np.float32))


def test_colocated_consumer_host_read_materializes_lazily():
    """A CPU-chore consumer of a colocated by-ref delivery still reads the
    right bytes: the wire copy is bound as the clone's host buffer, dirty,
    and the coherence pull writes it at the first host read."""
    elems = 512

    def prog(dev, tp, prod, cons):
        dev.attach(prod, tp, kernel=lambda x: x * 2.0, reads=["X"],
                   writes=["X"], shapes={"X": (elems,)}, dtype=np.float32)

        def cpu_cons(view):
            x = view.data("X", np.float32, (elems,))
            y = view.data("Y", np.float32, (elems,))
            y[...] = x + 0.5

        cons.body(cpu_cons)

    res = _colocated(prog, elems, 5.0)
    np.testing.assert_array_equal(res[1][2], np.full(elems, 10.5,
                                                     np.float32))
    assert res[1][1]["dp_d2d_bytes"] == elems * 4, res[1][1]
