"""The prefetch lane's rest (device/prefetch.py): the lane engages only
while staging can pay.  On `CudaDevice(ctx, device="cpu")`:

  - a resident run (every tile already a mirror on the device) puts the
    lane to rest after a dry sweep: the manager's later handoffs are
    declined at once, and the factors are the bits of a run without the
    lane
  - a resting lane re-engages when a pool reads tiles only the host
    holds (a dispatch-time stage from the host rouses it), and stages
    that pool's next waves ahead of the manager
  - a path that stages from the host never rests while it stages

The lane's rest is the port's own (the reference's lane has none), so
these hold the port to itself and to numpy."""
import time

import numpy as np
import pytest
import torch

import parsec_tpu_torch as tpt
from parsec_tpu_torch.algos import build_potrf_panels
from parsec_tpu_torch.data import TwoDimBlockCyclic
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.device import bench_utils as bu

LANE = ("pf_dry_sweeps", "pf_engagements", "pf_handoffs",
        "pf_handoffs_skipped", "pf_handoff_ns")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread (the suite runs files in parallel
    worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _until(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline
        time.sleep(0.01)


def _resident_potrf(prefetch, solves=4, n=256, nb=16):
    """`solves` panel Cholesky solves of one generated SPD matrix whose
    panels are re-installed as device mirrors before each (as the
    benchmark's resident cells do).  Returns each solve's factor stack,
    each solve's lane counters and the device's stats at the end."""
    with tpt.Context(nb_workers=2) as ctx:
        A = TwoDimBlockCyclic(n, n, n, nb)
        A.register(ctx, "A")
        dev = CudaDevice(ctx, device="cpu", prefetch=prefetch)
        pristine = bu.generate_spd_panels_on_device(dev, A, seed=5).clone()
        outs, deltas = [], []
        for _ in range(solves):
            bu.install_device_tiles(dev, A, pristine.clone())
            s0 = dict(dev.info()["stats"])
            tp = build_potrf_panels(ctx, A, dev=dev)
            tp.run()
            tp.wait()
            bu.wait_device_tiles(dev, A)
            outs.append(bu.gather_device_tiles(dev, A).clone())
            tp.destroy()
            s1 = dev.info()["stats"]
            deltas.append({k: s1[k] - s0[k] for k in LANE + (
                "mgr_plan_ns", "prefetch_staged")})
        stats = dict(dev.info()["stats"])
        lane = dev._pf_lane
        thread = None if lane is None else lane._thread
        t0 = time.monotonic()
        dev.stop()
        stop_s = time.monotonic() - t0
        if thread is not None:  # a resting lane ends at the stop's wake
            assert not thread.is_alive()
            assert stop_s < 10.0, stop_s
    return outs, deltas, stats, pristine


def test_a_resident_run_puts_the_lane_to_rest():
    """Every tile the lookahead reads is a current mirror: the lane's
    sweeps are dry, it rests, and the manager's handoffs after the first
    solve are declined (no wait); nothing is staged ahead.  The factors
    are bit for bit those of a run without the lane, every solve's the
    same, and L L^T is the matrix."""
    outs, deltas, stats, a_st = _resident_potrf(True)
    ref, ref_deltas, ref_stats, _ = _resident_potrf(False)
    for got in outs + ref:
        assert torch.equal(got, ref[0])
    assert stats["pf_dry_sweeps"] > 0, stats
    assert sum(d["pf_handoffs_skipped"] for d in deltas[1:]) > 0, deltas
    assert all(d["prefetch_staged"] == 0 for d in deltas[1:]), deltas
    # the handoff's time is a part of the manager's planning time
    assert 0 <= stats["pf_handoff_ns"] <= stats["mgr_plan_ns"], stats
    # without the lane there is no handoff and no rest
    assert all(ref_stats[k] == 0 for k in LANE), ref_stats
    n = a_st.shape[1]
    a = bu.assemble_dense(a_st, 1, a_st.shape[0], a_st.shape[2],
                          n).double().numpy()
    L = np.tril(bu.assemble_dense(outs[-1], 1, a_st.shape[0],
                                  a_st.shape[2], n).double().numpy())
    assert np.linalg.norm(L @ L.T - a) / np.linalg.norm(a) < 1e-5


def _scale_pool(ctx, dev, t_name, o_name, nt, elems, scale):
    """y = scale * x + y over tile (0, k) of two 1 x nt collections,
    k < nt: independent tasks, each reading one tile of each."""
    tp = tpt.Taskpool(ctx, globals={"NT": nt - 1})
    k = tpt.L("k")
    tc = tp.task_class("Scale")
    tc.param("k", 0, tpt.G("NT"))
    tc.flow("X", "R", tpt.In(tpt.Mem(t_name, 0, k)))
    tc.flow("Y", "RW", tpt.In(tpt.Mem(o_name, 0, k)),
            tpt.Out(tpt.Mem(o_name, 0, k)))
    dev.attach(tc, tp, kernel=lambda x, y: x * scale + y, reads=["X", "Y"],
               writes=["Y"], shapes={"X": (1, elems), "Y": (1, elems)},
               dtype=np.float32)
    return tp


def _row(ctx, name, data):
    """A 1 x nt collection of 1 x elems tiles holding `data` (nt, elems)
    on the host."""
    nt, elems = data.shape
    c = TwoDimBlockCyclic(1, nt * elems, 1, elems, dtype=np.float32)
    c.from_dense(data.reshape(1, -1))
    c.register(ctx, name)
    return c


def test_a_resting_lane_engages_when_a_pool_reads_host_tiles():
    """First a pool over collections staged on the device
    (stage_collection): the lane's sweeps are dry and it rests.  Then a
    pool over collections only the host holds: the manager's first
    stage from the host rouses the lane, which engages (pf_engagements)
    and stages the next waves ahead of the manager (prefetch_hits).
    Both pools' results are numpy's."""
    nt, elems = 48, 2048
    rng = np.random.default_rng(26)
    t1, o1, t2, o2 = (rng.standard_normal((nt, elems)).astype(np.float32)
                      for _ in range(4))
    with tpt.Context(nb_workers=1) as ctx:
        dev = CudaDevice(ctx, device="cpu", prefetch=True)
        dev.batch_max = 4
        T1, O1 = _row(ctx, "T1", t1), _row(ctx, "O1", o1)
        dev.stage_collection(T1)
        dev.stage_collection(O1)
        tp = _scale_pool(ctx, dev, "T1", "O1", nt, elems, 2.0)
        tp.run()
        tp.wait()
        _until(lambda: dev._pf_rest)
        s0 = dict(dev.info()["stats"])
        assert s0["pf_dry_sweeps"] > 0, s0
        assert s0["prefetch_staged"] == 0, s0
        T2, O2 = _row(ctx, "T2", t2), _row(ctx, "O2", o2)
        tp2 = _scale_pool(ctx, dev, "T2", "O2", nt, elems, 3.0)
        tp2.run()
        tp2.wait()
        dev.flush()
        s1 = dict(dev.info()["stats"])
        got1, got2 = O1.to_dense(), O2.to_dense()
        dev.stop()
    assert s1["pf_engagements"] > s0["pf_engagements"], (s0, s1)
    assert s1["prefetch_misses"] > s0["prefetch_misses"], (s0, s1)
    assert s1["prefetch_staged"] > 0 and s1["prefetch_hits"] > 0, s1
    assert s1["pf_handoffs"] > s0["pf_handoffs"], (s0, s1)
    np.testing.assert_array_equal(got1.reshape(nt, elems), t1 * 2.0 + o1)
    np.testing.assert_array_equal(got2.reshape(nt, elems), t2 * 3.0 + o2)


def test_a_host_staged_path_never_rests_while_it_stages():
    """Every tile of the pool is on the host alone and no task shares
    one: every sweep finds a tile to stage or a stage in flight, so the
    lane never rests and never declines a handoff, and it stages ahead
    of the manager."""
    nt, elems = 48, 2048
    rng = np.random.default_rng(27)
    t, o = (rng.standard_normal((nt, elems)).astype(np.float32)
            for _ in range(2))
    with tpt.Context(nb_workers=1) as ctx:
        dev = CudaDevice(ctx, device="cpu", prefetch=True)
        dev.batch_max = 4
        _, O = _row(ctx, "T", t), _row(ctx, "O", o)
        tp = _scale_pool(ctx, dev, "T", "O", nt, elems, 2.0)
        tp.run()
        tp.wait()
        dev.flush()
        st = dict(dev.info()["stats"])
        rest = dev._pf_rest
        got = O.to_dense()
        dev.stop()
    assert st["pf_dry_sweeps"] == 0 and st["pf_handoffs_skipped"] == 0, st
    assert not rest
    assert st["prefetch_staged"] > 0 and st["prefetch_hits"] > 0, st
    np.testing.assert_array_equal(got.reshape(nt, elems), t * 2.0 + o)
