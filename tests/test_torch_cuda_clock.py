"""The program's trace and the card's timeline on one clock, on the card.

A DTD GEMM (N 2048, NB 512: one launch a task) runs under
ctx.profile_enable(1) and torch.profiler; with the trace mapped by
Trace.to_wall(), the launches' DEVICE_DISPATCH spans and their kernels on
the device's exec stream are paired in order, and no kernel may start
before the span that issued it opened.  Marked `cuda`: without a card it
skips (the decision is taken inside the fixture).  Run on a machine with
the card:

    python -m pytest tests/test_torch_cuda_clock.py -q -p no:cacheprovider \
        --noconftest
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def k_gemm(a, b, c):
    return c + a @ b


def dtd_gemm(card, n, nb, traced):
    """One DTD GEMM of n x n operands in nb tiles.  Traced: (the
    program's trace, the card's kernels (start_ns, end_ns, stream) on the
    wall clock, sorted)."""
    import parsec_tpu_torch as pt
    from parsec_tpu_torch.data import TwoDimBlockCyclic
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.dsl.dtd import DtdTaskpool
    from parsec_tpu_torch.profiling import take_trace
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(0)
    nt = n // nb
    with pt.Context(nb_workers=4) as ctx:
        colls = []
        for name in "ABC":
            c = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32)
            c.from_dense(rng.standard_normal((n, n), dtype=np.float32))
            c.register(ctx, name)
            colls.append(c)
        a, b, c = colls
        dev = CudaDevice(ctx, device=card)
        dtd = DtdTaskpool(ctx)
        prof = profile(activities=[ProfilerActivity.CUDA]) if traced \
            else None
        if traced:
            prof.start()
            # the trace's first anchor after the profiler's slow start:
            # anchors close around the run keep the line between them
            # true to the wall clock, which an NTP slew may bend
            ctx.profile_enable(1)
        for m in range(nt):
            for j in range(nt):
                for k in range(nt):
                    dtd.insert_cuda_task(
                        dev, k_gemm, (dtd.tile_of(a, m, k), "INPUT"),
                        (dtd.tile_of(b, k, j), "INPUT"),
                        (dtd.tile_of(c, m, j), "INOUT"),
                        shapes={i: (nb, nb) for i in range(3)})
        dtd.wait()
        torch.cuda.synchronize(card)
        if traced:
            prof.stop()
        dev.stop()
        dtd.destroy()
        if not traced:
            return None
        tr = take_trace(ctx)
    kernels = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() != DeviceType.CUDA or name.startswith(
                ("Memcpy", "Memset")):
            continue
        a0 = int(ev.start_ns())
        kernels.append((a0, a0 + int(ev.duration_ns()),
                        int(ev.device_resource_id())))
    return tr, sorted(kernels)


def test_dispatch_spans_precede_their_kernels(card):
    from parsec_tpu_torch.profiling import KEY_DEVICE
    n, nb = 2048, 512
    dtd_gemm(card, n, nb, traced=False)  # cuBLAS, the allocator, warm
    tr, kernels = dtd_gemm(card, n, nb, traced=True)
    wall = tr.to_wall()
    spans = sorted((s[7], s[8]) for s in wall.spans()
                   if s[2] == KEY_DEVICE)
    assert len(spans) == (n // nb) ** 3
    # the exec stream: the one that runs the launches' kernels
    streams = [k[2] for k in kernels]
    exec_stream = max(set(streams), key=streams.count)
    ops = [k for k in kernels if k[2] == exec_stream]
    assert ops and len(ops) % len(spans) == 0, (len(ops), len(spans))
    per = len(ops) // len(spans)
    early = [(i, s[0] - ops[per * i][0]) for i, s in enumerate(spans)
             if ops[per * i][0] < s[0]]
    assert not early, (early[:5], tr.wall_drift_ns())
    # the trace window lies between its anchors, on the wall clock too
    w = [a[1] for a in tr.meta["wall_anchors"]]
    assert w[0] <= spans[0][0] and spans[-1][1] <= w[-1]
    lead = min(ops[per * i][0] - s[0] for i, s in enumerate(spans))
    print(f"launches {len(spans)}, exec-stream kernels a launch {per}, "
          f"least lead of a span over its first kernel {lead} ns, trace "
          f"clock drift {tr.wall_drift_ns()} ns over {w[-1] - w[0]} ns")
