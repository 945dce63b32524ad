"""The port's CUDA kernels and device path on the card, each held against
its plain PyTorch version.  Marked `cuda`: without a card every test
skips (the decision is taken inside the fixture).  Run them on a machine
with a card, from the repo root, with

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider --noconftest

(--noconftest: tests/conftest.py sets up JAX, which this file does not
use and a CUDA machine may not have)."""
import numpy as np
import pytest

import parsec_tpu_torch as pt
from parsec_tpu_torch import kernels
from parsec_tpu_torch.algos import build_gemm
from parsec_tpu_torch.comm.launch import free_port_base
from parsec_tpu_torch.convert import to_collection
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.ops.flash_attention import (attention_reference,
                                                  flash_attention_cuda)
from parsec_tpu_torch.ops.rms_norm import rms_norm_cuda, rms_norm_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _t(card, shape, seed, dtype=None):
    import torch
    a = np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)
    return torch.from_numpy(a).to(card, dtype or torch.float32)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 1.6e-2)])
def test_rms_norm_kernel_matches_plain(card, dtype, tol):
    import torch
    dt = getattr(torch, dtype)
    x, w = _t(card, (256, 384), 0, dt), _t(card, (384,), 1, dt)
    y = rms_norm_cuda(x, w, 1e-6)
    torch.testing.assert_close(y.float(), rms_norm_plain(x, w, 1e-6).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain(card, d, causal):
    import torch
    q, k, v = (_t(card, (3, 192, d), s) for s in (2, 3, 4))
    o = flash_attention_cuda(q, k, v, causal, d ** -0.5)
    torch.testing.assert_close(o, attention_reference(q, k, v, causal,
                                                      d ** -0.5),
                               rtol=2e-5, atol=2e-5)


def test_flash_kernel_shared_kv_lane_stride_zero(card):
    import torch
    q = _t(card, (4, 128, 64), 5)
    k = _t(card, (128, 64), 6).unsqueeze(0).expand(4, 128, 64)
    v = _t(card, (128, 64), 7).unsqueeze(0).expand(4, 128, 64)
    torch.testing.assert_close(flash_attention_cuda(q, k, v, False, 0.125),
                               attention_reference(q, k, v, False, 0.125),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_16bit_matches_plain(card, dtype, causal):
    """bf16 and f16 in and out, at the RMSNorm bf16 tolerance: the kernel
    and the plain version both sum in f32, in another order, and each
    rounds its f32 result to the 16-bit type once."""
    import torch
    dt = getattr(torch, dtype)
    q, k, v = (_t(card, (3, 192, 128), s, dt) for s in (10, 11, 12))
    o = flash_attention_cuda(q, k, v, causal, 128 ** -0.5)
    assert o.dtype == dt
    torch.testing.assert_close(
        o.float(), attention_reference(q, k, v, causal, 128 ** -0.5).float(),
        rtol=1.6e-2, atol=1e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_lq_differs_from_lk(card, causal):
    """192 query rows (a 128-row block and a 64-row tail) over 320 keys."""
    import torch
    q = _t(card, (2, 192, 64), 13)
    k, v = _t(card, (2, 320, 64), 14), _t(card, (2, 320, 64), 15)
    torch.testing.assert_close(flash_attention_cuda(q, k, v, causal, 0.125),
                               attention_reference(q, k, v, causal, 0.125),
                               rtol=2e-5, atol=2e-5)


def test_flash_kernel_causal_shared_kv(card):
    import torch
    q = _t(card, (4, 192, 128), 16)
    k = _t(card, (192, 128), 17).unsqueeze(0).expand(4, 192, 128)
    v = _t(card, (192, 128), 18).unsqueeze(0).expand(4, 192, 128)
    sc = 128 ** -0.5
    torch.testing.assert_close(flash_attention_cuda(q, k, v, True, sc),
                               attention_reference(q, k, v, True, sc),
                               rtol=2e-5, atol=2e-5)


def test_flash_kernel_misaligned_input_is_copied(card):
    """The kernel stages rows with 16-byte copies; a q whose rows start 4
    bytes off that alignment is copied by the wrapper, not refused."""
    import torch
    q = _t(card, (2 * 128 * 64 + 1,), 22)[1:].view(2, 128, 64)
    assert q.data_ptr() % 16
    k, v = _t(card, (2, 128, 64), 23), _t(card, (2, 128, 64), 24)
    torch.testing.assert_close(flash_attention_cuda(q, k, v, False, 0.125),
                               attention_reference(q, k, v, False, 0.125),
                               rtol=2e-5, atol=2e-5)


def test_flash_kernel_f32_large_scores(card):
    """q scaled by 4: peaked softmax rows, where a single TF32 pass would
    miss the reference's 2e-5 and the three-pass split must not."""
    import torch
    q, k, v = (_t(card, (3, 256, 128), s) for s in (19, 20, 21))
    q = q * 4
    sc = 128 ** -0.5
    torch.testing.assert_close(flash_attention_cuda(q, k, v, False, sc),
                               attention_reference(q, k, v, False, sc),
                               rtol=2e-5, atol=2e-5)


def test_gemm_taskpool_on_the_card(card):
    rng = np.random.default_rng(8)
    a = rng.standard_normal((256, 256), dtype=np.float32)
    b = rng.standard_normal((256, 256), dtype=np.float32)
    with pt.Context(nb_workers=2) as ctx:
        A, B = to_collection(a, 64, 64), to_collection(b, 64, 64)
        C = to_collection(np.zeros((256, 256), np.float32), 64, 64)
        for name, c in zip("ABC", (A, B, C)):
            c.register(ctx, name)
        dev = CudaDevice(ctx)
        tp = build_gemm(ctx, A, B, C, dev=dev)
        tp.run()
        tp.wait()
        dev.stop()
        np.testing.assert_allclose(C.to_dense(), a @ b, rtol=1e-4,
                                   atol=1e-3)
        assert dev.stats["tasks"] == 64 and dev.stats["h2d_hits"] > 0


def test_norm_taskpool_launches_the_kernel(card):
    from parsec_tpu_torch.ops import build_rms_norm
    rng = np.random.default_rng(9)
    x = rng.standard_normal((512, 256), dtype=np.float32)
    w = rng.standard_normal((1, 256), dtype=np.float32)
    with pt.Context(nb_workers=2) as ctx:
        Xc, Wc = to_collection(x, 128, 256), to_collection(w, 1, 256)
        Oc = to_collection(np.zeros_like(x), 128, 256)
        dev = CudaDevice(ctx)
        kernels.reset_launches()
        tp = build_rms_norm(ctx, Xc, Wc, Oc, dev=dev)
        tp.run()
        tp.wait()
        dev.stop()
        assert kernels.LAUNCHES["rms_norm"] >= 1
        ref = x / np.sqrt(np.mean(x * x, -1, keepdims=True) + 1e-6) * w[0]
        np.testing.assert_allclose(Oc.to_dense(), ref, rtol=2e-5, atol=2e-5)


def test_host_reads_of_device_results_are_coherent(card):
    """A CPU chore reading a device result (TaskView.data sync) and a
    sync_mem_out flow (the writeback lane) both see the card's bytes."""
    seen = []
    with pt.Context(nb_workers=2) as ctx:
        X = to_collection(np.full((64, 64), 2.0, np.float32), 64, 64)
        Y = to_collection(np.zeros((64, 64), np.float32), 64, 64)
        Z = to_collection(np.zeros((64, 64), np.float32), 64, 64)
        for name, c in zip("XYZ", (X, Y, Z)):
            c.register(ctx, name)
        dev = CudaDevice(ctx)
        tp = pt.Taskpool(ctx)
        a = tp.task_class("Dev")
        a.flow("X", "READ", pt.In(pt.Mem("X", 0, 0)))
        a.flow("Y", "RW", pt.In(pt.Mem("Y", 0, 0)),
               pt.Out(pt.Ref("Host", flow="Y")))
        dev.attach(a, tp, kernel=lambda x: x * 5.0, reads=["X"],
                   writes=["Y"], shapes={"X": (64, 64), "Y": (64, 64)})
        b = tp.task_class("Host")
        b.flow("Y", "READ", pt.In(pt.Ref("Dev", flow="Y")))
        b.body(lambda t: seen.append(
            t.data("Y", np.float32, (64, 64)).copy()))
        c = tp.task_class("Wb")
        c.flow("X", "READ", pt.In(pt.Mem("X", 0, 0)))
        c.flow("Z", "RW", pt.In(pt.Mem("Z", 0, 0)),
               pt.Out(pt.Mem("Z", 0, 0)))
        dev.attach(c, tp, kernel=lambda x: x + 1.0, reads=["X"],
                   writes=["Z"], shapes={"X": (64, 64), "Z": (64, 64)},
                   sync_mem_out=True)
        tp.run()
        tp.wait()
        np.testing.assert_array_equal(Z.tile(0, 0), 3.0)
        assert dev.stats["wb_tasks"] == 1
        dev.stop()
    np.testing.assert_array_equal(seen[0], 10.0)


@pytest.mark.parametrize("lanes", [1, 8])
def test_fold_chore_on_the_card_matches_host_fold(card, lanes):
    """The serving path's fold chore at its decode shape (32 heads of
    128, 16-row pages) against the numpy host fold: f32 sums over 128
    and 16 terms in another order, 1e-5."""
    import torch
    from parsec_tpu_torch.ops.paged_attention import (attend_heads,
                                                      fold_heads, reset_acc)
    nh, dh, P = 32, 128, 16
    d = nh * dh
    rng = np.random.default_rng(30 + lanes)
    q, K, V = ((0.5 * rng.standard_normal(s)).astype(np.float32)
               for s in ((lanes, 1, d), (lanes, P, d), (lanes, P, d)))
    acc = np.zeros((lanes, 1, d + 2 * nh), np.float32)
    for i in range(lanes):
        reset_acc(acc[i], nh)
        attend_heads(q[i, 0], K[i], V[i], acc[i], dh ** -0.5, nh)
    got = fold_heads(*(torch.from_numpy(a).to(card) for a in (q, K, V, acc)),
                     dh ** -0.5, nh)
    for i in range(lanes):
        attend_heads(q[i, 0], K[i], V[i], acc[i], dh ** -0.5, nh)
    np.testing.assert_allclose(got.cpu().numpy(), acc, rtol=1e-5, atol=1e-5)


def _panels(dense, nb):
    from parsec_tpu_torch.data import TwoDimBlockCyclic
    n = dense.shape[0]
    c = TwoDimBlockCyclic(n, n, n, nb)
    for j in range(c.nt):
        c.tile(0, j)[...] = dense[:, j * nb:(j + 1) * nb]
    return c


def _panel_dense(c):
    return np.concatenate([c.tile(0, j) for j in range(c.nt)], axis=1)


def _spd(n, seed):
    x = np.random.default_rng(seed).standard_normal((n, n))
    return (x @ x.T + n * np.eye(n)).astype(np.float32)


def test_panel_potrf_on_the_card_with_its_epilogue(card):
    """build_potrf_panels at N=512, nb=64 on the card against float64
    numpy at the reference's panel tolerance; the epilogue factors every
    chained panel (7 stores, 7 hits, no miss)."""
    from parsec_tpu_torch.algos import build_potrf_panels
    spd = _spd(512, 40)
    with pt.Context(nb_workers=2) as ctx:
        A = _panels(spd, 64)
        A.register(ctx, "A")
        dev = CudaDevice(ctx)
        tp = build_potrf_panels(ctx, A, dev=dev)
        tp.run()
        tp.wait()
        dev.flush()
        st = dict(dev.stats)
        dev.stop()
        got = np.tril(_panel_dense(A))
    np.testing.assert_allclose(got, np.linalg.cholesky(spd.astype(
        np.float64)), rtol=2e-3, atol=2e-3)
    assert st["tasks"] == 8 + 28
    assert st["spec_store"] == st["spec_hits"] == 7
    assert st["spec_misses"] == 0


@pytest.mark.parametrize("via_inverse", [True, False])
def test_tiled_potrf_on_the_card(card, via_inverse):
    from parsec_tpu_torch.algos import build_potrf
    spd = _spd(256, 41)
    with pt.Context(nb_workers=2) as ctx:
        A = to_collection(spd, 64, 64)
        A.register(ctx, "A")
        dev = CudaDevice(ctx)
        tp = build_potrf(ctx, A, dev=dev, trsm_via_inverse=via_inverse)
        tp.run()
        tp.wait()
        dev.stop()
        assert dev.stats["tasks"] == 4 + 6 + 6 + 4
        got = np.tril(A.to_dense())
    np.testing.assert_allclose(got, np.linalg.cholesky(spd.astype(
        np.float64)), rtol=2e-3, atol=2e-3)


def test_getrf_panels_on_the_card(card):
    """No-pivot LU panels (cuSOLVER getrf without pivots in the factor)
    against the float64 Doolittle oracle; the two-output epilogue hits
    every chained factor."""
    from parsec_tpu_torch.algos import (build_getrf_panels,
                                        getrf_nopiv_reference)
    n, nb = 384, 64
    full = (np.random.default_rng(42).standard_normal((n, n))
            + n * np.eye(n)).astype(np.float32)
    with pt.Context(nb_workers=2) as ctx:
        A = _panels(full, nb)
        A.register(ctx, "A")
        dev = CudaDevice(ctx)
        tp = build_getrf_panels(ctx, A, dev=dev)
        tp.run()
        tp.wait()
        dev.flush()
        st = dict(dev.stats)
        dev.stop()
        got = _panel_dense(A)
    np.testing.assert_allclose(got, getrf_nopiv_reference(full), rtol=5e-3,
                               atol=5e-3)
    assert st["spec_hits"] == 5 and st["spec_misses"] == 0


def test_geqrf_on_the_card(card):
    """Tiled QR: R upper triangular with R^T R = A^T A in float64 (Q's
    signs are cuSOLVER's own, so R is compared through its Gram)."""
    from parsec_tpu_torch.algos import build_geqrf
    a0 = np.random.default_rng(43).standard_normal((256, 256)) \
        .astype(np.float32)
    with pt.Context(nb_workers=2) as ctx:
        A = to_collection(a0, 64, 64)
        A.register(ctx, "A")
        dev = CudaDevice(ctx)
        tp = build_geqrf(ctx, A, dev=dev)
        tp.run()
        tp.wait()
        dev.stop()
        assert dev.stats["tasks"] == 4 + 6 + 6 + 14
        r = A.to_dense().astype(np.float64)
    np.testing.assert_allclose(np.tril(r, -1), 0, atol=2e-4)
    a = a0.astype(np.float64)
    np.testing.assert_allclose(r.T @ r, a.T @ a, rtol=2e-3, atol=2e-3)


def test_generators_on_the_card_agree_block_for_block(card):
    from parsec_tpu_torch.data import TwoDimBlockCyclic
    from parsec_tpu_torch.device import bench_utils as bu
    n, nb = 256, 64
    dense = []
    with pt.Context(nb_workers=1) as ctx:
        for i, panels in enumerate((False, True)):
            A = TwoDimBlockCyclic(n, n, n if panels else nb, nb)
            A.register(ctx, f"A{i}")
            dev = CudaDevice(ctx)
            st = (bu.generate_spd_panels_on_device if panels
                  else bu.generate_spd_on_device)(dev, A, seed=5)
            dense.append(bu.assemble_dense(st, A.mt, A.nt, nb, A.mb)
                         .cpu().numpy())
            dev.stop()
    assert dense[0].tobytes() == dense[1].tobytes()
    np.testing.assert_array_equal(dense[0], dense[0].T)


def test_dense_chores_refuse_tf32(card):
    """A context that turned TF32 on is refused: the chore raises, and a
    taskpool whose chore raises fails (no fallback)."""
    import torch
    from parsec_tpu_torch.algos import build_potrf
    from parsec_tpu_torch.algos.potrf import k_potrf
    spd = _spd(128, 44)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            k_potrf(torch.from_numpy(spd).to(card).unsqueeze(0))
        with pt.Context(nb_workers=2) as ctx:
            A = to_collection(spd, 64, 64)
            A.register(ctx, "A")
            dev = CudaDevice(ctx)
            tp = build_potrf(ctx, A, dev=dev)
            tp.run()
            with pytest.raises(RuntimeError, match="aborted"):
                tp.wait()
            dev.stop()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_serving_engine_on_the_card_matches_float64_oracle(card):
    """Two requests at d=512, 4 heads through Server -> InferenceEngine
    -> CudaDevice: every output within 1e-4 / 1e-5 of the float64 oracle
    on the engine's own token stream, every token its argmax (up to a
    1e-4 tie), and the frozen pages folded on the card."""
    import torch
    import chip_smoke
    from parsec_tpu_torch.serve import (InferenceEngine, PagedLM,
                                        PagedLMConfig, TenantConfig)
    model = PagedLM(PagedLMConfig(vocab=1000, d=512, heads=4, page=16,
                                  seed=4))
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, 1000, size=n)]
               for n in (100, 300)]
    with pt.Context(nb_workers=2, scheduler="lws") as ctx:
        dev = CudaDevice(ctx)
        eng = InferenceEngine(ctx, model, n_pages=64, max_seqs=2, dev=dev,
                              tenants=[TenantConfig("t")])
        hs = [eng.submit(p, 5, "t") for p in prompts]
        eng.run(timeout_s=300)
        st = dict(dev.stats)
        eng.close()
        dev.stop()
    head64 = (model.wo.double(), model.embed.double())
    for h in hs:
        assert h.state == "done" and len(h.generated) == 5
        o, logits = chip_smoke.serve_oracle(model, h, card, head64)
        torch.testing.assert_close(
            torch.from_numpy(np.stack(h.outputs)).to(card).double(), o,
            rtol=1e-4, atol=1e-5)
        top2 = torch.topk(logits, 2, dim=-1)
        for t, tok in enumerate(h.generated):
            assert tok == int(top2.indices[t, 0]) or float(
                top2.values[t, 0] - top2.values[t, 1]) <= 1e-4
    assert st["tasks"] > 0 and st["h2d_hits"] > 0


def _scale_pool(ctx, src, dst, tb):
    """A pool of one task per tile of src (collection T), reading it and
    updating the same tile of dst (collection O); the caller attaches the
    chore."""
    ctx.register_linear_collection("T", src, elem_size=tb)
    ctx.register_linear_collection("O", dst, elem_size=tb)
    ctx.register_arena("t", tb)
    tp = pt.Taskpool(ctx, globals={"NT": src.shape[0] - 1})
    k = pt.L("k")
    tc = tp.task_class("Scale")
    tc.param("k", 0, pt.G("NT"))
    tc.flow("X", "R", pt.In(pt.Mem("T", k)), arena="t")
    tc.flow("Y", "RW", pt.In(pt.Mem("O", k)), pt.Out(pt.Mem("O", k)),
            arena="t")
    return tp, tc


def test_device_holds_three_distinct_streams(card):
    """h2d copies, kernels and d2h copies each have a stream of their own,
    none of them the default stream."""
    import torch
    with pt.Context(nb_workers=1) as ctx:
        dev = CudaDevice(ctx)
        ids = {s.cuda_stream for s in (dev._stream, dev._h2d_stream,
                                       dev._d2h_stream)}
        dev.stop()
    assert len(ids) == 3, ids
    assert torch.cuda.default_stream(card).cuda_stream not in ids


def test_prefetched_tile_behind_a_slow_h2d_is_read_correctly(card):
    """The lane's copies are queued behind a long sleep on the h2d stream,
    so they are still pending when the manager launches: the exec stream
    must wait on each entry's copy event, or the kernel reads memory the
    copy has not filled yet."""
    import torch
    from parsec_tpu_torch.device.prefetch import _PrefetchLane
    n, elems = 8, 1 << 20
    src = np.random.default_rng(13).standard_normal((n, elems)) \
        .astype(np.float32)
    dst = np.zeros_like(src)
    with pt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx, autostart=False, prefetch=True)
        dev.batch_max = 4
        tp, tc = _scale_pool(ctx, src, dst, elems * 4)
        dev.attach(tc, tp, kernel=lambda x, y: x * 2.0 + y,
                   reads=["X", "Y"], writes=["Y"],
                   shapes={"X": (elems,), "Y": (elems,)})
        tp.run()
        import time
        deadline = time.monotonic() + 30
        while ctx.device_queue_depth(dev.qid) < n:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        with torch.cuda.stream(dev._h2d_stream):
            torch.cuda._sleep(1 << 30)  # about half a second
        assert _PrefetchLane(dev, depth=64, slots=2)._sweep()
        with dev._lock:
            pending = [e for e in dev._cache.values() if e.pf]
        assert pending and not any(e.event.query() for e in pending)
        dev.start()
        tp.wait()
        dev.flush()
        hits = dev.stats["prefetch_hits"]
        dev.stop()
    assert hits > 0
    np.testing.assert_array_equal(dst, src * 2.0)


def test_flush_right_after_a_wave_returns_the_launch_bytes(card):
    """The wave's kernel sleeps on the exec stream before it writes: a
    flush issued as soon as the pool completes must wait on the launch's
    event on the d2h stream and land the kernel's bytes, not the
    output's unwritten memory."""
    import torch
    n, elems = 8, 1 << 20
    src = np.random.default_rng(14).standard_normal((n, elems)) \
        .astype(np.float32)
    dst = np.zeros_like(src)

    def slow_scale(x, y):
        torch.cuda._sleep(1 << 28)
        return x * 3.0 + y

    with pt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx)
        tp, tc = _scale_pool(ctx, src, dst, elems * 4)
        dev.attach(tc, tp, kernel=slow_scale, reads=["X", "Y"],
                   writes=["Y"], shapes={"X": (elems,), "Y": (elems,)})
        tp.run()
        tp.wait()
        dev.flush()
        np.testing.assert_array_equal(dst, src * 3.0)
        dev.stop()


def test_norm_out_of_core_bit_identical_to_resident(card):
    """NORM through the RMSNorm kernel, resident and with a budget of
    half its O (dirty mirrors spill through the writeback lane): the same
    bits, and within 2e-5 of the plain version."""
    import torch
    from parsec_tpu_torch.ops import build_rms_norm
    rows, d, T = 4096, 1024, 256
    x = np.random.default_rng(15).standard_normal((rows, d)) \
        .astype(np.float32)
    w = np.random.default_rng(16).standard_normal((1, d)).astype(np.float32)
    outs, spills = [], []
    for budget in (None, rows * d * 2):
        Xc, Wc = to_collection(x, T, d), to_collection(w, 1, d)
        Oc = to_collection(np.zeros_like(x), T, d)
        with pt.Context(nb_workers=2) as ctx:
            kw = {} if budget is None else {"cache_bytes": budget}
            dev = CudaDevice(ctx, **kw)
            dev.batch_max = 4
            kernels.reset_launches()
            tp = build_rms_norm(ctx, Xc, Wc, Oc, dev=dev)
            tp.run()
            tp.wait()
            dev.flush()
            spills.append(dev.stats["spills"])
            dev.stop()
            assert kernels.LAUNCHES["rms_norm"] >= 1
        outs.append(Oc.to_dense())
    assert spills[0] == 0 and spills[1] > 0, spills
    np.testing.assert_array_equal(outs[0], outs[1])
    want = rms_norm_plain(torch.from_numpy(x).to(card),
                          torch.from_numpy(w[0]).to(card), 1e-6)
    np.testing.assert_allclose(outs[0], want.cpu().numpy(), rtol=2e-5,
                               atol=2e-5)


# ------------------------------------------------ the DSLs on the card
def _dtd_norm_fatt(card, kernel_norm, kernel_fatt):
    """NORM and FATT as DTD device tasks on CudaDevice(ctx), 3 tasks
    each; returns (O norm, O fatt, inputs, launches in the run)."""
    from parsec_tpu_torch.dsl.dtd import DtdTaskpool
    R, T, d = 3, 256, 512
    H, L, D = 3, 128, 64
    rng = np.random.default_rng(31)
    x = rng.standard_normal((R * T, d), dtype=np.float32)
    w = rng.standard_normal((1, d), dtype=np.float32)
    q = rng.standard_normal((H * L, D), dtype=np.float32)
    k = rng.standard_normal((L, D), dtype=np.float32)
    v = rng.standard_normal((L, D), dtype=np.float32)
    colls = {"X": to_collection(x, T, d), "W": to_collection(w, 1, d),
             "O": to_collection(np.zeros_like(x), T, d),
             "Q": to_collection(q, L, D), "K": to_collection(k, L, D),
             "V": to_collection(v, L, D),
             "P": to_collection(np.zeros_like(q), L, D)}
    with pt.Context(nb_workers=2) as ctx:
        for name, c in colls.items():
            c.register(ctx, name)
        dev = CudaDevice(ctx)
        dtd = DtdTaskpool(ctx)
        kernels.reset_launches()
        tile = dtd.tile_of
        for r in range(R):
            dtd.insert_cuda_task(dev, kernel_norm,
                                 (tile(colls["X"], r, 0), "INPUT"),
                                 (tile(colls["W"], 0, 0), "INPUT"),
                                 (tile(colls["O"], r, 0), "OUTPUT"),
                                 shapes={0: (T, d), 1: (1, d), 2: (T, d)})
        for h in range(H):
            dtd.insert_cuda_task(dev, kernel_fatt,
                                 (tile(colls["Q"], h, 0), "INPUT"),
                                 (tile(colls["K"], 0, 0), "INPUT"),
                                 (tile(colls["V"], 0, 0), "INPUT"),
                                 (tile(colls["P"], h, 0), "OUTPUT"),
                                 shapes={i: (L, D) for i in range(4)})
        try:
            dtd.wait()
        finally:
            dev.flush()
            launches = dict(kernels.LAUNCHES)
            dev.stop()
            dtd.destroy()
    return (colls["O"].to_dense(), colls["P"].to_dense(), (x, w, q, k, v),
            launches)


def test_dtd_device_tasks_launch_each_kernel(card):
    """A DTD device task on CudaDevice(ctx) launches the RMSNorm kernel,
    another the flash kernel, once a task; each output matches its plain
    version at 2e-5."""
    import torch
    from parsec_tpu_torch.ops.flash_attention import flash_fwd
    from parsec_tpu_torch.ops.rms_norm import rms_norm

    def k_norm(xb, wb):
        return rms_norm(xb, wb[0], 1e-6)

    def k_fatt(qb, kb, vb):
        return flash_fwd(qb[None], kb[None], vb[None], False, 0.125)[0]

    o, p, (x, w, q, k, v), launches = _dtd_norm_fatt(card, k_norm, k_fatt)
    assert launches == {"rms_norm": 3, "flash_attention": 3}
    want = rms_norm_plain(torch.from_numpy(x).to(card),
                          torch.from_numpy(w[0]).to(card), 1e-6)
    np.testing.assert_allclose(o, want.cpu().numpy(), rtol=2e-5, atol=2e-5)
    kt = torch.from_numpy(k).to(card).expand(3, 128, 64)
    vt = torch.from_numpy(v).to(card).expand(3, 128, 64)
    att = attention_reference(torch.from_numpy(q).to(card)
                              .reshape(3, 128, 64), kt, vt, False, 0.125)
    np.testing.assert_allclose(p, att.reshape(-1, 64).cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


def test_dtd_device_task_that_cannot_launch_raises(card):
    """A kernel the wrapper cannot launch (the flash kernel has no head
    dim 48) fails the pool: nothing falls back to the plain version, and
    no flash launch is counted."""
    from parsec_tpu_torch.ops.flash_attention import flash_attention_cuda
    from parsec_tpu_torch.ops.rms_norm import rms_norm

    def k_norm(xb, wb):
        return rms_norm(xb, wb[0], 1e-6)

    def k_bad(qb, kb, vb):
        return flash_attention_cuda(qb[None, :, :48], kb[None, :, :48],
                                    vb[None, :, :48], False, 0.125)[0]

    with pytest.raises(RuntimeError, match="aborted"):
        _dtd_norm_fatt(card, k_norm, k_bad)
    assert kernels.LAUNCHES["flash_attention"] == 0


def test_jdf_cuda_body_launches_the_rms_norm_kernel(card):
    """A JDF class whose BODY [type=CUDA] calls the RMSNorm op on its
    wave's stacks launches the kernel; O matches the plain version."""
    import torch
    from parsec_tpu_torch.dsl.jdf import compile_jdf
    from parsec_tpu_torch.ops.rms_norm import rms_norm
    src = """
R [ type = "int" ]
NORM(r)
r = 0 .. R
: X( r, 0 )
READ X <- X( r, 0 )
READ W <- W( 0, 0 )
RW   O <- O( r, 0 )
       -> O( r, 0 )
BODY [type=CUDA reads=X,W writes=O]
{
O = rms_norm(X, W[0, 0], 1e-6)
}
END
"""
    R, T, d = 4, 256, 512
    rng = np.random.default_rng(37)
    x = rng.standard_normal((R * T, d), dtype=np.float32)
    w = rng.standard_normal((1, d), dtype=np.float32)
    X, W = to_collection(x, T, d), to_collection(w, 1, d)
    O = to_collection(np.zeros_like(x), T, d)
    with pt.Context(nb_workers=2) as ctx:
        for name, c in (("X", X), ("W", W), ("O", O)):
            c.register(ctx, name)
        dev = CudaDevice(ctx)
        kernels.reset_launches()
        b = compile_jdf(src, ctx, globals={"R": R - 1}, dtype=np.float32,
                        shapes={"X": (T, d), "W": (1, d), "O": (T, d)},
                        dev=dev)
        b.scope["rms_norm"] = rms_norm
        b.run().wait()
        dev.flush()
        dev.stop()
    assert kernels.LAUNCHES["rms_norm"] >= 1
    want = rms_norm_plain(torch.from_numpy(x).to(card),
                          torch.from_numpy(w[0]).to(card), 1e-6)
    np.testing.assert_allclose(O.to_dense(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


def test_traced_norm_spans_match_launches_and_stats(card):
    """Phase 9a's checks at a small NORM: the DEVICE_DISPATCH spans equal
    the RMSNorm kernel's launches, their lanes the device's tasks, the
    DEVICE_H2D bytes stats["h2d_bytes"] and the ends' aux
    stats["h2d_stall_ns"]."""
    from parsec_tpu_torch.ops.rms_norm import build_rms_norm
    from parsec_tpu_torch.profiling import KEY_DEVICE, KEY_H2D, take_trace
    R, T, d = 8, 256, 512
    rng = np.random.default_rng(41)
    x = rng.standard_normal((R * T, d), dtype=np.float32)
    w = rng.standard_normal((1, d), dtype=np.float32)
    X, W = to_collection(x, T, d), to_collection(w, 1, d)
    O = to_collection(np.zeros_like(x), T, d)
    with pt.Context(nb_workers=2) as ctx:
        ctx.profile_enable(2)
        dev = CudaDevice(ctx)
        kernels.reset_launches()
        tp = build_rms_norm(ctx, X, W, O, 1e-6, dev=dev)
        tp.run()
        tp.wait()
        dev.flush()
        dev.stop()
        st = dict(dev.stats)
        tr = take_trace(ctx, class_names=["NORM"])
    ev = tr.events
    beg = ev[:, 1] == 0
    d_, h_ = ev[:, 0] == KEY_DEVICE, ev[:, 0] == KEY_H2D
    assert (d_ & beg).sum() == (d_ & ~beg).sum() == \
        kernels.LAUNCHES["rms_norm"] >= 1
    assert ev[d_ & beg, 3].sum() == st["tasks"] == R
    assert ev[h_ & beg, 3].sum() == st["h2d_bytes"]
    assert ev[d_ & ~beg, 6].sum() == st["h2d_stall_ns"]


def test_recursive_potrf_over_the_card(card):
    """Phase 9b at a small size: one host task recursing into a potrf
    over sub-tiles whose chores run on the card; the writeback pulls the
    dirty mirrors on the manager thread, and L matches
    torch.linalg.cholesky within 1e-3 max|L|."""
    import threading

    import torch
    from parsec_tpu_torch.algos import build_potrf
    from parsec_tpu_torch.data import SubtileView, TwoDimBlockCyclic
    n, nb = 512, 64
    g = np.random.default_rng(43).standard_normal((n, n)).astype(np.float32)
    spd = (g + g.T) * 0.5 + 2.0 * n * np.eye(n, dtype=np.float32)
    where = []
    with pt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx)
        A = TwoDimBlockCyclic(n, n, n, n)
        A.tile(0, 0)[...] = spd
        A.register(ctx, "A")
        tp = pt.Taskpool(ctx, globals={})
        tc = tp.task_class("FACTOR")
        tc.param("k", 0, 0)
        tc.flow("T", "RW", pt.In(pt.Mem("A", pt.L("k"), pt.L("k"))),
                pt.Out(pt.Mem("A", pt.L("k"), pt.L("k"))))

        def body(t):
            sub = SubtileView(t.data("T", np.float32, (n, n)), nb, nb)
            sub.register(ctx, "SUB")

            def on_done():
                where.append(threading.current_thread().name)
                sub.writeback()

            return pt.recursive_call(t, build_potrf(ctx, sub, dev,
                                                    name="SUB"),
                                     on_done=on_done)

        tc.body(body)
        tp.run()
        tp.wait()
        assert dev.stats["tasks"] > 0
        dev.stop()
    lo = torch.tril(torch.from_numpy(A.tile(0, 0).copy()).to(card))
    lc = torch.linalg.cholesky(torch.from_numpy(spd).to(card))
    assert float((lo - lc).abs().max() / lc.abs().max()) <= 1e-3
    assert where == ["ptc-cuda-manager"]


def test_compose_potri_on_the_card_matches_run_potri(card):
    """Phase 9c at a small size: compose(potrf, trtri, lauum) as one
    Compound on the card against run_potri, within 1e-4 max|ref|."""
    from parsec_tpu_torch.algos import (build_lauum, build_potrf,
                                        build_trtri, run_potri)
    from parsec_tpu_torch.data import TwoDimBlockCyclic
    from parsec_tpu_torch.device.bench_utils import generate_spd_on_device
    n, nb = 512, 64
    with pt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx)
        cs = {}
        for name in ("A", "W", "C", "A2", "W2", "C2"):
            cs[name] = TwoDimBlockCyclic(n, n, nb, nb)
            cs[name].register(ctx, name)
        generate_spd_on_device(dev, cs["A"], seed=5)
        generate_spd_on_device(dev, cs["A2"], seed=5)
        comp = pt.compose(
            build_potrf(ctx, cs["A"], dev=dev, name="A"),
            build_trtri(ctx, cs["A"], cs["W"], dev=dev, names=("A", "W")),
            build_lauum(ctx, cs["W"], cs["C"], dev=dev, names=("W", "C")))
        comp.run()
        comp.wait()
        dev.flush()
        run_potri(ctx, cs["A2"], cs["W2"], cs["C2"], dev=dev,
                  names=("A2", "W2", "C2"))
        got, want = (np.tril(cs[c].to_dense()) for c in ("C", "C2"))
        dev.stop()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_reshape_paths_on_a_device_dirty_factor(card):
    """Phase 9d at a small size: a factor left dirty on the card,
    regridded (bit for bit the flushed factor), cast to float16 (bit for
    bit numpy's astype) and column-reduced on the host (1e-4 max|ref| of
    a float64 sum)."""
    from parsec_tpu_torch.algos import (build_potrf, build_reduce_col,
                                        build_reshape_dtype,
                                        reshape_geometry)
    from parsec_tpu_torch.data import TwoDimBlockCyclic
    from parsec_tpu_torch.device.bench_utils import generate_spd_on_device
    n, nb = 512, 128
    with pt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx)
        A = TwoDimBlockCyclic(n, n, nb, nb)
        A.register(ctx, "A")
        generate_spd_on_device(dev, A, seed=3)
        tp = build_potrf(ctx, A, dev=dev)
        tp.run()
        tp.wait()
        assert any(e.dirty for e in list(dev._cache.values()))
        R = TwoDimBlockCyclic(n, n, nb // 2, nb // 2)
        R.register(ctx, "R")
        reshape_geometry(ctx, A, R)
        H = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float16)
        H.register(ctx, "H")
        tp = build_reshape_dtype(ctx, A, H, src_name="A", dst_name="H")
        tp.run()
        tp.wait()
        dev.flush()
        dense = A.to_dense()
        np.testing.assert_array_equal(R.to_dense(), dense)
        np.testing.assert_array_equal(H.to_dense(), dense.astype(np.float16))
        want = dense.astype(np.float64).reshape(n // nb, nb, n).sum(axis=0)
        tp = build_reduce_col(ctx, A, np.add)
        tp.run()
        tp.wait()
        got = A.to_dense()[:nb]
        dev.stop()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_two_devices_on_one_card_route_by_affinity(card):
    """Phase 9e's chain: with the default affinity skew every consumer
    follows its producer's mirror (no d2d bytes); with skew 0 the
    consumers tie onto the sibling, which stages device to device."""
    def chain(skew):
        with pt.Context(nb_workers=2) as ctx:
            if skew is not None:
                ctx.device_set_affinity_skew(skew)
            arr = np.ones((64 * 64,), dtype=np.float32)
            ctx.register_linear_collection("A", arr, elem_size=arr.nbytes)
            ctx.register_arena("t", arr.nbytes)
            d0, d1 = CudaDevice(ctx), CudaDevice(ctx)
            tp = pt.Taskpool(ctx, globals={"NB": 3})
            k = pt.L("k")
            prod = tp.task_class("P")
            prod.param("k", 0, 3)
            prod.flow("X", "RW", pt.In(pt.Mem("A", 0), guard=(k == 0)),
                      pt.In(pt.Ref("C", k - 1, flow="X")),
                      pt.Out(pt.Ref("C", k, flow="X")), arena="t")
            cons = tp.task_class("C")
            cons.param("k", 0, 3)
            cons.flow("X", "RW", pt.In(pt.Ref("P", k, flow="X")),
                      pt.Out(pt.Ref("P", k + 1, flow="X"), guard=(k < 3)),
                      pt.Out(pt.Mem("A", 0), guard=(k == 3)), arena="t")
            shp = {"X": (64, 64)}
            d0.attach(prod, tp, kernel=lambda x: x + 1.0, reads=["X"],
                      writes=["X"], shapes=shp)
            d1.attach(cons, tp, kernel=lambda x: x * 2.0, reads=["X"],
                      writes=["X"], shapes=shp)
            d0.attach(cons, tp, kernel=lambda x: x * 2.0, reads=["X"],
                      writes=["X"], shapes=shp)
            tp.run()
            tp.wait()
            for dv in (d0, d1):
                dv.flush()
            res = (d1.stats["tasks"],
                   d0.stats["d2d_bytes"] + d1.stats["d2d_bytes"])
            d0.stop()
            d1.stop()
        assert np.all(arr == 46.0)
        return res

    assert chain(None) == (0, 0)
    tasks, d2d = chain(0.0)
    assert tasks == 4 and d2d > 0


# ------------------------------------------ the profiling layer (phase 10)
def test_pins_and_h2d_stall_histogram_match_the_card_stats(card):
    """PINS DeviceActivity and the native h2d_stall histogram over a NORM
    pool on the card: waves equal the kernel's launches, lanes the tasks,
    the stall and the histogram's sum the device's h2d_stall_ns."""
    from parsec_tpu_torch import _native as N
    from parsec_tpu_torch.ops.rms_norm import build_rms_norm
    from parsec_tpu_torch.profiling import DeviceActivity, enable_pins
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2048, 256)).astype(np.float32)
    w = rng.standard_normal((1, 256)).astype(np.float32)
    with pt.Context(nb_workers=2) as ctx:
        act = DeviceActivity()
        enable_pins(ctx, act)
        X, W = to_collection(x, 256, 256), to_collection(w, 1, 256)
        O = to_collection(np.zeros_like(x), 256, 256)
        dev = CudaDevice(ctx, device=card)
        kernels.reset_launches()
        tp = build_rms_norm(ctx, X, W, O, 1e-6, dev=dev)
        tp.run(verify=True)
        tp.wait()
        dev.flush()
        dev.stop()
        st = dict(dev.stats)
        (h,) = [h for h in ctx.metrics_histograms()
                if h.kind == N.MET_H2D_STALL]
        launches = kernels.LAUNCHES["rms_norm"]
    assert act.waves == launches > 0 and act.lanes == st["tasks"] == 8
    assert act.stall_ns == st["h2d_stall_ns"] == h.sum_ns
    assert sum(act.h2d_bytes) == st["h2d_bytes"]


def test_plan_and_tuned_run_of_gemm_on_the_card(card, tmp_path):
    """GEMM on the card: verified, planned (its working set the tile
    set), and run under a tuned knob vector that its runtime was created
    under (the registry restored after)."""
    import torch
    from parsec_tpu_torch.analysis.tune import apply_knobs
    from parsec_tpu_torch.utils import params
    rng = np.random.default_rng(8)
    a = rng.standard_normal((512, 512)).astype(np.float32)
    b = rng.standard_normal((512, 512)).astype(np.float32)
    before = params.get("device.staging_slots")
    vec = {"device.staging_slots": before + 2}
    with apply_knobs(vec):
        ctx = pt.Context(nb_workers=2)
        dev = CudaDevice(ctx, device=card)
    assert params.get("device.staging_slots") == before
    with ctx:
        A, B = to_collection(a, 128, 128), to_collection(b, 128, 128)
        C = to_collection(np.zeros_like(a), 128, 128)
        for name, coll in (("A", A), ("B", B), ("C", C)):
            coll.register(ctx, name)
        tp = build_gemm(ctx, A, B, C, dev)
        plan = tp.plan()
        assert plan.est_bytes() == 3 * 512 * 512 * 4
        tp.run(verify=True, tuned=vec)
        assert tp.tuned_applied == vec
        assert dev._pf_slots_max == before + 2
        tp.wait()
        dev.flush()
        dev.stop()
        got = C.to_dense()
    want = (torch.from_numpy(a).to(card) @ torch.from_numpy(b).to(card))
    torch.testing.assert_close(torch.from_numpy(got).to(card), want,
                               rtol=1e-4, atol=1e-3)


def test_serving_conformance_covers_every_pool_on_the_card(card):
    """The engine with a CudaDevice and conformance on by default: every
    pool planned (coverage 1.0), tokens equal to the engine's own
    oracle."""
    from parsec_tpu_torch.serve import (InferenceEngine, PagedLM,
                                        PagedLMConfig, TenantConfig)
    model = PagedLM(PagedLMConfig(vocab=64, d=64, heads=4, page=8, seed=4),
                    device=card)
    with pt.Context(nb_workers=2, scheduler="lws") as ctx:
        dev = CudaDevice(ctx, device=card)
        eng = InferenceEngine(ctx, model, n_pages=64, max_seqs=4, dev=dev,
                              tenants=[TenantConfig("t")])
        hs = [eng.submit(list(range(1, 20 + 4 * i)), 3, "t")
              for i in range(3)]
        eng.run(timeout_s=120)
        conf = ctx.stats()["scope"]["conformance"]
        eng.close()
        dev.stop()
    assert all(h.state == "done" for h in hs)
    assert conf["pools"] > 0 and conf["coverage"] == 1.0
    assert dev.stats["tasks"] > 0


def _card_gemm(card, fused, depth=None):
    """GEMM 1024^2 in 128^2 tiles (an 8-deep k chain, 512 tasks) on a
    fresh device created under device.wave_fuse=`fused`, whole waves per
    pop: (C, the fuse counters, the residency pin, k_gemm_nn calls and
    their widths)."""
    from parsec_tpu_torch.utils import params
    rng = np.random.default_rng(21)
    a = rng.standard_normal((1024, 1024)).astype(np.float32)
    b = rng.standard_normal((1024, 1024)).astype(np.float32)
    with pt.Context(nb_workers=2) as ctx:
        A, B = to_collection(a, 128, 128), to_collection(b, 128, 128)
        C = to_collection(np.zeros_like(a), 128, 128)
        for name, coll in (("A", A), ("B", B), ("C", C)):
            coll.register(ctx, name)
        params.set("device.wave_fuse", fused)
        try:
            dev = CudaDevice(ctx, device=card)
        finally:
            params.unset("device.wave_fuse")
        dev.batch_wait_ms = 2.0
        tp = build_gemm(ctx, A, B, C, dev)
        body = dev.bodies[(id(tp), tp.classes[0].id)]
        widths, kern = [], body.kernel

        def k_gemm_nn(x, y, z):
            widths.append(int(x.shape[0]))
            return kern(x, y, z)
        body.kernel = k_gemm_nn
        tp.run()
        tp.wait()
        dev.flush()
        fs = dev.info()["fuse"]
        pinned = dev._chain_pinned
        dev.stop()
        out = C.to_dense()
    return out, fs, pinned, widths, a @ b


def test_gemm_chain_on_the_card_fused_against_unfused(card):
    """A small GEMM chain on the card: the fused run completes its
    chained waves from parked results (no miss), runs each chained
    level with the unfused dispatch's widths, and its C equals the
    unfused C bit for bit when the widths of both runs agree (the same
    cuBLAS calls); both within 1e-4 / 1e-3 of the host product."""
    c1, fs, _, w1, want = _card_gemm(card, True)
    c0, fs0, _, w0, _ = _card_gemm(card, False)
    assert fs["fused_chains"] > 0 and fs["chain_hits"] > 0
    assert fs["chain_misses"] == 0 and fs0["enabled"] is False
    assert sum(w1) == sum(w0) == 512
    if sorted(w1) == sorted(w0):
        assert c1.tobytes() == c0.tobytes()
    for c in (c1, c0):
        np.testing.assert_allclose(c, want, rtol=1e-4, atol=1e-3)


def test_gemm_chain_on_the_card_drains_its_parked_results(card):
    """Every parked chain result is consumed, missed or dropped by the
    end of the pool, and the residency pin goes with it."""
    _, fs, pinned, _, _ = _card_gemm(card, True)
    assert fs["chain_parked"] > 0
    assert fs["chain_parked"] == fs["chain_hits"] + fs["chain_misses"] \
        + fs["chain_drops"] + fs["parked"]
    assert fs["parked"] == 0 and pinned == 0


def test_plan_check_error_mode_on_the_card(card, monkeypatch):
    """device.plan_check=error with out-of-core off: Taskpool.run raises
    PlanCheckError before the pool is committed or a task reaches the
    card."""
    from parsec_tpu_torch.analysis import PlanCheckError
    monkeypatch.setenv("PTC_MCA_device_out_of_core", "0")
    monkeypatch.setenv("PTC_MCA_device_plan_check", "error")
    a = np.ones((512, 512), np.float32)
    with pt.Context(nb_workers=2) as ctx:
        A, B = to_collection(a, 128, 128), to_collection(a, 128, 128)
        C = to_collection(np.zeros_like(a), 128, 128)
        for name, coll in (("A", A), ("B", B), ("C", C)):
            coll.register(ctx, name)
        dev = CudaDevice(ctx, device=card, cache_bytes=3 * a.nbytes // 2)
        tp = build_gemm(ctx, A, B, C, dev)
        with pytest.raises(PlanCheckError):
            tp.run()
        assert not tp._committed and dev.stats["tasks"] == 0
        assert ctx.stats()["plan"]["over_budget"] == 1
        dev.stop()


def test_device_transfer_on_the_card_is_a_clone(card):
    """comm/ici.py device_transfer on one card: a copy ordered after the
    source's event, never an alias (a later write of the source does not
    reach it)."""
    import torch
    from parsec_tpu_torch.comm.ici import device_transfer
    x = _t(card, (1024, 512), 5)
    ev = torch.cuda.Event()
    ev.record()
    y = device_transfer(x, card, event=ev)
    torch.cuda.synchronize()
    assert y.data_ptr() != x.data_ptr()
    want = x.clone()
    x.add_(1.0)
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_colocated_norm_chain_on_the_card(card):
    """Two colocated Contexts on the card (chip_smoke.py's 12c at a small
    size): NORM's intermediate crosses as by-reference tokens and on-card
    clones, the RMSNorm kernel runs on both sides, and O holds against
    the plain version applied twice."""
    import importlib
    import sys
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cs = importlib.import_module("chip_smoke")
    kernels.reset_launches()
    out = cs.comm_colocated(card, {"norm": (8 * 128, 512, 128),
                                   "timeout": 120.0}, free_port_base(4))
    r0, r1 = out
    # each rank's device launched the kernel, and nothing else did
    assert r0["chore_calls"] > 0 and r1["chore_calls"] > 0
    assert kernels.LAUNCHES["rms_norm"] == \
        r0["chore_calls"] + r1["chore_calls"]
    assert r0["dev"]["dp_sends"] == 8 and r0["dev"]["d2h_bytes"] == 0
    assert r1["dev"]["dp_d2d_bytes"] == 8 * 128 * 512 * 4
    assert r1["dev"]["dp_recv_bytes"] == 0
    assert r0["dev"]["dp_errors"] == r1["dev"]["dp_errors"] == 0
    assert r1["max_abs_err"] <= 2e-5


def _chip_smoke():
    import importlib
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return importlib.import_module("chip_smoke")


# chip_smoke.py phase 13 at a small size (a head dim and widths the card
# path uses, few shards and tokens)
_MULTI = {"ring": (4, 256, 128), "ring2": (4, 256),
          "moe": (2, 64, 256, 512, 4, 2), "moe_cap": 20, "moe2": (2, 32),
          "serve_prompts": (40, 72), "serve_new": 4, "serve_pages": 64,
          "serve_model": {"vocab": 512, "d": 256, "heads": 4, "page": 16},
          "threads": 4, "cache_bytes": 1 << 30, "timeout": 120.0}


def test_ring_attention_chores_on_the_card(card):
    """Ring attention with every ATT and FIN a device chore on the card
    (13a at a small size): O against float64 attention at 2e-4 / 2e-5,
    S*S + S device tasks."""
    import parsec_tpu_torch as pt
    cs = _chip_smoke()
    with pt.Context(nb_workers=2) as ctx:
        r = cs.ring_run(ctx, card, _MULTI, 1, 0, "ring")
    assert r["tasks"] == 4 * 4 + 4
    assert r["max_abs_err"] <= 2e-4


def test_moe_exp_chore_on_the_card(card):
    """MoE with EXP on the card (13c at a small size): Y against the
    float64 oracle at 3e-4, every EXP task a device task."""
    cs = _chip_smoke()
    S, T, d, f, E, k = _MULTI["moe"]
    experts = cs.moe_experts(range(E), d, f, 2)
    x, wg = cs.moe_tokens(S, T, d, E)
    want = cs.moe_oracle64(x, wg, k, T, range(S), experts, card)
    r, _ = cs.moe_run(card, _MULTI, 1, 0, None, "moe", S, T, x, wg, experts,
                      check=cs.moe_check("moe", card, want))
    assert r["tasks"] == S * E and r["max_abs_err"] <= 3e-4


def test_tp_serving_on_the_card_matches_tp1(card):
    """Two colocated tp ranks on the card (13e at a small size): tokens
    and pre-logits bit for bit a tp=1 engine's, plain and speculative,
    conformance 1.0, a nonzero coll_wait in the request timelines."""
    cs = _chip_smoke()
    out = cs.tp_serve(card, _MULTI)
    for rnd in ("plain", "spec"):
        assert out[rnd]["tokens_equal_tp1"]
        assert not any(out[rnd]["prelogit_elems_differing"])
    assert out["coverage"] == [1.0, 1.0]


def test_ring_attention_two_colocated_ranks_on_the_card(card):
    """13b's program on two colocated Contexts (threads) on the card: the
    K/V blocks cross as by-reference tokens cloned on the consumer's
    device, after the producer's event.  A pass-through output is
    cloned before that event is recorded: the consumer never reads a
    clone still being written."""
    import threading

    import parsec_tpu_torch as pt
    cs = _chip_smoke()
    port, out = free_port_base(4), {}

    def rank(r):
        try:
            ctx = pt.Context(nb_workers=2)
            ctx.set_rank(r, 2)
            ctx.comm_init(port)
            ctx.comm_set_colocated([1 - r])
            out[r] = cs.ring_run(ctx, card, _MULTI, 2, r, f"ring r{r}")
            ctx.comm_fini()
            ctx.destroy()
        except Exception as e:
            out[r] = e

    ths = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=120)
    for r in range(2):
        assert isinstance(out.get(r), dict), out.get(r)
        assert out[r]["max_abs_err"] <= 2e-4


def test_transfer_plane_moves_a_tile_between_two_processes(card):
    """Two spawned processes on the card, device.dp_transfer on: rank 0's
    device-produced tile reaches rank 1's chore as a CUDA IPC token pulled
    card to card, bit for bit, with no byte on the host path and one
    session established."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_comm_workers as W
    elems = 1 << 18
    res = W.spmd(W.xfer_tile, 2, timeout=120, elems=elems)
    want = np.arange(elems, dtype=np.float32) * 3.0 + 1.0
    np.testing.assert_array_equal(res[1]["A1"], want)
    assert res[1]["dev"]["dp_xfer_bytes"] == elems * 4
    assert res[1]["pool"]["established"] == 1


def test_k_gemm_nn_lane_bits_independent_of_width_on_the_card(card):
    """Lane 0 of k_gemm_nn at 512^2 is bit for bit the same at widths 1,
    2 and 64 (a lone lane is a two-lane product: cuBLAS's one-lane
    batched product takes another algorithm)."""
    import torch

    from parsec_tpu_torch.algos.gemm import k_gemm_nn
    ops = [_t(card, (512, 512), s) for s in (1, 2, 3)]
    lane0 = {w: k_gemm_nn(*[o.unsqueeze(0).expand(w, 512, 512).contiguous()
                            for o in ops])[0].clone() for w in (1, 2, 64)}
    assert torch.equal(lane0[1], lane0[2])
    assert torch.equal(lane0[1], lane0[64])


def test_two_replica_fleet_on_the_card_matches_one_replica(card):
    """14a at a small width: routed, disaggregated and re-placed fleets of
    two replicas on the card give tokens and outputs bit for bit a
    single replica's, each request's predicted warm pages are what its
    admission mapped, and no queued request is dropped."""
    from parsec_tpu_torch.serve import PagedLM, PagedLMConfig
    cs = _chip_smoke()
    dims = dict(cs.FLEET, model={"vocab": 512, "d": 256, "heads": 4,
                                 "page": 16}, prefix=64, tight_pages=5,
                n_pages=96, timeout=120.0)
    model = PagedLM(PagedLMConfig(seed=0, **dims["model"]), device=card)
    out = cs.fleet_serve(card, model, dims)
    assert set(out["rounds"]) == {"single", "routed", "disagg", "replace"}
    assert all(p == m for p, m, _ in out["rounds"]["routed"]["warm"])
    assert out["rounds"]["disagg"]["counters"]["migrated_pages"] > 0


def test_transformer_step_with_both_kernels_matches_plain(card):
    """A small transformer's loss and gradients with use_flash and
    use_pallas_norm (both kernels forward, their plain backward) against
    the plain path on the same card: loss 1e-5 relative, every gradient
    within 1e-4 of its max-abs (f32 with TF32 off; the flash kernel's
    3xTF32 products); one flash launch a layer, two RMSNorm launches a
    layer and one for ln_f."""
    import dataclasses

    import torch
    from parsec_tpu_torch.models import transformer as T
    cfg = T.TransformerConfig(vocab=256, d_model=256, n_heads=4,
                              head_dim=64, n_layers=2, d_ff=512,
                              use_flash=True, use_pallas_norm=True)
    gen = torch.Generator(device=card).manual_seed(0)
    model = T.init_params(cfg, gen, device=card)
    toks = torch.randint(0, 256, (2, 257), generator=gen, device=card)
    batch = (toks[:, :-1], toks[:, 1:])
    kernels.reset_launches()
    loss, grads = T.value_and_grad(model, batch, cfg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"rms_norm": 5, "flash_attention": 2}
    plain = dataclasses.replace(cfg, use_flash=False, use_pallas_norm=False)
    want_loss, want = T.value_and_grad(model, batch, plain)
    want = dict(T.tree_items(want))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    for path, g in T.tree_items(grads):
        w = want[path]
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), \
            path


def test_flash_causal_gradient_through_autograd(card):
    """The causal flash kernel inside autograd (_Flash: the kernel
    forward, the reference's recompute backward) against autograd through
    the plain attention: output at phase 2's 2e-5, gradients at 1e-4."""
    import torch
    from parsec_tpu_torch.ops.flash_attention import _Flash
    q, k, v = (_t(card, (4, 256, 64), s).requires_grad_()
               for s in (21, 22, 23))
    o = _Flash.apply(q, k, v, True, 0.125)
    g = _t(card, (4, 256, 64), 24)
    got = torch.autograd.grad(o, (q, k, v), g)
    ref = attention_reference(q, k, v, True, 0.125)
    want = torch.autograd.grad(ref, (q, k, v), g)
    torch.testing.assert_close(o, ref, rtol=2e-5, atol=2e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ------------------------------------------- the card tools (slice 14)
def _tool_lines(main, argv, capsys):
    import json
    rc = main(argv)
    return rc, [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("{")]


def test_probe_la_kernels_on_the_card(card, capsys):
    import torch

    from parsec_tpu_torch.tools import probe_la_kernels
    rc, rows = _tool_lines(probe_la_kernels.main,
                           ["--nb", "128", "--batch", "4"], capsys)
    assert rc == 0
    assert [r["kernel"] for r in rows] == ["launch", "chol", "trsm", "trsm",
                                           "trsm_inv", "syrk", "gemm"]
    assert all(r["chip"] == torch.cuda.get_device_name(card) and r["ms"] > 0
               for r in rows)


def test_probe_launch_overhead_on_the_card(card, capsys):
    from parsec_tpu_torch.tools import probe_launch_overhead
    rc, (row,) = _tool_lines(probe_launch_overhead.main, ["--big", "512"],
                             capsys)
    assert rc == 0 and row["metric"] == "launch_overhead"
    assert row["dep_us_per_call"] > 0 and row["indep_us_per_call"] > 0


def test_bench_dtd_gemm_on_the_card(card, capsys):
    """512 / 128: 64 device tasks, C within 1e-4 / 1e-3 of torch.matmul
    (the tool exits 1 otherwise)."""
    from parsec_tpu_torch.tools import bench_dtd_gemm
    rc, (row,) = _tool_lines(bench_dtd_gemm.main,
                             ["--n", "512", "--nb", "128"], capsys)
    assert rc == 0 and row["config"]["tasks"] == 64 and row["gflops"] > 0


def test_bench_dataplane_transfer_rung_on_the_card(card, capsys):
    """4 MiB over two spawned ranks on this card: the transfer rung's
    payload moves over the CUDA IPC plane, with no dp_error."""
    from parsec_tpu_torch.tools import bench_dataplane
    rc, rows = _tool_lines(bench_dataplane.main, ["--mb", "4", "--reps", "1"],
                           capsys)
    assert rc == 0, rows
    by = {r["path"]: r for r in rows}
    assert by["bytes"]["path_taken"] == "bytes"
    assert by["transfer"]["path_taken"] == "transfer"
    assert by["transfer"]["dp_xfer_bytes"] == 4 << 20
    assert by["transfer"]["dp_errors"] == 0


def test_testbandwidth_device_fit_on_the_card(card, tmp_path, capsys):
    from parsec_tpu_torch.comm.economics import TransferEconomics
    from parsec_tpu_torch.tools import testbandwidth
    out = str(tmp_path / "econ.json")
    # a 4 MiB size: below 64 KiB the fixed leg hides the per-byte leg
    assert testbandwidth.main(["--quick", "--paths", "device", "--sizes",
                               "4096,65536,4194304", "--json", out]) == 0
    econ = TransferEconomics.load(out)
    assert econ.alpha("device") > 0 and econ.beta("device") > 0


def _bench_line(argv):
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "parsec_tpu_torch.bench",
                        *argv], cwd=root, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def test_bench_spotrf_child_on_the_card(card):
    """--spotrf-child at N 4096, NB 512 on the card: the residual gate
    held, vs_baseline against torch.linalg.cholesky in the same
    process, the card's name and power limit in the line."""
    import torch
    line = _bench_line(["--spotrf-child", "--n", "4096", "--nb", "512"])
    assert line["config"] == {"N": 4096, "NB": 512, "variant": "panel"}
    assert line["value"] > 0 and 0 <= line["residual"] <= 1e-2
    assert line["baseline"]["name"] == "torch.linalg.cholesky"
    assert line["baseline"]["gflops"] > 0
    assert line["chip_kind"] == torch.cuda.get_device_name(card)
    assert line["power_limit_w"] and line["power_limit_w"] > 0


def test_bench_ring_on_the_card(card):
    import torch
    line = _bench_line(["--ring", "--s", "2", "--t", "1024"])
    assert line["config"] == {"S": 2, "T": 1024, "d": 128, "seq": 2048}
    assert line["max_abs_err"] <= 5e-2
    assert line["chip_kind"] == torch.cuda.get_device_name(card)
    assert line["runtime_ms"] > 0 and line["gspmd_ms"] > 0


def test_soak_device_jobs_on_the_card(card):
    """The concurrency soak's two device jobs with a CudaDevice on the
    card, each with its own checks: wave_fuse_gemm's C tiles within
    2e-3 of float64; tp_decode_churn's tokens and pre-logits bit for bit
    the single-rank reference on both ranks, fused_waves > 0 and
    coll_pools > 0; dp_errors 0 on every rank of both."""
    from parsec_tpu_torch.tools import stress_tsan as S
    calls = {n: (kw, env) for n, kw, env in S.CALLS if n in S.DEVICE_JOBS}
    tiles = S.run_call("wave_fuse_gemm", *calls["wave_fuse_gemm"],
                       device=card)
    assert len(tiles) == 16
    tokens = S.run_call("tp_decode_churn", *calls["tp_decode_churn"],
                        device=card)
    assert tokens[0] == tokens[1] and len(tokens[0]) == 3
