"""The port's serving path held against parsec_tpu on the CPU, at the
reference tests' sizes: the host fold math, the KV PagePool, the torch
fold chore, the paged-attention builders, and the continuous-batching
engine (with and without a device attached).  Both frameworks run in one
process on the same seeded inputs; weights cross as numpy arrays
(parsec_tpu_torch.convert.paged_lm_params).  Tolerances: host math and
builders bit-identical; the torch fold 1e-5 / 1e-6 against both the
reference's jnp fold and the numpy fold; device engines 1e-4 / 1e-5."""
import threading

import numpy as np
import pytest
import torch

import jax
import parsec_tpu as jpt
import parsec_tpu_torch as tpt
from parsec_tpu.data.collections import TwoDimBlockCyclic as JaxBlockCyclic
from parsec_tpu.device import TpuDevice
from parsec_tpu.ops import paged_attention as jpa
from parsec_tpu.serve import InferenceEngine as JaxEngine
from parsec_tpu.serve import PagedLM as JaxLM
from parsec_tpu.serve import PagedLMConfig as JaxCfg
from parsec_tpu.serve import TenantConfig as JaxTenant
from parsec_tpu_torch.convert import paged_lm_params
from parsec_tpu_torch.data.collections import TwoDimBlockCyclic
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.ops import paged_attention as tpa
from parsec_tpu_torch.serve import (InferenceEngine, PagedLM, PagedLMConfig,
                                    Server, TenantConfig)

CFG = PagedLMConfig(vocab=32, d=8, page=4, seed=2)
JCFG = JaxCfg(vocab=32, d=8, page=4, seed=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs its files in parallel
    worker processes, and an intra-op pool per worker would oversubscribe
    the host under the timing-sensitive tests of the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(cfg=CFG):
    return PagedLM(cfg, device="cpu")


def _reqs(n, seed=0, lo=2, hi=9, new=(2, 6)):
    rng = np.random.RandomState(seed)
    return [(list(rng.randint(0, CFG.vocab, size=rng.randint(lo, hi))),
             int(rng.randint(*new)),
             "hi" if i % 3 == 0 else "lo") for i in range(n)]


# ----------------------------------------------------------- host math
@pytest.mark.parametrize("page", [4, 16])
def test_prefix_page_keys_match_reference(page):
    rng = np.random.RandomState(7)
    for n in (3, 16, 37, 64):
        toks = [int(t) for t in rng.randint(0, 32000, size=n)]
        assert tpa.prefix_page_keys("m", toks, page) == \
            jpa.prefix_page_keys("m", toks, page)


@pytest.mark.parametrize("nh,rows", [(1, None), (4, None), (4, 3)])
def test_host_fold_math_bit_identical(nh, rows):
    rng = np.random.RandomState(nh)
    d, P = 16, 4
    q = rng.randn(d).astype(np.float32)
    at0 = np.zeros((1, d + 2 * nh), np.float32)
    tpa.reset_acc(at0, nh)
    ja, ta = at0.copy(), at0.copy()
    jpa.reset_acc(ja, nh)
    assert np.array_equal(ja, ta)
    for _ in range(3):
        K = rng.randn(P, d).astype(np.float32)
        V = rng.randn(P, d).astype(np.float32)
        jpa.attend_heads(q, K, V, ja, 0.25, nh, rows=rows)
        tpa.attend_heads(q, K, V, ta, 0.25, nh, rows=rows)
        assert np.array_equal(ja, ta)
    assert np.array_equal(jpa.finalize_heads(ja, nh),
                          tpa.finalize_heads(ta, nh))
    acc = np.zeros(d, np.float32)
    got = tpa.attend_page(q, K, V, acc, -1e30, 0.0, 0.25)
    want = jpa.attend_page(q, K, V, acc, -1e30, 0.0, 0.25)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert np.array_equal(tpa.finalize_attention(got[0], got[2]),
                          jpa.finalize_attention(want[0], want[2]))


# ----------------------------------------------------------- page pool
def _pool_ops(pool, np_mod):
    """One operation sequence: reserve, freeze, acquire_prefix (warm and
    partial), make_private (COW and sole owner), release, eviction of a
    cached frozen page, export/import.  Returns the observable trace."""
    obs = []

    def snap():
        obs.append((pool.free_pages,
                    [pool.refcount(p) for p in range(pool.n_pages)],
                    {k: v for k, v in pool.stats().items()}))

    pages, warm = pool.acquire_prefix(["a", "b"], 3)
    pool.k_tile(pages[0])[...] = 1.5
    snap()
    pool.freeze(pages[0], "a", owner="t0")
    pool.freeze(pages[1], "b", owner="t1")
    p2, w2 = pool.acquire_prefix(["a", "b"], 3)
    obs.append((pages, warm, p2, w2))
    snap()
    p3, w3 = pool.acquire_prefix(["a", "x"], 2)
    obs.append((p3, w3))
    q = pool.make_private(pages[0])       # shared: COW clone
    obs.append((q, np_mod.array(pool.k_tile(q)).sum()))
    snap()
    pool.release(p2)
    pool.release(p3)
    r = pool.make_private(pages[1])       # sole owner: index dropped
    obs.append((r, pool.is_frozen(pages[1])))
    pool.release([q, r, pages[2]])
    snap()
    obs.append(pool.reserve(pool.n_pages + 1))  # all or nothing
    got = pool.reserve(pool.free_pages)  # evicts the cached frozen pages
    obs.append(got)
    snap()
    pool.release(got)
    obs.append(pool.import_frozen("k9", np.full((pool.page, pool.d), 2.0),
                                  np.full((pool.page, pool.d), 3.0)))
    obs.append(pool.import_frozen("k9", np.zeros((pool.page, pool.d)),
                                  np.zeros((pool.page, pool.d))))
    kv = pool.export_frozen("k9")
    obs.append((float(kv[0].sum()), float(kv[1].sum())))
    obs.append(sorted(pool.frozen_keys()))
    snap()
    return obs


def test_page_pool_operation_sequence_matches_reference():
    with jpt.Context(nb_workers=1) as jctx:
        jobs = _pool_ops(jpa.PagePool(jctx, 6, 4, 8, name="KV"), np)
    with tpt.Context(nb_workers=1) as tctx:
        tobs = _pool_ops(tpa.PagePool(tctx, 6, 4, 8, name="KV"), np)
    # every stats key compares, the controller's share-aware eviction
    # counters ("shares", "share_evictions") included
    assert len(jobs) == len(tobs)
    for j, t in zip(jobs, tobs):
        assert j == t


# ----------------------------------------------------------- fold chore
def _lanes(nh, d, P, n, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 1, d).astype(np.float32)
    K = rng.randn(n, P, d).astype(np.float32)
    V = rng.randn(n, P, d).astype(np.float32)
    A = np.zeros((n, 1, d + 2 * nh), np.float32)
    for i in range(n):
        tpa.reset_acc(A[i], nh)
        # a warm accumulator: one host fold already in
        tpa.attend_heads(q[i, 0], rng.randn(P, d).astype(np.float32),
                         rng.randn(P, d).astype(np.float32), A[i],
                         (d // nh) ** -0.5, nh)
    return q, K, V, A


@pytest.mark.parametrize("nh,d,P", [(1, 8, 4), (4, 32, 8)])
def test_fold_on_lanes_matches_reference_and_host(nh, d, P):
    """The port's torch fold on 3-lane stacks against the reference's
    jnp fold (run by JAX on the CPU, vmapped as TpuDevice runs it) and
    the numpy host fold: 1e-5 / 1e-6."""
    sc = (d // nh) ** -0.5
    q, K, V, A = _lanes(nh, d, P, 3, 11)
    got = tpa.fold_heads(*(torch.from_numpy(a) for a in (q, K, V, A)),
                         sc, nh).numpy()
    if nh == 1:
        kern = lambda qb, kb, vb, ab: jpa._fold_kernel(qb, kb, vb, ab, sc)
    else:
        kern = lambda qb, kb, vb, ab: jpa._fold_kernel_heads(
            qb, kb, vb, ab, sc, nh)
    ref = np.asarray(jax.vmap(kern)(q, K, V, A))
    host = A.copy()
    for i in range(3):
        tpa.attend_heads(q[i, 0], K[i], V[i], host[i], sc, nh)
    assert got.shape == (3, 1, d + 2 * nh)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, host, rtol=1e-5, atol=1e-6)


def test_fold_reads_shared_lanes_at_stride_zero():
    """A flow every lane reads the same way arrives at lane stride 0."""
    nh, d, P = 2, 16, 4
    q, K, V, A = _lanes(nh, d, P, 3, 12)
    Kt = torch.from_numpy(K[:1]).expand(3, P, d)
    Vt = torch.from_numpy(V[:1]).expand(3, P, d)
    got = tpa.fold_heads(torch.from_numpy(q), Kt, Vt, torch.from_numpy(A),
                         0.25, nh).numpy()
    for i in range(3):
        host = A[i].copy()
        tpa.attend_heads(q[i, 0], K[0], V[0], host, 0.25, nh)
        np.testing.assert_allclose(got[i], host, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- builders
D, P = 8, 4


def _decode_scenario(pkg, mod, Coll, nh):
    """3 sequences with 1/2/3 pages decode in ONE pool (the reference's
    test_decode_ragged_multi_seq_bit_identical); returns the O rows."""
    rng = np.random.RandomState(0)
    with pkg.Context(nb_workers=2, scheduler="lws") as ctx:
        pool = mod.PagePool(ctx, 10, P, D, name="KV")
        Qc, ACCc, Oc, KNc, names = mod.make_slot_collections(
            ctx, 4, D, name="PA", nh=nh)
        seqs = []
        for i in range(3):
            pages = [pool.alloc() for _ in range(i + 1)]
            fill = i
            n_old = i * P + fill
            K = rng.randn(n_old + 1, D).astype(np.float32)
            V = rng.randn(n_old + 1, D).astype(np.float32)
            for j, pg in enumerate(pages):
                upto = P if j < len(pages) - 1 else fill
                pool.k_tile(pg)[:upto] = K[j * P:j * P + upto]
                pool.v_tile(pg)[:upto] = V[j * P:j * P + upto]
            Qc.tile(i, 0)[0] = rng.randn(D).astype(np.float32)
            KNc.tile(i, 0)[0, :D] = K[n_old]
            KNc.tile(i, 0)[0, D:] = V[n_old]
            mod.reset_acc(ACCc.tile(i, 0), nh)
            seqs.append(mod.SeqSpec(i, pages, fill))
        tp = mod.build_paged_decode(ctx, pool, seqs, names, nh=nh)
        tp.run()
        tp.wait()
        # O rows, then each last page (PUPD persisted the new row)
        return np.concatenate([Oc.tile(i, 0)[0] for i in range(3)] +
                              [pool.k_tile(s.pages[-1]).ravel()
                               for s in seqs])


def _prefill_scenario(pkg, mod, Coll, nh):
    """Two prompts with partial last pages (the reference's
    test_prefill_bit_identical_and_partial_page), the second one with a
    warm first page."""
    rng = np.random.RandomState(1)
    with pkg.Context(nb_workers=2, scheduler="lws") as ctx:
        pool = mod.PagePool(ctx, 8, P, D, name="KV")
        Qc, ACCc, Oc, KNc, names = mod.make_slot_collections(
            ctx, 2, D, name="PA", nh=nh)
        PRc = Coll(6 * P, 2 * D, P, 2 * D, dtype=np.float32)
        PRc.register(ctx, "PR")
        specs, ptiles, tile_i = [], [], 0
        for i, T in enumerate((6, 7)):
            n_pages = (T + P - 1) // P
            pages = [pool.alloc() for _ in range(n_pages)]
            K = rng.randn(T, D).astype(np.float32)
            V = rng.randn(T, D).astype(np.float32)
            tiles = []
            for j in range(n_pages):
                t = PRc.tile(tile_i, 0)
                rows = K[j * P:(j + 1) * P]
                t[:len(rows), :D] = rows
                t[:len(rows), D:] = V[j * P:(j + 1) * P]
                tiles.append(tile_i)
                tile_i += 1
            if i == 1:  # warm first page: already in the KV collections
                pool.k_tile(pages[0])[...] = K[:P]
                pool.v_tile(pages[0])[...] = V[:P]
            Qc.tile(i, 0)[0] = rng.randn(D).astype(np.float32)
            mod.reset_acc(ACCc.tile(i, 0), nh)
            specs.append(mod.SeqSpec(i, pages, T - (n_pages - 1) * P))
            ptiles.append(tiles)
        tp = mod.build_paged_prefill(ctx, pool, specs, names, "PR", ptiles,
                                     warm=[0, 1], nh=nh)
        tp.run()
        tp.wait()
        return np.stack([Oc.tile(i, 0)[0].copy() for i in range(2)])


def _verify_scenario(pkg, mod, Coll, nh):
    """The reference's test_verify_builder_clean_and_bit_exact wave."""
    rng = np.random.RandomState(5)
    with pkg.Context(nb_workers=2, scheduler="lws") as ctx:
        pool = mod.PagePool(ctx, 10, P, D, name="KV")
        Qc, ACCc, Oc, _, names = mod.make_slot_collections(
            ctx, 4, D, name="PV", nh=nh)
        seqs = []
        for i, (npg, fill) in enumerate(((3, 2), (1, 4), (2, 1))):
            pages = pool.reserve(npg)
            rows = (npg - 1) * P + fill
            K = rng.randn(rows, D).astype(np.float32)
            V = rng.randn(rows, D).astype(np.float32)
            for j, pg in enumerate(pages):
                upto = min(P, rows - j * P)
                pool.k_tile(pg)[:upto] = K[j * P:j * P + upto]
                pool.v_tile(pg)[:upto] = V[j * P:j * P + upto]
            Qc.tile(i, 0)[0] = rng.randn(D).astype(np.float32)
            mod.reset_acc(ACCc.tile(i, 0), nh)
            seqs.append(mod.SeqSpec(i, pages, fill))
        tp = mod.build_paged_verify(ctx, pool, seqs, names, nh=nh)
        tp.run()
        tp.wait()
        return np.stack([Oc.tile(i, 0)[0].copy() for i in range(3)])


@pytest.mark.parametrize("scenario", [_decode_scenario, _prefill_scenario,
                                      _verify_scenario],
                         ids=["decode", "prefill", "verify"])
@pytest.mark.parametrize("nh", [1, 2])
def test_builders_bit_identical_to_reference(scenario, nh):
    got = scenario(tpt, tpa, TwoDimBlockCyclic, nh)
    want = scenario(jpt, jpa, JaxBlockCyclic, nh)
    assert np.array_equal(got, want)
    assert np.all(np.isfinite(got)) and np.any(got != 0)


# ----------------------------------------------------------- the model
def test_model_weights_cross_bit_for_bit():
    ref = JaxLM(JaxCfg(vocab=32, d=8, page=4, seed=2, heads=2))
    cfg = PagedLMConfig(vocab=32, d=8, page=4, seed=2, heads=2)
    seeded = PagedLM(cfg, device="cpu")
    carried = PagedLM.from_params(cfg, paged_lm_params(ref), device="cpu")
    for name, w in paged_lm_params(ref).items():
        assert np.array_equal(paged_lm_params(seeded)[name], w), name
        assert np.array_equal(paged_lm_params(carried)[name], w), name
    assert seeded.model_id == ref.model_id
    q, k, v = carried.qkv(5)
    rq, rk, rv = ref.qkv(5)
    for a, b in ((q, rq), (k, rk), (v, rv)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_model_and_device_default_to_the_card():
    """Without a card, the default device raises: nothing runs on the
    CPU unless the caller asks for it."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedLM(CFG)
    with tpt.Context(nb_workers=1) as ctx:
        with pytest.raises(RuntimeError, match="CUDA"):
            CudaDevice(ctx)


# ----------------------------------------------------------- the engine
def _run_port_engine(model, reqs, dev=False, **kw):
    with tpt.Context(nb_workers=2, scheduler="lws") as ctx:
        d = CudaDevice(ctx, device="cpu") if dev else None
        eng = InferenceEngine(
            ctx, model, dev=d,
            tenants=[TenantConfig("hi", priority=4, weight=4),
                     TenantConfig("lo")], **kw)
        hs = [eng.submit(p, n, t) for p, n, t in reqs]
        eng.run(timeout_s=120)
        stats = dict(eng.stats)
        ds = ctx.device_stats()
        eng.close()
        if d is not None:
            d.stop()
    return hs, stats, ds


def _run_ref_engine(model, reqs, dev=False, **kw):
    with jpt.Context(nb_workers=2, scheduler="lws") as ctx:
        d = TpuDevice(ctx) if dev else None
        try:
            eng = JaxEngine(
                ctx, model, dev=d,
                tenants=[JaxTenant("hi", priority=4, weight=4),
                         JaxTenant("lo")], **kw)
            hs = [eng.submit(p, n, t) for p, n, t in reqs]
            eng.run(timeout_s=150)
            eng.close()
        finally:
            if d is not None:
                d.stop()
    return hs


def test_engine_matches_reference_and_its_own_oracle():
    """8 mixed-tenant requests (the reference's test_engine scenario):
    the port is bit-identical to its own sequential reference_generate,
    its tokens equal the reference engine's and its outputs agree to
    1e-5 / 1e-6 (the projections are torch's products, not numpy's)."""
    ref_model = JaxLM(JCFG)
    model = PagedLM.from_params(CFG, paged_lm_params(ref_model), "cpu")
    reqs = _reqs(8)
    hs, st, _ = _run_port_engine(model, reqs, n_pages=24, max_seqs=6)
    rhs = _run_ref_engine(ref_model, reqs, n_pages=24, max_seqs=6)
    for h, rh, (p, n, _t) in zip(hs, rhs, reqs):
        assert h.state == rh.state == "done"
        toks, outs = model.reference_generate(p, n)
        assert h.tokens == toks
        assert np.array_equal(np.stack(h.outputs), outs)
        assert h.tokens == rh.tokens
        np.testing.assert_allclose(np.stack(h.outputs),
                                   np.stack(rh.outputs),
                                   rtol=1e-5, atol=1e-6)
    assert st["retired"] == 8 and st["decode_pools"] > 0


@pytest.mark.parametrize("heads", [1, 2])
def test_engine_on_device_matches_reference_device(heads):
    """The same scenario with the frozen-page folds on CudaDevice
    (device='cpu': the fold's torch form on the host) against the
    reference with TpuDevice on the JAX CPU backend: equal tokens,
    outputs within 1e-4 / 1e-5, and the device really folded."""
    jcfg = JaxCfg(vocab=32, d=8, page=4, seed=2, heads=heads)
    cfg = PagedLMConfig(vocab=32, d=8, page=4, seed=2, heads=heads)
    ref_model = JaxLM(jcfg)
    model = PagedLM.from_params(cfg, paged_lm_params(ref_model), "cpu")
    reqs = _reqs(8, lo=5, hi=14)
    hs, _, ds = _run_port_engine(model, reqs, dev=True, n_pages=32,
                                 max_seqs=6)
    rhs = _run_ref_engine(ref_model, reqs, dev=True, n_pages=32,
                          max_seqs=6)
    for h, rh in zip(hs, rhs):
        assert h.state == rh.state == "done"
        assert h.tokens == rh.tokens
        np.testing.assert_allclose(np.stack(h.outputs),
                                   np.stack(rh.outputs),
                                   rtol=1e-4, atol=1e-5)
    assert ds["tasks"] > 0 and ds["h2d_hits"] > 0


def test_stale_mirrors_without_host_wrote_miss_the_oracle(monkeypatch):
    """The engine rewrites Q/KN/ACC slot tiles on the host without a
    runtime write; Context.host_wrote is what drops their device
    mirrors.  With it disabled, reused slots fold last step's rows and
    the outputs leave the oracle — the hazard the port guards."""
    model = _model()
    monkeypatch.setattr(tpt.Context, "host_wrote", lambda *a, **k: None)
    reqs = _reqs(8, lo=5, hi=14)
    hs, _, _ = _run_port_engine(model, reqs, dev=True, n_pages=32,
                                max_seqs=6)
    ok = [np.allclose(np.stack(h.outputs),
                      model.reference_generate(p, n)[1],
                      rtol=1e-4, atol=1e-5)
          for h, (p, n, _t) in zip(hs, reqs)]
    assert not all(ok)


def test_failed_fold_fails_its_requests(monkeypatch):
    """No fallback: a fold that raises on the device fails its pool and
    the engine reports the request failed (pages and slots return)."""
    def broken(*a, **k):
        raise RuntimeError("fold refused")
    monkeypatch.setattr(tpa, "fold_heads", broken)
    model = _model()
    with tpt.Context(nb_workers=2, scheduler="lws") as ctx:
        dev = CudaDevice(ctx, device="cpu")
        eng = InferenceEngine(ctx, model, n_pages=16, max_seqs=2, dev=dev,
                              tenants=[TenantConfig("t")])
        free0 = eng.pool.free_pages
        h = eng.submit(list(range(1, 11)), 4, "t")
        eng.run(timeout_s=60)
        assert h.state == "failed"
        assert len(h.generated) == 1  # the prefill's token only
        assert eng.pool.free_pages == free0
        assert len(eng._free_slots) == 2
        assert ctx.stats()["scope"]["tenants"]["t"]["failed"] == 1
        eng.close()
        dev.stop()


# --------------------------------------- engine contracts (test_engine)
def test_pages_and_slots_recycle():
    model = _model()
    with tpt.Context(nb_workers=2, scheduler="lws") as ctx:
        eng = InferenceEngine(ctx, model, n_pages=12, max_seqs=3,
                              tenants=[TenantConfig("t")])
        free0 = eng.pool.free_pages
        handles = [eng.submit([1, 2, 3, 4, 5, 6], 3, "t")
                   for _ in range(7)]
        eng.run(timeout_s=120)
        assert all(h.state == "done" for h in handles)
        assert eng.pool.free_pages == free0
        assert len(eng._free_slots) == 3
        assert eng.stats["retired"] == 7
        assert eng.stats["decode_pools"] > 0
        # retired decode pools are destroyed: no lingering QoS rows
        assert ctx.stats()["sched"]["pools"] == []
        eng.close()


def test_admission_rejects_and_backpressure():
    model = _model()
    with tpt.Context(nb_workers=1, scheduler="lws") as ctx:
        eng = InferenceEngine(
            ctx, model, n_pages=8, max_seqs=2,
            tenants=[TenantConfig("x", max_pools=1, max_queue=2)])
        handles = [eng.submit([1, 2, 3], 3, "x") for _ in range(8)]
        eng.run(timeout_s=120)
        st = eng.server.stats()["tenants"]["x"]
        assert st["rejected"] == 5
        assert st["completed"] == 3
        done = [h for h in handles if h.state == "done"]
        rejected = [h for h in handles if h.state == "rejected"]
        assert len(done) == 3 and len(rejected) == 5
        rt, _ = model.reference_generate([1, 2, 3], 3)
        for h in done:
            assert h.tokens == rt
        eng.close()


def test_serve_namespace_in_unified_stats():
    model = _model()
    with tpt.Context(nb_workers=1, scheduler="lws") as ctx:
        eng = InferenceEngine(ctx, model, n_pages=8, max_seqs=2,
                              tenants=[TenantConfig("t", priority=2)])
        eng.submit([1, 2, 3], 2, "t")
        eng.run(timeout_s=60)
        s = ctx.stats()
        assert s["serve"]["enabled"] is True
        tot = s["serve"]["totals"]
        assert tot["admitted"] == 1 and tot["completed"] == 1
        assert "qos_selects" in s["sched"]
        assert isinstance(s["sched"]["pools"], list)
        sc = s["scope"]
        assert sc["enabled"] and sc["requests"] == 1
        assert sc["tenants"]["t"]["ttft_ns_count"] == 1
        assert sc["conformance"]["pools"] > 0
        eng.close()
        assert ctx.stats()["serve"] == {"enabled": False}


# ------------------------------------------ prefix cache (test_prefix_share)
def test_pool_atomic_reserve_all_or_nothing():
    with tpt.Context(nb_workers=1) as ctx:
        pool = tpa.PagePool(ctx, 4, 4, 8, name="KV")
        got = pool.reserve(3)
        assert got is not None and len(got) == 3
        assert pool.reserve(2) is None  # only 1 left: nothing taken
        assert pool.free_pages == 1
        assert pool.stats()["reserve_fails"] == 1
        pool.release(got)
        assert pool.free_pages == 4


def test_pool_shared_frozen_page_never_evicted_under_pressure():
    with tpt.Context(nb_workers=1) as ctx:
        pool = tpa.PagePool(ctx, 4, 4, 8, name="KV")
        held, _ = pool.acquire_prefix(["k0"], 1)
        pool.k_tile(held[0])[...] = 42.0
        pool.freeze(held[0], "k0")
        parked, _ = pool.acquire_prefix(["p0"], 1)
        pool.freeze(parked[0], "p0")
        pool.release(parked)  # refcount 0: parks on the cached LRU
        got = pool.reserve(3)
        assert got is not None
        assert held[0] not in got and parked[0] in got
        assert pool.stats()["evictions"] == 1
        assert np.all(pool.k_tile(held[0]) == 42.0)
        assert pool.probe(["p0"]) == 0 and pool.probe(["k0"]) == 1
        assert pool.reserve(1) is None  # truly dry, held page safe
        assert pool.refcount(held[0]) == 1
        pool.release(got)
        with pytest.raises(RuntimeError, match="over-released"):
            pool.release([got[0]])


def test_pool_stress_concurrent_churn():
    """Multi-threaded acquire/freeze/release/COW churn under eviction
    pressure: refcounts stay consistent and every page is recovered."""
    with tpt.Context(nb_workers=1) as ctx:
        pool = tpa.PagePool(ctx, 16, 4, 8, name="KV")
        errs = []

        def worker(seed):
            rng = np.random.RandomState(seed)
            try:
                for _ in range(120):
                    keys = [f"k{seed % 2}{j}" for j in
                            range(rng.randint(1, 4))]
                    got = pool.acquire_prefix(keys, len(keys) + 1)
                    if got is None:
                        continue
                    pages, warm = got
                    for j in range(warm, len(keys)):
                        pool.freeze(pages[j], keys[j])
                    if rng.randint(2):
                        q = pool.make_private(pages[-1])
                        if q is not None:
                            pages[-1] = q
                    pool.release(pages)
            except Exception as e:  # pragma: no cover
                errs.append(repr(e))

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        assert not errs, errs
        st = pool.stats()
        assert st["free"] + st["cached_free"] == pool.n_pages
        assert st["prefix_hits"] > 0


def test_two_tenant_shared_prefix_bit_identical_to_cold():
    model = _model()
    common = [5, 9, 2, 11, 7, 1, 8, 6]  # 2 full shared pages
    reqs = [(common + [3], 4, "hi"), (common + [12], 4, "lo"),
            (common, 3, "hi"), (common + [3, 4, 5], 3, "lo")]
    with tpt.Context(nb_workers=2, scheduler="lws") as ctx:
        eng = InferenceEngine(ctx, model, n_pages=48, max_seqs=8,
                              tenants=[TenantConfig("hi"),
                                       TenantConfig("lo")])
        warm = [eng.submit(*reqs[0])]
        eng.run(timeout_s=120)
        warm += [eng.submit(p, n, t) for p, n, t in reqs[1:]]
        eng.run(timeout_s=120)
        st = eng.pool.stats()
        scope_rows = ctx.stats()["scope"]["tenants"]
        serve_ns = ctx.stats()["serve"]
        eng.close()
    cold, _, _ = _run_port_engine(model, reqs, n_pages=48, max_seqs=8,
                                  prefix_cache=False)
    assert st["prefix_hits"] > 0, st
    for hw, hc, (p, n, _t) in zip(warm, cold, reqs):
        assert hw.state == hc.state == "done"
        rt, ro = model.reference_generate(p, n)
        assert hw.tokens == rt and hc.tokens == rt
        assert np.array_equal(np.stack(hw.outputs), ro)
        assert np.array_equal(np.stack(hc.outputs), ro)
    assert serve_ns["prefix"]["prefix_hits"] == st["prefix_hits"]
    assert serve_ns["prefix"]["hit_rate"] > 0
    assert sum(r.get("prefix_hits", 0) for r in scope_rows.values()) == \
        st["prefix_hits"]


def test_concurrent_prefix_sharers_keep_their_staged_prompt_pages():
    """Eight prefills in flight share a 60-page warm prefix, so together
    they pass many more prompt pages than the KV pool holds.  Each stages
    only its cold tail, and no other running prefill may stage over it.
    The only worker is held busy until all eight are admitted, so every
    prefill stages before any PFILL reads: a shared staging tile shows
    as outputs that leave reference_generate."""
    model = _model()
    P = CFG.page
    rng = np.random.RandomState(3)
    common = [int(t) for t in rng.randint(0, CFG.vocab, size=60 * P)]
    warmer = (common + [1] * (4 * P), 1, "lo")
    reqs = [(common + [int(t) for t in rng.randint(0, CFG.vocab,
                                                    size=3 * P + 1)],
             2, "hi" if i % 2 else "lo") for i in range(8)]
    started, release = threading.Event(), threading.Event()

    def hold(_t):
        started.set()
        release.wait(timeout=60)

    with tpt.Context(nb_workers=1, scheduler="lws") as ctx:
        eng = InferenceEngine(ctx, model, n_pages=128, max_seqs=8,
                              tenants=[TenantConfig("hi"),
                                       TenantConfig("lo")])
        eng.submit(*warmer)
        eng.run(timeout_s=120)
        blocker = tpt.Taskpool(ctx, globals={"NB": 0})
        blk = blocker.task_class("Hold")
        blk.param("k", 0, tpt.G("NB"))
        blk.body(hold)
        blocker.run()
        assert started.wait(timeout=60)
        hs = [eng.submit(p, n, t) for p, n, t in reqs]
        release.set()
        blocker.wait()
        eng.run(timeout_s=120)
        hits = eng.pool.stats()["prefix_hits"]
        eng.close()
    assert hits >= 8 * 60
    for h, (p, n, _t) in zip(hs, reqs):
        assert h.state == "done"
        toks, outs = model.reference_generate(p, n)
        assert h.tokens == toks
        assert np.array_equal(np.stack(h.outputs), outs)


def test_warm_rerun_prefills_fewer_pages():
    model = _model()
    prompt = [4, 4, 9, 1, 2, 3, 7, 7, 5]
    with tpt.Context(nb_workers=2, scheduler="lws") as ctx:
        eng = InferenceEngine(ctx, model, n_pages=32, max_seqs=4,
                              tenants=[TenantConfig("a"),
                                       TenantConfig("b")])
        h1 = eng.submit(prompt, 3, "a")
        eng.run(timeout_s=60)
        miss_cold = eng.pool.stats()["prefix_misses"]
        h2 = eng.submit(prompt, 3, "b")
        eng.run(timeout_s=60)
        st = eng.pool.stats()
        eng.close()
    assert h1.tokens == h2.tokens
    assert np.array_equal(np.stack(h1.outputs), np.stack(h2.outputs))
    assert st["prefix_hits"] == 2          # both full pages shared
    assert st["prefix_misses"] == miss_cold + 1  # only the cold tail


def test_admission_discount_for_predicted_shared_pages():
    model = _model()
    prompt = [5, 9, 2, 11, 7, 1, 8, 6]  # 2 pages, both freezable
    bpp = 2 * CFG.page * CFG.d * 4
    with tpt.Context(nb_workers=2, scheduler="lws") as ctx:
        eng = InferenceEngine(
            ctx, model, n_pages=32, max_seqs=4,
            tenants=[TenantConfig("t", max_pools=1, max_queue=4,
                                  max_queued_bytes=bpp)])
        h1 = eng.submit(prompt, 2, "t")
        eng.run(timeout_s=60)
        assert h1.state == "done"
        h2 = eng.submit(prompt, 2, "t")
        h3 = eng.submit(prompt, 2, "t")
        eng.run(timeout_s=60)
        st = eng.server.stats()["tenants"]["t"]
        eng.close()
    assert h2.state == "done" and h3.state == "done"
    assert st["rejected"] == 0
    assert st["discounted_bytes"] >= 2 * bpp - 2


# --------------------------------- speculative decoding (test_spec_decode)
@pytest.mark.parametrize("k", [1, 2, 3, "auto"])
def test_spec_oracle_draft_bit_identical_and_accepts(k):
    """spec_draft='self': every draft accepted, outputs bit-identical to
    the port's own oracle and to its non-speculative engine."""
    model = _model()
    reqs = _reqs(6, lo=2, hi=11, new=(3, 8))
    hs, st, _ = _run_port_engine(model, reqs, n_pages=96, max_seqs=8,
                                 spec_k=k)
    h0, _, _ = _run_port_engine(model, reqs, n_pages=96, max_seqs=8)
    for h, hseq, (p, n, _t) in zip(hs, h0, reqs):
        assert h.state == "done"
        rt, ro = model.reference_generate(p, n)
        assert h.tokens == rt == hseq.tokens
        assert np.array_equal(np.stack(h.outputs), ro)
        assert np.array_equal(np.stack(h.outputs), np.stack(hseq.outputs))
    assert st["spec_proposed"] > 0
    assert st["spec_accepted"] == st["spec_proposed"]
    assert st["spec_steps"] < sum(len(h.generated) for h in hs)


def test_spec_adversarial_draft_rolls_back_and_drains():
    """A draft with unrelated weights: acceptance below 1, every
    rejected window rolls back, the stream still equals the oracle, and
    every page and slot comes back."""
    model = _model()
    draft = PagedLM(PagedLMConfig(vocab=32, d=8, page=4, seed=909), "cpu")
    with tpt.Context(nb_workers=2, scheduler="lws") as ctx:
        eng = InferenceEngine(ctx, model, n_pages=32, max_seqs=4,
                              tenants=[TenantConfig("t")], spec_k=3,
                              spec_draft=draft)
        free0 = eng.pool.free_pages
        hs = [eng.submit([1, 2, 3, 4, 5, 6, 7], 5, "t") for _ in range(5)]
        eng.run(timeout_s=120)
        assert eng.pool.free_pages == free0
        assert len(eng._free_slots) == 4
        st = dict(eng.stats)
        eng.close()
    rt, ro = model.reference_generate([1, 2, 3, 4, 5, 6, 7], 5)
    for h in hs:
        assert h.state == "done" and h.tokens == rt
        assert np.array_equal(np.stack(h.outputs), ro)
    assert 0 < st["spec_proposed"] and st["spec_accepted"] < \
        st["spec_proposed"]


def test_spec_page_shortfall_falls_back_to_plain_decode():
    model = _model()
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    with tpt.Context(nb_workers=2, scheduler="lws") as ctx:
        eng = InferenceEngine(ctx, model, n_pages=8, max_seqs=2,
                              tenants=[TenantConfig("t")], spec_k=4)
        h = eng.submit(prompt, 6, "t")
        eng.run(timeout_s=120)
        st = dict(eng.stats)
        eng.close()
    rt, ro = model.reference_generate(prompt, 6)
    assert h.state == "done" and h.tokens == rt
    assert np.array_equal(np.stack(h.outputs), ro)
    assert st["spec_fallbacks"] > 0


def test_spec_with_prefix_cache_composes():
    model = _model()
    common = [5, 9, 2, 11, 7, 1, 8, 6]
    with tpt.Context(nb_workers=2, scheduler="lws") as ctx:
        eng = InferenceEngine(ctx, model, n_pages=64, max_seqs=8,
                              tenants=[TenantConfig("a"),
                                       TenantConfig("b")], spec_k=3)
        h1 = eng.submit(common + [3], 5, "a")
        eng.run(timeout_s=120)
        h2 = eng.submit(common + [9], 5, "b")
        h3 = eng.submit(common, 4, "b")
        eng.run(timeout_s=120)
        pool_st = eng.pool.stats()
        eng.close()
    assert pool_st["prefix_hits"] > 0
    for h, (p, n) in ((h1, (common + [3], 5)), (h2, (common + [9], 5)),
                      (h3, (common, 4))):
        rt, ro = model.reference_generate(p, n)
        assert h.tokens == rt
        assert np.array_equal(np.stack(h.outputs), ro)


def test_spec_verify_wave_batches_on_device():
    """With a device attached the VATF verify wave runs as batched
    launches over its lanes; tokens equal the non-speculative device
    run's and outputs agree to 1e-5 / 1e-6."""
    model = _model()
    prompts = [[5, 9, 2, 11, 7, 1, 8, 6, 3], [4, 4, 9, 1, 2, 3, 7, 7],
               [1, 2, 8, 5, 5]]
    reqs = [(p, 6, "hi") for p in prompts]
    hs1, _, ds1 = _run_port_engine(model, reqs, dev=True, n_pages=64,
                                   max_seqs=8, spec_k=3)
    hs0, _, _ = _run_port_engine(model, reqs, dev=True, n_pages=64,
                                 max_seqs=8)
    assert ds1["batches"] > 0 and ds1["batched_tasks"] > ds1["batches"]
    for h1, h0 in zip(hs1, hs0):
        assert h1.state == h0.state == "done"
        assert h1.tokens == h0.tokens
        np.testing.assert_allclose(np.stack(h1.outputs),
                                   np.stack(h0.outputs),
                                   rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- not ported
def test_unported_paths_raise():
    """What is not ported yet raises: the collectives' mesh path and the
    local path without a live multi-rank ctx (tensor-parallel serving
    and sharded pages are ported, tests/test_torch_tp_shard.py).
    Conformance (the default now), the plan and the plan bound of an
    unknown byte estimate are ported, and run on both packages in
    tests/test_torch_profiling.py."""
    from parsec_tpu_torch import parallel as pp
    model = _model()
    x = np.ones(8, np.float32)
    with tpt.Context(nb_workers=1) as ctx:
        for call in (lambda **kw: pp.all_reduce(x, **kw),
                     lambda **kw: pp.reduce_scatter(x, **kw),
                     lambda **kw: pp.all_gather(x, **kw),
                     lambda **kw: pp.broadcast(x, **kw)):
            with pytest.raises(NotImplementedError, match="mesh"):
                call(ctx=ctx, mesh=object())
            with pytest.raises(NotImplementedError, match="multi-rank"):
                call(ctx=ctx)
            with pytest.raises(NotImplementedError, match="multi-rank"):
                call()
        with pytest.raises(ValueError, match="2-rank ctx"):
            InferenceEngine(ctx, model, tp=2)
        srv = Server(ctx, [TenantConfig("t")])
        assert srv.conformance
        assert InferenceEngine(ctx, model, server=srv).conformance
        srv.close()


@pytest.mark.parametrize("heads", [1, 4])
def test_fold_heads_lane_bits_independent_of_wave_width(heads):
    """The device fold's lane 0 is bit for bit the same at 1, 2, 3, 8 and
    32 lanes, given as copies or as a lane-stride-0 view (the scores and
    p @ V are elementwise products and sums: no batched product whose
    algorithm a wave's width picks), and within f32 rounding of the
    numpy host fold, which is the reference's."""
    d, P = 16, 8
    rng = np.random.default_rng(heads)
    q = (0.5 * rng.standard_normal((1, 1, d))).astype(np.float32)
    k = (0.5 * rng.standard_normal((1, P, d))).astype(np.float32)
    v = (0.5 * rng.standard_normal((1, P, d))).astype(np.float32)
    a = np.zeros((1, 1, d + 2 * heads), np.float32)
    tpa.reset_acc(a[0], heads)
    host = a.copy()
    jpa.attend_heads(q[0, 0], k[0], v[0], host[0], 0.25, heads)
    lane0 = {}
    for w in (1, 2, 3, 8, 32):
        for stride0 in (False, True):
            st = [torch.from_numpy(x).expand(w, *x.shape[1:])
                  for x in (q, k, v, a)]
            if not stride0:
                st = [t.contiguous() for t in st]
            lane0[(w, stride0)] = tpa.fold_heads(*st, 0.25, heads)[0]
    first = lane0[(1, False)]
    assert all(torch.equal(first, t) for t in lane0.values())
    np.testing.assert_allclose(first.numpy(), host[0], rtol=1e-5,
                               atol=1e-6)
