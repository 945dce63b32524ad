"""The port's tensor-parallel serving held against parsec_tpu on the CPU:
the counterpart of every case of tests/serve/test_tp_shard.py.

A PagedLM serves across a colocated tp group (ranks as threads, one
Context each, comm engine up, colocated peers), qkv projections and KV
pages sharded BY HEAD, each decode/prefill/verify pool embedding a
RefReduce all-reduce of the ranks' partial pre-logit projections.  The
model is the JAX package's PagedLM (heads=4, qlog=True), its weights
carried across bit for bit (convert.paged_lm_params).  Held: every rank
decodes the same tokens and the same reduced pre-logit bytes, and both
are BIT-identical to the JAX package's PagedLM.reference_generate and
pre_logits on the same weights — qlog makes every partial product exact
in f32, so no association can change a bit.
"""
import threading
import time

import numpy as np
import pytest
import torch

from parsec_tpu.serve import PagedLM as JaxLM
from parsec_tpu.serve import PagedLMConfig as JaxCfg
import parsec_tpu_torch as tpt
from parsec_tpu_torch.comm.launch import free_port_base
from parsec_tpu_torch.convert import paged_lm_params
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.serve.engine import (InferenceEngine, PagedLM,
                                           PagedLMConfig)

JCFG = JaxCfg(heads=4, qlog=True)
CFG = PagedLMConfig(heads=4, qlog=True)
REF_MODEL = JaxLM(JCFG)
PARAMS = paged_lm_params(REF_MODEL)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs its files in
    parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model():
    return PagedLM.from_params(CFG, PARAMS, device="cpu")


def _tp_worker(rank, nodes, port, prompts, max_new, results, *,
               spec_k=0, profile=0, barrier=None, shared=None,
               check_rank0=None, device=False):
    try:
        ctx = tpt.Context(nb_workers=1)
        ctx.set_rank(rank, nodes)
        ctx.comm_init(port)
        ctx.comm_set_colocated([r for r in range(nodes) if r != rank])
        with ctx:
            if profile:
                ctx.profile_enable(profile)
            dev = CudaDevice(ctx, device="cpu") if device else None
            eng = InferenceEngine(ctx, _model(), n_pages=64, max_seqs=4,
                                  tp=nodes, spec_k=spec_k, dev=dev)
            hs = [None] * len(prompts)
            t0 = time.monotonic()
            for i, (p, m) in enumerate(zip(prompts, max_new)):
                hs[i] = eng.submit(p, m)
                while hs[i].state == "submitted":
                    if time.monotonic() - t0 > 90:
                        raise TimeoutError("prefill stuck")
                    time.sleep(0.001)
            while eng.pending() or eng._inflight:
                if time.monotonic() - t0 > 150:
                    raise TimeoutError("decode stuck")
                eng.step()
            toks = [list(h.tokens) for h in hs]
            outs = [[o.copy() for o in h.outputs] for h in hs]
            st = dict(eng.stats)
            tp_st = eng._tp_stats()
            if profile and barrier is not None:
                from parsec_tpu_torch.profiling import take_trace
                shared[rank] = (take_trace(ctx), [h.rid for h in hs], eng,
                                ctx)
                barrier.wait(timeout=60)
                if rank == 0 and check_rank0 is not None:
                    check_rank0(shared)
                barrier.wait(timeout=60)
            eng.close()
            if dev is not None:
                assert dev.stats["tasks"] > 0 and \
                    dev.stats["dp_errors"] == 0, dev.stats
                dev.stop()
            ctx.comm_fence()
            ctx.comm_fini()
        results[rank] = ("ok", toks, outs, st, tp_st)
    except Exception:
        import traceback
        results[rank] = ("err", traceback.format_exc(), None, None, None)


def _run_tp(nodes, prompts, max_new, **kw):
    port = free_port_base(nodes)
    results = {}
    threads = [threading.Thread(target=_tp_worker,
                                args=(r, nodes, port, prompts, max_new,
                                      results), kwargs=kw)
               for r in range(nodes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=170)
    for r in range(nodes):
        st = results.get(r, ("missing", None, None, None, None))
        assert st[0] == "ok", f"rank {r}: {st[1]}"
    return results


def _assert_matches_reference(results, nodes, prompts, max_new):
    # every rank decoded the SAME tokens and the SAME reduced pre-logit
    # bytes (the fan-out delivers the reduction to every rank)
    for r in range(1, nodes):
        assert results[0][1] == results[r][1]
        for o0, o1 in zip(results[0][2], results[r][2]):
            for a, b in zip(o0, o1):
                assert np.array_equal(a, b)
    # ... and they are bitwise the JAX package's one-rank reference
    for i, (p, m) in enumerate(zip(prompts, max_new)):
        ref_toks, ref_o = REF_MODEL.reference_generate(p, m)
        assert results[0][1][i] == ref_toks, \
            (i, results[0][1][i], ref_toks)
        for j in range(m):
            pre_ref = REF_MODEL.pre_logits(ref_o[j])
            assert np.array_equal(results[0][2][i][j], pre_ref), (i, j)


def test_tp2_decode_bit_identical():
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9]]
    max_new = [6, 5]
    results = _run_tp(2, prompts, max_new)
    _assert_matches_reference(results, 2, prompts, max_new)
    for r in range(2):
        tp_st = results[r][4]
        assert tp_st["enabled"] and tp_st["tp"] == 2
        assert tp_st["rank"] == r
        assert tp_st["heads_local"] == 2 and tp_st["d_local"] == 8
        # every prefill + decode step embedded a collective
        assert tp_st["coll_pools"] > 0
        assert tp_st["coll_wait_ns"] >= 0


def test_tp4_prefix_and_spec_bit_identical():
    """4-rank tp with the copy-on-write shared-prefix cache and
    speculative decoding both live: sharing and verification happen per
    rank on head-sharded pages, the reduction still reproduces the
    reference bit for bit, and the serve counters show both fired."""
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 5, 6, 7, 8, 9],
               [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]]
    max_new = [7, 6, 5]
    results = _run_tp(4, prompts, max_new, spec_k=2)
    _assert_matches_reference(results, 4, prompts, max_new)
    st = results[0][3]
    assert st["prefix_hits"] > 0, st
    assert st["spec_accepted"] > 0, st
    assert st["tp_coll_pools"] > 0, st


def test_tp2_coll_wait_in_request_timeline():
    """The per-request scope timeline grows the coll_wait bucket: wire
    flows that delivered ptc_coll_* steps partition out of `wire`, and
    the stage identity admission + exec + h2d + coll_wait + wire + lane
    == e2e still holds exactly."""
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9]]
    max_new = [5, 4]
    barrier = threading.Barrier(2)
    shared = {}
    failures = []

    def check_rank0(shared):
        try:
            from parsec_tpu_torch.profiling import Trace
            tr = Trace.merge([shared[r][0] for r in range(2)])
            rids = shared[0][1]
            reg = shared[0][3].scope_registry()
            coll_hops = 0
            coll_wait = 0
            for rid in rids:
                tl = reg.request_timeline(tr, rid)
                st = tl["stages"]
                assert "coll_wait_ns" in st, st
                assert tl["stages_sum_ns"] == tl["e2e_ns"], tl
                assert st["exec_ns"] > 0, tl
                coll_hops += sum(1 for h in tl["wire_hops"] if h["coll"])
                coll_wait += st["coll_wait_ns"]
            assert coll_hops > 0, "no ptc_coll_* hops in any timeline"
            assert coll_wait > 0, "coll_wait never surfaced"
        except Exception:
            import traceback
            failures.append(traceback.format_exc())

    results = _run_tp(2, prompts, max_new, profile=2, barrier=barrier,
                      shared=shared, check_rank0=check_rank0)
    assert not failures, failures[0]
    _assert_matches_reference(results, 2, prompts, max_new)
    # the engine fed record_coll_wait on every reap
    for r in range(2):
        assert results[r][4]["coll_wait_ns"] > 0


@pytest.mark.parametrize("spec_k", [0, 2])
def test_tp2_device_folds_match_tp1(spec_k):
    """The frozen-page folds on CudaDevice(device="cpu") on both tp ranks
    (chip_smoke.py's 13e at a small size): tokens and reduced pre-logits
    bit for bit a tp=1 engine's on a device, whose pre-logits come from
    its attention outputs — the device fold's rounding per head does not
    reach the quantized head."""
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
                18, 19], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17]]
    max_new = [6, 5]
    results = _run_tp(2, prompts, max_new, spec_k=spec_k, device=True)
    model = _model()
    with tpt.Context(nb_workers=1) as ctx:
        dev = CudaDevice(ctx, device="cpu")
        eng = InferenceEngine(ctx, model, n_pages=64, max_seqs=4, dev=dev,
                              spec_k=spec_k)
        hs = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
        eng.run(timeout_s=120)
        eng.close()
        assert dev.stats["tasks"] > 0
        dev.stop()
    for i, h in enumerate(hs):
        assert results[0][1][i] == results[1][1][i] == h.tokens
        for j, o in enumerate(h.outputs):
            pre = model.pre_logits(o)
            for r in range(2):
                assert np.array_equal(results[r][2][i][j], pre), (i, j, r)


def test_tp_engine_requires_exact_sharding():
    """tp mode insists on ctx.nodes == tp, heads % tp == 0 and the
    quantized-projection model (the reference asserts; the port raises
    ValueError)."""
    with tpt.Context(nb_workers=1) as ctx:
        with pytest.raises(ValueError, match="2-rank ctx"):
            InferenceEngine(ctx, _model(), n_pages=16, max_seqs=2, tp=2)
    port = free_port_base(2)
    errs = {}

    def rank(r):
        ctx = tpt.Context(nb_workers=1)
        ctx.set_rank(r, 2)
        ctx.comm_init(port)
        ctx.comm_set_colocated([1 - r])
        with ctx:
            for cfg, what in ((PagedLMConfig(heads=4), "qlog"),
                              (PagedLMConfig(heads=3, d=15, qlog=True),
                               "heads")):
                try:
                    InferenceEngine(ctx, PagedLM(cfg, device="cpu"),
                                    n_pages=16, max_seqs=2, tp=2)
                    errs[(r, what)] = "no error"
                except ValueError as e:
                    if what not in str(e):
                        errs[(r, what)] = str(e)
            ctx.comm_fence()
            ctx.comm_fini()

    ths = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=60)
    assert not errs, errs


def test_qlog_model_matches_reference():
    """The qlog model's weights, id, quantizer and head cross bit for
    bit: wo on the 1/8 grid, the model id suffixed (the prefix cache
    cannot cross-hit a non-qlog model), quant_o on the 1/256 grid, and
    each rank's wo shard summing to the full projection exactly."""
    m = _model()
    seeded = PagedLM(CFG, device="cpu")
    assert m.model_id == seeded.model_id == REF_MODEL.model_id
    assert m.model_id.endswith(":h4:q")
    for name, w in PARAMS.items():
        assert np.array_equal(paged_lm_params(seeded)[name], w), name
    rng = np.random.RandomState(3)
    o = rng.randn(CFG.d).astype(np.float32)
    assert np.array_equal(m.quant_o(o), REF_MODEL.quant_o(o))
    assert np.array_equal(m.pre_logits(o), REF_MODEL.pre_logits(o))
    for tp in (2, 4):
        part = sum(m.project(o[m.shard_slice(r, tp)], m.wo_shard(r, tp))
                   for r in range(tp))
        assert np.array_equal(part, REF_MODEL.pre_logits(o)), tp
        for r in range(tp):
            assert m.shard_slice(r, tp) == REF_MODEL.shard_slice(r, tp)
            assert np.array_equal(m.wo_shard(r, tp).numpy(),
                                  REF_MODEL.wo_shard(r, tp))
    pre = REF_MODEL.pre_logits(o)
    assert m.next_token_pre(pre) == REF_MODEL.next_token_pre(pre)
    np.testing.assert_allclose(m.logits(o), REF_MODEL.logits(o),
                               rtol=1e-5, atol=1e-5)


def _coll_worker(rank, nodes, port, results):
    try:
        from parsec_tpu_torch.parallel.collectives import (all_reduce,
                                                           reduce_scatter)
        ctx = tpt.Context(nb_workers=1)
        ctx.set_rank(rank, nodes)
        ctx.comm_init(port)
        ctx.comm_set_colocated([r for r in range(nodes) if r != rank])
        with ctx:
            tp = tpt.Taskpool(ctx)
            x = np.full(64, float(rank + 1), np.float32)
            # in-pool front door: emits into the caller's LIVE pool; the
            # buffer fills during tp.run()
            res = all_reduce(x, ctx=ctx, tp=tp)
            assert not res.any()  # deferred: zero until the pool runs
            tp.run()
            tp.wait()
            ctx.comm_fence()
            expect = sum(range(1, nodes + 1))
            assert np.array_equal(
                res, np.full(64, float(expect), np.float32)), res
            tp2 = tpt.Taskpool(ctx)
            seg = reduce_scatter(x, ctx=ctx, tp=tp2)
            tp2.run()
            tp2.wait()
            ctx.comm_fence()
            assert seg.size == 64 // nodes
            assert np.array_equal(
                seg, np.full(64 // nodes, float(expect), np.float32))
            ctx.comm_fini()
        results[rank] = ("ok",)
    except Exception:
        import traceback
        results[rank] = ("err", traceback.format_exc())


def test_front_door_in_pool_collectives():
    results = {}
    port = free_port_base(2)
    threads = [threading.Thread(target=_coll_worker,
                                args=(r, 2, port, results))
               for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for r in range(2):
        st = results.get(r, ("missing",))
        assert st[0] == "ok", f"rank {r}: {st[1] if len(st) > 1 else st}"
