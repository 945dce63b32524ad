"""The port's fleet router (serve/router.py), its two engine hooks
(Server.cancel, InferenceEngine.prefill_warm) and the in-process page
migration (comm/migrate.py) against the JAX package's: the cases of
tests/serve/test_router.py and tests/serve/test_migrate.py, run on both
packages in this process on the same seeded inputs.

Both packages' models carry the same weights (the port's is made from the
reference's parameters), both routers price with the same transfer
economics (each loaded from the repo's BENCH_comm.json: the cached
default_economics() of either package could hold another load), and each
case returns what it observed: digests and their adverts, the score rows
(every leg, the cost included), the chosen replicas, the router's
counters, the migrations and the fleet's tokens.  Those are held equal
between the packages; the attention outputs are torch's products on the
port and numpy's on the reference, so they are held at 1e-5 / 1e-6, and
bit for bit against the port's own sequential reference_generate.  The
`device` cases run the port's replicas with CudaDevice(ctx, device="cpu")
(the fold's torch form) against the reference's host folds: tokens equal,
outputs at 1e-4 / 1e-5.
"""
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import parsec_tpu as jpt
import parsec_tpu_torch as tpt
from parsec_tpu import serve as jserve
from parsec_tpu.comm import economics as jecon
from parsec_tpu.comm import migrate as jmig
from parsec_tpu.comm import topology as jtopo
from parsec_tpu.ops import paged_attention as jpa
from parsec_tpu_torch import serve as tserve
from parsec_tpu_torch.comm import economics as tecon
from parsec_tpu_torch.comm import migrate as tmig
from parsec_tpu_torch.comm import topology as ttopo
from parsec_tpu_torch.convert import paged_lm_params
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.ops import paged_attention as tpa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_COMM = os.path.join(REPO, "BENCH_comm.json")
CFG = dict(vocab=32, d=8, page=4, seed=2)
PAGE, D = 4, 8


def _ref_model():
    return jserve.PagedLM(jserve.PagedLMConfig(**CFG))


def _port_model():
    return tserve.PagedLM.from_params(tserve.PagedLMConfig(**CFG),
                                      paged_lm_params(_ref_model()), "cpu")


REF = SimpleNamespace(
    name="ref", pt=jpt, serve=jserve, mig=jmig, pa=jpa, topo=jtopo,
    econ=lambda: jecon.TransferEconomics.load(BENCH_COMM),
    model=_ref_model, dev=None)
PORT = SimpleNamespace(
    name="port", pt=tpt, serve=tserve, mig=tmig, pa=tpa, topo=ttopo,
    econ=lambda: tecon.TransferEconomics.load(BENCH_COMM),
    model=_port_model, dev=None)
PORT_DEV = SimpleNamespace(**dict(vars(PORT), name="port+device",
                                  dev=lambda ctx: CudaDevice(ctx,
                                                             device="cpu")))


def _fleet(P, model, n=2, n_pages=24, roles=None, tenants=None):
    ctxs, reps = [], []
    for i in range(n):
        ctx = P.pt.Context(nb_workers=2, scheduler="lws")
        dev = P.dev(ctx) if P.dev else None
        eng = P.serve.InferenceEngine(
            ctx, model, n_pages=n_pages, max_seqs=4, dev=dev,
            tenants=(tenants or (lambda S: [S.TenantConfig("t")]))(P.serve),
            name=f"r{i}")
        ctxs.append(ctx)
        reps.append(P.serve.Replica(eng, role=(roles or {}).get(i, "mixed")))
    return ctxs, reps


def _teardown(router, ctxs):
    router.close()
    for c in ctxs:
        for d in list(c._devices):
            d.stop()
        c.destroy()


def _advert(keys=(), healthy=True, queued_bytes=0, active_pools=0,
            burn=0.0, page_bytes=256):
    return {"healthy": healthy, "queued_bytes": queued_bytes,
            "active_pools": active_pools, "slo_burn_rate": burn,
            "prefix": {"mode": "set", "keys": [str(k) for k in keys],
                       "page_bytes": page_bytes}}


def _both(case, *pkgs):
    """`case` run on the reference and on each port variant (fresh
    models each)."""
    return [case(P, P.model()) for P in (REF,) + (pkgs or (PORT,))]


def _hold(ref: dict, got: dict, outputs_tol=(1e-5, 1e-6)):
    """Every key equal but the attention outputs, held at `outputs_tol`."""
    assert set(ref) == set(got), (sorted(ref), sorted(got))
    for k in ref:
        if k == "outputs":
            for a, b in zip(ref[k], got[k]):
                np.testing.assert_allclose(b, a, rtol=outputs_tol[0],
                                           atol=outputs_tol[1])
        else:
            assert got[k] == ref[k], (k, ref[k], got[k])


def _rows(rows):
    return [dict(r) for r in rows]


# ---------------------------------------------------------------- digest
def test_key_digest_set_and_bloom_match_reference():
    keys = [f"k{i:02d}" for i in range(8)]
    chain = keys[:4] + ["cold0", "cold1"]

    def case(P, _model):
        K = P.serve.KeyDigest
        ds, db = K("set", keys), K("bloom", keys, m=1024, k=3)
        assert all(k in ds and k in db for k in keys)
        m = K("set", keys[:2]).merge(K("set", keys[2:5]))
        bm = K.from_advert(db.to_advert()).merge(
            K("bloom", ["extra"], m=1024, k=3))
        return {"set": ds.to_advert(), "bloom": db.to_advert(),
                "warm": [ds.predict_warm(chain), db.predict_warm(chain),
                         K.from_advert(ds.to_advert()).predict_warm(chain),
                         m.predict_warm(keys)],
                "merged_bloom": bm.to_advert(),
                "lens": [len(ds), len(db), len(bm)],
                "garbled": [K.from_advert(None).predict_warm(chain),
                            K.from_advert({"mode": "bloom", "bits": "zz"})
                            .predict_warm(chain)]}
    ref, port = _both(case)
    assert port == ref
    assert port["warm"][0] == 4 and port["garbled"] == [0, 0]


# ------------------------------------------------------------- placement
def _placement(P, model):
    ctxs, reps = _fleet(P, model, n=2)
    router = P.serve.Router(reps, P.serve.RoutePolicy(econ=P.econ()))
    try:
        shared = [1, 2, 3, 4, 5, 6, 7, 8]
        rows0 = router.score(shared + [9], adverts={0: _advert(),
                                                    1: _advert()})
        fh0 = router.submit(shared + [9], 3, tenant="t",
                            adverts={0: _advert(), 1: _advert()})
        router.run(timeout_s=120)
        prompt = shared + [10, 11, 12, 13, 14]
        keys = P.pa.prefix_page_keys(model.model_id, prompt, CFG["page"])
        rows = router.score(prompt)
        probes = [r.pool.probe(keys) for r in reps]
        hits0 = reps[0].pool.stats()["prefix_hits"]
        fh1 = router.submit(prompt, 3, tenant="t")
        router.run(timeout_s=120)
        hits = reps[0].pool.stats()["prefix_hits"] - hits0
        rt, ro = model.reference_generate(prompt, 3)
        assert fh1.tokens == rt
        if P.dev is None:
            assert np.array_equal(np.stack(fh1.outputs), ro)
        return {"rows0": _rows(rows0), "first": reps.index(fh0.replica),
                "rows": _rows(rows), "probes": probes,
                "chosen": reps.index(fh1.replica), "hits": hits,
                "tokens": [fh0.tokens, fh1.tokens],
                "outputs": [np.stack(fh0.outputs), np.stack(fh1.outputs)],
                "counters": dict(router.counters)}
    finally:
        _teardown(router, ctxs)


def test_placement_prediction_matches_acquire_prefix_like_reference():
    """The digest's predicted warm length is what acquire_prefix maps,
    on both packages, with the same score rows and choices."""
    ref, port = _both(_placement)
    _hold(ref, port)
    assert port["probes"] == [2, 0] and port["hits"] == 2
    assert port["first"] == 0 and port["chosen"] == 0


def test_placement_on_device_replicas_matches_reference():
    """The same placement with the port's replicas on CudaDevice: the
    device folds leave the rows, choices and tokens equal."""
    ref, port = _both(_placement, PORT_DEV)
    _hold(ref, port, outputs_tol=(1e-4, 1e-5))


def test_tie_break_and_occupancy_pressure_match_reference():
    def case(P, model):
        ctxs, reps = _fleet(P, model, n=2)
        router = P.serve.Router(reps, P.serve.RoutePolicy(
            migrate=False, econ=P.econ()))
        try:
            prompt = [1, 2, 3, 4, 5, 6, 7, 8]
            keys = P.pa.prefix_page_keys(model.model_id, prompt,
                                         CFG["page"])
            out = []
            for ads in ({0: _advert(), 1: _advert()},
                        {0: _advert(), 1: _advert(keys=keys)},
                        {0: _advert(), 1: _advert(
                            keys=keys, queued_bytes=1 << 30,
                            active_pools=64, burn=1.0)},
                        {0: _advert(healthy=False),
                         1: _advert(queued_bytes=1 << 30)}):
                rows = router.score(prompt, adverts=ads)
                out.append((_rows(rows), router._choose(rows)["replica"]))
            return {"cases": out}
        finally:
            _teardown(router, ctxs)
    ref, port = _both(case)
    assert port == ref
    assert [c[1] for c in port["cases"]] == [0, 1, 0, 1]
    assert port["cases"][3][0][0]["cost"] == float("inf")


def _migration_priced(P, model):
    ctxs, reps = _fleet(P, model, n=2)
    router = P.serve.Router(reps, P.serve.RoutePolicy(mem_gbps=1e-4,
                                                      econ=P.econ()))
    try:
        shared = [3, 1, 4, 1, 5, 9, 2, 6]
        reqs = [(shared + [7 + i], 4) for i in range(4)]
        pin = {0: _advert(), 1: _advert(queued_bytes=1 << 30)}
        fhs = [router.submit(p, n, tenant="t", adverts=pin)
               for p, n in reqs]
        router.run(timeout_s=120)
        for fh, (p, n) in zip(fhs, reqs):
            assert fh.state == "done"
            rt, ro = model.reference_generate(p, n)
            assert fh.tokens == rt
            if P.dev is None:
                assert np.array_equal(np.stack(fh.outputs), ro)
        keys = P.pa.prefix_page_keys(model.model_id, shared, CFG["page"])
        rows = router.score(shared + [9], adverts={
            0: _advert(keys=keys, healthy=False), 1: _advert()})
        best = router._choose(rows)
        res = router.migrate(keys, dst=reps[1], src=reps[0])
        ev = reps[1].engine.scope.events("page_migration")[-1]
        return {"tokens": [fh.tokens for fh in fhs],
                "outputs": [np.stack(fh.outputs) for fh in fhs],
                "rows": _rows(rows), "best": best["replica"],
                "migrate": res, "probe": reps[1].pool.probe(keys),
                "counters": dict(router.counters),
                "event": {k: ev[k] for k in ("transferred", "bytes",
                                             "skipped_held",
                                             "skipped_missing")}}
    finally:
        _teardown(router, ctxs)


def test_fleet_bit_identical_and_migration_priced_in_like_reference():
    ref, port = _both(_migration_priced)
    _hold(ref, port)
    assert port["best"] == 1 and port["migrate"]["transferred"] == 2
    assert port["counters"]["migrated_pages"] == 2


def test_fleet_on_device_replicas_matches_reference():
    ref, port = _both(_migration_priced, PORT_DEV)
    _hold(ref, port, outputs_tol=(1e-4, 1e-5))


def _disaggregated(P, model):
    ctxs, reps = _fleet(P, model, n=2, roles={0: "prefill", 1: "decode"})
    router = P.serve.Router(reps, P.serve.RoutePolicy(econ=P.econ()))
    try:
        prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9]
        fh = router.prefill_then_decode(prompt, 5, tenant="t")
        placed = reps.index(fh.replica)
        router.run(timeout_s=120)
        assert fh.state == "done"
        rt, ro = model.reference_generate(prompt, 5)
        assert fh.tokens == rt
        if P.dev is None:
            assert np.array_equal(np.stack(fh.outputs), ro)
        dst = reps[1].pool.stats()
        return {"placed": placed, "tokens": [fh.tokens],
                "outputs": [np.stack(fh.outputs)],
                "imported": dst["imported"],
                "warm_hits": dst["prefix_hits"] >= 2,
                "counters": dict(router.counters),
                "prefill_retired": reps[0].engine.stats["retired"]}
    finally:
        _teardown(router, ctxs)


def test_prefill_then_decode_disaggregated_like_reference():
    """prefill_warm on the prefill replica (max_new=0), the frozen pages
    migrated, the request served warm on the decode replica: bit for bit
    the port's own sequential run, and the reference's counters."""
    ref, port = _both(_disaggregated)
    _hold(ref, port)
    assert port["placed"] == 1 and port["imported"] == 2
    assert port["counters"]["prefill_jobs"] == 1
    assert port["prefill_retired"] == 1


def test_prefill_then_decode_on_device_replicas_matches_reference():
    ref, port = _both(_disaggregated, PORT_DEV)
    _hold(ref, port, outputs_tol=(1e-4, 1e-5))


# ---------------------------------------------------------- re-placement
def _tenants(S):
    return [S.TenantConfig("t"), S.TenantConfig("probe", slo_ms=1e-6,
                                                slo_burn=0.5)]


def test_requeued_request_replaced_off_unhealthy_replica_like_reference():
    """A request still queued on a replica whose health flips is
    cancelled (Server.cancel) and re-placed: the same counters, events
    and tokens on both packages; the decoding request is never touched."""
    def case(P, model):
        ctxs, reps = _fleet(P, model, n=2, n_pages=2, tenants=_tenants)
        router = P.serve.Router(reps, P.serve.RoutePolicy(econ=P.econ()))
        try:
            fh1 = router.submit([1, 2, 3, 4, 5, 6], 2, tenant="t",
                                adverts={0: _advert(), 1: _advert()})
            fh2 = router.submit([8, 9, 10, 11], 2, tenant="t",
                                adverts={0: _advert(),
                                         1: _advert(queued_bytes=1 << 30)})
            states = [fh1.handle.ticket.state, fh2.handle.ticket.state]
            sid = reps[0].engine.scope.new_scope("probe")
            reps[0].engine.scope.record_done(sid)
            health = [r.server.healthy() for r in reps]
            moved = router._pump()
            placed = [reps.index(fh.replica) for fh in (fh1, fh2)]
            cancelled = reps[0].server.stats()["tenants"]["t"]["cancelled"]
            ev = reps[1].engine.scope.events("route_replace")[-1]
            router.run(timeout_s=120)
            out = {"states": states, "health": health, "moved": moved,
                   "placed": placed, "reroutes": [fh1.reroutes,
                                                  fh2.reroutes],
                   "cancelled": cancelled,
                   "event_from": ev["from_replica"],
                   "done": [fh1.state, fh2.state],
                   "tokens": [fh1.tokens, fh2.tokens],
                   "counters": dict(router.counters)}
            for fh, p in ((fh1, [1, 2, 3, 4, 5, 6]), (fh2, [8, 9, 10, 11])):
                assert fh.tokens == model.reference_generate(p, 2)[0]
            return out
        finally:
            _teardown(router, ctxs)
    ref, port = _both(case)
    assert port == ref
    assert port["states"] == ["running", "queued"]
    assert port["moved"] == 1 and port["placed"] == [0, 1]
    assert port["cancelled"] == 1 and port["event_from"] == "r0"


def test_no_healthy_replica_is_counted_like_reference():
    def case(P, model):
        ctxs, reps = _fleet(P, model, n=2, n_pages=2, tenants=_tenants)
        router = P.serve.Router(reps, P.serve.RoutePolicy(econ=P.econ()))
        try:
            router.submit([1, 2, 3, 4, 5, 6], 2, tenant="t",
                          adverts={0: _advert(), 1: _advert()})
            fh2 = router.submit([8, 9, 10, 11], 2, tenant="t",
                                adverts={0: _advert(),
                                         1: _advert(queued_bytes=1 << 30)})
            for rep in reps:
                sid = rep.engine.scope.new_scope("probe")
                rep.engine.scope.record_done(sid)
            moved = router._pump()
            out = {"moved": moved, "ticket": fh2.handle.ticket.state,
                   "state": fh2.state, "counters": dict(router.counters)}
            router.run(timeout_s=120)
            out["after"] = fh2.state
            return out
        finally:
            _teardown(router, ctxs)
    ref, port = _both(case)
    assert port == ref
    assert port["moved"] == 0 and port["state"] == "cancelled"
    assert port["counters"]["reroute_failed"] == 1


def test_migration_priced_per_link_class_like_reference():
    def case(P, model):
        ctxs, reps = _fleet(P, model, n=2)
        econ = P.econ()
        shared = [3, 1, 4, 1, 5, 9, 2, 6]
        keys = P.pa.prefix_page_keys(model.model_id, shared, CFG["page"])
        pb = 256
        nbytes = len(keys) * pb
        s_intra = econ.cost(nbytes, "rdv", cls="host")
        s_dcn = econ.cost(nbytes, "rdv", cls="dcn")
        mem_gbps = nbytes / ((s_intra + s_dcn) / 2) / 1e9
        adverts = {0: _advert(keys=keys, page_bytes=pb), 1: _advert()}
        out = {}
        for spec in ("0,1", "0;1"):
            router = P.serve.Router(reps, P.serve.RoutePolicy(
                mem_gbps=mem_gbps, econ=econ,
                topo=P.topo.TopologyModel.parse(spec)))
            out[spec] = _rows(router.score(shared, adverts=adverts))
            if spec == "0,1":
                router.close()
        _teardown(router, ctxs)
        return out
    ref, port = _both(case)
    assert port == ref
    assert port["0,1"][1]["migrate_cls"] == "host"
    assert port["0;1"][1]["migrate_pages"] == 0


def test_router_stats_and_fleet_row_match_reference():
    """Router.stats() (the live sampler's fleet row) and the route_place
    events carry the reference's fields and values."""
    def case(P, model):
        ctxs, reps = _fleet(P, model, n=2)
        router = P.serve.Router(reps, P.serve.RoutePolicy(econ=P.econ()))
        try:
            router.submit([1, 2, 3, 4, 5], 2, tenant="t")
            router.run(timeout_s=120)
            st = router.stats()
            ev = reps[0].engine.scope.events("route_place")[-1]
            assert router in ctxs[0]._routers
            return {"stats": st, "event": {k: ev[k] for k in (
                "replica", "tenant", "warm", "cost", "migrate_pages",
                "scores")}}
        finally:
            _teardown(router, ctxs)
    ref, port = _both(case)
    assert port == ref


# ------------------------------------------------------------- migration
def _freeze(pool, key, seed):
    p = pool.alloc()
    rng = np.random.RandomState(seed)
    pool.k_tile(p)[...] = rng.randn(PAGE, D).astype(np.float32)
    pool.v_tile(p)[...] = rng.randn(PAGE, D).astype(np.float32)
    pool.host_wrote(p)
    assert pool.freeze(p, key)
    pool.release([p])


def _page_bytes(pool, key):
    p = pool._index[key]
    return np.concatenate([np.array(pool.k_tile(p)),
                           np.array(pool.v_tile(p))])


def test_migrate_transfers_once_then_dedups_like_reference():
    def case(P, _model):
        with P.pt.Context(nb_workers=2, scheduler="lws") as ctx:
            src = P.pa.PagePool(ctx, 8, PAGE, D, name="SRC")
            dst = P.pa.PagePool(ctx, 8, PAGE, D, name="DST")
            keys = P.pa.prefix_page_keys("m", list(range(12)), PAGE)
            for j, k in enumerate(keys):
                _freeze(src, k, seed=j)
            wanted = P.mig.wanted_keys(dst, keys)
            res = P.mig.migrate_keys(src, dst, keys)
            pages = [_page_bytes(dst, k) for k in keys]
            assert all(np.array_equal(_page_bytes(src, k), b)
                       for k, b in zip(keys, pages))
            res2 = P.mig.migrate_keys(src, dst, keys)
            res3 = P.mig.migrate_keys(
                src, P.pa.PagePool(ctx, 4, PAGE, D, name="DST2"),
                list(keys) + ["ghost"])
            st = dst.stats()
            return {"wanted": wanted == keys, "res": [res, res2, res3],
                    "pages": [p.tobytes() for p in pages],
                    "probe": dst.probe(keys), "free": dst.free_pages,
                    "refs": [dst.refcount(dst._index[k]) for k in keys],
                    "stats": {k: st[k] for k in ("imported",
                                                 "migrated_in_bytes",
                                                 "import_dups")}}
    ref, port = _both(case)
    assert port == ref
    assert port["res"][0]["transferred"] == 3 and \
        port["res"][1]["bytes"] == 0
    assert port["res"][2]["skipped_missing"] == 1


def test_import_refuses_duplicates_like_reference():
    def case(P, _model):
        with P.pt.Context(nb_workers=2, scheduler="lws") as ctx:
            src = P.pa.PagePool(ctx, 4, PAGE, D, name="SRC")
            dst = P.pa.PagePool(ctx, 4, PAGE, D, name="DST")
            _freeze(src, "k0", seed=7)
            payload = src.export_frozen("k0")
            out = {"exported": src.stats()["exported"],
                   "src_ref": src.refcount(src._index["k0"]),
                   "first": dst.import_frozen("k0", *payload)}
            free0, p0 = dst.free_pages, dst._index["k0"]
            before = _page_bytes(dst, "k0")
            out["dup"] = dst.import_frozen("k0", payload[0] * 2, payload[1])
            out.update({"dups": dst.stats()["import_dups"],
                        "leak": dst.free_pages - free0,
                        "same_page": dst._index["k0"] == p0,
                        "untouched": np.array_equal(
                            before, _page_bytes(dst, "k0")),
                        "missing": dst.export_frozen("missing") is None})
            return out
    ref, port = _both(case)
    assert port == ref
    assert port["first"] is True and port["dup"] is False


def test_shared_page_survives_eviction_during_migration_like_reference():
    def case(P, _model):
        with P.pt.Context(nb_workers=2, scheduler="lws") as ctx:
            src = P.pa.PagePool(ctx, 8, PAGE, D, name="SRC")
            dst = P.pa.PagePool(ctx, 4, PAGE, D, name="DST")
            keys = [f"k{j}" for j in range(3)]
            for j, k in enumerate(keys):
                _freeze(src, k, seed=j)
            out = {"first": P.mig.migrate_keys(src, dst, keys)}
            got = dst.acquire_prefix(keys[:1], 1)
            held = got[0][0]
            want = _page_bytes(dst, keys[0])
            grabbed = dst.reserve(3)
            out.update({"held_not_grabbed": held not in grabbed,
                        "evictions": dst.stats()["evictions"],
                        "still_indexed": dst.probe(keys[:1]),
                        "bytes_kept": np.array_equal(
                            want, _page_bytes(dst, keys[0]))})
            dst.release(grabbed)
            out["again"] = P.mig.migrate_keys(src, dst, keys)
            out["probe"] = dst.probe(keys)
            dst.release([held])
            out["free"] = dst.free_pages
            out["refs"] = [dst.refcount(p) for p in range(4)]
            return out
    ref, port = _both(case)
    assert port == ref
    assert port["evictions"] == 2 and port["again"]["transferred"] == 2


def test_concurrent_migration_and_eviction_churn():
    """Threaded churn (re-migration against reserve/release), the
    reference's invariants on the port: accounting balances, no refcount
    leaks, every still-indexed key bit-exact, a final pass restores full
    warmth.  The interleaving is the scheduler's, so the two packages'
    runs are held to the invariants, not to each other."""
    with tpt.Context(nb_workers=2, scheduler="lws") as ctx:
        src = tpa.PagePool(ctx, 8, PAGE, D, name="SRC")
        dst = tpa.PagePool(ctx, 4, PAGE, D, name="DST")
        keys = [f"c{j}" for j in range(4)]
        blobs = {}
        for j, k in enumerate(keys):
            _freeze(src, k, seed=100 + j)
            blobs[k] = _page_bytes(src, k)
        stop = threading.Event()
        errs = []

        def loop(fn):
            try:
                while not stop.is_set():
                    fn()
            except Exception as e:  # pragma: no cover
                errs.append(e)

        def evict():
            got = dst.reserve(2)
            if got:
                dst.release(got)
        ts = [threading.Thread(target=loop, args=(
            lambda: tmig.migrate_keys(src, dst, keys),)),
              threading.Thread(target=loop, args=(evict,))]
        for t in ts:
            t.start()
        time.sleep(0.4)
        stop.set()
        for t in ts:
            t.join()
        assert not errs, errs
        st = dst.stats()
        assert st["free"] + st["cached_free"] == 4, st
        assert all(dst.refcount(p) == 0 for p in range(4))
        for k in keys:
            if dst.probe([k]):
                assert np.array_equal(_page_bytes(dst, k), blobs[k])
        tmig.migrate_keys(src, dst, keys)
        assert dst.probe(keys) == 4


def test_migration_pricing_functions_match_reference():
    """migration_class, migration_cost and relay_rank_for (the topology's
    classed legs and the relay decision) on both packages."""
    fits = {"rdv": {"fixed_overhead_us": 50.0, "per_byte_ns": 1.0}}
    out = []
    for P, E in ((REF, jecon), (PORT, tecon)):
        tm = P.topo.TopologyModel.parse("0,1;2,3")
        econ = E.TransferEconomics(fits, source="synthetic")
        out.append({
            "cls": [P.mig.migration_class(s, d, tm)
                    for s, d in ((0, 1), (0, 2), (2, 2))],
            "cost": [P.mig.migration_cost(1 << 20, s, d, tm, econ)
                     for s, d in ((0, 1), (0, 2))],
            "relay": [P.mig.relay_rank_for(1 << 24, s, d, tm, P.econ())
                      for s, d in ((1, 3), (0, 2), (0, 1))]})
    assert out[1] == out[0]
    assert out[1]["cls"] == ["host", "dcn", "loopback"]
    assert out[1]["relay"] == [2, None, None]


def test_cancel_withdraws_only_queued_tickets():
    """Server.cancel on both packages: a queued ticket turns terminal
    `cancelled` (counted, its scope a rejection, journalled), a running
    one is left alone."""
    def case(P, model):
        with P.pt.Context(nb_workers=2, scheduler="lws") as ctx:
            eng = P.serve.InferenceEngine(
                ctx, model, n_pages=2, max_seqs=4,
                tenants=[P.serve.TenantConfig("t")])
            h1 = eng.submit([1, 2, 3, 4, 5, 6], 2, "t")
            h2 = eng.submit([8, 9, 10, 11], 2, "t")
            out = {"states": [h1.ticket.state, h2.ticket.state],
                   "cancel_running": eng.server.cancel(h1.ticket),
                   "cancel_queued": eng.server.cancel(h2.ticket),
                   "again": eng.server.cancel(h2.ticket),
                   "terminal": h2.ticket.terminal,
                   "state": h2.ticket.state}
            st = eng.server.stats()
            out["counted"] = [st["tenants"]["t"]["cancelled"],
                              st["totals"]["cancelled"],
                              st["totals"]["queue_depth"]]
            eng.run(timeout_s=60)
            out["h1"] = h1.state
            out["h2"] = h2.state
            out["scope_rejected"] = ctx.stats()["scope"]["tenants"]["t"][
                "rejected"]
            warm = eng.prefill_warm([1, 2, 3, 4, 5], tenant="t")
            eng.run(timeout_s=60)
            out["warm"] = (warm.state, len(warm.generated),
                           eng.pool.probe(P.pa.prefix_page_keys(
                               model.model_id, [1, 2, 3, 4, 5], PAGE)))
            eng.close()
            return out
    ref, port = _both(case)
    assert port == ref
    assert port["cancel_running"] is False and port["cancel_queued"] is True
    assert port["state"] == "cancelled" and port["counted"][:2] == [1, 1]
