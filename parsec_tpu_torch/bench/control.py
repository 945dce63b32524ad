"""The control suite (bench.py's `--control`): the drift soak (an
incident, drift detection, a recalibrated retune, the pool-boundary
hot-swap, recovered throughput without a restart) on an out-of-core GEMM
on a CudaDevice, and the adaptive-vs-fixed spec_k sweep over an oracle
and an adversarial draft.
"""
from __future__ import annotations

import os
import tempfile
import time

import numpy as np

import parsec_tpu_torch as pt

from .common import host_provenance, torch_device


def _control_soak_section(m=384, k=64, mb=32, reps=3,
                          fault_delay_us=2000, device="cuda"):
    """Drift soak: an out-of-core-capable GEMM runs healthy, then an
    incident lands mid-run — the comm fault hook is armed
    (PTC_COMM_FAULT_DELAY_US) and the tuned knob vector goes stale:
    device.cache_bytes pinned to a quarter of the tile set, so every rep
    thrashes the device cache.  A Controller on a long-lived
    control-plane context observes each rep through
    ScopeRegistry.record_pool_done, detects the sustained makespan
    drift, re-simulates on the recalibrated model and hot-swaps the
    winning vector (the uncapped budget) at the next pool boundary.
    `recovery_ratio` is the fraction of incident-lost throughput the
    swap claws back without a restart."""
    from parsec_tpu_torch.algos import build_gemm
    from parsec_tpu_torch.analysis.control import Controller
    from parsec_tpu_torch.analysis.tune import TuneStore, hold_knobs
    from parsec_tpu_torch.data import TwoDimBlockCyclic
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.utils.faults import apply_comm_faults

    def _gemm(ctx, dev):
        rng = np.random.default_rng(3)
        A = TwoDimBlockCyclic(m, k, mb, mb, dtype=np.float32)
        B = TwoDimBlockCyclic(k, m, mb, mb, dtype=np.float32)
        Cc = TwoDimBlockCyclic(m, m, mb, mb, dtype=np.float32)
        A.from_dense(rng.standard_normal((m, k), dtype=np.float32))
        B.from_dense(rng.standard_normal((k, m), dtype=np.float32))
        Cc.from_dense(np.zeros((m, m), np.float32))
        A.register(ctx, "A")
        B.register(ctx, "B")
        Cc.register(ctx, "C")
        return build_gemm(ctx, A, B, Cc, dev=dev)

    spill_log = []

    def _rep():
        """One pool: a fresh context and device (the device reads the
        live device.cache_bytes knob, so a hot-swapped budget binds at
        the next rep — the pool boundary)."""
        with pt.Context(nb_workers=2) as ctx:
            dev = CudaDevice(ctx, device=device)
            try:
                tp = _gemm(ctx, dev)
                t0 = time.perf_counter()
                tp.run()
                tp.wait()
                dev.flush()
                wall = time.perf_counter() - t0
                spill_log.append(ctx.device_stats()["spills"])
            finally:
                dev.stop()
        return wall

    nt = (m // mb) * (m // mb) * (k // mb)

    def _tput(walls):
        return round(nt / sorted(walls)[len(walls) // 2], 1)

    store_path = os.path.join(tempfile.mkdtemp(prefix="ptc_bench_control_"),
                              "tuned.json")

    _rep()  # untimed warmup
    with pt.Context(nb_workers=1) as cctx:
        reg = cctx.scope_registry()
        # phase A: healthy baseline, and the healthy makespan ratio the
        # drift threshold is calibrated against
        walls_a = [_rep() for _ in range(reps)]
        t_base = _tput(walls_a)

        ctrl = Controller(cctx, window=reps, cooldown=2,
                          store=TuneStore(store_path))
        target_dev = CudaDevice(cctx, device=device)  # graph construction
        try:
            plan = ctrl.attach_target(_gemm(cctx, target_dev),
                                      workers=2)
            plan_sum = reg.plan_summary(plan)
            lb_ns = max(1, plan_sum["makespan_lb_ns"])
            healthy_ratio = sorted(walls_a)[reps // 2] * 1e9 / lb_ns
            ctrl.drift_ratio = 1.35 * healthy_ratio

            # the incident: armed comm fault injection + the stale cache
            # budget (a quarter of the GEMM tile set)
            apply_comm_faults(delay_us=fault_delay_us)
            stale = (m * k + k * m + m * m) * 4 // 4
            _applied, restore_incident = hold_knobs(
                {"device.cache_bytes": stale})
            try:
                # phase B: degraded reps, each a planned pool the
                # controller observes; drift fires, the retune goes
                # pending
                walls_b = []
                for _ in range(reps):
                    w = _rep()
                    walls_b.append(w)
                    sid = reg.new_scope("soak", kind="decode_step")
                    reg.record_pool_done(sid, plan=dict(plan_sum),
                                         measured={"wall_ns": w * 1e9})
                t_fault = _tput(walls_b)
                # the next pool boundary applies the pending swap
                ctrl.observe_pool(None)
                s = ctrl.stats()

                # phase C: recovered reps under the controller's vector
                walls_c = [_rep() for _ in range(reps)]
                t_rec = _tput(walls_c)
            finally:
                ctrl.stop()        # restores the pre-swap (incident) knobs
                restore_incident()  # lifts the incident hold itself
                os.environ.pop("PTC_COMM_FAULT_DELAY_US", None)
        finally:
            target_dev.stop()

        lost = max(1e-9, t_base - t_fault)
        recovery = round(max(0.0, min(1.5, (t_rec - t_fault) / lost)), 3)
        return {
            "m": m, "k": k, "mb": mb, "tasks": nt, "reps": reps,
            "fault_delay_us": fault_delay_us,
            "stale_cache_bytes": stale,
            "healthy_ratio": round(healthy_ratio, 3),
            "drift_ratio": round(ctrl.drift_ratio, 3),
            "throughput_tasks_s": {"healthy": t_base, "faulted": t_fault,
                                   "recovered": t_rec},
            "spills_per_phase": {
                "healthy": spill_log[1:1 + reps],
                "faulted": spill_log[1 + reps:1 + 2 * reps],
                "recovered": spill_log[1 + 2 * reps:]},
            "recovery_ratio": recovery,
            "recovered": bool(recovery >= 0.5 and s["swaps"] >= 1),
            "retunes": s["retunes"], "swaps": s["swaps"],
            "persisted": s["persisted"],
            "last_swap": s["last_swap"],
            "decisions": [d["kind"] for d in ctrl.decision_log()],
        }


def _control_spec_section(workers=2, n_reqs=4, max_new=40, seed=31,
                          device="cuda"):
    """Adaptive speculation: the same request mix against an oracle
    draft (self, acceptance 1.0) and an adversarial draft (a differently
    seeded model, acceptance ~0), at every fixed k and with
    spec_k='auto'.  The score is deterministic (counts, not wall time):
    tokens per verify wave normalized by wasted verify positions per
    token, summed over both mixes — adaptive must beat every fixed k,
    every stream bit-identical to plain decode."""
    from parsec_tpu_torch.serve import InferenceEngine, TenantConfig
    from parsec_tpu_torch.serve.engine import PagedLM, PagedLMConfig

    model = PagedLM(PagedLMConfig(vocab=32, d=8, page=4, seed=5),
                    device=device)
    adversary = PagedLM(PagedLMConfig(vocab=32, d=8, page=4, seed=99),
                        device=device)
    rng = np.random.RandomState(seed)
    reqs = [(list(rng.randint(0, 32, size=int(rng.randint(5, 12)))),
             max_new, "t") for _ in range(n_reqs)]

    def run_one(k, draft):
        with pt.Context(nb_workers=workers, scheduler="lws") as ctx:
            eng = InferenceEngine(
                ctx, model, n_pages=256, max_seqs=8,
                tenants=[TenantConfig("t", max_pools=32, max_queue=64)],
                spec_k=k, spec_draft=draft)
            t0 = time.perf_counter()
            hs = [eng.submit(p, n, t) for p, n, t in reqs]
            eng.run(timeout_s=300)
            wall = time.perf_counter() - t0
            st = dict(eng.stats)
            sp = eng._spec_stats()
            events = len(ctx.scope_registry().events("control_spec"))
            eng.close()
        assert all(h.state == "done" for h in hs)
        return {"tokens": sum(len(h.generated) for h in hs),
                "waves": st["decode_pools"],
                "proposed": sp["proposed"], "accepted": sp["accepted"],
                "wall_s": wall, "events": events,
                "k_by_tenant": sp["k_by_tenant"]}, \
            [(h.tokens, np.stack(h.outputs)) for h in hs]

    mixes = (("oracle", "self"), ("adversarial", adversary))
    base = {name: run_one(0, draft) for name, draft in mixes}
    out = {"configs": {}, "n_reqs": n_reqs, "max_new": max_new}
    bit_identical = True
    for k in (1, 2, 4, "auto"):
        tot = {"tokens": 0, "waves": 0, "wasted": 0, "wall_s": 0.0}
        per_mix = {}
        decisions = 0
        for name, draft in mixes:
            doc, outs = run_one(k, draft)
            for (st_, so), (bt, bo) in zip(outs, base[name][1]):
                if st_ != bt or not np.array_equal(so, bo):
                    bit_identical = False
            tot["tokens"] += doc["tokens"]
            tot["waves"] += doc["waves"]
            tot["wasted"] += doc["proposed"] - doc["accepted"]
            tot["wall_s"] += doc["wall_s"]
            decisions += doc["events"]
            per_mix[name] = {
                "accept_rate": round(doc["accepted"]
                                     / max(1, doc["proposed"]), 3),
                "waves": doc["waves"],
                "k_final": doc["k_by_tenant"].get("t")}
        tpw = tot["tokens"] / max(1, tot["waves"])
        wpt = tot["wasted"] / max(1, tot["tokens"])
        out["configs"][f"k{k}"] = {
            "tokens_per_wave": round(tpw, 3),
            "wasted_per_token": round(wpt, 3),
            "score": round(tpw / (1.0 + wpt), 4),
            "tokens_per_s": round(tot["tokens"] / tot["wall_s"], 1),
            "decisions": decisions,
            "mixes": per_mix,
        }
    cfgs = out["configs"]
    best_fixed = max((cfgs[f"k{k}"]["score"] for k in (1, 2, 4)))
    out["best_fixed_score"] = best_fixed
    out["adaptive_score"] = cfgs["kauto"]["score"]
    out["adaptive_ge_best_fixed"] = bool(
        cfgs["kauto"]["score"] >= best_fixed)
    out["bit_identical"] = bit_identical
    return out


def bench_control_suite(m=384, reps=3, fault_delay_us=2000,
                        workers=2, n_reqs=4, max_new=40, device="cuda"):
    """The control document: the drift soak plus the adaptive-vs-fixed
    spec_k sweep over a mixed oracle/adversarial draft workload."""
    device = str(torch_device(str(device)))
    doc = host_provenance(threads=max(workers, 1) + 1)
    doc["soak"] = _control_soak_section(m=m, reps=reps,
                                        fault_delay_us=fault_delay_us,
                                        device=device)
    doc["spec"] = _control_spec_section(workers=workers, n_reqs=n_reqs,
                                        max_new=max_new, device=device)
    return doc
