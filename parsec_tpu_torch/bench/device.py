"""The device suite (bench.py's `--device`): staged-vs-prefetched wave
dispatch, the out-of-core GEMM at twice the device budget, and wave
fusion's launch economics, on a CudaDevice (the card unless the caller
passes device="cpu").
"""
from __future__ import annotations

import sys
import time

import numpy as np

import parsec_tpu_torch as pt
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.profiling.trace import KEY_DEVICE, KEY_H2D_AHEAD

from .common import host_provenance, torch_device


def _pair_spans(ev, key, aux_filter=None):
    """(t0, t1, l0, end_aux, begin_aux) tuples from consecutive
    begin/end events of one trace key.  DEVICE and H2D_AHEAD spans are
    emitted by single threads (manager / prefetch lane), so time-ordered
    pairing is exact.  DEVICE begin aux carries the fused mark (0 plain,
    n >= 1 a certified wave of a chain of n waves)."""
    rows = ev[ev[:, 0] == key]
    if aux_filter is not None:
        rows = rows[rows[:, 6] == aux_filter]
    rows = rows[np.argsort(rows[:, 7], kind="stable")]
    spans, open_t = [], None
    for r in rows:
        if r[1] == 0:
            open_t = (r[7], r[3], r[6])
        elif open_t is not None:
            spans.append((open_t[0], r[7], open_t[1], r[6], open_t[2]))
            open_t = None
    return spans


def _overlap_fraction(h2d_spans, exec_spans):
    """Fraction of h2d span time covered by device-dispatch spans — the
    trace-level transfer/compute overlap evidence."""
    total = sum(s[1] - s[0] for s in h2d_spans)
    if total <= 0:
        return None
    merged = []
    for t0, t1, *_ in sorted(exec_spans):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    cov = 0
    for t0, t1, *_ in h2d_spans:
        for m0, m1 in merged:
            lo, hi = max(t0, m0), min(t1, m1)
            if lo < hi:
                cov += hi - lo
    return cov / total


def _wave_kernel(x, y):
    return x * 2.0 + y


def _device_wave_run(prefetch, tiles, elems, batch, workers=2,
                     device="cuda"):
    """One wave-pipeline run: `tiles` independent device tasks, each
    staging a distinct Mem tile, batch_max=batch so the job executes as
    ~tiles/batch waves.  Returns (wave spans, device_stats, wall_s)."""
    tb = elems * 4
    rng = np.random.default_rng(11)
    src = rng.standard_normal((tiles, elems)).astype(np.float32)
    dst = np.zeros((tiles, elems), dtype=np.float32)
    with pt.Context(nb_workers=workers) as ctx:
        ctx.profile_enable(1)
        ctx.register_linear_collection("T", src, elem_size=tb)
        ctx.register_linear_collection("O", dst, elem_size=tb)
        ctx.register_arena("t", tb)
        dev = CudaDevice(ctx, device=device, autostart=False,
                         prefetch=prefetch)
        dev.batch_max = batch
        dev.start()
        tp = pt.Taskpool(ctx, globals={"NT": tiles - 1})
        k = pt.L("k")
        tc = tp.task_class("Wave")
        tc.param("k", 0, pt.G("NT"))
        tc.flow("X", "R", pt.In(pt.Mem("T", k)), arena="t")
        tc.flow("Y", "RW", pt.In(pt.Mem("O", k)), pt.Out(pt.Mem("O", k)),
                arena="t")
        dev.attach(tc, tp, kernel=_wave_kernel,
                   reads=["X", "Y"], writes=["Y"],
                   shapes={"X": (elems,), "Y": (elems,)},
                   dtype=np.float32)
        t0 = time.perf_counter()
        tp.run()
        tp.wait()
        dev.flush()
        wall = time.perf_counter() - t0
        ev = ctx.profile_take()
        stats = ctx.device_stats()
        dev.stop()
    waves = _pair_spans(ev, KEY_DEVICE)
    h2d_pf = _pair_spans(ev, KEY_H2D_AHEAD)
    stats.pop("devices", None)
    stats["trace_overlap_fraction"] = _overlap_fraction(h2d_pf, waves)
    return waves, stats, wall


def bench_device_pipeline(tiles=96, elems=32 * 1024, batch=8, reps=3,
                          device="cuda"):
    """Staged-vs-prefetched wave dispatch: the same wave workload with
    the prefetch lane off (every wave pays its h2d at dispatch) and on.
    Per-wave dispatch-time h2d stall comes off the DEVICE span's end aux
    (0 = a prefetch-hit wave); the overlap fraction pairs the lane's H2D
    spans against the dispatch spans."""

    def summarize(waves, stats, wall):
        stalls = np.array([w[3] for w in waves], dtype=np.float64)
        lat = np.array([w[1] - w[0] for w in waves], dtype=np.float64)
        hit = stalls == 0
        return {
            "waves": len(waves),
            "wall_s": round(wall, 4),
            "wave_p50_us": round(float(np.percentile(lat, 50)) / 1e3, 2)
            if len(lat) else None,
            "stall_per_wave_us": round(float(stalls.mean()) / 1e3, 2)
            if len(stalls) else None,
            "stall_total_ms": round(float(stalls.sum()) / 1e6, 3),
            "prefetch_hit_waves": int(hit.sum()),
            "staged_waves": int((~hit).sum()),
            "hit_wave_stall_us": round(float(stalls[hit].mean()) / 1e3, 3)
            if hit.any() else None,
            "staged_wave_stall_us":
                round(float(stalls[~hit].mean()) / 1e3, 2)
                if (~hit).any() else None,
            "device_stats": stats,
        }

    best_off = best_on = None
    for _ in range(reps):
        off = summarize(*_device_wave_run(False, tiles, elems, batch,
                                          device=device))
        on = summarize(*_device_wave_run(True, tiles, elems, batch,
                                         device=device))
        if best_off is None or off["stall_per_wave_us"] < \
                best_off["stall_per_wave_us"]:
            best_off = off
        if best_on is None or on["stall_total_ms"] < \
                best_on["stall_total_ms"]:
            best_on = on
    off_stall = best_off["stall_per_wave_us"] or 0.0
    hit_stall = best_on["hit_wave_stall_us"]
    reduction = None
    if off_stall > 0 and hit_stall is not None:
        reduction = round(1.0 - hit_stall / off_stall, 4)
    return {
        "tiles": tiles, "tile_bytes": elems * 4, "batch": batch,
        "reps": reps,
        "staged": best_off,
        "prefetched": best_on,
        # dispatch-time h2d stall of prefetch-hit waves vs the staged
        # baseline's per-wave stall (target >= 0.8)
        "hit_wave_stall_reduction": reduction,
        "total_stall_reduction": round(
            1.0 - best_on["stall_total_ms"] /
            max(best_off["stall_total_ms"], 1e-9), 4),
    }


def bench_device_ooc_gemm(m=512, n=512, k=64, mb=32, device="cuda"):
    """Out-of-core leg: a GEMM whose tile set is 2x the device byte
    budget (C alone exceeds it: dirty mirrors must spill through the
    writeback lane).  Evidence: completion, the result against numpy,
    nonzero spill counters, residency back under budget at the end."""
    from parsec_tpu_torch.algos import build_gemm
    from parsec_tpu_torch.data import TwoDimBlockCyclic
    rng = np.random.default_rng(3)
    with pt.Context(nb_workers=2) as ctx:
        A = TwoDimBlockCyclic(m, k, mb, mb, dtype=np.float32)
        B = TwoDimBlockCyclic(k, n, mb, mb, dtype=np.float32)
        Cc = TwoDimBlockCyclic(m, n, mb, mb, dtype=np.float32)
        A.from_dense(rng.standard_normal((m, k), dtype=np.float32))
        B.from_dense(rng.standard_normal((k, n), dtype=np.float32))
        Cc.from_dense(np.zeros((m, n), np.float32))
        A.register(ctx, "A")
        B.register(ctx, "B")
        Cc.register(ctx, "C")
        tile_set = (m * k + k * n + m * n) * 4
        budget = tile_set // 2
        dev = CudaDevice(ctx, device=device, cache_bytes=budget)
        tp = build_gemm(ctx, A, B, Cc, dev=dev)
        t0 = time.perf_counter()
        tp.run()
        tp.wait()
        dev.flush()
        wall = time.perf_counter() - t0
        stats = ctx.device_stats()
        used = dev._cache_used
        dev.stop()
        ref = A.to_dense() @ B.to_dense()
        err = float(np.abs(Cc.to_dense() - ref).max())
        correct = bool(np.allclose(Cc.to_dense(), ref, rtol=1e-3,
                                   atol=1e-3))
    stats.pop("devices", None)
    return {
        "m": m, "n": n, "k": k, "mb": mb,
        "tile_set_bytes": tile_set, "budget_bytes": budget,
        "budget_ratio": round(tile_set / budget, 2),
        "wall_s": round(wall, 3),
        "correct": correct, "max_abs_err": err,
        "spills": stats["spills"], "spill_bytes": stats["spill_bytes"],
        "reserve_fails": stats["reserve_fails"],
        "ooc_waits": stats["ooc_waits"],
        "end_residency_bytes": int(used),
        "device_stats": stats,
    }


def _fuse_gemm_run(fuse, m, k, nb, batch_wait_ms=2.0, device="cuda"):
    """One wave-fusion GEMM run: single-rank owner-computes k-chain
    (kt = k/nb waves of (m/nb)^2 Gemm tasks).  Returns (C dense, DEVICE
    launch count, fused-marked launch count, fuse counters, wall_s)."""
    from parsec_tpu_torch.algos import build_gemm
    from parsec_tpu_torch.data import TwoDimBlockCyclic
    from parsec_tpu_torch.utils import params as _mca
    _mca.set("device.wave_fuse", bool(fuse))
    try:
        rng = np.random.default_rng(5)
        with pt.Context(nb_workers=2) as ctx:
            A = TwoDimBlockCyclic(m, k, nb, nb, dtype=np.float32)
            B = TwoDimBlockCyclic(k, m, nb, nb, dtype=np.float32)
            Cc = TwoDimBlockCyclic(m, m, nb, nb, dtype=np.float32)
            A.from_dense(rng.standard_normal((m, k), dtype=np.float32))
            B.from_dense(rng.standard_normal((k, m), dtype=np.float32))
            Cc.from_dense(np.zeros((m, m), np.float32))
            A.register(ctx, "A")
            B.register(ctx, "B")
            Cc.register(ctx, "C")
            ctx.profile_enable(1)
            dev = CudaDevice(ctx, device=device)
            # coalesce whole waves per pop: launch economics, not
            # pop-timing luck, is under test
            dev.batch_wait_ms = batch_wait_ms
            tp = build_gemm(ctx, A, B, Cc, dev=dev)
            t0 = time.perf_counter()
            tp.run()
            tp.wait()
            dev.flush()
            wall = time.perf_counter() - t0
            ev = ctx.profile_take()
            stats = ctx.device_stats()
            dev.stop()
            out = Cc.to_dense().copy()
        spans = _pair_spans(ev, KEY_DEVICE)
        fused_marked = sum(1 for s in spans if s[4] > 0)
        return out, len(spans), fused_marked, stats["fuse"], wall
    finally:
        _mca.unset("device.wave_fuse")


def bench_device_fuse_gemm(m=128, k=512, nb=32, reps=3, device="cuda"):
    """Wave fusion: the same deep-k GEMM with the wave compiler on
    (certified waves and chains as one launch each; downstream waves
    complete from parked results with no launch) and off
    (device.wave_fuse=0).  Launch counts come off paired DEVICE spans;
    the gate is >= 5x fewer launches at bit-identical results."""
    tasks = (m // nb) ** 2 * (k // nb)
    best_f = best_u = None
    bit_identical = True
    fuse_stats = None
    for _ in range(reps):
        cf, lf, marked, fs, wf = _fuse_gemm_run(True, m, k, nb,
                                                device=device)
        cu, lu, _, _, wu = _fuse_gemm_run(False, m, k, nb, device=device)
        bit_identical = bit_identical and \
            (cf.tobytes() == cu.tobytes())
        # fewest launches first, then wall
        if best_f is None or (lf, wf) < (best_f[0], best_f[2]):
            best_f = (lf, marked, wf)
            fuse_stats = fs
        if best_u is None or (lu, wu) < best_u:
            best_u = (lu, wu)
    launches_f, marked, wall_f = best_f
    launches_u, wall_u = best_u
    return {
        "m": m, "k": k, "nb": nb, "reps": reps,
        "tasks": tasks,
        "waves": k // nb,
        "launches_fused": launches_f,
        "launches_unfused": launches_u,
        "fused_marked_launches": marked,
        "launches_per_task": round(launches_f / tasks, 5),
        "fused_vs_unfused_ratio": round(launches_u
                                        / max(1, launches_f), 2),
        "bit_identical": bit_identical,
        "wall_fused_s": round(wall_f, 4),
        "wall_unfused_s": round(wall_u, 4),
        "fuse_stats": {kk: vv for kk, vv in (fuse_stats or {}).items()},
    }


def bench_device_suite(tiles=96, elems=32 * 1024, batch=8, reps=3,
                       gemm_m=512, gemm_k=64, gemm_mb=32, device="cuda"):
    """The device document: staged-vs-prefetched wave latency and overlap
    evidence, the 2x-budget out-of-core GEMM, wave fusion's launches, and
    host provenance (the pipeline threads — workers, manager, writeback
    and prefetch lanes — timeshare on small hosts, which is flagged)."""
    from parsec_tpu_torch.utils import params as _mca
    device = str(torch_device(str(device)))
    workers = 2
    threads = workers + 3  # manager + writeback + prefetch lanes
    doc = {
        "bench": "device",
        **host_provenance(threads=threads),
        "knobs": {
            "prefetch_depth": _mca.get("device.prefetch_depth"),
            "staging_slots": _mca.get("device.staging_slots"),
            "out_of_core": _mca.get("device.out_of_core"),
            "overcommit": _mca.get("device.overcommit"),
        },
        "wave_pipeline": bench_device_pipeline(tiles, elems, batch, reps,
                                               device=device),
        "out_of_core_gemm": bench_device_ooc_gemm(
            m=gemm_m, n=gemm_m, k=gemm_k, mb=gemm_mb, device=device),
        # >= 5x fewer DEVICE launches at bit-identical results
        "wave_fuse": bench_device_fuse_gemm(device=device),
    }
    if doc["oversubscribed"]:
        doc["caveat"] = (
            f"pipeline threads ({threads}) > cores "
            f"({doc['host']['cpu_count']}): the "
            "prefetch lane timeshares with the manager, so the overlap "
            "fraction measures scheduling luck, not true concurrency — "
            "stall accounting (what moved OFF the dispatch path) "
            "remains valid")
        sys.stderr.write(f"bench-device WARNING: {doc['caveat']}\n")
    return doc
