"""The headline: DPLASMA-style spotrf GFLOP/s on the card (bench.py's
default run and `--spotrf-child`).

The matrix is generated in place on the device and verified by its
residual; the timed section is the factorization (dispatch, execution,
on-device data movement) after a small warm-up pass.  `vs_baseline` is
the run's GFLOP/s over torch.linalg.cholesky's (cuSOLVER on the card) at
the same N, on the same matrix, in the same process; the line names that
yardstick under "baseline".

The headline climbs the reference's ladder, (4096..65536, NB 512), one
child process per rung on the card, within PTC_BENCH_TIMEOUT_S (480 s):
a rung the card's memory cannot hold is reported skipped, a rung that
times out keeps the best completed one, and no card, a failed child or
no completed rung is a non-zero exit with no metric line.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

from .common import (_arg_after, _chip_info, _device_hbm, _spotrf_fits,
                     device_choice, torch_device)

_LAST_POTRF_INFO = None  # per-rung dispatch evidence (see _potrf_once)

# the reference's ladder toward BASELINE.json's N = 65536, NB = 512, and
# each rung's time cap (s; the last rung takes what is left)
LADDER = ((4096, 512), (8192, 512), (16384, 512), (32768, 512),
          (65536, 512))
CAPS = (180, 240, 360, 600, None)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _potrf_once(N, nb, seed=0, check=False, profile=False,
                variant="panel", device="cuda"):
    """One spotrf run with device-resident data on a CudaDevice on
    `device`; returns (seconds, residual).

    variant="panel" (default): build_potrf_panels — full-height N x nb
    panel tasks, each trailing update one product, a wave one launch.
    variant="tile": the tiled dpotrf_L DAG, nb x nb tasks."""
    import parsec_tpu_torch as pt
    from parsec_tpu_torch.algos import build_potrf, build_potrf_panels
    from parsec_tpu_torch.data import TwoDimBlockCyclic
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.device.bench_utils import (
        generate_spd_on_device, generate_spd_panels_on_device,
        potrf_residual, wait_device_tiles)
    workers = int(os.environ.get("PTC_BENCH_WORKERS", "4"))
    cache_gb = os.environ.get("PTC_BENCH_CACHE_GB")
    # wide batches keep whole waves in one stack: consumers take one
    # slice and launches stay O(waves), not O(tasks)
    os.environ.setdefault("PTC_DEVICE_BATCH", "512")
    hbm = _device_hbm(device)
    with pt.Context(nb_workers=workers) as ctx:
        if variant == "panel":
            A = TwoDimBlockCyclic(N, N, N, nb, dtype=np.float32)
        else:
            A = TwoDimBlockCyclic(N, N, nb, nb, dtype=np.float32)
        A.register(ctx, "A")
        if cache_gb is not None:
            cache_bytes = int(cache_gb) << 30
        else:
            # the tile cache from the device's memory: the generated
            # matrix, the launches' transients and the library workspace
            # take their share, and a budget above the memory would
            # never evict dead tile versions
            cache_bytes = max(2 << 30, int(hbm - N * N * 4 - (3 << 30)))
            # the per-launch byte cap from the same headroom: the in and
            # out stacks of one launch fit beside the matrix
            os.environ.setdefault(
                "PTC_DEVICE_BATCH_BYTES",
                str(max(1 << 30, int(hbm - N * N * 4 - (3 << 30)) // 3)))
        dev = CudaDevice(ctx, device=device, cache_bytes=cache_bytes)
        t_g0 = time.perf_counter()
        if variant == "panel":
            a_stacked = generate_spd_panels_on_device(dev, A, seed=seed)
        else:
            a_stacked = generate_spd_on_device(dev, A, seed=seed)
        wait_device_tiles(dev, A)
        t_g1 = time.perf_counter()
        if variant == "panel":
            tp = build_potrf_panels(ctx, A, dev=dev)
        else:
            tp = build_potrf(ctx, A, dev=dev)
        t0 = time.perf_counter()
        tp.run()
        tp.wait()
        t_w = time.perf_counter()
        # all tasks enqueued; done when every tile's device value lands
        wait_device_tiles(dev, A)
        _sync(device)
        dt = time.perf_counter() - t0
        # per-rung evidence: device-call count, dispatch counters, wall
        # breakdown
        sd = dev.stats
        singles = sd["tasks"] - sd.get("batched_tasks", 0) \
            - sd.get("spec_hits", 0)
        global _LAST_POTRF_INFO
        _LAST_POTRF_INFO = {
            "device_calls": sd.get("batches", 0) + max(0, singles),
            "counters": {k: sd.get(k, 0) for k in
                         ("tasks", "batches", "batched_tasks",
                          "fused_flows", "eager_gathers", "h2d_bytes",
                          "d2h_bytes", "wb_tasks", "spec_hits",
                          "spec_store", "spec_misses")},
            "wall": {"gen_s": round(t_g1 - t_g0, 3),
                     "enqueue_s": round(t_w - t0, 3),
                     "total_s": round(dt, 3)},
        }
        if profile:
            s = dev.stats
            sys.stderr.write(
                f"[profile] N={N} nb={nb} gen={t_g1 - t_g0:.2f}s "
                f"enqueue={t_w - t0:.2f}s total={dt:.2f}s "
                f"tasks={s['tasks']} batches={s.get('batches', 0)} "
                f"batched={s.get('batched_tasks', 0)} "
                f"fused={s.get('fused_flows', 0)} "
                f"eager={s.get('eager_gathers', 0)} "
                f"h2d={s['h2d_bytes']} d2h={s['d2h_bytes']} "
                f"wb={s.get('wb_tasks', 0)} "
                f"spec={s.get('spec_hits', 0)}/"
                f"{s.get('spec_store', 0)}\n")
        resid = 0.0
        if check:
            # the reference's rule: check where seven matrices fit in
            # the device's memory (the port's residual holds two dense
            # matrices beside the cache); skip honestly otherwise
            if 7.0 * N * N * 4 <= hbm:
                resid = potrf_residual(dev, A, a_stacked)
            else:
                resid = None
                sys.stderr.write(
                    f"[resid] N={N}: exact check needs "
                    f"~{7.0 * N * N * 4 / 2**30:.0f} GiB, device memory "
                    f"is {hbm / 2**30:.0f} GiB - skipped (verified at "
                    "smaller rungs)\n")
        del a_stacked
        dev.stop()
    # the context and device just left scope: collect now so the next
    # rep's allocations do not race the old rep's tensors
    gc.collect()
    _empty_cache(device)
    return dt, resid


def _empty_cache(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def bench_spotrf(N=16384, nb=1024, reps=2, variant="panel", device="cuda",
                 out=None):
    """spotrf GFLOP/s of the best of `reps` runs at N, nb after a small
    warm-up run; the first run's residual must be <= 1e-2 and finite
    (RuntimeError otherwise).  `out`, a dict, receives the residual."""
    from parsec_tpu_torch.algos import potrf_flops
    device = str(torch_device(str(device)))
    profile = bool(os.environ.get("PTC_BENCH_PROFILE"))
    # warm up small: the runtime, import and device paths (never bigger
    # than the measured run)
    warm_n = min((4 if variant == "panel" else 16) * nb, N)
    _potrf_once(warm_n, nb, seed=1, variant=variant, device=device)
    best = None
    resid = None
    for rep in range(reps):
        dt, r = _potrf_once(N, nb, seed=0, check=(rep == 0),
                            profile=profile, variant=variant, device=device)
        if rep == 0:
            resid = r
        if best is None or dt < best:
            best = dt
    if resid is not None and (resid > 1e-2 or not np.isfinite(resid)):
        raise RuntimeError(f"spotrf residual check failed: {resid}")
    if out is not None:
        out["residual"] = resid
    return potrf_flops(N) / best / 1e9


def cholesky_baseline(N, nb, device="cuda", seed=0, reps=3) -> dict:
    """torch.linalg.cholesky (cuSOLVER on the card) on the same SPD
    matrix the runs factor (bench_utils' generator, seed 0) as one dense
    N x N float32 tensor on `device`: median ms of `reps` calls after
    one untimed call (CUDA events on the card) and its GFLOP/s."""
    import torch

    from parsec_tpu_torch.algos import potrf_flops
    from parsec_tpu_torch.device.bench_utils import _spd_blocks
    from parsec_tpu_torch.tools import median_s
    dev = torch.device(device)
    a = torch.empty((N, N), dtype=torch.float32, device=dev)
    for m, n, blk in _spd_blocks(seed, N // nb, nb, N, dev):
        a[m * nb:(m + 1) * nb, n * nb:(n + 1) * nb] = blk
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        s = median_s(lambda: torch.linalg.cholesky(a), dev, reps=reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    del a
    _empty_cache(dev)
    return {"name": "torch.linalg.cholesky", "ms": round(s * 1e3, 3),
            "gflops": round(potrf_flops(N) / s / 1e9, 1)}


def spotrf_child(argv) -> int:
    """`--spotrf-child --n N --nb NB [--tiled] [--device D]`: one rung,
    its JSON line on stdout (a `skipped` line when the device's memory
    cannot hold it)."""
    device = str(torch_device(device_choice(argv)))
    n = _arg_after("--n", 16384, argv)
    nb = _arg_after("--nb", 1024, argv)
    hbm = _device_hbm(device)
    ok, need_gib = _spotrf_fits(n, hbm)
    kind, peak, watts = _chip_info(device)
    if not ok:
        # a rung that cannot fit is reported as a completed step
        print(json.dumps({
            "metric": "spotrf_gflops_per_chip", "value": None,
            "unit": "GFLOP/s",
            "skipped": f"N={n} fp32 needs ~{need_gib:.0f}"
                       f" GiB, device memory is {hbm / 2**30:.0f} GiB",
            "config": {"N": n, "NB": nb},
            "chip_kind": kind,
        }))
        return 0
    variant = "tile" if "--tiled" in argv else "panel"
    extra = {}
    gflops = bench_spotrf(n, nb, variant=variant, device=device, out=extra)
    base = cholesky_baseline(n, nb, device)
    line = {
        "metric": "spotrf_gflops_per_chip",
        "value": round(gflops, 1),
        "unit": "GFLOP/s",
        "vs_baseline": round(gflops / base["gflops"], 4),
        "config": {"N": n, "NB": nb, "variant": variant},
        "chip_kind": kind,
        "power_limit_w": watts,
        "chip_fp32_matmul_gflops": round(peak, 1),
        "frac_of_chip_matmul": round(gflops / peak, 3) if peak else None,
        "baseline": base,
        "residual": extra.get("residual"),
    }
    # per-rung dispatch evidence from the measured (last) rep
    if _LAST_POTRF_INFO is not None:
        line.update(_LAST_POTRF_INFO)
    print(json.dumps(line))
    return 0


def headline(argv) -> int:
    """The default run: the ladder, each rung a `--spotrf-child` process
    on the chosen device, the largest completed rung's line printed."""
    device = device_choice(argv)
    dev = torch_device(device)  # raises without a card
    hbm = _device_hbm(dev)
    budget = int(os.environ.get("PTC_BENCH_TIMEOUT_S", "480"))
    deadline = time.monotonic() + budget
    # NB=512 first: the smallest rung leads with a tight cap; larger N
    # supersedes
    ladder, caps = list(LADDER), list(CAPS)
    if os.environ.get("PTC_BENCH_N"):
        ladder = [(int(os.environ["PTC_BENCH_N"]),
                   int(os.environ.get("PTC_BENCH_NB", "512")))]
        caps = [None]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    best_line = None
    for (n, nb), cap in zip(ladder, caps):
        remaining = deadline - time.monotonic()
        if remaining < 60:
            break
        ok, need_gib = _spotrf_fits(n, hbm)
        if not ok:
            sys.stderr.write(f"spotrf rung N={n} skipped: needs "
                             f"~{need_gib:.0f} GiB, device memory is "
                             f"{hbm / 2**30:.0f} GiB\n")
            continue
        if cap is not None:
            remaining = min(remaining, cap)
        child_argv = [sys.executable, "-m", "parsec_tpu_torch.bench",
                      "--spotrf-child", "--n", str(n), "--nb", str(nb),
                      "--device", device]
        if "--tiled" in argv:
            child_argv.append("--tiled")
        try:
            r = subprocess.run(child_argv, cwd=root, timeout=remaining,
                               capture_output=True, text=True)
        except subprocess.TimeoutExpired:
            sys.stderr.write(f"spotrf child N={n} exceeded budget; "
                             "keeping best completed rung\n")
            break
        got = None
        for ln in reversed((r.stdout or "").strip().splitlines()):
            if ln.startswith("{"):
                got = ln
                break
        if r.returncode != 0 or got is None:
            sys.stderr.write(f"spotrf child N={n} failed "
                             f"(rc={r.returncode}): "
                             f"{(r.stderr or '')[-2000:]}\n")
            return 1
        sys.stderr.write(f"spotrf child N={n}: {got}\n")
        if json.loads(got).get("skipped"):
            continue
        best_line = got  # larger N supersedes
    if best_line is None:
        sys.stderr.write("spotrf: no rung completed\n")
        return 1
    print(best_line)
    return 0
