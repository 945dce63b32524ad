#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (parsec_tpu_torch) on one card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; no phase swallows an exception):
  1. print the card's name and power limit (nvidia-smi) and build every
     kernel from kernels/*.cu (one nvcc per source, all at once)
  2. hold each kernel against its plain PyTorch version on the card at
     the main path's shapes, with the tolerance stated beside each check
  3. time each kernel, its plain version and, as a yardstick only, one
     PyTorch library call computing the same function (CUDA events)
  4. drive the main path Context -> Taskpool -> CudaDevice -> kernel
     through GEMM, NORM and FATT at full width, check each result
     against the plain computation on the card, and check from the
     device stats and the launch counters that the kernels ran there
  5. drive the serving path at Llama-2-7B attention widths (PagedLM
     vocab 32000, d 4096, 32 heads, page 16): 8 requests of 256..2048
     tokens over two tenants, two sharing a 1024-token prefix, 8 new
     tokens each, then a spec_k=2 run; every output is checked against
     a float64 oracle on the engine's own token stream, every token
     against the oracle's argmax, and the device and prefix counters
     against what the run must have done
  6. drive the dense linear algebra on the card (phase 6, f32, matrices
     generated on the device): the north-star spotrf as the panel DAG
     with its speculative epilogue at N=32768, NB=512, then POSV on its
     factor, the tiled spotrf at N=16384, NB=1024, the panel LU at
     N=16384, and TRSM, TRTRI, LAUUM, POTRI, GEQRF, the tiled LU and the
     tiled spotrf's solve dataflow at N=8192, NB=512; each checked by its
     residual or against one PyTorch call on the card, spotrf also timed
     against torch.linalg.cholesky (cuSOLVER); then every chore the phase
     launched is timed at its path's shape beside its bound, and
     POTRF-P's flush is printed in GB/s
  7. drive the device pipeline (pipeline_path): phase 4's NORM with the
     prefetch lane off and on, three runs each in turns, every output
     held to the plain version and to the first run's bits, the lane's
     hits required; then GEMM at N=8192 in 1024^2 tiles resident and
     out-of-core at half its tile set (spills required, C against
     torch.matmul), and NORM out-of-core at half its O, bit-identical
  8. drive the DSL front ends on phase 4's data (dsl_path), each in a
     fresh context: GEMM as 512 DTD device tasks (INOUT chains of 8 on
     each C tile), NORM and FATT as 32 DTD device tasks each (one
     kernel launch a task, required), NORM as a JDF class with a
     BODY [type=CUDA] (batched) compiled with dev=, and a host DTD body
     reading a device task's tile; before each DTD run phase 4's PTG pool
     of the path runs again, warm, as its yardstick; each held to its
     plain version at phase 4's tolerance, NORM also beside phase 4's
     PTG output bit for bit; each run's wall, tasks and kernel launches
     printed
  9. drive the rest of the one-rank runtime (runtime_path) and read its
     own trace: phase 4's GEMM, NORM and FATT pools traced at level 2,
     the DEVICE_DISPATCH and DEVICE_H2D spans held to the device's
     stats and the kernels' launches, the trace saved and loaded back,
     per class its dispatch time and stall, critical path and lost
     time, NORM's wall traced and untraced in turns; a recursive
     Cholesky of one 8192^2 tile over 512^2 sub-tiles on the card; a
     composed potrf, trtri, lauum against run_potri; POTRF-T's
     device-dirty factor regridded, cast to float16 and column-reduced
     on the host; two devices on the card routed by affinity and by
     weight
Then print the dense-LA line, the pipeline line, the DSL line, the
runtime line and the kernels line (JSON; the kernels' launches are
phase 4's, phase 7's, phase 8's and phase 9's) and, last, the device
line (JSON).
Exits non-zero, printing no result, when there is no CUDA card.
"""
from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 0
EPS = 1e-6
# card peaks for the bounds, by the name nvidia-smi reports (NVIDIA data
# sheets, dense rates): bytes/s, float32 FLOP/s on the CUDA cores, TF32
# FLOP/s on the tensor cores (the sheets' sparse TF32 figure halved)
PEAKS = {"PCIe": (2.0e12, 51.0e12, 378.0e12),
         "NVL": (3.9e12, 60.0e12, 417.5e12),
         "SXM": (3.35e12, 67.0e12, 495.0e12)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, PEAKS[key]
    return "SXM", PEAKS["SXM"]


_TYPES = {"f": "float", "13__nv_bfloat16": "bf16", "6__half": "f16"}


def _template_args(mangled: str) -> str:
    """`<float, 128>` for a mangled kernel template instantiation."""
    m = re.search(r"kernelI(.*?)EEv", mangled)
    if m is None:
        return mangled
    args = []
    for tok in re.findall(r"13__nv_bfloat16|6__half|S1_|Li\d+E|f",
                          m.group(1)):
        args.append(args[0] if tok == "S1_" else
                    tok[2:-1] if tok.startswith("Li") else _TYPES[tok])
    return f"<{', '.join(args)}>"


def ptxas_summary(report: str):
    """One line per kernel instantiation of an nvcc -Xptxas -v report:
    its mangled template arguments, registers, spills and stack."""
    out, props = [], ""
    for line in report.splitlines():
        line = line.strip()
        if "bytes stack frame" in line:
            props = line
        elif line.startswith("ptxas info    : Used"):
            out.append(f"{line.split(': ', 1)[1]}; {props}")
        elif "Compiling entry function" in line:
            out.append(_template_args(line.split("'")[1]))
    return [f"{a}: {b}" for a, b in zip(out[::2], out[1::2])]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over `iters` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(what: str, got, want, rtol: float, atol: float) -> float:
    """Max |got - want| after asserting |got - want| <= atol + rtol*|want|
    everywhere (float32 comparison)."""
    import torch
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{what}: shape {tuple(g.shape)} != "
                             f"{tuple(w.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite values")
    diff = (g - w).abs()
    bad = diff > atol + rtol * w.abs()
    err = float(diff.max())
    log(f"  {what}: max_abs_err={err:.3e} (rtol={rtol:g}, atol={atol:g})")
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside "
                             f"the tolerance, max_abs_err={err:.3e}")
    return err


def main_path(rng, dev_t, drive) -> np.ndarray:
    """The port's main path at full width: GEMM, NORM and FATT taskpools
    through Context -> Taskpool -> CudaDevice, each run by
    drive(label, tp, dev, ntasks) -> launch counts of that run, then
    checked against the plain computation on the card.  Returns NORM's
    O (host), which phase 8 holds its DSL runs of NORM against."""
    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch.algos import build_gemm
    from parsec_tpu_torch.convert import to_collection, to_tensor
    from parsec_tpu_torch.device import CudaDevice
    # the modules (the ops package exports functions of the same names)
    fa_mod = importlib.import_module("parsec_tpu_torch.ops.flash_attention")
    rn_mod = importlib.import_module("parsec_tpu_torch.ops.rms_norm")
    rows, d = 8 * 4096, 4096
    L, H, D = 4096, 32, 128
    scale = D ** -0.5

    # GEMM: 4096x4096 f32, 512x512 tiles, 8*8*8 = 512 tasks
    n, nb = 4096, 512
    a = rng.standard_normal((n, n), dtype=np.float32)
    b = rng.standard_normal((n, n), dtype=np.float32)
    with pt.Context(nb_workers=4) as ctx:
        A, B = to_collection(a, nb, nb), to_collection(b, nb, nb)
        C = to_collection(np.zeros((n, n), np.float32), nb, nb)
        A.register(ctx, "A")
        B.register(ctx, "B")
        C.register(ctx, "C")
        dev = CudaDevice(ctx)
        drive("GEMM 4096^2 f32, 512^2 tiles", build_gemm(ctx, A, B, C, dev),
              dev, 512)
        if dev.stats["h2d_hits"] <= 0:
            raise AssertionError("GEMM: no device cache hit")
        want = torch.matmul(to_tensor(a, dev_t), to_tensor(b, dev_t))
        # f32 products, sums of 4096 terms in another order
        check_close("GEMM C vs torch.matmul", to_tensor(C.to_dense(), dev_t),
                    want, 1e-4, 1e-3)
        dev.stop()
    del a, b, want

    # NORM: X, O 32768x4096 f32 tiled (1024, 4096); W one (1, 4096) tile
    T = 1024
    xn = rng.standard_normal((rows, d), dtype=np.float32)
    wn = rng.standard_normal((1, d), dtype=np.float32)
    with pt.Context(nb_workers=4) as ctx:
        Xc, Wc = to_collection(xn, T, d), to_collection(wn, 1, d)
        Oc = to_collection(np.zeros_like(xn), T, d)
        dev = CudaDevice(ctx)
        got = drive("NORM 32768x4096 f32, T=1024",
                    rn_mod.build_rms_norm(ctx, Xc, Wc, Oc, EPS, dev=dev),
                    dev, rows // T)
        if got["rms_norm"] <= 0:
            raise AssertionError("NORM: the rms_norm kernel never ran")
        norm_o = Oc.to_dense()
        check_close("NORM O vs plain", to_tensor(norm_o, dev_t),
                    rn_mod.rms_norm_plain(to_tensor(xn, dev_t),
                                          to_tensor(wn[0], dev_t), EPS),
                    2e-5, 2e-5)
        dev.stop()
    del xn, Xc, Oc

    # FATT: Q, O (32*4096)x128 f32 tiled (4096, 128); K, V one (4096, 128)
    # tile: 32 query heads over one shared KV head
    qn = rng.standard_normal((H * L, D), dtype=np.float32)
    kn = rng.standard_normal((L, D), dtype=np.float32)
    vn = rng.standard_normal((L, D), dtype=np.float32)
    with pt.Context(nb_workers=4) as ctx:
        Qc, Kc, Vc = (to_collection(qn, L, D), to_collection(kn, L, D),
                      to_collection(vn, L, D))
        Oc = to_collection(np.zeros_like(qn), L, D)
        dev = CudaDevice(ctx)
        got = drive("FATT 32x4096x128 f32, shared K/V",
                    fa_mod.build_flash_attention(ctx, Qc, Kc, Vc, Oc,
                                                 dev=dev), dev, H)
        if got["flash_attention"] <= 0:
            raise AssertionError("FATT: the flash kernel never ran")
        kt, vt = to_tensor(kn, dev_t), to_tensor(vn, dev_t)
        want = fa_mod.attention_reference(
            to_tensor(qn, dev_t).reshape(H, L, D),
            kt.unsqueeze(0).expand(H, L, D), vt.unsqueeze(0).expand(H, L, D),
            False, scale)
        check_close("FATT O vs plain", to_tensor(Oc.to_dense(), dev_t)
                    .reshape(H, L, D), want, 2e-5, 2e-5)
        dev.stop()
    return norm_o


# phase 6 sizes: (N, NB) per path; the tiled group shares one (N, NB).
# DENSE_WARM: the untimed first pass at the same NB, which pays the
# libraries' first-use costs (cuSOLVER and cuBLAS handles and workspaces
# on the managers' streams, lazily loaded kernels: 2219 vs 397 ms for a
# cold vs a warm POTRF-P at N=16384 on the H100), as the reference
# bench's warm-up does
DENSE = {"potrf_p": (32768, 512), "posv_nrhs": 512,
         "potrf_t": (16384, 1024), "getrf_p": (16384, 512),
         "tiled": (8192, 512)}
DENSE_WARM = {"potrf_p": (2048, 512), "posv_nrhs": 512,
              "potrf_t": (4096, 1024), "getrf_p": (2048, 512),
              "tiled": (2048, 512)}


def sync(dev_t) -> None:
    if dev_t.type == "cuda":
        import torch
        torch.cuda.synchronize(dev_t)


def timed_ms(dev_t, fn, iters: int, warmup: int = 1) -> float:
    """time_ms on the card; on the CPU (a rehearsal) the host clock."""
    if dev_t.type == "cuda":
        return time_ms(fn, iters, warmup)
    for _ in range(warmup):
        fn()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) * 1e3 / iters


def as_tiles(dense, mb: int, nb: int):
    """(M, N) dense -> (mt*nt, mb, nb) row-major tiles (the inverse of
    bench_utils.assemble_dense)."""
    M, N = dense.shape
    return dense.reshape(M // mb, mb, N // nb, nb).permute(0, 2, 1, 3) \
        .reshape(-1, mb, nb).contiguous()


def chore_flops(name: str, lanes: int, nb: int, n: int, r: int) -> float:
    """Floating-point operations of one launch of a dense-LA chore over
    `lanes` lanes: tiles nb x nb, panels n x nb, right-hand sides n x r.
    Counted as the chore computes (a full product where it forms one;
    LAPACK's counts for the factorizations)."""
    c = nb ** 3
    per_lane = {
        "k_potrf": c / 3, "k_potrf_inv": 2 * c / 3, "k_trsm": c,
        "k_trsm_mm": 2 * c, "k_syrk": 2 * c, "k_gemm": 2 * c,
        "k_solve": c, "k_update": 2 * c,
        "k_getrf_nopiv": 2 * c / 3, "k_trsm_l": c, "k_trsm_u": c,
        "k_gemm_lu": 2 * c, "k_tri_inv": c / 3, "k_acc_ab": 2 * c,
        "k_mul_ab": 2 * c, "k_neg_mul": 2 * c, "k_acc_atb": 2 * c,
        "k_geqrt": 8 * c / 3, "k_unmqr": 2 * c, "k_tsqrt": 38 * c / 3,
        "k_tsmqr": 8 * c,
        "k_panel_factor": 2 * c / 3 + 2 * n * nb * nb,
        "k_panel_update": 2 * n * nb * nb,
        "k_panel_fwd": nb * nb * r + 2 * n * nb * r,
        "k_panel_bwd": nb * nb * r + 2 * n * nb * r,
        "k_panel_getrf": 2 * c / 3 + n * nb * nb,
        "k_panel_getrf_update": c + 2 * n * nb * nb}[name]
    return lanes * per_lane


def chore_inputs(name: str, lanes: int, nb: int, n: int, r: int, dev_t):
    """Inputs of one launch of a chore at the path's shape, random but of
    the structure the path gives it (SPD tiles for a Cholesky, a
    well-conditioned factor for a solve); a flow every lane of the path
    reads is one tile at lane stride 0.  Returns (inputs, library call
    computing the same function in one PyTorch call, or None)."""
    import torch
    g = torch.Generator(device=dev_t)
    g.manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev_t)

    def spd(k):
        a = rnd(k, nb, nb)
        return a @ a.mT + nb * torch.eye(nb, device=dev_t)

    def low(k):
        return torch.tril(rnd(k, nb, nb)) + 2 * nb * torch.eye(
            nb, device=dev_t)

    def shared(t):
        return t.expand(lanes, *t.shape[1:])

    def panels(dominant):
        blocks = n // nb
        p = rnd(lanes, n, nb)
        ks = torch.tensor([[i % blocks] for i in range(lanes)],
                          dtype=torch.int32, device=dev_t)
        for i in range(lanes):
            k = i % blocks
            p[i, k * nb:(k + 1) * nb] = (low(1)[0] if dominant else
                                         spd(1)[0])
        return p, ks

    t, s = rnd(lanes, nb, nb), rnd(lanes, nb, nb)
    L = torch.linalg
    if name in ("k_potrf", "k_potrf_inv"):
        a = spd(lanes)
        return [a], (lambda: L.cholesky(a)) if name == "k_potrf" else None
    if name in ("k_trsm", "k_trsm_mm", "k_solve", "k_trsm_l", "k_trsm_u",
                "k_unmqr", "k_neg_mul"):
        # the factor every lane of the wave reads: lower, or upper for
        # k_trsm_u (the U of a packed LU)
        f = shared(low(1).mT.contiguous() if name == "k_trsm_u"
                   else low(1))
        lib = {"k_trsm": lambda: L.solve_triangular(f.mT, t, upper=True,
                                                    left=False),
               "k_trsm_mm": lambda: torch.matmul(t, f.mT),
               "k_solve": lambda: L.solve_triangular(f, t, upper=False),
               "k_trsm_l": lambda: L.solve_triangular(
                   f, t, upper=False, unitriangular=True),
               "k_trsm_u": lambda: L.solve_triangular(
                   f, t, upper=True, left=False),
               "k_unmqr": lambda: torch.matmul(f.mT, t)}.get(name)
        return [f, t], lib
    if name in ("k_syrk",):
        return [t, s], lambda: torch.baddbmm(s, t, t.mT, alpha=-1)
    if name in ("k_gemm", "k_update", "k_gemm_lu", "k_acc_ab", "k_acc_atb"):
        c = rnd(lanes, nb, nb)
        tb = {"k_gemm": s.mT, "k_update": s, "k_gemm_lu": s, "k_acc_ab": s,
              "k_acc_atb": s}[name]
        ta = t.mT if name == "k_acc_atb" else t
        alpha = -1 if name in ("k_gemm", "k_update", "k_gemm_lu") else 1
        return [t, s, c], lambda: torch.baddbmm(c, ta, tb, alpha=alpha)
    if name == "k_mul_ab":
        return [t, s], lambda: torch.matmul(t, s)
    if name == "k_getrf_nopiv":
        a = low(lanes) + rnd(lanes, nb, nb)
        return [a], (lambda: L.lu_factor_ex(a, pivot=False)) \
            if a.is_cuda else None
    if name == "k_tri_inv":
        a = low(lanes)
        return [a], lambda: L.solve_triangular(
            a, torch.eye(nb, device=dev_t).expand_as(a), upper=False)
    if name == "k_geqrt":
        return [t], lambda: L.qr(t, mode="complete")
    if name == "k_tsqrt":
        return [torch.triu(t), s], None
    if name == "k_tsmqr":
        q2 = shared(L.qr(rnd(1, 2 * nb, 2 * nb))[0])
        return [q2, t, s], None
    if name in ("k_panel_factor", "k_panel_getrf"):
        p, ks = panels(name == "k_panel_getrf")
        return [p, ks], None
    if name in ("k_panel_update", "k_panel_getrf_update"):
        p, ks = panels(name == "k_panel_getrf_update")
        idx = shared(ks[:1]) if name == "k_panel_getrf_update" else ks
        return [shared(p[:1]), idx, rnd(lanes, n, nb)], None
    if name in ("k_panel_fwd", "k_panel_bwd"):
        p, ks = panels(True)
        return [p, ks, rnd(lanes, n, r)], None
    raise KeyError(name)


def dense_la_path(dev_t, dims=None, observe=None) -> dict:
    """Phase 6: the dense linear-algebra builders through Context ->
    Taskpool -> CudaDevice on `dev_t`, f32, seed SEED, matrices generated
    on the device: POTRF-P (the headline spotrf, panels, speculative
    epilogue) then POSV-P on its factor, POTRF-T, GETRF-P, and at the
    tiled size POTRF-T (solve dataflow), GETRF-T, TRSM, TRTRI, LAUUM,
    POTRI and GEQRF, each checked (residual, or against one PyTorch call
    on the same device at the tolerance beside it) and its device task
    count against the DAG's.  The whole phase first runs once at
    DENSE_WARM, untimed and checked all the same.  observe(label, fn)
    runs each timed taskpool run (a profiler may wrap it).  Returns the
    numbers the smoke prints: per path its walls and stats, per chore
    its launches and the path's shape."""
    t = time.perf_counter()
    _dense_paths(dev_t, DENSE_WARM, None, lambda msg: None)
    log(f"  warm-up pass at {DENSE_WARM} (untimed, checked): "
        f"{time.perf_counter() - t:.1f} s")
    return _dense_paths(dev_t, dims or DENSE, observe, log)


def _dense_paths(dev_t, dims, observe, say) -> dict:
    """dense_la_path's one pass at `dims`; say(msg) prints."""
    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch.algos import (build_geqrf, build_getrf_nopiv,
                                        build_getrf_panels, build_lauum,
                                        build_potrf, build_potrf_panels,
                                        build_potrs_panels, build_trsm,
                                        build_trtri, getrf_flops,
                                        potrf_flops, run_potri)
    from parsec_tpu_torch.data import TwoDimBlockCyclic
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.device.bench_utils import (
        assemble_dense, device_tiles, gather_device_tiles,
        generate_spd_on_device,
        generate_spd_panels_on_device, install_device_tiles,
        potrf_residual, wait_device_tiles)
    if observe is None:
        def observe(label, fn):
            fn()
    if dev_t.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32 or
                                 torch.get_float32_matmul_precision()
                                 != "highest"):
        raise AssertionError("DENSE: TF32 is on for float32 products")
    f32_peak = card_peaks(torch.cuda.get_device_name(dev_t))[1][1] \
        if dev_t.type == "cuda" else None
    out = {"paths": {}, "chores": {}}
    gen = torch.Generator(device=dev_t)
    gen.manual_seed(SEED)

    def budget(nbytes_held):
        """Cache budget from the card's free memory, less what the caller
        holds and room for the launches' transients and the checks (the
        generated mirrors are clean: an eviction would lose them)."""
        if dev_t.type != "cuda":
            return 4 << 30
        free, _ = torch.cuda.mem_get_info(dev_t)
        return max(2 << 30, free - nbytes_held - (8 << 30))

    def new_dev(ctx, held=0):
        return CudaDevice(ctx, device=dev_t, cache_bytes=budget(held))

    def run(label, tp, dev, colls, ntasks, flops=None, shape=None):
        """One timed taskpool run: wall from tp.run() until every tile of
        `colls` is final on the device, then the flush; the device task
        count against the DAG's; chore launches recorded at `shape`."""
        before = {k: list(v) for k, v in dev.launches.items()}
        st0 = dict(dev.stats)
        sync(dev_t)
        walls = {}

        def go():
            t = time.perf_counter()
            tp.run()
            tp.wait()
            for c in colls:
                wait_device_tiles(dev, c)
            sync(dev_t)
            walls["run"] = time.perf_counter() - t
            walls["d2h0"] = dev.stats["d2h_bytes"]
            dev.flush()
            sync(dev_t)
            walls["flush"] = time.perf_counter() - t
        observe(label, go)
        st = dict(dev.stats)
        ran = st["tasks"] - st0["tasks"]
        # this run's counts (the device may have run earlier pools)
        flush_s = walls["flush"] - walls["run"]
        row = {"wall_ms": walls["run"] * 1e3,
               "wall_flush_ms": walls["flush"] * 1e3, "tasks": ran,
               "flush_bytes": st["d2h_bytes"] - walls["d2h0"],
               "flush_gbps": (st["d2h_bytes"] - walls["d2h0"]) / flush_s
               / 1e9 if flush_s > 0 else None,
               "stats": {k: st[k] - st0[k] for k in (
                   "batches", "batched_tasks", "h2d_bytes", "d2h_bytes",
                   "d2d_bytes", "h2d_hits", "eager_gathers", "evictions",
                   "spec_store", "spec_hits", "spec_misses")}}
        row["stats"]["cache_peak_bytes"] = st["cache_peak_bytes"]
        if flops is not None:
            row["gflops"] = flops / walls["run"] / 1e9
        launches = {}
        for k, (n, lanes) in dev.launches.items():
            n0, l0 = before.get(k, (0, 0))
            if n > n0:
                launches[k] = [n - n0, lanes - l0]
                # a chore is timed at the shape of the first path that
                # launched it, at that path's mean lanes per launch
                rec = out["chores"].setdefault(k, {
                    "launches": 0, "lanes": 0, "path": label,
                    "shape": shape, "path_lanes": (n - n0) and
                    (lanes - l0) / (n - n0)})
                rec["launches"] += n - n0
                rec["lanes"] += lanes - l0
        row["launches"] = launches
        say(f"  {label}: {row['wall_ms']:.1f} ms to final device values, "
            f"{row['wall_flush_ms']:.1f} ms with the flush ("
            f"{row['flush_bytes']} B"
            + (f" at {row['flush_gbps']:.2f} GB/s" if row["flush_gbps"]
               else "") + f"); tasks={ran} "
            + (f"{row['gflops']:.1f} GFLOP/s; " if flops else "")
            + f"{row['stats']}; launches [count, lanes] {launches}")
        if ran != ntasks:
            raise AssertionError(f"{label}: {ran} device tasks, the DAG "
                                 f"has {ntasks}")
        out["paths"][label] = row
        return row

    def check_rel(label, value, limit):
        say(f"  {label}: {value:.3e} (limit {limit:g})")
        if not value <= limit:
            raise AssertionError(f"{label}: {value:.3e} > {limit:g}")
        return value

    def maxabs(t):  # a reduction: no |t| temporary
        return float(torch.linalg.vector_norm(t, ord=float("inf")))

    def check_max(label, got, want, rel):
        return check_rel(f"{label}: max|got - want| / max|want|",
                         maxabs(got - want) / maxabs(want), rel)

    def bound_ms(flops):
        return flops / f32_peak * 1e3 if f32_peak else None

    # ---------------------------------------------------- POTRF-P, POSV-P
    N, nb = dims["potrf_p"]
    nt = N // nb
    with pt.Context(nb_workers=4) as ctx:
        A = TwoDimBlockCyclic(N, N, N, nb)
        A.register(ctx, "A")
        dev = new_dev(ctx, N * N * 4)
        t = time.perf_counter()
        a_st = generate_spd_panels_on_device(dev, A, seed=SEED)
        sync(dev_t)
        say(f"  POTRF-P: generated the {N}^2 SPD matrix ({nt} panels of "
            f"{N}x{nb}) on the device in {time.perf_counter() - t:.2f} s")
        label = f"POTRF-P N={N} NB={nb}"
        row = run(label, build_potrf_panels(ctx, A, dev=dev), dev, [A],
                  nt + nt * (nt - 1) // 2, potrf_flops(N), (N, nb, 0))
        s = row["stats"]
        if not (s["spec_store"] == s["spec_hits"] == nt - 1
                and s["spec_misses"] == 0):
            raise AssertionError(f"{label}: epilogue store/hits/misses "
                                 f"{s['spec_store']}/{s['spec_hits']}/"
                                 f"{s['spec_misses']}, expected {nt - 1}/"
                                 f"{nt - 1}/0")
        row["residual"] = check_rel(f"{label} ||LL^T - A||_F / ||A||_F",
                                    potrf_residual(dev, A, a_st), 1e-4)
        # the dense matrices one at a time (at N = 65536 each is 16 GiB):
        # A, then cuSOLVER's factor, compared panel by panel (the port's
        # panels hold zeros above their diagonal block already)
        with dev._on_stream():
            a = assemble_dense(a_st, 1, nt, nb, N)
            del a_st
            lc = torch.linalg.cholesky(a)
            err = max(maxabs(panel - lc[:, j * nb:(j + 1) * nb])
                      for (_, j), panel in device_tiles(dev, A))
            row["vs_cusolver"] = check_rel(
                f"{label} max|L - torch.linalg.cholesky| / max|L_cusolver|",
                err / maxabs(lc), 1e-3)
            del lc
        row["cusolver_ms"] = timed_ms(dev_t,
                                      lambda: torch.linalg.cholesky(a), 3)
        row["bound_ms"] = bound_ms(potrf_flops(N))
        say(f"  {label}: torch.linalg.cholesky (cuSOLVER) "
            f"{row['cusolver_ms']:.1f} ms (mean of 3) = "
            f"{potrf_flops(N) / row['cusolver_ms'] / 1e6:.1f} GFLOP/s; the "
            f"runtime {row['wall_ms']:.1f} ms; f32 bound {row['bound_ms']} "
            "ms (potrf_flops / f32 non-tensor peak)")

        # POSV-P: solve with the factor the run left on the device
        nrhs = dims["posv_nrhs"]
        b = torch.randn(N, nrhs, generator=gen, device=dev_t)
        B = TwoDimBlockCyclic(N, nrhs, N, nrhs)
        B.tile(0, 0)[...] = b.cpu().numpy()
        B.register(ctx, "B")
        label = f"POSV-P N={N} NB={nb} nrhs={nrhs}"
        prow = run(label, build_potrs_panels(ctx, A, B, dev=dev), dev, [B],
                   2 * nt, shape=(N, nb, nrhs))
        x = torch.from_numpy(B.tile(0, 0).copy()).to(dev_t)
        with dev._on_stream():
            prow["residual"] = check_rel(
                f"{label} ||Ax - b|| / (||A|| ||x||)",
                float(torch.linalg.norm(a @ x - b) / (
                    torch.linalg.norm(a) * torch.linalg.norm(x))), 1e-4)
        lc = torch.linalg.cholesky(a)
        prow["cusolver_ms"] = timed_ms(
            dev_t, lambda: torch.cholesky_solve(b, lc), 3)
        say(f"  {label}: torch.cholesky_solve on the cuSOLVER factor "
            f"{prow['cusolver_ms']:.2f} ms (mean of 3)")
        dev.stop()
        del a, lc, b, x
    if dev_t.type == "cuda":
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ POTRF-T
    N, nb = dims["potrf_t"]
    nt = N // nb
    with pt.Context(nb_workers=4) as ctx:
        A = TwoDimBlockCyclic(N, N, nb, nb)
        A.register(ctx, "A")
        dev = new_dev(ctx, N * N * 4)
        a_st = generate_spd_on_device(dev, A, seed=SEED)
        label = f"POTRF-T N={N} NB={nb}"
        row = run(label, build_potrf(ctx, A, dev=dev), dev, [A],
                  nt + nt * (nt - 1) + nt * (nt - 1) * (nt - 2) // 6,
                  potrf_flops(N), (nb, nb, 0))
        row["residual"] = check_rel(f"{label} ||LL^T - A||_F / ||A||_F",
                                    potrf_residual(dev, A, a_st), 1e-4)
        with dev._on_stream():
            a = assemble_dense(a_st, nt, nt, nb)
        row["cusolver_ms"] = timed_ms(dev_t,
                                      lambda: torch.linalg.cholesky(a), 3)
        row["bound_ms"] = bound_ms(potrf_flops(N))
        say(f"  {label}: torch.linalg.cholesky {row['cusolver_ms']:.1f} ms "
            f"(mean of 3); the runtime {row['wall_ms']:.1f} ms; f32 bound "
            f"{row['bound_ms']} ms")
        dev.stop()
        del a, a_st

    # ------------------------------------------------------------ GETRF-P
    N, nb = dims["getrf_p"]
    nt = N // nb
    with pt.Context(nb_workers=4) as ctx:
        A = TwoDimBlockCyclic(N, N, N, nb)
        A.register(ctx, "A")
        dev = new_dev(ctx, N * N * 4)
        with dev._on_stream():
            # diagonally dominant, not symmetric
            a = torch.randn(N, N, generator=gen, device=dev_t)
            a.diagonal().add_(2.0 * N)
            install_device_tiles(dev, A, as_tiles(a, N, nb))
        label = f"GETRF-P N={N} NB={nb}"
        row = run(label, build_getrf_panels(ctx, A, dev=dev), dev, [A],
                  nt + nt * (nt - 1) // 2, getrf_flops(N), (N, nb, 0))
        if row["stats"]["spec_hits"] != nt - 1 \
                or row["stats"]["spec_misses"] != 0:
            raise AssertionError(f"{label}: epilogue hits "
                                 f"{row['stats']['spec_hits']}, misses "
                                 f"{row['stats']['spec_misses']}, expected "
                                 f"{nt - 1} and 0")
        with dev._on_stream():
            lu = assemble_dense(gather_device_tiles(dev, A), 1, nt, nb, N)
            lo = torch.tril(lu, -1)
            lo.diagonal().fill_(1.0)
            # read on the device's stream, where it was computed
            row["residual"] = check_rel(
                f"{label} ||LU - A||_F / ||A||_F",
                float(torch.linalg.norm(lo @ torch.triu(lu) - a)
                      / torch.linalg.norm(a)), 1e-4)
            del lo, lu
        if dev_t.type == "cuda":  # no pivot-free LU on the CPU
            row["cusolver_ms"] = timed_ms(
                dev_t, lambda: torch.linalg.lu_factor_ex(a, pivot=False), 3)
            say(f"  {label}: torch.linalg.lu_factor_ex(pivot=False) "
                f"{row['cusolver_ms']:.1f} ms (mean of 3)")
        dev.stop()
        del a

    # ------------------------------------- the tiled group at one (N, NB)
    N, nb = dims["tiled"]
    nt = N // nb
    pairs, triples = nt * (nt - 1) // 2, nt * (nt - 1) * (nt - 2) // 6
    squares = sum(j * j for j in range(nt))
    eye = torch.eye(N, device=dev_t)
    low = torch.tril(torch.randn(N, N, generator=gen, device=dev_t)) \
        + 2.0 * N * eye
    rhs = torch.randn(N, N, generator=gen, device=dev_t)
    gauss = torch.randn(N, N, generator=gen, device=dev_t)
    sync(dev_t)  # made on the default stream, read on the devices' own
    shape = (nb, nb, 0)

    def tiled(ctx, name):
        """A registered N x N collection of nb x nb tiles (host zeros)."""
        c = TwoDimBlockCyclic(N, N, nb, nb)
        c.register(ctx, name)
        return c

    def host_dense(c):
        return torch.from_numpy(c.to_dense()).to(dev_t)

    with pt.Context(nb_workers=4) as ctx:
        dev = new_dev(ctx, 6 * N * N * 4)
        A, L, B, W, C, G = (tiled(ctx, n) for n in "ALBWCG")
        a_st = generate_spd_on_device(dev, A, seed=SEED + 1)
        with dev._on_stream():
            install_device_tiles(dev, L, as_tiles(low, nb, nb))
            install_device_tiles(dev, B, as_tiles(rhs, nb, nb))
            install_device_tiles(dev, G, as_tiles(low + gauss, nb, nb))
            a = assemble_dense(a_st, nt, nt, nb)

        label = f"POTRF-T(solve) N={N} NB={nb}"
        row = run(label, build_potrf(ctx, A, dev=dev,
                                     trsm_via_inverse=False), dev, [A],
                  nt + 2 * pairs + triples, potrf_flops(N), shape)
        row["residual"] = check_rel(f"{label} ||LL^T - A||_F / ||A||_F",
                                    potrf_residual(dev, A, a_st), 1e-4)

        label = f"GETRF-T N={N} NB={nb}"
        row = run(label, build_getrf_nopiv(ctx, G, dev=dev, name="G"), dev,
                  [G], nt + 2 * pairs + squares, getrf_flops(N), shape)
        with dev._on_stream():
            lu = host_dense(G)
            lo = torch.tril(lu, -1) + eye
            g = low + gauss
            row["residual"] = check_rel(
                f"{label} ||LU - A||_F / ||A||_F",
                float(torch.linalg.norm(lo @ torch.triu(lu) - g)
                      / torch.linalg.norm(g)), 1e-4)
            del lu, lo

        label = f"TRSM N={N} NB={nb} nrhs={N}"
        row = run(label, build_trsm(ctx, L, B, dev=dev), dev, [B],
                  nt * nt + pairs * nt, float(N) ** 3, shape)
        with dev._on_stream():
            row["vs_torch"] = check_max(
                f"{label} X vs torch.linalg.solve_triangular",
                host_dense(B), torch.linalg.solve_triangular(
                    low, rhs, upper=False), 1e-4)
        row["torch_ms"] = timed_ms(dev_t, lambda: torch.linalg.
                                   solve_triangular(low, rhs, upper=False),
                                   3)

        label = f"TRTRI N={N} NB={nb}"
        row = run(label, build_trtri(ctx, L, W, dev=dev), dev, [W],
                  nt + 2 * pairs + triples, N ** 3 / 3.0, shape)
        with dev._on_stream():
            winv = torch.linalg.solve_triangular(low, eye, upper=False)
            w = torch.tril(host_dense(W))
            row["vs_torch"] = check_max(
                f"{label} W vs torch.linalg.solve_triangular(L, I)", w,
                winv, 1e-4)
        row["torch_ms"] = timed_ms(dev_t, lambda: torch.linalg.
                                   solve_triangular(low, eye, upper=False),
                                   3)
        # LAUUM reads W's lower tiles as staged from the host
        label = f"LAUUM N={N} NB={nb}"
        row = run(label, build_lauum(ctx, W, C, dev=dev), dev, [C],
                  nt * (nt + 1) * (nt + 2) // 6, N ** 3 / 3.0, shape)
        with dev._on_stream():
            row["vs_torch"] = check_max(
                f"{label} C vs tril(W^T W) by torch.matmul",
                torch.tril(host_dense(C)), torch.tril(w.mT @ w), 1e-4)
        row["torch_ms"] = timed_ms(dev_t, lambda: torch.matmul(w.mT, w), 3)
        del w, winv
        dev.stop()

    with pt.Context(nb_workers=4) as ctx:
        dev = new_dev(ctx, 4 * N * N * 4)
        A, W, C = (tiled(ctx, n) for n in "AWC")
        a_st = generate_spd_on_device(dev, A, seed=SEED + 1)
        label = f"POTRI N={N} NB={nb}"

        class _Potri:  # run_potri runs and waits for its three pools
            def run(self):
                run_potri(ctx, A, W, C, dev=dev)

            def wait(self):
                pass
        row = run(label, _Potri(), dev, [A, W, C],
                  3 * (nt + 2 * pairs + triples), N ** 3, shape)
        with dev._on_stream():
            ainv = torch.linalg.inv(a)
            row["vs_torch"] = check_max(
                f"{label} lower(A^-1) vs torch.linalg.inv",
                torch.tril(host_dense(C)), torch.tril(ainv), 1e-4)
        row["torch_ms"] = timed_ms(dev_t, lambda: torch.linalg.inv(a), 3)
        del ainv, a_st
        dev.stop()

    with pt.Context(nb_workers=4) as ctx:
        dev = new_dev(ctx, 2 * N * N * 4)
        Q = tiled(ctx, "Q")
        with dev._on_stream():
            install_device_tiles(dev, Q, as_tiles(gauss, nb, nb))
        label = f"GEQRF N={N} NB={nb}"
        row = run(label, build_geqrf(ctx, Q, dev=dev, name="Q"), dev, [Q],
                  nt + 2 * pairs + squares, 4.0 * N ** 3 / 3.0, shape)
        with dev._on_stream():
            r_lib = torch.linalg.qr(gauss, mode="r")[1]
            r = torch.triu(host_dense(Q))
            # R is unique up to the sign of each row (LAPACK and
            # cuSOLVER choose their Householder signs independently)
            row["vs_torch"] = check_max(
                f"{label} R vs torch.linalg.qr, rows sign-normalised",
                r * torch.sign(r.diagonal())[:, None],
                r_lib * torch.sign(r_lib.diagonal())[:, None], 1e-3)
        row["torch_ms"] = timed_ms(dev_t, lambda: torch.linalg.qr(
            gauss, mode="r"), 3)
        dev.stop()
    for name, ms in ((k, v.get("torch_ms")) for k, v in
                     out["paths"].items()):
        if ms is not None:
            say(f"  {name}: one torch call {ms:.2f} ms (mean of 3), the "
                f"runtime {out['paths'][name]['wall_ms']:.1f} ms")
    return out


def time_chores(dev_t, chores) -> None:
    """Time one launch of each chore the dense path launched, at its
    path's shape and mean lanes per launch, beside its bound and, where
    one PyTorch call computes the same function, that call's time.
    Fills each record of `chores` in place."""
    import torch

    import parsec_tpu_torch.algos as algos
    mods = (algos.potrf, algos.lu, algos.trsm, algos.inverse, algos.qr)
    # (a CPU rehearsal times the control flow only: no peaks there)
    bw, f32_peak, _ = card_peaks(torch.cuda.get_device_name(dev_t))[1] \
        if dev_t.type == "cuda" else (1.0, 1.0, 1.0)
    for name, rec in sorted(chores.items()):
        fn = next(getattr(m, name) for m in mods if hasattr(m, name))
        n, nb, r = rec["shape"]
        lanes = max(1, round(rec["path_lanes"]))
        ins, lib = chore_inputs(name, lanes, nb, n, r, dev_t)
        outs = fn(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        nbytes = sum(t[:1].nbytes if t.stride(0) == 0 else t.nbytes
                     for t in ins) + sum(o.nbytes for o in outs)
        flops = chore_flops(name, lanes, nb, n, r)
        iters = 20 if flops < 1e10 else 5
        rec.update(
            lanes_timed=lanes,
            ms=timed_ms(dev_t, lambda: fn(*ins), iters, 2),
            library_ms=timed_ms(dev_t, lib, iters, 2) if lib else None,
            bound_ms=max(nbytes / bw, flops / f32_peak) * 1e3,
            bound_by="bytes" if nbytes / bw >= flops / f32_peak
            else "operations")
        log(f"  {name} [{lanes} lanes, {rec['path']}]: {rec['ms']:.4f} ms a "
            f"launch, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
            f"library {rec['library_ms']} ms; {rec['launches']} launches "
            f"({rec['lanes']} lanes) on the path")
        del ins, outs


# phase 7 sizes: NORM as phase 4 runs it, X and O 32768 x 4096 f32 tiled
# (1024, 4096), 32 tasks in waves of PIPE["batch"]; GEMM (N, NB) for the
# out-of-core leg
PIPE = {"norm": (32768, 4096, 1024), "batch": 4, "reps": 3,
        "gemm": (8192, 1024)}


def pipeline_path(dev_t, dims=None, observe=None, ooc=True) -> dict:
    """Phase 7: the device pipeline through Context -> Taskpool ->
    CudaDevice.  7a: NORM with the prefetch lane off and on, `reps` runs
    of each in turns (off, on, on, off, ...), every O held to the plain
    version at 2e-5 and to the first run's O bit for bit, and the lane's
    hits required.  7b (ooc=True): GEMM resident, then out-of-core at half
    its tile set (C against torch.matmul at 1e-4 / 1e-3, spills required,
    residency at the end within the tile set), then NORM out-of-core at
    half its O, bit-identical to 7a.  Host data from seed SEED + 7: the
    out-of-core legs stage from host data, never from matrices generated
    on the device (a spilled or evicted clean mirror of those would be
    staged again from zero host tiles).  observe(label, fn) runs each
    taskpool run and its flush (a profiler may wrap it).  Returns the
    numbers the smoke prints, with the hand-written kernels' launches
    summed over the phase's runs under "launches"."""
    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch import kernels
    from parsec_tpu_torch.algos import build_gemm
    from parsec_tpu_torch.convert import to_collection, to_tensor
    from parsec_tpu_torch.device import CudaDevice
    rn_mod = importlib.import_module("parsec_tpu_torch.ops.rms_norm")
    if observe is None:
        def observe(label, fn):
            fn()
    dims = dims or PIPE
    rows, d, T = dims["norm"]
    rng = np.random.default_rng(SEED + 7)
    xn = rng.standard_normal((rows, d), dtype=np.float32)
    wn = rng.standard_normal((1, d), dtype=np.float32)
    out = {"launches": {}, "runs": {}}
    keys = ("h2d_bytes", "h2d_stall_ns", "prefetch_staged", "prefetch_hits",
            "prefetch_misses", "prefetch_wasted", "prefetch_h2d_ns",
            "reserve_fails", "evictions", "spills", "spill_bytes",
            "ooc_waits", "d2h_bytes", "batches", "tasks", "overlap_ratio",
            "cache_peak_bytes")

    def run(label, build, prefetch, cache_bytes=None, batch=None):
        """One taskpool run on a new context and device: wall from
        tp.run() to the pool's end (the device synchronised), then with
        the flush; the pipeline counters, the residency at the end, the
        kernels' launches.  Returns (the result read on the host, the
        row).  Fails on a prefetch lane exception."""
        with pt.Context(nb_workers=4) as ctx:
            dev = CudaDevice(ctx, device=dev_t, prefetch=prefetch,
                             cache_bytes=cache_bytes)
            if batch is not None:
                dev.batch_max = batch
            tp, result = build(ctx, dev)
            walls = {}

            def go():
                sync(dev_t)
                t = time.perf_counter()
                tp.run()
                tp.wait()
                sync(dev_t)
                walls["run"] = time.perf_counter() - t
                dev.flush()
                sync(dev_t)
                walls["total"] = time.perf_counter() - t
            kernels.reset_launches()
            observe(label, go)
            got = dict(kernels.LAUNCHES)
            st = ctx.device_stats()
            used = dev._cache_used
            err = dev.prefetch_error
            dev.stop()
            host = result()
        if err is not None:
            raise AssertionError(f"{label}: prefetch lane exception {err!r}")
        for k, n in got.items():
            out["launches"][k] = out["launches"].get(k, 0) + n
        row = {"run_ms": walls["run"] * 1e3, "total_ms": walls["total"] * 1e3,
               "end_residency": used, "launches": got,
               **{k: st[k] for k in keys}}
        log(f"  {label}: {row['run_ms']:.1f} ms to the pool's end, "
            f"{row['total_ms']:.1f} ms with the flush; h2d stall "
            f"{st['h2d_stall_ns'] / 1e6:.1f} ms, lane h2d "
            f"{st['prefetch_h2d_ns'] / 1e6:.1f} ms, overlap_ratio "
            f"{st['overlap_ratio']}; prefetch staged/hits/misses/wasted "
            f"{st['prefetch_staged']}/{st['prefetch_hits']}/"
            f"{st['prefetch_misses']}/{st['prefetch_wasted']}; "
            f"reserve_fails {st['reserve_fails']} evictions "
            f"{st['evictions']} spills {st['spills']} ({st['spill_bytes']} "
            f"B) ooc_waits {st['ooc_waits']}; cache peak "
            f"{st['cache_peak_bytes']} B, {used} B at the end; tasks "
            f"{st['tasks']} in {st['batches']} batched launches; kernel "
            f"launches {got}")
        out["runs"][label] = row
        return host, row

    def norm(ctx, dev):
        Xc, Wc = to_collection(xn, T, d), to_collection(wn, 1, d)
        Oc = to_collection(np.zeros_like(xn), T, d)
        return (rn_mod.build_rms_norm(ctx, Xc, Wc, Oc, EPS, dev=dev),
                Oc.to_dense)

    # ------------------------------------------ 7a: prefetch off and on
    want = rn_mod.rms_norm_plain(to_tensor(xn, dev_t),
                                 to_tensor(wn[0], dev_t), EPS)
    o_ref, checked, hits = None, set(), 0
    order = [False, True, True, False, False, True][:2 * dims["reps"]]
    for i, prefetch in enumerate(order):
        label = (f"NORM {rows}x{d} f32, T={T}, batch {dims['batch']}, "
                 f"prefetch {'on' if prefetch else 'off'} #{i + 1}")
        o, row = run(label, norm, prefetch, batch=dims["batch"])
        # (a CPU rehearsal runs the plain version: no launch to count)
        if dev_t.type == "cuda" and row["launches"]["rms_norm"] <= 0:
            raise AssertionError(f"{label}: the rms_norm kernel never ran")
        if prefetch:
            hits += row["prefetch_hits"]
        if prefetch not in checked:  # once for each mode: 2e-5, as phase 4
            checked.add(prefetch)
            check_close(f"{label} O vs plain", to_tensor(o, dev_t), want,
                        2e-5, 2e-5)
        if o_ref is None:
            o_ref = o
        elif not np.array_equal(o, o_ref):
            raise AssertionError(f"{label}: O differs from run 1's bits")
    del want
    log(f"  NORM: O bit-identical over the {len(order)} runs, prefetch on "
        "and off")
    if hits <= 0:
        raise AssertionError("NORM prefetch on: prefetch_hits == 0")
    if not ooc:
        return out

    # ---------------------------------------------- 7b: out-of-core legs
    n, nb = dims["gemm"]
    a = rng.standard_normal((n, n), dtype=np.float32)
    b = rng.standard_normal((n, n), dtype=np.float32)
    tile_set = 3 * n * n * 4

    def gemm(ctx, dev):
        A, B = to_collection(a, nb, nb), to_collection(b, nb, nb)
        C = to_collection(np.zeros((n, n), np.float32), nb, nb)
        for name, c in zip("ABC", (A, B, C)):
            c.register(ctx, name)
        return build_gemm(ctx, A, B, C, dev), C.to_dense

    want = torch.matmul(to_tensor(a, dev_t), to_tensor(b, dev_t))
    # resident: a budget that also holds every wave's gathered lane
    # stacks (4.5 GB at the default 4 GiB evicted, on the H100)
    label = f"GEMM {n}^2 f32, {nb}^2 tiles, resident"
    c, res = run(label, gemm, True, 16 << 30)
    if res["evictions"] or res["spills"]:
        raise AssertionError(f"{label}: evictions or spills")
    check_close(f"{label} C vs torch.matmul", to_tensor(c, dev_t), want,
                1e-4, 1e-3)
    label = (f"GEMM {n}^2 f32, {nb}^2 tiles, out-of-core at "
             f"{tile_set // 2 >> 20} MiB of a {tile_set >> 20} MiB tile set")
    c, row = run(label, gemm, True, tile_set // 2)
    check_close(f"{label} C vs torch.matmul", to_tensor(c, dev_t), want,
                1e-4, 1e-3)
    if row["spills"] <= 0:
        raise AssertionError(f"{label}: no spill")
    if row["end_residency"] > tile_set:
        raise AssertionError(f"{label}: {row['end_residency']} B resident "
                             f"at the end, over the {tile_set} B tile set")
    log(f"  GEMM out-of-core {row['run_ms']:.1f} ms ({row['total_ms']:.1f} "
        f"with the flush) against resident {res['run_ms']:.1f} ms "
        f"({res['total_ms']:.1f}): spills {row['spills']}, spill_bytes "
        f"{row['spill_bytes']}, ooc_waits {row['ooc_waits']}, reserve_fails "
        f"{row['reserve_fails']}")
    del a, b, c, want
    # NORM out-of-core: half of O, so that O's dirty mirrors must spill
    budget = rows * d * 4 // 2
    label = (f"NORM {rows}x{d} f32, T={T}, out-of-core at "
             f"{budget >> 20} MiB")
    o, row = run(label, norm, True, budget, dims["batch"])
    if row["spills"] <= 0:
        raise AssertionError(f"{label}: no spill")
    if dev_t.type == "cuda" and row["launches"]["rms_norm"] <= 0:
        raise AssertionError(f"{label}: the rms_norm kernel never ran")
    if not np.array_equal(o, o_ref):
        raise AssertionError(f"{label}: O differs from the resident run's")
    log(f"  {label}: O bit-identical to the resident runs")
    return out


# phase 8 sizes, phase 4's: GEMM (N, NB), NORM (rows, d, T), FATT (heads,
# L, D)
DSL = {"gemm": (4096, 512), "norm": (8 * 4096, 4096, 1024),
       "fatt": (32, 4096, 128)}

# phase 8's JDF program: NORM as one class whose device incarnation calls
# the RMSNorm op on the wave's [lanes, T, d] stacks (a batched body: one
# launch for a wave); its host incarnation must not run
NORM_JDF = """
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
O = rms_norm(X, W[0, 0], eps)
}
END

BODY
{
raise RuntimeError("NORM ran its host incarnation")
}
END
"""


def dsl_path(dev_t, rng, dims=None, ptg_norm_o=None) -> dict:
    """Phase 8: the DSL front ends, each run in a fresh
    Context(nb_workers=4) with CudaDevice(ctx, device=dev_t), on phase
    4's data (`rng` replays main_path's draws: GEMM's A and B, NORM's X
    and W, FATT's Q, K and V, in that order):
      DTD-GEMM  C += A @ B as insert_cuda_task calls, k_gemm = c + a @ b
                (a plain product, as the PTG chore k_gemm_nn); each C
                tile an INOUT chain of N/NB tasks; C at 1e-4 / 1e-3 of
                torch.matmul
      DTD-NORM  one device task per X row tile through the RMSNorm op;
                O at 2e-5 of the plain version, and beside phase 4's PTG
                NORM O (`ptg_norm_o`: bit identity expected, the largest
                difference printed)
      DTD-FATT  one device task per query head through the flash op, K
                and V one shared tile each; O at 2e-5 of the plain
                attention
      JDF-NORM  NORM_JDF compiled with compile_jdf(..., dev=dev); held
                as DTD-NORM
      MIXED     a host insert_task body reads the tile a device task
                has just written, in one DTD pool: it must see the
                device's bytes
    Before each DTD run, phase 4's PTG pool of the same path runs on the
    same data (PTG-GEMM, PTG-NORM, PTG-FATT), held as phase 4 holds it:
    the per-task DTD dispatch against PTG's lane groups, both warm (phase
    4's runs are each path's first in the process).  Each run's wall is
    from its first insert (PTG and JDF: building the pool and run())
    through wait(), dev.flush() and a synchronize, printed with the task
    count and the hand-written kernels' launches in the run; on a card
    the DTD runs must launch their kernel once a task.  Returns {"runs":
    {label: row}, "launches": the kernels' launches summed}."""
    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch import kernels
    from parsec_tpu_torch.algos import build_gemm
    from parsec_tpu_torch.convert import to_collection, to_tensor
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.dsl.dtd import DtdTaskpool
    from parsec_tpu_torch.dsl.jdf import compile_jdf
    fa_mod = importlib.import_module("parsec_tpu_torch.ops.flash_attention")
    rn_mod = importlib.import_module("parsec_tpu_torch.ops.rms_norm")
    dims = dims or DSL
    n, nb = dims["gemm"]
    rows, d, T = dims["norm"]
    H, L, D = dims["fatt"]
    out = {"runs": {}, "launches": {name: 0 for name in kernels.LAUNCHES}}

    def run(label, ctx, go, ntasks):
        """Run go() (the inserts and the wait) on a new CudaDevice of
        `ctx`, then flush and synchronize; check the task count and
        record the run.  Returns (the device, this run's launches)."""
        dev = CudaDevice(ctx, device=dev_t)
        kernels.reset_launches()
        sync(dev_t)
        t = time.perf_counter()
        go(dev)
        dev.flush()
        sync(dev_t)
        wall = (time.perf_counter() - t) * 1e3
        got = dict(kernels.LAUNCHES)
        st = dict(dev.stats)
        chores = {k: v[0] for k, v in dev.launches.items()}
        log(f"  {label}: {wall:.1f} ms wall (through the flush, "
            f"synchronized), tasks={st['tasks']} batches={st['batches']} "
            f"h2d_bytes={st['h2d_bytes']} d2h_bytes={st['d2h_bytes']} "
            f"prefetch hits/staged {st['prefetch_hits']}/"
            f"{st['prefetch_staged']}; chore launches {chores}; "
            f"hand-written kernel launches {got}")
        if st["tasks"] != ntasks:
            raise AssertionError(f"{label}: {st['tasks']} device tasks, "
                                 f"expected {ntasks}")
        if dev.prefetch_error is not None:
            raise AssertionError(f"{label}: prefetch lane exception "
                                 f"{dev.prefetch_error!r}")
        for k, v in got.items():
            out["launches"][k] += v
        out["runs"][label] = {"wall_ms": wall, "tasks": st["tasks"],
                              "batches": st["batches"], "launches": got,
                              "chore_launches": chores,
                              "h2d_bytes": st["h2d_bytes"],
                              "d2h_bytes": st["d2h_bytes"]}
        return dev, got

    def need(label, got, name, count):
        if dev_t.type == "cuda" and got[name] != count:
            raise AssertionError(f"{label}: {got[name]} {name} launches, "
                                 f"expected {count}")

    def vs_ptg(label, o):
        if ptg_norm_o is None:
            return
        diff = float(np.abs(o - ptg_norm_o).max())
        same = bool(np.array_equal(o, ptg_norm_o))
        log(f"  {label} O vs phase 4's PTG NORM O: bit-identical {same}, "
            f"max_abs_diff={diff:.3e}")
        out["runs"][label]["ptg_bit_identical"] = same

    # ------------------------------------------------- PTG-, DTD-GEMM
    a = rng.standard_normal((n, n), dtype=np.float32)
    b = rng.standard_normal((n, n), dtype=np.float32)
    want = torch.matmul(to_tensor(a, dev_t), to_tensor(b, dev_t))
    nt = n // nb

    def gemm_colls(ctx):
        A, B = to_collection(a, nb, nb), to_collection(b, nb, nb)
        C = to_collection(np.zeros((n, n), np.float32), nb, nb)
        for name, coll in (("A", A), ("B", B), ("C", C)):
            coll.register(ctx, name)
        return A, B, C

    with pt.Context(nb_workers=4) as ctx:
        A, B, C = gemm_colls(ctx)

        def gemm_ptg(dev):
            tp = build_gemm(ctx, A, B, C, dev)
            tp.run()
            tp.wait()

        dev, _ = run(f"PTG-GEMM {n}^2 f32, {nb}^2 tiles", ctx, gemm_ptg,
                     nt ** 3)
        dev.stop()
        check_close("PTG-GEMM C vs torch.matmul",
                    to_tensor(C.to_dense(), dev_t), want, 1e-4, 1e-3)

    with pt.Context(nb_workers=4) as ctx:
        A, B, C = gemm_colls(ctx)
        dtd = DtdTaskpool(ctx)

        def k_gemm(a, b, c):
            return c + a @ b

        def gemm(dev):
            shapes = {i: (nb, nb) for i in range(3)}
            for m in range(nt):
                for j in range(nt):
                    for k in range(nt):
                        dtd.insert_cuda_task(
                            dev, k_gemm, (dtd.tile_of(A, m, k), "INPUT"),
                            (dtd.tile_of(B, k, j), "INPUT"),
                            (dtd.tile_of(C, m, j), "INOUT"), shapes=shapes)
            dtd.wait()

        dev, _ = run(f"DTD-GEMM {n}^2 f32, {nb}^2 tiles", ctx, gemm,
                     nt ** 3)
        dev.stop()
        dtd.destroy()
        # f32 products, sums of n terms in another order
        check_close("DTD-GEMM C vs torch.matmul",
                    to_tensor(C.to_dense(), dev_t), want, 1e-4, 1e-3)
    del a, b, A, B, C, want

    # ------------------------------------------------------- DTD-NORM
    xn = rng.standard_normal((rows, d), dtype=np.float32)
    wn = rng.standard_normal((1, d), dtype=np.float32)
    want = rn_mod.rms_norm_plain(to_tensor(xn, dev_t),
                                 to_tensor(wn[0], dev_t), EPS)
    R = rows // T

    def norm_colls(ctx):
        X, W = to_collection(xn, T, d), to_collection(wn, 1, d)
        O = to_collection(np.zeros_like(xn), T, d)
        for name, coll in (("X", X), ("W", W), ("O", O)):
            coll.register(ctx, name)
        return X, W, O

    with pt.Context(nb_workers=4) as ctx:
        X, W, O = norm_colls(ctx)

        def norm_ptg(dev):
            tp = rn_mod.build_rms_norm(ctx, X, W, O, EPS, dev=dev)
            tp.run()
            tp.wait()

        label = f"PTG-NORM {rows}x{d} f32, T={T}"
        dev, got = run(label, ctx, norm_ptg, R)
        dev.stop()
        o = O.to_dense()
        check_close("PTG-NORM O vs plain", to_tensor(o, dev_t), want,
                    2e-5, 2e-5)
        vs_ptg(label, o)

    with pt.Context(nb_workers=4) as ctx:
        X, W, O = norm_colls(ctx)
        dtd = DtdTaskpool(ctx)

        def k_norm(x, w):
            # x [T, d], w [1, d]: one task's tiles
            return rn_mod.rms_norm(x, w[0], EPS)

        def norm(dev):
            shapes = {0: (T, d), 1: (1, d), 2: (T, d)}
            for r in range(R):
                dtd.insert_cuda_task(dev, k_norm,
                                     (dtd.tile_of(X, r, 0), "INPUT"),
                                     (dtd.tile_of(W, 0, 0), "INPUT"),
                                     (dtd.tile_of(O, r, 0), "OUTPUT"),
                                     shapes=shapes)
            dtd.wait()

        label = f"DTD-NORM {rows}x{d} f32, T={T}"
        dev, got = run(label, ctx, norm, R)
        dev.stop()
        dtd.destroy()
        need(label, got, "rms_norm", R)
        o = O.to_dense()
        check_close("DTD-NORM O vs plain", to_tensor(o, dev_t), want,
                    2e-5, 2e-5)
        vs_ptg(label, o)
    del X, O, o

    # ------------------------------------------------------- JDF-NORM
    with pt.Context(nb_workers=4) as ctx:
        X, W, O = norm_colls(ctx)
        holder = {}

        def jdf(dev):
            bld = compile_jdf(NORM_JDF, ctx, globals={"R": R - 1},
                              dtype=np.float32,
                              shapes={"X": (T, d), "W": (1, d),
                                      "O": (T, d)}, dev=dev)
            bld.scope.update(rms_norm=rn_mod.rms_norm, eps=EPS)
            tp = bld.run()
            tp.wait()
            holder["tp"] = tp

        label = f"JDF-NORM {rows}x{d} f32, T={T}, BODY [type=CUDA] batched"
        dev, got = run(label, ctx, jdf, R)
        dev.stop()
        if dev_t.type == "cuda" and got["rms_norm"] <= 0:
            raise AssertionError("JDF-NORM: the rms_norm kernel never ran")
        o = O.to_dense()
        check_close("JDF-NORM O vs plain", to_tensor(o, dev_t), want,
                    2e-5, 2e-5)
        vs_ptg(label, o)
    del X, O, o, want

    # ----------------------------------------------------------- MIXED
    with pt.Context(nb_workers=4) as ctx:
        tile = xn[:T].copy()
        seen = {}
        dtd = DtdTaskpool(ctx)
        t = dtd.tile_of(ctx.data(1, tile))

        def k_scale(x):
            return x * 2 + 1

        def host_read(view):
            seen["x"] = view.data(0, np.float32, (T, d)).copy()

        def mixed(dev):
            dtd.insert_cuda_task(dev, k_scale, (t, "INOUT"),
                                 shapes={0: (T, d)})
            dtd.insert_task(host_read, (t, "INPUT"))
            dtd.insert_cuda_task(dev, k_scale, (t, "INOUT"),
                                 shapes={0: (T, d)})
            dtd.wait()

        dev, _ = run(f"MIXED device, host, device on one ({T}, {d}) tile",
                     ctx, mixed, 2)
        dev.stop()
        dtd.destroy()
        x1 = xn[:T] * np.float32(2) + np.float32(1)
        if not np.array_equal(seen["x"], x1):
            raise AssertionError("MIXED: the host body did not read the "
                                 "device task's bytes")
        if not np.array_equal(tile, x1 * np.float32(2) + np.float32(1)):
            raise AssertionError("MIXED: the tile does not hold the second "
                                 "device task's bytes")
        log("  MIXED: the host body read the device task's bytes, and "
            "the next device task read them")
    del xn, wn

    # ------------------------------------------------------- DTD-FATT
    qn = rng.standard_normal((H * L, D), dtype=np.float32)
    kn = rng.standard_normal((L, D), dtype=np.float32)
    vn = rng.standard_normal((L, D), dtype=np.float32)
    scale = D ** -0.5
    kt, vt = to_tensor(kn, dev_t), to_tensor(vn, dev_t)
    want = fa_mod.attention_reference(
        to_tensor(qn, dev_t).reshape(H, L, D),
        kt.unsqueeze(0).expand(H, L, D), vt.unsqueeze(0).expand(H, L, D),
        False, scale)

    def fatt_colls(ctx):
        Q, K, V = (to_collection(qn, L, D), to_collection(kn, L, D),
                   to_collection(vn, L, D))
        O = to_collection(np.zeros_like(qn), L, D)
        for name, coll in (("Q", Q), ("K", K), ("V", V), ("O", O)):
            coll.register(ctx, name)
        return Q, K, V, O

    with pt.Context(nb_workers=4) as ctx:
        Q, K, V, O = fatt_colls(ctx)

        def fatt_ptg(dev):
            tp = fa_mod.build_flash_attention(ctx, Q, K, V, O, dev=dev)
            tp.run()
            tp.wait()

        dev, _ = run(f"PTG-FATT {H}x{L}x{D} f32, shared K/V", ctx,
                     fatt_ptg, H)
        dev.stop()
        check_close("PTG-FATT O vs plain",
                    to_tensor(O.to_dense(), dev_t).reshape(H, L, D), want,
                    2e-5, 2e-5)

    with pt.Context(nb_workers=4) as ctx:
        Q, K, V, O = fatt_colls(ctx)
        dtd = DtdTaskpool(ctx)

        def k_fatt(qb, kb, vb):
            # one head's [L, D] blocks through the flash op as 1 lane
            return fa_mod.flash_fwd(qb[None], kb[None], vb[None], False,
                                    scale)[0]

        def fatt(dev):
            shapes = {i: (L, D) for i in range(4)}
            for h in range(H):
                dtd.insert_cuda_task(dev, k_fatt,
                                     (dtd.tile_of(Q, h, 0), "INPUT"),
                                     (dtd.tile_of(K, 0, 0), "INPUT"),
                                     (dtd.tile_of(V, 0, 0), "INPUT"),
                                     (dtd.tile_of(O, h, 0), "OUTPUT"),
                                     shapes=shapes)
            dtd.wait()

        label = f"DTD-FATT {H}x{L}x{D} f32, shared K/V"
        dev, got = run(label, ctx, fatt, H)
        dev.stop()
        dtd.destroy()
        need(label, got, "flash_attention", H)
        check_close("DTD-FATT O vs plain",
                    to_tensor(O.to_dense(), dev_t).reshape(H, L, D), want,
                    2e-5, 2e-5)
    return out


# phase 9 sizes: 9a phase 4's paths (GEMM (N, NB), NORM (rows, d, T),
# FATT (heads, L, D)) and the NORM walls traced and untraced (runs of
# each); 9b one (N, N) tile recursing into (NB, NB) sub-tiles; 9c the
# tiled group's (N, NB); 9d POTRF-T's (N, NB), regridded to NB / 2; 9e the
# chain's square tile side, and GEMM's (N, NB) over two devices
RUNTIME = {"gemm": (4096, 512), "norm": (8 * 4096, 4096, 1024),
           "fatt": (32, 4096, 128), "norm_walls": 3,
           "recursive": (8192, 512), "compose": (8192, 512),
           "reshape": (16384, 1024), "chain": 1024, "gemm2": (4096, 512)}


def trace_summary(tr, kernel_launches=None) -> dict:
    """The device's own spans in one pool's trace: the window from the
    first event to the last, the host time in RELEASE_DEPS spans (a
    device task's release runs on the manager thread) and in the lane's
    DEVICE_H2D spans, dispatch begins and ends, lanes, DEVICE_H2D bytes
    (dispatch lane 0 and off-path lane 1) and the ends' stall aux; per
    task class (DTD bodies: class -1) its dispatch spans, their summed
    host time and stall; the pool's critical path and lost time."""
    from parsec_tpu_torch.profiling import (KEY_DEVICE, KEY_H2D,
                                            KEY_RELEASE, critical_path,
                                            lost_time)
    ev = tr.events
    beg = ev[:, 1] == 0
    d, h = ev[:, 0] == KEY_DEVICE, ev[:, 0] == KEY_H2D
    per = {}
    busy = {"release_ms": 0.0, "lane_h2d_ms": 0.0}
    for (_, _, key, cid, l0, _, aux, t0, t1) in tr.spans():
        if key == KEY_RELEASE:
            busy["release_ms"] += (t1 - t0) / 1e6
        elif key == KEY_H2D and aux == 1:
            busy["lane_h2d_ms"] += (t1 - t0) / 1e6
        if key != KEY_DEVICE:
            continue
        row = per.setdefault(tr._cname(cid), {"spans": 0, "lanes": 0,
                                              "dispatch_ms": 0.0,
                                              "stall_ms": 0.0})
        row["spans"] += 1
        row["lanes"] += l0
        row["dispatch_ms"] += (t1 - t0) / 1e6
        row["stall_ms"] += aux / 1e6
    try:
        cp = critical_path(tr)
        cp = {"nodes": cp["nodes"], "edges": cp["edges"],
              "total_ms": cp["total_ns"] / 1e6,
              "classes": sorted({p[0] for p in cp["path"]})}
    except ValueError as e:
        # an EDGE names a task by its class and first two locals: a class
        # of three (GEMM's m, n, k) folds its k-chain into self-loops
        cp = {"error": str(e)}
    lt = lost_time(tr)["totals"]
    return {"window_ms": float(ev[:, 7].max() - ev[:, 7].min()) / 1e6
            if len(ev) else 0.0, **busy,
            "dispatch_begins": int((d & beg).sum()),
            "dispatch_ends": int((d & ~beg).sum()),
            "lanes": int(ev[d & beg, 3].sum()),
            "h2d_bytes": int(ev[h & beg, 3].sum()),
            "h2d_lane_bytes": int(ev[h & beg & (ev[:, 6] == 1), 3].sum()),
            "stall_ns": int(ev[d & ~beg, 6].sum()),
            "per_class": per,
            "critical_path": cp,
            "lost_time_ms": {k: v / 1e6 for k, v in lt.items()}}


def runtime_path(dev_t, rng, dims=None, ptg_norm_o=None,
                 trace_dir=None) -> dict:
    """Phase 9: the rest of the one-rank runtime and its own trace.
      9a  phase 4's GEMM, NORM and FATT pools (`rng` replays main_path's
          draws) and phase 8's DTD-GEMM in one Context(nb_workers=4),
          each warm (an untraced run first), then traced at level 2 on a
          fresh CudaDevice: the
          DEVICE_DISPATCH begins and ends pair, their lanes sum to the
          device's tasks, NORM's and FATT's spans equal their kernel's
          launches, the DEVICE_H2D bytes sum to stats["h2d_bytes"], the
          ends' aux to stats["h2d_stall_ns"], and the trace saved with
          Trace.save (under trace_dir) loads back with the same events;
          per class the dispatch host time, launches and stall, the
          critical path and lost time; then NORM's wall untraced and
          traced, norm_walls runs of each in turns (no bound asserted)
      9b  one host task over one (N, N) tile recursing (recursive_call)
          into build_potrf over a SubtileView of (NB, NB) sub-tiles whose
          chores run on the device; L held to a residual of 1e-4 and to
          torch.linalg.cholesky within 1e-3 max|L|
      9c  compose(build_potrf, build_trtri, build_lauum) as one Compound
          on the device, held to run_potri on the same matrix within
          1e-4 max|ref|
      9d  POTRF-T's factor left dirty on the device: reshape_geometry to
          NB / 2 (bit for bit the flushed factor), build_reshape_dtype
          to float16 (bit for bit numpy's astype) and build_reduce_col
          with np.add (1e-4 max|ref| of a float64 sum of the tiles)
      9e  two CudaDevices on one card: a producer -> consumer chain with
          the default affinity skew (no d2d bytes) and with skew 0 (d2d
          bytes required); then GEMM under device weights 2:1, C at
          phase 4's 1e-4 / 1e-3, the tasks per device printed
    Returns {"runs": {label: row}, "launches": the kernels' launches}."""
    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch import kernels
    from parsec_tpu_torch.algos import (build_gemm, build_lauum,
                                        build_potrf, build_reduce_col,
                                        build_reshape_dtype, build_trtri,
                                        k_gemm_nn, potrf_flops,
                                        reshape_geometry, run_potri)
    from parsec_tpu_torch.convert import to_collection, to_tensor
    from parsec_tpu_torch.data import SubtileView, TwoDimBlockCyclic
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.device.bench_utils import generate_spd_on_device
    from parsec_tpu_torch.dsl.dtd import DtdTaskpool
    from parsec_tpu_torch.profiling import Trace, take_trace
    fa_mod = importlib.import_module("parsec_tpu_torch.ops.flash_attention")
    rn_mod = importlib.import_module("parsec_tpu_torch.ops.rms_norm")
    dims = dims or RUNTIME
    out = {"runs": {}, "launches": {name: 0 for name in kernels.LAUNCHES}}
    big = 24 << 30 if dev_t.type == "cuda" else 4 << 30  # cache budget

    def maxabs(t):
        return float(torch.linalg.vector_norm(t, ord=float("inf")))

    def check_rel(label, value, limit):
        log(f"  {label}: {value:.3e} (limit {limit:g})")
        if not value <= limit:
            raise AssertionError(f"{label}: {value:.3e} > {limit:g}")
        return value

    # ------------------------------------------------ 9a, traced path
    n, nb = dims["gemm"]
    rows, d, T = dims["norm"]
    H, L, D = dims["fatt"]
    a = rng.standard_normal((n, n), dtype=np.float32)
    b = rng.standard_normal((n, n), dtype=np.float32)
    xn = rng.standard_normal((rows, d), dtype=np.float32)
    wn = rng.standard_normal((1, d), dtype=np.float32)
    qn = rng.standard_normal((H * L, D), dtype=np.float32)
    kn = rng.standard_normal((L, D), dtype=np.float32)
    vn = rng.standard_normal((L, D), dtype=np.float32)
    if trace_dir is None:
        trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "build", "traces")
    os.makedirs(trace_dir, exist_ok=True)
    with pt.Context(nb_workers=4) as ctx:
        A, B = to_collection(a, nb, nb), to_collection(b, nb, nb)
        C = to_collection(np.zeros((n, n), np.float32), nb, nb)
        for name, coll in (("A", A), ("B", B), ("C", C)):
            coll.register(ctx, name)
        X, W = to_collection(xn, T, d), to_collection(wn, 1, d)
        O = to_collection(np.zeros_like(xn), T, d)
        Q, K, V = (to_collection(qn, L, D), to_collection(kn, L, D),
                   to_collection(vn, L, D))
        OF = to_collection(np.zeros_like(qn), L, D)

        def ptg(build):
            def go(dev):
                tp = build(dev)
                tp.run()
                tp.wait()
                return [tc.name for tc in tp.classes]
            return go

        def gemm(dev):
            for t in C._tiles.values():  # C += A @ B: from zero each run
                t[...] = 0
            return build_gemm(ctx, A, B, C, dev)

        def dtd_gemm(dev):
            """Phase 8's DTD-GEMM: one device task a (m, n, k), C += A @ B
            along INOUT chains on each C tile."""
            for t in C._tiles.values():
                t[...] = 0
            dtd = DtdTaskpool(ctx)
            shapes = {i: (nb, nb) for i in range(3)}
            for m in range(n // nb):
                for j in range(n // nb):
                    for k in range(n // nb):
                        dtd.insert_cuda_task(
                            dev, lambda a, b, c: c + a @ b,
                            (dtd.tile_of(A, m, k), "INPUT"),
                            (dtd.tile_of(B, k, j), "INPUT"),
                            (dtd.tile_of(C, m, j), "INOUT"), shapes=shapes)
            dtd.wait()
            dtd.destroy()
            return []

        paths = {
            "GEMM": (ptg(gemm), (n // nb) ** 3, None),
            "NORM": (ptg(lambda dev: rn_mod.build_rms_norm(
                ctx, X, W, O, EPS, dev=dev)), rows // T, "rms_norm"),
            "FATT": (ptg(lambda dev: fa_mod.build_flash_attention(
                ctx, Q, K, V, OF, dev=dev)), H, "flash_attention"),
            "DTD-GEMM": (dtd_gemm, (n // nb) ** 3, None)}

        def one_run(label, level):
            """One pool on a fresh device with tracing at `level`; the
            device stops (its lanes joined) before the trace is taken."""
            go, ntasks, _ = paths[label]
            ctx.profile_take()
            ctx.profile_enable(level)
            dev = CudaDevice(ctx, device=dev_t)
            kernels.reset_launches()
            sync(dev_t)
            t = time.perf_counter()
            names = go(dev)
            dev.flush()
            sync(dev_t)
            wall = (time.perf_counter() - t) * 1e3
            got = dict(kernels.LAUNCHES)
            for k, v in got.items():
                out["launches"][k] += v
            dev.stop()
            ctx.profile_enable(0)
            tr = take_trace(ctx, class_names=names, meta={"path": label})
            st = dict(dev.stats)
            if st["tasks"] != ntasks:
                raise AssertionError(f"{label}: {st['tasks']} device tasks, "
                                     f"expected {ntasks}")
            return wall, st, got, tr

        for label, (_, ntasks, kname) in paths.items():
            warm, _, _, _ = one_run(label, 0)
            wall, st, got, tr = one_run(label, 2)
            s = trace_summary(tr)
            log(f"  9a {label} traced: {wall:.1f} ms (untraced warm-up "
                f"{warm:.1f} ms); {len(tr.events)} events "
                f"{tr.counts()}; tasks={st['tasks']} h2d_bytes="
                f"{st['h2d_bytes']} h2d_stall={st['h2d_stall_ns'] / 1e6:.2f}"
                f" ms; kernel launches {got}")
            checks = {
                "dispatch begins == ends": s["dispatch_begins"]
                == s["dispatch_ends"] > 0,
                "lanes == stats tasks": s["lanes"] == st["tasks"],
                "DEVICE_H2D bytes == stats h2d_bytes":
                    s["h2d_bytes"] == st["h2d_bytes"],
                "ends' aux == stats h2d_stall_ns":
                    s["stall_ns"] == st["h2d_stall_ns"]}
            if kname is not None and dev_t.type == "cuda":
                checks[f"spans == {kname} launches"] = \
                    s["dispatch_begins"] == got[kname]
            path = os.path.join(trace_dir, f"phase9_{label}.ptt")
            tr.save(path)
            back = Trace.load(path)
            checks["saved trace loads back equal"] = bool(
                np.array_equal(back.events, tr.events)
                and back.class_names == tr.class_names)
            for what, ok in checks.items():
                log(f"    check {what}: {ok}")
                if not ok:
                    raise AssertionError(f"9a {label}: {what} fails: {s}")
            for cname, row in s["per_class"].items():
                log(f"    {cname}: {row['spans']} dispatch spans, "
                    f"{row['lanes']} lanes, {row['dispatch_ms']:.2f} ms of "
                    f"host dispatch, {row['stall_ms']:.2f} ms h2d stall")
            log(f"    trace window {s['window_ms']:.2f} ms: RELEASE_DEPS "
                f"{s['release_ms']:.2f} ms, lane DEVICE_H2D "
                f"{s['lane_h2d_ms']:.2f} ms ({s['h2d_lane_bytes']} B)")
            log(f"    critical path {s['critical_path']}; lost time "
                f"(ms, worker threads) {s['lost_time_ms']}; trace "
                f"{path} ({os.path.getsize(path)} B)")
            out["runs"][f"9a {label}"] = {"wall_ms": wall,
                                          "warm_wall_ms": warm,
                                          "trace": s, "launches": got}
            if label.endswith("GEMM"):
                check_close(f"9a {label} C vs torch.matmul",
                            to_tensor(C.to_dense(), dev_t),
                            torch.matmul(to_tensor(a, dev_t),
                                         to_tensor(b, dev_t)), 1e-4, 1e-3)
            elif label == "NORM":
                o = O.to_dense()
                check_close("9a NORM O vs plain", to_tensor(o, dev_t),
                            rn_mod.rms_norm_plain(to_tensor(xn, dev_t),
                                                  to_tensor(wn[0], dev_t),
                                                  EPS), 2e-5, 2e-5)
                if ptg_norm_o is not None:
                    same = bool(np.array_equal(o, ptg_norm_o))
                    log(f"  9a NORM O traced vs phase 4's: bit-identical "
                        f"{same}")
                    if not same:
                        raise AssertionError("9a NORM: tracing changed O")
                del o
            else:
                kt, vt = to_tensor(kn, dev_t), to_tensor(vn, dev_t)
                check_close(
                    "9a FATT O vs plain",
                    to_tensor(OF.to_dense(), dev_t).reshape(H, L, D),
                    fa_mod.attention_reference(
                        to_tensor(qn, dev_t).reshape(H, L, D),
                        kt.unsqueeze(0).expand(H, L, D),
                        vt.unsqueeze(0).expand(H, L, D), False,
                        D ** -0.5), 2e-5, 2e-5)
        walls = {"untraced": [], "traced": []}
        for _ in range(dims["norm_walls"]):
            for key, level in (("untraced", 0), ("traced", 2)):
                walls[key].append(one_run("NORM", level)[0])
        med = {k: float(np.median(v)) for k, v in walls.items()}
        log(f"  9a NORM walls in turns (ms): untraced {walls['untraced']}, "
            f"traced {walls['traced']}; medians {med}, traced/untraced "
            f"{med['traced'] / med['untraced']:.3f}")
        out["runs"]["9a NORM walls"] = walls
    del a, b, xn, wn, qn, kn, vn, A, B, C, X, W, O, Q, K, V, OF

    # -------------------------------------------- 9b, recursive potrf
    N, nb = dims["recursive"]
    nt = N // nb
    with pt.Context(nb_workers=4) as ctx:
        dev = CudaDevice(ctx, device=dev_t, cache_bytes=big)
        g = torch.Generator(device=dev_t)
        g.manual_seed(SEED + 9)
        with dev._on_stream():
            x = torch.randn(N, N, generator=g, device=dev_t)
            spd = (x + x.mT) * 0.5 + 2.0 * N * torch.eye(N, device=dev_t)
            del x
        sync(dev_t)
        A = TwoDimBlockCyclic(N, N, N, N)  # ONE tile
        A.tile(0, 0)[...] = spd.cpu().numpy()
        A.register(ctx, "A")
        tp = pt.Taskpool(ctx, globals={})
        tc = tp.task_class("FACTOR")
        tc.param("k", 0, 0)
        tc.affinity("A", pt.L("k"), pt.L("k"))
        tc.flow("T", "RW", pt.In(pt.Mem("A", pt.L("k"), pt.L("k"))),
                pt.Out(pt.Mem("A", pt.L("k"), pt.L("k"))))
        where = []

        def body(t):
            tile = t.data("T", np.float32, (N, N))
            sub = SubtileView(tile, nb, nb)
            sub.register(ctx, "SUB")
            inner = build_potrf(ctx, sub, dev, name="SUB")

            def on_done():
                where.append(threading.current_thread().name)
                sub.writeback()

            return pt.recursive_call(t, inner, on_done=on_done)

        tc.body(body)
        sync(dev_t)
        t = time.perf_counter()
        tp.run()
        tp.wait()
        wall = (time.perf_counter() - t) * 1e3
        ntasks = nt + nt * (nt - 1) + nt * (nt - 1) * (nt - 2) // 6
        log(f"  9b recursive potrf, one {N}^2 tile -> {nt}^2 sub-tiles of "
            f"{nb}^2: {wall:.1f} ms = {potrf_flops(N) / wall / 1e6:.1f} "
            f"GFLOP/s, inner device tasks={dev.stats['tasks']} (the DAG "
            f"has {ntasks}), writeback on thread {where}")
        if dev.stats["tasks"] != ntasks:
            raise AssertionError(f"9b: {dev.stats['tasks']} device tasks, "
                                 f"the inner DAG has {ntasks}")
        with dev._on_stream():
            lo = torch.tril(torch.from_numpy(A.tile(0, 0)).to(dev_t))
            res = check_rel("9b ||LL^T - A||_F / ||A||_F",
                            float(torch.linalg.norm(lo @ lo.mT - spd)
                                  / torch.linalg.norm(spd)), 1e-4)
            lc = torch.linalg.cholesky(spd)
            vs = check_rel("9b max|L - torch.linalg.cholesky| / max|L|",
                           maxabs(lo - lc) / maxabs(lc), 1e-3)
        out["runs"]["9b recursive potrf"] = {
            "wall_ms": wall, "tasks": ntasks, "residual": res,
            "vs_cusolver": vs, "writeback_thread": where}
        dev.stop()
        del lo, lc, spd

    # ----------------------------------------------------- 9c, compose
    N, nb = dims["compose"]
    nt = N // nb
    with pt.Context(nb_workers=4) as ctx:
        dev = CudaDevice(ctx, device=dev_t, cache_bytes=big)
        cs = {}
        for name in ("A", "W", "C", "A2", "W2", "C2"):
            cs[name] = TwoDimBlockCyclic(N, N, nb, nb)
            cs[name].register(ctx, name)
        generate_spd_on_device(dev, cs["A"], seed=SEED + 1)
        generate_spd_on_device(dev, cs["A2"], seed=SEED + 1)
        sync(dev_t)
        comp = pt.compose(
            build_potrf(ctx, cs["A"], dev=dev, name="A"),
            build_trtri(ctx, cs["A"], cs["W"], dev=dev, names=("A", "W")),
            build_lauum(ctx, cs["W"], cs["C"], dev=dev, names=("W", "C")))
        t = time.perf_counter()
        comp.run()
        comp.wait()
        dev.flush()
        sync(dev_t)
        wall = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        run_potri(ctx, cs["A2"], cs["W2"], cs["C2"], dev=dev,
                  names=("A2", "W2", "C2"))
        sync(dev_t)
        wall_ref = (time.perf_counter() - t) * 1e3
        log(f"  9c compose(potrf, trtri, lauum) N={N} NB={nb}: "
            f"{comp.nb_total_tasks} tasks, {wall:.1f} ms through the flush; "
            f"run_potri (three runs and waits) {wall_ref:.1f} ms")
        got = torch.tril(torch.from_numpy(cs["C"].to_dense()).to(dev_t))
        want = torch.tril(torch.from_numpy(cs["C2"].to_dense()).to(dev_t))
        rel = check_rel("9c max|C - run_potri's C| / max|run_potri's C|",
                        maxabs(got - want) / maxabs(want), 1e-4)
        out["runs"]["9c compose"] = {"wall_ms": wall,
                                     "run_potri_ms": wall_ref,
                                     "tasks": comp.nb_total_tasks,
                                     "vs_run_potri": rel}
        dev.stop()
        del got, want

    # ------------------------------------------- 9d, regrid and cast
    N, nb = dims["reshape"]
    nt = N // nb
    with pt.Context(nb_workers=4) as ctx:
        dev = CudaDevice(ctx, device=dev_t, cache_bytes=big)
        A = TwoDimBlockCyclic(N, N, nb, nb)
        A.register(ctx, "A")
        generate_spd_on_device(dev, A, seed=SEED)
        tp = build_potrf(ctx, A, dev=dev)
        tp.run()
        tp.wait()
        sync(dev_t)
        dirty = sum(1 for e in list(dev._cache.values()) if e.dirty)
        R = TwoDimBlockCyclic(N, N, nb // 2, nb // 2)
        R.register(ctx, "R")
        t = time.perf_counter()
        reshape_geometry(ctx, A, R)
        t_geo = (time.perf_counter() - t) * 1e3
        Hc = TwoDimBlockCyclic(N, N, nb, nb, dtype=np.float16)
        Hc.register(ctx, "H")
        t = time.perf_counter()
        tp = build_reshape_dtype(ctx, A, Hc, src_name="A", dst_name="H")
        tp.run()
        tp.wait()
        t_cast = (time.perf_counter() - t) * 1e3
        dev.flush()
        dense = A.to_dense()
        same_geo = bool(np.array_equal(R.to_dense(), dense))
        same_cast = bool(np.array_equal(Hc.to_dense(),
                                        dense.astype(np.float16)))
        want = dense.astype(np.float64).reshape(nt, nb, N).sum(axis=0)
        t = time.perf_counter()
        tp = build_reduce_col(ctx, A, np.add)
        tp.run()
        tp.wait()
        t_red = (time.perf_counter() - t) * 1e3
        got = np.concatenate([A.tile(0, j) for j in range(nt)], axis=1)
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        log(f"  9d POTRF-T N={N} NB={nb}, {dirty} dirty device tiles: "
            f"reshape_geometry to NB={nb // 2} {t_geo:.1f} ms, bit for bit "
            f"{same_geo}; build_reshape_dtype to float16 {t_cast:.1f} ms, "
            f"bit for bit {same_cast}; build_reduce_col np.add "
            f"{t_red:.1f} ms, max|got - float64| / max|float64| {rel:.3e} "
            "(limit 1e-4)")
        if dirty <= 0 or not (same_geo and same_cast and rel <= 1e-4):
            raise AssertionError("9d: a reshape path read stale tiles or "
                                 "disagrees")
        out["runs"]["9d reshape"] = {"dirty_tiles": dirty,
                                     "geometry_ms": t_geo, "cast_ms": t_cast,
                                     "reduce_ms": t_red, "reduce_rel": rel}
        dev.stop()
        del dense, want, got

    # ------------------------------------------ 9e, affinity on one card
    side = dims["chain"]

    def chain(skew):
        with pt.Context(nb_workers=4) as ctx:
            if skew is not None:
                ctx.device_set_affinity_skew(skew)
            arr = np.ones((side * side,), dtype=np.float32)
            ctx.register_linear_collection("A", arr, elem_size=arr.nbytes)
            ctx.register_arena("t", arr.nbytes)
            d0 = CudaDevice(ctx, device=dev_t)
            d1 = CudaDevice(ctx, device=dev_t)
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
            shp = {"X": (side, side)}
            d0.attach(prod, tp, kernel=lambda x: x + 1.0, reads=["X"],
                      writes=["X"], shapes=shp)
            # the sibling first: a load tie points away from the data
            d1.attach(cons, tp, kernel=lambda x: x * 2.0, reads=["X"],
                      writes=["X"], shapes=shp)
            d0.attach(cons, tp, kernel=lambda x: x * 2.0, reads=["X"],
                      writes=["X"], shapes=shp)
            tp.run()
            tp.wait()
            for dv in (d0, d1):
                dv.flush()
            sync(dev_t)
            res = (d0.stats["tasks"], d1.stats["tasks"],
                   d0.stats["d2d_bytes"] + d1.stats["d2d_bytes"],
                   bool(np.all(arr == 46.0)))
            d0.stop()
            d1.stop()
        return res

    aff, off = chain(None), chain(0.0)
    log(f"  9e chain of 4 producers and 4 consumers on ({side}, {side}) "
        f"f32, two devices on one card: default skew tasks d0/d1 "
        f"{aff[0]}/{aff[1]}, d2d {aff[2]} B; skew 0 tasks {off[0]}/{off[1]}"
        f", d2d {off[2]} B; data exact {aff[3]}/{off[3]}")
    if not (aff[2] == 0 and aff[1] == 0 and off[2] > 0 and aff[3]
            and off[3]):
        raise AssertionError(f"9e: affinity routing {aff} / {off}")
    n, nb = dims["gemm2"]
    a = rng.standard_normal((n, n), dtype=np.float32)
    b = rng.standard_normal((n, n), dtype=np.float32)
    with pt.Context(nb_workers=4) as ctx:
        A, B = to_collection(a, nb, nb), to_collection(b, nb, nb)
        C = to_collection(np.zeros((n, n), np.float32), nb, nb)
        for name, coll in (("A", A), ("B", B), ("C", C)):
            coll.register(ctx, name)
        d0 = CudaDevice(ctx, device=dev_t)
        d1 = CudaDevice(ctx, device=dev_t)
        ctx.device_queue_set_weight(d0.qid, 2.0)
        ctx.device_queue_set_weight(d1.qid, 1.0)
        tp = build_gemm(ctx, A, B, C, d0)
        d1.attach(tp.classes[0], tp, kernel=k_gemm_nn,
                  reads=["A", "B", "C"], writes=["C"],
                  shapes={f: (nb, nb) for f in "ABC"})
        sync(dev_t)
        t = time.perf_counter()
        tp.run()
        tp.wait()
        for dv in (d0, d1):
            dv.flush()
        sync(dev_t)
        wall = (time.perf_counter() - t) * 1e3
        split = (d0.stats["tasks"], d1.stats["tasks"])
        d2d = d0.stats["d2d_bytes"] + d1.stats["d2d_bytes"]
        log(f"  9e GEMM {n}^2 over two devices weighted 2:1: {wall:.1f} ms, "
            f"tasks d0/d1 {split[0]}/{split[1]}, d2d {d2d} B")
        if sum(split) != (n // nb) ** 3:
            raise AssertionError(f"9e GEMM: {split} device tasks")
        check_close("9e GEMM C vs torch.matmul",
                    to_tensor(C.to_dense(), dev_t),
                    torch.matmul(to_tensor(a, dev_t), to_tensor(b, dev_t)),
                    1e-4, 1e-3)
        d0.stop()
        d1.stop()
    out["runs"]["9e affinity"] = {"chain_default": aff, "chain_skew0": off,
                                  "gemm_wall_ms": wall, "gemm_split": split,
                                  "gemm_d2d_bytes": d2d}
    return out


def serve_oracle(model, req, dev_t, head64):
    """The request's outputs and logits recomputed on the engine's own
    token stream (teacher-forced): per step, q of the query token and
    K/V of every token before it from the port's PagedLM, then plain
    per-head softmax(q K^T * scale) V in float64 on the card, and the
    model head in float64.  Returns (outputs [n, d], logits [n, vocab])
    as float64 tensors.  head64 = (wo, embed) in float64 on the card."""
    import torch
    H, dh = model.cfg.heads, model.dh
    Lp, n = len(req.prompt), len(req.outputs)
    rows = [model.qkv(t) for t in req.tokens[:Lp + n - 1]]
    f64 = dict(device=dev_t, dtype=torch.float64)
    q = torch.tensor(np.stack([r[0] for r in rows[Lp - 1:]]), **f64)
    k = torch.tensor(np.stack([r[1] for r in rows]), **f64)
    v = torch.tensor(np.stack([r[2] for r in rows]), **f64)
    T = k.shape[0]
    s = torch.einsum("thd,jhd->thj", q.view(n, H, dh), k.view(T, H, dh)) \
        * model.scale
    # step t attends to the first Lp + t tokens
    keep = torch.arange(T, device=dev_t)[None, :] < \
        (Lp + torch.arange(n, device=dev_t))[:, None]
    s = s.masked_fill(~keep[:, None, :], float("-inf"))
    o = torch.einsum("thj,jhd->thd", torch.softmax(s, -1),
                     v.view(T, H, dh)).reshape(n, H * dh)
    wo, embed = head64
    return o, (o @ wo) @ embed.T


def serve_path(dev_t, observe=None) -> dict:
    """The serving path at Llama-2-7B attention widths (hidden 4096, 32
    heads, vocab 32000; page 16): a two-tenant continuous-batching run
    of 8 requests, then a short speculative run, each through Context ->
    Server -> InferenceEngine -> CudaDevice, checked against the float64
    oracle.  observe(label, fn) runs each engine's decode loop (a
    profiler may wrap it); returns the numbers the smoke prints."""
    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.ops.paged_attention import (attend_heads,
                                                      fold_heads, reset_acc)
    from parsec_tpu_torch.serve import (InferenceEngine, PagedLM,
                                        PagedLMConfig, TenantConfig)
    if observe is None:
        def observe(label, fn):
            fn()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("SERVE: TF32 is on for float32 products")
    out = {}
    cfg = PagedLMConfig(vocab=32000, d=4096, heads=32, page=16, seed=SEED)
    H, P, d = cfg.heads, cfg.page, cfg.d
    t = time.perf_counter()
    model = PagedLM(cfg)
    torch.cuda.synchronize()
    log(f"  PagedLM(vocab={cfg.vocab}, d={d}, heads={H}, page={P}) on "
        f"{model.device}: {time.perf_counter() - t:.1f} s to draw and "
        f"place {sum(b.numel() for b in model.buffers()) * 4 / 2**20:.0f} "
        "MiB of weights")

    # the fold chore alone at the decode wave's shapes: 1 lane (a
    # decode PATTF) and 8 lanes, against the numpy host fold
    rng = np.random.default_rng(SEED + 1)
    for lanes in (1, 8):
        qn = (0.5 * rng.standard_normal((lanes, 1, d))).astype(np.float32)
        kn = (0.5 * rng.standard_normal((lanes, P, d))).astype(np.float32)
        vn = (0.5 * rng.standard_normal((lanes, P, d))).astype(np.float32)
        an = np.zeros((lanes, 1, d + 2 * H), np.float32)
        for i in range(lanes):
            reset_acc(an[i], H)
            attend_heads(qn[i, 0], kn[i], vn[i], an[i], model.scale, H)
        ins = [torch.from_numpy(a).to(dev_t) for a in (qn, kn, vn, an)]
        host = an.copy()
        for i in range(lanes):
            attend_heads(qn[i, 0], kn[i], vn[i], host[i], model.scale, H)
        got = fold_heads(*ins, model.scale, H)
        torch.cuda.synchronize()
        # f32 sums over 128 (scores) and 16 (p @ V) terms in another order
        err = check_close(f"fold_heads [{lanes}, {P}, {d}], {H} heads, vs "
                          "the numpy host fold", got,
                          torch.from_numpy(host).to(dev_t), 1e-5, 1e-5)
        ms = time_ms(lambda: fold_heads(*ins, model.scale, H), 200, 10)
        nbytes = sum(a.nbytes for a in (qn, kn, vn, an)) + an.nbytes
        out[f"fold_{lanes}"] = {"ms": ms, "max_abs_err": err,
                                "bound_ms": nbytes / card_peaks(
                                    torch.cuda.get_device_name(0))[1][0]
                                * 1e3}
        log(f"  fold_heads {lanes} lane(s): {ms:.4f} ms a launch (CUDA "
            f"events, mean of 200), byte bound "
            f"{out[f'fold_{lanes}']['bound_ms']:.6f} ms")

    max_new = 8
    lens = [256 * (i + 1) for i in range(8)]
    prompts = [[int(x) for x in rng.integers(0, cfg.vocab, size=n)]
               for n in lens]
    # the 1280- and 1536-token prompts share their first 1024 tokens:
    # 64 full pages the second one maps onto frozen pages
    prompts[5][:1024] = prompts[4][:1024]
    tenants = ["hi" if i % 2 == 0 else "lo" for i in range(8)]

    head64 = (model.wo.double(), model.embed.double())

    def check_requests(label, hs, n_new):
        worst, ties = 0.0, 0
        for h in hs:
            if h.state != "done" or len(h.generated) != n_new:
                raise AssertionError(f"{label}: request {h.rid} ended "
                                     f"{h.state} with {len(h.generated)} "
                                     f"of {n_new} tokens")
            o, logits = serve_oracle(model, h, dev_t, head64)
            err = check_close(
                f"{label} request {h.rid} ({len(h.prompt)} tokens) "
                "outputs vs the float64 oracle",
                torch.from_numpy(np.stack(h.outputs)).to(dev_t), o,
                1e-4, 1e-5)
            worst = max(worst, err)
            top2 = torch.topk(logits, 2, dim=-1)
            for t, tok in enumerate(h.generated):
                if int(top2.indices[t, 0]) == tok:
                    continue
                gap = float(top2.values[t, 0] - top2.values[t, 1])
                if gap > 1e-4:
                    raise AssertionError(
                        f"{label} request {h.rid} step {t}: token {tok}, "
                        f"the oracle's argmax {int(top2.indices[t, 0])} "
                        f"leads by {gap:.3e}")
                ties += 1
        log(f"  {label}: {len(hs)} requests match the oracle, max abs err "
            f"{worst:.3e}; tokens off the oracle's argmax within a 1e-4 "
            f"tie: {ties}")
        return worst, ties

    with pt.Context(nb_workers=4, scheduler="lws") as ctx:
        dev = CudaDevice(ctx)
        eng = InferenceEngine(
            ctx, model, n_pages=1200, max_seqs=8, dev=dev,
            tenants=[TenantConfig("hi", priority=4, weight=4),
                     TenantConfig("lo")])
        t0 = time.perf_counter()
        # the prefix owner is served first, so its frozen pages exist
        # when the sharer is admitted
        first = eng.submit(prompts[4], max_new, tenants[4])
        first.ticket.wait()
        hs = [eng.submit(prompts[i], max_new, tenants[i])
              for i in range(8) if i != 4]
        hs.insert(4, first)
        walls = []

        def decode():
            deadline = time.monotonic() + 600
            while eng.pending() or eng._inflight:
                if time.monotonic() > deadline:
                    raise TimeoutError("SERVE: decode loop past 600 s")
                ts = time.perf_counter()
                n = eng.step()
                torch.cuda.synchronize()
                if n:
                    walls.append(time.perf_counter() - ts)
                else:
                    time.sleep(0.0005)
            eng.settle()

        observe("SERVE 8 requests, 2 tenants", decode)
        wall = time.perf_counter() - t0
        st = dict(dev.stats)
        pool = eng.pool.stats()
        scope = ctx.stats()["scope"]
        eng.close()
        dev.stop()
        gen = sum(len(h.generated) for h in hs)
        out["tokens_per_s"] = gen / wall
        out["step_wall_p50_ms"] = float(np.percentile(walls, 50)) * 1e3
        log(f"  SERVE: {gen} tokens in {wall:.2f} s = "
            f"{out['tokens_per_s']:.2f} tokens/s; {len(walls)} decode "
            f"steps, wall p50 {out['step_wall_p50_ms']:.1f} ms, max "
            f"{max(walls) * 1e3:.1f} ms; decode pools "
            f"{eng.stats['decode_pools']}; prefix hits "
            f"{pool['prefix_hits']} of {pool['prefix_hits'] + pool['prefix_misses']} "
            f"pages")
        for tn in ("hi", "lo"):
            ttft = [(r.first_token_ns - r.submitted_ns) / 1e6
                    for h in hs if h.tenant == tn
                    for r in [eng.scope.request(h.rid)]]
            out[f"ttft_{tn}"] = (float(np.percentile(ttft, 50)),
                                 float(np.percentile(ttft, 99)))
            log(f"  SERVE tenant {tn}: TTFT p50 {out[f'ttft_{tn}'][0]:.1f}"
                f" ms, p99 {out[f'ttft_{tn}'][1]:.1f} ms over {len(ttft)} "
                f"requests (scope histogram p50 "
                f"{scope['tenants'][tn]['ttft_ns_p50'] / 1e6:.1f} ms)")
        # every request takes max_new - 1 decode token steps (the prefill
        # emits its first token), and each folds every frozen page once
        token_steps = max_new - 1
        out["fold_tasks_per_token_step"] = st["tasks"] / token_steps
        log(f"  SERVE device: tasks={st['tasks']} batches={st['batches']} "
            f"h2d_bytes={st['h2d_bytes']} h2d_hits={st['h2d_hits']} "
            f"h2d_stall={st['h2d_stall_ns'] / 1e6:.1f} ms "
            f"invalidations={st['invalidations']} "
            f"cache_peak={st['cache_peak_bytes']}; {token_steps} decode "
            f"token steps a request = "
            f"{out['fold_tasks_per_token_step']:.1f} fold launches for one "
            f"token of all {len(hs)} requests; the {len(walls)} step() "
            f"calls took {sum(walls) * 1e3:.1f} ms = "
            f"{sum(walls) * 1e3 / max(1, st['tasks']):.3f} ms a fold task")
        out["max_abs_err"], out["ties"] = check_requests(
            "SERVE", hs, max_new)
        if st["tasks"] <= 0 or st["h2d_hits"] <= 0:
            raise AssertionError("SERVE: the device folded nothing")
        if pool["prefix_hits"] < 64:
            raise AssertionError(f"SERVE: {pool['prefix_hits']} prefix "
                                 "hits, expected at least 64")
        out["device"] = st

    # speculative decoding: the verify wave's folds run batched
    spec_prompts = [[int(x) for x in rng.integers(0, cfg.vocab, size=512)]
                    for _ in range(2)]
    with pt.Context(nb_workers=4, scheduler="lws") as ctx:
        dev = CudaDevice(ctx)
        eng = InferenceEngine(ctx, model, n_pages=256, max_seqs=2, dev=dev,
                              tenants=[TenantConfig("hi", priority=4,
                                                    weight=4)], spec_k=2)
        t0 = time.perf_counter()
        hs = [eng.submit(p, 6, "hi") for p in spec_prompts]
        observe("SERVE speculative, spec_k=2",
                lambda: eng.run(timeout_s=600))
        wall = time.perf_counter() - t0
        st = dict(dev.stats)
        es = dict(eng.stats)
        eng.close()
        dev.stop()
        log(f"  SERVE spec_k=2: {wall:.2f} s, spec steps "
            f"{es['spec_steps']}, proposed {es['spec_proposed']}, "
            f"accepted {es['spec_accepted']}; device tasks={st['tasks']} "
            f"batches={st['batches']} batched_tasks={st['batched_tasks']}")
        check_requests("SERVE spec_k=2", hs, 6)
        if st["batches"] <= 0:
            raise AssertionError("SERVE spec: no batched verify launch")
        if es["spec_accepted"] <= 0:
            raise AssertionError("SERVE spec: no draft token accepted")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from parsec_tpu_torch import kernels
    from parsec_tpu_torch.convert import to_tensor
    # the modules (the ops package exports functions of the same names)
    fa_mod = importlib.import_module("parsec_tpu_torch.ops.flash_attention")
    rn_mod = importlib.import_module("parsec_tpu_torch.ops.rms_norm")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_t = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ---------------------------------------------------------- phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    part, (bw, f32_peak, tf32_peak) = card_peaks(kind)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; bounds use "
        f"the H100 {part} data sheet: {bw / 1e12:g} TB/s, "
        f"{f32_peak / 1e12:g} TFLOP/s float32 (non-tensor), "
        f"{tf32_peak / 1e12:g} TFLOP/s TF32 (tensor cores)")
    t0 = time.perf_counter()
    reports = kernels.build_all()
    log(f"phase 1: built {len(reports)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        log(f"  {name} (ptxas -v, per instantiation):")
        for line in ptxas_summary(rep):
            log(f"    {line}")
    for dt in (torch.float32, torch.bfloat16):
        smem, threads, blocks = fa_mod.kernel_occupancy(dt, 128)
        log(f"  flash_attention <{dt}, 128>: {smem} bytes of shared memory "
            f"and {threads} threads a block, {blocks} block(s) = "
            f"{blocks * threads // 32} warps resident per SM")

    rng = np.random.default_rng(SEED)

    # ---------------------------------------------------------- phase 2
    log("phase 2: kernels against their plain versions on the card")
    rows, d = 8 * 4096, 4096           # NORM: 8 sequences x 4096 tokens
    x = to_tensor(rng.standard_normal((rows, d), dtype=np.float32), dev_t)
    w = to_tensor(rng.standard_normal((d,), dtype=np.float32), dev_t)
    # f32 at the reference's 2e-5; bf16 at 1.6e-2 relative (two bf16
    # ulps: the f32 sums differ in order, which can move one rounding)
    y_k = rn_mod.rms_norm_cuda(x, w, EPS)
    torch.cuda.synchronize()
    rms_err = check_close("rms_norm f32 [32768, 4096]", y_k,
                          rn_mod.rms_norm_plain(x, w, EPS), 2e-5, 2e-5)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    check_close("rms_norm bf16 [32768, 4096]",
                rn_mod.rms_norm_cuda(xb, wb, EPS),
                rn_mod.rms_norm_plain(xb, wb, EPS), 1.6e-2, 1e-2)
    del y_k, xb, wb

    L, H, D = 4096, 32, 128
    scale = D ** -0.5
    q4, k4, v4 = (to_tensor(rng.standard_normal((1, L, H, D),
                                                dtype=np.float32), dev_t)
                  for _ in range(3))

    def fold(t):
        return t.permute(0, 2, 1, 3).reshape(H, L, D)

    # f32 FMA in both: the reference's 2e-5 tolerance
    for causal in (False, True):
        got = fa_mod.flash_attention(q4, k4, v4, causal=causal)
        want = fa_mod.attention_reference(fold(q4), fold(k4), fold(v4),
                                          causal, scale)
        torch.cuda.synchronize()
        check_close(f"flash_attention [1, 4096, 32, 128] causal={causal}",
                    fold(got), want, 2e-5, 2e-5)
        del got, want
    # the FATT wave's shape: 32 query blocks as lanes over ONE shared K/V
    # (lane stride 0)
    qw = fold(q4).contiguous()
    kw = k4[0, :, 0, :].contiguous().unsqueeze(0).expand(H, L, D)
    vw = v4[0, :, 0, :].contiguous().unsqueeze(0).expand(H, L, D)
    fa_err = check_close(
        "flash_attention lanes [32, 4096, 128], K/V lane stride 0",
        fa_mod.flash_attention_cuda(qw, kw, vw, False, scale),
        fa_mod.attention_reference(qw, kw, vw, False, scale), 2e-5, 2e-5)
    # bf16 in and out: f32 sums in another order, one bf16 rounding each
    # (the RMSNorm bf16 tolerance)
    qh = qw.to(torch.bfloat16)
    kh, vh = (t[0].to(torch.bfloat16).unsqueeze(0).expand(H, L, D)
              for t in (kw, vw))
    check_close("flash_attention bf16 lanes [32, 4096, 128], K/V lane "
                "stride 0", fa_mod.flash_attention_cuda(qh, kh, vh, False,
                                                        scale),
                fa_mod.attention_reference(qh, kh, vh, False, scale),
                1.6e-2, 1e-2)
    del q4, k4, v4, qh, kh, vh
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 3
    log("phase 3: times (CUDA events)")
    import torch.nn.functional as F
    rms = {"ms": time_ms(lambda: rn_mod.rms_norm_cuda(x, w, EPS), 20),
           "plain_ms": time_ms(lambda: rn_mod.rms_norm_plain(x, w, EPS), 10),
           "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, EPS), 20)
           if hasattr(F, "rms_norm") else None}
    rms_bytes = 2 * x.numel() * x.element_size() + w.numel() * 4
    rms_ops = 4 * x.numel()
    rms["bound_ms"] = max(rms_bytes / bw, rms_ops / f32_peak) * 1e3
    rms["bound_by"] = "bytes" if rms_bytes / bw >= rms_ops / f32_peak \
        else "operations"
    qs, ks, vs = (t.unsqueeze(0) for t in (qw, kw.contiguous(),
                                           vw.contiguous()))
    fa = {"ms": time_ms(lambda: fa_mod.flash_attention_cuda(
              qw, kw, vw, False, scale), 20),
          "plain_ms": time_ms(lambda: fa_mod.attention_reference(
              qw, kw, vw, False, scale), 3),
          "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
              qs, ks, vs, scale=scale), 5)}
    # f32-accurate operations either as f32 FMA on the CUDA cores or as
    # three TF32 passes (3xTF32) on the tensor cores, whichever is faster;
    # the bound is the larger of that and the bytes
    fa_ops = 4 * H * L * L * D
    fa_bytes = (2 * qw.numel() + 2 * L * D) * 4
    t_fma, t_tc, t_bytes = (fa_ops / f32_peak, 3 * fa_ops / tf32_peak,
                            fa_bytes / bw)
    fa["bound_ms"] = max(t_bytes, min(t_fma, t_tc)) * 1e3
    fa["bound_by"] = "operations" if min(t_fma, t_tc) >= t_bytes \
        else "bytes"
    log(f"  flash_attention bound: f32 FMA {t_fma * 1e3:.4f} ms, 3xTF32 "
        f"tensor cores {t_tc * 1e3:.4f} ms, bytes {t_bytes * 1e3:.4f} ms; "
        f"achieved {fa_ops / fa['ms'] / 1e9:.1f} TFLOP/s of attention "
        f"({3 * fa_ops / fa['ms'] / 1e9:.1f} TFLOP/s TF32), SDPA "
        f"{fa_ops / fa['library_ms'] / 1e9:.1f} TFLOP/s")
    for name, r in (("rms_norm", rms), ("flash_attention", fa)):
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, library {r['library_ms']} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    del x, w, qw, kw, vw, qs, ks, vs
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 4
    log("phase 4: the main path, Context -> Taskpool -> CudaDevice")
    launches = {name: 0 for name in kernels.LAUNCHES}

    def drive(label, tp, dev, ntasks):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        tp.run()
        tp.wait()
        dev.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = dict(kernels.LAUNCHES)
        for name, n in got.items():
            launches[name] += n
        st = dev.stats
        log(f"  {label}: {wall * 1e3:.1f} ms wall, tasks={st['tasks']} "
            f"batches={st['batches']} h2d_hits={st['h2d_hits']} "
            f"h2d_bytes={st['h2d_bytes']} d2h_bytes={st['d2h_bytes']} "
            f"launches={got}")
        if st["tasks"] != ntasks:
            raise AssertionError(f"{label}: stats tasks {st['tasks']} != "
                                 f"{ntasks}")
        if st["batches"] <= 0:
            raise AssertionError(f"{label}: no batched launch")
        return got

    # phase 8 replays phase 4's draws from this state
    phase4_rng = rng.bit_generator.state
    norm_o = main_path(rng, dev_t, drive)

    log("phase 5: the serving path, Context -> Server -> InferenceEngine "
        "-> CudaDevice, at Llama-2-7B attention widths")
    # the serving path launches none of the hand-written kernels (its
    # device chore is the torch fold); its counts are read all the same
    kernels.reset_launches()
    t = time.perf_counter()
    serve = serve_path(dev_t)
    log(f"  SERVE phase {time.perf_counter() - t:.1f} s; hand-written "
        f"kernel launches in it: {dict(kernels.LAUNCHES)}")
    log(f"  SERVE summary: {serve['tokens_per_s']:.2f} tokens/s, decode "
        f"step wall p50 {serve['step_wall_p50_ms']:.1f} ms, TTFT p50/p99 "
        f"hi {serve['ttft_hi'][0]:.1f}/{serve['ttft_hi'][1]:.1f} ms, lo "
        f"{serve['ttft_lo'][0]:.1f}/{serve['ttft_lo'][1]:.1f} ms")

    log("phase 6: dense linear algebra, Context -> Taskpool -> CudaDevice, "
        "f32, matrices generated on the card")
    # the dense chores are library calls, none a hand-written kernel;
    # the counts are read all the same
    kernels.reset_launches()
    t = time.perf_counter()
    dense = dense_la_path(dev_t)
    log("  every chore of phase 6 at its path's shape (CUDA events):")
    time_chores(dev_t, dense["chores"])
    log(f"  DENSE phase {time.perf_counter() - t:.1f} s; hand-written "
        f"kernel launches in it: {dict(kernels.LAUNCHES)}")
    for label, row in dense["paths"].items():
        if label.startswith("POTRF-P"):
            log(f"  {label} flush: {row['flush_bytes']} B in "
                f"{row['wall_flush_ms'] - row['wall_ms']:.1f} ms = "
                f"{row['flush_gbps']:.2f} GB/s (stacked d2h on the d2h "
                "stream into pinned staging, then the host tiles)")

    log("phase 7: the device pipeline, Context -> Taskpool -> CudaDevice: "
        "prefetch lane off and on, out-of-core spill")
    t = time.perf_counter()
    pipe = pipeline_path(dev_t)
    for name, n in pipe["launches"].items():
        launches[name] += n
    log(f"  PIPELINE phase {time.perf_counter() - t:.1f} s; hand-written "
        f"kernel launches in it: {pipe['launches']}")

    log("phase 8: the DSL front ends on the card: DTD device tasks and a "
        "JDF BODY [type=CUDA] -> CudaDevice, on phase 4's data")
    t = time.perf_counter()
    rng8 = np.random.default_rng()
    rng8.bit_generator.state = phase4_rng
    dsl = dsl_path(dev_t, rng8, ptg_norm_o=norm_o)
    for name, n in dsl["launches"].items():
        launches[name] += n
    log(f"  DSL phase {time.perf_counter() - t:.1f} s; hand-written "
        f"kernel launches in it: {dsl['launches']}")

    log("phase 9: the rest of the one-rank runtime and its own trace: "
        "traced paths, recursive and composed pools, reshape, affinity")
    t = time.perf_counter()
    rng9 = np.random.default_rng()
    rng9.bit_generator.state = phase4_rng
    rt = runtime_path(dev_t, rng9, ptg_norm_o=norm_o)
    del norm_o
    for name, n in rt["launches"].items():
        launches[name] += n
    log(f"  RUNTIME phase {time.perf_counter() - t:.1f} s; hand-written "
        f"kernel launches in it: {rt['launches']}")
    log(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"dense_la": dense}))
    print(json.dumps({"pipeline": pipe["runs"]}))
    print(json.dumps({"dsl": dsl["runs"]}))
    print(json.dumps({"runtime": rt["runs"]}))

    rows_out = []
    for name, r, err, repl in (
            ("rms_norm", rms, rms_err,
             "parsec_tpu/ops/rms_norm.py:21"),
            ("flash_attention", fa, fa_err,
             "parsec_tpu/ops/flash_attention.py:33")):
        rows_out.append({
            "name": name, "route": "cuda",
            "source": f"parsec_tpu_torch/kernels/{name}.cu",
            "replaces": repl, "launches": launches[name],
            "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
