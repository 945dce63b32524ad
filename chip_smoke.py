#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (parsec_tpu_torch) on one card.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --gloo-probe   # which gloo ops take CUDA tensors

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
 10. drive the profiling layer and the static analyses (observe_path):
     the card's h2d fit, PINS and the histograms against the device's
     stats, verify and plan, the tuner, serving with conformance, the
     watchdog and the journal
 11. drive wave and chain fusion, plan_check and the chain hints
     (fuse_path): phase 4's GEMM fused and unfused (device.wave_fuse=0)
     in turns, bit for bit, spans and chains counted; NORM, FATT and
     POTRF-T fused against unfused bit for bit; plan_check's peak bound,
     its spill verdict on the out-of-core GEMM and its error mode; the
     lane's hinted stages
 12. drive the comm engine (comm_path): two ranks as two spawned
     processes on this one card over the loopback transport run the
     distributed GEMM at phase 4's size under three broadcast topologies
     and with comm.eager_limit=0, fused against unfused (12a); phase 4's
     NORM as a two-rank chain whose intermediate crosses through the
     device data plane, streamed and not (12b); the collectives over 64
     MiB and the k-split GEMM panel reduction (12d); a traced GEMM merged
     on the clock offsets (12e); then two colocated ranks in this
     process move 12b's intermediate as on-card clones (12c).  A rank
     that fails or times out fails the phase
 13. drive the multi-rank taskpools and tensor-parallel serving
     (multi_path), float32 with TF32 off, numpy-made inputs: ring
     attention over a 32768-token context (8 shards of 4096, head dim
     128) with every ATT and FIN a device chore, O against float64
     attention on the card (13a); the same on phase 12's two ranks, the
     K/V hops through the data plane (13b); MoE at Mixtral-8x7B's FFN
     widths (d 4096, f 14336, 8 experts, top-2; 4 shards of 2048 tokens)
     with EXP on the card, uncapped and capped, Y against float64 on the
     card (13c); MoE on phase 12's two ranks with combine="chain" and
     "coll" (13d); tp=2 serving (two colocated Contexts as threads)
     against a tp=1 engine, tokens and pre-logits bit for bit, plain and
     speculative (13e); each chore timed at its path's shape beside its
     plain version and bound (13f)
 14. drive the fleet tier (fleet_path) at phase 5's serving widths: the
     serving fold's bits probed across wave widths; a Router over two
     replicas (each its own Context, CudaDevice and InferenceEngine on
     phase 5's PagedLM) against one replica, bit for bit: scored
     placement with every predicted warm page mapped at admission,
     prefill_then_decode with in-process page migration, queued
     requests re-placed off a replica whose health flips (14a); on phase
     12's two ranks, build_page_migration of 32 frozen pages (16 MiB)
     streamed in 128 KiB chunks, then deduplicated by the receiver to 8
     MiB and to nothing (14b), and 12b's NORM chain through the CUDA IPC
     transfer plane (device.dp_transfer), its O 12b's bit for bit
     (14c); the live sampler's comm/stream/topo/fleet rows, the
     watchdog's stalled-pull check and the journal's replicated
     checkpoints (14d); the tuner's collective and streaming proposals
     beside 12d's and 12b's walls (14e)
 15. drive the transformer's training path (train_path) at Llama-2-7B's
     widths (vocab 32000, d 4096, 32 heads x 128, d_ff 11008; depth 4 of
     32), f32 with TF32 off, both kernels in it (use_flash,
     use_pallas_norm): 8 steps of training.train on one fixed batch of
     4 x 2048 tokens, every loss finite and falling, the kernels'
     launches per step (15a); the loss and every gradient at batch 1
     through both kernels against the plain path in float64 on the card
     (15b); 2 steps, a checkpoint, 2 more, against a fresh model and
     optimizer loaded from it, bit for bit, at depth 1 (15c); each
     kernel at 15a's shapes against its plain version, timed beside its
     bound; on phase 12's two ranks, gloo with CUDA tensors, the mesh
     libraries (ring and Ulysses attention, MoE, gpipe, the LM's forward
     at tp=2 and sp=2) against their one-rank calls (15d, mesh_rank)
 16. drive the repo's tools on the port (tools_path), each as python -m
     parsec_tpu_torch.tools.<stem> and held to its exit status: phase
     4's NORM and FATT pools traced at level 2 (both kernels launched,
     O at 2e-5 of the plain versions) and read by ptt_info, ptt2tables,
     ptt2dot, ptt_critpath and ptc_plan --trace (16a); ptc_verify,
     plan_graphs and ptc_tune --check over every in-tree generator and
     jdf2dot over examples/Ex01-Ex08 (16b); ptc_postmortem on phase
     10f's journal (16c); the card probes probe_la_kernels (NB 512 and
     1024), probe_launch_overhead, bench_dtd_gemm, bench_dataplane at 16
     and 64 MiB over bytes and the transfer plane, and testbandwidth
     --quick, whose document TransferEconomics.load reads (16d)
 17. drive the benchmark entry point (bench_path), each suite as python
     -m parsec_tpu_torch.bench ... --json build/torch_bench/BENCH_<suite>
     .json, held to exit 0 and a last stdout line that parses: the
     headline at one rung (N 32768, NB 512: phase 6's POTRF-P), its
     residual gated and its GFLOP/s beside torch.linalg.cholesky and
     phase 6's, then the tiled child at N 16384, NB 1024 (17a); the ring
     at S 8 x T 2048, d 128, max_abs_err <= 5e-2 (17b); the device,
     stream, serve and control suites, their bit_identical and correct
     flags true, every dp_errors 0 (17c); the dispatch, trace, ep,
     collective and topology suites (17d); tools/bench_check over the
     documents, every guarded path found and every `equal` row true but
     four timing verdicts, which are printed (17e)
 18. drive the native core's concurrency soak (soak_path): python -m
     parsec_tpu_torch.tools.stress_tsan at STRESS_REPS=1, without TSAN,
     held to exit 0 and "stress ok": its 15 jobs from many threads in one
     process, wave_fuse_gemm (C within 2e-3 of float64) and
     tp_decode_churn (tokens bit for bit the single-rank reference) with
     a CudaDevice on the card and dp_errors 0; each job's wall printed
 19. drive the debug streams (debug_path): phase 4's NORM path at 4
     tiles of (1024, 4096) f32 in a child process with
     PTC_MCA_debug_runtime=1 and PTC_MCA_debug_device=1, O held to the
     plain RMSNorm at 2e-5; its stderr must hold the device's 'device
     up: cuda:0 ...' and 'flush: 4 dirty mirrors' lines and the
     runtime's two taskpool lines, and no comm line; its wall printed
Phases 1-10 run with fusion on, the default.  Then print the dense-LA
line, the pipeline line, the DSL line, the runtime line, the observe
line, the fuse line, the comm line, the multi line (with the chores'
rows), the fleet line, the train line, the tools line, the bench line,
the soak line, the debug line and the kernels line (JSON; the kernels'
launches are those of phases 4, 7-11, 12, 14c (both ranks'), 15a, 16a
and 19 (its child's)) and, last, the device line (JSON).
Exits non-zero, printing no result, when there is no CUDA card.
"""
from __future__ import annotations

import hashlib
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
    the DTD dispatch (vmapped lanes where the kernel allows) against
    PTG's lane groups, both warm (phase 4's runs are each path's first in
    the process).  Each run's wall is from its first insert (PTG and JDF:
    building the pool and run()) through wait(), dev.flush() and a
    synchronize, printed with the task count and the hand-written
    kernels' launches in the run; on a card the DTD runs must launch
    their kernel once a task (the ops' wrappers refuse vmap).  Returns {"runs":
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
    DEVICE_H2D_AHEAD spans, dispatch begins and ends, lanes, staging bytes
    (DEVICE_H2D and, off the path, DEVICE_H2D_AHEAD) and the ends' stall
    aux; per
    task class (DTD bodies: class -1) its dispatch spans, their summed
    host time and stall; the pool's critical path and lost time."""
    from parsec_tpu_torch.profiling import (KEY_DEVICE, KEY_H2D,
                                            KEY_H2D_AHEAD, KEY_RELEASE,
                                            critical_path, lost_time)
    ev = tr.events
    beg = ev[:, 1] == 0
    d = ev[:, 0] == KEY_DEVICE
    lane = ev[:, 0] == KEY_H2D_AHEAD
    h = (ev[:, 0] == KEY_H2D) | lane
    per = {}
    busy = {"release_ms": 0.0, "lane_h2d_ms": 0.0}
    for (_, _, key, cid, l0, _, aux, t0, t1) in tr.spans():
        if key == KEY_RELEASE:
            busy["release_ms"] += (t1 - t0) / 1e6
        elif key == KEY_H2D_AHEAD:
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
            "h2d_lane_bytes": int(ev[lane & beg, 3].sum()),
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
            st["fuse"] = dev.info()["fuse"]
            st["chore_calls"] = sum(v[0] for v in dev.launches.values())
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
            fs = st["fuse"]
            log(f"    fuse: chains {fs['fused_chains']}, chained levels "
                f"{fs['chain_waves']}, chain hits {fs['chain_hits']}, "
                f"misses {fs['chain_misses']}, refused {fs['refused']}")
            # a task completed from a parked chain result (device/fuse.py)
            # is in stats tasks but opens no span, and each chained level
            # is one chore call inside its chain's span
            checks = {
                "dispatch begins == ends": s["dispatch_begins"]
                == s["dispatch_ends"] > 0,
                "lanes + chain hits == stats tasks":
                    s["lanes"] + fs["chain_hits"] == st["tasks"],
                "spans + chained levels == chore calls":
                    s["dispatch_begins"] + fs["chain_waves"]
                    == st["chore_calls"],
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


def serve_round(model, prompts, tenants, max_new, observe, label,
                conformance=True, trace=False):
    """One continuous-batching round of serve_path: a fresh Context(4
    workers, lws) -> CudaDevice -> InferenceEngine over `prompts` (the
    prefix owner, prompts[4], served first so its frozen pages exist
    when the sharer is admitted), every request to `max_new` tokens.
    `conformance` is the engine's and its server's; `trace` traces the
    round at level 1 and returns the trace with its scope registry.
    Returns the handles, tokens/s, step walls, TTFTs, the counters and
    the host time Taskpool.plan took (the conformance plans, on the
    submit and decode paths; timed around the class's method)."""
    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.profiling import take_trace
    from parsec_tpu_torch.serve import (InferenceEngine, Server,
                                        TenantConfig)
    r = {"plan_ns": 0}
    plan0 = pt.Taskpool.plan

    def timed_plan(tp, *a, **kw):
        t = time.perf_counter_ns()
        try:
            return plan0(tp, *a, **kw)
        finally:
            r["plan_ns"] += time.perf_counter_ns() - t
    pt.Taskpool.plan = timed_plan
    try:
        with pt.Context(nb_workers=4, scheduler="lws") as ctx:
            if trace:
                ctx.profile_enable(1)
            dev = CudaDevice(ctx)
            tcs = [TenantConfig("hi", priority=4, weight=4),
                   TenantConfig("lo")]
            eng = InferenceEngine(
                ctx, model, n_pages=1200, max_seqs=8, dev=dev,
                server=Server(ctx, tcs, name="eng",
                              conformance=conformance),
                conformance=conformance)
            t0 = time.perf_counter()
            first = eng.submit(prompts[4], max_new, tenants[4])
            first.ticket.wait()
            hs = [eng.submit(prompts[i], max_new, tenants[i])
                  for i in range(len(prompts)) if i != 4]
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

            observe(label, decode)
            r["wall_s"] = time.perf_counter() - t0
            r["device"] = dict(dev.stats)
            r["pool"] = eng.pool.stats()
            r["scope"] = ctx.stats()["scope"]
            r["engine"] = dict(eng.stats)
            r["ttft_ms"] = {tn: [(q.first_token_ns - q.submitted_ns) / 1e6
                                 for h in hs if h.tenant == tn
                                 for q in [eng.scope.request(h.rid)]]
                            for tn in ("hi", "lo")}
            if trace:
                dev.stop()  # its lanes joined: no span left open
                r["trace"] = take_trace(ctx)
                r["registry"] = eng.scope
            r["watchdog"] = (ctx._watchdog.status()
                             if ctx._watchdog is not None else None)
            r["journal"] = (ctx._journal.stats()
                            if ctx._journal is not None else None)
            eng.close()
            dev.stop()
    finally:
        pt.Taskpool.plan = plan0
    r["handles"] = hs
    r["walls"] = walls
    r["plan_ms"] = r.pop("plan_ns") / 1e6
    r["generated"] = sum(len(h.generated) for h in hs)
    r["tokens_per_s"] = r["generated"] / r["wall_s"]
    return r


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

    def round_(label, conformance, first):
        r = serve_round(model, prompts, tenants, max_new, observe, label,
                        conformance=conformance)
        if not first:
            # the first round's numbers are the ones the smoke reports
            check_requests(label, r["handles"], max_new)
            return r
        hs, st, pool, scope = r["handles"], r["device"], r["pool"], \
            r["scope"]
        walls = r["walls"]
        out["tokens_per_s"] = r["tokens_per_s"]
        out["step_wall_p50_ms"] = float(np.percentile(walls, 50)) * 1e3
        log(f"  SERVE: {r['generated']} tokens in {r['wall_s']:.2f} s = "
            f"{out['tokens_per_s']:.2f} tokens/s; {len(walls)} decode "
            f"steps, wall p50 {out['step_wall_p50_ms']:.1f} ms, max "
            f"{max(walls) * 1e3:.1f} ms; decode pools "
            f"{r['engine']['decode_pools']}; prefix hits "
            f"{pool['prefix_hits']} of {pool['prefix_hits'] + pool['prefix_misses']} "
            f"pages")
        for tn in ("hi", "lo"):
            ttft = r["ttft_ms"][tn]
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
        return r

    # conformance (every pool planned) is the default; the same round
    # without it, in turns: on, off, on
    turns = {"on": [], "off": []}
    for k, (key, conf) in enumerate((("on", True), ("off", False),
                                     ("on", True))):
        r = round_(f"SERVE conformance={key}", conf, k == 0)
        cov = r["scope"]["conformance"]["coverage"]
        if conf and cov != 1.0:
            raise AssertionError(f"SERVE: conformance coverage {cov}, "
                                 "expected 1.0 (a plan failed)")
        turns[key].append(r["tokens_per_s"])
        log(f"  SERVE round {k + 1} conformance={key}: "
            f"{r['tokens_per_s']:.2f} tokens/s, coverage {cov}, makespan "
            f"ratio p50 {r['scope']['conformance']['makespan']['ratio_p50']}"
            f", plan {r['plan_ms']:.1f} ms of host in the decode loop")
    out["tokens_per_s_conformance"] = turns
    # phase 10 serves again with the watchdog and the journal armed
    out["_round"] = (model, prompts, tenants, max_new, check_requests)

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


# phase 10 sizes: phase 4's paths (GEMM (N, NB), NORM (rows, d, T), FATT
# (heads, L, D)), the north-star POTRF-P (N, NB), NORM's PINS-off/on
# runs in turns, and the h2d fit's sizes and repetitions
OBSERVE = {"gemm": (4096, 512), "norm": (8 * 4096, 4096, 1024),
           "fatt": (32, 4096, 128), "potrf_p": (32768, 512),
           "pins_walls": 3,
           # the tile sizes the path moves: GEMM's and POTRF-P's 1 MiB,
           # FATT's 2 MiB, NORM's 16 MiB
           "fit_sizes": (1 << 20, 1 << 21, 1 << 22, 1 << 23, 1 << 24),
           "fit_reps": 5, "tune_topk": 2}


def observe_path(dev_t, rng, serve=None, dims=None, ptg_norm_o=None,
                 out_dir=None) -> dict:
    """Phase 10: the profiling layer and the static analyses on the card.
      10a the card's h2d fit (the pinned buffer on the h2d stream, at
          the tile sizes the path moves, fit_points), written under
          out_dir in the BENCH_comm.json schema for the tuner's device
          pricing; a negative intercept fails the phase (the economics
          would clamp it to 0), and the fit's error at each size is
          printed
      10b phase 4's GEMM, NORM and FATT (`rng` replays main_path's draws)
          in one Context(nb_workers=4) with one PINS chain installed
          (DeviceActivity, TaskCounter, StragglerLog and a count of the
          dispatch-time DEVICE_H2D ends): each pool warm first, then
          planned (tp.plan()) and run with run(verify=True) on a fresh
          CudaDevice; DeviceActivity's waves equal the device's launches
          (NORM's and FATT's equal their kernel's), its lanes the tasks,
          its stall the device's h2d_stall_ns and its lane-split bytes
          the device's h2d_bytes; the plan's est_bytes beside the
          device's cache_peak_bytes and its critical path beside the
          wall; a LiveMonitor samples during NORM (device rows
          required); then the h2d_stall histogram's count equals the
          dispatch-time h2d count and its sum the devices' summed
          h2d_stall_ns, and the exporter is scraped once on localhost
      10c NORM with PINS off and on, pins_walls runs of each in turns,
          O bit-identical to phase 4's every run; the median wall ratio
      10d POTRF-P at (N, NB) with run(verify=True) and tp.plan(), its
          residual held to 1e-4
      10e autotune on GEMM: proposals priced with the card's fit, each
          validated by a real run in a fresh Context and CudaDevice
          created under its knob vector, the winner persisted under
          out_dir; a runtime created with the defaults refuses it, and
          a fresh GEMM created under it runs with run(tuned=True), the
          winner's knobs read back from the Context and the device, C
          at phase 4's 1e-4 / 1e-3
      10f (serve given) phase 5's round with conformance on by default,
          the watchdog and the journal armed through their runtime.*
          parameters and tracing at level 1: coverage 1.0 required, the
          makespan ratio printed, the journal read back, and one
          request's timeline (its exec rows held to the trace's EXEC
          spans of its scopes)
    Returns {"runs": {label: row}, "launches": the kernels' launches}."""
    import shutil
    import urllib.request

    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch import _native as N
    from parsec_tpu_torch import kernels
    from parsec_tpu_torch.algos import (build_gemm, build_potrf_panels,
                                        potrf_flops)
    from parsec_tpu_torch.analysis import autotune
    from parsec_tpu_torch.analysis.tune import (ACTED_KNOBS, apply_knobs,
                                                bound_value, check_tuned,
                                                default_knobs,
                                                knobs_in_force,
                                                resolve_tuned)
    from parsec_tpu_torch.comm.economics import (TransferEconomics,
                                                 fit_points)
    from parsec_tpu_torch.convert import to_collection, to_tensor
    from parsec_tpu_torch.data import TwoDimBlockCyclic
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.device.bench_utils import (
        generate_spd_panels_on_device, potrf_residual, wait_device_tiles)
    from parsec_tpu_torch.profiling import (KEY_H2D, DeviceActivity,
                                            MetricsExporter, PinsModule,
                                            StragglerLog, TaskCounter,
                                            enable_pins)
    from parsec_tpu_torch.profiling.live import LiveMonitor
    from parsec_tpu_torch.profiling.trace import KEY_EXEC
    from parsec_tpu_torch.utils import params as mca
    fa_mod = importlib.import_module("parsec_tpu_torch.ops.flash_attention")
    rn_mod = importlib.import_module("parsec_tpu_torch.ops.rms_norm")
    dims = dims or OBSERVE
    out = {"runs": {}, "launches": {name: 0 for name in kernels.LAUNCHES}}
    if out_dir is None:
        out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "phase10")
    os.makedirs(out_dir, exist_ok=True)

    def check(label, ok, detail=""):
        log(f"    check {label}: {ok}" + (f" ({detail})" if detail else ""))
        if not ok:
            raise AssertionError(f"10: {label} fails {detail}")

    # ------------------------------------------- 10a, the card's h2d fit
    with pt.Context(nb_workers=1) as ctx:
        dev = CudaDevice(ctx, device=dev_t)
        points, rows_fit = [], []
        for size in dims["fit_sizes"]:
            host = np.ones(size // 4, np.float32)
            best = None
            for _ in range(dims["fit_reps"]):
                sync(dev_t)
                t = time.perf_counter()
                got, ev = dev._h2d_async(torch.from_numpy(host))
                if ev is not None:
                    ev.synchronize()
                secs = time.perf_counter() - t
                best = secs if best is None else min(best, secs)
            del got
            points.append((size, best))
            rows_fit.append({"size_bytes": size, "seconds": best,
                             "gbps": size / best / 1e9})
        dev.stop()
    fit = fit_points(points)
    if fit["fixed_overhead_us"] < 0:
        raise AssertionError(
            f"10a: the h2d fit's intercept {fit['fixed_overhead_us']} us "
            "is negative: no fit of the card")
    for r in rows_fit:
        pred = (fit["fixed_overhead_us"] * 1e-6
                + fit["per_byte_ns"] * 1e-9 * r["size_bytes"])
        r["fit_rel_err"] = (pred - r["seconds"]) / r["seconds"]
    econ_path = os.path.join(out_dir, "econ.json")
    with open(econ_path, "w") as f:
        json.dump({"bench": "chip_smoke.py phase 10 h2d fit",
                   "meta": {"platform": dev_t.type,
                            "card": torch.cuda.get_device_name(dev_t)
                            if dev_t.type == "cuda" else "cpu"},
                   "paths": {"device": {"sizes": rows_fit, "fit": fit}}},
                  f, indent=1)
    econ = TransferEconomics.load(econ_path)
    log(f"  10a h2d fit (pinned staging, h2d stream, min of "
        f"{dims['fit_reps']}): " + ", ".join(
            f"{r['size_bytes']} B {r['seconds'] * 1e3:.4f} ms "
            f"({r['gbps']:.2f} GB/s, fit {r['fit_rel_err']:+.1%})"
            for r in rows_fit)
        + f"; fit {fit['fixed_overhead_us']} us + {fit['per_byte_ns']} "
        f"ns/B (r2 {fit['r2']}) -> {econ_path}")
    out["runs"]["10a h2d fit"] = {"sizes": rows_fit, "fit": fit}

    # ---------------------------------- 10b, PINS, metrics, live, plans
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

    class StallCount(PinsModule):
        """Dispatch-time DEVICE_H2D ends (lane 0): the h2d_stall
        histogram's sample count."""
        name = "stall_count"
        mask = 1 << KEY_H2D

        def __init__(self):
            self.count = 0
            self._lock = threading.Lock()

        def on_event(self, key, phase, class_id, l0, l1, worker, aux,
                     t_ns):
            if phase == 1 and aux == 0:
                with self._lock:
                    self.count += 1

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
        act, cnt, slog, stalls = (DeviceActivity(), TaskCounter(),
                                  StragglerLog(k=8), StallCount())
        chain = enable_pins(ctx, act, cnt, slog, stalls)
        stall_sum = 0

        def gemm(dev):
            for t in C._tiles.values():  # C += A @ B: from zero each run
                t[...] = 0
            return build_gemm(ctx, A, B, C, dev)

        paths = {
            "GEMM": (gemm, (n // nb) ** 3, None),
            "NORM": (lambda dev: rn_mod.build_rms_norm(
                ctx, X, W, O, EPS, dev=dev), rows // T, "rms_norm"),
            "FATT": (lambda dev: fa_mod.build_flash_attention(
                ctx, Q, K, V, OF, dev=dev), H, "flash_attention")}
        for label, (build, ntasks, kname) in paths.items():
            for warm in (True, False):
                dev = CudaDevice(ctx, device=dev_t)
                tp = build(dev)
                plan = None if warm else tp.plan()
                mon = None
                if label == "NORM" and not warm:
                    mon_path = os.path.join(out_dir, "live_{rank}.jsonl")
                    if os.path.exists(mon_path.format(rank=0)):
                        os.unlink(mon_path.format(rank=0))
                    mon = LiveMonitor(ctx, path=mon_path, interval=0.05)
                a0 = (act.waves, act.lanes, act.stall_ns,
                      sum(act.h2d_bytes), list(act.h2d_bytes))
                kernels.reset_launches()
                sync(dev_t)
                t = time.perf_counter()
                tp.run(verify=None if warm else True)
                tp.wait()
                dev.flush()
                sync(dev_t)
                wall = (time.perf_counter() - t) * 1e3
                got = dict(kernels.LAUNCHES)
                for k, v in got.items():
                    out["launches"][k] += v
                if mon is not None:
                    mon.stop()  # its final sample sees the device live
                dev.stop()
                st = dict(dev.stats)
                stall_sum += st["h2d_stall_ns"]
                if st["tasks"] != ntasks:
                    raise AssertionError(f"10b {label}: {st['tasks']} device"
                                         f" tasks, expected {ntasks}")
                if warm:
                    continue
                launches = sum(v[0] for v in dev.launches.values())
                fs = dev.info()["fuse"]
                dw, dl, ds, db = (act.waves - a0[0], act.lanes - a0[1],
                                  act.stall_ns - a0[2],
                                  sum(act.h2d_bytes) - a0[3])
                split = [act.h2d_bytes[i] - a0[4][i] for i in (0, 1)]
                log(f"  10b {label}: {wall:.1f} ms with PINS on, "
                    f"verified; DeviceActivity waves={dw} lanes={dl} "
                    f"stall={ds / 1e6:.2f} ms h2d bytes by lane "
                    f"(dispatch, off-path)={split}; device launches "
                    f"{launches} tasks={st['tasks']} h2d_bytes="
                    f"{st['h2d_bytes']} stall="
                    f"{st['h2d_stall_ns'] / 1e6:.2f} ms; kernel launches "
                    f"{got}")
                # a chained level is one launch inside its chain's wave
                # (one span), and a task completed from its parked result
                # is a lane of no wave (device/fuse.py)
                check(f"{label} waves + chained levels == device launches",
                      dw + fs["chain_waves"] == launches,
                      f"{dw} + {fs['chain_waves']} vs {launches}")
                if kname is not None and dev_t.type == "cuda":
                    check(f"{label} waves == {kname} launches",
                          dw == got[kname], f"{dw} vs {got[kname]}")
                check(f"{label} lanes + chain hits == device tasks",
                      dl + fs["chain_hits"] == st["tasks"],
                      f"{dl} + {fs['chain_hits']} vs {st['tasks']}")
                check(f"{label} stall == stats h2d_stall_ns",
                      ds == st["h2d_stall_ns"])
                check(f"{label} lane-split h2d bytes == stats h2d_bytes",
                      db == st["h2d_bytes"], f"{db} vs {st['h2d_bytes']}")
                ms = plan.makespan
                log(f"    plan: est_bytes {plan.est_bytes()} vs device "
                    f"cache_peak_bytes {st['cache_peak_bytes']}; "
                    f"{plan.stats['instances']} tasks in "
                    f"{plan.stats['waves']} waves, {plan.fusable_waves()} "
                    f"certified; critical path {ms['critical_path_ns']} ns "
                    f"and lower bound {ms['lower_bound_ns']} ns "
                    f"({ms['cost_source']} costs) vs the wall "
                    f"{wall * 1e6:.0f} ns = {wall * 1e6 / ms['lower_bound_ns']:.0f}x")
                row = {"wall_ms": wall, "waves": dw, "lanes": dl,
                       "stall_ns": ds, "h2d_split": split,
                       "launches": got, "est_bytes": plan.est_bytes(),
                       "cache_peak_bytes": st["cache_peak_bytes"],
                       "critical_path_ns": ms["critical_path_ns"],
                       "lower_bound_ns": ms["lower_bound_ns"],
                       "cost_source": ms["cost_source"]}
                if label == "GEMM":
                    check_close("10b GEMM C vs torch.matmul",
                                to_tensor(C.to_dense(), dev_t),
                                torch.matmul(to_tensor(a, dev_t),
                                             to_tensor(b, dev_t)),
                                1e-4, 1e-3)
                elif label == "NORM":
                    o = O.to_dense()
                    if ptg_norm_o is not None:
                        check("NORM O with PINS bit-identical to phase "
                              "4's", bool(np.array_equal(o, ptg_norm_o)))
                    del o
                    recs = [json.loads(x)
                            for x in open(mon.path)]
                    i = len(ctx._devices) - 1
                    dev_rows = [r for r in recs if f"dev{i}_tasks" in r]
                    keys = (f"dev{i}_tasks", f"dev{i}_cache_bytes",
                            f"dev{i}_qdepth", "device")
                    check("live samples carry the device rows",
                          bool(dev_rows) and all(k in dev_rows[-1]
                                                 for k in keys),
                          f"{len(recs)} samples, last keys "
                          f"{sorted(recs[-1])}")
                    last = dev_rows[-1]
                    log(f"    live: {len(recs)} samples, the last "
                        f"dev{i}_tasks={last[f'dev{i}_tasks']} "
                        f"dev{i}_cache_bytes={last[f'dev{i}_cache_bytes']}"
                        f" device={last['device']}")
                    row["live_samples"] = len(recs)
                else:
                    check_close(
                        "10b FATT O vs plain",
                        to_tensor(OF.to_dense(), dev_t).reshape(H, L, D),
                        fa_mod.attention_reference(
                            to_tensor(qn, dev_t).reshape(H, L, D),
                            to_tensor(kn, dev_t).unsqueeze(0)
                            .expand(H, L, D),
                            to_tensor(vn, dev_t).unsqueeze(0)
                            .expand(H, L, D), False, D ** -0.5),
                        2e-5, 2e-5)
                out["runs"][f"10b {label}"] = row
        log(f"  10b PINS: TaskCounter counted {cnt.total} EXEC spans (the "
            f"device tasks emit none), StragglerLog holds "
            f"{len(slog.slowest)} rows")
        chain.uninstall()
        hist = [h for h in ctx.metrics_histograms()
                if h.kind == N.MET_H2D_STALL]
        hcount = hist[0].count if hist else 0
        hsum = hist[0].sum_ns if hist else 0
        log(f"  10b h2d_stall histogram: count {hcount}, sum "
            f"{hsum / 1e6:.3f} ms, p50 {hist[0].quantile(0.5) / 1e3:.1f} us"
            f", p99 {hist[0].quantile(0.99) / 1e3:.1f} us; the devices' "
            f"h2d_stall_ns {stall_sum / 1e6:.3f} ms over {stalls.count} "
            "dispatch-time copies")
        check("h2d_stall histogram count == dispatch-time h2d copies",
              hcount == stalls.count > 0, f"{hcount} vs {stalls.count}")
        check("h2d_stall histogram sum == the devices' h2d_stall_ns",
              hsum == stall_sum, f"{hsum} vs {stall_sum}")
        exp = MetricsExporter(ctx, 0)
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{exp.port}/metrics",
                timeout=30).read().decode()
        finally:
            exp.stop()
        scraped = [ln for ln in body.splitlines()
                   if ln.startswith("ptc_h2d_stall_seconds_count")]
        check("exporter scrape carries the h2d_stall count",
              scraped == [f"ptc_h2d_stall_seconds_count {hcount}"],
              f"{scraped}; {len(body.splitlines())} lines")
        out["runs"]["10b metrics"] = {"h2d_stall_count": hcount,
                                      "h2d_stall_sum_ns": hsum,
                                      "scrape_lines":
                                          len(body.splitlines())}

        # ------------------------------- 10c, PINS' cost on NORM, in turns
        walls = {"off": [], "on": []}
        for _ in range(dims["pins_walls"]):
            for key in ("off", "on"):
                chain = enable_pins(ctx, DeviceActivity(), TaskCounter(),
                                    StragglerLog(k=8)) \
                    if key == "on" else None
                dev = CudaDevice(ctx, device=dev_t)
                tp = rn_mod.build_rms_norm(ctx, X, W, O, EPS, dev=dev)
                kernels.reset_launches()
                sync(dev_t)
                t = time.perf_counter()
                tp.run()
                tp.wait()
                dev.flush()
                sync(dev_t)
                walls[key].append((time.perf_counter() - t) * 1e3)
                for k, v in kernels.LAUNCHES.items():
                    out["launches"][k] += v
                dev.stop()
                if chain is not None:
                    if chain["device_activity"].lanes != rows // T:
                        raise AssertionError("10c: PINS missed NORM tasks")
                    chain.uninstall()
                if ptg_norm_o is not None and \
                        not np.array_equal(O.to_dense(), ptg_norm_o):
                    raise AssertionError(f"10c NORM PINS {key}: O is not "
                                         "phase 4's bit for bit")
        med = {k: float(np.median(v)) for k, v in walls.items()}
        ratio = med["on"] / med["off"]
        log(f"  10c NORM walls (ms) PINS off {['%.1f' % w for w in walls['off']]}"
            f", on {['%.1f' % w for w in walls['on']]}: median ratio "
            f"{ratio:.3f}; O bit-identical to phase 4's every run")
        out["runs"]["10c pins cost"] = {"walls_ms": walls,
                                        "median_ratio": ratio}
    del xn, X, O, qn, Q, OF

    # --------------------------------------- 10d, POTRF-P verified, planned
    N, pnb = dims["potrf_p"]
    nt = N // pnb
    with pt.Context(nb_workers=4) as ctx:
        Ap = TwoDimBlockCyclic(N, N, N, pnb)
        Ap.register(ctx, "A")
        cache = 4 << 30
        if dev_t.type == "cuda":
            free, _ = torch.cuda.mem_get_info(dev_t)
            cache = max(2 << 30, free - N * N * 4 - (8 << 30))
        dev = CudaDevice(ctx, device=dev_t, cache_bytes=cache)
        a_st = generate_spd_panels_on_device(dev, Ap, seed=SEED)
        tp = build_potrf_panels(ctx, Ap, dev=dev)
        t = time.perf_counter()
        rep = tp.verify()
        plan = tp.plan()
        t_an = (time.perf_counter() - t) * 1e3
        check(f"POTRF-P N={N} NB={pnb} verifies clean",
              not rep.findings, rep.text())
        sync(dev_t)
        t = time.perf_counter()
        tp.run(verify=True)
        tp.wait()
        wait_device_tiles(dev, Ap)
        sync(dev_t)
        wall = (time.perf_counter() - t) * 1e3
        st = dict(dev.stats)
        res = potrf_residual(dev, Ap, a_st)
        del a_st
        dev.stop()
    ms = plan.makespan
    log(f"  10d POTRF-P N={N} NB={pnb}: verify + plan {t_an:.1f} ms of "
        f"host ({plan.stats['instances']} tasks, {plan.stats['waves']} "
        f"waves); run(verify=True) {wall:.1f} ms = "
        f"{potrf_flops(N) / wall / 1e6:.0f} GFLOP/s; residual {res:.3e}; "
        f"est_bytes {plan.est_bytes()} vs cache_peak_bytes "
        f"{st['cache_peak_bytes']}; critical path {ms['critical_path_ns']} "
        f"ns, lower bound {ms['lower_bound_ns']} ns ({ms['cost_source']}) "
        f"vs the wall {wall * 1e6:.0f} ns")
    if not res <= 1e-4:
        raise AssertionError(f"10d POTRF-P residual {res:.3e} > 1e-4")
    if st["tasks"] != nt + nt * (nt - 1) // 2:
        raise AssertionError(f"10d POTRF-P: {st['tasks']} device tasks")
    out["runs"]["10d POTRF-P"] = {
        "wall_ms": wall, "analysis_ms": t_an, "residual": res,
        "est_bytes": plan.est_bytes(),
        "cache_peak_bytes": st["cache_peak_bytes"],
        "critical_path_ns": ms["critical_path_ns"],
        "lower_bound_ns": ms["lower_bound_ns"]}

    # ----------------------------------------------- 10e, tuning on GEMM
    store_path = os.path.join(out_dir, "tuned.json")
    if os.path.exists(store_path):
        os.unlink(store_path)
    mca.set("tune.cache_path", store_path)
    try:
        def gemm_run(knobs=None, tuned=None):
            # the acted knobs are read when the Context and CudaDevice
            # are created: the run's runtime is created under the vector
            with apply_knobs(knobs), pt.Context(nb_workers=4) as gctx:
                A, B = to_collection(a, nb, nb), to_collection(b, nb, nb)
                C = to_collection(np.zeros((n, n), np.float32), nb, nb)
                for name, coll in (("A", A), ("B", B), ("C", C)):
                    coll.register(gctx, name)
                dev = CudaDevice(gctx, device=dev_t)
                tp = build_gemm(gctx, A, B, C, dev)
                kernels.reset_launches()
                sync(dev_t)
                t = time.perf_counter()
                tp.run(tuned=tuned)
                tp.wait()
                dev.flush()
                sync(dev_t)
                secs = time.perf_counter() - t
                for k, v in kernels.LAUNCHES.items():
                    out["launches"][k] += v
                force = knobs_in_force(gctx)
                dev.stop()
                return secs, C.to_dense(), tp.tuned_applied, force

        def bound(knobs):
            return {k: [bound_value(k, knobs[k])] for k in ACTED_KNOBS}

        def measure(knobs):
            secs, _, _, force = gemm_run(knobs)
            check(f"candidate {knobs_note(knobs)} in force on its Context "
                  "and CudaDevice", force == bound(knobs), f"{force}")
            return secs

        def knobs_note(knobs):
            return {k: knobs[k] for k in ACTED_KNOBS if knobs[k] != dflt[k]}

        dflt = default_knobs()

        with pt.Context(nb_workers=4) as tctx:
            A, B = to_collection(a, nb, nb), to_collection(b, nb, nb)
            C = to_collection(np.zeros((n, n), np.float32), nb, nb)
            for name, coll in (("A", A), ("B", B), ("C", C)):
                coll.register(tctx, name)
            tdev = CudaDevice(tctx, device=dev_t)
            probe = build_gemm(tctx, A, B, C, tdev)
            t = time.perf_counter()
            res = autotune(probe, measure=measure, topk=dims["tune_topk"],
                           econ=econ, workers=4)
            t_tune = time.perf_counter() - t
            vec = resolve_tuned(probe, True)
            # this runtime was created with the defaults: each candidate
            # that moves an acted knob is refused on it, not passed for
            # a tuned vector
            refused = []
            for r in res["validated"]:
                if knobs_note(r["knobs"]):
                    try:
                        check_tuned(tctx, r["knobs"])
                    except ValueError:
                        refused.append(knobs_note(r["knobs"]))
                        continue
                    check(f"the defaults' runtime refuses "
                          f"{knobs_note(r['knobs'])}", False)
            tdev.stop()
        for r in res["validated"]:
            log(f"  10e candidate {knobs_note(r['knobs']) or 'defaults'}: "
                f"predicted {r['predicted_ns'] / 1e6:.3f} ms, measured "
                f"{r['measured_s'] * 1e3:.1f} ms "
                f"(predicted/wall {r['predicted_vs_wall']})")
        log(f"  10e the defaults' runtime refused {refused}")
        win = res["winner"]
        check("the store holds the winner under GEMM's signature",
              vec == win["knobs"])
        secs, c_out, applied, force = gemm_run(knobs=vec, tuned=True)
        check("run(tuned=True) holds the persisted winner", applied == vec)
        check("the winner's knobs are in force on the tuned run's Context "
              "and CudaDevice", force == bound(vec), f"{force}")
        check_close("10e GEMM C (tuned) vs torch.matmul",
                    to_tensor(c_out, dev_t),
                    torch.matmul(to_tensor(a, dev_t), to_tensor(b, dev_t)),
                    1e-4, 1e-3)
        log(f"  10e autotune {t_tune:.1f} s; winner measured "
            f"{win['measured_s'] * 1e3:.1f} ms, persisted to "
            f"{res.get('store_path')}; run(tuned=True) {secs * 1e3:.1f} ms "
            f"with {bound(vec)} in force")
        out["runs"]["10e tune"] = {
            "candidates": [{"knobs": {k: r["knobs"][k] for k in
                                      ("device.staging_slots",
                                       "device.cache_bytes",
                                       "runtime.mag_batch")},
                            "predicted_ns": r["predicted_ns"],
                            "measured_s": r["measured_s"]}
                           for r in res["validated"]],
            "tuned_wall_ms": secs * 1e3, "autotune_s": t_tune,
            "in_force": bound(vec), "refused": refused}
    finally:
        mca.unset("tune.cache_path")
    del a, b

    # ------------------------- 10f, serving: watchdog and journal armed
    if serve is not None:
        model, prompts, tenants, max_new, check_requests = serve["_round"]
        jdir = os.path.join(out_dir, "journal")
        shutil.rmtree(jdir, ignore_errors=True)
        armed = {"PTC_MCA_runtime_watchdog": "0.5",
                 "PTC_MCA_runtime_journal": jdir}
        saved = {k: os.environ.get(k) for k in armed}
        os.environ.update(armed)
        try:
            r = serve_round(model, prompts, tenants, max_new,
                            lambda label, fn: fn(),
                            "SERVE armed, traced", trace=True)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        check_requests("10f SERVE", r["handles"], max_new)
        conf = r["scope"]["conformance"]
        log(f"  10f SERVE (conformance on, watchdog, journal, trace level "
            f"1): {r['tokens_per_s']:.2f} tokens/s, {conf['pools']} pools,"
            f" coverage {conf['coverage']}, makespan ratio p50 "
            f"{conf['makespan']['ratio_p50']} (min "
            f"{conf['makespan']['ratio_min']}), plans {r['plan_ms']:.1f} "
            f"ms of host; watchdog {r['watchdog']['ticks']} ticks, "
            f"{r['watchdog']['detections']} detections")
        check("conformance coverage == 1.0", conf["coverage"] == 1.0)
        recs = [json.loads(x) for x in
                open(os.path.join(jdir, "journal.0.jsonl"))]
        types = {}
        for rec in recs:
            types[rec["type"]] = types.get(rec["type"], 0) + 1
        ops = {}
        for rec in recs:
            if rec["type"] == "serve":
                ops[rec["op"]] = ops.get(rec["op"], 0) + 1
        log(f"  10f journal read back: {len(recs)} records {types}, serve "
            f"ops {ops}")
        check("journal holds every prefill's admit and done",
              ops.get("admit") == ops.get("done") == len(r["handles"])
              and types.get("journal_close") == 1)
        tr, reg = r["trace"], r["registry"]
        h = r["handles"][0]
        tl = reg.request_timeline(tr, h.rid)
        stages = {k.replace("_ns", "_ms"): v / 1e6
                  for k, v in tl["stages"].items()}
        log(f"  10f request_timeline of request {h.rid} "
            f"({len(h.prompt)} prompt tokens): e2e {tl['e2e_ns'] / 1e6:.1f}"
            f" ms, stages (ms) {stages}, {len(tl['waves'])} wave rows")
        # the exec stage against the trace's own EXEC spans of the
        # request's scopes (its lane's, in a shared decode scope); the
        # lane_wait stage is the unattributed remainder, device tasks
        # emitting no EXEC span
        n_exec, ev = 0, tr.events
        for sid, member in reg.request_scopes(h.rid):
            # EXEC ends stamped with the scope (aux), lane in l0
            m = (ev[:, 0] == KEY_EXEC) & (ev[:, 1] == 0) & (ev[:, 6] == sid)
            if member is not None:
                m &= ev[:, 3] == member
            n_exec += int(m.sum())
        span_sum = sum(w["dur_ns"] for w in tl["waves"])
        check("the timeline's exec rows are the trace's EXEC spans of the "
              "request's scopes",
              len(tl["waves"]) == n_exec > 0
              and 0 < tl["stages"]["exec_ns"] <= span_sum,
              f"{len(tl['waves'])} rows, {n_exec} EXEC spans, exec "
              f"{tl['stages']['exec_ns']} ns of {span_sum} ns of spans")
        out["runs"]["10f serve"] = {
            "tokens_per_s": r["tokens_per_s"], "pools": conf["pools"],
            "coverage": conf["coverage"],
            "makespan_ratio_p50": conf["makespan"]["ratio_p50"],
            "makespan_ratio_min": conf["makespan"]["ratio_min"],
            "plan_ms": r["plan_ms"], "journal_records": len(recs),
            "timeline_ms": stages}
        del r, tr
    return out


# phase 11 sizes: 11a/11d phase 4's GEMM (N, NB) in `turns` runs of each
# mode and 11d's chain depth; 11b phase 4's NORM (rows, d, T) and FATT
# (heads, L, D) and phase 6's POTRF-T (N, NB); 11c phase 7's out-of-core
# GEMM (N, NB) at half its tile set
FUSE = {"gemm": (4096, 512), "norm": (8 * 4096, 4096, 1024),
        "fatt": (32, 4096, 128), "potrf_t": (16384, 1024),
        "gemm_ooc": (8192, 1024), "turns": 3, "hint_depth": 4,
        "probe_sides": (256, 512, 1024, 2048)}


def fuse_path(dev_t, rng, dims=None) -> dict:
    """Phase 11: wave and chain fusion (device/fuse.py), the device's
    pre-run plan_check and the lane's chain hints.  Every run is on a
    fresh CudaDevice created under its knobs, with batch_wait_ms = 2.0
    (a wave pops whole, as in the reference's tests).
      11a phase 4's GEMM fused (device.wave_fuse on, the default) and
          unfused (wave_fuse=0), `turns` runs of each in turns, then as
          many again without the coalescing wait (batch_wait_ms = 0,
          the device's default; the drain held): per run the
          DEVICE_DISPATCH spans (a level-1 trace), their lanes and host
          time, the k_gemm_nn calls and their widths, the fuse counters,
          the drain invariant, the dispatch h2d stall and the wall.  C
          is held to torch.matmul at 1e-4 / 1e-3 in every run, and
          every run of 11a and 11d to the first bit for bit (a lone
          lane is a two-lane product, so a lane's bits do not depend on
          its wave's width); lane 0 of k_gemm_nn is probed at 64, 8, 4,
          3, 2 and 1 lanes at `probe_sides`, identical at every width,
          and a lone 512^2 product timed before and after that route.
          Required:
          chain_hits > 0, chain_misses == 0, span lanes + chain_hits =
          tasks, at most 7 chained levels a chain (the 2 GiB byte cap
          over 256 MiB waves), and the median fused spans at least 3x
          fewer than the unfused
      11b NORM and FATT at phase 4's sizes and POTRF-T at phase 6's,
          unfused, fused, fused, unfused: bit-identical, fused_waves > 0;
          every refusal reason and the pool's chain certificates' host
          time printed
      11c plan_check: phase 4's GEMM under PTC_DEVICE_BATCH=1 (measured
          cache_peak_bytes <= predicted peak <= 1.25x measured); phase
          7's out-of-core GEMM at half its tile set, the knob armed in
          warn mode (predicted spills > 0 and measured spills > 0, its
          chains refused for residency pressure, C held); error mode
          with out-of-core off raises PlanCheckError before any task is
          scheduled; ctx.stats()["plan"] against each
      11d the chain hints: the lane's hint stages, their dispatch hits
          and the wasted stages in 11a's fused runs, and one fused run
          with the chain cut to `hint_depth` waves (each chain hints the
          next segment's A and B tiles), its C bit-identical to 11a's
          fused C
    Returns {"runs": ..., "launches": hand-written kernel launches}."""
    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch import kernels
    from parsec_tpu_torch.algos import build_gemm, build_potrf
    from parsec_tpu_torch.analysis import PlanCheckError
    from parsec_tpu_torch.analysis.plan import chain_certificates
    from parsec_tpu_torch.convert import to_collection, to_tensor
    from parsec_tpu_torch.data import TwoDimBlockCyclic
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.device.bench_utils import (generate_spd_on_device,
                                                     potrf_residual)
    from parsec_tpu_torch.profiling import KEY_DEVICE
    from parsec_tpu_torch.utils import params
    fa_mod = importlib.import_module("parsec_tpu_torch.ops.flash_attention")
    rn_mod = importlib.import_module("parsec_tpu_torch.ops.rms_norm")
    dims = dims or FUSE
    out = {"runs": {}, "launches": {name: 0 for name in kernels.LAUNCHES}}
    fails = []

    def check(what, ok, detail=""):
        log(f"    check {what}: {bool(ok)} {detail}".rstrip())
        if not ok:
            fails.append(what)

    def new_dev(ctx, knobs, cache_bytes=None, env=None):
        """A CudaDevice created under `knobs` (and PTC_* `env`), both
        restored after."""
        saved = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        try:
            for k, v in knobs.items():
                params.set(k, v)
            dev = CudaDevice(ctx, device=dev_t, cache_bytes=cache_bytes)
        finally:
            for k in knobs:
                params.unset(k)
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        dev.batch_wait_ms = 2.0
        return dev

    def cert_ms(tp):
        """Host ms of the chain certificates the wave compiler computes
        for a pool (once, on the manager thread, before its first
        chain); timed here outside the pool's wall."""
        t = time.perf_counter()
        chain_certificates(tp)
        return (time.perf_counter() - t) * 1e3

    def drained(fs, pinned):
        return (fs["chain_parked"] == fs["chain_hits"] + fs["chain_misses"]
                + fs["chain_drops"] + fs["parked"]
                and fs["parked"] == 0 and pinned == 0)

    # ------------------------------------------------ 11a, 11d: GEMM
    n, nb = dims["gemm"]
    nt = n // nb
    a = rng.standard_normal((n, n), dtype=np.float32)
    b = rng.standard_normal((n, n), dtype=np.float32)
    want = torch.matmul(to_tensor(a, dev_t), to_tensor(b, dev_t))
    with pt.Context(nb_workers=4) as ctx:
        A, B = to_collection(a, nb, nb), to_collection(b, nb, nb)
        C = to_collection(np.zeros((n, n), np.float32), nb, nb)
        for name, coll in (("A", A), ("B", B), ("C", C)):
            coll.register(ctx, name)

        def gemm_run(fused, depth=None, wait_ms=2.0):
            for t in C._tiles.values():  # C += A @ B: from zero each run
                t[...] = 0
            knobs = {"device.wave_fuse": fused}
            if depth is not None:
                knobs["device.wave_fuse_depth"] = depth
            dev = new_dev(ctx, knobs)
            dev.batch_wait_ms = wait_ms
            tp = build_gemm(ctx, A, B, C, dev)
            body = dev._pools[tp._ptr].bodies[tp.classes[0].id]
            widths, kern = [], body.kernel

            def k_gemm_nn(a_, b_, c_):  # the chore, its widths recorded
                widths.append(int(a_.shape[0]))
                return kern(a_, b_, c_)
            body.kernel = k_gemm_nn
            certs = cert_ms(tp) if fused else None
            ctx.profile_take()
            ctx.profile_enable(1)
            sync(dev_t)
            t = time.perf_counter()
            tp.run()
            tp.wait()
            dev.flush()
            sync(dev_t)
            wall = (time.perf_counter() - t) * 1e3
            ctx.profile_enable(0)
            ev = ctx.profile_take()
            fs = dev.info()["fuse"]
            pinned = dev._chain_pinned
            dev.stop()
            st = dict(dev.stats)
            d, beg = ev[:, 0] == KEY_DEVICE, ev[:, 1] == 0
            t0s, t1s = ev[d & beg, 7], ev[d & ~beg, 7]
            row = {"fused": fused, "wait_ms": wait_ms, "wall_ms": wall,
                   "stall_ms": st["h2d_stall_ns"] / 1e6,
                   "certificates_ms": certs,
                   "spans": int((d & beg).sum()),
                   "span_ms": float((t1s.sum() - t0s.sum()) / 1e6)
                   if len(t0s) == len(t1s) else None,
                   "span_lanes": int(ev[d & beg, 3].sum()),
                   "calls": dev.launches["k_gemm_nn"][0],
                   "widths": widths, "tasks": st["tasks"],
                   "fuse": fs, "drained": drained(fs, pinned),
                   "hint_stages": st["prefetch_hint_stages"],
                   "hint_hits": st["prefetch_hint_hits"],
                   "hint_wasted": st["prefetch_hint_wasted"],
                   "prefetch_hits": st["prefetch_hits"]}
            got = C.to_dense()
            row["max_abs_err"] = check_close(
                f"11a GEMM {'fused' if fused else 'unfused'} C vs "
                "torch.matmul", to_tensor(got, dev_t), want, 1e-4, 1e-3)
            return row, got

        rows = {True: [], False: []}
        # every GEMM run of 11a and 11d by the bits of its C: (label, the
        # widths of its k_gemm_nn calls, C)
        runs_c = []
        for turn in range(dims["turns"]):
            for fused in (True, False):
                row, got = gemm_run(fused)
                runs_c.append((f"{'fused' if fused else 'unfused'} turn "
                               f"{turn}", row["widths"], got))
                rows[fused].append(row)
                fs = row["fuse"]
                log(f"  11a GEMM {'fused' if fused else 'unfused'} turn "
                    f"{turn}: {row['wall_ms']:.1f} ms; {row['spans']} "
                    f"DEVICE_DISPATCH spans of {row['span_lanes']} lanes, "
                    f"{row['span_ms']:.1f} ms of host in them; "
                    f"k_gemm_nn calls {row['calls']} widths "
                    f"{row['widths']}; chains {fs['fused_chains']} levels "
                    f"{fs['chain_waves']} parked {fs['chain_parked']} hits "
                    f"{fs['chain_hits']} misses {fs['chain_misses']} drops "
                    f"{fs['chain_drops']} fused_waves {fs['fused_waves']} "
                    f"marshal plans (hit/miss) {fs['cache_hits']}/"
                    f"{fs['cache_misses']} refused {fs['refused']}; drain "
                    f"invariant {row['drained']}; dispatch h2d stall "
                    f"{row['stall_ms']:.1f} ms")
                check(f"11a GEMM turn {turn} span lanes + chain_hits == "
                      "tasks", row["span_lanes"] + fs["chain_hits"]
                      == row["tasks"] == nt ** 3)
                check(f"11a GEMM turn {turn} spans + chained levels == "
                      "k_gemm_nn calls", row["spans"] + fs["chain_waves"]
                      == row["calls"] == len(row["widths"]))
                if fused:
                    check(f"11a GEMM turn {turn} chain_hits > 0, "
                          "chain_misses == 0", fs["chain_hits"] > 0
                          and fs["chain_misses"] == 0)
                    check(f"11a GEMM turn {turn} drain invariant",
                          row["drained"])
                    check(f"11a GEMM turn {turn} at most 7 chained levels "
                          "a chain", fs["fused_chains"] > 0
                          and fs["chain_waves"] <= 7 * fs["fused_chains"])
                else:
                    check(f"11a GEMM turn {turn} unfused: no compiler",
                          fs["enabled"] is False and fs["chain_hits"] == 0)
        med = {m: sorted(r["spans"] for r in rows[m])[len(rows[m]) // 2]
               for m in rows}
        walls = {m: sorted(r["wall_ms"] for r in rows[m])[len(rows[m]) // 2]
                 for m in rows}
        log(f"  11a median spans fused {med[True]}, unfused {med[False]}; "
            f"median wall fused {walls[True]:.1f} ms, unfused "
            f"{walls[False]:.1f} ms")
        check("11a median spans fused * 3 <= unfused",
              med[True] * 3 <= med[False], f"{med[True]} vs {med[False]}")
        out["runs"]["11a GEMM"] = {
            "fused": rows[True], "unfused": rows[False],
            "median_spans": {"fused": med[True], "unfused": med[False]},
            "median_wall_ms": {"fused": walls[True],
                               "unfused": walls[False]}}
        # the same turns without the coalescing wait (the device's
        # default, batch_wait_ms = 0, as phases 4 and 9-10 run): a pop of
        # a few parked consumers then dispatches at once
        nowait = {True: [], False: []}
        for turn in range(dims["turns"]):
            for fused in (True, False):
                row, got = gemm_run(fused, wait_ms=0.0)
                runs_c.append((f"{'fused' if fused else 'unfused'} no wait "
                               f"turn {turn}", row["widths"], got))
                nowait[fused].append(row)
                fs = row["fuse"]
                log(f"  11a GEMM {'fused' if fused else 'unfused'}, no "
                    f"coalescing wait, turn {turn}: {row['wall_ms']:.1f} "
                    f"ms; {row['spans']} spans, {row['span_ms']:.1f} ms "
                    f"of host in them; widths {row['widths']}; chains "
                    f"{fs['fused_chains']} hits {fs['chain_hits']} misses "
                    f"{fs['chain_misses']}")
                check(f"11a GEMM no wait turn {turn} drain invariant, no "
                      "chain miss", row["drained"]
                      and fs["chain_misses"] == 0)
        nw = {m: sorted(r["wall_ms"] for r in nowait[m])[len(nowait[m]) // 2]
              for m in nowait}
        certs = sorted(r["certificates_ms"] for r in rows[True])
        log(f"  11a no coalescing wait: median wall fused {nw[True]:.1f} "
            f"ms, unfused {nw[False]:.1f} ms; the GEMM pool's chain "
            f"certificates {certs[len(certs) // 2]:.1f} ms of host "
            "(median; computed once a pool, before its first chain)")
        out["runs"]["11a GEMM no wait"] = {
            "fused": nowait[True], "unfused": nowait[False],
            "median_wall_ms": {"fused": nw[True], "unfused": nw[False]}}

        # 11d: the hints of 11a's fused runs, then a chain cut short
        hs = {k: sum(r[k] for r in rows[True])
              for k in ("hint_stages", "hint_hits", "hint_wasted")}
        log(f"  11d 11a's fused runs: the lane staged {hs['hint_stages']} "
            f"hinted tiles, {hs['hint_hits']} dispatch hits on them, "
            f"{hs['hint_wasted']} wasted stages (a chain of 8 waves covers "
            "the whole k range: no next segment to hint)")
        row, got = gemm_run(True, depth=dims["hint_depth"])
        runs_c.append((f"fused depth {dims['hint_depth']}", row["widths"],
                       got))
        fs = row["fuse"]
        log(f"  11d GEMM fused, depth {dims['hint_depth']}: "
            f"{row['wall_ms']:.1f} ms; {row['spans']} spans; chains "
            f"{fs['fused_chains']} levels {fs['chain_waves']} hits "
            f"{fs['chain_hits']} misses {fs['chain_misses']}; the lane "
            f"staged {row['hint_stages']} hinted tiles, "
            f"{row['hint_hits']} dispatch hits on them, "
            f"{row['hint_wasted']} wasted; prefetch hits "
            f"{row['prefetch_hits']}")
        check("11d drain invariant, no chain miss",
              row["drained"] and fs["chain_misses"] == 0)
        out["runs"]["11d GEMM depth"] = row
        hs["depth_run"] = {k: row[k] for k in hs}
        out["runs"]["11d hints"] = hs

        # bit identity of C across the GEMM runs above: each run is held
        # to torch.matmul at 1e-4 / 1e-3, and every run of 11a and 11d
        # (fused, unfused, with and without the coalescing wait, a chain
        # cut short) to the first bit for bit.  A lone lane runs as
        # a two-lane product (algos/gemm.k_gemm_nn), so a lane's bits do
        # not depend on its wave's width; the probe holds lane 0 of
        # k_gemm_nn at 1-64 lanes to the 64-lane call at four tile sides,
        # and times a lone 512^2 product as a one-lane batched call (the
        # route before the repair) and through the repaired chore
        groups: dict = {}
        for label, widths, got in runs_c:
            key = hashlib.sha1(got.tobytes()).hexdigest()[:12]
            groups.setdefault(key, []).append((label, widths, got))
        for key, members in groups.items():
            log(f"  11a/11d GEMM C bits {key}: {len(members)} run(s), with "
                f"a 1-lane call {sum(1 in w for _, w, _ in members)}; "
                + "; ".join(f"{lb} widths {sorted(set(w))}"
                            for lb, w, _ in members))
        check("11a/11d GEMM C bit-identical across every run (fused, "
              "unfused, no wait, depth-cut)", len(groups) == 1,
              f"{len(groups)} groups")
        from parsec_tpu_torch.algos.gemm import k_gemm_nn
        probe = {}
        for side in dims.get("probe_sides", (nb,)):
            ops = [to_tensor(rng.standard_normal((side, side),
                                                 dtype=np.float32), dev_t)
                   for _ in range(3)]
            lane0 = {}
            for w in (64, 8, 4, 3, 2, 1):
                st_ = [o.unsqueeze(0).expand(w, side, side).contiguous()
                       for o in ops]
                lane0[w] = k_gemm_nn(*st_)[0].clone()
            # the route before the repair: a one-lane batched product
            torch.backends.cuda.matmul.allow_tf32 = False
            before = torch.baddbmm(st_[2], st_[0], st_[1])[0]
            probe[side] = {w: bool(torch.equal(lane0[w], lane0[64]))
                           for w in lane0}
            probe[side]["one-lane baddbmm"] = bool(
                torch.equal(before, lane0[64]))
            log(f"  11a probe: k_gemm_nn at {side}^2, lane 0 bit-identical "
                f"to the 64-lane call at widths {probe[side]}")
            check(f"11a probe {side}^2: lane 0 identical at every width",
                  all(v for w, v in probe[side].items() if w != "one-lane "
                      "baddbmm"))
            del ops, st_, lane0, before
        side = 512
        one = [to_tensor(rng.standard_normal((1, side, side),
                                             dtype=np.float32), dev_t)
               for _ in range(3)]
        torch.backends.cuda.matmul.allow_tf32 = False
        lone_ms = {
            "one-lane baddbmm (before)": timed_ms(
                dev_t, lambda: torch.baddbmm(one[2], one[0], one[1]), 20),
            "k_gemm_nn two-lane (after)": timed_ms(
                dev_t, lambda: k_gemm_nn(*one), 20)}
        log("  11a a lone 512^2 product: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in lone_ms.items()))
        out["runs"]["11a GEMM bits"] = {
            "groups": {k: [(lb, sorted(set(w))) for lb, w, _ in m]
                       for k, m in groups.items()},
            "probe": {str(k): {str(w): v for w, v in p.items()}
                      for k, p in probe.items()},
            "lone_512_ms": lone_ms}
        del one
    del a, b, want, runs_c, groups
    if dev_t.type == "cuda":
        torch.cuda.empty_cache()

    # ------------------------------------------------ 11b: the matrix
    def pair(label, go, kname=None):
        """go(fused) -> (outputs, fuse counters, certificate ms, ms to
        leave out of the wall: the certificates' and a check's) on a
        fresh device a run, unfused, fused, fused, unfused; every run
        bit-identical to the first, fused_waves > 0 when fused.  The
        wall runs from the pool's build to its flush."""
        runs = []
        for fused in (False, True, True, False):
            kernels.reset_launches()
            sync(dev_t)
            t = time.perf_counter()
            res, fs, certs, excluded = go(fused)
            sync(dev_t)
            wall = (time.perf_counter() - t) * 1e3 - excluded
            for k, v in kernels.LAUNCHES.items():
                out["launches"][k] += v
            runs.append((fused, res, fs, wall, certs))
            log(f"  11b {label} {'fused' if fused else 'unfused'}: "
                f"{wall:.1f} ms; fused_waves {fs['fused_waves']} "
                f"fused_tasks {fs['fused_tasks']} chains "
                f"{fs['fused_chains']}; refused {fs['refused']}"
                + (f"; chain certificates {certs:.1f} ms of host"
                   if certs is not None else "")
                + (f"; {kname} launches {kernels.LAUNCHES[kname]}"
                   if kname else ""))
        same = all(np.array_equal(x, y) for r in runs[1:]
                   for x, y in zip(r[1], runs[0][1]))
        check(f"11b {label} fused bit-identical to unfused", same)
        check(f"11b {label} fused_waves > 0",
              all(r[2]["fused_waves"] > 0 for r in runs if r[0]))
        out["runs"][f"11b {label}"] = {
            "bit_identical": same,
            "fuse": [r[2] for r in runs if r[0]],
            "wall_ms": {"fused": [r[3] for r in runs if r[0]],
                        "unfused": [r[3] for r in runs if not r[0]]},
            "certificates_ms": [r[4] for r in runs if r[0]]}

    rows_, d, T = dims["norm"]
    xn = rng.standard_normal((rows_, d), dtype=np.float32)
    wn = rng.standard_normal((1, d), dtype=np.float32)
    with pt.Context(nb_workers=4) as ctx:
        Xc, Wc = to_collection(xn, T, d), to_collection(wn, 1, d)
        Oc = to_collection(np.zeros_like(xn), T, d)

        def norm(fused):
            dev = new_dev(ctx, {"device.wave_fuse": fused})
            tp = rn_mod.build_rms_norm(ctx, Xc, Wc, Oc, EPS, dev=dev)
            certs = cert_ms(tp) if fused else None
            tp.run()
            tp.wait()
            dev.flush()
            fs = dev.info()["fuse"]
            dev.stop()
            return [Oc.to_dense()], fs, certs, certs or 0.0
        pair("NORM", norm, "rms_norm")
    del xn, Xc, Oc

    H, L, D = dims["fatt"]
    qn = rng.standard_normal((H * L, D), dtype=np.float32)
    kn = rng.standard_normal((L, D), dtype=np.float32)
    vn = rng.standard_normal((L, D), dtype=np.float32)
    with pt.Context(nb_workers=4) as ctx:
        Qc, Kc, Vc = (to_collection(qn, L, D), to_collection(kn, L, D),
                      to_collection(vn, L, D))
        OF = to_collection(np.zeros_like(qn), L, D)

        def fatt(fused):
            dev = new_dev(ctx, {"device.wave_fuse": fused})
            tp = fa_mod.build_flash_attention(ctx, Qc, Kc, Vc, OF, dev=dev)
            certs = cert_ms(tp) if fused else None
            tp.run()
            tp.wait()
            dev.flush()
            fs = dev.info()["fuse"]
            dev.stop()
            return [OF.to_dense()], fs, certs, certs or 0.0
        pair("FATT", fatt, "flash_attention")
    del qn, kn, vn

    N, nbp = dims["potrf_t"]

    def potrf(fused):
        with pt.Context(nb_workers=4) as ctx:
            Ap = TwoDimBlockCyclic(N, N, nbp, nbp)
            Ap.register(ctx, "A")
            held = 2 * N * N * 4
            budget = 4 << 30
            if dev_t.type == "cuda":
                free, _ = torch.cuda.mem_get_info(dev_t)
                budget = max(2 << 30, free - held - (8 << 30))
            dev = new_dev(ctx, {"device.wave_fuse": fused},
                          cache_bytes=budget)
            a_st = generate_spd_on_device(dev, Ap, seed=SEED)
            tp = build_potrf(ctx, Ap, dev=dev)
            certs = cert_ms(tp) if fused else None
            tp.run()
            tp.wait()
            excluded = certs or 0.0
            if fused:
                t = time.perf_counter()
                check_rel = potrf_residual(dev, Ap, a_st)
                excluded += (time.perf_counter() - t) * 1e3
                log(f"    POTRF-T fused ||LL^T - A||_F / ||A||_F "
                    f"{check_rel:.3e} (limit 1e-4)")
                check("11b POTRF-T fused residual <= 1e-4",
                      check_rel <= 1e-4)
            dev.flush()
            fs = dev.info()["fuse"]
            dev.stop()
            nt_ = N // nbp
            low = [Ap.tile(m, k).copy() for m in range(nt_)
                   for k in range(m + 1)]
            del a_st
        if dev_t.type == "cuda":
            torch.cuda.empty_cache()
        return low, fs, certs, excluded
    pair(f"POTRF-T N={N} NB={nbp}", potrf)

    # ------------------------------------------------ 11c: plan_check
    with pt.Context(nb_workers=4) as ctx:
        A, B = to_collection(rng.standard_normal((n, n), dtype=np.float32),
                             nb, nb), \
            to_collection(rng.standard_normal((n, n), dtype=np.float32),
                          nb, nb)
        C = to_collection(np.zeros((n, n), np.float32), nb, nb)
        for name, coll in (("A", A), ("B", B), ("C", C)):
            coll.register(ctx, name)
        dev = new_dev(ctx, {}, env={"PTC_DEVICE_BATCH": "1"})
        tp = build_gemm(ctx, A, B, C, dev)
        plan = tp.plan()
        predicted = plan.peak_bytes(rank=0, device_only=True)
        dev.plan_check(tp, mode="warn", plan=plan)
        t = time.perf_counter()
        tp.run()
        tp.wait()
        dev.flush()
        wall = (time.perf_counter() - t) * 1e3
        dev.stop()
        measured = dev.stats["cache_peak_bytes"]
        ps = ctx.stats()["plan"]
        log(f"  11c GEMM {n}^2 in {nb}^2 tiles, PTC_DEVICE_BATCH=1: "
            f"{wall:.1f} ms, {dev.stats['batches']} batched launches; "
            f"cache_peak_bytes {measured}, predicted peak {predicted} "
            f"({predicted / max(1, measured):.4f}x); stats()['plan'] {ps}")
        check("11c measured peak <= predicted <= 1.25x measured",
              0 < measured <= predicted <= 1.25 * measured)
        check("11c stats()['plan'] one check, fits",
              ps["checks"] == 1 and ps["over_budget"] == 0
              and ps["last_peak_bytes"] == predicted)

    # out-of-core: phase 7's GEMM (square) and the reference test's
    # geometry (K = N / 4, tests/device/test_plan_check.py), each at half
    # its tile set.  The plan's spill model evicts furthest-next-use
    # first: for the square GEMM the dirty C tiles alone fit in half the
    # tile set, so it predicts no spill where the device (LRU over lane
    # stacks) spills; the verdict is held where the model predicts spills
    n2, nb2 = dims["gemm_ooc"]
    for label, k2 in (("phase 7's", n2), ("the reference test's", n2 // 4)):
        a2 = rng.standard_normal((n2, k2), dtype=np.float32)
        b2 = rng.standard_normal((k2, n2), dtype=np.float32)
        tile_set = (2 * n2 * k2 + n2 * n2) * 4
        with pt.Context(nb_workers=4) as ctx:
            A, B = to_collection(a2, nb2, nb2), to_collection(b2, nb2, nb2)
            C = to_collection(np.zeros((n2, n2), np.float32), nb2, nb2)
            for name, coll in (("A", A), ("B", B), ("C", C)):
                coll.register(ctx, name)
            dev = new_dev(ctx, {}, cache_bytes=tile_set // 2)
            tp = build_gemm(ctx, A, B, C, dev)
            params.set("device.plan_check", "warn")
            try:
                t = time.perf_counter()
                tp.run()
            finally:
                params.unset("device.plan_check")
            tp.wait()
            dev.flush()
            sync(dev_t)
            wall = (time.perf_counter() - t) * 1e3
            fs = dev.info()["fuse"]
            dev.stop()
            ps = ctx.stats()["plan"]
            spills = dev.stats["spills"]
            pred = ps["predicted_spills"]
            log(f"  11c {label} GEMM {n2}x{k2} @ {k2}x{n2} in {nb2}^2 tiles "
                f"at half its tile set ({tile_set // 2} B), plan_check "
                f"warn: {wall:.1f} ms; predicted spills {pred}, measured "
                f"spills {spills} ({dev.stats['spill_bytes']} B); verdicts "
                f"{'agree' if (pred > 0) == (spills > 0) else 'DISAGREE'}; "
                f"chains {fs['fused_chains']}, refused {fs['refused']}; "
                f"stats()['plan'] {ps}")
            check(f"11c {label}: stats()['plan'] one check, over budget",
                  ps["checks"] == 1 and ps["over_budget"] == 1
                  and ps["last_budget_bytes"] == tile_set // 2)
            check(f"11c {label}: the device spilled", spills > 0)
            if k2 != n2:
                check(f"11c {label}: predicted spills > 0, the verdicts "
                      "agree", pred > 0 and spills > 0)
            check(f"11c {label}: chains refused for residency pressure",
                  fs["refused"].get("chain:residency-pressure", 0) > 0,
                  f"(chains run: {fs['fused_chains']})")
            check_close(f"11c {label} out-of-core GEMM C vs torch.matmul",
                        to_tensor(C.to_dense(), dev_t),
                        torch.matmul(to_tensor(a2, dev_t),
                                     to_tensor(b2, dev_t)), 1e-4, 1e-3)
            out["runs"][f"11c OOC {label}"] = {
                "wall_ms": wall, "predicted_spills": pred, "spills": spills,
                "plan": ps, "chains": fs["fused_chains"],
                "refused": fs["refused"]}
        del a2, b2
    out["runs"]["11c resident"] = {"measured_peak": measured,
                                   "predicted_peak": predicted}

    with pt.Context(nb_workers=4) as ctx:
        A, B = to_collection(np.ones((n, n), np.float32), nb, nb), \
            to_collection(np.ones((n, n), np.float32), nb, nb)
        C = to_collection(np.zeros((n, n), np.float32), nb, nb)
        for name, coll in (("A", A), ("B", B), ("C", C)):
            coll.register(ctx, name)
        dev = new_dev(ctx, {"device.out_of_core": False},
                      cache_bytes=3 * n * n * 4 // 2)
        tp = build_gemm(ctx, A, B, C, dev)
        params.set("device.plan_check", "error")
        raised = None
        try:
            tp.run()
        except PlanCheckError as e:
            raised = str(e)
        finally:
            params.unset("device.plan_check")
        ps = ctx.stats()["plan"]
        log(f"  11c error mode, out-of-core off: PlanCheckError "
            f"{raised!r}; committed {tp._committed}; device tasks "
            f"{dev.stats['tasks']}; stats()['plan'] {ps}")
        check("11c PlanCheckError before any task is scheduled",
              raised is not None and not tp._committed
              and dev.stats["tasks"] == 0)
        check("11c stats()['plan'] one check, over budget, no spill "
              "predicted", ps["checks"] == 1 and ps["over_budget"] == 1
              and ps["predicted_spills"] == 0 and ps["enabled"] is False)
        dev.stop()
    if fails:
        raise AssertionError(f"phase 11: {len(fails)} check(s) failed: "
                             f"{fails}")
    return out


# phase 12 sizes: GEMM (N, NB) as phase 4's; NORM (rows, d, T) as phase
# 4's (32 tiles of 16 MiB); the collectives' buffer in float32 elements
# (64 MiB); the panel reduction's (M, K, N), integer-valued
COMM = {"gemm": (4096, 512), "norm": (8 * 4096, 4096, 1024),
        "coll_elems": 16 << 20, "panel": (2048, 2048, 2048),
        "timeout": 240.0}


def _owned_on(owner: int):
    """A TwoDimBlockCyclic whose every tile lives on rank `owner` (rank 0
    holds X, rank 1 holds O in phase 12b)."""
    from parsec_tpu_torch.data.collections import TwoDimBlockCyclic

    class OwnedBy(TwoDimBlockCyclic):
        def rank_of(self, m: int, n: int) -> int:
            return owner
    return OwnedBy


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def comm_norm_chain(ctx, rank: int, nodes: int, dev_t, dims, label: str,
                    make_dev, tag: str = "", trace: bool = False,
                    reset: bool = True, xfer: bool = False) -> dict:
    """Phase 12b/12c's program on one rank: NORM twice across the ranks.
    N0(r) on rank 0 normalizes X's row tile r (X on rank 0) on the card
    into an arena tile Y; N1(r) on rank 1 reads Y, device-resident, through
    the data plane, normalizes it again and writes O's tile r (O on rank
    1).  W is rank-replicated.  X is drawn on the card from a seeded torch
    generator (every rank draws the same).  Returns the run's counters,
    and on rank 1 O's digest and its error against the plain version
    applied twice.  `tag` suffixes the collections' and arenas' names
    (a second run on one Context); `trace` records the run at level 2
    and returns the device's and the wire's spans (trace_summary).
    `reset=False` leaves the kernels' launch counts to the caller (the
    colocated ranks share them); `chore_calls`, this rank's device's
    calls of the NORM chore, each one launch of the RMSNorm kernel on
    the card, shows this rank's own launches.  `xfer`: the transfer
    plane (device.dp_transfer) is on, so the intermediate crosses as CUDA
    IPC tokens pulled card to card (dp_xfer_bytes), not as bytes."""
    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch import kernels
    from parsec_tpu_torch.data.collections import ReplicatedLocal
    rn_mod = importlib.import_module("parsec_tpu_torch.ops.rms_norm")
    rows, d, T = dims["norm"]
    R = rows // T
    gen = torch.Generator(device=dev_t).manual_seed(SEED + 12)
    xt = torch.randn((rows, d), generator=gen, device=dev_t)
    wt = torch.randn((d,), generator=gen, device=dev_t)
    X = _owned_on(0)(rows, d, T, d, P=nodes, nodes=nodes, myrank=rank)
    O = _owned_on(1)(rows, d, T, d, P=nodes, nodes=nodes, myrank=rank)
    W = ReplicatedLocal(1, d, 1, d, nodes=nodes, myrank=rank)
    W.tile(0, 0)[...] = wt.cpu().numpy()
    if rank == 0:
        xh = xt.cpu().numpy()
        for r in range(R):
            X.tile(r, 0)[...] = xh[r * T:(r + 1) * T]
        del xh
    xn, on, wn, yn, otn = (n + tag for n in ("X", "O", "W", "Y", "Ot"))
    X.register(ctx, xn)
    O.register(ctx, on)
    W.register(ctx, wn)
    tile_bytes = T * d * 4
    ctx.register_arena(yn, tile_bytes)
    ctx.register_arena(otn, tile_bytes)
    dev = make_dev(ctx)
    tp = pt.Taskpool(ctx, globals={"R": R - 1})
    r_ = pt.L("r")
    n0 = tp.task_class("N0")
    n0.param("r", 0, pt.G("R"))
    n0.affinity(xn, r_, 0)
    n0.flow("X", "READ", pt.In(pt.Mem(xn, r_, 0)))
    n0.flow("W", "READ", pt.In(pt.Mem(wn, 0, 0)))
    n0.flow("Y", "W", pt.Out(pt.Ref("N1", r_, flow="Y")), arena=yn)
    n1 = tp.task_class("N1")
    n1.param("r", 0, pt.G("R"))
    n1.affinity(on, r_, 0)
    n1.flow("Y", "READ", pt.In(pt.Ref("N0", r_, flow="Y")), arena=yn)
    n1.flow("W", "READ", pt.In(pt.Mem(wn, 0, 0)))
    n1.flow("O", "W", pt.Out(pt.Mem(on, r_, 0)), arena=otn)
    eps = EPS

    def k_norm(x, w):
        # x [lanes, T, d]; w [lanes, 1, d], the one scale tile
        return rn_mod.rms_norm(x, w[0, 0], eps)

    shp, wshp = (T, d), (1, d)
    dev.attach(n0, tp, kernel=k_norm, reads=["X", "W"], writes=["Y"],
               shapes={"X": shp, "W": wshp, "Y": shp}, dtype=np.float32)
    dev.attach(n1, tp, kernel=k_norm, reads=["Y", "W"], writes=["O"],
               shapes={"Y": shp, "W": wshp, "O": shp}, dtype=np.float32)
    if reset:
        kernels.reset_launches()
    if trace:
        ctx.profile_take()
        ctx.profile_enable(2)
    s0 = ctx.comm_stats()
    sync(dev_t)
    t = time.perf_counter()
    tp.run()
    t_run = time.perf_counter()
    tp.wait()
    t_wait = time.perf_counter()
    ctx.comm_fence()
    sync(dev_t)
    wall = (time.perf_counter() - t) * 1e3
    # the wall's parts: tp.run() returning, the pool's tasks, the fence
    parts = {"run_ms": (t_run - t) * 1e3, "wait_ms": (t_wait - t_run) * 1e3,
             "fence_ms": wall - (t_wait - t) * 1e3}
    launches = dict(kernels.LAUNCHES)
    chore_calls = dev.launches.get("k_norm", [0, 0])[0]
    spans = None
    if trace:
        from parsec_tpu_torch.profiling import (KEY_COMM_RECV, KEY_STREAM,
                                                take_trace)
        ctx.profile_enable(0)
        tr = take_trace(ctx, class_names=[c.name for c in tp.classes])
        ev = tr.events
        t_min = ev[:, 7].min() if len(ev) else 0
        recv = ev[(ev[:, 0] == KEY_COMM_RECV) & (ev[:, 1] == 0), 7]
        spans = trace_summary(tr)
        spans["stream_span_ms"] = sum(
            (t1 - t0) / 1e6 for (_, _, key, _, _, _, _, t0, t1)
            in tr.spans() if key == KEY_STREAM)
        spans["comm_recv"] = int(len(recv))
        spans["comm_recv_first_last_ms"] = (
            [float(recv.min() - t_min) / 1e6, float(recv.max() - t_min)
             / 1e6] if len(recv) else None)
    st = dict(dev.stats)  # before any flush
    s1 = ctx.comm_stats()
    out = {"label": label, "rank": rank, "wall_ms": wall, "parts": parts,
           "spans": spans,
           "launches": launches, "chore_calls": chore_calls,
           "payload_bytes": R * tile_bytes,
           "bytes_sent": s1["bytes_sent"] - s0["bytes_sent"],
           "bytes_recv": s1["bytes_recv"] - s0["bytes_recv"],
           "stream": ctx.comm_stream_stats(),
           "dev": {k: st[k] for k in (
               "dp_sends", "dp_recv_bytes", "dp_d2d_bytes", "dp_errors",
               "dp_serve_bytes", "dp_serve_d2h_ns", "dp_serve_copy_ns",
               "d2h_bytes", "h2d_bytes", "stream_serves", "stream_slices",
               "stream_d2h_ns", "stream_copy_ns", "stream_bytes",
               "dp_xfer_tokens", "dp_xfer_bytes", "dp_xfer_pull_ns",
               "tasks")}}
    if st["dp_errors"]:
        raise AssertionError(f"{label} rank {rank}: dp_errors "
                             f"{st['dp_errors']}")
    if dev_t.type == "cuda" and (
            chore_calls <= 0 or launches["rms_norm"] < chore_calls):
        raise AssertionError(
            f"{label} rank {rank}: {chore_calls} NORM chore calls, "
            f"{launches['rms_norm']} rms_norm launches in the process")
    if rank == 0:
        if st["dp_sends"] != R or st["d2h_bytes"] != 0:
            raise AssertionError(
                f"{label} rank 0: dp_sends {st['dp_sends']} (want {R}), "
                f"d2h_bytes {st['d2h_bytes']} (want 0: the intermediate's "
                "host copy is never written)")
    dev.flush()
    if rank == 1:
        way = "clone" if ctx._colocated else \
            "transfer plane" if xfer else "wire"
        moved = {"clone": st["dp_d2d_bytes"], "wire": st["dp_recv_bytes"],
                 "transfer plane": st["dp_xfer_bytes"]}[way]
        other = st["dp_d2d_bytes"] + st["dp_recv_bytes"] + \
            st["dp_xfer_bytes"] - moved
        if moved != R * tile_bytes or other != 0:
            raise AssertionError(
                f"{label} rank 1: {st['dp_recv_bytes']} B delivered, "
                f"{st['dp_d2d_bytes']} B cloned on the card, "
                f"{st['dp_xfer_bytes']} B pulled through the transfer "
                f"plane; want {R * tile_bytes} B the {way} way only")
        # W's 16 KiB tile may be staged more than once (the lane and a
        # dispatch can race for it), a 16 MiB intermediate never
        if st["h2d_bytes"] >= tile_bytes or st["h2d_bytes"] % (d * 4):
            raise AssertionError(f"{label} rank 1: h2d_bytes "
                                 f"{st['h2d_bytes']}: only W's {d * 4} B "
                                 "tile may be staged, no intermediate")
        o = np.concatenate([O.tile(r, 0) for r in range(R)])
        want = rn_mod.rms_norm_plain(rn_mod.rms_norm_plain(xt, wt, eps), wt,
                                     eps)
        out["max_abs_err"] = check_close(
            f"12 {label} O vs the plain version twice",
            torch.from_numpy(o).to(dev_t), want, 2e-5, 2e-5)
        out["o_digest"] = _digest(o)
    dev.stop()
    return out


def _comm_gemm(ctx, rank, nodes, dev_t, dims, label, want_c, mats, c0,
               fused=True, trace_path=None) -> dict:
    """One run of build_gemm_dist on this rank (12a): C reset to c0, a
    fresh CudaDevice (device.wave_fuse as asked), run, fence, flush;
    owned C tiles held to phase 4's 1e-4 / 1e-3 against want_c (on the
    card); returns the wall, the wire counters, the k_gemm_nn widths and
    the owned C's digest."""
    import torch

    from parsec_tpu_torch.algos.gemm import build_gemm_dist
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.profiling import take_trace
    from parsec_tpu_torch.utils import params as _knobs
    n, nb = dims["gemm"]
    (A, B, C), names = mats
    for m in range(C.mt):
        for k in range(C.nt):
            if C.rank_of(m, k) == rank:
                C.tile(m, k)[...] = c0[m * nb:(m + 1) * nb,
                                       k * nb:(k + 1) * nb]
    _knobs.set("device.wave_fuse", fused)
    try:
        dev = CudaDevice(ctx, device=dev_t)
    finally:
        _knobs.unset("device.wave_fuse")
    tp = build_gemm_dist(ctx, A, B, C, dev, names=names)
    body = dev._pools[tp._ptr].bodies[tp.class_by_name("Gemm").id]
    widths, kern = [], body.kernel

    def k_gemm_nn(a_, b_, c_):  # the chore, its widths recorded
        widths.append(int(a_.shape[0]))
        return kern(a_, b_, c_)
    body.kernel = k_gemm_nn
    if trace_path:
        ctx.profile_take()
        ctx.profile_enable(1)
    s0, r0 = ctx.comm_stats(), ctx.comm_rdv_stats()
    sync(dev_t)
    t = time.perf_counter()
    tp.run()
    tp.wait()
    ctx.comm_fence()
    dev.flush()
    sync(dev_t)
    wall = (time.perf_counter() - t) * 1e3
    s1, rdv = ctx.comm_stats(), ctx.comm_rdv_stats()
    if trace_path:
        ctx.profile_enable(0)
        take_trace(ctx, class_names=[c.name for c in tp.classes]) \
            .save(trace_path)
    st = dict(dev.stats)
    dev.stop()
    if st["dp_errors"]:
        raise AssertionError(f"12a {label}: dp_errors {st['dp_errors']}")
    if s1["msgs_sent"] - s0["msgs_sent"] <= 0:
        raise AssertionError(f"12a {label}: no message sent")
    if rdv["registered_bytes"] or rdv["pending_pulls"]:
        raise AssertionError(f"12a {label}: after the fence {rdv}")
    rows = [m for m in range(C.mt) if C.rank_of(m, 0) == rank]
    got = np.concatenate([np.concatenate([C.tile(m, k) for k in
                                          range(C.nt)], axis=1)
                          for m in rows])
    want = torch.cat([want_c[m * nb:(m + 1) * nb] for m in rows])
    err = check_close(f"12a GEMM {label} rank {rank} owned C vs "
                      "torch.matmul", torch.from_numpy(got).to(dev_t), want,
                      1e-4, 1e-3)
    return {"label": label, "wall_ms": wall, "fused": fused,
            "bytes_sent": s1["bytes_sent"] - s0["bytes_sent"],
            "bytes_recv": s1["bytes_recv"] - s0["bytes_recv"],
            "msgs_sent": s1["msgs_sent"] - s0["msgs_sent"],
            "gets": rdv["gets_sent"] - r0["gets_sent"],
            "widths": sorted(set(widths)), "calls": len(widths),
            "tasks": st["tasks"], "max_abs_err": err,
            "c_digest": _digest(got)}


def _comm_colls(ctx, rank, nodes, dims, topos) -> dict:
    """12d: the four collectives over a 64 MiB float32 buffer per rank
    (integer values, so every reduction order gives the same bits),
    under each topology; every result against numpy's rank-order sum.
    Returns per (topology, op) the host wall and the result's digest."""
    from parsec_tpu_torch.comm import coll
    elems = dims["coll_elems"]
    alls = [np.random.default_rng(SEED + 100 + r).integers(
        -50, 50, size=elems).astype(np.float32) for r in range(nodes)]
    total = np.sum(np.stack(alls), axis=0, dtype=np.float32)
    seg = -(-elems // nodes)
    root = 1 % nodes
    want = {"all_reduce": total,
            "reduce_scatter": total[rank * seg:(rank + 1) * seg],
            "all_gather": np.concatenate(alls), "broadcast": alls[root]}
    out = {}
    for topo in topos:
        for op in ("all_reduce", "reduce_scatter", "all_gather",
                   "broadcast"):
            ctx.comm_fence()
            t = time.perf_counter()
            if op == "broadcast":
                got = coll.broadcast(ctx, alls[rank].copy(), root=root,
                                     topo=topo)
            else:
                got = getattr(coll, op)(ctx, alls[rank], topo=topo)
            ms = (time.perf_counter() - t) * 1e3
            if not np.array_equal(got, want[op]):
                raise AssertionError(f"12d {op} topo={topo} rank {rank}: "
                                     "differs from numpy's sum")
            out[f"{topo}/{op}"] = {"ms": ms, "digest": _digest(got)}
    ctx.comm_fence()
    return out


def _comm_panels(ctx, rank, nodes, dims) -> dict:
    """12d: gemm_panel_reduce, the runtime-native collective against the
    DAG chain, each bit for bit against numpy (integer-valued)."""
    from parsec_tpu_torch.algos.gemm import gemm_panel_reduce
    M, K, Nc = dims["panel"]
    rng = np.random.default_rng(SEED + 3)
    a = rng.integers(-4, 4, size=(M, K)).astype(np.float32)
    b = rng.integers(-4, 4, size=(K, Nc)).astype(np.float32)
    ks = K // nodes
    ref = sum(a[:, r * ks:(r + 1) * ks] @ b[r * ks:(r + 1) * ks]
              for r in range(nodes))
    out = {}
    for mode in ("coll", "chain"):
        ctx.comm_fence()
        t = time.perf_counter()
        c = gemm_panel_reduce(ctx, a[:, rank * ks:(rank + 1) * ks].copy(),
                              b[rank * ks:(rank + 1) * ks].copy(),
                              reduce=mode)
        ms = (time.perf_counter() - t) * 1e3
        if not np.array_equal(c, ref):
            raise AssertionError(f"12d gemm_panel_reduce {mode} rank "
                                 f"{rank}: differs from numpy")
        out[mode] = {"ms": ms, "digest": _digest(c)}
    ctx.comm_fence()
    return out


def comm_rank(rank, nodes, port, q, dev_s, dims, out_dir, multi=None,
              fleet=None, mesh=None):
    """One spawned rank of phase 12 (12a, 12b, 12d, 12e) and, with
    `multi` (phase 13's sizes), of phase 13 (13b, 13d), with `fleet`
    (phase 14's), of phase 14 (14b-14d), and with `mesh` (phase 15's), of
    phase 15d: pushes ("ok", rank, results) or ("err", rank,
    traceback)."""
    import traceback
    try:
        q.put(("ok", rank, _comm_rank(rank, nodes, port, dev_s, dims,
                                      out_dir, multi, fleet, mesh)))
    except Exception:
        q.put(("err", rank, traceback.format_exc()))


def _comm_rank(rank, nodes, port, dev_s, dims, out_dir,
               multi=None, fleet=None, mesh=None) -> dict:
    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch.convert import to_tensor
    from parsec_tpu_torch.data.collections import TwoDimBlockCyclic
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.utils import params as _knobs
    torch.backends.cuda.matmul.allow_tf32 = False
    dev_t = torch.device(dev_s)
    if dev_t.type == "cuda":
        torch.cuda.set_device(dev_t)
    n, nb = dims["gemm"]
    rng = np.random.default_rng(SEED + 12)
    a = rng.standard_normal((n, n), dtype=np.float32)
    b = rng.standard_normal((n, n), dtype=np.float32)
    c0 = rng.standard_normal((n, n), dtype=np.float32)
    want_c = to_tensor(c0, dev_t) + torch.matmul(to_tensor(a, dev_t),
                                                 to_tensor(b, dev_t))
    res = {"rank": rank, "gemm": [], "norm": []}

    def collections(ctx, tag):
        mats, names = [], []
        for name, src in (("A", a), ("B", b), ("C", None)):
            m = TwoDimBlockCyclic(n, n, nb, nb, P=nodes, Q=1, nodes=nodes,
                                  myrank=rank)
            m.register(ctx, name + tag)
            if src is not None:
                m.from_dense(src)
            mats.append(m)
            names.append(name + tag)
        return mats, tuple(names)

    # pass 1: the default knobs (comm.eager_limit 64 KiB, comm.stream and
    # device.stream_serve on)
    ctx = pt.Context(nb_workers=4)
    ctx.set_rank(rank, nodes)
    ctx.comm_init(port)
    mats = collections(ctx, "1")
    for topo in ("star", "chain", "binomial"):
        ctx.comm_set_topology(topo)
        res["gemm"].append(_comm_gemm(ctx, rank, nodes, dev_t, dims, topo,
                                      want_c, mats, c0))
    ctx.comm_set_topology("star")
    res["gemm"].append(_comm_gemm(ctx, rank, nodes, dev_t, dims,
                                  "star unfused", want_c, mats, c0,
                                  fused=False))
    res["gemm"].append(_comm_gemm(
        ctx, rank, nodes, dev_t, dims, "star traced", want_c, mats, c0,
        trace_path=os.path.join(out_dir, f"phase12_r{rank}.ptt")))
    res["norm"].append(comm_norm_chain(
        ctx, rank, nodes, dev_t, dims, "NORM stream on",
        lambda c: CudaDevice(c, device=dev_t)))
    res["norm_traced"] = comm_norm_chain(
        ctx, rank, nodes, dev_t, dims, "NORM stream on, traced",
        lambda c: CudaDevice(c, device=dev_t), tag="t", trace=True)
    res["coll"] = _comm_colls(ctx, rank, nodes, dims,
                              ("ring", "binomial", "star"))
    res["panel"] = _comm_panels(ctx, rank, nodes, dims)
    res["coll_stats"] = ctx.coll_stats()
    res["clock"] = ctx.comm_clock()
    ctx.comm_fini()
    ctx.destroy()
    # pass 2: comm.eager_limit = 0, comm.stream and device.stream_serve
    # off (the engine reads its knobs at comm_init)
    os.environ["PTC_MCA_comm_eager_limit"] = "0"
    os.environ["PTC_MCA_comm_stream"] = "0"
    _knobs.set("device.stream_serve", False)
    ctx = pt.Context(nb_workers=4)
    ctx.set_rank(rank, nodes)
    ctx.comm_init(port + 8)
    res["gemm"].append(_comm_gemm(ctx, rank, nodes, dev_t, dims,
                                  "star eager_limit=0", want_c,
                                  collections(ctx, "2"), c0))
    res["norm"].append(comm_norm_chain(
        ctx, rank, nodes, dev_t, dims, "NORM stream off",
        lambda c: CudaDevice(c, device=dev_t)))
    res["coll_off"] = _comm_colls(ctx, rank, nodes, dims, ("ring",))
    ctx.comm_fini()
    ctx.destroy()
    # phase 13b and 13d on these ranks, with the default knobs back
    os.environ.pop("PTC_MCA_comm_eager_limit")
    os.environ.pop("PTC_MCA_comm_stream")
    _knobs.unset("device.stream_serve")
    if multi is not None:
        res["multi"] = multi_rank(rank, nodes, port + 16, dev_t, multi)
    if fleet is not None:
        res["fleet"] = fleet_rank(rank, nodes, port + 28, dev_t, fleet,
                                  dims, out_dir)
    if mesh is not None:
        res["mesh"] = mesh_rank(rank, nodes, port + 40, dev_t, mesh)
    if "jax" in sys.modules:
        raise AssertionError("phase 12 rank imported jax")
    return res


def comm_colocated(dev_t, dims, port: int) -> list:
    """12c: phase 12b's NORM chain with two Contexts in this process, one
    thread each, declared colocated, both devices on one card: the
    intermediate moves as by-reference tokens and on-card clones."""
    from parsec_tpu_torch.device import CudaDevice
    import parsec_tpu_torch as pt
    results, nodes = {}, 2

    def worker(rank):
        import traceback
        try:
            ctx = pt.Context(nb_workers=2)
            ctx.set_rank(rank, nodes)
            ctx.comm_init(port)
            ctx.comm_set_colocated([r for r in range(nodes) if r != rank])
            out = comm_norm_chain(ctx, rank, nodes, dev_t, dims,
                                  "NORM colocated",
                                  lambda c: CudaDevice(c, device=dev_t),
                                  reset=False)
            out["bytes_sent_total"] = ctx.comm_stats()["bytes_sent"]
            ctx.comm_fini()
            ctx.destroy()
            results[rank] = ("ok", out)
        except Exception:
            results[rank] = ("err", traceback.format_exc())

    threads = [threading.Thread(target=worker, args=(r,), daemon=True)
               for r in range(nodes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=dims["timeout"])
    bad = [results.get(r, ("err", f"rank {r} did not finish"))
           for r in range(nodes)
           if results.get(r, ("err",))[0] != "ok"]
    if any(t.is_alive() for t in threads):
        import faulthandler
        faulthandler.dump_traceback(file=sys.stdout, all_threads=True)
    if bad:
        raise AssertionError("12c: " + "\n".join(str(b[1]) for b in bad))
    return [results[r][1] for r in range(nodes)]


def comm_path(dev_t, dims=None, out_dir=None, multi=None,
              fleet=None, mesh=None) -> dict:
    """Phase 12: the comm engine on the card, two ranks as two spawned
    processes on the one card over the loopback transport (the card
    time-slices them: the walls include it), then two colocated ranks in
    this process.
      12a build_gemm_dist at phase 4's size on P=2 x Q=1 ranks under the
          star, chain and binomial broadcasts and with
          comm.eager_limit=0; owned C tiles against torch.matmul at
          1e-4 / 1e-3; every run (each topology, fused (the default)
          and device.wave_fuse=0) gives a rank's owned C the same bits
      12b phase 4's NORM as a two-rank chain through the data plane (the
          RMSNorm kernel on both ranks), with comm.stream and
          device.stream_serve on and off, O bit-identical between them,
          and once more streamed and traced at level 2 (the device's
          and the wire's spans per rank)
      12c 12b colocated: by-reference tokens and on-card clones
      12d the four collectives over 64 MiB under ring, binomial and
          star, comm.stream off bit-exact, and gemm_panel_reduce coll
          against chain
      12e 12a's GEMM traced on both ranks, merged on the clock offsets
    With `multi` (phase 13's sizes) the same two ranks then run phase
    13b and 13d (multi_rank), with `fleet` (phase 14's) phase 14b-14d
    (fleet_rank), and with `mesh` (phase 15's) phase 15d (mesh_rank).
    Returns the runs, the hand-written kernels' launches (12b's on both
    ranks, traced run included, and 12c's) and the ranks' phase 13, 14
    and 15d results."""
    import multiprocessing as mp

    import torch

    from parsec_tpu_torch import kernels
    from parsec_tpu_torch.comm.launch import free_port_base
    from parsec_tpu_torch.profiling import Trace
    dims = dims or COMM
    out_dir = out_dir or os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "build", "phase12")
    os.makedirs(out_dir, exist_ok=True)
    nodes = 2
    port = free_port_base(44)
    mpctx = mp.get_context("spawn")
    q = mpctx.Queue()
    dev_s = str(dev_t)
    procs = [mpctx.Process(target=comm_rank, args=(r, nodes, port, q, dev_s,
                                                   dims, out_dir, multi,
                                                   fleet, mesh))
             for r in range(nodes)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    import queue
    got = []
    wait_s = dims["timeout"] + (multi["timeout"] if multi else 0.0) + \
        (fleet["timeout"] if fleet else 0.0) + \
        (mesh["timeout"] if mesh else 0.0)
    try:
        for _ in range(nodes):
            got.append(q.get(timeout=wait_s))
    except queue.Empty:
        got.append(("err", -1, f"a rank sent nothing in "
                    f"{wait_s:.0f} s (timed out)"))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    errs = [g for g in got if g[0] != "ok"]
    if errs:
        raise AssertionError("phase 12 rank failed:\n" +
                             "\n".join(g[2] for g in errs))
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"phase 12 ranks exited "
                             f"{[p.exitcode for p in procs]}")
    ranks = [g[2] for g in sorted(got, key=lambda g: g[1])]
    spmd_s = time.perf_counter() - t0
    launches = {name: 0 for name in kernels.LAUNCHES}
    multi_ranks = [r.pop("multi") for r in ranks] if multi else None
    multi_s = max(r["wall_s"] for r in multi_ranks) if multi else 0.0
    fleet_ranks = [r.pop("fleet") for r in ranks] if fleet else None
    fleet_s = max(r["wall_s"] for r in fleet_ranks) if fleet else 0.0
    mesh_ranks = [r.pop("mesh") for r in ranks] if mesh else None
    mesh_s = max(r["wall_s"] for r in mesh_ranks) if mesh else 0.0
    runs = {"spmd_s": spmd_s, "multi_s": multi_s, "fleet_s": fleet_s,
            "mesh_s": mesh_s}

    # 12a: walls and wire bytes per run; fused against unfused
    gem = list(zip(*[r["gemm"] for r in ranks]))
    runs["gemm"] = []
    for per_rank in gem:
        lb = per_rank[0]["label"]
        row = {"label": lb,
               "wall_ms": [g["wall_ms"] for g in per_rank],
               "bytes_sent": [g["bytes_sent"] for g in per_rank],
               "msgs_sent": [g["msgs_sent"] for g in per_rank],
               "widths": [g["widths"] for g in per_rank],
               "max_abs_err": max(g["max_abs_err"] for g in per_rank),
               "c_digest": [g["c_digest"] for g in per_rank]}
        runs["gemm"].append(row)
        log(f"  12a GEMM {lb}: walls {[f'{w:.1f}' for w in row['wall_ms']]}"
            f" ms, bytes sent {row['bytes_sent']}, messages "
            f"{row['msgs_sent']}, k_gemm_nn widths {row['widths']}, C "
            f"{row['c_digest']}")
    # every run (each topology, fused and unfused) gives a rank's owned
    # C the same bits: a lone lane is a two-lane product (phase 11a), so
    # no bit depends on a wave's width; each run is also held to
    # torch.matmul above
    runs["gemm_groups"] = []
    for r in range(nodes):
        groups: dict = {}
        for r_ in runs["gemm"]:
            groups.setdefault(r_["c_digest"][r], []).append(
                (r_["label"], r_["widths"][r]))
        runs["gemm_groups"].append(groups)
        log(f"  12a rank {r} owned C bits: " + "; ".join(
            f"{k}: " + ", ".join(f"{lb} {w}" for lb, w in m)
            for k, m in groups.items()))
        if len(groups) > 1:
            raise AssertionError(f"12a rank {r}: owned C differs between "
                                 f"runs ({len(groups)} groups of bits)")
    by = {r_["label"]: r_ for r_ in runs["gemm"]}
    f_, u_ = by["star"], by["star unfused"]
    runs["gemm_fused_bits"] = "identical" if \
        f_["c_digest"] == u_["c_digest"] else "different"
    log(f"  12a fused against unfused owned C: {runs['gemm_fused_bits']}")

    # 12b: the data plane, stream on and off
    runs["norm"] = []
    for i in range(2):
        r0, r1 = ranks[0]["norm"][i], ranks[1]["norm"][i]
        for name, n_ in r0["launches"].items():
            launches[name] += n_ + r1["launches"][name]
        gbps = r1["payload_bytes"] / (r1["wall_ms"] / 1e3) / 1e9
        st = r0["stream"]
        row = {"label": r0["label"], "wall_ms": [r0["wall_ms"],
                                                 r1["wall_ms"]],
               "payload_gbps": gbps, "o_digest": r1["o_digest"],
               "max_abs_err": r1["max_abs_err"],
               "stream_slices": r0["dev"]["stream_slices"],
               "stream_d2h_ns": r0["dev"]["stream_d2h_ns"],
               "stream_copy_ns": r0["dev"]["stream_copy_ns"],
               "stream_bytes": r0["dev"]["stream_bytes"],
               "serve_bytes": r0["dev"]["dp_serve_bytes"],
               "serve_d2h_ns": r0["dev"]["dp_serve_d2h_ns"],
               "serve_copy_ns": r0["dev"]["dp_serve_copy_ns"],
               "overlap_fraction": st["overlap_fraction"],
               "wire_ns": st["wire_ns"], "sessions": st["sessions"],
               "dev": [r0["dev"], r1["dev"]],
               "parts": [r0["parts"], r1["parts"]],
               "launches": [r0["launches"], r1["launches"]]}
        # the serve's host wall (streamed: paced by the wire) and its
        # copies alone (CUDA events on the d2h stream)
        d2h_ns = row["stream_d2h_ns"] or row["serve_d2h_ns"]
        copy_ns = row["stream_copy_ns"] or row["serve_copy_ns"]
        d2h_b = row["stream_bytes"] or row["serve_bytes"]
        row["serve_wall_gbps"] = d2h_b / d2h_ns if d2h_ns else None
        row["serve_d2h_gbps"] = d2h_b / copy_ns if copy_ns else None
        if dev_t.type == "cuda" and not copy_ns:
            raise AssertionError(f"12b {row['label']}: no serve copy timed")
        runs["norm"].append(row)
        log(f"  12b {row['label']}: walls {row['wall_ms'][0]:.1f} / "
            f"{row['wall_ms'][1]:.1f} ms, {r1['payload_bytes']} B over the "
            f"wire at {gbps:.3f} GB/s of the chain's wall, serve "
            f"{d2h_b} B in {d2h_ns / 1e6:.1f} ms of host wall "
            f"({row['serve_wall_gbps']} GB/s), its d2h copies "
            f"{copy_ns / 1e6:.2f} ms ({row['serve_d2h_gbps']} GB/s), "
            f"stream_slices {row['stream_slices']}, stream_d2h_ns "
            f"{row['stream_d2h_ns']}, overlap_fraction "
            f"{row['overlap_fraction']}, O {row['o_digest']}, launches "
            f"{row['launches']}; wall parts (run, wait, fence ms) "
            + ", ".join(f"rank {k}: " + "/".join(
                f"{v:.1f}" for v in p_.values())
                for k, p_ in enumerate(row["parts"])))
    runs["norm_traced"] = []
    for r_ in ranks:
        tr_ = r_["norm_traced"]
        for name, n_ in tr_["launches"].items():
            launches[name] += n_
        sp = tr_["spans"]
        runs["norm_traced"].append({"wall_ms": tr_["wall_ms"], **sp})
        per = {k: round(v["dispatch_ms"], 1) for k, v in
               sp["per_class"].items()}
        log(f"  12b traced rank {r_['rank']}: wall {tr_['wall_ms']:.1f} ms "
            f"(run/wait/fence " + "/".join(f"{v:.1f}" for v in
                                            tr_["parts"].values()) + "),"
            f" window {sp['window_ms']:.1f} ms; dispatch spans {per} ms, "
            f"stall {sp['stall_ns'] / 1e6:.1f} ms, lane h2d "
            f"{sp['lane_h2d_ms']:.1f} ms, release {sp['release_ms']:.1f} "
            f"ms, STREAM spans {sp['stream_span_ms']:.1f} ms; "
            f"{sp['comm_recv']} deliveries from "
            f"{sp['comm_recv_first_last_ms']} ms; O "
            f"{tr_.get('o_digest')}")
    if ranks[1]["norm_traced"]["o_digest"] != runs["norm"][0]["o_digest"]:
        raise AssertionError("12b: the traced run's O differs")
    if runs["norm"][0]["o_digest"] != runs["norm"][1]["o_digest"]:
        raise AssertionError("12b: O differs between comm.stream on and "
                             "off")
    if runs["norm"][0]["stream_slices"] <= 0 or \
            runs["norm"][1]["stream_slices"] != 0:
        raise AssertionError("12b: the stream on run streamed no slice, or "
                             "the off run streamed")

    # 12c: colocated in this process
    kernels.reset_launches()
    t = time.perf_counter()
    colo = comm_colocated(dev_t, dims, free_port_base(4))
    colo_s = time.perf_counter() - t
    for name, n_ in kernels.LAUNCHES.items():
        launches[name] += n_
    c0_, c1_ = colo
    if c1_["o_digest"] != runs["norm"][0]["o_digest"]:
        raise AssertionError("12c: O differs from 12b's")
    # both ranks launch from this process: its count is theirs together
    if dev_t.type == "cuda" and kernels.LAUNCHES["rms_norm"] != \
            c0_["chore_calls"] + c1_["chore_calls"]:
        raise AssertionError(
            f"12c: {kernels.LAUNCHES['rms_norm']} rms_norm launches for "
            f"{c0_['chore_calls']} + {c1_['chore_calls']} NORM chore calls")
    if c0_["bytes_sent_total"] * 100 > c0_["payload_bytes"]:
        raise AssertionError(f"12c: rank 0 sent {c0_['bytes_sent_total']} "
                             f"B for a {c0_['payload_bytes']} B payload")
    clone_gbps = c1_["payload_bytes"] / (c1_["wall_ms"] / 1e3) / 1e9
    # the on-card clone alone: comm/ici.py device_transfer of one of the
    # chain's tiles, CUDA events
    tile_ms = None
    if dev_t.type == "cuda":
        from parsec_tpu_torch.comm.ici import device_transfer
        rows_, d_, T_ = dims["norm"]
        tile = torch.randn((T_, d_), device=dev_t)
        tile_ms = time_ms(lambda: device_transfer(tile, dev_t), 20)
        log(f"  12c one {T_}x{d_} f32 tile cloned on the card by "
            f"device_transfer: {tile_ms:.4f} ms = "
            f"{tile.nbytes / tile_ms / 1e6:.1f} GB/s of payload")
        del tile
    runs["colocated"] = {"wall_ms": [c0_["wall_ms"], c1_["wall_ms"]],
                         "payload_gbps": clone_gbps, "tile_clone_ms": tile_ms,
                         "bytes_sent": c0_["bytes_sent_total"],
                         "dev": [c0_["dev"], c1_["dev"]],
                         "launches": dict(kernels.LAUNCHES),
                         "phase_s": colo_s}
    log(f"  12c NORM colocated: walls {c0_['wall_ms']:.1f} / "
        f"{c1_['wall_ms']:.1f} ms, {c1_['dev']['dp_d2d_bytes']} B cloned "
        f"on the card ({clone_gbps:.3f} GB/s of the chain's wall), rank 0 "
        f"sent {c0_['bytes_sent_total']} B on the wire, O bit for bit "
        f"12b's; rms_norm launched {c0_['chore_calls']} + "
        f"{c1_['chore_calls']} times by ranks 0 + 1")

    # 12d: the collectives
    runs["coll"] = {}
    for key in ranks[0]["coll"]:
        ms = [r["coll"][key]["ms"] for r in ranks]
        runs["coll"][key] = ms
        log(f"  12d {key} 64 MiB: {ms[0]:.1f} / {ms[1]:.1f} ms")
    for key in ranks[0]["coll_off"]:
        for r in ranks:
            if r["coll_off"][key]["digest"] != r["coll"][key]["digest"]:
                raise AssertionError(f"12d {key}: comm.stream=0 differs")
    log("  12d comm.stream=0 ring: bit for bit the streamed results")
    runs["panel"] = {m: [r["panel"][m]["ms"] for r in ranks]
                     for m in ("coll", "chain")}
    log(f"  12d gemm_panel_reduce {dims['panel']} coll "
        f"{runs['panel']['coll']} ms, chain {runs['panel']['chain']} ms; "
        f"coll_stats {ranks[0]['coll_stats']}")

    # 12e: the merged trace
    traces = [Trace.load(os.path.join(out_dir, f"phase12_r{r}.ptt"))
              for r in range(nodes)]
    m = Trace.merge(traces)
    off = traces[1].meta.get("clock_offset_ns")
    if off is None or m.meta["clock_offsets_ns"][1] != off:
        raise AssertionError(f"12e: rank 1's clock offset {off} not "
                             f"applied ({m.meta['clock_offsets_ns']})")
    fl = m.flows()
    if len(fl) == 0 or not (fl[:, 6] >= 0).all():
        raise AssertionError(f"12e: {len(fl)} flows, "
                             f"{int((fl[:, 6] < 0).sum())} receives "
                             "before their send")
    runs["trace"] = {"flows": int(len(fl)), "clock_offset_ns": off,
                     "clock_err_ns": traces[1].meta.get("clock_err_ns"),
                     "latency_ns_p50": float(np.median(fl[:, 6]))}
    log(f"  12e merged trace: {len(fl)} cross-rank flows, every receive at "
        f"or after its send; rank 1 clock offset {off} ns (err "
        f"{runs['trace']['clock_err_ns']} ns), wire latency p50 "
        f"{runs['trace']['latency_ns_p50'] / 1e3:.1f} us")
    return {"runs": runs, "launches": launches, "multi": multi_ranks,
            "fleet": fleet_ranks, "mesh": mesh_ranks}


# phase 13 sizes: ring attention (S shards, T tokens a shard, head dim d:
# Llama-2-7B's head dim, a 32768-token context); MoE (S, T, d, f, E, k) at
# Mixtral-8x7B's FFN widths, cut in depth only, its capped run's capacity
# (1.25 T k / E); 13b's and 13d's (S, T) on two ranks; the tensor-parallel
# serving round (prompt lengths, new tokens each); host threads that draw
# the expert weights
MULTI = {"ring": (8, 4096, 128), "ring2": (8, 4096),
         "moe": (4, 2048, 4096, 14336, 8, 2), "moe_cap": 640,
         "moe2": (2, 1024), "serve_prompts": (256, 512, 768, 1024),
         "serve_new": 8, "serve_pages": 512,
         "serve_model": {"vocab": 32000, "d": 4096, "heads": 32,
                         "page": 16},
         "threads": 8, "cache_bytes": 32 << 30, "timeout": 600.0}


def _launch_widths(dev) -> dict:
    """Record the lane width of every chore launch of `dev`, by chore name
    (its own counts, dev.launches, go on as before)."""
    widths: dict = {}
    count = dev._count_launch

    def counted(kernel, lanes):
        widths.setdefault(getattr(kernel, "__name__", repr(kernel)),
                          []).append(int(lanes))
        count(kernel, lanes)
    dev._count_launch = counted
    return widths


def ring_inputs(S: int, T: int, d: int):
    """13a/13b's q, k, v: (S*T, d) float32 from numpy, seeded."""
    rng = np.random.default_rng([SEED, 13, 1])
    return [rng.standard_normal((S * T, d), dtype=np.float32)
            for _ in range(3)]


def ring_run(ctx, dev_t, dims, nodes: int, rank: int, label: str) -> dict:
    """13a/13b on this rank: the ring attention taskpool with its ATT and
    FIN chores on a CudaDevice; the owned O shards held to float64
    attention on the card at the reference test's 2e-4 / 2e-5.  Returns
    the wall, the device's tasks, the chores' launches and widths, the
    wire counters and the error."""
    import torch

    from parsec_tpu_torch.algos.ring_attention import (build_ring_attention,
                                                       make_collections)
    from parsec_tpu_torch.device import CudaDevice
    S, T, d = dims["ring"][0], dims["ring"][1], dims["ring"][2]
    if nodes > 1:
        S, T = dims["ring2"]
    q, k, v = ring_inputs(S, T, d)
    dev = CudaDevice(ctx, device=dev_t)
    widths = _launch_widths(dev)
    Qc, KVc, ACCc, Oc = make_collections(S, T, d, nodes, rank, q, k, v)
    tp = build_ring_attention(ctx, Qc, KVc, ACCc, Oc, dev=dev)
    s0 = ctx.comm_stats() if nodes > 1 else None
    sync(dev_t)
    t = time.perf_counter()
    tp.run()
    tp.wait()
    if nodes > 1:
        ctx.comm_fence()
    dev.flush()
    sync(dev_t)
    wall = (time.perf_counter() - t) * 1e3
    st = dict(dev.stats)
    launches = {n: v_[0] for n, v_ in dev.launches.items()}
    dev.stop()
    owned = [m for m in range(S) if Oc.rank_of(m, 0) == rank]
    if st["tasks"] != len(owned) * (S + 1):
        raise AssertionError(f"{label}: {st['tasks']} device tasks, "
                             f"expected {len(owned) * (S + 1)} "
                             "(every ATT and FIN of the owned shards)")
    if st["dp_errors"]:
        raise AssertionError(f"{label}: dp_errors {st['dp_errors']}")
    out = {"label": label, "wall_ms": wall, "tasks": st["tasks"],
           "launches": launches, "widths": widths,
           "h2d_bytes": st["h2d_bytes"], "d2h_bytes": st["d2h_bytes"]}
    if nodes > 1:
        s1, rdv = ctx.comm_stats(), ctx.comm_rdv_stats()
        if rdv["registered_bytes"]:
            raise AssertionError(f"{label}: registered_bytes after the "
                                 f"fence: {rdv}")
        out.update(bytes_sent=s1["bytes_sent"] - s0["bytes_sent"],
                   dp_sends=st["dp_sends"],
                   dp_recv_bytes=st["dp_recv_bytes"])
        # a K/V block above the eager limit is device-resident: it must
        # ride the data plane, served from and delivered to the devices
        # (between colocated ranks, cloned on the consumer's device)
        if KVc.mb * KVc.nb * 4 > (64 << 10) and not (
                st["dp_sends"] and (st["dp_recv_bytes"] or
                                    st["dp_d2d_bytes"])):
            raise AssertionError(f"{label}: the K/V hops missed the data "
                                 f"plane: {st}")
    # float64 attention on the card, one shard's queries at a time
    kk = torch.from_numpy(k).to(dev_t, torch.float64)
    vv = torch.from_numpy(v).to(dev_t, torch.float64)
    got, want = [], []
    for m in owned:
        qq = torch.from_numpy(q[m * T:(m + 1) * T]).to(dev_t, torch.float64)
        want.append(torch.softmax(qq @ kk.T / float(np.sqrt(d)), -1) @ vv)
        got.append(torch.from_numpy(Oc.tile(m, 0)).to(dev_t))
    out["max_abs_err"] = check_close(
        f"{label} O ({len(owned)} shards of {T}x{d}) vs float64 attention",
        torch.cat(got), torch.cat(want).float(), 2e-4, 2e-5)
    del kk, vv, got, want
    return out


def moe_tokens(S: int, T: int, d: int, E: int):
    """13c/13d's tokens x (S*T, d) and gate weights wg (d, E), float32
    from numpy, seeded: wg scaled by 1/sqrt(d) (unit-variance logits),
    x drawn N(0.5, 1), whose shared component skews the untrained
    router's loads as an unbalanced router's are (13c: the busiest
    expert takes about twice the mean; with iid N(0, 1) tokens the loads
    stay within 8% of it and a capacity factor of 1.25 drops nothing)."""
    rng = np.random.default_rng([SEED, 13, 100 + S])
    x = rng.standard_normal((S * T, d), dtype=np.float32)
    x += np.float32(0.5)
    wg = rng.standard_normal((d, E), dtype=np.float32)
    wg *= np.float32(d ** -0.5)
    return x, wg


def moe_expert_into(e: int, wu: np.ndarray, wd: np.ndarray) -> None:
    """Expert e's weights drawn by numpy into wu (d, f) and wd (f, d):
    uniform with variance 1/d and 1/f, from a per-expert seed (any rank
    draws any expert alone, the same bytes)."""
    rng = np.random.default_rng([SEED, 13, 200 + e])
    for w, fan in ((wu, wu.shape[0]), (wd, wd.shape[0])):
        rng.random(out=w, dtype=np.float32)
        w -= np.float32(0.5)
        w *= np.float32(2.0 * np.sqrt(3.0 / fan))


def moe_experts(es, d: int, f: int, threads: int) -> dict:
    """{e: (wu, wd)} for experts `es`, drawn on host threads."""
    from concurrent.futures import ThreadPoolExecutor

    def one(e):
        wu = np.empty((d, f), np.float32)
        wd = np.empty((f, d), np.float32)
        moe_expert_into(e, wu, wd)
        return e, (wu, wd)
    with ThreadPoolExecutor(threads) as ex:
        return dict(ex.map(one, es))


def moe_oracle64(x, wg, k: int, T: int, shards, experts, dev_t):
    """Y of the given token shards in float64 on the card: the taskpool's
    own routing (algos.moe._topk_gate per shard, as GATE computes it),
    then every routed expert's relu FFN in float64, no capacity limit."""
    import torch

    from parsec_tpu_torch.algos.moe import _topk_gate
    xs = np.concatenate([x[s * T:(s + 1) * T] for s in shards])
    gates = [_topk_gate(x[s * T:(s + 1) * T], wg, k) for s in shards]
    idx = np.concatenate([g[0] for g in gates])
    vals = np.concatenate([g[1] for g in gates])
    X = torch.from_numpy(xs).to(dev_t, torch.float64)
    Y = torch.zeros_like(X)
    for e, (wu, wd) in sorted(experts.items()):
        rows, slots = np.nonzero(idx == e)
        if not len(rows):
            continue
        wu64 = torch.from_numpy(wu).to(dev_t).double()
        wd64 = torch.from_numpy(wd).to(dev_t).double()
        r_t = torch.from_numpy(rows).to(dev_t)
        p = torch.from_numpy(vals[rows, slots]).to(dev_t, torch.float64)
        Y.index_add_(0, r_t, p[:, None] * (torch.relu(X[r_t] @ wu64)
                                          @ wd64))
        del wu64, wd64
    return Y


def moe_run(dev_t, dims, nodes: int, rank: int, port, label: str,
            S: int, T: int, x, wg, experts: dict, capacity=None,
            combine: str = "chain", check=None) -> dict:
    """One MoE taskpool run (13c/13d) in a fresh Context on this rank:
    EXP on a CudaDevice, its owned expert tiles filled from `experts`.
    Returns (the run's record: wall, device tasks, h2d bytes, EXP
    launches and their widths, the card's peak, the wire counters; the
    owned Y rows, float32 numpy).  `check` is held against the owned Y
    on the card."""
    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch.algos.moe import build_moe, make_moe_collections
    from parsec_tpu_torch.device import CudaDevice
    _, _, d, f, E, k = dims["moe"]
    ctx = pt.Context(nb_workers=4)
    if nodes > 1:
        ctx.set_rank(rank, nodes)
        ctx.comm_init(port)
    try:
        Xc, Yc, WGc, WUc, WDc = make_moe_collections(
            S, T, d, f, E, nodes=nodes, myrank=rank, x=x, w_gate=wg)
        mine = [e for e in range(E) if WUc.rank_of(e, 0) == rank]
        for e in mine:
            wu, wd = experts[e]
            WUc.tile(e, 0)[...] = wu
            WDc.tile(e, 0)[...] = wd
        dev = CudaDevice(ctx, device=dev_t, cache_bytes=dims["cache_bytes"])
        widths = _launch_widths(dev)
        tp = build_moe(ctx, Xc, Yc, WGc, WUc, WDc, E, k=k,
                       capacity=capacity, dev=dev, combine=combine)
        s0 = ctx.comm_stats() if nodes > 1 else None
        sync(dev_t)
        if dev_t.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev_t)
        t = time.perf_counter()
        tp.run()
        tp.wait()
        if nodes > 1:
            ctx.comm_fence()
        dev.flush()
        sync(dev_t)
        wall = (time.perf_counter() - t) * 1e3
        st = dict(dev.stats)
        launches = {n: v_[0] for n, v_ in dev.launches.items()}
        peak = torch.cuda.max_memory_allocated(dev_t) \
            if dev_t.type == "cuda" else None
        dev.stop()
        shards = [s for s in range(S) if Xc.rank_of(s, 0) == rank]
        y = np.concatenate([Yc.tile(s, 0) for s in shards])
        out = {"label": label, "wall_ms": wall, "tasks": st["tasks"],
               "h2d_bytes": st["h2d_bytes"], "d2h_bytes": st["d2h_bytes"],
               "weight_bytes": sum(experts[e][0].nbytes +
                                   experts[e][1].nbytes for e in mine),
               "launches": launches, "widths": widths,
               "eager_gathers": st["eager_gathers"],
               "prefetch": {k_: st[k_] for k_ in (
                   "prefetch_staged", "prefetch_bytes", "prefetch_hits",
                   "prefetch_wasted")},
               "d2d_bytes": st["d2d_bytes"],
               "cache_peak_bytes": st["cache_peak_bytes"],
               "card_peak_bytes": peak, "shards": shards}
        if st["tasks"] != len(mine) * S:
            raise AssertionError(f"{label}: {st['tasks']} device tasks, "
                                 f"expected {len(mine) * S} (every EXP "
                                 "of the owned experts)")
        if st["dp_errors"]:
            raise AssertionError(f"{label}: dp_errors {st['dp_errors']}")
        if nodes > 1:
            s1, rdv = ctx.comm_stats(), ctx.comm_rdv_stats()
            out["bytes_sent"] = s1["bytes_sent"] - s0["bytes_sent"]
            out["coll_stats"] = ctx.coll_stats()
            if combine == "coll" and out["coll_stats"]["steps"] <= 0:
                raise AssertionError(f"{label}: no coll step "
                                     f"{out['coll_stats']}")
            if rdv["registered_bytes"]:
                raise AssertionError(f"{label}: registered_bytes after "
                                     f"the fence: {rdv}")
            ctx.comm_fini()
        if check is not None:
            out["max_abs_err"] = check(y)
        return out, y
    finally:
        ctx.destroy()


def moe_check(label: str, dev_t, want64):
    """A check callable for moe_run: Y against the float64 oracle rows on
    the card at the reference's device tolerance, 3e-4 / 3e-4."""
    import torch

    def check(y):
        return check_close(f"{label} Y vs the float64 oracle",
                           torch.from_numpy(y).to(dev_t), want64.float(),
                           3e-4, 3e-4)
    return check


def multi_rank(rank: int, nodes: int, port: int, dev_t, dims) -> dict:
    """13b and 13d on one of phase 12's spawned ranks, in Contexts of
    their own: ring attention with its chores on two ranks (the K/V hops
    through the data plane), then MoE at 13c's widths with
    combine="chain" and "coll"."""
    import parsec_tpu_torch as pt
    t0 = time.perf_counter()
    res = {}
    ctx = pt.Context(nb_workers=4)
    ctx.set_rank(rank, nodes)
    ctx.comm_init(port)
    res["ring"] = ring_run(ctx, dev_t, dims, nodes, rank,
                           f"13b ring attention rank {rank}")
    ctx.comm_fini()
    ctx.destroy()
    S, T = dims["moe2"]
    _, _, d, f, E, k = dims["moe"]
    x, wg = moe_tokens(S, T, d, E)
    experts = moe_experts(range(E), d, f, dims["threads"] // nodes)
    shards = [s for s in range(S) if s % nodes == rank]
    want = moe_oracle64(x, wg, k, T, shards, experts, dev_t)
    res["moe"] = []
    for i, combine in enumerate(("chain", "coll")):
        lb = f"13d MoE combine={combine} rank {rank}"
        r_, _ = moe_run(dev_t, dims, nodes, rank, port + 4 * (i + 1), lb,
                        S, T, x, wg, experts, combine=combine,
                        check=moe_check(lb, dev_t, want))
        res["moe"].append(r_)
    res["wall_s"] = time.perf_counter() - t0
    return res


def _k_att_plain(q, kv, acc):
    """k_att's plain version: the reference's step, one lane at a time."""
    import torch
    outs = []
    for i in range(q.shape[0]):
        T, d = q.shape[1], q.shape[2]
        k, v = kv[i, :T], kv[i, T:]
        o, m, l = acc[i, :, :d], acc[i, :, d:d + 1], acc[i, :, d + 1:]
        s = (q[i] @ k.T) / float(np.sqrt(d))
        m_new = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        outs.append(torch.cat([alpha * o + p @ v, m_new,
                               alpha * l + p.sum(-1, keepdim=True)], 1))
    return q, kv, torch.stack(outs)


def _k_fin_plain(acc):
    import torch
    d = acc.shape[-1] - 2
    return torch.stack([a[:, :d] / a[:, d + 1:] for a in acc])


def _k_exp_plain(dtile, wu, wd):
    """_k_exp_relu's plain version: one lane at a time."""
    import torch
    d = wu.shape[1]
    return torch.stack([torch.cat([torch.relu(D[:, :d] @ u) @ w, D[:, d:]],
                                  1) for D, u, w in zip(dtile, wu, wd)])


def time_multi_chores(dev_t, dims, runs) -> list:
    """13f: each chore of the phase at its path's shape and mean lanes a
    launch, CUDA events, beside its plain version (one lane at a time)
    and its bound (operations at the float32 non-tensor peak, TF32 off,
    or bytes, whichever is larger); its launches are those of 13a-13d."""
    import torch

    from parsec_tpu_torch.algos.moe import _k_exp_relu
    from parsec_tpu_torch.algos.ring_attention import k_att, k_fin
    bw, f32_peak, _ = card_peaks(torch.cuda.get_device_name(dev_t))[1] \
        if dev_t.type == "cuda" else (1.0, 1.0, 1.0)
    S, T, dr = dims["ring"]
    C, d, f = dims["moe"][1], dims["moe"][2], dims["moe"][3]
    gen = torch.Generator(device=dev_t).manual_seed(SEED + 13)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev_t)

    def totals(name):
        calls = [w for r in runs for w in r["widths"].get(name, [])]
        return len(calls), sum(calls)

    def path_lanes(name):
        """The most frequent width of the chore's launches on the one-rank
        runs (13a, 13c uncapped), the wider on a tie: the main path's
        shape."""
        ws = [w for r in runs[:2] for w in r["widths"].get(name, [])]
        return max(set(ws), key=lambda w: (ws.count(w), w)) if ws else 1

    rows = []
    for name, fn, plain, repl in (
            ("k_att", k_att, _k_att_plain,
             "parsec_tpu/algos/ring_attention.py:47"),
            ("k_fin", k_fin, _k_fin_plain,
             "parsec_tpu/algos/ring_attention.py:61"),
            ("_k_exp_relu", _k_exp_relu, _k_exp_plain,
             "parsec_tpu/algos/moe.py:53")):
        n_calls, n_lanes = totals(name)
        lanes = path_lanes(name)
        if name == "k_att":
            acc = torch.cat([rnd(lanes, T, dr), rnd(lanes, T, 1),
                             rnd(lanes, T, 1).abs() + 1], -1)
            ins = (rnd(lanes, T, dr), rnd(lanes, 2 * T, dr), acc)
            flops = lanes * (4 * T * T * dr + 6 * T * T)
        elif name == "k_fin":
            ins = (torch.cat([rnd(lanes, T, dr + 1),
                              rnd(lanes, T, 1).abs() + 1], -1),)
            flops = lanes * T * dr
        else:
            Dt = rnd(lanes, C, d + 2)
            ins = (Dt, rnd(lanes, d, f) * d ** -0.5,
                   rnd(lanes, f, d) * f ** -0.5)
            flops = lanes * (4 * C * d * f + C * f)
        outs = fn(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        want = plain(*ins)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((a - b).abs().max()) for a, b in zip(outs, want))
        nbytes = sum(t.nbytes for t in ins) + sum(o.nbytes for o in outs)
        iters = 10 if flops < 1e11 else 3
        row = {"name": name, "replaces": repl, "lanes_timed": lanes,
               "launches": n_calls, "lanes": n_lanes,
               "ms": timed_ms(dev_t, lambda: fn(*ins), iters, 1),
               "plain_ms": timed_ms(dev_t, lambda: plain(*ins), iters, 1),
               "bound_ms": max(nbytes / bw, flops / f32_peak) * 1e3,
               "bound_by": "bytes" if nbytes / bw >= flops / f32_peak
               else "operations", "max_abs_err_vs_plain": err}
        rows.append(row)
        log(f"  13f {name} [{lanes} lanes]: {row['ms']:.4f} ms a launch, "
            f"plain (lane by lane) {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"max |chore - plain| {err:.3e}; {n_calls} launches "
            f"({n_lanes} lanes) on the path")
        del ins, outs, want
    if dev_t.type == "cuda":
        torch.cuda.empty_cache()
    return rows


def tp_serve(dev_t, dims) -> dict:
    """13e: tensor-parallel serving, two colocated Contexts in this
    process as threads (one CudaDevice each, both on this card), at
    Llama-2-7B attention widths with the quantized head (qlog): the
    prompts served to `serve_new` tokens each, then the same prompts
    with spec_k=2.  Every rank's tokens and reduced pre-logits are the
    same bits; both rounds are held bit for bit against a tp=1 engine on
    the card (its pre-logits from its attention outputs); conformance
    covers every pool; the request timelines of the merged trace carry
    a nonzero coll_wait stage.  Launches are counted per device."""
    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch.comm.launch import free_port_base
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.profiling import Trace, take_trace
    from parsec_tpu_torch.serve import (InferenceEngine, PagedLM,
                                        PagedLMConfig)
    cfg = PagedLMConfig(**dims["serve_model"], qlog=True)
    model = PagedLM(cfg, device=dev_t)
    rng = np.random.default_rng([SEED, 13, 300])
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in dims["serve_prompts"]]
    new = dims["serve_new"]
    timeout = dims["timeout"]

    def serve(ctx, dev, tp, spec_k, name):
        eng = InferenceEngine(ctx, model, n_pages=dims["serve_pages"],
                              max_seqs=len(prompts), dev=dev, tp=tp,
                              spec_k=spec_k, name=name)
        t0 = time.monotonic()
        hs = []
        for p in prompts:
            h = eng.submit(p, new)
            while h.state == "submitted":
                if time.monotonic() - t0 > timeout:
                    raise TimeoutError(f"13e {name}: prefill stuck")
                time.sleep(0.001)
            hs.append(h)
        while eng.pending() or eng._inflight:
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(f"13e {name}: decode stuck")
            eng.step()
        sync(dev_t)
        wall = time.monotonic() - t0
        st, tps = dict(eng.stats), eng._tp_stats()
        eng.close()
        if any(h.state != "done" for h in hs):
            raise AssertionError(f"13e {name}: states "
                                 f"{[h.state for h in hs]}")
        return {"tokens": [list(h.tokens) for h in hs],
                "outputs": [np.stack(h.outputs) for h in hs],
                "rids": [h.rid for h in hs], "wall_s": wall,
                "stats": st, "tp": tps}

    nodes, port = 2, free_port_base(4)
    results, shared, fails = {}, {}, []
    barrier = threading.Barrier(nodes)

    def timelines():
        tr = Trace.merge([shared[r][0] for r in range(nodes)])
        reg = shared[0][1].scope_registry()
        hops = wait = 0
        for rid in shared[0][2]:
            tl = reg.request_timeline(tr, rid)
            if tl["stages_sum_ns"] != tl["e2e_ns"]:
                raise AssertionError(f"13e rid {rid}: stages do not sum "
                                     f"to e2e: {tl}")
            hops += sum(1 for h in tl["wire_hops"] if h["coll"])
            wait += tl["stages"]["coll_wait_ns"]
        return {"coll_hops": hops, "coll_wait_ns": wait}

    def rank_main(rank):
        import traceback
        try:
            ctx = pt.Context(nb_workers=2)
            ctx.set_rank(rank, nodes)
            ctx.comm_init(port)
            ctx.comm_set_colocated([r for r in range(nodes) if r != rank])
            if dev_t.type == "cuda":
                torch.cuda.set_device(dev_t)
            with ctx:
                # traced at level 2: the request timelines read the wire
                # hops of the trace
                ctx.profile_enable(2)
                dev = CudaDevice(ctx, device=dev_t)
                out = {"plain": serve(ctx, dev, nodes, 0, "tp"),
                       "spec": serve(ctx, dev, nodes, 2, "tps")}
                out["coverage"] = \
                    ctx.stats()["scope"]["conformance"]["coverage"]
                out["launches"] = {n: list(v_) for n, v_ in
                                   dev.launches.items()}
                out["device"] = {k_: dev.stats[k_] for k_ in
                                 ("tasks", "batches", "h2d_bytes",
                                  "dp_errors")}
                dev.stop()
                shared[rank] = (take_trace(ctx), ctx,
                                out["plain"]["rids"] + out["spec"]["rids"])
                barrier.wait(timeout=timeout)
                if rank == 0:
                    try:
                        out["timeline"] = timelines()
                    except Exception:
                        fails.append(traceback.format_exc())
                barrier.wait(timeout=timeout)
                ctx.comm_fence()
                ctx.comm_fini()
            results[rank] = ("ok", out)
        except Exception:
            results[rank] = ("err", traceback.format_exc())
            barrier.abort()

    t = time.perf_counter()
    threads = [threading.Thread(target=rank_main, args=(r,), daemon=True)
               for r in range(nodes)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout)
    tp_s = time.perf_counter() - t
    bad = [str(results.get(r, ("err", f"rank {r} did not finish"))[1])
           for r in range(nodes) if results.get(r, ("err",))[0] != "ok"]
    if bad or fails:
        raise AssertionError("13e: " + "\n".join(bad + fails))
    r0, r1 = results[0][1], results[1][1]
    # the tp=1 engine on the card, the same rounds
    t = time.perf_counter()
    with pt.Context(nb_workers=2) as ctx:
        dev = CudaDevice(ctx, device=dev_t)
        one = {"plain": serve(ctx, dev, 1, 0, "one"),
               "spec": serve(ctx, dev, 1, 2, "ones")}
        one_launches = {n: list(v_) for n, v_ in dev.launches.items()}
        dev.stop()
    one_s = time.perf_counter() - t
    out = {"tp_s": tp_s, "one_s": one_s, "coverage": [r0["coverage"],
                                                      r1["coverage"]],
           "timeline": r0["timeline"],
           "launches": [r0["launches"], r1["launches"], one_launches],
           "device": [r0["device"], r1["device"]]}
    for rnd in ("plain", "spec"):
        a, b, o = r0[rnd], r1[rnd], one[rnd]
        if a["tokens"] != b["tokens"]:
            raise AssertionError(f"13e {rnd}: the ranks' tokens differ")
        for x_, y_ in zip(a["outputs"], b["outputs"]):
            if x_.tobytes() != y_.tobytes():
                raise AssertionError(f"13e {rnd}: the ranks' pre-logits "
                                     "differ")
        pre1 = [np.stack([model.pre_logits(row) for row in outs])
                for outs in o["outputs"]]
        diff = [int((x_ != y_).sum()) for x_, y_ in zip(a["outputs"], pre1)]
        out[rnd] = {"wall_s": [a["wall_s"], b["wall_s"], o["wall_s"]],
                    "generated": sum(len(t_) - len(p) for t_, p in
                                     zip(a["tokens"], prompts)),
                    "tokens_equal_tp1": a["tokens"] == o["tokens"],
                    "prelogit_elems_differing": diff,
                    "stats": [a["stats"], o["stats"]], "tp": a["tp"]}
        log(f"  13e {rnd}: tp=2 walls {a['wall_s']:.2f} / "
            f"{b['wall_s']:.2f} s, tp=1 {o['wall_s']:.2f} s; tokens "
            f"{'equal' if a['tokens'] == o['tokens'] else 'DIFFER'} to "
            f"tp=1; pre-logit elements differing from tp=1 per request "
            f"{diff}; coll pools {a['tp']['coll_pools']}, coll wait "
            f"{a['tp']['coll_wait_ns'] / 1e6:.1f} ms; spec accepted "
            f"{a['stats']['spec_accepted']} of "
            f"{a['stats']['spec_proposed']}")
        if any(diff):
            log(f"  13e {rnd}: fold launches (count, lanes) per device: "
                f"rank 0 {r0['launches']}, rank 1 {r1['launches']}, tp=1 "
                f"{one_launches}")
            raise AssertionError(f"13e {rnd}: tp=2 pre-logits differ from "
                                 f"tp=1 in {diff} elements")
        if a["tokens"] != o["tokens"]:
            raise AssertionError(f"13e {rnd}: tp=2 tokens differ from tp=1")
    if r0["plain"]["tokens"] != r0["spec"]["tokens"]:
        raise AssertionError("13e: the spec round's tokens differ from the "
                             "plain round's")
    if min(out["coverage"]) != 1.0:
        raise AssertionError(f"13e: conformance coverage {out['coverage']}")
    if out["timeline"]["coll_wait_ns"] <= 0 or \
            out["timeline"]["coll_hops"] <= 0:
        raise AssertionError(f"13e: no coll_wait in the request timelines "
                             f"{out['timeline']}")
    if any(d_["dp_errors"] for d_ in out["device"]):
        raise AssertionError(f"13e: dp_errors {out['device']}")
    log(f"  13e: conformance coverage {out['coverage']}; merged trace "
        f"{out['timeline']['coll_hops']} ptc_coll hops, coll_wait "
        f"{out['timeline']['coll_wait_ns'] / 1e6:.1f} ms over the "
        f"requests; chore launches (count, lanes) rank 0 {r0['launches']}, "
        f"rank 1 {r1['launches']}, tp=1 {one_launches}; tp=2 {tp_s:.1f} s, "
        f"tp=1 {one_s:.1f} s")
    del model
    return out


def multi_path(dev_t, dims=None, ranks=None) -> dict:
    """Phase 13: the multi-rank taskpools and tensor-parallel serving on
    the card, float32 with TF32 off, numpy-made inputs from SEED.
      13a ring attention on one rank: S x T tokens, head dim d, every
          ATT and FIN a device chore, O against float64 attention on the
          card (one head: the taskpool has no head axis)
      13b 13a's size on two ranks (run by phase 12's spawned ranks,
          multi_rank): the K/V hops through the device data plane
      13c MoE on one rank at Mixtral-8x7B's FFN widths, EXP on the card,
          combine="chain" uncapped and capped; Y against float64
      13d 13c's widths on two ranks (phase 12's ranks), combine="chain"
          and "coll"
      13e tensor-parallel serving, tp=2 against tp=1 (tp_serve)
      13f each chore at its path's shape beside its plain version and
          bound (time_multi_chores)
    `ranks` are the two ranks' multi_rank results.  Returns the runs and
    the chores' rows."""
    import torch

    import parsec_tpu_torch as pt
    dims = dims or MULTI
    runs = {}
    t0 = time.perf_counter()
    with pt.Context(nb_workers=4) as ctx:
        runs["ring"] = ring_run(ctx, dev_t, dims, 1, 0,
                                "13a ring attention")
    r = runs["ring"]
    log(f"  13a ring attention S={dims['ring'][0]} T={dims['ring'][1]} "
        f"d={dims['ring'][2]} (one head): {r['wall_ms']:.1f} ms, "
        f"{r['tasks']} device tasks, launches {r['launches']}, widths "
        f"{r['widths']}, h2d {r['h2d_bytes']} B")
    if ranks:
        runs["ring2"] = [rk["ring"] for rk in ranks]
        for r in runs["ring2"]:
            log(f"  {r['label']}: {r['wall_ms']:.1f} ms, {r['tasks']} "
                f"device tasks, {r['bytes_sent']} B on the wire "
                f"({r['dp_sends']} data-plane sends, "
                f"{r['dp_recv_bytes']} B received by the device), "
                f"launches {r['launches']}")
    S, T, d, f, E, k = dims["moe"]
    t = time.perf_counter()
    experts = moe_experts(range(E), d, f, dims["threads"])
    x, wg = moe_tokens(S, T, d, E)
    gen_s = time.perf_counter() - t
    want = moe_oracle64(x, wg, k, T, range(S), experts, dev_t)
    runs["moe"] = []
    for cap in (None, dims["moe_cap"]):
        lb = f"13c MoE capacity={cap}"
        r, y = moe_run(dev_t, dims, 1, 0, None, lb, S, T, x, wg, experts,
                       capacity=cap,
                       check=moe_check(lb, dev_t, want) if cap is None
                       else None)
        if cap is not None:
            yt = torch.from_numpy(y).to(dev_t)
            if not bool(torch.isfinite(yt).all()):
                raise AssertionError(f"{lb}: non-finite Y")
            dev_ = float((yt - want.float()).abs().max())
            if dev_ <= 3e-4:
                raise AssertionError(f"{lb}: Y equals the uncapped oracle "
                                     "(no token was dropped)")
            r["max_abs_dev_from_oracle"] = dev_
            from parsec_tpu_torch.algos.moe import _topk_gate
            loads = np.stack([np.bincount(
                _topk_gate(x[s_ * T:(s_ + 1) * T], wg, k)[0].ravel(),
                minlength=E) for s_ in range(S)])
            r["loads_max"] = int(loads.max())
            r["dropped_pairs"] = int(np.maximum(loads - cap, 0).sum())
            log(f"  {lb}: expert loads up to {r['loads_max']} a shard, "
                f"{r['dropped_pairs']} of {S * T * k} (token, expert) "
                f"pairs dropped; max |Y - uncapped oracle| {dev_:.3f}")
        runs["moe"].append(r)
        log(f"  {lb}: {r['wall_ms']:.1f} ms, {r['tasks']} device tasks, "
            f"h2d {r['h2d_bytes']} B ({r['weight_bytes']} B of expert "
            f"weights), EXP launches {r['launches']} widths "
            f"{r['widths']}, eager gathers {r['eager_gathers']}, cache "
            f"peak {r['cache_peak_bytes']} B, card peak "
            f"{r['card_peak_bytes']} B")
    del experts, want
    if dev_t.type == "cuda":
        torch.cuda.empty_cache()
    runs["moe_gen_s"] = gen_s
    if ranks:
        runs["moe2"] = [m for rk in ranks for m in rk["moe"]]
        for r in runs["moe2"]:
            log(f"  {r['label']}: {r['wall_ms']:.1f} ms, {r['tasks']} "
                f"device tasks, {r['bytes_sent']} B on the wire (the D "
                f"tiles and the combine), EXP widths {r['widths']}, "
                f"coll_stats steps {r['coll_stats']['steps']}")
        runs["ranks_wall_s"] = [rk["wall_s"] for rk in ranks]
    runs["serve"] = tp_serve(dev_t, dims)
    everything = [runs["ring"], runs["moe"][0]] + runs.get("ring2", []) + \
        runs["moe"][1:] + runs.get("moe2", [])
    chores = time_multi_chores(dev_t, dims, everything)
    runs["phase_s"] = time.perf_counter() - t0
    return {"runs": runs, "chores": chores}


# phase 14 sizes: the fleet at the serving model's widths (phase 5's
# PagedLM, Llama-2-7B attention widths), 8 requests from two tenants over
# two shared 256-token prefixes (16 pages of 16 tokens each) plus a short
# private tail, 8 new tokens each; each replica's page budget, and the
# re-placement round's tight one (one sequence's pages); 14b's frozen
# pages and chunk size; 14e's message size; the fold probe's widths
FLEET = {"model": {"vocab": 32000, "d": 4096, "heads": 32, "page": 16},
         "prefix": 256, "tails": (3, 5, 7, 9), "max_new": 8,
         "n_pages": 320, "tight_pages": 17, "replace_requests": 4,
         "mig_pages": 32, "mig_chunk": 128 << 10, "tune_bytes": 64 << 20,
         "fold_widths": (1, 2, 3, 8, 17, 32, 64, 256, 1024),
         "timeout": 240.0}


def _fleet_prompts(dims, vocab: int):
    """(prompt, tenant) of 14a's requests: request i extends prefix i % 2
    by a private tail; tenant "hi" owns prefix 0, "lo" prefix 1."""
    rng = np.random.default_rng(SEED + 14)
    prefixes = [[int(x) for x in rng.integers(0, vocab, dims["prefix"])]
                for _ in range(2)]
    reqs = []
    for i, tail in enumerate(t for t in dims["tails"] for _ in range(2)):
        reqs.append((prefixes[i % 2] + [int(x) for x in rng.integers(
            0, vocab, tail)], "hi" if i % 2 == 0 else "lo"))
    return reqs


def _mig_page(j: int, page: int, d: int):
    """Frozen page j's k and v of 14b: a pure function of j."""
    rng = np.random.default_rng(SEED + 1400 + j)
    return (rng.standard_normal((page, d), dtype=np.float32),
            rng.standard_normal((page, d), dtype=np.float32))


def _live_rows(ctx, mon) -> dict:
    """One LiveMonitor sample on `ctx` (quiescent: after a fence) with its
    comm, stream and topo rows held to the engine's counters read at that
    moment."""
    # a peer's control frames (its fence, clock sync) may land while
    # sampling: a sample is held to the counters read right before and
    # after it once they agree
    for _ in range(50):
        before = ctx.comm_stats()
        mon._sample()
        rec = mon.latest()
        comm, ss, ts = ctx.comm_stats(), ctx.comm_stream_stats(), \
            ctx.comm_topo_stats()
        if comm == before:
            break
    missing = [k for k in ("comm", "stream", "topo") if k not in rec]
    if missing:
        raise AssertionError(f"14d: live sample lacks {missing}")
    if rec["comm"] != comm:
        raise AssertionError(f"14d: live comm row {rec['comm']} != "
                             f"comm_stats() {comm}")
    if rec["stream"] != {k: ss[k] for k in ("sessions", "parked_gets",
                                            "overlap_fraction")}:
        raise AssertionError(f"14d: live stream row {rec['stream']}")
    sent = sum(v[0] for v in rec["topo"]["classes"].values())
    if sent != sum(r["bytes_sent"] for r in ts["classes"].values()):
        raise AssertionError(f"14d: live topo row {rec['topo']}")
    return {k: rec[k] for k in ("comm", "stream", "topo")}


def fleet_rank(rank: int, nodes: int, port: int, dev_t, dims,
               norm_dims, out_dir: str) -> dict:
    """14b, 14c and 14d on one of phase 12's spawned ranks.
      14b build_page_migration of `mig_pages` frozen pages of the serving
          model's width (page 16, d 4096: 512 KiB of k|v each) rank 0 ->
          rank 1 with comm.eager_limit=0 and comm.chunk_size `mig_chunk`
          (each page streams as chunks), then again with the receiver
          holding half the pages, then holding all of them (no pool is
          built); a Watchdog runs through it, a LiveMonitor samples after
          each, and each rank's Journal checkpoints its pool's frozen
          keys to the other
      14c phase 12b's NORM chain with device.dp_transfer on: the
          intermediate crosses as CUDA IPC tokens
    Returns walls, byte counts, digests, the samples and the peer
    blobs."""
    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch.comm.migrate import (build_page_migration,
                                               wanted_keys)
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.device import cuda as dc
    from parsec_tpu_torch.ops.paged_attention import (PagePool,
                                                      prefix_page_keys)
    from parsec_tpu_torch.profiling.blackbox import Journal
    from parsec_tpu_torch.profiling.live import LiveMonitor
    from parsec_tpu_torch.profiling.metrics import Watchdog
    from parsec_tpu_torch.utils import params as _knobs
    out = {"rank": rank}
    t_all = time.perf_counter()
    page, d = dims["model"]["page"], dims["model"]["d"]
    n = dims["mig_pages"]
    keys = prefix_page_keys("fleet-wire", list(range(n * page)), page)
    saved = {k: os.environ.get(k) for k in (
        "PTC_MCA_comm_eager_limit", "PTC_MCA_comm_chunk_size")}
    os.environ["PTC_MCA_comm_eager_limit"] = "0"
    os.environ["PTC_MCA_comm_chunk_size"] = str(dims["mig_chunk"])
    ctx = pt.Context(nb_workers=4)
    try:
        ctx.set_rank(rank, nodes)
        ctx.comm_init(port)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    dev = CudaDevice(ctx, device=dev_t)
    wd = Watchdog(ctx, interval=0.05)
    mon = LiveMonitor(ctx, path=os.path.join(
        out_dir, "phase14_live_{rank}.jsonl"), interval=3600.0)
    jdir = os.path.join(out_dir, "phase14_journal")
    jr = Journal(ctx, dirpath=jdir, checkpoint_s=0, fsync_s=0.5)
    runs = []
    pools = []
    for i, held in enumerate((0, n // 2, n)):
        pool = PagePool(ctx, n + 2, page, d, name=f"MIG{i}")
        pools.append(pool)
        if rank == 0:
            for j, key in enumerate(keys):
                _author_frozen(pool, key, *_mig_page(j, page, d))
        else:
            for j in range(held):
                _author_frozen(pool, keys[j], *_mig_page(j, page, d))
        wanted = list(range(held, n))
        if rank == 1 and wanted_keys(pool, keys) != [keys[j]
                                                     for j in wanted]:
            raise AssertionError("14b: the receiver's dedup decision "
                                 "differs from the plan")
        s0 = ctx.comm_stats()
        m0 = pool.stats()["migrated_in_bytes"]
        t0 = ctx.comm_tuning()
        sync(dev_t)
        t = time.perf_counter()
        tp = build_page_migration(pt, ctx, keys, wanted, src_pool=pool,
                                  dst_pool=pool, src_rank=0, dst_rank=1,
                                  page=page, d=d, coll_name=f"MIGC{i}")
        if tp is not None:
            tp.run()
            tp.wait()
        ctx.comm_fence()
        wall = (time.perf_counter() - t) * 1e3
        s1 = ctx.comm_stats()
        t1 = ctx.comm_tuning()
        row = {"held": held, "wanted": len(wanted), "built": tp is not None,
               "wall_ms": wall,
               "payload_bytes": pool.stats()["migrated_in_bytes"] - m0,
               "bytes_recv": s1["bytes_recv"] - s0["bytes_recv"],
               "bytes_sent": s1["bytes_sent"] - s0["bytes_sent"],
               "chunks_recv": t1["chunks_recv"] - t0["chunks_recv"],
               "exported": pool.stats()["exported"],
               "imported": pool.stats()["imported"]}
        if rank == 1:
            if pool.probe(keys) != n:
                raise AssertionError(f"14b run {i}: receiver holds "
                                     f"{pool.probe(keys)} of {n} keys")
            row["digest"] = _digest(np.stack([np.concatenate(
                [pool.k_tile(pool._index[k]), pool.v_tile(pool._index[k])])
                for k in keys]))
        else:
            row["digest"] = _digest(np.stack([np.concatenate(
                pool.export_frozen(k)) for k in keys]))
        row["live"] = _live_rows(ctx, mon)
        if tp is not None:
            tp.destroy()
        runs.append(row)
    out["migrate"] = runs
    wd.stop()
    out["watchdog"] = wd.status()
    out["stalled_pull"] = [e for e in wd.events
                           if e["type"] == "stalled_pull"]
    # the journal's checkpoint, replicated to the other rank
    jr.register_inventory("frozen_page_keys", pools[0].frozen_keys)
    jr.checkpoint()
    ctx.comm_fence()
    other = 1 - rank
    blob, deadline = None, time.monotonic() + 10.0
    while time.monotonic() < deadline:
        blob = jr.peer_blob(other)
        if blob is not None:
            break
        time.sleep(0.05)
    out["peer_blob_keys"] = sorted((blob or {}).get("inventory", {})
                                   .get("frozen_page_keys") or [])
    out["own_keys"] = sorted(pools[0].frozen_keys())
    out["lost_peers"] = sorted(jr.lost_peers())
    out["migrate_s"] = time.perf_counter() - t_all
    jr.stop()
    mon.stop()
    dev.stop()
    if dev.stats["dp_errors"]:
        raise AssertionError(f"14b rank {rank}: dp_errors "
                             f"{dev.stats['dp_errors']}")
    out["dp_errors"] = dev.stats["dp_errors"]
    ctx.comm_fini()
    ctx.destroy()

    # 14c: phase 12b's NORM chain through the transfer plane
    t = time.perf_counter()
    ctx = pt.Context(nb_workers=4)
    ctx.set_rank(rank, nodes)
    ctx.comm_init(port + 4)
    mon = LiveMonitor(ctx, path=os.path.join(
        out_dir, "phase14_live_{rank}.jsonl"), interval=3600.0)
    _knobs.set("device.dp_transfer", True)
    try:
        # (on the CPU, a rehearsal, no token is served: bytes move)
        out["xfer"] = comm_norm_chain(
            ctx, rank, nodes, dev_t, norm_dims, "NORM transfer plane",
            lambda c: CudaDevice(c, device=dev_t), tag="x",
            xfer=dev_t.type == "cuda")
    finally:
        _knobs.unset("device.dp_transfer")
    out["xfer"]["pool"] = dc._xfer_sessions().stats()
    out["xfer"]["live"] = _live_rows(ctx, mon)
    mon.stop()
    ctx.comm_fini()
    ctx.destroy()
    out["xfer_s"] = time.perf_counter() - t
    out["wall_s"] = time.perf_counter() - t_all
    return out


def _author_frozen(pool, key, k, v) -> None:
    """Freeze one page of `pool` under `key` holding k and v."""
    p = pool.alloc()
    pool.k_tile(p)[...] = k
    pool.v_tile(p)[...] = v
    pool.host_wrote(p)
    if not pool.freeze(p, key):
        raise AssertionError(f"14b: key {key} frozen twice")
    pool.release([p])


def _fold_einsum(qb, kb, vb, ab, scale, nh):
    """ops.paged_attention.fold_heads as it was before its products became
    elementwise sums: batched einsum products, whose algorithm cuBLAS
    picks by the batch count.  Kept for 14a's width probe."""
    import torch
    n, P, dl = kb.shape
    dh = dl // nh
    q = qb.reshape(n, nh, dh)
    K = kb.reshape(n, P, nh, dh)
    V = vb.reshape(n, P, nh, dh)
    a = ab.reshape(n, dl + 2 * nh)
    acc = a[:, :dl].reshape(n, nh, dh)
    m = a[:, dl:dl + nh]
    l_ = a[:, dl + nh:]
    s_ = torch.einsum("nphd,nhd->nhp", K, q) * scale
    m_new = torch.maximum(m, s_.amax(-1))
    p_ = torch.exp(s_ - m_new.unsqueeze(-1))
    corr = torch.exp(m - m_new)
    l_new = l_ * corr + p_.sum(-1)
    acc_new = acc * corr.unsqueeze(-1) + torch.einsum("nhp,nphd->nhd", p_,
                                                      V)
    return torch.cat([acc_new.reshape(n, dl), m_new, l_new],
                     dim=1).unsqueeze(1)


def fold_width_probe(dev_t, model, widths) -> dict:
    """The serving fold's lane 0 at `widths` lanes (copies and stride-0
    views) against its 1-lane result, for fold_heads and for the einsum
    form it replaced: a fleet's replicas batch a request's folds in
    other waves than a single replica, so its bits must not depend on
    the width.  fold_heads must agree at every width.  Both forms are
    timed at 1, 8 and 64 lanes in this call (CUDA events on the card):
    the repair's cost."""
    import torch

    from parsec_tpu_torch.ops.paged_attention import fold_heads, reset_acc
    cfg = model.cfg
    H, P, d = cfg.heads, cfg.page, cfg.d
    g = torch.Generator(device=dev_t).manual_seed(SEED + 140)
    q, k, v = (0.5 * torch.randn(1, n_, d, generator=g, device=dev_t)
               for n_ in (1, P, P))
    an = np.zeros((1, 1, d + 2 * H), np.float32)
    reset_acc(an[0], H)
    a = torch.from_numpy(an).to(dev_t)
    out = {}
    for name, fn in (("fold_heads", fold_heads), ("einsum", _fold_einsum)):
        lane0 = {}
        for w in widths:
            for s0 in (False, True):
                st = [t.expand(w, *t.shape[1:]) for t in (q, k, v, a)]
                if not s0:
                    st = [t.contiguous() for t in st]
                lane0[(w, s0)] = fn(*st, model.scale, H)[0].clone()
        ref = lane0[(1, False)]
        same = {f"{w}{' stride0' if s0 else ''}": bool(torch.equal(t, ref))
                for (w, s0), t in lane0.items()}
        out[name] = same
        log(f"  14a probe: {name} lane 0 bit-identical to its 1-lane "
            f"result at {H} heads, page {P}, d {d}: {same}")
        ms = {}
        for w in (1, 8, 64):
            st = [t.expand(w, *t.shape[1:]).contiguous()
                  for t in (q, k, v, a)]
            ms[w] = timed_ms(dev_t, lambda: fn(*st, model.scale, H), 50, 5)
        out[f"{name}_ms"] = ms
        log(f"  14a probe: {name} at 1 / 8 / 64 lanes: "
            + " / ".join(f"{m:.4f}" for m in ms.values()) + " ms a call")
    if not all(out["fold_heads"].values()):
        raise AssertionError("14a: fold_heads' bits depend on the width")
    return out


def fleet_serve(dev_t, model, dims) -> dict:
    """14a: the fleet in this process.  Each round builds fresh replicas:
    a Context(4 workers, lws), a CudaDevice and an InferenceEngine each,
    over the one PagedLM `model`.  Requests arrive in two waves, one
    request per prefix first (cold everywhere), then the rest once their
    prefixes are frozen; so a request's predicted warm pages (the
    router's digest, at submit) must equal what acquire_prefix maps
    (the engine's prefix_hits, at the same synchronous admission).
      single   one replica serves every request (the reference)
      routed   Router over two mixed replicas: predicted == mapped for
               every request; tokens and outputs bit for bit `single`'s
      disagg   prefill_then_decode over a prefill and a decode replica:
               bit for bit `single`'s, migrated_pages > 0, migrated_bytes
               = migrated_pages * the page's k|v bytes
      replace  a request of prefix 0, then `replace_requests` - 1 of
               prefix 1, pinned to a replica holding one sequence's
               pages: the prefix-1 requests queue (no page of theirs is
               warm there, and decode, which would free the pages, runs
               only in the router's loop); the replica's health flips
               (an SLO breach) and the router's pump re-places them:
               rerouted == the server's cancelled, none dropped, tokens
               bit for bit `single`'s
    Returns walls, tokens/s per replica, the migration's GB/s, the
    fleet's live row and the router counters."""
    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.profiling.live import LiveMonitor
    from parsec_tpu_torch.serve import (InferenceEngine, Replica, Router,
                                        RoutePolicy, Server, TenantConfig)
    reqs = _fleet_prompts(dims, model.cfg.vocab)
    n_new = dims["max_new"]
    page_bytes = model.cfg.page * 2 * model.cfg.d * 4
    out = {"rounds": {}}

    def replicas(n, roles=(), pages=None, tenants=None):
        reps = []
        for i in range(n):
            ctx = pt.Context(nb_workers=4, scheduler="lws")
            dev = CudaDevice(ctx, device=dev_t)
            # max_pools above the requests a tenant has in flight: every
            # admission is synchronous, at submit
            tcs = tenants() if tenants else [
                TenantConfig("hi", priority=4, weight=4, max_pools=16),
                TenantConfig("lo", max_pools=16)]
            eng = InferenceEngine(
                ctx, model, n_pages=(pages or {}).get(i, dims["n_pages"]),
                max_seqs=8, dev=dev, server=Server(ctx, tcs, name=f"r{i}"),
                name=f"r{i}")
            reps.append(Replica(eng, role=dict(roles).get(i, "mixed")))
        return reps

    def teardown(router, reps):
        if router is not None:
            router.close()  # closes the engines
        for r in reps:
            if router is None:
                r.engine.close()
            for d_ in list(r.engine.ctx._devices):
                d_.stop()
            r.engine.ctx.destroy()

    def finish(label, hs, reps, t0):
        wall = time.perf_counter() - t0
        for h in hs:
            if h.state != "done" or len(h.generated) != n_new:
                raise AssertionError(f"14a {label}: request ended "
                                     f"{h.state} with {len(h.generated)} "
                                     "tokens")
        per = {r.name: sum(len(h.generated) for h in hs
                           if getattr(h, "replica", reps[0]) is r)
               for r in reps}
        row = {"wall_s": wall,
               "tokens_per_s": sum(len(h.generated) for h in hs) / wall,
               "tokens_per_s_by_replica": {k: v / wall
                                           for k, v in per.items()},
               "tokens": [list(h.generated) for h in hs],
               "outputs": [_digest(np.stack(h.outputs)) for h in hs]}
        out["rounds"][label] = row
        log(f"  14a {label}: {len(hs)} requests, {wall:.2f} s, "
            f"{row['tokens_per_s']:.2f} tokens/s; per replica "
            + ", ".join(f"{k} {v:.2f}" for k, v in
                        row["tokens_per_s_by_replica"].items()))
        return row

    def same_as_single(label, row, idx=None):
        ref = out["rounds"]["single"]
        idx = list(range(len(row["tokens"]))) if idx is None else idx
        ok = all(row["tokens"][k] == ref["tokens"][i] and
                 row["outputs"][k] == ref["outputs"][i]
                 for k, i in enumerate(idx))
        log(f"    check 14a {label} tokens and outputs bit for bit the "
            f"single replica's: {ok}")
        if not ok:
            raise AssertionError(f"14a {label}: differs from the single "
                                 "replica")

    # single: one replica, the two waves
    t0 = time.perf_counter()
    reps = replicas(1)
    eng = reps[0].engine
    try:
        hs = [eng.submit(p, n_new, tn) for p, tn in reqs[:2]]
        eng.run(timeout_s=dims["timeout"])
        hs += [eng.submit(p, n_new, tn) for p, tn in reqs[2:]]
        eng.run(timeout_s=dims["timeout"])
        finish("single", hs, reps, t0)
    finally:
        teardown(None, reps)

    # routed: two mixed replicas, predicted warm == mapped warm
    t0 = time.perf_counter()
    reps = replicas(2)
    router = Router(reps)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase14")
    os.makedirs(out_dir, exist_ok=True)
    mon = LiveMonitor(reps[0].engine.ctx, path=os.path.join(
        out_dir, "fleet_live.jsonl"), interval=3600.0)
    try:
        fhs, preds = [], []
        for wave in (reqs[:2], reqs[2:]):
            for p, tn in wave:
                hits0 = [r.engine.stats["prefix_hits"] for r in reps]
                fh = router.submit(p, n_new, tn)
                if fh.handle.ticket.state == "queued":
                    raise AssertionError("14a routed: admission was not "
                                         "synchronous")
                # the router's decision (scope event) against what the
                # admission mapped: a priced-in migration lands first
                ev = fh.replica.engine.scope.events("route_place")[-1]
                mapped = sum(r.engine.stats["prefix_hits"] - h0
                             for r, h0 in zip(reps, hits0))
                preds.append((ev["warm"] + ev["migrate_pages"], mapped,
                              ev["replica"]))
                fhs.append(fh)
            router.run(timeout_s=dims["timeout"])
        ok = all(p_ == m_ for p_, m_, _ in preds)
        log(f"    check 14a routed: predicted warm pages == pages "
            f"acquire_prefix mapped, every request: {ok} "
            f"{[(p_, m_, r_) for p_, m_, r_ in preds]} (predicted, mapped,"
            " replica)")
        if not ok or sum(m_ for _, m_, _ in preds) == 0:
            raise AssertionError("14a routed: a prediction missed")
        row = finish("routed", fhs, reps, t0)
        row["warm"] = preds
        same_as_single("routed", row)
        mon._sample()
        rec = mon.latest()
        if "fleet" not in rec or rec["fleet"]["router"]["placed"] != \
                len(reqs):
            raise AssertionError(f"14d: the replica's live sample lacks "
                                 f"the fleet row: {sorted(rec)}")
        out["live_fleet"] = rec["fleet"]
        log(f"  14d fleet row on replica r0's live sample: router "
            f"{rec['fleet']['router']}")
        mon.stop()
        out["router_routed"] = dict(router.counters)
    finally:
        teardown(router, reps)

    # disagg: prefill_then_decode, the pages migrated in process
    t0 = time.perf_counter()
    reps = replicas(2, roles=((0, "prefill"), (1, "decode")))
    router = Router(reps)
    try:
        fhs = []
        mig_ms = 0.0
        mig0 = router.migrate

        def timed_migrate(*a, **kw):
            nonlocal mig_ms
            t = time.perf_counter()
            try:
                return mig0(*a, **kw)
            finally:
                mig_ms += (time.perf_counter() - t) * 1e3
        router.migrate = timed_migrate
        for wave in (reqs[:2], reqs[2:]):
            for p, tn in wave:
                fh = router.prefill_then_decode(p, n_new, tn)
                if fh.replica is not reps[1]:
                    raise AssertionError("14a disagg: placed off the "
                                         "decode replica")
                fhs.append(fh)
            router.run(timeout_s=dims["timeout"])
        row = finish("disagg", fhs, reps, t0)
        c = dict(router.counters)
        row["counters"] = c
        row["migrate_ms"] = mig_ms
        row["migrate_gbps"] = (c["migrated_bytes"] / (mig_ms / 1e3) / 1e9
                               if mig_ms else None)
        log(f"  14a disagg: migrated {c['migrated_pages']} pages, "
            f"{c['migrated_bytes']} B in {mig_ms:.1f} ms of migrate() "
            f"({row['migrate_gbps']} GB/s, in process), prefill jobs "
            f"{c['prefill_jobs']}, dedup skips {c['migration_dups']}")
        if c["migrated_pages"] <= 0 or \
                c["migrated_bytes"] != c["migrated_pages"] * page_bytes:
            raise AssertionError(f"14a disagg: counters {c}")
        same_as_single("disagg", row)
    finally:
        teardown(router, reps)

    # replace: queued requests re-placed off a replica whose health flips
    t0 = time.perf_counter()
    nr = dims["replace_requests"]

    def tenants():
        return [TenantConfig("hi", priority=4, weight=4), TenantConfig("lo"),
                TenantConfig("probe", slo_ms=1e-6, slo_burn=0.5)]
    reps = replicas(2, pages={0: dims["tight_pages"]}, tenants=tenants)
    router = Router(reps)
    try:
        busy = {0: {"healthy": True}, 1: {"healthy": True,
                                          "queued_bytes": 1 << 40}}
        idx = [0] + [2 * k + 1 for k in range(nr - 1)]
        fhs = [router.submit(*reqs[i][:1], n_new, reqs[i][1], adverts=busy)
               for i in idx]
        queued = [fh for fh in fhs if fh.handle.ticket.state == "queued"]
        if not queued or any(fh.replica is not reps[0] for fh in fhs):
            raise AssertionError("14a replace: nothing queued on r0")
        sid = reps[0].engine.scope.new_scope("probe")
        reps[0].engine.scope.record_done(sid)
        if reps[0].server.healthy():
            raise AssertionError("14a replace: r0 did not turn unhealthy")
        moved = router._pump()
        router.run(timeout_s=dims["timeout"])
        row = finish("replace", fhs, reps, t0)
        cancelled = reps[0].server.stats()["totals"]["cancelled"]
        c = dict(router.counters)
        row.update({"queued": len(queued), "moved": moved,
                    "cancelled": cancelled, "counters": c})
        ok = c["rerouted"] == cancelled == moved == len(queued) and \
            c["reroute_failed"] == 0
        log(f"    check 14a replace: {len(queued)} queued on r0, "
            f"re-placed {moved}, rerouted {c['rerouted']} == cancelled "
            f"{cancelled}, none dropped: {ok}")
        if not ok:
            raise AssertionError(f"14a replace: {row}")
        same_as_single("replace", row, idx=idx)
    finally:
        teardown(router, reps)
    return out


def fleet_path(dev_t, model=None, dims=None, ranks=None, comm_runs=None,
               norm_dims=None) -> dict:
    """Phase 14: the fleet tier and the rest of the multi-rank half.
      14a fleet_serve (this process)
      14b-14d the ranks' fleet_rank results (run on phase 12's spawned
          ranks): imported pages bit for bit the source's export, payload
          bytes 16 MiB, 8 MiB, then 0 with no pool built, dp_errors 0;
          the transfer plane's NORM chain: dp_xfer_bytes 512 MiB and
          dp_recv_bytes 0 on rank 1, O's digest 12b's byte path's, one
          session per peer established and the rest reused; the live
          samples' comm/stream/topo rows; no stalled_pull; each rank's
          checkpoint read on the other through peer_blob, no lost peer
      14e the tuner's comm axes: propose_stream and propose_collective at
          `tune_bytes`, ranked, beside phase 12d's and 12b's walls
    Returns the runs and the RMSNorm launches of 14c (both ranks)."""
    import torch

    from parsec_tpu_torch.analysis.tune import (propose_collective,
                                                propose_stream)
    from parsec_tpu_torch.serve import PagedLM, PagedLMConfig
    dims = dims or FLEET
    norm_dims = norm_dims or COMM
    t0 = time.perf_counter()
    runs = {}
    if model is None:
        model = PagedLM(PagedLMConfig(seed=SEED, **dims["model"]),
                        device=dev_t)
    runs["fold_probe"] = fold_width_probe(dev_t, model, dims["fold_widths"])
    fs = fleet_serve(dev_t, model, dims)
    runs["serve"] = fs
    launches = {"rms_norm": 0, "flash_attention": 0}
    if ranks is not None:
        r0, r1 = ranks
        n = dims["mig_pages"]
        page_bytes = dims["model"]["page"] * 2 * dims["model"]["d"] * 4
        mig = []
        for i, (a, b) in enumerate(zip(r0["migrate"], r1["migrate"])):
            want = (n - b["held"]) * page_bytes
            row = {"held": b["held"], "wall_ms": [a["wall_ms"],
                                                  b["wall_ms"]],
                   "payload_bytes": b["payload_bytes"],
                   "bytes_recv": b["bytes_recv"],
                   "chunks_recv": b["chunks_recv"], "built": b["built"],
                   "gbps": (b["payload_bytes"] / (b["wall_ms"] / 1e3) / 1e9
                            if b["payload_bytes"] else None),
                   "bit_for_bit": a["digest"] == b["digest"]}
            mig.append(row)
            log(f"  14b migration run {i} (receiver holds {b['held']} of "
                f"{n}): {row['payload_bytes']} B imported, "
                f"{b['bytes_recv']} B received on the wire in "
                f"{b['chunks_recv']} chunks, walls {a['wall_ms']:.1f} / "
                f"{b['wall_ms']:.1f} ms ({row['gbps']} GB/s), pool built "
                f"{b['built']}, imported bit for bit the export "
                f"{row['bit_for_bit']}")
            if not row["bit_for_bit"] or row["payload_bytes"] != want or \
                    b["built"] != (want > 0):
                raise AssertionError(f"14b run {i}: {row}")
            if want and b["chunks_recv"] < (n - b["held"]) * -(
                    -page_bytes // dims["mig_chunk"]):
                raise AssertionError(f"14b run {i}: {b['chunks_recv']} "
                                     "chunks: the pages did not stream")
        runs["migrate"] = mig
        # 14c: the transfer plane against 12b's byte path
        x0, x1 = r0["xfer"], r1["xfer"]
        for name, v in x0["launches"].items():
            launches[name] += v + x1["launches"][name]
        gb = x1["payload_bytes"] / (x1["wall_ms"] / 1e3) / 1e9
        byte_row = comm_runs["norm"][0] if comm_runs else None
        pool = x1["pool"]
        runs["xfer"] = {"wall_ms": [x0["wall_ms"], x1["wall_ms"]],
                        "payload_gbps": gb,
                        "byte_path_gbps": byte_row["payload_gbps"]
                        if byte_row else None,
                        "dev": [x0["dev"], x1["dev"]], "pool": pool,
                        "o_digest": x1["o_digest"],
                        "max_abs_err": x1["max_abs_err"],
                        "launches": [x0["launches"], x1["launches"]],
                        "phase_s": r1["xfer_s"]}
        log(f"  14c NORM through the transfer plane: walls "
            f"{x0['wall_ms']:.1f} / {x1['wall_ms']:.1f} ms, "
            f"{x1['dev']['dp_xfer_bytes']} B pulled card to card "
            f"({x0['dev']['dp_xfer_tokens']} tokens), dp_recv_bytes "
            f"{x1['dev']['dp_recv_bytes']}, {gb:.3f} GB/s of the chain's "
            f"wall against 12b's byte path "
            f"{runs['xfer']['byte_path_gbps']} GB/s in this run; pulls "
            f"{x1['dev']['dp_xfer_pull_ns'] / 1e6:.1f} ms of host; "
            f"session pool {pool}; O {x1['o_digest']}")
        on_card = dev_t.type == "cuda"
        if on_card and (x1["dev"]["dp_xfer_bytes"] != x1["payload_bytes"]
                        or x1["dev"]["dp_recv_bytes"] != 0):
            raise AssertionError(f"14c: {x1['dev']}")
        if byte_row and x1["o_digest"] != byte_row["o_digest"]:
            raise AssertionError("14c: O differs from 12b's byte path")
        rows_, d_, T_ = norm_dims["norm"]
        R = rows_ // T_
        if on_card and (pool["peers"] != 1 or pool["established"] != 1
                        or pool["reused"] != R - 1):
            raise AssertionError(f"14c: session pool {pool}")
        # 14d on the ranks
        for r_ in ranks:
            if r_["stalled_pull"]:
                raise AssertionError(f"14d rank {r_['rank']}: "
                                     f"{r_['stalled_pull']}")
            if r_["lost_peers"]:
                raise AssertionError(f"14d rank {r_['rank']}: lost peers "
                                     f"{r_['lost_peers']}")
        for a, b in ((r0, r1), (r1, r0)):
            if a["peer_blob_keys"] != b["own_keys"] or not b["own_keys"]:
                raise AssertionError(
                    f"14d: rank {a['rank']} read {len(a['peer_blob_keys'])}"
                    f" keys of rank {b['rank']}'s checkpoint, which holds "
                    f"{len(b['own_keys'])}")
        runs["observe"] = {
            "watchdog": [r_["watchdog"] for r_ in ranks],
            "live_migrate": [r_["migrate"][0]["live"] for r_ in ranks],
            "live_xfer": [r_["xfer"]["live"] for r_ in ranks]}
        log(f"  14d live samples on both ranks carry comm/stream/topo rows "
            f"equal to the engine's counters; watchdog ticks "
            f"{[r_['watchdog']['ticks'] for r_ in ranks]}, no "
            f"stalled_pull; each rank read the other's checkpoint "
            f"({len(r0['own_keys'])} frozen keys) through peer_blob; no "
            f"lost peer")
        runs["ranks_s"] = max(r_["wall_s"] for r_ in ranks)
    # 14e: the tuner's comm axes
    nb = dims["tune_bytes"]
    ps = propose_stream(nb)
    pc = propose_collective(nb, 2)
    runs["tune"] = {"stream": ps, "collective": pc}
    for name, props in (("propose_stream", ps),
                        ("propose_collective", pc)):
        for rank_, r_ in enumerate(props):
            log(f"  14e {name}({nb >> 20} MiB) #{rank_}: {r_['knobs']} "
                f"predicted {r_['predicted_ns'] / 1e6:.3f} ms")
    if comm_runs:
        # the model's ranking beside the card's: 12d's all_reduce of the
        # same size under each topology, 12b's streamed 16 MiB tiles
        for r_ in pc:
            w = comm_runs["coll"].get(f"{r_['knobs']['coll.topo']}"
                                      "/all_reduce")
            r_["measured_all_reduce_ms"] = w
            log(f"  14e propose_collective {r_['knobs']}: predicted "
                f"{r_['predicted_ns'] / 1e6:.3f} ms; phase 12d's "
                f"all_reduce under that topology, ranks 0 / 1: "
                + (f"{w[0]:.1f} / {w[1]:.1f} ms" if w else
                   "not measured (12d runs ring, binomial and star)"))
        nr = comm_runs["norm"][0]
        log(f"  14e propose_stream beside phase 12b's streamed NORM chain "
            f"(16 MiB tiles, comm.chunk_size 1 MiB, 2 rails): "
            f"{nr['payload_gbps']:.3f} GB/s of the chain's wall, serve "
            f"copies {nr['serve_d2h_gbps']} GB/s")
    runs["phase_s"] = time.perf_counter() - t0
    return {"runs": runs, "launches": launches}


# phase 15 sizes: 15a-15c the reference's transformer at Llama-2-7B's
# published widths (HF meta-llama/Llama-2-7b-hf config.json: vocab 32000,
# d 4096, 32 heads x 128, d_ff 11008; the FFN is this repo's GELU form),
# depth cut to 4 of 32 layers (15c: 1), batch 4 x 2048 tokens (15b: 1 x
# 2048); 15d the mesh libraries on phase 12's two ranks (attention
# [B, L, H, D], MoE tokens a rank (B, S), d, f, experts, top-k; the pipeline
# (n_mb, mb, d); the LM at narrow widths)
TRAIN = {"model": {"vocab": 32000, "d_model": 4096, "n_heads": 32,
                   "head_dim": 128, "d_ff": 11008},
         "layers": 4, "batch": (4, 2048), "steps": 8, "lr": 3e-4,
         "warmup": 2, "oracle_tol": 1e-3, "resume_layers": 1,
         "resume_batch": (2, 2048), "resume_steps": 2}
MESH = {"attn": (1, 4096, 8, 128), "moe": ((2, 512), 1024, 2048, 8, 2),
        "pipe": (4, 64, 1024),
        "lm": {"vocab": 32000, "d_model": 512, "n_heads": 8,
               "head_dim": 64, "n_layers": 2, "d_ff": 2048},
        "lm_batch": (2, 1024), "timeout": 180.0}


def _rel_err(got, want) -> float:
    """max |got - want| / max |want| (float64)."""
    g, w = got.detach().double(), want.detach().double()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-300))


def train_path(dev_t, dims=None, out_dir=None) -> dict:
    """Phase 15a-15c: the transformer's training path, both hand-written
    kernels in it (use_flash, use_pallas_norm), f32 with TF32 off.
      15a training.train, `steps` steps of AdamW (clip, warmup-cosine) on
          one fixed batch drawn from a seeded generator: every loss
          finite, the last below the first, the parameters on the card;
          per-step wall (CUDA events), tokens/s, peak memory, and the
          kernels' launches, which must be n_layers flash and
          2*n_layers+1 RMSNorm forward launches a step (the backward of
          each is plain torch, as the reference's is plain jnp)
      15b on 15a's parameters, its optimizer state freed: the loss and
          every gradient at batch 1 through both kernels in f32 against
          the plain path in float64 on the card, each gradient within
          `oracle_tol` of its max-abs
      15c depth `resume_layers`: 2 steps, save, 2 more; a fresh model and
          optimizer loaded from the file run the same 2 steps: every
          parameter and moment bit for bit, under
          torch.use_deterministic_algorithms(True) with
          CUBLAS_WORKSPACE_CONFIG=:4096:8 (both restored after); the save
          and load rates in GB/s of the file
    Returns the runs and 15a's launches."""
    import dataclasses
    import gc

    import torch

    from parsec_tpu_torch import kernels
    from parsec_tpu_torch.checkpoint import save_train_state
    from parsec_tpu_torch.models import training as TR
    from parsec_tpu_torch.models import transformer as T
    dims = dims or TRAIN
    on_card = dev_t.type == "cuda"
    if on_card and (torch.backends.cuda.matmul.allow_tf32 or
                    torch.backends.cudnn.allow_tf32):
        raise AssertionError("phase 15 wants TF32 off")
    out_dir = out_dir or os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "build", "phase15")
    os.makedirs(out_dir, exist_ok=True)

    def peak_gb():
        return torch.cuda.max_memory_allocated(dev_t) / 1e9 if on_card \
            else 0.0

    def reset_peak():
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev_t)

    cfg = T.TransformerConfig(**dims["model"], n_layers=dims["layers"],
                              use_flash=True, use_pallas_norm=True)
    steps = dims["steps"]
    gen = torch.Generator(device=dev_t)
    gen.manual_seed(SEED + 15)
    B, S = dims["batch"]
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                         device=dev_t)
    batch = (toks[:, :-1].contiguous(), toks[:, 1:].contiguous())
    tc = TR.TrainConfig(lr=dims["lr"], warmup_steps=dims["warmup"],
                        total_steps=steps)
    runs = {"model": dict(dims["model"], layers=dims["layers"]),
            "batch": [B, S], "steps": steps}

    # ------------------------------------------------------------ 15a
    t = time.perf_counter()
    state = TR.init_train_state(cfg, tc, gen, device=dev_t)
    sync(dev_t)
    runs["init_s"] = time.perf_counter() - t
    n_params = sum(p.numel() for p in state["params"].parameters())
    reset_peak()
    marks = []

    def mark(*_):
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    kernels.reset_launches()
    mark()
    state, losses = TR.train(cfg, tc, [batch] * steps, state=state,
                             on_step=mark)
    sync(dev_t)
    launches = dict(kernels.LAUNCHES)
    step_ms = [marks[i].elapsed_time(marks[i + 1]) if on_card
               else (marks[i + 1] - marks[i]) * 1e3
               for i in range(steps)]
    want = {"flash_attention": cfg.n_layers * steps,
            "rms_norm": (2 * cfg.n_layers + 1) * steps}
    runs.update({"params": n_params, "losses": losses, "step_ms": step_ms,
                 "tokens_per_s": B * S * 1e3 / float(np.median(step_ms)),
                 "peak_gb_a": peak_gb(), "launches": launches,
                 "launches_expected": want})
    log(f"  15a {n_params} parameters ({n_params * 4 / 1e9:.2f} GB f32), "
        f"init {runs['init_s']:.2f} s; losses "
        f"{[f'{x:.4f}' for x in losses]}")
    log(f"  15a step wall (CUDA events) {[f'{x:.1f}' for x in step_ms]} "
        f"ms, {runs['tokens_per_s']:.1f} tokens/s (median step), peak "
        f"{runs['peak_gb_a']:.2f} GB; launches {launches} (expected "
        f"{want} on the card: n_layers flash and 2*n_layers+1 RMSNorm "
        "forward launches a step)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"15a: losses {losses}")
    devs = {p.device.type for p in state["params"].parameters()}
    if devs != {dev_t.type}:
        raise AssertionError(f"15a: parameters on {devs}")
    if on_card and launches != want:
        raise AssertionError(f"15a: launches {launches} != {want}")

    # ------------------------------------------------------------ 15b
    model = state["params"]
    del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reset_peak()
    b1 = (batch[0][:1], batch[1][:1])
    t = time.perf_counter()
    loss32, g32 = T.value_and_grad(model, b1, cfg)
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64, use_flash=False,
                                use_pallas_norm=False)
    p64 = T.tree_from_items((k, v.detach().double())
                            for k, v in T.tree_items(model.tree()))
    loss64, g64 = T.value_and_grad(p64, b1, cfg64)
    sync(dev_t)
    g64 = dict(T.tree_items(g64))
    errs = {k: _rel_err(g, g64[k]) for k, g in T.tree_items(g32)}
    loss_err = abs(float(loss32) - float(loss64)) / abs(float(loss64))
    runs.update({"oracle_s": time.perf_counter() - t,
                 "oracle_loss": [float(loss32), float(loss64)],
                 "oracle_loss_rel_err": loss_err, "oracle_grad_rel_err": errs,
                 "peak_gb_b": peak_gb()})
    log(f"  15b batch 1 x {S}: loss f32 kernels {float(loss32):.6f} vs "
        f"float64 plain {float(loss64):.6f} (rel {loss_err:.2e}, tol 1e-5); "
        f"gradient max-abs error / max-abs (tol {dims['oracle_tol']:g}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; {runs['oracle_s']:.1f} s, peak {runs['peak_gb_b']:.2f} GB")
    if loss_err > 1e-5 or max(errs.values()) > dims["oracle_tol"]:
        raise AssertionError(f"15b: loss rel {loss_err}, gradients {errs}")
    del model, g32, g64, p64, loss32, loss64
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ 15c
    reset_peak()
    cfg1 = dataclasses.replace(cfg, n_layers=dims["resume_layers"])
    n = dims["resume_steps"]
    tc1 = TR.TrainConfig(lr=dims["lr"], warmup_steps=1, total_steps=2 * n)
    gen.manual_seed(SEED + 151)
    b, s = dims["resume_batch"]
    toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                         device=dev_t)
    batch1 = [(toks[:, :-1].contiguous(), toks[:, 1:].contiguous())] * n
    path = os.path.join(out_dir, "train_state.npz")
    prev_det = torch.are_deterministic_algorithms_enabled()
    prev_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        state = TR.init_train_state(cfg1, tc1, gen, device=dev_t)
        state, _ = TR.train(cfg1, tc1, batch1, state=state)
        sync(dev_t)
        t = time.perf_counter()
        save_train_state(path, state)
        save_s = time.perf_counter() - t
        nbytes = os.path.getsize(path)
        state, la = TR.train(cfg1, tc1, batch1, state=state)
        sync(dev_t)
        t = time.perf_counter()
        resumed = TR.resume_train_state(cfg1, tc1, path, device=dev_t)
        sync(dev_t)
        load_s = time.perf_counter() - t
        resumed, lb = TR.train(cfg1, tc1, batch1, state=resumed)
        sync(dev_t)
        diff = [k for k, a in T.tree_items(state["params"].tree())
                if not torch.equal(a, dict(T.tree_items(
                    resumed["params"].tree()))[k])]
        for which in ("mu", "nu"):
            rb = dict(T.tree_items(resumed["opt"][which]))
            diff += [f"{which}.{k}" for k, a in
                     T.tree_items(state["opt"][which])
                     if not torch.equal(a, rb[k])]
    finally:
        torch.use_deterministic_algorithms(prev_det)
        if prev_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_env
        if os.path.exists(path):
            os.remove(path)
    n1 = sum(p.numel() for p in state["params"].parameters())
    runs.update({"resume_params": n1, "ckpt_bytes": nbytes,
                 "save_s": save_s, "load_s": load_s,
                 "save_gbps": nbytes / save_s / 1e9,
                 "load_gbps": nbytes / load_s / 1e9,
                 "resume_losses": [la, lb], "peak_gb_c": peak_gb()})
    log(f"  15c depth {cfg1.n_layers}, {n1} parameters: checkpoint "
        f"{nbytes / 1e9:.2f} GB saved in {save_s:.2f} s "
        f"({runs['save_gbps']:.2f} GB/s), loaded in {load_s:.2f} s "
        f"({runs['load_gbps']:.2f} GB/s); losses after resume {lb} vs "
        f"straight {la}; parameters and moments differing: {diff or 'none'}"
        f"; peak {runs['peak_gb_c']:.2f} GB")
    if diff or la != lb:
        raise AssertionError(f"15c: resume not bit for bit: {diff}, "
                             f"{la} vs {lb}")
    del state, resumed
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return {"runs": runs, "launches": launches}


def train_kernels(dev_t, runs: dict, bw: float, f32_peak: float,
                  tf32_peak: float) -> None:
    """15a's kernels at its shapes, f32: the flash kernel causal at
    [B*H, S, D] and the RMSNorm kernel at [B*S, d], each held against its
    plain version on the same inputs (phase 2's 2e-5) and timed (CUDA
    events) beside its plain version, one library call (SDPA causal,
    F.rms_norm) and its bound: the bytes (each input read once, the
    output written once) or the operations a causal run needs (the
    query-key pairs at or below the diagonal), as phase 3 counts them."""
    import torch
    import torch.nn.functional as F
    fa_mod = importlib.import_module("parsec_tpu_torch.ops.flash_attention")
    rn_mod = importlib.import_module("parsec_tpu_torch.ops.rms_norm")
    B, S = runs["batch"]
    H, D, d = (runs["model"][k] for k in ("n_heads", "head_dim", "d_model"))
    gen = torch.Generator(device=dev_t)
    gen.manual_seed(SEED + 152)
    n = B * H
    q, k, v = (torch.randn((n, S, D), generator=gen, device=dev_t)
               for _ in range(3))
    sc = D ** -0.5
    fa = {"shape": [n, S, D], "max_abs_err": check_close(
        f"flash_attention causal [{n}, {S}, {D}] (15a's)",
        fa_mod.flash_attention_cuda(q, k, v, True, sc),
        fa_mod.attention_reference(q, k, v, True, sc), 2e-5, 2e-5)}
    fa["ms"] = time_ms(lambda: fa_mod.flash_attention_cuda(q, k, v, True,
                                                           sc), 10)
    fa["plain_ms"] = time_ms(lambda: fa_mod.attention_reference(
        q, k, v, True, sc), 3)
    fa["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=sc), 5)
    ops = 4.0 * n * (S * (S + 1) / 2) * D
    t_ops = min(ops / f32_peak, 3 * ops / tf32_peak)
    t_bytes = 4 * n * S * D * 4 / bw
    fa["bound_ms"] = max(t_ops, t_bytes) * 1e3
    fa["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    del q, k, v
    x = torch.randn((B * S, d), generator=gen, device=dev_t)
    w = torch.randn((d,), generator=gen, device=dev_t)
    rms = {"shape": [B * S, d], "max_abs_err": check_close(
        f"rms_norm [{B * S}, {d}] (15a's)", rn_mod.rms_norm_cuda(x, w, EPS),
        rn_mod.rms_norm_plain(x, w, EPS), 2e-5, 2e-5)}
    rms["ms"] = time_ms(lambda: rn_mod.rms_norm_cuda(x, w, EPS), 20)
    rms["plain_ms"] = time_ms(lambda: rn_mod.rms_norm_plain(x, w, EPS), 10)
    rms["library_ms"] = time_ms(lambda: F.rms_norm(x, (d,), w, EPS), 20) \
        if hasattr(F, "rms_norm") else None
    t_bytes = (2 * x.numel() + d) * 4 / bw
    t_ops = 4 * x.numel() / f32_peak
    rms["bound_ms"] = max(t_ops, t_bytes) * 1e3
    rms["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    del x, w
    runs["kernels"] = {"flash_attention": fa, "rms_norm": rms}
    for name, r in runs["kernels"].items():
        log(f"  15a {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


# 15d: each mesh library's output and gradients within this fraction of
# the one-rank call's max-abs (f32 with TF32 off, sums in other orders;
# the flash kernel's 3xTF32 products as in phase 2)
MESH_TOL = 1e-4


def mesh_check(ranks) -> dict:
    """15d's results from the two ranks: every error within MESH_TOL, the
    capped MoE dropping (token, choice) pairs; prints the bytes staged
    through host memory per op."""
    out = {"staged": ranks[0]["staged"],
           "moe_dropped_pairs": ranks[0]["moe_dropped_pairs"],
           "launches": [r["launches"] for r in ranks],
           "wall_s": [r["wall_s"] for r in ranks], "err": {}}
    for r in ranks:
        for k, v in r["err"].items():
            out["err"][k] = max(out["err"].get(k, 0.0), v)
    log(f"  15d bytes staged through pinned host memory (rank 0): "
        f"{out['staged']}")
    log("  15d max-abs error / max-abs of the one-rank call (tol "
        f"{MESH_TOL:g}): " + ", ".join(f"{k} {v:.2e}"
                                       for k, v in out["err"].items())
        + f"; capped MoE dropped {out['moe_dropped_pairs']} (token, "
        "choice) pairs; "
        f"ranks' kernel launches {out['launches']}, walls "
        f"{[f'{w:.1f}' for w in out['wall_s']]} s")
    bad = {k: v for k, v in out["err"].items() if not v <= MESH_TOL}
    if bad or out["moe_dropped_pairs"] <= 0:
        raise AssertionError(f"15d: {bad}, dropped pairs "
                             f"{out['moe_dropped_pairs']}")
    return out


GLOO_PROBE_OPS = ("all_reduce", "broadcast", "all_gather",
                  "reduce_scatter", "all_to_all", "send_recv")


def _gloo_probe_rank(op: str, rank: int, port: int, q) -> None:
    """One rank of the gloo probe: `op` once over two ranks with tensors
    on the card, its result checked on the host."""
    import torch
    import torch.distributed as dist
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                                f"{port}", world_size=2, rank=rank)
        x = torch.full((1 << 16,), rank + 1.0, device="cuda")
        peer = 1 - rank
        if op == "all_reduce":
            dist.all_reduce(x)
            want = [3.0]
        elif op == "broadcast":
            dist.broadcast(x, 0)
            want = [1.0]
        elif op == "all_gather":
            outs = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(outs, x)
            x, want = torch.cat(outs), [1.0, 2.0]
        elif op == "reduce_scatter":
            out = torch.empty_like(x[:1 << 15])
            dist.reduce_scatter(out, list(x.chunk(2)))
            x, want = out, [3.0]
        elif op == "all_to_all":
            outs = [torch.empty_like(x[:1 << 15]) for _ in range(2)]
            dist.all_to_all(outs, list(x.chunk(2)))
            x, want = torch.cat(outs), [1.0, 2.0]
        else:
            out = torch.empty_like(x)
            for r in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, peer),
                    dist.P2POp(dist.irecv, out, peer)]):
                r.wait()
            x, want = out, [peer + 1.0]
        torch.cuda.synchronize()
        got = sorted(set(x.cpu().tolist()))
        q.put((rank, "ok" if got == want else f"wrong result {got}"))
        dist.destroy_process_group()
    except (RuntimeError, ValueError, TypeError) as e:
        q.put((rank, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"))


def gloo_cuda_probe() -> dict:
    """Which gloo collectives take tensors on the card: each op of
    GLOO_PROBE_OPS on two fresh spawned ranks (a gloo op that does not
    check its device can abort its process, so each gets its own):
    "ok", the error it raised, or how its ranks ended."""
    import multiprocessing as mp
    import queue

    from parsec_tpu_torch.comm.launch import free_port_base
    out = {}
    for op in GLOO_PROBE_OPS:
        mpctx = mp.get_context("spawn")
        q = mpctx.Queue()
        port = free_port_base(1)
        procs = [mpctx.Process(target=_gloo_probe_rank, args=(op, r, port, q))
                 for r in range(2)]
        for p in procs:
            p.start()
        got = []
        try:
            for _ in range(2):
                got.append(q.get(timeout=60))
        except queue.Empty:
            pass
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        verdicts = sorted({v for _, v in got})
        out[op] = verdicts[0] if len(got) == 2 and len(verdicts) == 1 else \
            f"ranks reported {dict(got)}, exit codes " \
            f"{[p.exitcode for p in procs]}"
        log(f"  gloo {op} on CUDA tensors: {out[op]}")
    return out


def _moe_oracle(x, wg, wu, wd, k: int, cap: int, shards: int):
    """moe_ffn's arithmetic on one rank: each shard of x routes its own
    tokens (capacity `cap` per expert) through every expert.  Returns the
    output and the (token, choice) pairs the capacity dropped."""
    import torch

    from parsec_tpu_torch.parallel.expert import _dispatch_combine, gelu
    outs, dropped = [], 0
    for xs in x.chunk(shards, 0):
        bl, sl, d = xs.shape
        tok = xs.reshape(-1, d)
        disp, comb = _dispatch_combine(tok @ wg, k, cap)
        dropped += k * tok.shape[0] - int(disp.sum())
        send = torch.einsum("tec,td->ecd", disp, tok)
        h = gelu(torch.einsum("ecd,edf->ecf", send, wu))
        y = torch.einsum("tec,ecd->td", comb,
                         torch.einsum("ecf,efd->ecd", h, wd))
        outs.append(y.reshape(bl, sl, d))
    return torch.cat(outs, 0), dropped


def mesh_rank(rank: int, nodes: int, port: int, dev_t, dims) -> dict:
    """15d on one of phase 12's spawned ranks: a gloo job over the two
    ranks with CUDA tensors (NCCL refuses two ranks on one card; the ops
    gloo cannot take on the card are staged through pinned host memory,
    parallel/collectives.py), then each mesh library at
    sp/ep/pp/tp = 2 held against the one-rank call on the card (every
    rank computes it): ring and Ulysses attention (its local attention
    the flash kernel), causal; MoE uncapped against moe_ffn_reference and
    capped against one rank's dispatch/combine; gpipe forward and
    gradients against the sequential stack; the LM's forward at tp=2 and
    sp=2 with both kernels against its one-rank forward.  Returns the
    errors, the staged bytes per op and the wall."""
    import torch
    import torch.distributed as dist

    from parsec_tpu_torch import kernels
    from parsec_tpu_torch import parallel as pp
    from parsec_tpu_torch.models import transformer as T
    from parsec_tpu_torch.ops import flash_attention
    from parsec_tpu_torch.parallel.mesh import shard, unshard
    from parsec_tpu_torch.parallel.pipeline import gpipe
    t0 = time.perf_counter()
    pp.init_distributed(f"127.0.0.1:{port}", nodes, rank, device=dev_t,
                        backend="gloo")
    res = {"err": {}, "staged": {}}
    err = res["err"]
    kernels.reset_launches()
    try:
        gen = torch.Generator(device=dev_t)
        gen.manual_seed(SEED + 150)

        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev_t) * scale

        # attention at sp=2, causal
        sp = pp.make_mesh(sp=nodes, device=dev_t)
        q, k, v = (randn(*dims["attn"]) for _ in range(3))
        want = pp.blockwise_attention_reference(q, k, v, causal=True)
        loc = [shard(a, sp, (None, "sp")) for a in (q, k, v)]
        ring = pp.ring_attention(*loc, sp, "sp", causal=True)
        uly = pp.ulysses_attention(*loc, sp, "sp", causal=True,
                                   local_attn=flash_attention)
        err["ring_attention"] = _rel_err(unshard(ring, sp, (None, "sp")),
                                         want)
        err["ulysses_attention"] = _rel_err(
            unshard(uly, sp, (None, "sp")), want)
        del q, k, v, want, loc, ring, uly
        # MoE at ep=2
        (bl, sl), d, f, e, topk = dims["moe"]
        ep = pp.make_mesh(ep=nodes, device=dev_t)
        # tokens drawn N(0.5, 1), as phase 13's: the untrained router is
        # unbalanced and the capped run drops pairs
        x = randn(bl * nodes, sl, d) + 0.5
        wg = randn(d, e, scale=0.1)
        wu, wd = randn(e, d, f, scale=d ** -0.5), randn(e, f, d,
                                                        scale=f ** -0.5)
        xl, wul, wdl = (shard(a, ep, ("ep",)) for a in (x, wu, wd))
        full = pp.moe_ffn(xl, wg, wul, wdl, ep, "ep", k=topk,
                          capacity=bl * sl)
        err["moe_uncapped"] = _rel_err(
            unshard(full, ep, ("ep",)),
            pp.moe_ffn_reference(x, wg, wu, wd, k=topk))
        cap = max(1, int(1.25 * topk * bl * sl / e))
        capped = unshard(pp.moe_ffn(xl, wg, wul, wdl, ep, "ep", k=topk),
                         ep, ("ep",))
        want, res["moe_dropped_pairs"] = _moe_oracle(x, wg, wu, wd, topk,
                                                     cap, nodes)
        err["moe_capped"] = _rel_err(capped, want)
        del x, wu, wd, xl, wul, wdl, full, capped, want
        # gpipe at pp=2: forward and gradients
        n_mb, mb, dd = dims["pipe"]
        ppm = pp.make_mesh(pp=nodes, device=dev_t)
        w, b = randn(nodes, dd, dd, scale=dd ** -0.5), randn(nodes, dd,
                                                             scale=0.1)
        xs = randn(n_mb, mb, dd)

        def stage(params, h):
            return torch.tanh(h @ params[0] + params[1])

        wl, bl_ = (shard(a, ppm, ("pp",)).requires_grad_()
                   for a in (w, b))
        out = gpipe(stage, (wl, bl_), xs, ppm, "pp")
        (out ** 2).sum().backward()
        wr, br = w.clone().requires_grad_(), b.clone().requires_grad_()
        ref = xs
        for i in range(nodes):
            ref = stage((wr[i], br[i]), ref)
        (ref ** 2).sum().backward()
        err["gpipe"] = _rel_err(out, ref)
        err["gpipe_grad_w"] = _rel_err(unshard(wl.grad, ppm, ("pp",)),
                                       wr.grad)
        err["gpipe_grad_b"] = _rel_err(unshard(bl_.grad, ppm, ("pp",)),
                                       br.grad)
        # the LM's forward at tp=2 and at sp=2, both kernels on
        cfg = T.TransformerConfig(**dims["lm"], use_flash=True,
                                  use_pallas_norm=True)
        model = T.init_params(cfg, gen, device=dev_t)
        bb, ss = dims["lm_batch"]
        toks = torch.randint(0, cfg.vocab, (bb, ss), generator=gen,
                             device=dev_t)
        with torch.no_grad():
            want = T.forward(model, toks, cfg)
            for axis in ("tp", "sp"):
                mesh = pp.make_mesh(device=dev_t, **{axis: nodes})
                loc = T.shard_params(model, cfg, mesh)
                tl = shard(toks, mesh, (None, "sp" if axis == "sp"
                                        else None))
                got = T.forward(loc, tl, cfg, mesh)
                if axis == "sp":
                    got = unshard(got, mesh, (None, "sp"))
                err[f"lm_forward_{axis}"] = _rel_err(got, want)
                for op, nb in mesh.staged.items():
                    res["staged"][f"lm_{axis}.{op}"] = nb
        for name, m in (("attn", sp), ("moe", ep), ("pipe", ppm)):
            for op, nb in m.staged.items():
                res["staged"][f"{name}.{op}"] = nb
        res["launches"] = dict(kernels.LAUNCHES)
    finally:
        dist.destroy_process_group()
    res["wall_s"] = time.perf_counter() - t0
    return res


# phase 16 sizes: 16a phase 4's NORM (rows, d, T) and FATT (heads, L, D);
# 16d the dense-LA probe's tile sides (the reference's 512 and 1024), the
# DTD GEMM's (N, NB), the data plane's rungs (MiB), the launch probe's
# product side and the transfer-economics sweep's sizes (bytes)
TOOLS = {"norm": (8 * 4096, 4096, 1024), "fatt": (32, 4096, 128),
         "la_nb": (512, 1024), "dtd": (4096, 512), "dp_mb": (16, 64),
         "big": 4096, "econ_sizes": (4096, 65536, 4 << 20)}
# the examples jdf2dot enumerates, and the one whose enumeration both
# packages refuse (its LOWER datatype is registered by its runner only)
JDF_EXAMPLES = ("Ex01_HelloWorld", "Ex02_Chain", "Ex03_ChainDist",
                "Ex04_ChainData", "Ex05_Broadcast", "Ex06_RAW",
                "Ex07_RAW_CTL", "Ex08_Reshape")
JDF_REFUSED = {"Ex08_Reshape": "names no registered datatype"}


def run_tools(jobs: dict, parallel: int = 1,
              module: str = "parsec_tpu_torch.tools.{stem}",
              phase: int = 16) -> dict:
    """Run `python -m <module> args` (module: parsec_tpu_torch.tools.<stem>
    by default) for each {label: (stem, args, want, env)}, at most
    `parallel` at once, from the root of the checkout.  Returns {label:
    {"rc", "out", "err", "s"}}; raises when one exits other than
    `want`."""
    from concurrent.futures import ThreadPoolExecutor
    root = os.path.dirname(os.path.abspath(__file__))

    def one(stem, args, env):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", module.format(stem=stem),
             *map(str, args)], cwd=root, capture_output=True, text=True,
            env=dict(os.environ, **(env or {})), timeout=900)
        return {"rc": r.returncode, "out": r.stdout, "err": r.stderr,
                "s": time.perf_counter() - t0}

    # a free slot takes the next job whichever one ends first
    with ThreadPoolExecutor(max_workers=parallel) as pool:
        futs = {label: pool.submit(one, stem, args, env)
                for label, (stem, args, _, env) in jobs.items()}
        done = {label: f.result() for label, f in futs.items()}
    bad = {label: r for label, r in done.items()
           if r["rc"] != jobs[label][2]}
    for label, r in bad.items():
        log(f"  {label}: exit {r['rc']}, expected {jobs[label][2]}\n"
            f"{r['out'][-2000:]}\n{r['err'][-4000:]}")
    if bad:
        raise AssertionError(f"phase {phase}: {sorted(bad)} exited wrong")
    return done


def json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def tools_path(dev_t, rng, dims=None, out_dir=None, journal_dir=None,
               phase8_dtd_ms=None) -> dict:
    """Phase 16: the port's tools (parsec_tpu_torch.tools), each run as
    python -m parsec_tpu_torch.tools.<stem> and held to its exit status.
      16a phase 4's NORM and FATT pools (inputs drawn from `rng`) traced
          at level 2 on a fresh CudaDevice each, the launches counted, O
          at 2e-5 of the plain versions; ptt_info, ptt2tables, ptt2dot,
          ptt_critpath and ptc_plan --trace on the two traces
      16b ptc_verify all, plan_graphs and ptc_tune --check over every
          in-tree generator (all clean), jdf2dot --simulate 2 over the
          examples (Ex08 refused by both packages, checked by message),
          ptc_tune gemm_dist's simulated makespan under 16d's economics
          beside the default's
      16c ptc_postmortem --json on `journal_dir` (phase 10f's journal)
      16d the card probes one at a time: probe_la_kernels at the tile
          sides (beside torch.linalg.cholesky at each side, CUDA
          events), probe_launch_overhead, bench_dtd_gemm (beside phase 8's
          DTD-GEMM), bench_dataplane at the rungs over bytes and the
          transfer plane, testbandwidth --quick over its three paths at
          4 KiB, 64 KiB and 4 MiB (the document loaded with
          TransferEconomics.load, finite positive alpha and beta on
          every path)
    16d runs first, with nothing beside it; then 16b and 16c beside 16a,
    whose pools are held for their results, not timed.  Returns
    {"runs": {label: row}, "launches": 16a's kernel launches}."""
    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch import kernels
    from parsec_tpu_torch.comm.economics import TransferEconomics
    from parsec_tpu_torch.convert import to_collection, to_tensor
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.profiling import take_trace
    fa_mod = importlib.import_module("parsec_tpu_torch.ops.flash_attention")
    rn_mod = importlib.import_module("parsec_tpu_torch.ops.rms_norm")
    dims = dims or TOOLS
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = out_dir or os.path.join(root, "build", "phase16")
    os.makedirs(out_dir, exist_ok=True)
    journal_dir = journal_dir or os.path.join(root, "build", "phase10",
                                              "journal")
    on_card = dev_t.type == "cuda"
    dev_arg = [] if on_card else ["--device", "cpu"]
    out = {"runs": {}, "launches": {name: 0 for name in kernels.LAUNCHES}}
    t_phase = time.perf_counter()

    # ------------------------- 16d: the card probes, first and alone
    econ_path = os.path.join(out_dir, "econ.json")
    n, nb = dims["dtd"]
    probes = {
        "probe_la_kernels": ("probe_la_kernels", [
            a for s in dims["la_nb"] for a in ("--nb", s)] + dev_arg, 0,
            None),
        "probe_launch_overhead": ("probe_launch_overhead",
                                  ["--big", dims["big"]] + dev_arg, 0, None),
        "bench_dtd_gemm": ("bench_dtd_gemm", ["--n", n, "--nb", nb]
                           + dev_arg, 0, None),
        # on the CPU the transfer rungs are error rows (no card to pull
        # from), so the tool exits 1 there
        "bench_dataplane": ("bench_dataplane", [
            a for s in dims["dp_mb"] for a in ("--mb", s)] + dev_arg,
            0 if on_card else 1, None),
        # --quick's hops and reps, with a 4 MiB size beside its two: on
        # the H100 the device path's ~2 ms fixed leg hides its per-byte
        # leg below 64 KiB (a 4 KiB/64 KiB fit can slope below zero,
        # which the loader clamps to 0 ns/B)
        "testbandwidth": ("testbandwidth", [
            "--quick", "--sizes", ",".join(map(str, dims["econ_sizes"])),
            "--json", econ_path] + dev_arg, 0, None)}
    res = run_tools(probes)
    for label, r in res.items():
        log(f"  16d {label}: exit {r['rc']} in {r['s']:.1f} s")
    la = json_lines(res["probe_la_kernels"]["out"])
    for row in la:
        log(f"    {row['kernel']:9s} nb {row['nb']:5d} batch "
            f"{row['batch']:3d}: {row['ms']} ms, {row['gflops']} GFLOP/s")
    # the yardstick of `chol` (k_potrf, cholesky_ex on a one-lane stack):
    # one torch.linalg.cholesky call on the probe's matrix, CUDA events
    chol_lib = {}
    for nb_ in dims["la_nb"]:
        m = np.random.default_rng(0).standard_normal((nb_, nb_),
                                                     dtype=np.float32)
        spd = to_tensor(m @ m.T + nb_ * np.eye(nb_, dtype=np.float32),
                        dev_t)
        chol_lib[nb_] = time_ms(lambda: torch.linalg.cholesky(spd), 20) \
            if on_card else None
        log(f"    torch.linalg.cholesky nb {nb_}: {chol_lib[nb_]} ms")
    lo = json_lines(res["probe_launch_overhead"]["out"])[0]
    log(f"    launch overhead: {lo}")
    dtd = json_lines(res["bench_dtd_gemm"]["out"])[0]
    p8 = (f"; phase 8's DTD-GEMM (through its flush) "
          f"{2.0 * n ** 3 / phase8_dtd_ms / 1e6:.1f} GFLOP/s"
          if phase8_dtd_ms else "")
    log(f"    DTD GEMM: {dtd}{p8}")
    dp = json_lines(res["bench_dataplane"]["out"])
    for row in dp:
        log(f"    data plane: {row}")
        if on_card and (row.get("error") or (
                row["path"] == "transfer" and (
                    row["path_taken"] != "transfer"
                    or row["dp_xfer_bytes"] != row["tile_mb"] << 20
                    or row["dp_errors"] != 0))):
            raise AssertionError(f"16d data plane: {row}")
    econ = TransferEconomics.load(econ_path)
    legs = {p: (econ.alpha(p), econ.beta(p))
            for p in ("eager", "rdv", "device")}
    log(f"    the card's economics ({econ_path}): " + ", ".join(
        f"{p} alpha {a * 1e6:.2f} us beta {b * 1e9:.4f} ns/B"
        for p, (a, b) in legs.items()))
    for p, (a, b) in legs.items():
        # (a rehearsal's host device path can fit a negative intercept,
        # which the loader clamps to 0)
        if not (np.isfinite(a) and np.isfinite(b) and b > 0
                and (a > 0 or not on_card and a == 0)):
            raise AssertionError(f"16d economics: {p} alpha {a} beta {b}")
    with open(econ_path) as f:
        doc = json.load(f)
    out["runs"]["16d"] = {
        "la": la, "cholesky_lib_ms": chol_lib, "launch": lo,
        "dtd_gemm": dtd,
        "phase8_dtd_gflops": 2.0 * n ** 3 / phase8_dtd_ms / 1e6
        if phase8_dtd_ms else None,
        "dataplane": dp,
        "econ": {p: {"alpha_us": a * 1e6, "beta_ns": b * 1e9}
                 for p, (a, b) in legs.items()},
        "econ_sizes": {p: doc["paths"][p]["sizes"]
                       for p in ("eager", "rdv", "device")},
        "tool_s": {k: r["s"] for k, r in res.items()}}

    # 16b and 16c: the static tools and the postmortem, beside 16a
    static = {"ptc_verify all": ("ptc_verify", ["all"], 0, None),
              "plan_graphs": ("plan_graphs", [
                  "--json", os.path.join(out_dir, "plan_graphs.json")], 0,
                  None),
              "ptc_tune --check": ("ptc_tune", ["--check"], 0, None),
              "ptc_tune gemm_dist": ("ptc_tune", [
                  "gemm_dist", "--json",
                  os.path.join(out_dir, "tune_dflt.json")], 0, None),
              "ptc_tune gemm_dist, the card's economics": ("ptc_tune", [
                  "gemm_dist", "--json",
                  os.path.join(out_dir, "tune_card.json")], 0,
                  {"PTC_MCA_coll_econ_path": econ_path}),
              "ptc_postmortem": ("ptc_postmortem", [journal_dir, "--json"],
                                 0, None)}
    for ex in JDF_EXAMPLES:
        static[f"jdf2dot {ex}"] = (
            "jdf2dot", [os.path.join(root, "examples", ex + ".jdf"),
                        os.path.join(out_dir, ex + ".dot"), "--simulate",
                        "2"], 1 if ex in JDF_REFUSED else 0, None)
    static_res = {}
    static_thread = threading.Thread(
        target=lambda: static_res.update(
            run_tools(static, parallel=max(2, (os.cpu_count() or 2) // 2))),
        daemon=True)
    static_thread.start()

    # ------------------------------------------ 16a: traced NORM and FATT
    rows, d, T = dims["norm"]
    H, L, D = dims["fatt"]
    xn = rng.standard_normal((rows, d), dtype=np.float32)
    wn = rng.standard_normal((1, d), dtype=np.float32)
    qn = rng.standard_normal((H * L, D), dtype=np.float32)
    kn = rng.standard_normal((L, D), dtype=np.float32)
    vn = rng.standard_normal((L, D), dtype=np.float32)
    traces = {}
    with pt.Context(nb_workers=4) as ctx:
        X, W = to_collection(xn, T, d), to_collection(wn, 1, d)
        O = to_collection(np.zeros_like(xn), T, d)
        Q, K, V = (to_collection(qn, L, D), to_collection(kn, L, D),
                   to_collection(vn, L, D))
        OF = to_collection(np.zeros_like(qn), L, D)
        pools = {"NORM": (lambda dev: rn_mod.build_rms_norm(
                     ctx, X, W, O, EPS, dev=dev), rows // T, "rms_norm"),
                 "FATT": (lambda dev: fa_mod.build_flash_attention(
                     ctx, Q, K, V, OF, dev=dev), H, "flash_attention")}
        for label, (build, ntasks, kname) in pools.items():
            ctx.profile_take()
            ctx.profile_enable(2)
            dev = CudaDevice(ctx, device=dev_t)
            kernels.reset_launches()
            sync(dev_t)
            t = time.perf_counter()
            tp = build(dev)
            tp.run()
            tp.wait()
            dev.flush()
            sync(dev_t)
            wall = (time.perf_counter() - t) * 1e3
            got = dict(kernels.LAUNCHES)
            dev.stop()
            ctx.profile_enable(0)
            for k, v in got.items():
                out["launches"][k] += v
            if dev.stats["tasks"] != ntasks:
                raise AssertionError(f"16a {label}: {dev.stats['tasks']} "
                                     f"device tasks, expected {ntasks}")
            if on_card and got[kname] <= 0:
                raise AssertionError(f"16a {label}: {kname} never ran")
            tr = take_trace(ctx, class_names=[tc.name for tc in tp.classes],
                            meta={"path": f"phase16 {label}"})
            traces[label] = os.path.join(out_dir, f"phase16_{label}.ptt")
            tr.save(traces[label])
            log(f"  16a {label} traced at level 2: {wall:.1f} ms, "
                f"{len(tr.events)} events {tr.counts()}, kernel launches "
                f"{got} -> {traces[label]}")
            out["runs"][f"16a {label}"] = {"wall_ms": wall,
                                           "events": len(tr.events),
                                           "launches": got}
        check_close("16a NORM O vs plain", to_tensor(O.to_dense(), dev_t),
                    rn_mod.rms_norm_plain(to_tensor(xn, dev_t),
                                          to_tensor(wn[0], dev_t), EPS),
                    2e-5, 2e-5)
        kt, vt = to_tensor(kn, dev_t), to_tensor(vn, dev_t)
        check_close("16a FATT O vs plain",
                    to_tensor(OF.to_dense(), dev_t).reshape(H, L, D),
                    fa_mod.attention_reference(
                        to_tensor(qn, dev_t).reshape(H, L, D),
                        kt.unsqueeze(0).expand(H, L, D),
                        vt.unsqueeze(0).expand(H, L, D), False, D ** -0.5),
                    2e-5, 2e-5)
    del xn, wn, qn, kn, vn, X, W, O, Q, K, V, OF
    readers = {}
    gens = {"NORM": "ops_rms_norm", "FATT": "ops_flash_attention"}
    for label, path in traces.items():
        base = os.path.join(out_dir, f"phase16_{label}")
        readers.update({
            f"ptt_info {label}": ("ptt_info", [path], 0, None),
            f"ptt2tables {label}": ("ptt2tables", [base + ".csv", path], 0,
                                    None),
            f"ptt2dot {label}": ("ptt2dot", [base + ".dot", path], 0, None),
            f"ptt_critpath {label}": ("ptt_critpath", [
                path, "--json", base + "_critpath.json"], 0, None),
            f"ptc_plan --trace {label}": ("ptc_plan", [
                gens[label], "--trace", path], 0, None)})
    res = run_tools(readers, parallel=max(2, (os.cpu_count() or 2) // 2))
    for label in traces:
        info = res[f"ptt_info {label}"]["out"].splitlines()
        log(f"  16a ptt_info {label}: " + "; ".join(
            ln.strip() for ln in info if "n=" in ln))
        log(f"  16a ptt2tables {label}: "
            f"{res[f'ptt2tables {label}']['out'].strip()}; ptt2dot: "
            f"{res[f'ptt2dot {label}']['out'].strip()}")
        with open(os.path.join(out_dir,
                               f"phase16_{label}_critpath.json")) as f:
            rep = json.load(f)
        cp = rep.get("critical_path") or {}
        lt = rep.get("lost_time_totals")
        log(f"  16a ptt_critpath {label}: critical path "
            f"{len(cp.get('path', []))} task(s) "
            f"{cp.get('total_ns', 0) / 1e6:.3f} ms; lost time totals {lt}")
        plan_line = [ln.strip() for ln in
                     res[f"ptc_plan --trace {label}"]["out"].splitlines()
                     if ln.strip().startswith("critpath predicted")]
        if not plan_line:
            raise AssertionError(f"16a ptc_plan --trace {label}: no "
                                 "critpath line")
        log(f"  16a ptc_plan {gens[label]} --trace: {plan_line[0]}")
        out["runs"][f"16a {label}"].update({
            "critical_path": cp, "lost_time_totals": lt,
            "plan_vs_trace": plan_line[0]})
    out["runs"]["16a readers_s"] = {k: r["s"] for k, r in res.items()}

    static_thread.join(timeout=900)
    if set(static_res) != set(static):
        raise AssertionError("phase 16b/16c: the static tools failed (see "
                             "above)")
    for label, r in static_res.items():
        last = (r["out"].strip().splitlines() or [""])[-1]
        log(f"  16b {label}: exit {r['rc']} in {r['s']:.1f} s"
            + ("" if label == "ptc_postmortem" else f"; {last[:160]}"))
    for ex, msg in JDF_REFUSED.items():
        if msg not in static_res[f"jdf2dot {ex}"]["err"]:
            raise AssertionError(f"16b jdf2dot {ex}: refused otherwise than "
                                 f"the reference ({msg!r} expected)")
    pm = json.loads(static_res["ptc_postmortem"]["out"])
    log(f"  16c ptc_postmortem {journal_dir}: ranks {pm['ranks']}, dead "
        f"{pm['dead_ranks']}, first cause {pm['first_cause']}, "
        f"{len(pm['timeline'])} timeline records, {len(pm['anomalies'])} "
        "anomalies")
    if pm["schema"] != "ptc-postmortem-v1" or not pm["ranks"]:
        raise AssertionError(f"16c: bad report {pm}")
    out["runs"]["16b"] = {k: {"rc": r["rc"], "s": r["s"]}
                          for k, r in static_res.items()}
    out["runs"]["16c postmortem"] = {k: pm[k] for k in
                                     ("ranks", "dead_ranks", "first_cause")}
    mk = {}
    for key, f in (("default", "tune_dflt.json"), ("card", "tune_card.json")):
        with open(os.path.join(out_dir, f)) as fh:
            mk[key] = json.load(fh)["gemm_dist"]["simulated_makespan_ns"]
    log(f"  16d ptc_tune gemm_dist simulated makespan: {mk['default']} ns "
        f"under the default economics (BENCH_comm.json), {mk['card']} ns "
        "under the card's")
    out["runs"]["16d"]["gemm_dist_makespan_ns"] = mk

    out["runs"]["phase_s"] = time.perf_counter() - t_phase
    return out


# phase 17 sizes: 17a the headline's one rung at phase 6's POTRF-P size and
# the tiled child at phase 6's POTRF-T size; 17b the ring at the
# reference's defaults (S 8 x T 2048, d 128: a 16384-token context); 17c
# and 17d at the reference tests' flags (host-bound suites: small sizes
# measure the same thing), trace, serve and control at their defaults
# (their in-document verdicts are timing gates sized there; trace and
# serve run alone: another suite's load moves them)
BENCH = {
    "headline": (32768, 512), "tiled": (16384, 1024), "ring": (8, 2048, 128),
    "device": ["--tiles", 24, "--elems", 4096, "--batch", 4, "--reps", 1,
               "--gemm-m", 128, "--gemm-k", 32, "--gemm-mb", 16],
    "stream": ["--size", 512 * 1024, "--chunk", 64 * 1024, "--hops", 3,
               "--reps", 1],
    "serve": [],
    "control": [],
    "dispatch": ["--tasks", 2000, "--mt-tasks", 600, "--reps", 2],
    "trace": [],
    "collective": ["--sizes", f"{64 * 1024},{256 * 1024}", "--reps", 1],
    "topo": [],
}
# bench_check's `equal` rows whose value is a timing verdict, not a
# correctness flag: a wall or latency ratio, or wave counts that the
# admission timing moves.  Printed, not gated: on the card they flipped
# with the load beside them (journal 1.143 and 1.115 over the 5% gate,
# QoS p99 0.947x at the test flags, a recovery ratio of 0.0 after a
# swap that took the spills to 0)
BENCH_TIMING_ROWS = {"journal.within_gate", "qos.hi_p99_beats_control",
                     "soak.recovered", "spec.adaptive_ge_best_fixed"}
# the correctness flags each document must hold true
BENCH_FLAGS = {
    "device": ("out_of_core_gemm.correct", "wave_fuse.bit_identical"),
    "serve": ("decode.bit_identical", "prefix.bit_identical",
              "spec.bit_identical", "fleet.bit_identical",
              "tp.bit_identical", "tp.all_ranks_fused"),
    "control": ("spec.bit_identical",),
    "topo": ("bit_identical", "remap.predicted_sound"),
}


def _dig(doc, path):
    for part in path.split("."):
        doc = doc[part]
    return doc


def _dp_errors(doc, path=""):
    """(path, value) of every dp_errors key in a document."""
    out = []
    if isinstance(doc, dict):
        for k, v in doc.items():
            if k == "dp_errors":
                out.append((f"{path}/{k}", v))
            out += _dp_errors(v, f"{path}/{k}")
    elif isinstance(doc, list):
        for i, v in enumerate(doc):
            out += _dp_errors(v, f"{path}[{i}]")
    return out


def bench_path(dev_t, dims=None, out_dir=None, dense=None) -> dict:
    """Phase 17: the benchmark entry point, each suite as python -m
    parsec_tpu_torch.bench ... --json <out_dir>/BENCH_<suite>.json in a
    subprocess on `dev_t`, held to exit 0 and a last stdout line that
    parses.
      17a the headline at one rung (PTC_BENCH_N / PTC_BENCH_NB: phase 6's
          POTRF-P), its residual gated, its GFLOP/s printed beside
          torch.linalg.cholesky and phase 6's POTRF-P (`dense`); then the
          tiled child at phase 6's POTRF-T size
      17b the ring at the reference's defaults: max_abs_err <= 5e-2
      17c the device, stream, control and serve suites: their
          bit_identical and correct flags true, every dp_errors 0
      17d the dispatch, trace, ep, collective and topology suites (and
          plan_graphs' PLAN_graphs.json)
    Trace and serve run alone (their timing verdicts), the rest four
    at a time.
      17e tools/bench_check.check_all over the documents: every guarded
          path found, every `equal` row's value true but the timing
          verdicts of BENCH_TIMING_ROWS, which are printed"""
    import importlib.util
    dims = dims or BENCH
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = out_dir or os.path.join(root, "build", "torch_bench")
    os.makedirs(out_dir, exist_ok=True)
    t_phase = time.perf_counter()
    dev = ["--device", str(dev_t)]
    env = {"PTC_MCA_tune_cache_path": os.path.join(out_dir, "tuned.json")}
    out = {"runs": {}}

    def doc_path(name):
        return os.path.join(out_dir, f"BENCH_{name}.json")

    def bench(jobs, parallel=1):
        """{label: args} -> {label: (last stdout JSON line, run)}"""
        res = run_tools({label: ("", args, 0, env)
                         for label, args in jobs.items()},
                        parallel=parallel, module="parsec_tpu_torch.bench",
                        phase=17)
        lines = {}
        for label, r in res.items():
            got = json_lines(r["out"])
            if not got:
                raise AssertionError(f"17 {label}: no JSON line on stdout")
            lines[label] = (got[-1], r)
            out["runs"][label] = {"s": r["s"], "line": got[-1]}
        return lines

    # ---- 17a: the headline's one rung, alone on the card
    n, nb = dims["headline"]
    env_h = dict(env, PTC_BENCH_N=str(n), PTC_BENCH_NB=str(nb))
    res = run_tools({"17a headline": ("", dev, 0, env_h)},
                    module="parsec_tpu_torch.bench", phase=17)
    (line,) = json_lines(res["17a headline"]["out"])[-1:]
    out["runs"]["17a headline"] = {"s": res["17a headline"]["s"],
                                   "line": line}
    with open(doc_path("spotrf"), "w") as fh:
        json.dump(line, fh, indent=1)
    if line["config"]["N"] != n or line.get("value") is None:
        raise AssertionError(f"17a: not the N={n} rung: {line}")
    if line["residual"] is None or not line["residual"] <= 1e-2:
        raise AssertionError(f"17a: residual {line['residual']}")
    base = line["baseline"]
    p6 = ""
    if dense is not None:
        row = dense["paths"].get(f"POTRF-P N={n} NB={nb}")
        if row is not None:
            p6 = (f"; phase 6's POTRF-P {row['gflops']:.1f} GFLOP/s, its "
                  f"torch.linalg.cholesky {row['cusolver_ms']:.1f} ms")
    log(f"  17a headline N={n} NB={nb}: {line['value']} GFLOP/s, "
        f"torch.linalg.cholesky {base['gflops']} GFLOP/s ({base['ms']} ms), "
        f"vs_baseline {line['vs_baseline']}, residual "
        f"{line['residual']:.3e}, f32 matmul "
        f"{line['chip_fp32_matmul_gflops']} GFLOP/s, {line['chip_kind']} "
        f"{line['power_limit_w']} W, wall {line['wall']}{p6} "
        f"({res['17a headline']['s']:.1f} s)")

    # ---- the trace suite alone: its journal gate is a 5% timing gate
    lines = bench({"17d trace": ["--trace", "--json", doc_path("trace"),
                                 *dims["trace"]]})

    # ---- 17a tiled child, 17b ring, 17c, 17d: four at a time
    n2, nb2 = dims["tiled"]
    s, t, d = dims["ring"]
    jobs = {
        "17c control": ["--control", "--json", doc_path("control"),
                        *dims["control"], *dev],
        "17c stream": ["--stream", "--json", doc_path("stream"),
                       *dims["stream"], *dev],
        "17d collective": ["--collective", "--json", doc_path("collective"),
                           *dims["collective"], *dev],
        "17c device": ["--device", "--json", doc_path("device"),
                       *dims["device"], *dev],
        "17a tiled": ["--spotrf-child", "--tiled", "--n", n2, "--nb", nb2,
                      *dev],
        "17b ring": ["--ring", "--s", s, "--t", t, "--d", d, *dev],
        "17d dispatch": ["--dispatch", "--json", doc_path("dispatch"),
                         *dims["dispatch"]],
        "17d topo": ["--topo", "--json", doc_path("topo"), *dims["topo"]],
        "17d ep": ["--ep"],
    }
    lines.update(bench(jobs, parallel=4))
    # ---- the serve suite alone: its QoS verdict is a latency race
    jobs["17c serve"] = ["--serve", "--json", doc_path("serve"),
                         *dims["serve"], *dev]
    lines.update(bench({"17c serve": jobs["17c serve"]}))
    tl = lines["17a tiled"][0]
    if tl["residual"] is None or not tl["residual"] <= 1e-2:
        raise AssertionError(f"17a tiled: residual {tl['residual']}")
    log(f"  17a tiled child N={n2} NB={nb2}: {tl['value']} GFLOP/s, "
        f"torch.linalg.cholesky {tl['baseline']['gflops']} GFLOP/s, "
        f"vs_baseline {tl['vs_baseline']}, residual {tl['residual']:.3e}")
    rg = lines["17b ring"][0]
    if not rg["max_abs_err"] <= 5e-2:
        raise AssertionError(f"17b: max_abs_err {rg['max_abs_err']}")
    log(f"  17b ring S={s} T={t} d={d}: runtime {rg['runtime_ms']} ms, "
        f"one plain torch attention call {rg['gspmd_ms']} ms (both host "
        f"to host), ratio {rg['value']}, max_abs_err "
        f"{rg['max_abs_err']:.3e}")
    for label in sorted(lines):
        if label.startswith(("17c", "17d")):
            log(f"  {label}: {lines[label][1]['s']:.1f} s, "
                f"{json.dumps(lines[label][0])[:300]}")

    # the documents' correctness flags and data-plane errors
    res = run_tools({"17d plan_graphs": (
        "plan_graphs", ["--json", os.path.join(out_dir, "PLAN_graphs.json")],
        0, env)}, phase=17)
    docs = {}
    for name in ("device", "stream", "serve", "control", "collective",
                 "dispatch", "trace", "topo"):
        with open(doc_path(name)) as fh:
            docs[name] = json.load(fh)
    fails = []
    for name, paths in BENCH_FLAGS.items():
        for p in paths:
            v = _dig(docs[name], p)
            if v is not True:
                fails.append(f"{name}: {p} = {v}")
    for name, d in docs.items():
        for p, v in _dp_errors(d):
            if v != 0:
                fails.append(f"{name}: {p} = {v}")
    flags = [f"{n}.{p}" for n, ps in BENCH_FLAGS.items() for p in ps]
    log(f"  17c flags {', '.join(flags)} true, dp_errors 0: {not fails}")

    # ---- 17e: the guarded paths
    spec = importlib.util.spec_from_file_location(
        "bench_check_tool", os.path.join(root, "tools", "bench_check.py"))
    bc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bc)
    rows, _ = bc.check_all(current_dir=out_dir, baseline_dir=out_dir)
    for r in rows:
        if r.get("note") in ("no current file", "metric missing"):
            fails.append(f"17e {r['file']} {r['metric']}: {r['note']}")
        elif r["direction"] == "equal" and \
                r["metric"] not in BENCH_TIMING_ROWS and \
                r.get("current") is not True:
            fails.append(f"17e {r['file']} {r['metric']} = "
                         f"{r.get('current')}")
    eq = [r for r in rows if r["direction"] == "equal"]
    log(f"  17e bench_check: {len(rows)} guarded paths found in "
        f"{len({r['file'] for r in rows})} documents; equal rows: "
        + ", ".join(f"{r['file'][6:-5]}.{r['metric']}={r.get('current')}"
                    for r in eq if r["metric"] not in BENCH_TIMING_ROWS)
        + "; timing verdicts (not gated): "
        + ", ".join(f"{r['file'][6:-5]}.{r['metric']}={r.get('current')}"
                    for r in eq if r["metric"] in BENCH_TIMING_ROWS))
    out["runs"]["17e"] = {"rows": len(rows),
                          "equal": {f"{r['file']}:{r['metric']}":
                                    r.get("current") for r in eq}}
    if fails:
        raise AssertionError("phase 17: " + "; ".join(fails))
    out["runs"]["phase_s"] = time.perf_counter() - t_phase
    return out


# phase 18: the concurrency soak at one rep of main's sizes, its two
# device jobs on the card; aimed at about 120 s of the run, failed above
# SOAK_LIMIT_S
SOAK_REPS = 1
SOAK_LIMIT_S = 180.0


def soak_path(dev_t, reps: int = SOAK_REPS) -> dict:
    """Phase 18: python -m parsec_tpu_torch.tools.stress_tsan --device
    <dev_t> with STRESS_REPS=reps in a subprocess, without TSAN: the 15
    jobs of the native core's concurrency soak (tools/stress_tsan.py's
    port), wave_fuse_gemm and tp_decode_churn with a CudaDevice on the
    card.  Held to exit 0, "stress ok" as the last stdout line and one
    wall a call of the soak's CALLS a rep (stderr's "job <name> <s> s");
    each job asserts its own checks, the device jobs dp_errors 0 on every
    rank.  Returns {"runs": {"rc", "s", "jobs": {name: [walls]}}}."""
    from parsec_tpu_torch.tools.stress_tsan import CALLS
    t_phase = time.perf_counter()
    res = run_tools({"18 soak": ("stress_tsan", ["--device", str(dev_t)], 0,
                                 {"STRESS_REPS": str(reps)})}, phase=18)
    r = res["18 soak"]
    if r["out"].splitlines()[-1:] != ["stress ok"]:
        raise AssertionError(f"phase 18: no 'stress ok' line\n"
                             f"{r['out'][-2000:]}\n{r['err'][-4000:]}")
    jobs: dict = {}
    for ln in r["err"].splitlines():
        m = re.fullmatch(r"job (\w+) ([0-9.]+) s", ln.strip())
        if m:
            jobs.setdefault(m.group(1), []).append(float(m.group(2)))
    want = {}
    for name, _, _ in CALLS:
        want[name] = want.get(name, 0) + reps
    got = {name: len(w) for name, w in jobs.items()}
    if got != want:
        raise AssertionError(f"phase 18: job lines {got}, expected {want}")
    for name, walls in jobs.items():
        log(f"  18 {name}: {len(walls)} call(s), "
            + ", ".join(f"{w:.3f}" for w in walls) + " s")
    out = {"rc": r["rc"], "s": r["s"], "jobs": jobs,
           "phase_s": time.perf_counter() - t_phase}
    log(f"  18 soak: exit {r['rc']}, stress ok, {sum(got.values())} job "
        f"calls in {r['s']:.1f} s")
    return {"runs": out}


# phase 19: the debug streams on the card: phase 4's NORM path at 4
# tiles of (1024, 4096) f32 in a child process with debug.runtime and
# debug.device at 1
DEBUG = {"norm": (4 * 1024, 4096, 1024)}
DEBUG_LIMIT_S = 120.0


def debug_child(dev_s: str, rows: int, d: int, T: int) -> None:
    """Phase 19's child: phase 4's NORM pool (X, O rows x d tiled (T, d),
    W one (1, d) tile) through Context -> Taskpool -> CudaDevice(dev_s),
    run, waited and flushed under the launch counts, O held to the plain
    RMSNorm at phase 4's 2e-5.  Prints one JSON line {"tasks",
    "launches", "max_abs_err", "wall_ms"} last on stdout; the streams
    write to stderr."""
    import torch

    import parsec_tpu_torch as pt
    from parsec_tpu_torch import kernels
    from parsec_tpu_torch.convert import to_collection, to_tensor
    from parsec_tpu_torch.device import CudaDevice
    rn_mod = importlib.import_module("parsec_tpu_torch.ops.rms_norm")
    dev_t = torch.device(dev_s)
    rng = np.random.default_rng(SEED + 19)
    xn = rng.standard_normal((rows, d), dtype=np.float32)
    wn = rng.standard_normal((1, d), dtype=np.float32)
    with pt.Context(nb_workers=4) as ctx:
        Xc, Wc = to_collection(xn, T, d), to_collection(wn, 1, d)
        Oc = to_collection(np.zeros_like(xn), T, d)
        dev = CudaDevice(ctx, device=dev_s)
        tp = rn_mod.build_rms_norm(ctx, Xc, Wc, Oc, EPS, dev=dev)
        kernels.reset_launches()
        sync(dev_t)
        t = time.perf_counter()
        tp.run()
        tp.wait()
        dev.flush()
        sync(dev_t)
        wall = time.perf_counter() - t
        got = dict(kernels.LAUNCHES)
        err = check_close("19 NORM O vs plain", to_tensor(Oc.to_dense(),
                                                          dev_t),
                          rn_mod.rms_norm_plain(to_tensor(xn, dev_t),
                                                to_tensor(wn[0], dev_t),
                                                EPS), 2e-5, 2e-5)
        tasks = dev.stats["tasks"]
        dev.stop()
    print(json.dumps({"tasks": tasks, "launches": got, "max_abs_err": err,
                      "wall_ms": wall * 1e3}))


def debug_path(dev_t, dims=None) -> dict:
    """Phase 19: debug_child in a subprocess from the root of the
    checkout with PTC_MCA_debug_runtime=1 and PTC_MCA_debug_device=1
    (every other PTC_MCA_debug_* removed).  Holds its stderr to the
    streams' lines: the device's 'device up: <dev_t> ...', the runtime's
    'taskpool 0: <tasks> local tasks across 1 classes' and 'taskpool 0
    complete (0 errors)', the flush's '<tasks> dirty mirrors' (one O tile
    a task), and no comm line; on the card the rms_norm kernel must have
    run.  Returns {"runs": {...}, "launches": the child's counts}."""
    rows, d, T = (dims or DEBUG)["norm"]
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PTC_MCA_debug_")}
    env.update(PTC_MCA_debug_runtime="1", PTC_MCA_debug_device="1")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.debug_child("
         f"{str(dev_t)!r}, {rows}, {d}, {T})"], cwd=root, env=env,
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"phase 19: the child exited {r.returncode}\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    res = json.loads(r.stdout.splitlines()[-1])
    n = rows // T
    want = {
        "device up": rf"ptc \[device\]: device up: {re.escape(str(dev_t))} "
                     r"queue=\d+ cache=\d+MiB batch<= \d+",
        "taskpool start": rf"ptc \[runtime\]: taskpool 0: {n} local tasks "
                          r"across 1 classes .*",
        "taskpool end": r"ptc \[runtime\]: taskpool 0 complete \(0 errors\)",
        "flush": rf"ptc \[device\]: flush: {n} dirty mirrors"}
    lines = [ln.strip() for ln in r.stderr.splitlines()
             if ln.startswith("ptc [")]
    found = {k: [ln for ln in lines if re.fullmatch(rx, ln)]
             for k, rx in want.items()}
    missing = [k for k, got in found.items() if len(got) != 1]
    if missing or any(ln.startswith("ptc [comm]:") for ln in lines):
        raise AssertionError(f"phase 19: stream lines {missing} not found "
                             f"once, or a comm line, in\n"
                             + "\n".join(lines) + f"\n{r.stderr[-4000:]}")
    if res["tasks"] != n:
        raise AssertionError(f"phase 19: {res['tasks']} tasks, not {n}")
    if str(dev_t).startswith("cuda") and res["launches"]["rms_norm"] <= 0:
        raise AssertionError("phase 19: the rms_norm kernel never ran")
    for ln in lines:
        log(f"  19 {ln}")
    log(f"  19 NORM {rows}x{d} f32, T={T} with debug.runtime=1 and "
        f"debug.device=1: {res['wall_ms']:.1f} ms path wall, "
        f"max_abs_err {res['max_abs_err']:.3e}, launches "
        f"{res['launches']}; the child process {wall:.1f} s")
    return {"runs": {"wall_ms": res["wall_ms"],
                     "max_abs_err": res["max_abs_err"],
                     "tasks": res["tasks"], "lines": lines,
                     "phase_s": wall},
            "launches": res["launches"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:] == ["--gloo-probe"]:
        # which gloo ops take CUDA tensors (parallel/collectives.py
        # stages the others through pinned host memory)
        print(json.dumps({"gloo_cuda": gloo_cuda_probe()}))
        return 0
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
    log(f"  SERVE conformance turns (on, off, on) tokens/s: on "
        f"{serve['tokens_per_s_conformance']['on']}, off "
        f"{serve['tokens_per_s_conformance']['off']}")
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
    for name, n in rt["launches"].items():
        launches[name] += n
    log(f"  RUNTIME phase {time.perf_counter() - t:.1f} s; hand-written "
        f"kernel launches in it: {rt['launches']}")
    log("phase 10: the profiling layer and the static analyses: PINS, "
        "metrics, live sampler, verify, plan, tune, serving with "
        "conformance on, the watchdog and the journal")
    t = time.perf_counter()
    rng10 = np.random.default_rng()
    rng10.bit_generator.state = phase4_rng
    obs = observe_path(dev_t, rng10, serve=serve, ptg_norm_o=norm_o)
    # phase 5's serving model is phase 14's too (same config and seed)
    fleet_model = serve["_round"][0]
    del norm_o, serve["_round"]
    for name, n in obs["launches"].items():
        launches[name] += n
    log(f"  OBSERVE phase {time.perf_counter() - t:.1f} s; hand-written "
        f"kernel launches in it: {obs['launches']}")
    log("phase 11: wave and chain fusion, plan_check and the chain hints")
    t = time.perf_counter()
    rng11 = np.random.default_rng(SEED + 11)
    fz = fuse_path(dev_t, rng11)
    for name, n in fz["launches"].items():
        launches[name] += n
    log(f"  FUSE phase {time.perf_counter() - t:.1f} s; hand-written "
        f"kernel launches in it: {fz['launches']}")
    log("phase 12: the comm engine on the card: two ranks as two "
        "processes on this card over the loopback transport (12a GEMM, 12b "
        "the data plane, 12d collectives, 12e merged trace), then two "
        "colocated ranks in this process (12c)")
    t = time.perf_counter()
    cm = comm_path(dev_t, multi=MULTI, fleet=FLEET, mesh=MESH)
    # the ranks ran phase 13b/13d, 14b-14d and 15d after phase 12: their
    # time is phase 13's, 14's and 15's
    comm_s = time.perf_counter() - t - cm["runs"]["multi_s"] - \
        cm["runs"]["fleet_s"] - cm["runs"]["mesh_s"]
    for name, n in cm["launches"].items():
        launches[name] += n
    cm["runs"]["phase_s"] = comm_s
    log(f"  COMM phase {comm_s:.1f} s (its ranks' processes "
        f"{cm['runs']['spmd_s'] - cm['runs']['multi_s'] - cm['runs']['fleet_s'] - cm['runs']['mesh_s']:.1f}"
        f" s of it, then 13b/13d {cm['runs']['multi_s']:.1f} s, "
        f"14b-14d {cm['runs']['fleet_s']:.1f} s and 15d "
        f"{cm['runs']['mesh_s']:.1f} s); hand-written kernel "
        f"launches in it (both ranks): {cm['launches']}")
    if comm_s > 90.0:
        raise AssertionError(f"phase 12 took {comm_s:.1f} s (> 90 s)")
    log("phase 13: the multi-rank taskpools and tensor-parallel serving: "
        "ring attention and MoE with device chores on one rank (13a, "
        "13c) and on phase 12's two ranks (13b, 13d), tp=2 serving "
        "against tp=1 (13e), the chores timed (13f)")
    kernels.reset_launches()
    mu = multi_path(dev_t, ranks=cm["multi"])
    multi_s = mu["runs"]["phase_s"] + cm["runs"]["multi_s"]
    log(f"  MULTI phase {multi_s:.1f} s (13b/13d on the ranks "
        f"{cm['runs']['multi_s']:.1f} s); hand-written kernel launches in "
        f"it: {dict(kernels.LAUNCHES)}")
    if multi_s > 180.0:
        raise AssertionError(f"phase 13 took {multi_s:.1f} s (> 180 s)")
    log("phase 14: the fleet tier: the router over two replicas in this "
        "process (14a), page migration over the wire and the transfer "
        "plane on phase 12's two ranks (14b, 14c), the comm rows of "
        "observability (14d), the tuner's comm axes (14e)")
    kernels.reset_launches()
    fl = fleet_path(dev_t, model=fleet_model, ranks=cm["fleet"],
                    comm_runs=cm["runs"])
    del fleet_model
    fleet_s = fl["runs"]["phase_s"] + cm["runs"]["fleet_s"]
    fl["runs"]["total_s"] = fleet_s
    for name, n in fl["launches"].items():
        launches[name] += n
    log(f"  FLEET phase {fleet_s:.1f} s (14b-14d on the ranks "
        f"{cm['runs']['fleet_s']:.1f} s); hand-written kernel launches in "
        f"it (14c, both ranks): {fl['launches']}")
    if fleet_s > 120.0:
        raise AssertionError(f"phase 14 took {fleet_s:.1f} s (> 120 s)")
    log("phase 15: the transformer's training path at Llama-2-7B widths, "
        "both kernels in it: train (15a), float64 oracle (15b), "
        "checkpoint resume (15c); the mesh libraries on phase 12's two "
        "ranks (15d)")
    t = time.perf_counter()
    tr = train_path(dev_t)
    for name, n in tr["launches"].items():
        launches[name] += n
    train_kernels(dev_t, tr["runs"], bw, f32_peak, tf32_peak)
    tr["runs"]["mesh"] = mesh_check(cm["mesh"])
    train_s = time.perf_counter() - t + cm["runs"]["mesh_s"]
    tr["runs"]["phase_s"] = train_s
    log(f"  TRAIN phase {train_s:.1f} s (15d on the ranks "
        f"{cm['runs']['mesh_s']:.1f} s); hand-written kernel launches in "
        f"15a: {tr['launches']}")
    if train_s > 120.0:
        raise AssertionError(f"phase 15 took {train_s:.1f} s (> 120 s)")
    log("phase 16: the repo's tools on the port, each as python -m "
        "parsec_tpu_torch.tools.<stem>: the trace readers on traced NORM "
        "and FATT pools (16a), the static tools over every generator and "
        "the examples (16b), the postmortem on phase 10f's journal (16c), "
        "the card probes (16d)")
    n8, nb8 = DSL["gemm"]
    tl = tools_path(dev_t, np.random.default_rng(SEED + 16),
                    phase8_dtd_ms=dsl["runs"][
                        f"DTD-GEMM {n8}^2 f32, {nb8}^2 tiles"]["wall_ms"])
    for name, n in tl["launches"].items():
        launches[name] += n
    tools_s = tl["runs"]["phase_s"]
    log(f"  TOOLS phase {tools_s:.1f} s; hand-written kernel launches in "
        f"16a: {tl['launches']}")
    if tools_s > 180.0:
        raise AssertionError(f"phase 16 took {tools_s:.1f} s (> 180 s)")
    log("phase 17: the benchmark entry point, each suite as python -m "
        "parsec_tpu_torch.bench: the headline's rung and the tiled child "
        "(17a), the ring (17b), the device, stream, serve and control "
        "suites (17c), the host suites (17d), tools/bench_check over "
        "their documents (17e)")
    bn = bench_path(dev_t, dense=dense)
    bench_s = bn["runs"]["phase_s"]
    log(f"  BENCH phase {bench_s:.1f} s; documents in build/torch_bench/")
    if bench_s > 300.0:
        raise AssertionError(f"phase 17 took {bench_s:.1f} s (> 300 s)")
    log("phase 18: the native core's concurrency soak, python -m "
        "parsec_tpu_torch.tools.stress_tsan at STRESS_REPS=1 without "
        "TSAN, its device jobs (wave_fuse_gemm, tp_decode_churn) on the "
        "card")
    sk = soak_path(dev_t)
    soak_s = sk["runs"]["phase_s"]
    log(f"  SOAK phase {soak_s:.1f} s")
    if soak_s > SOAK_LIMIT_S:
        raise AssertionError(f"phase 18 took {soak_s:.1f} s "
                             f"(> {SOAK_LIMIT_S:.0f} s)")
    log("phase 19: the debug streams on the card: phase 4's NORM path "
        "at 4 tiles in a child process with PTC_MCA_debug_runtime=1 and "
        "PTC_MCA_debug_device=1")
    dbg = debug_path(dev_t)
    for name, n in dbg["launches"].items():
        launches[name] += n
    debug_s = dbg["runs"]["phase_s"]
    log(f"  DEBUG phase {debug_s:.1f} s; hand-written kernel launches in "
        f"it: {dbg['launches']}")
    if debug_s > DEBUG_LIMIT_S:
        raise AssertionError(f"phase 19 took {debug_s:.1f} s "
                             f"(> {DEBUG_LIMIT_S:.0f} s)")
    log(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"dense_la": dense}))
    print(json.dumps({"pipeline": pipe["runs"]}))
    print(json.dumps({"dsl": dsl["runs"]}))
    print(json.dumps({"runtime": rt["runs"]}))
    print(json.dumps({"observe": obs["runs"]}))
    print(json.dumps({"fuse": fz["runs"]}))
    print(json.dumps({"comm": cm["runs"]}))
    print(json.dumps({"multi": mu["runs"], "chores": mu["chores"]},
                     default=str))
    print(json.dumps({"fleet": fl["runs"]}, default=str))
    print(json.dumps({"train": tr["runs"]}, default=str))
    print(json.dumps({"tools": tl["runs"]}, default=str))
    print(json.dumps({"bench": bn["runs"]}, default=str))
    print(json.dumps({"soak": sk["runs"]}))
    print(json.dumps({"debug": dbg["runs"]}))

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
