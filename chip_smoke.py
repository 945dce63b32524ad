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
Then print the kernels line (JSON) and, last, the device line (JSON).
Exits non-zero, printing no result, when there is no CUDA card.
"""
from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys
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


def main_path(rng, dev_t, drive) -> None:
    """The port's main path at full width: GEMM, NORM and FATT taskpools
    through Context -> Taskpool -> CudaDevice, each run by
    drive(label, tp, dev, ntasks) -> launch counts of that run, then
    checked against the plain computation on the card."""
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
        check_close("NORM O vs plain", to_tensor(Oc.to_dense(), dev_t),
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

    main_path(rng, dev_t, drive)

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
    log(smi.stdout.strip().splitlines()[0])

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
