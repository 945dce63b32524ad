#!/usr/bin/env python3
"""Design choices of the flash-attention kernel, timed on one card.

    python3 tools/flash_variants.py        # from the repo root

Builds the committed kernel (parsec_tpu_torch/kernels/flash_attention.cu)
and variants of it made by replacing one line or expression of its
source, one nvcc per variant, all at once, into build/flash_variants/.
Each runs FATT's shape, q [32, 4096, 128] f32 over one K/V shared at
lane stride 0, with q as drawn and scaled by 4, and the script prints
per variant one JSON line: ptxas registers and spills, the mean time of
20 launches (CUDA events), and the max abs error against the plain f32
version and against float64.  SDPA is timed beside them as the
yardstick.  The "no_split" variant feeds raw f32 bits to all three
passes and "no_split_pass" skips the pass that splits each K/V tile:
their results are wrong, and their times are those of the kernel
without that work.  Exits non-zero without a
CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "flash_variants")

_ROUND = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
_SMALL = "  small = tf32(x - __uint_as_float(big));"
_K_PASS = "      for (int i = threadIdx.x; i < BK * NQ; i += NT) {"
_V_PASS = "      for (int i = threadIdx.x; i < BK * D / 4; i += NT) {"
# name -> (old, new) replacements in the kernel's source
VARIANTS = {
    "committed": [],
    # Q.K^T summed on the tensor cores over all of D at once
    "skc16": [("constexpr int SKC = 8;", "constexpr int SKC = 16;")],
    # TF32 rounding by the cvt instruction instead of the integer pipe
    "cvt_rna": [(_ROUND, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" '
                 ': "=r"(r) : "f"(x));\n  return r;')],
    # small left for the tensor cores to truncate
    "trunc_small": [(_SMALL,
                     "  small = __float_as_uint(x - __uint_as_float(big));")],
    # no split at all (wrong results; the time without the split's work)
    "no_split": [("  big = tf32(x);\n" + _SMALL,
                  "  big = __float_as_uint(x);\n  small = big;")],
    # no split pass over the K/V tiles (wrong results; the time without it)
    "no_split_pass": [(_K_PASS, _K_PASS.replace("BK * NQ", "0")),
                      (_V_PASS, _V_PASS.replace("BK * D / 4", "0"))],
}


def _time_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _ptxas_f32_d128(log: str) -> str:
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Function properties" in line and "IfLi128E" in line:
            return f"{lines[i + 2].split(': ', 1)[1]}; {lines[i + 1].strip()}"
    return "not found"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from parsec_tpu_torch import kernels
    from parsec_tpu_torch.ops.flash_attention import attention_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    with open(kernels.source_path("flash_attention")) as f:
        source = f.read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        src = os.path.join(OUT, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
             os.path.join(OUT, f"{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")

    H, L, D = 32, 4096, 128
    sc = D ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(H, L, D, device="cuda", generator=gen)
    k1 = torch.randn(L, D, device="cuda", generator=gen)
    v1 = torch.randn(L, D, device="cuda", generator=gen)
    k, v = (t.unsqueeze(0).expand(H, L, D) for t in (k1, v1))
    cases = {}
    for qs in (1, 4):
        qq = q * qs
        s64 = torch.matmul(qq.double(), k1.double().t()) * sc
        cases[qs] = (qq, attention_reference(qq, k, v, False, sc),
                     torch.matmul(torch.softmax(s64, -1), v1.double()))
        del s64
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    sdpa = _time_ms(lambda: F.scaled_dot_product_attention(
        q[None], k.contiguous()[None], v.contiguous()[None], scale=sc))
    print(json.dumps({"variant": "sdpa", "ms": sdpa}), flush=True)
    o = torch.empty_like(q)
    for name in VARIANTS:
        fn = ctypes.CDLL(os.path.join(OUT, f"{name}.so")).ptc_flash_attention
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
            [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]

        def run(qq):
            rc = fn(qq.data_ptr(), k1.data_ptr(), v1.data_ptr(), o.data_ptr(),
                    H, L, L, D, qq.stride(0), 0, 0, sc, 0, 0,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed, CUDA error {rc}")

        row = {"variant": name, "ptxas": _ptxas_f32_d128(logs[name]),
               "ms": _time_ms(lambda: run(q))}
        for qs, (qq, ref, ref64) in cases.items():
            run(qq)
            torch.cuda.synchronize()
            row[f"q*{qs} err_vs_plain"] = (o - ref).abs().max().item()
            row[f"q*{qs} err_vs_f64"] = (o.double() - ref64).abs().max().item()
            row[f"q*{qs} plain_vs_f64"] = (ref.double() - ref64).abs().max() \
                .item()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
