"""Ring attention through the runtime against one plain attention call
(bench.py's `--ring`): the same blockwise attention computed (a) as the
runtime's ring-attention taskpool with every ATT and FIN a chore on a
CudaDevice, and (b) as one softmax(q k^T / sqrt(d)) v in torch on the
same device, TF32 off.  Both are timed host to host (placement of the
numpy inputs, compute, the dense result back on the host); the ratio is
the task runtime's overhead at this shape.
"""
from __future__ import annotations

import json
import time

import numpy as np

import parsec_tpu_torch as pt

from .common import torch_device


def bench_ring(S=8, T=2048, d=128, reps=3, device="cuda"):
    """The ring line; `gspmd_ms` (the reference's key) is the plain
    torch call's best host-to-host time, `runtime_ms` the taskpool's
    (its first run untimed).  The result must agree with the plain call
    within 5e-2 (RuntimeError otherwise)."""
    import torch

    from parsec_tpu_torch.algos.ring_attention import run_ring_attention
    from parsec_tpu_torch.device import CudaDevice

    dev_t = torch_device(str(device))
    rng = np.random.default_rng(0)
    L = S * T
    q = (rng.standard_normal((L, d)) / 8).astype(np.float32)
    k = (rng.standard_normal((L, d)) / 8).astype(np.float32)
    v = (rng.standard_normal((L, d)) / 8).astype(np.float32)

    def full_att(qt, kt, vt):
        s = (qt @ kt.T) * (d ** -0.5)
        return torch.softmax(s, dim=-1) @ vt

    def host_to_host():
        qt, kt, vt = (torch.from_numpy(x).to(dev_t) for x in (q, k, v))
        return full_att(qt, kt, vt).cpu().numpy()

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        o_ref = host_to_host()  # settle
        plain_s = None
        for _ in range(reps):
            t0 = time.perf_counter()
            host_to_host()
            dt = time.perf_counter() - t0
            if plain_s is None or dt < plain_s:
                plain_s = dt

        # (a) the same work through the native runtime + device module
        runtime_best = None
        out = None
        for rep in range(reps + 1):  # the first run warms up
            with pt.Context(nb_workers=2) as ctx:
                dev = CudaDevice(ctx, device=dev_t)
                try:
                    t0 = time.perf_counter()
                    Oc = run_ring_attention(ctx, S, T, d, q, k, v, dev=dev)
                    got = Oc.to_dense()
                    dt = time.perf_counter() - t0
                finally:
                    dev.stop()
            if rep > 0 and (runtime_best is None or dt < runtime_best):
                runtime_best = dt
            if out is None:
                out = got
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    err = float(np.abs(out - o_ref).max())
    if not np.isfinite(err) or err > 5e-2:
        raise RuntimeError(f"ring attention mismatch vs the plain torch "
                           f"call: {err}")
    chip = torch.cuda.get_device_name(dev_t) if dev_t.type == "cuda" \
        else "cpu"
    return json.dumps({
        "metric": "ring_attention_runtime_over_gspmd",
        "value": round(runtime_best / plain_s, 3),
        "unit": "x (lower is better, 1.0 = parity)",
        "vs_baseline": round(plain_s / runtime_best, 3),
        "config": {"S": S, "T": T, "d": d, "seq": L},
        "chip_kind": chip,
        "gspmd_ms": round(plain_s * 1e3, 2),
        "runtime_ms": round(runtime_best * 1e3, 2),
        "max_abs_err": err,
    })
