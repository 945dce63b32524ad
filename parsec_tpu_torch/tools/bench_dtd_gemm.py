"""DTD tiled GEMM on the card (the BASELINE ladder's rung 2).

Runtime-discovered DAG: every (m, n, k) product C[m, n] += A[m, k] @
B[k, n] inserted through the DTD accessor chain as one insert_cuda_task
on a CudaDevice (the ready tasks it pops together run as one vmapped
launch), host tiles staged h2d on first touch, then wait_device_tiles --
the honest DTD number.  One
untimed run first (the insert path, the cuBLAS handles), then the best
of two; C of the last run is held to torch.matmul at 1e-4 / 1e-3.

Emits one JSON line:
  {"metric": "dtd_gemm", "gflops": .., "tasks_per_s": .., "config": ..,
   "chip_kind": .., "max_abs_err": ..}

    python -m parsec_tpu_torch.tools.bench_dtd_gemm [--n 4096] [--nb 512]
        [--device cuda]

Exits 1 when C is off.  Port of tools/bench_dtd_gemm.py.
"""
import argparse
import json
import sys
import time

import numpy as np


def k_gemm(a, b, c):
    return c + a @ b


def run(N: int, nb: int, dev_t, rng):
    """One DTD GEMM of fresh N x N operands from `rng` on a new Context
    and CudaDevice.  Returns (seconds from the first insert to the last
    tile final on the device, a, b, C as a dense host array)."""
    import parsec_tpu_torch as pt
    from parsec_tpu_torch.data import TwoDimBlockCyclic
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.device.bench_utils import wait_device_tiles
    from parsec_tpu_torch.dsl.dtd import DtdTaskpool
    nt = N // nb
    a = rng.standard_normal((N, N), dtype=np.float32)
    b = rng.standard_normal((N, N), dtype=np.float32)
    with pt.Context(nb_workers=4) as ctx:
        A = TwoDimBlockCyclic(N, N, nb, nb, dtype=np.float32)
        B = TwoDimBlockCyclic(N, N, nb, nb, dtype=np.float32)
        C = TwoDimBlockCyclic(N, N, nb, nb, dtype=np.float32)
        A.from_dense(a)
        B.from_dense(b)
        C.from_dense(np.zeros((N, N), dtype=np.float32))
        A.register(ctx, "A")
        B.register(ctx, "B")
        C.register(ctx, "C")
        dev = CudaDevice(ctx, device=dev_t)
        dtd = DtdTaskpool(ctx)
        shapes = {i: (nb, nb) for i in range(3)}
        t0 = time.perf_counter()
        for m in range(nt):
            for n in range(nt):
                for k in range(nt):
                    dtd.insert_cuda_task(
                        dev, k_gemm,
                        (dtd.tile_of(A, m, k), "INPUT"),
                        (dtd.tile_of(B, k, n), "INPUT"),
                        (dtd.tile_of(C, m, n), "INOUT"), shapes=shapes)
        dtd.wait()
        wait_device_tiles(dev, C)
        dt = time.perf_counter() - t0
        dev.flush()
        dev.stop()
        dtd.destroy()
        return dt, a, b, C.to_dense()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--nb", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from parsec_tpu_torch.tools import device_kind, torch_device
    dev_t = torch_device(args.device)
    N, nb = args.n, args.nb
    rng = np.random.default_rng(7)
    run(N, nb, dev_t, rng)  # warm: the insert path, the library handles
    runs = [run(N, nb, dev_t, rng) for _ in range(2)]
    dt = min(r[0] for r in runs)
    _, a, b, c = runs[-1]
    want = torch.matmul(torch.from_numpy(a).to(dev_t),
                        torch.from_numpy(b).to(dev_t))
    got = torch.from_numpy(c).to(dev_t)
    diff = (got - want).abs()
    err = float(diff.max())
    # f32 products, sums of N terms in another order
    ok = bool((diff <= 1e-3 + 1e-4 * want.abs()).all())
    tasks = (N // nb) ** 3
    print(json.dumps({
        "metric": "dtd_gemm",
        "gflops": round(2.0 * N * N * N / dt / 1e9, 1),
        "tasks_per_s": round(tasks / dt, 1),
        "config": {"N": N, "nb": nb, "tasks": tasks},
        "chip_kind": device_kind(dev_t),
        "max_abs_err": err,
    }))
    if not ok:
        print(f"bench_dtd_gemm: C off torch.matmul beyond 1e-4 / 1e-3 "
              f"(max_abs_err {err:.3e})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
