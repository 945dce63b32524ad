"""Per-chore cost probe for the dense-LA tile chores (algos/potrf.py) on
the card: where a spotrf's time goes, chore by chore, before any
optimization is attempted.

Times, per tile shape (NB x NB) and batch width B (the chores take
[B, NB, NB] lane stacks, as a wave of the DAG gives them):
  chol      k_potrf                       (POTRF diagonal, B=1)
  trsm      k_trsm, L shared by the lanes (TRSM panel wave)
  trsm_inv  tri inverse once + one batched product against it (the
            tensor-core-friendly TRSM: solve_triangular(L, I) -> bmm)
  syrk      k_syrk                        (SYRK wave)
  gemm      k_gemm                        (GEMM wave, the FLOPs bulk)
  launch    x + 1 on 8 floats -- the per-call floor

Each time is the median of 5 calls after a warm-up call, CUDA events
around each call on the card (the host clock with --device cpu).
float32 with TF32 off: the chores refuse TF32 on the card.

Emits one JSON line per measurement:
  {"kernel": k, "nb": NB, "batch": B, "ms": t, "gflops": g, "chip": kind}

    python -m parsec_tpu_torch.tools.probe_la_kernels [--nb 512]
        [--nb 1024 ...] [--batch 8 ...] [--device cuda]

Port of tools/probe_la_kernels.py (NB 512 and batches 8 and 32 by
default, as there).
"""
import argparse
import json
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nb", type=int, action="append", default=None,
                    help="tile side (repeatable; default 512)")
    ap.add_argument("--batch", type=int, action="append", default=None,
                    help="wave width (repeatable; default 8 and 32)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from parsec_tpu_torch.algos.potrf import k_gemm, k_potrf, k_syrk, k_trsm
    from parsec_tpu_torch.tools import device_kind, median_s, torch_device
    dev = torch_device(args.device)
    kind = device_kind(dev)
    nbs = args.nb or [512]
    batches = args.batch or [8, 32]

    def emit(kernel, nb, batch, fn, flops):
        dt = median_s(fn, dev)
        print(json.dumps({"kernel": kernel, "nb": nb, "batch": batch,
                          "ms": round(dt * 1e3, 3),
                          "gflops": round(flops / dt / 1e9, 1),
                          "chip": kind}), flush=True)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # dispatch floor: what does ANY call cost end to end?
    tiny = torch.ones(8, dtype=torch.float32, device=dev)
    emit("launch", 0, 1, lambda: tiny + 1.0, 0.0)

    for nb in nbs:
        rng = np.random.default_rng(0)
        spd = rng.standard_normal((nb, nb), dtype=np.float32)
        spd = spd @ spd.T + nb * np.eye(nb, dtype=np.float32)
        t_d = put(spd[None])
        l_d = put(np.linalg.cholesky(spd)[None])

        emit("chol", nb, 1, lambda: k_potrf(t_d), nb ** 3 / 3)
        emit("trsm", nb, 1, lambda: k_trsm(l_d, t_d), nb ** 3)

        for b in batches:
            c_b = put(rng.standard_normal((b, nb, nb), dtype=np.float32))
            a_b = put(rng.standard_normal((b, nb, nb), dtype=np.float32))
            t_b = put(np.broadcast_to(spd, (b, nb, nb)))
            l_b = l_d.expand(b, nb, nb)  # one L for every lane

            emit("trsm", nb, b, lambda: k_trsm(l_b, c_b), b * nb ** 3)

            # the tensor-core-friendly TRSM: invert the (tiny) triangle
            # once, then the whole wave is one batched product
            def trsm_inv():
                linv = torch.linalg.solve_triangular(
                    l_d[0], torch.eye(nb, dtype=l_d.dtype, device=dev),
                    upper=False)
                return torch.matmul(c_b, linv)
            emit("trsm_inv", nb, b, trsm_inv, b * nb ** 3)

            emit("syrk", nb, b, lambda: k_syrk(a_b, t_b), b * nb ** 3)
            emit("gemm", nb, b, lambda: k_gemm(a_b, c_b, t_b),
                 2 * b * nb ** 3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
