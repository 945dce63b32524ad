"""Ex09: dense linear algebra through the runtime, both granularities.

The JDF tutorials (Ex01-Ex08) show the surface language; this example
shows the Python builder API on the framework's headline workload --
Cholesky factorization -- in its two dataflow shapes, with the chores on
a CudaDevice:

  * tiled   (build_potrf):        the DPLASMA dpotrf_L DAG over nb x nb
                                  tiles on a PxQ block-cyclic grid -- the
                                  distributed form (reference:
                                  dplasma/lib/dpotrf_L.jdf role)
  * panels  (build_potrf_panels): full-height N x nb panel tasks, each
                                  trailing update one batched product --
                                  the single-card form

Run:  python -m parsec_tpu_torch.examples.Ex09_PanelCholesky [N] [nb]
          [--device cuda]

The device is the card by default (raising without one); `--device cpu`
runs the chores' plain versions on the host.  float32 with TF32 off (the
chores refuse TF32).

Port of examples/Ex09_PanelCholesky.py.
"""
import argparse
import sys

import numpy as np

import parsec_tpu_torch as pt
from parsec_tpu_torch.algos import build_potrf, build_potrf_panels
from parsec_tpu_torch.data import TwoDimBlockCyclic
from parsec_tpu_torch.device import CudaDevice


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("N", type=int, nargs="?", default=512)
    ap.add_argument("nb", type=int, nargs="?", default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the chores (default: the card)")
    args = ap.parse_args(argv)
    N, nb = args.N, args.nb
    rng = np.random.default_rng(0)
    M = rng.standard_normal((N, N), dtype=np.float32)
    spd = M @ M.T + N * np.eye(N, dtype=np.float32)
    ref = np.linalg.cholesky(spd)

    with pt.Context(nb_workers=4) as ctx:
        dev = CudaDevice(ctx, device=args.device)

        # ---- tiled (distributed form; here single-rank) ----
        A = TwoDimBlockCyclic(N, N, nb, nb, dtype=np.float32)
        A.from_dense(spd)
        A.register(ctx, "A")
        tp = build_potrf(ctx, A, dev=dev)
        tp.run()
        tp.wait()
        dev.flush()
        err = np.abs(np.tril(A.to_dense()) - ref).max()
        print(f"tiled  potrf: N={N} nb={nb} max|err|={err:.2e}")

        # ---- panel-granular (single-card form) ----
        P = TwoDimBlockCyclic(N, N, N, nb, dtype=np.float32)
        for j in range(P.nt):
            P.tile(0, j)[...] = spd[:, j * nb:(j + 1) * nb]
        P.register(ctx, "P")
        tp2 = build_potrf_panels(ctx, P, dev=dev, name="P")
        tp2.run()
        tp2.wait()
        dev.flush()
        out = np.zeros((N, N), np.float32)
        for j in range(P.nt):
            out[:, j * nb:(j + 1) * nb] = P.tile(0, j)
        err2 = np.abs(np.tril(out) - ref).max()
        print(f"panels potrf: N={N} nb={nb} max|err|={err2:.2e}")
        s = dev.stats
        print(f"device: tasks={s['tasks']} batches={s['batches']} "
              f"fused_flows={s['fused_flows']}")
        dev.stop()
    if not (err < 5e-3 and err2 < 5e-3):
        print("Ex09: the factors are off", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
