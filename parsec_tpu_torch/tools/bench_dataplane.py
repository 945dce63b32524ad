"""Cross-PROCESS device data-plane measurement.

Two separate OS processes (the multi-process shape: no shared Context,
so the colocated on-card clone cannot apply), one device-resident tile
per size rung crossing rank 0 -> rank 1.  Each rung runs twice:

  bytes     through the PK_DEVICE rendezvous: the producer's lazy d2h at
            serve time, the wire, h2d on the consumer
  transfer  with device.dp_transfer=1: the consumer pulls the producer's
            tile over the CUDA IPC transfer plane (device/cuda.py), no
            bytes on the wire

Emits one JSON line per (tile size, path):
  {"tile_mb": M, "path": .., "path_taken": .., "xfer_ms": t, "gbps": g,
   "d2h_bytes": .., "h2d_bytes": .., "dp_xfer_bytes": .., "dp_errors": ..}

A transfer token has no byte fallback: a transfer rung that moved no
transfer bytes or counted a dp_error is an error row, and any error row
makes the exit status 1.  The plane needs a card; with --device cpu a
transfer rung is such an error row.

    python -m parsec_tpu_torch.tools.bench_dataplane          # all rungs
    python -m parsec_tpu_torch.tools.bench_dataplane --mb 16 --mb 64
    python -m parsec_tpu_torch.tools.bench_dataplane --mb 1 --device cpu

The ranks' base port comes from PTC_PORT, else a free range
(comm/launch.free_port_base).  Each worker sets the comm and plane knobs
in its own environment only.

Port of tools/bench_dataplane.py.
"""
import argparse
import json
import multiprocessing as mp
import os
import sys
import time

import numpy as np


def _prod_kernel(x):
    return x + 1.0


def _cons_kernel(x):
    return x * 1.0


def _worker(rank, nodes, port, mb, reps, q, dev_s, transfer):
    try:
        os.environ["PTC_MCA_comm_eager_limit"] = "65536"
        if transfer:
            os.environ["PTC_MCA_device_dp_transfer"] = "1"
        import parsec_tpu_torch as pt
        from parsec_tpu_torch.device import CudaDevice

        ctx = pt.Context(nb_workers=1)
        ctx.set_rank(rank, nodes)
        ctx.comm_init(port)
        elems = mb * (1 << 20) // 4
        esize = elems * 4
        arr = np.zeros((nodes, elems), dtype=np.float32)
        ctx.register_linear_collection("A", arr, elem_size=esize,
                                       nodes=nodes, myrank=rank)
        ctx.register_arena("t", esize)
        dev = CudaDevice(ctx, device=dev_s)
        k = pt.L("k")
        times = []
        for rep in range(reps + 1):  # rep 0 = warm-up
            tp = pt.Taskpool(ctx, globals={"R": rep})
            prod = tp.task_class("Prod")
            prod.param("k", 0, 0)
            prod.affinity("A", 0)
            cons = tp.task_class("Cons")
            cons.param("k", 0, 0)
            cons.affinity("A", 1)
            prod.flow("X", "RW", pt.In(pt.Mem("A", 0)),
                      pt.Out(pt.Ref("Cons", k, flow="X")))
            cons.flow("X", "R", pt.In(pt.Ref("Prod", k, flow="X")),
                      arena="t")
            cons.flow("Y", "W", pt.Out(pt.Mem("A", 1)), arena="t")
            dev.attach(prod, tp, kernel=_prod_kernel, reads=["X"],
                       writes=["X"], shapes={"X": (elems,)},
                       dtype=np.float32)
            dev.attach(cons, tp, kernel=_cons_kernel, reads=["X"],
                       writes=["Y"], shapes={"X": (elems,), "Y": (elems,)},
                       dtype=np.float32)
            ctx.comm_fence()  # both ranks ready: isolate the transfer
            t0 = time.perf_counter()
            tp.run()
            tp.wait()
            ctx.comm_fence()
            dt = time.perf_counter() - t0
            if rep == 0:
                base = dict(dev.stats)  # exclude the warm-up's traffic
            else:
                times.append(dt)
        end = dict(dev.stats)
        dev.stop()
        ctx.comm_fini()
        ctx.destroy()
        st = {key: (end.get(key, 0) - base.get(key, 0)) / reps
              for key in ("d2h_bytes", "h2d_bytes", "dp_xfer_bytes")}
        st["dp_errors"] = end.get("dp_errors", 0)
        q.put(("ok", rank, min(times), st))
    except Exception:
        import traceback
        q.put(("err", rank, traceback.format_exc(), None))


def run_rung(mb, port, dev_s, reps=3, transfer=False):
    """One rung on a fresh pair of spawned ranks: the row, raising
    RuntimeError when a rank failed."""
    mpctx = mp.get_context("spawn")
    q = mpctx.Queue()
    procs = [mpctx.Process(target=_worker,
                           args=(r, 2, port, mb, reps, q, dev_s, transfer))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        res = [q.get(timeout=600) for _ in range(2)]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    errs = [r for r in res if r[0] != "ok"]
    if errs:
        raise RuntimeError(str(errs))
    wall = max(r[2] for r in res)  # the transfer completes on the slower side
    xfer_b = sum(r[3]["dp_xfer_bytes"] for r in res)
    return {
        "tile_mb": mb,
        "path": "transfer" if transfer else "bytes",
        "path_taken": "transfer" if xfer_b > 0 else "bytes",
        "xfer_ms": round(wall * 1e3, 2),
        "gbps": round(mb / 1024 / wall * 8, 3),
        "d2h_bytes": sum(r[3]["d2h_bytes"] for r in res),
        "h2d_bytes": sum(r[3]["h2d_bytes"] for r in res),
        "dp_xfer_bytes": xfer_b,
        "dp_errors": sum(r[3]["dp_errors"] for r in res),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mb", type=int, action="append", default=None,
                    help="tile MiB (repeatable; default 1, 4, 16, 64)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from parsec_tpu_torch.comm.launch import free_port_base
    from parsec_tpu_torch.tools import torch_device
    dev_s = str(torch_device(args.device))
    env_port = os.environ.get("PTC_PORT")
    failed = 0
    for i, mb in enumerate(args.mb or [1, 4, 16, 64]):
        for transfer in (False, True):
            path = "transfer" if transfer else "bytes"
            port = int(env_port) + 4 * i + 2 * transfer if env_port \
                else free_port_base(2)
            try:
                row = run_rung(mb, port, dev_s, args.reps, transfer)
                if transfer and (row["dp_xfer_bytes"] == 0
                                 or row["dp_errors"] > 0):
                    row = {"tile_mb": mb, "path": path,
                           "error": f"the transfer plane moved "
                                    f"{row['dp_xfer_bytes']} B with "
                                    f"{row['dp_errors']} dp_errors",
                           "row": row}
            except (RuntimeError, OSError) as e:
                row = {"tile_mb": mb, "path": path, "error": str(e)[:300]}
            failed += "error" in row
            print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
