"""Transfer-economics harness (reference roles: tests/apps/pingpong/
bandwidth.jdf for the transport, tools/gpu/testbandwidth for the device
staging path): the card's fit of what a transfer costs.

Two SPMD processes over loopback TCP run rank-hopping RW chains whose
datum is a tile of the given size; every hop is one full cross-rank
payload transfer.  ONE persistent process pair serves an entire path
sweep -- all sizes and reps share the TCP mesh and the device -- so the
numbers measure steady-state per-transfer cost, with the first (warm-up)
rep's wall reported separately as `setup_ms`.

Paths swept (each in its own process pair, selected by env knobs):
  eager   -- payloads ride inline in ACTIVATE frames (eager_limit huge)
  rdv     -- every payload pulled via GET rendezvous (eager_limit 0);
             payloads above comm.chunk_size stream as pipelined chunks
  device  -- a CudaDevice on the card attached (x + 1 a hop): payloads
             ride the PK_DEVICE device data plane (d2h at serve, h2d at
             deliver); `--device cpu` runs it on the host

Per path the harness fits  t(size) = fixed_overhead + size * per_byte
by least squares over the per-size minima (comm/economics.fit_points)
and reports both legs, with the engine's own adaptive calibration from
a dedicated eager_limit=auto run.  `--classed` (or `--classes ici,dcn`)
re-runs the wire paths per link class (dcn emulated with the per-peer
fault delay map, `--dcn-delay-us` a recv) under doc["classes"].

The document (`--json PATH`, else printed) has exactly the shape
TransferEconomics.load reads: point coll.econ_path at it, or pass
TransferEconomics.load(PATH) as `econ=`, to price transfers with the
card's own fit.  Exit status 1 when a path failed (its entry holds the
error).

    python -m parsec_tpu_torch.tools.testbandwidth       # full sweep
    python -m parsec_tpu_torch.tools.testbandwidth --paths device \\
        --sizes 4194304
    python -m parsec_tpu_torch.tools.testbandwidth --quick --json comm.json
    python -m parsec_tpu_torch.tools.testbandwidth --quick --classed

`--device` alone keeps the reference's spelling for "the device path
only"; `--device cpu` (or cuda:N) names the device path's torch device.
The ranks' ports come from PTC_PORT, else a free range
(comm/launch.free_port_base); each worker sets its path's knobs in its
own environment only.

Port of tools/testbandwidth.py.
"""
import argparse
import itertools
import json
import multiprocessing as mp
import os
import sys
import time

import numpy as np

from parsec_tpu_torch.comm.economics import fit_points

_PATH_ENV = {
    # eager: everything inline (rendezvous never engages)
    "eager": {"PTC_MCA_comm_eager_limit": str(1 << 30)},
    # rdv: everything pulled (chunked above comm.chunk_size)
    "rdv": {"PTC_MCA_comm_eager_limit": "0"},
    # device: rendezvous forced so device-resident payloads advertise
    # PK_DEVICE transfer tags
    "device": {"PTC_MCA_comm_eager_limit": "0"},
}


def _bump(x):
    return x + 1.0


def _worker(rank, port, sizes, hops, reps, path, env, dev_s, q):
    try:
        for k, v in env.items():
            os.environ[k] = v
        import parsec_tpu_torch as pt

        ctx = pt.Context(nb_workers=1)
        ctx.set_rank(rank, 2)
        ctx.comm_init(port)
        dev = None
        if path == "device":
            from parsec_tpu_torch.device import CudaDevice
            dev = CudaDevice(ctx, device=dev_s)
        k = pt.L("k")
        out = []
        for si, size in enumerate(sizes):
            elems = max(1, size // 4)
            arr = np.zeros((2, elems), dtype=np.float32)
            ctx.register_linear_collection(f"A{si}", arr, elem_size=size,
                                           nodes=2, myrank=rank)
            ctx.register_arena(f"t{si}", size)

            def build():
                tp = pt.Taskpool(ctx, globals={"NB": hops})
                tc = tp.task_class("Hop")
                tc.param("k", 0, pt.G("NB"))
                tc.affinity(f"A{si}", k % 2)
                tc.flow("A", "RW",
                        pt.In(pt.Mem(f"A{si}", 0), guard=(k == 0)),
                        pt.In(pt.Ref("Hop", k - 1, flow="A")),
                        pt.Out(pt.Ref("Hop", k + 1, flow="A"),
                               guard=(k < pt.G("NB"))),
                        arena=f"t{si}")
                if dev is not None:
                    dev.attach(tc, tp, kernel=_bump, reads=["A"],
                               writes=["A"], shapes={"A": (elems,)},
                               dtype=np.float32)
                else:
                    tc.body_noop()
                return tp

            walls = []
            for rep in range(reps + 1):  # rep 0 = setup (reported apart)
                tp = build()
                ctx.comm_fence()  # both ranks ready: isolate the chain
                t0 = time.perf_counter()
                tp.run()
                tp.wait()
                ctx.comm_fence()
                walls.append(time.perf_counter() - t0)
            out.append({"size_bytes": size, "setup_ms": walls[0] * 1e3,
                        "walls": walls[1:]})
        tuning = ctx.comm_tuning()
        dstats = dict(dev.stats) if dev is not None else None
        if dev is not None:
            dev.stop()
        ctx.comm_fini()
        ctx.destroy()
        q.put(("ok", rank, out, tuning, dstats))
    except Exception:
        import traceback
        q.put(("err", rank, traceback.format_exc(), None, None))


def run_path(path, sizes, hops, reps, port, dev_s, extra_env=None):
    """Sweep all `sizes` on one persistent 2-process pair; returns the
    path's report dict (latencies, setup costs, fit, tunables)."""
    env = dict(_PATH_ENV[path])
    env.update(extra_env or {})
    mpctx = mp.get_context("spawn")
    q = mpctx.Queue()
    procs = [mpctx.Process(target=_worker,
                           args=(r, port, sizes, hops, reps, path, env,
                                 dev_s, q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        res = [q.get(timeout=900) for _ in range(2)]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    errs = [r for r in res if r[0] != "ok"]
    if errs:
        raise RuntimeError(str(errs))
    # per size: the transfer completes on the slower side
    by_rank = {r[1]: r for r in res}
    rows, points = [], []
    for si, size in enumerate(sizes):
        walls = [max(by_rank[0][2][si]["walls"][i],
                     by_rank[1][2][si]["walls"][i])
                 for i in range(len(by_rank[0][2][si]["walls"]))]
        per_transfer = [w / hops for w in walls]
        best = min(per_transfer)
        rows.append({
            "size_bytes": size,
            "setup_ms": round(max(by_rank[0][2][si]["setup_ms"],
                                  by_rank[1][2][si]["setup_ms"]), 2),
            "per_transfer_ms": round(best * 1e3, 3),
            "per_transfer_ms_all": [round(t * 1e3, 3)
                                    for t in per_transfer],
            "gbps": round(size * 8 / best / 1e9, 3),
        })
        points.append((size, best))
    return {
        "sizes": rows,
        "fit": fit_points(points),
        "tunables": by_rank[0][3],
        "device_stats": by_rank[0][4],
    }


def run_adaptive_probe(port, dev_s):
    """One tiny eager_limit=auto job, reported so every sweep records
    what threshold the engine would derive on this host (the measured
    RTT and memcpy legs come back via comm_tuning)."""
    rep = run_path("eager", [4096], hops=8, reps=1, port=port, dev_s=dev_s,
                   extra_env={"PTC_MCA_comm_eager_limit": "auto"})
    t = rep["tunables"]
    return {"derived_eager_limit": t["eager_limit"],
            "rtt_ns": t["rtt_ns"], "memcpy_bps": t["memcpy_bps"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="sizes 4 KiB and 64 KiB, 8 hops, 2 reps")
    ap.add_argument("--hops", type=int, default=None)
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--paths", default=None,
                    help="comma-separated subset of eager,rdv,device")
    ap.add_argument("--sizes", default=None,
                    help="comma-separated tile sizes in bytes")
    ap.add_argument("--device", nargs="?", const="", default=None,
                    help="alone: the device path only; with a value: the "
                         "device path's torch device (default: the card)")
    ap.add_argument("--json", default=None, metavar="PATH")
    ap.add_argument("--classed", action="store_true")
    ap.add_argument("--classes", default=None)
    ap.add_argument("--dcn-delay-us", type=int, default=150)
    args = ap.parse_args(argv)

    sizes = [4096, 65536] if args.quick else [65536, 1048576, 4194304]
    hops = args.hops or (8 if args.quick else 16)
    reps = args.reps or (2 if args.quick else 3)
    paths = ["eager", "rdv", "device"]
    if args.device == "":
        paths = ["device"]
    if args.paths:
        paths = args.paths.split(",")
    if args.sizes:
        sizes = [int(x) for x in args.sizes.split(",")]
    dev_s = "cuda"
    kind = None
    if "device" in paths:
        from parsec_tpu_torch.tools import device_kind, torch_device
        dev = torch_device(args.device or "cuda")
        dev_s, kind = str(dev), device_kind(dev)
    from parsec_tpu_torch.comm.launch import free_port_base
    env_port = os.environ.get("PTC_PORT")
    pairs = itertools.count()

    def port():
        """A base port for the next process pair."""
        i = next(pairs)
        return int(env_port) + 4 * i if env_port else free_port_base(2)

    from parsec_tpu_torch.tools import host_provenance
    doc = {
        "bench": "transfer_economics",
        "when": time.strftime("%Y-%m-%d %H:%M:%S"),
        **host_provenance(threads=2 * 2),
        "meta": {"hops": hops, "reps": reps, "sizes": sizes,
                 "nodes": 2,
                 "platform": ("cuda" if dev_s.startswith("cuda")
                              else "cpu-loopback"),
                 "device_kind": kind},
        "paths": {},
    }
    failed = 0
    try:
        doc["adaptive_eager"] = run_adaptive_probe(port(), dev_s)
    except RuntimeError as e:
        doc["adaptive_eager"] = {"error": str(e)[:300]}
        failed += 1
    for path in paths:
        try:
            doc["paths"][path] = run_path(path, sizes, hops, reps, port(),
                                          dev_s)
        except RuntimeError as e:
            doc["paths"][path] = {"error": str(e)[:300]}
            failed += 1
        print(json.dumps({path: doc["paths"][path]}), flush=True)
    # the classed sweep: the wire paths again, once per link class.  ici
    # = the plain loopback wire; dcn = the same wire under the per-peer
    # fault delay map.  The device path is skipped: staging is
    # class-independent.
    if args.classed or args.classes:
        cls_list = [c for c in (args.classes or "ici,dcn").split(",") if c]
        dcn_us = args.dcn_delay_us
        doc["meta"]["dcn_delay_us"] = dcn_us
        doc["classes"] = {}
        for cls_name in cls_list:
            extra = {}
            if cls_name == "dcn":
                extra = {"PTC_COMM_FAULT_DELAY_MAP":
                         f"0:{dcn_us},1:{dcn_us}"}
            doc["classes"][cls_name] = {}
            for path in paths:
                if path == "device":
                    continue
                try:
                    doc["classes"][cls_name][path] = run_path(
                        path, sizes, hops, reps, port(), dev_s,
                        extra_env=extra)
                except RuntimeError as e:
                    doc["classes"][cls_name][path] = \
                        {"error": str(e)[:300]}
                    failed += 1
                print(json.dumps(
                    {f"{cls_name}.{path}":
                     doc["classes"][cls_name][path]}), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {args.json}", file=sys.stderr)
    else:
        print(json.dumps(doc), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
