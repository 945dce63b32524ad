"""The device suite's prefetch lane under load: for each side, `--runs`
runs of the device suite, `--copies` processes at once, the sides in
turns (A B B A ...); per side, the runs with no prefetch-hit wave, the
runs that miss tests/test_torch_bench.py::test_device_suite_schema's
load-dependent assertions, and each run's hit waves, prefetched wall
and dispatch-time h2d stall.

    python -m parsec_tpu_torch.bench.lane_load --side port --side ref \\
        --runs 30 --copies 10                  # on the host, 10 at once
    python -m parsec_tpu_torch.bench.lane_load --side port=build/parent \\
        --side port --runs 3 --copies 1 --device cuda --defaults

A side is `port` (python -m parsec_tpu_torch.bench --device ...
--device DEVICE) or `ref` (the reference's bench.py --device, under JAX
on the CPU: a host with JAX only), and `=DIR` runs it from another
checkout (a `git archive` of another commit under build/).  The suite
runs at the test's flags (24 tiles of 4096 floats in waves of 4, one
rep, the out-of-core GEMM at 128/32/16) unless `--defaults` gives it
its own.  Prints one JSON line per run and, last, one per side.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TEST_FLAGS = ["--tiles", "24", "--elems", "4096", "--batch", "4", "--reps",
              "1", "--gemm-m", "128", "--gemm-k", "32", "--gemm-mb", "16"]


def _one(side: str, device: str, flags: list, tmp: str, i: int) -> dict:
    """One run of the device suite on `side`: its document's lane rows."""
    pkg, _, tree = side.partition("=")
    cwd = os.path.abspath(tree or REPO)
    out = os.path.join(tmp, f"{i}.json")
    env = dict(os.environ, PTC_MCA_tune_cache_path=out + ".tuned")
    if pkg == "ref":
        env["JAX_PLATFORMS"] = "cpu"
        cmd = [sys.executable, "bench.py", "--device", "--json", out, *flags]
    else:
        cmd = [sys.executable, "-m", "parsec_tpu_torch.bench", "--device",
               "--json", out, *flags, "--device", device]
    r = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=900)
    row = {"side": side, "run": i, "rc": r.returncode}
    if r.returncode:
        row["err"] = r.stderr[-400:]
        return row
    with open(out) as f:
        doc = json.load(f)
    wp = doc["wave_pipeline"]
    pf, st = wp["prefetched"], wp["staged"]
    g = doc["out_of_core_gemm"]
    row.update(
        hit_waves=pf["prefetch_hit_waves"], waves=pf["waves"],
        pf_wall_ms=pf["wall_s"] * 1e3, pf_stall_ms=pf["stall_total_ms"],
        staged_wall_ms=st["wall_s"] * 1e3,
        staged_stall_ms=st["stall_total_ms"],
        reduction=wp["hit_wave_stall_reduction"], spills=g["spills"],
        bit_identical=doc["wave_fuse"]["bit_identical"])
    # the test's assertions that the load can move
    row["test_ok"] = bool(
        st["stall_total_ms"] > 0 and pf["prefetch_hit_waves"] > 0
        and row["reduction"] is not None and row["reduction"] >= 0.8
        and g["spills"] > 0 and row["bit_identical"])
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="parsec_tpu_torch.bench.lane_load")
    ap.add_argument("--side", action="append", required=True,
                    help="port or ref, optionally =DIR (another checkout)")
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--copies", type=int, default=10)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (the reference runs on the CPU)")
    ap.add_argument("--defaults", action="store_true",
                    help="the suite's own sizes, not the test's flags")
    args = ap.parse_args(argv)
    flags = [] if args.defaults else TEST_FLAGS
    # the sides in turns: A B, then B A, ...
    jobs = [(side, i) for i in range(args.runs)
            for side in (args.side if i % 2 == 0 else args.side[::-1])]
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {side: os.path.join(tmp, str(k))
                for k, side in enumerate(args.side)}
        for d in dirs.values():
            os.makedirs(d)
        with ThreadPoolExecutor(args.copies) as pool:
            rows = list(pool.map(
                lambda j: _one(j[0], args.device, flags, dirs[j[0]], j[1]),
                jobs))
    for row in rows:
        print(json.dumps(row))
    for side in args.side:
        ok = [r for r in rows if r["side"] == side and r["rc"] == 0]
        print(json.dumps({
            "side": side, "runs": sum(r["side"] == side for r in rows),
            "failed": sum(r["side"] == side and r["rc"] != 0 for r in rows),
            "zero_hit_runs": sum(r["hit_waves"] == 0 for r in ok),
            "test_misses": sum(not r["test_ok"] for r in ok),
            "hit_waves": sorted(r["hit_waves"] for r in ok),
            "pf_wall_ms": [round(r["pf_wall_ms"], 1) for r in ok],
            "pf_stall_ms": [r["pf_stall_ms"] for r in ok]}))
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
