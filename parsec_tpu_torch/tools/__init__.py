"""The repo's tools on the port: one module per tool of tools/, under the
same file stem, each run as

    python -m parsec_tpu_torch.tools.<stem> [arguments]

with the reference tool's flags, exit codes and output (text, JSON keys
and values).  Each has main(argv=None) -> int and imports torch and this
package only, nothing of JAX or parsec_tpu.

Static tools (verify_graphs, ptc_verify, jdf2dot, plan_graphs, ptc_plan,
ptc_tune), the trace readers (ptt_info, ptt2tables, ptt2dot,
ptt_critpath) and ptc_postmortem touch no device.  The card probes
(probe_la_kernels, probe_launch_overhead, bench_dtd_gemm,
bench_dataplane, testbandwidth) take `--device` (default "cuda": the
card, raising without one; "cpu" runs the plain versions on the host).

This module holds what several tools share: the throwaway compile of a
.jdf target, the device choice, the timing of a call on its device and
the host provenance of a measurement document.
"""
from __future__ import annotations

import contextlib
import os
import platform
import sys
import time

import numpy as np


def parse_globals(pairs) -> dict:
    """`--global NAME=VALUE` pairs -> {NAME: int}, with the tools'
    defaults NB = N = 10."""
    globs = {}
    for g in pairs:
        k, v = g.split("=", 1)
        globs[k.strip()] = int(v)
    globs.setdefault("NB", 10)
    globs.setdefault("N", 10)
    return globs


@contextlib.contextmanager
def jdf_program(path: str, src: str, globs: dict, collection: str,
                size: int):
    """Compile the JDF source `src` (from `path`), never executed, in a
    one-worker Context over a throwaway int64 collection of `size`
    elements bound to `collection` and a "default" arena; yields the
    compiled builder while the Context is open."""
    import parsec_tpu_torch as pt
    from parsec_tpu_torch.dsl.jdf import compile_jdf
    with pt.Context(nb_workers=1) as ctx:
        buf = np.zeros(size, dtype=np.int64)
        ctx.register_linear_collection(collection, buf, elem_size=8)
        ctx.register_arena("default", 64)
        yield compile_jdf(src, ctx, globals=globs, dtype=np.int64,
                          arenas={"A": "default"},
                          filename=os.path.basename(path))


def torch_device(name: str):
    """The torch device a card tool runs on: "cuda" (the default) needs
    a card and raises without one; there is no fallback to the CPU."""
    import torch
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"no CUDA device is available for --device {name}; pass "
                "--device cpu to run the plain versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return dev


def device_kind(dev) -> str:
    """The card's name (torch.cuda.get_device_name), "cpu" on the host."""
    import torch
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def median_s(fn, dev, reps: int = 5) -> float:
    """Median seconds of `reps` calls of fn() after one untimed call: CUDA
    events around each call on the card, the host clock on the CPU."""
    import torch
    fn()
    sync(dev)
    ts = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def host_provenance(threads=None) -> dict:
    """Host provenance and the oversubscription flag of a measurement
    document (the keys of the reference's bench.host_provenance):
    `threads` runtime threads kept busy against the host's cores."""
    from parsec_tpu_torch.analysis.tune import host_fingerprint
    cpus = os.cpu_count() or 1
    doc = {"host": {"cpu_count": cpus, "platform": sys.platform,
                    "machine": platform.machine(),
                    "fingerprint": host_fingerprint()}}
    if threads is not None:
        doc["pipeline_threads"] = threads
        doc["oversubscribed"] = threads > cpus
    return doc
