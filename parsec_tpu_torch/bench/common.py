"""What the bench suites share: argument reading, the device choice, the
card's memory and rate, and the one-line/JSON-document output.

The port's counterpart of bench.py's helpers (`_arg_after`,
`_arg_str_after`, `_device_hbm`, `_spotrf_fits`, `_chip_info`).  The
card's name comes from torch, its power limit from nvidia-smi, its f32
matmul rate from measured 4096^2 products with TF32 off (CUDA events),
its memory from torch.cuda.mem_get_info.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from ..tools import host_provenance, torch_device  # noqa: F401

# device names `--device NAME` takes as the device choice; any other
# `--device` selects the device suite (bench.py's spelling)
_DEVICE_NAMES = ("cpu", "cuda")


def is_device_name(arg: str) -> bool:
    return arg.split(":", 1)[0] in _DEVICE_NAMES


def device_choice(argv) -> str:
    """The device a suite runs on: the NAME of the first `--device NAME`
    (cpu, cuda, cuda:N), the card ("cuda") when there is none."""
    for i, a in enumerate(argv[:-1]):
        if a == "--device" and is_device_name(argv[i + 1]):
            return argv[i + 1]
    return "cuda"


def device_suite_selected(argv) -> bool:
    """True when some `--device` is not followed by a device name: the
    reference's flag for the device suite."""
    return any(a == "--device" and
               (i + 1 == len(argv) or not is_device_name(argv[i + 1]))
               for i, a in enumerate(argv))


def _arg_after(flag, default, argv=None):
    argv = sys.argv if argv is None else argv
    if flag in argv:
        return int(argv[argv.index(flag) + 1])
    return default


def _arg_str_after(flag, default, argv=None):
    argv = sys.argv if argv is None else argv
    if flag in argv:
        return argv[argv.index(flag) + 1]
    return default


def _device_hbm(dev) -> int:
    """Usable device memory in bytes: the card's total memory
    (torch.cuda.mem_get_info), or the host's physical memory on the
    CPU."""
    import torch
    dev = torch.device(dev)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _spotrf_fits(n: int, hbm_bytes: int):
    """(fits, need_gib) for an fp32 spotrf rung: the matrix plus the
    device tile cache is ~2x the matrix, plus slack."""
    need = 2.2 * n * n * 4
    return need <= hbm_bytes, need / 2 ** 30


def power_limit_w():
    """The card's power limit in watts as nvidia-smi reports it, None
    where there is no nvidia-smi or it fails."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    if r.returncode != 0 or not r.stdout.strip():
        return None
    field = r.stdout.strip().splitlines()[0].rsplit(",", 1)[-1].strip()
    try:
        return float(field.split()[0])
    except (ValueError, IndexError):
        return None


def _chip_info(device="cuda"):
    """(kind, measured fp32 matmul GFLOP/s, power limit W) of the device
    a suite runs on: torch.cuda.get_device_name and nvidia-smi's power
    limit on the card, with the best of 3 batches of 8 4096^2 float32
    products after 4 untimed ones (an idle card ramps its clocks up
    under load), CUDA events, TF32 off (the reference read a scalar
    back through its tunnel); on the CPU "cpu", 1024^2 products on the
    host clock, and no power limit."""
    import torch
    dev = torch_device(str(device))
    on_card = dev.type == "cuda"
    n, reps = (4096, 8) if on_card else (1024, 2)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a = torch.ones((n, n), dtype=torch.float32, device=dev)
        for _ in range(4):  # settle
            x = a @ a
        best = None
        for _ in range(3):
            if on_card:
                torch.cuda.synchronize(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    x = a @ a
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                for _ in range(reps):
                    x = a @ a
                dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        del x
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    return kind, reps * 2 * n ** 3 / best / 1e9, \
        (power_limit_w() if on_card else None)


def spawn_ranks(target, args_of, nranks: int = 2, timeout: float = 900):
    """Spawn `nranks` processes running target(*args_of(rank), q), each
    putting ("ok", rank, ...) or ("err", rank, traceback) on q; returns
    the results by rank, raising with the failed ranks' tracebacks."""
    import multiprocessing as mp
    mpctx = mp.get_context("spawn")
    q = mpctx.Queue()
    procs = [mpctx.Process(target=target, args=(*args_of(r), q))
             for r in range(nranks)]
    for p in procs:
        p.start()
    try:
        res = [q.get(timeout=timeout) for _ in range(nranks)]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    errs = [r for r in res if r[0] != "ok"]
    if errs:
        raise RuntimeError(str(errs))
    return {r[1]: r for r in res}


def write_doc(doc: dict, out) -> None:
    """Write a suite's document to `out` (its directory made), and say
    so on stderr; nothing without `out`."""
    if not out:
        return
    d = os.path.dirname(os.path.abspath(out))
    os.makedirs(d, exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    sys.stderr.write(f"wrote {out}\n")
