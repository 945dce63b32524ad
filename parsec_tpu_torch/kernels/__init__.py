"""Hand-written Hopper kernels: build, load and launch counts.

Each `<name>.cu` here is a CUDA C++ kernel for sm_90a with a plain C
entry point.  `load(name)` builds it at first use with nvcc into
build/torch_kernels/ (one shared library per source, named by a hash of
the source and flags, written atomically so concurrent builders cannot
tear it) and loads it with ctypes.  `build_all()` starts one nvcc per
source, all at once.  Nothing is built when this module is imported.

`LAUNCHES[name]` counts the launches of each kernel; a wrapper adds one
(`count_launch`, safe across threads: colocated ranks launch from the
threads of one process) where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
BUILD_DIR = os.path.join(_REPO, "build", "torch_kernels")
SOURCES = ("rms_norm", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


_COUNT_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def source_path(name: str) -> str:
    return os.path.join(_HERE, f"{name}.cu")


def _target(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set NVCC or put the CUDA toolkit on PATH)")


def _start(name: str):
    """Start nvcc for one source; None when its library is built."""
    out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    with open(out + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> Dict[str, str]:
    """Build every kernel library that is missing, one nvcc per source
    running in parallel; returns name -> the ptxas report (-v)."""
    jobs = {name: _start(name) for name in SOURCES}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
    reports = {}
    for name in SOURCES:
        with open(_target(name) + ".log") as f:
            reports[name] = f.read()
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(_target(name))
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise on a launch the runtime refused (the C entry returns
    cudaGetLastError() right after its launch)."""
    if rc != 0:
        err = lib.ptc_cuda_error_string
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
