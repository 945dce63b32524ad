"""The per-subsystem debug streams (reference: parsec/utils/debug.c, one
output stream per subsystem with its own verbosity, MCA-selected) on
both packages: debug.runtime, debug.comm and debug.device, resolved as
every knob (file < PTC_MCA_debug_* < set()) and applied to the native
context when it is created.

The runtime and comm lines are the shared native core's; the device
lines are each package's device module's (TpuDevice on JAX's CPU,
CudaDevice(ctx, device="cpu")).  Every case runs its script in a fresh
process from the repo root (cwd and PYTHONPATH), with every
PTC_MCA_debug_* variable of this process removed first, so no level
leaks between cases or into colocated tests."""
import functools
import os
import re
import subprocess
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ["parsec_tpu", "parsec_tpu_torch"]
STREAMS = ("ptc [runtime]:", "ptc [comm]:", "ptc [device]:")

# the reference test's DAG (tests/utils/test_debug_streams.py): NB 3,
# four tasks of one class
RUNTIME = """
import sys
import {pkg} as pt
with pt.Context(nb_workers=1) as ctx:
    tp = pt.Taskpool(ctx, globals={{"NB": 3}})
    tc = tp.task_class("T"); tc.param("k", 0, pt.G("NB")); tc.body_noop()
    tp.run(); tp.wait()
assert "{pkg}" == "parsec_tpu" or "jax" not in sys.modules
print("done")
"""

# the reference test's round trip of the native API; out-of-range ids
# are safe
VERBOSE = """
import {pkg} as pt
from {pkg} import _native as N
with pt.Context(nb_workers=1) as ctx:
    assert N.lib.ptc_context_verbose(ctx._ptr, 1) == 0
    N.lib.ptc_context_set_verbose(ctx._ptr, 1, 2)
    assert N.lib.ptc_context_verbose(ctx._ptr, 1) == 2
    N.lib.ptc_context_set_verbose(ctx._ptr, 99, 1)  # out of range: safe
    assert N.lib.ptc_context_verbose(ctx._ptr, 99) == 0
    assert N.lib.ptc_context_verbose(ctx._ptr, -1) == 0
print("roundtrip ok")
"""

# the levels a new context takes: the registry's (env < set()), per
# context
LEVELS = """
import {pkg} as pt
from {pkg} import _native as N
from {pkg}.utils import params
params.set("debug.device", 3)
with pt.Context(nb_workers=1) as ctx:
    print("levels", [N.lib.ptc_context_verbose(ctx._ptr, i)
                     for i in range(len(N.DBG_SUBSYSTEMS))])
    params.set("debug.comm", 0)
    with pt.Context(nb_workers=1) as ctx2:
        print("second", [N.lib.ptc_context_verbose(ctx2._ptr, i)
                         for i in range(len(N.DBG_SUBSYSTEMS))])
    print("first", [N.lib.ptc_context_verbose(ctx._ptr, i)
                    for i in range(len(N.DBG_SUBSYSTEMS))])
"""

# phase 4's NORM pool at 2 tiles of (16, 32) on each package's device
DEVICE = """
import sys
import numpy as np
x = np.random.default_rng(0).standard_normal((32, 32)).astype(np.float32)
w = np.random.default_rng(1).standard_normal((1, 32)).astype(np.float32)
if "{pkg}" == "parsec_tpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import parsec_tpu as pt
    from parsec_tpu.data import TwoDimBlockCyclic
    from parsec_tpu.device import TpuDevice
    from parsec_tpu.ops.rms_norm import build_rms_norm

    def coll(a, mb, nb):
        c = TwoDimBlockCyclic(a.shape[0], a.shape[1], mb, nb,
                              dtype=np.float32)
        c.from_dense(a)
        return c

    def device(ctx):
        return TpuDevice(ctx)
else:
    import parsec_tpu_torch as pt
    from parsec_tpu_torch.convert import to_collection as coll
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.ops.rms_norm import build_rms_norm

    def device(ctx):
        return CudaDevice(ctx, device="cpu")
with pt.Context(nb_workers=2) as ctx:
    X, W = coll(x, 16, 32), coll(w, 1, 32)
    O = coll(np.zeros_like(x), 16, 32)
    dev = device(ctx)
    tp = build_rms_norm(ctx, X, W, O, dev=dev)
    tp.run(); tp.wait(); dev.flush()
    want = x / np.sqrt((x * x).mean(axis=1, keepdims=True) + 1e-6) * w
    np.testing.assert_allclose(O.to_dense(), want, rtol=2e-5, atol=2e-5)
    print("tasks", dev.stats["tasks"])
    dev.stop()
assert "{pkg}" == "parsec_tpu" or "jax" not in sys.modules
"""

# launched on two ranks by <pkg>.comm.launch: join, run the DAG, then
# comm_fini (its fence, then the FIN handshake: a rank that left right
# after its own fence could cut a peer's fence short)
LAUNCHED = """
import sys
import {pkg} as pt
from {pkg} import comm
with pt.Context(nb_workers=1) as ctx:
    rank, world = comm.init(ctx)
    tp = pt.Taskpool(ctx, globals={{"NB": 3}})
    tc = tp.task_class("T"); tc.param("k", 0, pt.G("NB")); tc.body_noop()
    tp.run(); tp.wait()
    ctx.comm_fini()
# one write: the two ranks share the launcher's pipe
sys.stdout.write(f"rank {{rank}} of {{world}} done\\n")
sys.stdout.flush()
"""


def _env(levels):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PTC_MCA_debug_")
           and k not in ("PTC_RANK", "PTC_WORLD", "PTC_PORT")}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["JAX_PLATFORMS"] = "cpu"
    env.update({f"PTC_MCA_debug_{k}": str(v) for k, v in levels})
    return env


@functools.lru_cache(maxsize=None)
def _run(script, pkg, levels=(), launch=0):
    """(stdout, stderr) of `script` for `pkg` with the debug `levels`
    ((subsystem, level) pairs) in the environment; on `launch` ranks
    through <pkg>.comm.launch when it is non-zero."""
    text = script.format(pkg=pkg)
    if not launch:
        r = subprocess.run([sys.executable, "-c", text], cwd=REPO,
                           env=_env(levels), capture_output=True, text=True,
                           timeout=180)
    else:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "launched.py")
            with open(path, "w") as f:
                f.write(text)
            r = subprocess.run(
                [sys.executable, "-m", f"{pkg}.comm.launch", "-n",
                 str(launch), path], cwd=REPO, env=_env(levels),
                capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout, r.stderr


def _lines(err, stream):
    return [ln for ln in err.splitlines() if ln.startswith(stream)]


@pytest.mark.parametrize("pkg", PKGS)
def test_runtime_stream_off_by_default(pkg):
    _, err = _run(RUNTIME, pkg)
    for s in STREAMS:
        assert s not in err, err


@pytest.mark.parametrize("pkg", PKGS)
def test_runtime_stream_verbose(pkg):
    _, err = _run(RUNTIME, pkg, (("runtime", 1),))
    assert "ptc [runtime]: taskpool 0: 4 local tasks" in err, err
    assert "taskpool 0 complete (0 errors)" in err, err
    # other subsystems stay quiet
    assert "ptc [comm]:" not in err and "ptc [device]:" not in err


def test_runtime_lines_match_reference():
    """The port prints the reference's runtime lines for the same DAG,
    word for word."""
    got = _lines(_run(RUNTIME, "parsec_tpu_torch", (("runtime", 1),))[1],
                 "ptc [runtime]:")
    want = _lines(_run(RUNTIME, "parsec_tpu", (("runtime", 1),))[1],
                  "ptc [runtime]:")
    assert got == want and len(got) == 2, (got, want)


@pytest.mark.parametrize("pkg", PKGS)
def test_verbose_api_roundtrip(pkg):
    out, _ = _run(VERBOSE, pkg)
    assert "roundtrip ok" in out


@pytest.mark.parametrize("pkg", PKGS)
def test_levels_resolve_env_and_set_per_context(pkg):
    """A context takes the env's level (comm 2) and set()'s (device 3,
    over the env's 1); a later set() reaches only contexts created after
    it."""
    out, _ = _run(LEVELS, pkg, (("comm", 2), ("device", 1)))
    assert "levels [0, 2, 3]" in out, out
    assert "second [0, 0, 3]" in out and "first [0, 2, 3]" in out, out


@pytest.mark.parametrize("pkg", PKGS)
def test_device_stream_off_by_default(pkg):
    out, err = _run(DEVICE, pkg)
    assert "tasks 2" in out
    for s in STREAMS:
        assert s not in err, err


def test_device_stream_matches_reference():
    """debug.device=1: the port's CudaDevice(device="cpu") prints its
    'device up' line with the torch device, and after the NORM pool the
    flush line with the reference TpuDevice's count for the same DAG;
    the runtime and comm streams stay quiet."""
    lv = (("device", 1),)
    port = _lines(_run(DEVICE, "parsec_tpu_torch", lv)[1], "ptc [device]:")
    ref = _lines(_run(DEVICE, "parsec_tpu", lv)[1], "ptc [device]:")
    assert len(port) == 2 and len(ref) == 2, (port, ref)
    assert re.fullmatch(r"ptc \[device\]: device up: cpu queue=\d+ "
                        r"cache=\d+MiB batch<= \d+", port[0]), port
    # the same queue, cache budget and batch cap as the reference's line
    assert port[0].split(" queue=")[1] == ref[0].split(" queue=")[1]
    assert port[1] == ref[1] == "ptc [device]: flush: 2 dirty mirrors"
    for pkg in PKGS:
        err = _run(DEVICE, pkg, lv)[1]
        assert "ptc [runtime]:" not in err and "ptc [comm]:" not in err


@pytest.mark.parametrize("pkg", PKGS)
def test_comm_stream_on_the_launcher(pkg):
    """debug.comm=1 on the two-rank SPMD launcher: each rank prints its
    mesh line at comm init and its fence line; the runtime stays quiet."""
    out, err = _run(LAUNCHED, pkg, (("comm", 1),), launch=2)
    assert "rank 0 of 2 done" in out and "rank 1 of 2 done" in out
    for r in (0, 1):
        assert f"ptc [comm]: rank {r}/2 mesh connected (transport tcp" \
            in err, err
    assert len(_lines(err, "ptc [comm]: fence quiesced at round")) == 2
    assert "ptc [runtime]:" not in err and "ptc [device]:" not in err


def test_comm_lines_match_reference():
    """The port's ranks print the reference's comm lines."""
    lv = (("comm", 1),)
    got = sorted(_lines(_run(LAUNCHED, "parsec_tpu_torch", lv, launch=2)[1],
                        "ptc [comm]:"))
    want = sorted(_lines(_run(LAUNCHED, "parsec_tpu", lv, launch=2)[1],
                         "ptc [comm]:"))
    assert got == want, (got, want)
