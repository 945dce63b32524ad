"""The port's concurrency soak (parsec_tpu_torch.tools.stress_tsan) held
against the reference's, tools/stress_tsan.py, on the CPU.

Each of the 15 jobs runs on both packages in this process at main's
sizes, every call main makes of it in one rep (ep_burst and chain_mesh
under each scheduler, chain_mesh under both magazine batches,
colocated_comm under its three environments), the device jobs on
CudaDevice(ctx, device="cpu") against TpuDevice on the JAX CPU backend.
Every job asserts its own checks on each package.  Where a job computes
a result from the same seed on both packages, the two are held to each
other with the reference's own check as the tolerance: wave_fuse_gemm's
C tiles at 2e-3, tp_decode_churn's tokens bit for bit.  The reference's
jobs get free ports here: its main binds fixed ones, so it is never
called.

The slow test builds the ThreadSanitizer core (make tsan) and runs the
port's main under it at STRESS_REPS=1 with the port's suppressions."""
import importlib.util
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from parsec_tpu_torch.comm.launch import free_port_base
from parsec_tpu_torch.tools import stress_tsan as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES = {"colocated_hier_coll": 4}


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "_ref_stress_tsan", os.path.join(REPO, "tools", "stress_tsan.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_call(ref, name, kwargs, env):
    """One call of the reference's job, with a free port range where it
    takes one."""
    fn = getattr(ref, name)
    kw = dict(kwargs)
    if "port" in inspect.signature(fn).parameters:
        kw["port"] = free_port_base(NODES.get(name, 2))
    with S.environ(env):
        return fn(**kw)


def _recording_gemm_c(monkeypatch):
    """Record the reference's C matrices (wave_fuse_gemm imports
    TwoDimBlockCyclic from parsec_tpu.data.collections when it runs)."""
    import parsec_tpu.data.collections as colls
    seen = []

    class Recording(colls.TwoDimBlockCyclic):
        def register(self, ctx, name, *a, **kw):
            if name == "C":
                seen.append(self)
            return super().register(ctx, name, *a, **kw)

    monkeypatch.setattr(colls, "TwoDimBlockCyclic", Recording)

    def tiles():
        return {(m, n): np.array(c.tile(m, n)) for c in seen
                for m in range(c.mt) for n in range(c.nt)
                if c.rank_of(m, n) == c.myrank}
    return tiles


def _recording_engines(monkeypatch):
    """Record each reference InferenceEngine's requests (tp_decode_churn
    imports InferenceEngine from parsec_tpu.serve when it runs)."""
    import parsec_tpu.serve as serve
    handles = []

    class Recording(serve.InferenceEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            handles.append([])
            self._recorded = handles[-1]

        def submit(self, *a, **kw):
            h = super().submit(*a, **kw)
            self._recorded.append(h)
            return h

    monkeypatch.setattr(serve, "InferenceEngine", Recording)
    return lambda: [[list(h.tokens) for h in hs] for hs in handles]


def test_calls_cover_every_job_with_the_reference_arguments(ref):
    """CALLS holds the reference main's calls: every job, each with the
    reference's argument names."""
    assert set(S.JOBS) == {n for n, _, _ in S.CALLS}
    assert len(S.JOBS) == 15
    for name, fn in S.JOBS.items():
        ref_params = inspect.signature(getattr(ref, name)).parameters
        params = inspect.signature(fn).parameters
        extra = {"device"} if name in S.DEVICE_JOBS else set()
        assert set(params) == set(ref_params) | extra, name
    assert [n for n, _, _ in S.CALLS].count("chain_mesh") == 6
    assert [n for n, _, _ in S.CALLS].count("colocated_comm") == 3


@pytest.mark.parametrize("name", sorted(S.JOBS))
def test_job_matches_reference(name, ref, monkeypatch):
    calls = [(kw, env) for n, kw, env in S.CALLS if n == name]
    ref_gemm = _recording_gemm_c(monkeypatch) \
        if name == "wave_fuse_gemm" else None
    ref_tokens = _recording_engines(monkeypatch) \
        if name == "tp_decode_churn" else None
    before = dict(os.environ)
    for kw, env in calls:
        got = S.run_call(name, kw, env, device="cpu")
        # every PTC_MCA_* variable a job set is restored
        assert dict(os.environ) == before
        _ref_call(ref, name, kw, env)
    if ref_gemm is not None:
        want = ref_gemm()
        assert sorted(got) == sorted(want)
        assert len(got) == (32 // 8) ** 2
        for mn, tile in got.items():
            assert np.abs(tile - want[mn]).max() < 2e-3, mn
    if ref_tokens is not None:
        want = ref_tokens()
        assert len(want) == 2 and len(got) == 2
        assert sorted(got.values()) == sorted(want)
        assert got[0] == got[1]


def test_main_reps_and_verdict(monkeypatch, capsys):
    """main runs CALLS STRESS_REPS times, a line per job and per rep on
    stderr, then "stress ok"; here over two small jobs."""
    monkeypatch.setattr(S, "CALLS", [
        ("ep_burst", {"sched": "lws", "workers": 2, "n": 100}, None),
        ("chain_mesh", {"sched": "lws", "workers": 2, "nb": 8, "lanes": 2},
         {"PTC_MCA_runtime_mag_batch": "4"})])
    monkeypatch.setenv("STRESS_REPS", "2")
    assert S.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out.splitlines() == ["stress ok"]
    lines = err.splitlines()
    assert [ln.split()[1] for ln in lines if ln.startswith("job ")] == \
        ["ep_burst", "chain_mesh"] * 2
    assert [ln for ln in lines if ln.startswith("rep ")] == \
        ["rep 1/2 done", "rep 2/2 done"]
    assert "PTC_MCA_runtime_mag_batch" not in os.environ


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_main_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.main([])


@pytest.mark.slow
def test_soak_under_thread_sanitizer():
    """make tsan, then the port's soak at STRESS_REPS=1 on the
    instrumented core with the port's suppressions: exit 0, "stress ok",
    no ThreadSanitizer report."""
    subprocess.run(["make", "-s", "tsan"], cwd=REPO, check=True,
                   timeout=600)
    tsan = subprocess.run(["g++", "-print-file-name=libtsan.so"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    supp = os.path.join(REPO, "parsec_tpu_torch", "tools", "tsan.supp")
    env = dict(os.environ,
               PTC_NATIVE_LIB=os.path.join(REPO, "build",
                                           "libparsec_core_tsan.so"),
               LD_PRELOAD=tsan, STRESS_REPS="1",
               TSAN_OPTIONS=f"suppressions={supp} exitcode=66 "
                            "report_thread_leaks=0")
    r = subprocess.run([sys.executable, "-m",
                        "parsec_tpu_torch.tools.stress_tsan", "--device",
                        "cpu"], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=1800)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-8000:])
    assert r.stdout.splitlines()[-1] == "stress ok"
    assert "WARNING: ThreadSanitizer" not in r.stderr, r.stderr[-8000:]
