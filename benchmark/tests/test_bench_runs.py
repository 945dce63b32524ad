"""Whole runs of the cells on the host at small sizes: the run's result
line, a cell, configuration and metric added by new files alone, and
`correct` coming out false under each fault a cell can have."""
import json
import os
import shutil
import time

import pytest
import torch

import parsec_tpu_torch.algos.gemm as gemm_mod
import parsec_tpu_torch.algos.potrf as potrf_mod
from harness import core
from parsec_tpu_torch.device import CudaDevice

CELLS = ("spotrf.panel", "spotrf.tile", "sgemm.ptg", "sgemm.dtd")


def _run(root, cell, trace=False, seed=2 ** 31 + 77, seconds=0.5):
    return core.run_cell(core.Cell(root, cell), seed, seconds, trace, "cpu",
                         time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_and_is_correct(small, cell):
    r = _run(small, cell)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s", "gflops"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", ["spotrf.panel", "sgemm.dtd"])
def test_a_traced_run_reports_the_per_layer_metrics(small, cell):
    r = _run(small, cell, trace=True)
    assert r["correct"] is True
    got = set(r["metrics"])
    # on the host there is no CUDA timeline: the device's readers and the
    # peak-based shares stay silent, every other one reads
    want = {"tasks_per_solve", "dag_build_ms", "host_retire_ms",
            "launches_per_solve", "h2d_stall_ms", "device_drain_ms"}
    if cell != "sgemm.dtd":
        want.add("fused_waves_per_solve")
    assert got == want
    tasks = {"spotrf.panel": 36, "sgemm.dtd": 64}[cell]
    assert r["metrics"]["tasks_per_solve"]["value"] == tasks
    assert r["device"]["window_s"] > 0


def test_add_a_cell_config_and_metric_by_new_files(small):
    """A further configuration (a second spotrf deployment), a cell on it
    and a per-layer metric, from new files only: the harness runs them
    with no existing file edited."""
    bench = os.path.join(small, "benchmark")
    with open(os.path.join(bench, "configs", "spotrf.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "dpotrf_like"
    with open(os.path.join(bench, "configs", "dpotrf_like.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(bench, "reference", "spotrf.py"),
                os.path.join(bench, "reference", "dpotrf_like.py"))
    with open(os.path.join(bench, "workloads", "spotrf.tile.json")) as f:
        w = json.load(f)
    w["N"] = 512
    with open(os.path.join(bench, "workloads", "dpotrf_like.tile.json"),
              "w") as f:
        json.dump(w, f)
    with open(os.path.join(bench, "metrics", "solves_in_window.py"),
              "w") as f:
        f.write("def read(run):\n    return float(run.n_solves)\n")
    path = os.path.join(small, "BENCHMARK.json")
    with open(path) as f:
        m = json.load(f)
    m["configs"].append({"name": "dpotrf_like", "source": "x",
                         "file": "benchmark/configs/dpotrf_like.json",
                         "reduced": ["N"], "why": "x"})
    m["workloads"].append({"name": "dpotrf_like.tile",
                           "config": "dpotrf_like", "traffic": "tile",
                           "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "solves_in_window", "unit": "count",
                           "better": "higher", "source": "host_clock",
                           "layer": "the whole solve", "moves": "gflops",
                           "workloads": ["dpotrf_like.tile"]})
    for e in m["end_to_end"]:
        e.get("workloads", []).append("dpotrf_like.tile")
    with open(path, "w") as f:
        json.dump(m, f)
    r = _run(small, "dpotrf_like.tile", trace=True)
    assert r["correct"] is True
    assert r["metrics"]["solves_in_window"]["value"] == r["attempted"]
    r = _run(small, "dpotrf_like.tile")
    assert set(r["metrics"]) == {"setup_s", "gflops"}


# ----------------------------------------------------------------- faults
def _unchanged(kernel):
    """The chore returns its state (its last, read-write, operand)."""
    def k(*args):
        return args[-1].clone()
    return k


def _half(kernel):
    """The chore leaves half of each batch out: lanes past the middle
    keep their state (a one-lane call, every other one)."""
    calls = [0]

    def k(*args):
        out = kernel(*args)
        state = args[-1]
        calls[0] += 1
        if state.dim() == 3 and state.shape[0] > 1:
            out = out.clone()
            h = state.shape[0] // 2
            out[h:] = state[h:]
            return out
        return state.clone() if calls[0] % 2 else out
    return k


def _altered(kernel):
    """Each call of the chore alters one entry of its answer (lane 0's
    last row, first column: below the diagonal of every tile it
    writes)."""
    def k(*args):
        out = kernel(*args).clone()
        (out[0] if out.dim() == 3 else out)[-1, 0] += 1.0
        return out
    return k


UPDATES = {"spotrf.panel": [(potrf_mod, "k_panel_update")],
           "spotrf.tile": [(potrf_mod, "k_gemm"), (potrf_mod, "k_syrk")],
           "sgemm.ptg": [(gemm_mod, "k_gemm_nn")]}


def _break(monkeypatch, cell, fault):
    if cell == "sgemm.dtd":
        orig = CudaDevice.register_dtd_task

        def register(self, task_ptr, kernel, *a, **kw):
            return orig(self, task_ptr, wrapped[kernel], *a, **kw)
        wrapped = _Memo(fault)
        monkeypatch.setattr(CudaDevice, "register_dtd_task", register)
        return
    for mod, name in UPDATES[cell]:
        monkeypatch.setattr(mod, name, fault(getattr(mod, name)))


class _Memo(dict):
    """One faulty wrapper per kernel, so a fault's call count spans the
    run."""

    def __init__(self, fault):
        super().__init__()
        self.fault = fault

    def __missing__(self, kernel):
        self[kernel] = self.fault(kernel)
        return self[kernel]


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_comes_out_not_correct(small, monkeypatch, cell,
                                             fault):
    _break(monkeypatch, cell, fault)
    r = _run(small, cell)
    assert r["correct"] is False
    (check,) = r["checks"].values()
    assert check["value"] > check["limit"]


def test_checks_print_beside_their_limits(small, capsys):
    _run(small, "sgemm.ptg")
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith("check c_err ") and " limit " in err[-1]
    assert err[-2].startswith("solves ")


def test_the_run_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        core.require_device(1)
    assert e.value.code != 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit):
        core.require_device(4)


@pytest.mark.parametrize("seed", range(3))
def test_a_window_of_one_solve_is_judged(small, seed):
    # whichever early solve the seed samples, the last one is judged
    r = _run(small, "sgemm.ptg", seed=seed, seconds=0.0)
    assert r["attempted"] == 1 and r["correct"] is True
    assert r["checks"]["c_err"]["value"] is not None
