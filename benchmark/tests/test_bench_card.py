"""On the card only (marked `cuda`; each test skips without a card):

    python -m pytest benchmark/tests/test_bench_card.py -q -p no:cacheprovider

a whole traced run of the command at a small size, and each cell's
control at the cell's own size with the card's TF32 mode."""
import json
import os
import subprocess
import sys

import pytest
import torch

from harness import core
from conftest import REPO, small_root


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_the_command_runs_a_small_cell_on_the_card(tmp_path):
    _need_card()
    root = small_root(tmp_path, {"spotrf.panel": 4096}, nb=512)
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "spotrf.panel",
         "--seed", str(2 ** 31 + 3), "--seconds", "2", "--trace", "1"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["kind"] == torch.cuda.get_device_name(0)
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    for name in ("device_idle_pct", "kernel_roofline", "solve_mfu_pct",
                 "launches_per_solve", "fused_waves_per_solve"):
        assert name in r["metrics"], name
    assert 0 < r["metrics"]["kernel_roofline"]["value"] <= 100
    assert r["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["spotrf.panel", "sgemm.dtd"])
def test_the_control_fails_at_the_cells_own_size(cell):
    _need_card()
    c = core.Cell(REPO, cell)
    ref = core.load_module(REPO, "reference", c.config_name)
    for seed in (1, 2, 3):
        got = ref.control(seed, c.traffic, c.config, "cuda:0")
        for k, limit in c.traffic["limits"].items():
            assert got[k] > limit, (cell, seed, k, got[k], limit)
