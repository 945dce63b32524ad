"""Tests of the benchmark harness, on the host at small sizes.

    python -m pytest benchmark/tests -q -p no:cacheprovider

A cell runs here with `CudaDevice(ctx, device="cpu")` (the plain
versions of the chores) through `harness.core.run_cell`, which skips the
look for a card.  Tests marked `cuda` need a card and skip without one.
"""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for p in (BENCH, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


def small_root(tmp_path, sizes, nb=128, cache_bytes=1 << 30):
    """A checkout-like root under tmp_path holding BENCHMARK.json and a
    copy of benchmark/, whose cells run at the sizes `sizes` ({cell: N})
    with tiles of `nb` and a small cache.  A cell of `sizes` that has its
    files but is out of BENCHMARK.json (spotrf.tile, sgemm.ptg: PERF.md
    says why) is entered in the copy.  No file of the repo is
    touched."""
    root = str(tmp_path / "root")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    held = {w["name"] for w in manifest["workloads"]}
    for cell in sizes:
        if cell not in held:    # a cell with files but out of the manifest
            config, traffic = cell.split(".", 1)
            manifest["workloads"].append(
                {"name": cell, "config": config, "traffic": traffic,
                 "chips": 1, "why": "held on the host only"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    for cell, n in sizes.items():
        path = os.path.join(root, "benchmark", "workloads", cell + ".json")
        with open(path) as f:
            w = json.load(f)
        w["N"] = n
        with open(path, "w") as f:
            json.dump(w, f)
    for name in ("spotrf", "sgemm"):
        path = os.path.join(root, "benchmark", "configs", name + ".json")
        with open(path) as f:
            c = json.load(f)
        c["NB"] = nb
        c["user_settings"].update(nb_workers=2, cache_bytes=cache_bytes)
        with open(path, "w") as f:
            json.dump(c, f)
    return root


SMALL = {"spotrf.panel": 1024, "spotrf.tile": 1024, "sgemm.ptg": 512,
         "sgemm.dtd": 512}


@pytest.fixture
def small(tmp_path):
    return small_root(tmp_path, SMALL)
