"""BENCHMARK.json holds to its contract, and every name in it resolves
to its files under benchmark/."""
import json
import os
import re

import pytest

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    path = os.path.join(REPO, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def _exists(*parts):
    return os.path.isfile(os.path.join(REPO, *parts))


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert manifest["command"][:2] == ["python3", "benchmark/run.py"]
    assert all(_line(w) for w in manifest["command"])
    assert 1 <= manifest["run_seconds"] <= 51
    assert isinstance(manifest["run_seconds"], int)


def test_configs_resolve(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert _exists(c["file"]), c["file"]
        assert _exists("benchmark", "reference", c["name"] + ".py")
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert set(cfg["reduced"]) == set(c["reduced"])
        assert {"nb_workers", "cache_bytes"} == set(cfg["user_settings"])
        assert c["name"] in used


def test_cells_resolve(manifest):
    names = [w["name"] for w in manifest["workloads"]]
    assert len(names) == len(set(names))
    pairs = {(w["config"], w["traffic"]) for w in manifest["workloads"]}
    assert len(pairs) == len(names)
    configs = {c["name"] for c in manifest["configs"]}
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert _exists("benchmark", "workloads", w["name"] + ".json")
        with open(os.path.join(REPO, "benchmark", "workloads",
                               w["name"] + ".json")) as f:
            traffic = json.load(f)
        assert _exists("benchmark", "drivers", traffic["driver"] + ".py")
        assert traffic["limits"]


def test_metrics_resolve(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = list(e2e) + [m["name"] for m in manifest["per_layer"]]
    assert len(names) == len(set(names))
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert _exists("benchmark", "metrics", m["name"] + ".py")


def test_every_cell_reports_enough(manifest):
    for w in manifest["workloads"]:
        cell = w["name"]
        e2e = [m["name"] for m in manifest["end_to_end"]
               if cell in m.get("workloads", [cell])]
        per = [m for m in manifest["per_layer"]
               if cell in m.get("workloads", [cell]) and m["moves"] in e2e]
        assert "setup_s" in e2e and len(e2e) >= 2 and per, cell
