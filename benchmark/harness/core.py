"""One run of one cell: load it by name, set up, measure, check, report.

Everything that belongs to one configuration, one cell or one metric
sits in a file of its own, found by the name that BENCHMARK.json gives:

    benchmark/configs/<config>.json     the deployment and its settings
    benchmark/workloads/<cell>.json     driver, problem size, limits
    benchmark/drivers/<driver>.py       the application code of a path
    benchmark/reference/<config>.py     inputs, flops, the plain reference
    benchmark/metrics/<metric>.py       the reader of one metric

A run: the inputs are made on the device from the seed, the driver sets
up the program's Context and CudaDevice once and solves once untimed;
then solves run back to back (closed loop, one client) until the window
has lasted `seconds`, each one after the inputs are handed to the
program again.  Once the window has closed the program is torn down and
the reference judges what sampled solves left in the device tiles.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import random
import sys
import time
import traceback
from typing import Dict, List, Optional

from . import arith

FORBIDDEN = ("jax", "jaxlib", "flax", "parsec_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))


class CellError(Exception):
    """A cell, configuration or metric that cannot be found or is not
    complete."""


def _json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise CellError(f"missing file {path}") from e


def load_module(root: str, kind: str, name: str):
    """benchmark/<kind>/<name>.py under `root`, imported by its path."""
    path = os.path.join(root, "benchmark", kind, name + ".py")
    if not os.path.isfile(path):
        raise CellError(f"missing file {path}")
    mod_name = f"bench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell as BENCHMARK.json and its files describe it."""

    def __init__(self, root: str, name: str):
        self.root = root
        manifest = _json(os.path.join(root, "BENCHMARK.json"))
        entry = next((w for w in manifest["workloads"]
                      if w["name"] == name), None)
        if entry is None:
            raise CellError(f"no cell {name!r} in BENCHMARK.json")
        self.name = name
        self.chips = int(entry["chips"])
        self.config_name = entry["config"]
        cfg_entry = next(c for c in manifest["configs"]
                         if c["name"] == self.config_name)
        self.config = _json(os.path.join(root, cfg_entry["file"]))
        self.traffic = _json(os.path.join(root, "benchmark", "workloads",
                                          name + ".json"))
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]


class Run:
    """What a reader reads: the solves' spans, the program's counters
    over the window, the device timeline (traced runs only) and the
    numbers the cell's configuration fixes."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.window_ns = (0, 0)        # wall clock, for the timeline
        self.solves: List[Dict[str, float]] = []  # span name -> seconds
        self.counters: Dict[str, float] = {}      # deltas over the window
        self.flops_per_solve = 0.0
        self.peak_flops: Optional[float] = None
        self.ops = None                # device ops [(name, kind, a, b)]
        self.spans = []                # host spans [(name, a_ns, b_ns)]

    @property
    def n_solves(self) -> int:
        return len(self.solves)

    def per_solve(self, key: str) -> Optional[float]:
        if not self.solves or key not in self.counters:
            return None
        return self.counters[key] / len(self.solves)

    def window_ops(self, kinds=("kernel", "memcpy", "memset")):
        """(start, end) ns of the device ops of `kinds` clipped to the
        window; None when the run was not traced or the trace holds no
        device op."""
        if not self.ops:
            return None
        t0, t1 = self.window_ns
        return arith.clip([(a, b) for _, k, a, b in self.ops if k in kinds],
                          t0, t1)


def _peaks(kind: str) -> Optional[dict]:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f).get(kind)


def _counters(dev) -> Dict[str, float]:
    """The device's counters flattened: stats, chore calls and the wave
    compiler's numbers."""
    info = dev.info()
    out = {f"stats.{k}": float(v) for k, v in info["stats"].items()}
    out["launches"] = float(sum(v[0] for v in dev.launches.values()))
    for k, v in info["fuse"].items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[f"fuse.{k}"] = float(v)
    return out


def _forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _breakdown(run: Run) -> dict:
    """The device ops that took most time, and the longest idle gaps by
    the host span open in each."""
    t0, t1 = run.window_ns
    by_name: Dict[str, float] = {}
    for name, _, a, b in run.ops:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            by_name[name[:160]] = by_name.get(name[:160], 0.0) + (b - a) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = arith.gaps(run.window_ops(), t0, t1)
    labelled = [(arith.label_at(run.spans, (a + b) / 2) or "other",
                 (b - a) / 1e9) for a, b in idle]
    labelled.sort(key=lambda kv: -kv[1])
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in labelled[:10]]}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float) -> dict:
    """One run of `cell` on `device` ("cuda:0", or "cpu" for the tests);
    returns the result line's object.  `t_start` is the process's start
    on the perf_counter clock."""
    import torch
    # the configuration's precision: float32 products in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # the program's import builds its native core where the checkout
    # lacks it (a checkout's first run): timed apart, inside set-up
    spec = importlib.util.find_spec("parsec_tpu_torch")
    built = spec is not None and "parsec_tpu_torch" not in sys.modules \
        and not os.path.exists(os.path.join(
            os.path.dirname(os.path.dirname(spec.origin)), "build",
            "libparsec_core.so"))
    t_import = time.perf_counter()
    import parsec_tpu_torch as pt
    from parsec_tpu_torch.device import CudaDevice
    t_import = time.perf_counter() - t_import

    driver = load_module(cell.root, "drivers", cell.traffic["driver"])
    reference = load_module(cell.root, "reference", cell.config_name)
    readers = {m["name"]: load_module(cell.root, "metrics", m["name"])
               for m in cell.end_to_end + cell.per_layer}
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    run = Run()
    run.flops_per_solve = reference.flops(cell.traffic, cell.config)
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    peaks = _peaks(kind)
    if peaks is not None:
        run.peak_flops = peaks.get(cell.config["precision"])
    # which sampled solve besides the last one is judged: drawn from
    # the seed among the first three
    sample = random.Random(seed).randrange(3)
    outputs = []
    attempted = failed = 0
    wall = time.time_ns() - time.perf_counter_ns()  # perf -> wall, ns

    def ns(t: float) -> int:
        return int(t * 1e9) + wall

    st = cell.config["user_settings"]
    ctx = pt.Context(nb_workers=int(st["nb_workers"]))
    try:
        dev = CudaDevice(ctx, device=device,
                         cache_bytes=int(st["cache_bytes"]))
        inputs = reference.inputs(seed, cell.traffic, cell.config, device)
        drv = driver.Driver(ctx, dev, cell.config, cell.traffic, inputs)
        del inputs
        drv.reinstall()
        sync()
        t_warm = time.perf_counter()
        drv.solve()                       # untimed: every shape once
        sync()
        t_warm = time.perf_counter() - t_warm
        tracer = None
        if trace and on_card:           # the host has no CUDA timeline
            from .trace import Tracer
            tracer = Tracer()
            tracer.start()
        c0 = _counters(dev)
        t0 = time.perf_counter()
        run.setup_s = t0 - t_start
        while True:
            a = time.perf_counter()
            drv.reinstall()
            run.spans.append(("reinstall", ns(a), ns(time.perf_counter())))
            attempted += 1
            try:
                spans = drv.solve()
            except Exception:
                traceback.print_exc()
                failed += 1
                break
            rec = {k: b - a for k, (a, b) in spans.items()}
            starts = [a for a, _ in spans.values()]
            ends = [b for _, b in spans.values()]
            rec["solve"] = max(ends) - min(starts)
            run.solves.append(rec)
            run.spans += [(k, ns(a), ns(b)) for k, (a, b) in spans.items()]
            if len(run.solves) == sample + 1:
                a = time.perf_counter()
                outputs.append(drv.output())
                run.spans.append(("sample", ns(a),
                                  ns(time.perf_counter())))
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        run.window_s = t1 - t0
        run.window_ns = (ns(t0), ns(t1))
        c1 = _counters(dev)
        run.counters = {k: c1[k] - c0.get(k, 0.0) for k in c1}
        if tracer is not None:
            sync()
            tracer.stop()
            run.ops = tracer.ops
        if failed == 0 and run.solves and len(run.solves) != sample + 1:
            outputs.append(drv.output())     # the last solve's
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        # tear the program down before the reference runs; the inputs
        # go back first, so the stop has no dirty mirror to write back
        drv.reinstall()
        sync()
        dev.stop()
    finally:
        ctx.destroy()
    del drv, dev, ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    sys.stderr.write(f"set-up {run.setup_s} s: the program's import "
                     f"{t_import} s ({'with' if built else 'without'} "
                     f"building the native core), the untimed solve "
                     f"{t_warm} s\n")
    bad = _forbidden_modules()
    if bad:
        raise RuntimeError(f"modules loaded in the run: {', '.join(bad)}")
    sys.stderr.write(f"solves {len(run.solves)} in a window of "
                     f"{run.window_s} s ({attempted} attempted, "
                     f"{failed} failed); solve ms "
                     f"{[round(s['solve'] * 1e3, 1) for s in run.solves]}"
                     "\n")

    numbers = reference.check(seed, cell.traffic, cell.config, outputs,
                              device) if outputs else {}
    limits = cell.traffic["limits"]
    checks = {k: {"value": numbers.get(k), "limit": limits[k]}
              for k in limits}
    correct = (bool(outputs) and failed == 0 and attempted > 0
               and set(numbers) == set(limits)
               and all(v is not None and math.isfinite(v) and v <= limits[k]
                       for k, v in numbers.items()))

    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        ops = run.window_ops()
        dev_info["busy_s"] = (arith.covered(ops, *run.window_ns) / 1e9
                              if ops else 0.0)
        dev_info["window_s"] = run.window_s
        if ops:
            result["breakdown"] = _breakdown(run)
    for k, c in checks.items():
        sys.stderr.write(f"check {k} {c['value']} limit {c['limit']}\n")
    result["checks"] = checks
    return result


def require_device(chips: int) -> str:
    """The card to run on; raises SystemExit (no result) when CUDA is
    not available or there are fewer cards than the cell asks for."""
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA device: torch.cuda.is_available() is "
                         "false\n")
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        sys.stderr.write(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} visible\n")
        raise SystemExit(2)
    return "cuda:0"
