"""The benchmark's arithmetic against hand-worked cases: flops, the
window rate, the quartile spread, the device timeline."""
import statistics

import pytest

from harness import arith, core
from conftest import REPO


def _reference(name):
    return core.load_module(REPO, "reference", name)


def test_flops_count_the_operation():
    spotrf, sgemm = _reference("spotrf"), _reference("sgemm")
    # DPLASMA's potrf count n^3/3 + n^2/2 + n/6: 1 at n = 1
    assert spotrf.flops({"N": 1}, {}) == pytest.approx(1.0)
    assert spotrf.flops({"N": 32768}, {}) == pytest.approx(
        32768 ** 3 / 3 + 32768 ** 2 / 2 + 32768 / 6)
    assert sgemm.flops({"N": 4096}, {}) == 2.0 * 4096 ** 3


def test_window_rate_takes_all_work_over_all_time():
    # 30 solves of 1e12 flops in a 45 s window -> 666.67 GFLOP/s
    assert arith.window_rate(1e12, 30, 45.0) / 1e9 == pytest.approx(
        666.6666666)
    with pytest.raises(ValueError):
        arith.window_rate(1.0, 1, 0.0)


def test_union_gaps_and_cover_on_a_synthetic_timeline():
    ops = [(0, 10), (5, 15), (20, 30), (29, 31), (50, 60), (70, 80)]
    assert arith.union(ops) == [(0, 15), (20, 31), (50, 60), (70, 80)]
    # window [2, 75]: covered 13 + 11 + 10 + 5 = 39 of 73
    assert arith.covered(ops, 2, 75) == 39
    assert arith.gaps(ops, 2, 75) == [(15, 20), (31, 50), (60, 70)]
    assert arith.gaps([], 0, 5) == [(0, 5)]
    idle_pct = 100 * (1 - arith.covered(ops, 2, 75) / 73)
    assert idle_pct == pytest.approx(100 * 34 / 73)


def test_gap_labels_come_from_the_span_open():
    spans = [("reinstall", 0, 10), ("build", 10, 12), ("run_wait", 12, 40),
             ("drain", 40, 45)]
    assert arith.label_at(spans, 11) == "build"
    assert arith.label_at(spans, 39.9) == "run_wait"
    assert arith.label_at(spans, 45) is None


def test_quartile_spread_uses_statistics_quantiles():
    xs = [10.0, 11.0, 9.5, 10.5, 10.2, 9.8]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert arith.quartile_spread(xs) == pytest.approx((q3 - q1) / q2)


def test_readers_on_a_synthetic_run():
    run = core.Run()
    run.solves = [{"solve": s, "build": 0.001, "run_wait": s - 0.002,
                   "drain": 0.001} for s in (1.0, 1.2, 1.1, 3.0)]
    run.window_s = 5.0
    run.window_ns = (0, 5_000_000_000)
    run.flops_per_solve = 1e12
    run.peak_flops = 67e12
    run.counters = {"stats.tasks": 8320.0, "launches": 900.0,
                    "stats.h2d_stall_ns": 4e6, "fuse.fused_waves": 40.0}
    # kernels busy 1 s of the 5 s window, half of it twice over
    run.ops = [("gemm", "kernel", 0, 500_000_000),
               ("gemm", "kernel", 250_000_000, 750_000_000),
               ("Memcpy DtoD", "memcpy", 4_000_000_000, 4_500_000_000)]
    read = {m: core.load_module(REPO, "metrics", m).read
            for m in ("gflops", "tasks_per_solve",
                      "launches_per_solve", "h2d_stall_ms",
                      "fused_waves_per_solve", "device_idle_pct",
                      "kernel_roofline", "solve_mfu_pct",
                      "dag_build_ms")}
    assert read["gflops"](run) == pytest.approx(800.0)
    assert read["tasks_per_solve"](run) == 2080.0
    assert read["launches_per_solve"](run) == 225.0
    assert read["h2d_stall_ms"](run) == pytest.approx(1.0)
    assert read["fused_waves_per_solve"](run) == 10.0
    # busy: union of [0, 0.75] s and [4, 4.5] s = 1.25 s of 5
    assert read["device_idle_pct"](run) == pytest.approx(75.0)
    # 4e12 flops need 4/67 s; kernels summed 1.0 s
    assert read["kernel_roofline"](run) == pytest.approx(
        100 * 4 / 67)
    assert read["solve_mfu_pct"](run) == pytest.approx(100 * 4 / 67 / 5)
    assert read["dag_build_ms"](run) == pytest.approx(1.0)
    run.ops = None
    assert read["device_idle_pct"](run) is None
    assert read["kernel_roofline"](run) is None
