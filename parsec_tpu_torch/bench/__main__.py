"""python -m parsec_tpu_torch.bench [suite flag] [options] [--device D]

bench.py's command line on the port: the same suite flags, options,
defaults, stdout line and `--json` document.  The device suites run on
the card unless `--device cpu` is given; `--device` followed by a device
name (cpu, cuda, cuda:N) is that choice, any other `--device` selects
the device suite, so the device suite on the host is
`--device --device cpu`.  Without a suite flag: the spotrf ladder
(spotrf.headline).  Exits 0 only when the suite ran to its end.
"""
from __future__ import annotations

import json
import sys

from .common import (_arg_after, _arg_str_after, device_choice,
                     device_suite_selected, write_doc)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = device_choice(argv)

    def arg(flag, default):
        return _arg_after(flag, default, argv)

    def sarg(flag, default):
        return _arg_str_after(flag, default, argv)

    if "--dispatch" in argv:
        from .dispatch import _dispatch_json, bench_dispatch_suite
        out = sarg("--json", None)
        if out:
            doc = bench_dispatch_suite(
                tasks=arg("--tasks", 20000),
                mt_tasks=arg("--mt-tasks", 4000),
                reps=arg("--reps", 5),
                workers=arg("--workers", 4),
                lanes=arg("--lanes", 8))
            write_doc(doc, out)
            print(_dispatch_json(doc["single_chain"]))
        else:
            print(_dispatch_json())
        return 0
    if device_suite_selected(argv):
        from .device import bench_device_suite
        doc = bench_device_suite(
            tiles=arg("--tiles", 96),
            elems=arg("--elems", 32 * 1024),
            batch=arg("--batch", 8),
            reps=arg("--reps", 3),
            gemm_m=arg("--gemm-m", 512),
            gemm_k=arg("--gemm-k", 64),
            gemm_mb=arg("--gemm-mb", 32),
            device=device)
        write_doc(doc, sarg("--json", None))
        wp = doc["wave_pipeline"]
        print(json.dumps({
            "metric": "device_h2d_stall_reduction",
            "value": wp["hit_wave_stall_reduction"],
            "unit": "fraction (prefetch-hit wave vs staged baseline)",
            "vs_baseline": (round(wp["hit_wave_stall_reduction"] / 0.8, 3)
                            if wp["hit_wave_stall_reduction"] is not None
                            else None),
            "config": {"tiles": wp["tiles"], "batch": wp["batch"],
                       "ooc_gemm_correct":
                           doc["out_of_core_gemm"]["correct"],
                       "ooc_gemm_spills":
                           doc["out_of_core_gemm"]["spills"]},
        }))
        return 0
    if "--stream" in argv:
        from .stream import bench_stream_suite
        doc = bench_stream_suite(
            size=arg("--size", 4 << 20),
            hops=arg("--hops", 8),
            reps=arg("--reps", 3),
            chunk=arg("--chunk", 1 << 20),
            inflight=arg("--inflight", 4),
            device=device)
        write_doc(doc, sarg("--json", None))
        line = {
            "metric": "stream_vs_serialized_latency_ratio",
            "value": doc["stream_vs_serialized_ratio"],
            "unit": "x (lower is better; serialized PR3 serve = 1.0)",
            "vs_baseline": (round(0.6 / doc["stream_vs_serialized_ratio"],
                                  3)
                            if doc["stream_vs_serialized_ratio"] else None),
            "config": {"size_bytes": doc["knobs"]["size_bytes"],
                       "hops": doc["knobs"]["hops"],
                       "rails2_vs_rails1_throughput":
                           doc["rails2_vs_rails1_throughput"],
                       "overlap_fraction":
                           doc["streamed"]["overlap_fraction"]},
        }
        if "caveat" in doc:
            line["caveat"] = doc["caveat"]
        print(json.dumps(line))
        return 0
    if "--collective" in argv:
        from .collective import bench_collective_suite
        sizes_arg = sarg("--sizes", None)
        sizes = (tuple(int(s) for s in sizes_arg.split(","))
                 if sizes_arg else (64 << 10, 512 << 10, 2 << 20))
        doc = bench_collective_suite(sizes=sizes, reps=arg("--reps", 3),
                                     device=device)
        write_doc(doc, sarg("--json", None))
        gp = doc["gemm_panel"]
        line = {
            "metric": "coll_vs_chain_reduction_latency_ratio",
            "value": doc["coll_vs_chain_ratio"],
            "unit": "x (lower is better; DAG-dependency chain = 1.0)",
            "vs_baseline": (round(1.0 / doc["coll_vs_chain_ratio"], 3)
                            if doc["coll_vs_chain_ratio"] else None),
            "config": {"sizes": doc["knobs"]["sizes"],
                       "wait_reduction": gp["wait_reduction"],
                       "overlap_fraction_gain":
                           gp["overlap_fraction_gain"],
                       "topology_ops": doc["coll_topology_ops"]},
        }
        if "caveat" in doc:
            line["caveat"] = doc["caveat"]
        print(json.dumps(line))
        return 0
    if "--topo" in argv:
        from .topo import bench_topo_suite
        doc = bench_topo_suite(
            spec=sarg("--spec", "0,1;2,3"),
            coll_bytes=arg("--coll-bytes", 1 << 20),
            reps=arg("--reps", 3),
            hops=arg("--hops", 8),
            elems=arg("--elems", 1 << 16),
            delay_us=arg("--delay-us", 500))
        write_doc(doc, sarg("--json", None))
        rm = doc["remap"]
        print(json.dumps({
            "metric": "topo_remap_dcn_bytes_reduction",
            "value": rm["dcn_reduction"],
            "unit": "fraction of identity-placement DCN bytes removed "
                    "(floor 0.30)",
            "vs_baseline": (round(rm["dcn_reduction"] / 0.30, 3)
                            if rm["dcn_reduction"] is not None else None),
            "config": {"spec": doc["knobs"]["spec"],
                       "delay_us": doc["knobs"]["delay_us"],
                       "predicted_sound": rm["predicted_sound"],
                       "payload_within_25pct":
                           rm["payload_within_25pct"],
                       "allreduce_dcn_ratio_hier_vs_ring":
                           doc["allreduce"]["dcn_ratio_hier_vs_ring"],
                       "bit_identical": doc["bit_identical"]},
        }))
        return 0
    if "--serve" in argv:
        from .serve import bench_serve_suite
        doc = bench_serve_suite(
            n_hi=arg("--hi", 6),
            n_lo=arg("--lo", 18),
            max_new=arg("--max-new", 6),
            workers=arg("--workers", 2),
            device=device)
        write_doc(doc, sarg("--json", None))
        line = {
            "metric": "serve_hi_p99_improvement",
            "value": doc["hi_p99_improvement"],
            "unit": "x (hi-tenant p99 control / qos; > 1 = QoS wins)",
            "vs_baseline": doc["hi_p99_improvement"],
            "config": {
                "hi_p99_ms": doc["qos"]["hi"]["p99_ms"],
                "control_hi_p99_ms": doc["control"]["hi"]["p99_ms"],
                "hi_p99_beats_control":
                    doc["qos"]["hi_p99_beats_control"],
                "bit_identical": doc["decode"]["bit_identical"],
                "rejected": doc["admission"]["rejected"],
                "throughput_tok_s": doc["qos"]["throughput_tok_s"],
            },
        }
        if "caveat" in doc:
            line["caveat"] = doc["caveat"]
        print(json.dumps(line))
        return 0
    if "--control" in argv:
        from .control import bench_control_suite
        doc = bench_control_suite(
            m=arg("--m", 384),
            reps=arg("--reps", 3),
            fault_delay_us=arg("--delay-us", 2000),
            workers=arg("--workers", 2),
            n_reqs=arg("--reqs", 4),
            max_new=arg("--max-new", 40),
            device=device)
        write_doc(doc, sarg("--json", None))
        print(json.dumps({
            "metric": "control_drift_recovery_ratio",
            "value": doc["soak"]["recovery_ratio"],
            "unit": "fraction of incident-lost throughput recovered "
                    "without restart (>= 0.5 gated)",
            "vs_baseline": doc["soak"]["recovery_ratio"],
            "config": {
                "recovered": doc["soak"]["recovered"],
                "swaps": doc["soak"]["swaps"],
                "persisted": doc["soak"]["persisted"],
                "adaptive_ge_best_fixed":
                    doc["spec"]["adaptive_ge_best_fixed"],
                "adaptive_score": doc["spec"]["adaptive_score"],
                "best_fixed_score": doc["spec"]["best_fixed_score"],
                "bit_identical": doc["spec"]["bit_identical"],
            },
        }))
        return 0
    if "--ep" in argv:
        from .dispatch import _ep_json
        print(_ep_json())
        return 0
    if "--dispatch-mt" in argv:
        from .dispatch import bench_dispatch_mt
        mt = bench_dispatch_mt(workers=arg("--workers", 4),
                               lanes=arg("--lanes", 8))
        line = {
            "metric": "task_dispatch_mt_p50",
            "value": mt["p50_us"],
            "unit": "us",
            "vs_baseline": round(5.0 / mt["p50_us"], 3),
            "config": {k: mt[k] for k in
                       ("workers", "workers_requested", "lanes", "tasks",
                        "cpu_count", "oversubscribed")},
            "p99_us": mt["p99_us"],
        }
        if "caveat" in mt:
            line["caveat"] = mt["caveat"]
        print(json.dumps(line))
        return 0
    if "--profov" in argv:
        from .trace import bench_profiling_overhead
        print(bench_profiling_overhead())
        return 0
    if "--trace" in argv:
        from .trace import bench_trace_suite
        doc = bench_trace_suite(tasks=arg("--tasks", 20000),
                                reps=arg("--reps", 5),
                                ring_bytes=arg("--ring", 1 << 16))
        write_doc(doc, sarg("--json", None))
        print(json.dumps({
            "metric": "trace_ring_vs_unbounded_level1",
            "value": doc["ring"]["vs_unbounded_level1"],
            "unit": "x (1.0 = no ring overhead; acceptance < 1.1)",
            "vs_baseline": (round(1.1 / doc["ring"]["vs_unbounded_level1"],
                                  3)
                            if doc["ring"]["vs_unbounded_level1"] else None),
            "config": {"tasks": doc["knobs"]["tasks"],
                       "ring_bytes": doc["knobs"]["ring_bytes"],
                       "level1_overhead_ns":
                           doc["overhead_ns_per_task"]["level1"],
                       "ring_dropped": doc["ring"]["dropped_events"]},
        }))
        return 0
    if "--ring" in argv:
        from .ring import bench_ring
        print(bench_ring(S=arg("--s", 8), T=arg("--t", 2048),
                         d=arg("--d", 128), device=device))
        return 0
    from .spotrf import headline, spotrf_child
    if "--spotrf-child" in argv:
        return spotrf_child(argv)
    return headline(argv)


if __name__ == "__main__":
    sys.exit(main())
