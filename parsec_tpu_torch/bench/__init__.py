"""The port's benchmark entry point: bench.py's suites on the card,

    python -m parsec_tpu_torch.bench <flags>     # see __main__.py

with the reference's flags, defaults, stdout line and `--json` document
for every suite.  The device suites run on the card unless the caller
passes `--device cpu` (device="cpu" to the functions); the host suites
(dispatch, trace, ep, topo) touch no device.  Without a suite flag it
climbs the spotrf ladder on the card (spotrf.headline): there is no
tunnel probe, no cached line and no dispatch fallback.

Differences from bench.py: `vs_baseline` of a spotrf line is against
torch.linalg.cholesky at the same N in the same process (named under
"baseline", with "power_limit_w" and "residual"); the collective
document's library baseline is `torch_all_reduce_ms` (gloo
all_reduce over the two ranks on the chosen device) for `xla_psum_ms`;
the ring's yardstick is one plain torch attention call; spawned ranks
take free ports from comm.launch.free_port_base.

The reference's functions keep their names and are re-exported here,
each module imported on first use (a spawned host rank that imports
this package loads no torch).  `python -m
parsec_tpu_torch.bench.lane_load` repeats the device suite many copies
at once and counts the prefetch lane's hit waves (the port's own; see
its docstring).
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "host_provenance": "common", "_arg_after": "common",
    "_arg_str_after": "common", "_device_hbm": "common",
    "_spotrf_fits": "common", "_chip_info": "common",
    "_chain_taskpool": "dispatch", "bench_dispatch_chain": "dispatch",
    "bench_dispatch_mt": "dispatch", "bench_dispatch_tuned": "dispatch",
    "bench_dispatch_suite": "dispatch", "_dispatch_json": "dispatch",
    "bench_ep": "dispatch", "_ep_json": "dispatch",
    "bench_profiling_overhead": "trace", "bench_trace_suite": "trace",
    "_pair_spans": "device", "_overlap_fraction": "device",
    "_device_wave_run": "device", "bench_device_pipeline": "device",
    "bench_device_ooc_gemm": "device", "_fuse_gemm_run": "device",
    "bench_device_fuse_gemm": "device", "bench_device_suite": "device",
    "_stream_worker": "stream", "_stream_pair": "stream",
    "bench_stream_tuned": "stream", "bench_stream_suite": "stream",
    "_coll_bench_worker": "collective",
    "_coll_trace_metrics": "collective", "_run_coll_pair": "collective",
    "_torch_all_reduce_baseline": "collective",
    "bench_collective_tuned": "collective",
    "bench_collective_suite": "collective",
    "_topo_bench_worker": "topo", "_run_topo_quad": "topo",
    "bench_topo_suite": "topo",
    "bench_serve_suite": "serve", "_scope_bench_section": "serve",
    "_prefix_bench_section": "serve", "_spec_bench_section": "serve",
    "_fleet_bench_section": "serve", "_tp_bench_section": "serve",
    "_control_soak_section": "control", "_control_spec_section": "control",
    "bench_control_suite": "control",
    "_potrf_once": "spotrf", "bench_spotrf": "spotrf",
    "cholesky_baseline": "spotrf", "spotrf_child": "spotrf",
    "headline": "spotrf",
    "bench_ring": "ring",
    "main": "__main__",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)
