"""ctypes bindings to the shared native core (build/libparsec_core.so).

The C++ runtime under native/ is shared build source: this binding builds
it with the repo's Makefile (`make -s`) when the library is missing or
older than its sources, exactly as the JAX package's binding does, and
loads the same library.  Keep the constants and signatures in step with
native/parsec_core.h.  Every entry point that parsec_tpu/_native.py
declares is declared here with the same signature
(tests/test_torch_parity.py holds the two tables to that).
"""
from __future__ import annotations

import ctypes as C
import os
import subprocess

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# PTC_NATIVE_LIB points at an alternate build of the core (ASan/TSan
# instrumented, debug, ...) without touching the default build tree.
_LIB_PATH = os.environ.get("PTC_NATIVE_LIB") or \
    os.path.join(_REPO, "build", "libparsec_core.so")
_SOURCES = [os.path.join(_REPO, "native", f) for f in (
    "core.cpp", "sched.cpp", "comm.cpp", "parsec_core.h",
    "runtime_internal.h", "lockfree.h")]

# hook protocol (parsec_core.h)
HOOK_DONE = 0
HOOK_AGAIN = 1
HOOK_ASYNC = 2
HOOK_NEXT = 3
HOOK_DISABLE = 4
HOOK_ERROR = -1

FLOW_READ = 1
FLOW_WRITE = 2
FLOW_RW = 3
FLOW_CTL = 4

# must mirror PTC_MAX_LOCALS / PTC_MAX_FLOWS (native/parsec_core.h:30-31)
MAX_LOCALS = 20
MAX_FLOWS = 20

# debug-stream subsystem ids (must mirror PTC_DBG_* in parsec_core.h)
DBG_RUNTIME = 0
DBG_COMM = 1
DBG_DEVICE = 2
DBG_SUBSYSTEMS = ("runtime", "comm", "device")  # index == id

# element kinds of a cast datatype (native ptc_register_datatype_cast)
ELEM_KINDS = {"float32": 0, "float64": 1, "int32": 2, "int64": 3, "uint8": 4}

BODY_NOOP = 0
BODY_CB = 1
BODY_DEVICE = 2

DEV_CPU = 0
# PTC_DEV_TPU is the native accelerator queue slot: "the device chore".
# The CUDA device registers its chores there; no native type is added.
DEV_TPU = 1
DEV_CUDA = DEV_TPU
DEV_RECURSIVE = 2

# always-on metrics kinds (must mirror PTC_MET_* in runtime_internal.h)
MET_EXEC = 0
MET_RELEASE = 1
MET_H2D_STALL = 2
MET_COMM_WAIT = 3
MET_COLL_WAIT = 4
MET_KIND_NAMES = ("exec", "release", "h2d_stall", "comm_wait", "coll_wait")

# expression VM opcodes
OP_IMM = 1
OP_LOCAL = 2
OP_GLOBAL = 3
OP_ADD = 4
OP_SUB = 5
OP_MUL = 6
OP_DIV = 7
OP_MOD = 8
OP_NEG = 9
OP_EQ = 10
OP_NE = 11
OP_LT = 12
OP_LE = 13
OP_GT = 14
OP_GE = 15
OP_AND = 16
OP_OR = 17
OP_NOT = 18
OP_SELECT = 19
OP_MIN = 20
OP_MAX = 21
OP_CALL = 22
OP_SHL = 23
OP_SHR = 24


def _needs_build() -> bool:
    if os.environ.get("PTC_NATIVE_LIB"):
        return False  # instrumented override: its builder owns freshness
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    return any(os.path.getmtime(s) > lib_mtime for s in _SOURCES
               if os.path.exists(s))


def _build() -> None:
    subprocess.run(["make", "-s"], cwd=_REPO, check=True)


if _needs_build():
    _build()

lib = C.CDLL(_LIB_PATH)

# callback signatures
EXPR_CB_T = C.CFUNCTYPE(C.c_int64, C.c_void_p, C.POINTER(C.c_int64), C.c_int32,
                        C.POINTER(C.c_int64))
BODY_CB_T = C.CFUNCTYPE(C.c_int32, C.c_void_p, C.c_void_p)
RANK_OF_CB_T = C.CFUNCTYPE(C.c_uint32, C.c_void_p, C.POINTER(C.c_int64), C.c_int32)
DATA_OF_CB_T = C.CFUNCTYPE(C.c_void_p, C.c_void_p, C.POINTER(C.c_int64), C.c_int32)
COPY_RELEASE_CB_T = C.CFUNCTYPE(None, C.c_void_p, C.c_int64)
COPY_SYNC_CB_T = C.CFUNCTYPE(None, C.c_void_p, C.c_int64)
COPY_INVALIDATE_CB_T = C.CFUNCTYPE(None, C.c_void_p, C.c_int64)
# the device data plane (ptc_set_dataplane): register a current device
# mirror as a transfer tag, serve a pull's bytes, retire a serve, deliver
# a payload to a device, bind the consumer's host copy
DP_REGISTER_CB_T = C.CFUNCTYPE(C.c_int64, C.c_void_p, C.c_int64, C.c_int64,
                               C.c_int64)
DP_SERVE_CB_T = C.CFUNCTYPE(C.c_int64, C.c_void_p, C.c_int64, C.c_int32,
                            C.c_int32, C.POINTER(C.c_void_p),
                            C.POINTER(C.c_int64))
DP_SERVE_DONE_CB_T = C.CFUNCTYPE(None, C.c_void_p, C.c_int64)
DP_DELIVER_CB_T = C.CFUNCTYPE(C.c_int64, C.c_void_p, C.c_void_p, C.c_int64,
                              C.c_int64)
DP_BOUND_CB_T = C.CFUNCTYPE(None, C.c_void_p, C.c_int64, C.c_void_p,
                            C.c_int64, C.c_int32)
# progressive-serve offer (wire v4 streaming): (user, tag, from, xfer_ok,
# stream_id, total) -> 1 accept / 0 decline
DP_STREAM_CB_T = C.CFUNCTYPE(C.c_int32, C.c_void_p, C.c_int64, C.c_int32,
                             C.c_int32, C.c_uint64, C.c_int64)
TP_COMPLETE_CB_T = C.CFUNCTYPE(None, C.c_void_p, C.c_void_p)
PINS_CB_T = C.CFUNCTYPE(None, C.c_void_p, C.POINTER(C.c_int64))

_sigs = {
    "ptc_version": (C.c_char_p, []),
    "ptc_context_new": (C.c_void_p, [C.c_int32]),
    "ptc_context_destroy": (None, [C.c_void_p]),
    "ptc_context_nb_workers": (C.c_int32, [C.c_void_p]),
    "ptc_context_start": (C.c_int32, [C.c_void_p]),
    "ptc_context_wait": (C.c_int32, [C.c_void_p]),
    "ptc_context_test": (C.c_int32, [C.c_void_p]),
    "ptc_context_set_scheduler": (C.c_int32, [C.c_void_p, C.c_char_p]),
    "ptc_context_get_scheduler": (C.c_char_p, [C.c_void_p]),
    "ptc_context_set_sched_bypass": (None, [C.c_void_p, C.c_int32]),
    "ptc_context_get_sched_bypass": (C.c_int32, [C.c_void_p]),
    "ptc_sched_stats": (C.c_int64, [C.c_void_p, C.POINTER(C.c_int64),
                                    C.c_int64]),
    "ptc_tp_set_qos": (None, [C.c_void_p, C.c_int32, C.c_int64]),
    "ptc_tp_qos_stats": (C.c_int64, [C.c_void_p, C.POINTER(C.c_int64),
                                     C.c_int64]),
    "ptc_context_set_qos_preempt": (None, [C.c_void_p, C.c_int32]),
    "ptc_context_get_qos_preempt": (C.c_int32, [C.c_void_p]),
    "ptc_context_set_binding": (None, [C.c_void_p, C.c_int32]),
    "ptc_worker_binding": (C.c_int32, [C.c_void_p, C.c_int32]),
    "ptc_context_set_verbose": (None, [C.c_void_p, C.c_int32, C.c_int32]),
    "ptc_context_verbose": (C.c_int32, [C.c_void_p, C.c_int32]),
    "ptc_register_expr_cb": (C.c_int32, [C.c_void_p, EXPR_CB_T, C.c_void_p]),
    "ptc_register_body": (C.c_int32, [C.c_void_p, BODY_CB_T, C.c_void_p]),
    "ptc_register_collection": (C.c_int32, [C.c_void_p, C.c_uint32, C.c_uint32,
                                            RANK_OF_CB_T, DATA_OF_CB_T, C.c_void_p]),
    "ptc_context_set_vpmap": (C.c_int32, [C.c_void_p,
                                          C.POINTER(C.c_int32),
                                          C.c_int32]),
    "ptc_sched_victim_order": (C.c_int32, [C.c_void_p, C.c_int32,
                                           C.POINTER(C.c_int32),
                                           C.c_int32]),
    "ptc_register_linear_collection": (C.c_int32, [C.c_void_p, C.c_uint32,
                                                   C.c_uint32, C.c_void_p,
                                                   C.c_int64, C.c_int64]),
    "ptc_register_arena": (C.c_int32, [C.c_void_p, C.c_int64]),
    "ptc_register_datatype": (C.c_int32, [C.c_void_p, C.c_int64, C.c_int64,
                                          C.c_int64]),
    "ptc_register_datatype_indexed": (C.c_int32, [C.c_void_p,
                                                  C.POINTER(C.c_int64),
                                                  C.POINTER(C.c_int64),
                                                  C.c_int32]),
    "ptc_register_datatype_cast": (C.c_int32, [C.c_void_p, C.c_int32,
                                               C.c_int32, C.c_int64]),
    "ptc_ctx_reshape_stats": (None, [C.c_void_p, C.POINTER(C.c_int64),
                                     C.POINTER(C.c_int64)]),
    # the collection tool ABI (ptg_to_dtd reaches natively registered
    # collections through it)
    "ptc_dc_data_of": (C.c_void_p, [C.c_void_p, C.c_int32,
                                    C.POINTER(C.c_int64), C.c_int32]),
    "ptc_dc_rank_of": (C.c_int32, [C.c_void_p, C.c_int32,
                                   C.POINTER(C.c_int64), C.c_int32]),
    "ptc_tp_new": (C.c_void_p, [C.c_void_p, C.c_int32, C.POINTER(C.c_int64)]),
    "ptc_tp_destroy": (None, [C.c_void_p]),
    "ptc_tp_add_class": (C.c_int32, [C.c_void_p, C.c_char_p,
                                     C.POINTER(C.c_int64), C.c_int64]),
    "ptc_context_add_taskpool": (C.c_int32, [C.c_void_p, C.c_void_p]),
    "ptc_tp_wait": (C.c_int32, [C.c_void_p]),
    "ptc_tp_nb_tasks": (C.c_int64, [C.c_void_p]),
    "ptc_tp_addto_nb_tasks": (C.c_int64, [C.c_void_p, C.c_int64]),
    "ptc_tp_nb_total_tasks": (C.c_int64, [C.c_void_p]),
    "ptc_tp_nb_errors": (C.c_int64, [C.c_void_p]),
    "ptc_tp_dense_classes": (C.c_int32, [C.c_void_p]),
    "ptc_tp_drain": (C.c_int32, [C.c_void_p]),
    "ptc_tp_set_on_complete": (None, [C.c_void_p, TP_COMPLETE_CB_T,
                                      C.c_void_p]),
    "ptc_tp_global": (C.c_int64, [C.c_void_p, C.c_int32]),
    "ptc_tp_id": (C.c_int32, [C.c_void_p]),
    "ptc_tp_set_scope": (None, [C.c_void_p, C.c_int64]),
    "ptc_tp_set_open": (None, [C.c_void_p, C.c_int32]),
    "ptc_clock_ns": (C.c_int64, []),
    "ptc_task_fail": (None, [C.c_void_p, C.c_void_p]),
    "ptc_data_new": (C.c_void_p, [C.c_int64, C.c_void_p, C.c_int64]),
    "ptc_data_destroy": (None, [C.c_void_p]),
    "ptc_data_host_copy": (C.c_void_p, [C.c_void_p]),
    "ptc_copy_ptr": (C.c_void_p, [C.c_void_p]),
    "ptc_copy_size": (C.c_int64, [C.c_void_p]),
    "ptc_copy_handle": (C.c_int64, [C.c_void_p]),
    "ptc_copy_set_handle": (None, [C.c_void_p, C.c_int64]),
    "ptc_copy_version": (C.c_int32, [C.c_void_p]),
    "ptc_copy_is_persistent": (C.c_int32, [C.c_void_p]),
    "ptc_set_copy_release_cb": (None, [C.c_void_p, COPY_RELEASE_CB_T,
                                       C.c_void_p]),
    "ptc_set_copy_sync_cb": (None, [C.c_void_p, COPY_SYNC_CB_T,
                                    C.c_void_p]),
    "ptc_set_copy_invalidate_cb": (None, [C.c_void_p, COPY_INVALIDATE_CB_T,
                                          C.c_void_p]),
    "ptc_task_local": (C.c_int64, [C.c_void_p, C.c_int32]),
    "ptc_task_class": (C.c_int32, [C.c_void_p]),
    "ptc_task_priority": (C.c_int32, [C.c_void_p]),
    "ptc_task_data_ptr": (C.c_void_p, [C.c_void_p, C.c_int32]),
    "ptc_task_copy": (C.c_void_p, [C.c_void_p, C.c_int32]),
    "ptc_task_taskpool": (C.c_void_p, [C.c_void_p]),
    "ptc_task_complete": (None, [C.c_void_p, C.c_void_p]),
    "ptc_device_queue_new": (C.c_int32, [C.c_void_p]),
    "ptc_device_queue_set_weight": (None, [C.c_void_p, C.c_int32,
                                           C.c_double]),
    "ptc_device_queue_depth": (C.c_int64, [C.c_void_p, C.c_int32]),
    "ptc_device_pop": (C.c_void_p, [C.c_void_p, C.c_int32, C.c_int32]),
    # ready-peek span of the prefetch lane: every emitted copy is
    # retained and must be unpinned exactly once (parsec_core.h:355-362)
    "ptc_peek_ready": (C.c_int64, [C.c_void_p, C.c_int32,
                                   C.POINTER(C.c_int64), C.c_int64,
                                   C.c_int32]),
    # wave-granular census of a device queue: (class_id, taskpool) per
    # queued task, nothing popped or pinned
    "ptc_peek_ready_front": (C.c_int64, [C.c_void_p, C.c_int32,
                                         C.POINTER(C.c_int64),
                                         C.c_int64]),
    "ptc_copy_unpin": (None, [C.c_void_p, C.c_void_p]),
    "ptc_device_set_data_owner": (None, [C.c_void_p, C.c_int64, C.c_int32,
                                         C.c_int32]),
    "ptc_device_clear_data_owner": (None, [C.c_void_p, C.c_int64,
                                           C.c_int32]),
    "ptc_device_get_data_owner": (C.c_int32, [C.c_void_p, C.c_int64,
                                              C.POINTER(C.c_int32)]),
    "ptc_device_set_affinity_skew": (None, [C.c_void_p, C.c_double]),
    # DTD: tracked tiles, task insertion (one at a time or as a batched
    # spec stream) and the per-task tag that keys a device task's body
    "ptc_dtile_new": (C.c_void_p, [C.c_void_p, C.c_void_p]),
    "ptc_dtile_destroy": (None, [C.c_void_p, C.c_void_p]),
    "ptc_dtile_set_owner": (None, [C.c_void_p, C.c_uint32]),
    "ptc_dtask_begin": (C.c_void_p, [C.c_void_p, C.c_int32, C.c_int64,
                                     C.c_int32]),
    "ptc_dtask_arg": (C.c_int32, [C.c_void_p, C.c_void_p, C.c_int32]),
    "ptc_dtask_submit": (C.c_int32, [C.c_void_p, C.c_void_p, C.c_int64]),
    "ptc_dtask_insert_batch": (C.c_int64, [C.c_void_p, C.c_void_p,
                                           C.POINTER(C.c_int64), C.c_int64,
                                           C.c_int64]),
    "ptc_dtask_nb_flows": (C.c_int32, [C.c_void_p]),
    "ptc_dtask_set_rank": (None, [C.c_void_p, C.c_int32]),
    "ptc_task_set_tag": (None, [C.c_void_p, C.c_int64]),
    "ptc_task_get_tag": (C.c_int64, [C.c_void_p]),
    # tracing: the native per-worker event buffers, their flight-recorder
    # ring and dump, and externally sourced events (the device's spans)
    "ptc_profile_enable": (None, [C.c_void_p, C.c_int32]),
    "ptc_profile_take": (C.c_int64, [C.c_void_p, C.POINTER(C.c_int64),
                                     C.c_int64]),
    "ptc_profile_level": (C.c_int32, [C.c_void_p]),
    "ptc_profile_set_ring": (None, [C.c_void_p, C.c_int64]),
    "ptc_profile_ring": (C.c_int64, [C.c_void_p]),
    "ptc_profile_dropped": (C.c_int64, [C.c_void_p]),
    "ptc_flight_dump": (C.c_int32, [C.c_void_p, C.c_char_p]),
    "ptc_flight_set_dump_path": (None, [C.c_void_p, C.c_char_p]),
    "ptc_prof_event": (None, [C.c_void_p, C.c_int64, C.c_int64, C.c_int64,
                              C.c_int64, C.c_int64, C.c_int64]),
    "ptc_task_scope": (C.c_int64, [C.c_void_p]),
    "ptc_worker_stats": (C.c_int64, [C.c_void_p, C.POINTER(C.c_int64), C.c_int64]),
    "ptc_worker_steals": (C.c_int64, [C.c_void_p, C.POINTER(C.c_int64), C.c_int64]),
    "ptc_metrics_enable": (None, [C.c_void_p, C.c_int32]),
    "ptc_metrics_set_release_sample": (None, [C.c_void_p, C.c_int32]),
    # always-on histograms: snapshot, class interning, the open-EXEC
    # slots the watchdog scans, and external samples (the device's stall)
    "ptc_metrics_enabled": (C.c_int32, [C.c_void_p]),
    "ptc_metrics_record": (None, [C.c_void_p, C.c_int32, C.c_int32,
                                  C.c_int64]),
    "ptc_metrics_intern": (C.c_int32, [C.c_void_p, C.c_char_p]),
    "ptc_metrics_nclasses": (C.c_int32, [C.c_void_p]),
    "ptc_metrics_class_name": (C.c_int32, [C.c_void_p, C.c_int32,
                                           C.c_char_p, C.c_int32]),
    "ptc_metrics_layout": (None, [C.POINTER(C.c_int64)]),
    "ptc_metrics_snapshot": (C.c_int64, [C.c_void_p, C.POINTER(C.c_int64),
                                         C.c_int64, C.c_int32]),
    "ptc_metrics_inflight": (C.c_int64, [C.c_void_p, C.POINTER(C.c_int64),
                                         C.c_int64]),
    "ptc_metrics_peer_rtts": (C.c_int32, [C.c_void_p, C.POINTER(C.c_int64),
                                          C.c_int32]),
    # PINS: one synchronous sink at the trace event points
    "ptc_set_pins_cb": (None, [C.c_void_p, PINS_CB_T, C.c_void_p,
                               C.c_uint64]),
    # the journal's fatal-signal crash dump
    "ptc_crash_arm": (C.c_int32, [C.c_void_p, C.c_char_p]),
    "ptc_crash_update_meta": (None, [C.c_void_p]),
    "ptc_crash_disarm": (None, [C.c_void_p]),
    "ptc_crash_dump_now": (C.c_int32, [C.c_void_p]),
    # rank identity and the rank permutation a plan's remap installs
    "ptc_context_set_rank": (None, [C.c_void_p, C.c_uint32, C.c_uint32]),
    "ptc_context_set_rank_map": (None, [C.c_void_p,
                                        C.POINTER(C.c_int32), C.c_int32]),
    # the comm engine (native/comm.cpp): transport, fences, termination
    # detection, counters, the clock-sync estimate and peer blobs
    "ptc_comm_init": (C.c_int32, [C.c_void_p, C.c_int32]),
    "ptc_comm_fence": (C.c_int32, [C.c_void_p]),
    "ptc_comm_quiesce": (C.c_int32, [C.c_void_p, C.c_void_p]),
    "ptc_comm_set_topology": (None, [C.c_void_p, C.c_int32]),
    "ptc_comm_fini": (C.c_int32, [C.c_void_p]),
    "ptc_comm_enabled": (C.c_int32, [C.c_void_p]),
    "ptc_comm_stats": (None, [C.c_void_p, C.POINTER(C.c_int64)]),
    "ptc_comm_rdv_stats": (None, [C.c_void_p, C.POINTER(C.c_int64)]),
    "ptc_comm_tuning": (None, [C.c_void_p, C.POINTER(C.c_int64)]),
    "ptc_comm_stream_stats": (None, [C.c_void_p, C.POINTER(C.c_int64)]),
    "ptc_comm_clock_stats": (None, [C.c_void_p, C.POINTER(C.c_int64)]),
    "ptc_comm_clock_sync": (C.c_int64, [C.c_void_p]),
    "ptc_comm_share_blob": (C.c_int32, [C.c_void_p, C.c_char_p, C.c_int64]),
    "ptc_comm_peer_blob": (C.c_int64, [C.c_void_p, C.c_int32, C.c_void_p,
                                       C.c_int64]),
    "ptc_comm_peers_lost": (C.c_int32, [C.c_void_p, C.POINTER(C.c_int64),
                                        C.c_int32]),
    "ptc_comm_peer_stats": (C.c_int32, [C.c_void_p, C.POINTER(C.c_int64),
                                        C.c_int32]),
    "ptc_comm_probe_rtts": (C.c_int32, [C.c_void_p]),
    # runtime-native collectives' counters (the ptc_coll_* classes)
    "ptc_coll_stats": (None, [C.c_void_p, C.POINTER(C.c_int64)]),
    # the device data plane
    "ptc_set_dataplane": (None, [C.c_void_p, DP_REGISTER_CB_T, DP_SERVE_CB_T,
                                 DP_SERVE_DONE_CB_T, DP_DELIVER_CB_T,
                                 DP_BOUND_CB_T, C.c_void_p]),
    "ptc_set_dp_can_pull": (None, [C.c_void_p, C.c_int32]),
    "ptc_set_dp_stream": (None, [C.c_void_p, DP_STREAM_CB_T]),
    "ptc_dp_serve_progress": (C.c_int32, [C.c_void_p, C.c_uint64,
                                          C.c_void_p, C.c_uint64,
                                          C.c_uint64]),
    "ptc_tp_scope": (C.c_int64, [C.c_void_p]),
}

for _name, (_res, _args) in _sigs.items():
    fn = getattr(lib, _name)
    fn.restype = _res
    fn.argtypes = _args


def peek_buffer(max_tasks: int):
    """A span buffer that holds ptc_peek_ready's records for max_tasks
    tasks."""
    return (C.c_int64 * (max_tasks * (2 + 4 * MAX_FLOWS)))()


def peek_ready(ctx_ptr, qid: int, buf, max_tasks: int) -> list:
    """The ready tasks queued on a device queue, not popped:
    [(task_ref, [(copy_ptr, data_ptr, size, version), ...]), ...], one
    record per read flow (the span: per task task_ref, n_copies, then
    four words per copy).  Every copy_ptr returned is retained and must
    be unpinned exactly once (ptc_copy_unpin)."""
    n = lib.ptc_peek_ready(ctx_ptr, qid, buf, len(buf), max_tasks)
    out, w = [], 0
    while w + 2 <= n:
        tref, nc = buf[w], buf[w + 1]
        w += 2
        out.append((tref, [tuple(buf[w + 4 * i:w + 4 * i + 4])
                           for i in range(nc)]))
        w += 4 * nc
    return out
