"""Typed parameter registry (the MCA param system).

Parameters are registered with type+default and resolved with ascending
priority
    defaults  <  config file  <  environment  <  programmatic set
Environment spelling: PTC_MCA_<name with '.' -> '_'>.  The config file is
./ptc.conf ("name = value" lines, '#' comments).  Registered: runtime.*,
sched.*, serve.* (the reference's, read by nothing yet there either),
the debug streams' debug.runtime, debug.comm and debug.device, the
control.spec_* knobs of the serving engine, device.cache_bytes,
device.affinity_skew and the device pipeline's knobs (device.prefetch,
prefetch_depth, staging_slots, out_of_core, overcommit), the wave
compiler's device.wave_fuse and wave_fuse_depth, the pre-run
device.plan_check, and the DTD
front end's dtd.window_size and dtd.insert_batch, the observability
hooks (runtime.pins, live, metrics_port, watchdog, journal and their
settings), the analyses' plan.*, scope.*, tune.* and control.* params,
runtime.mag_batch and coll.econ_path, and the comm engine's and the
collectives' comm.* and coll.* knobs with device.stream_serve.
"""
import os
from typing import Any, Callable, Dict, Optional

_BOOL_TRUE = {"1", "true", "yes", "on"}
_BOOL_FALSE = {"0", "false", "no", "off"}


def _coerce(raw: str, ty: type):
    if ty is bool:
        low = str(raw).strip().lower()
        if low in _BOOL_TRUE:
            return True
        if low in _BOOL_FALSE:
            return False
        raise ValueError(f"not a boolean: {raw!r}")
    return ty(raw)


class Param:
    __slots__ = ("name", "default", "type", "help", "value", "source")

    def __init__(self, name, default, ty, help_):
        self.name = name
        self.default = default
        self.type = ty
        self.help = help_
        self.value = None     # programmatic override
        self.source = "default"


class Params:
    def __init__(self, env_prefix: str = "PTC_MCA_",
                 files: Optional[list] = None):
        self.env_prefix = env_prefix
        self.files = files if files is not None else ["ptc.conf"]
        self._reg: Dict[str, Param] = {}
        self._file_vals: Optional[Dict[str, str]] = None

    def _load_files(self) -> Dict[str, str]:
        if self._file_vals is None:
            vals: Dict[str, str] = {}
            for path in self.files:
                try:
                    with open(path) as f:
                        for line in f:
                            line = line.split("#", 1)[0].strip()
                            if not line or "=" not in line:
                                continue
                            k, v = line.split("=", 1)
                            vals[k.strip()] = v.strip()
                except OSError:
                    continue
            self._file_vals = vals
        return self._file_vals

    def _env_name(self, name: str) -> str:
        return self.env_prefix + name.replace(".", "_")

    def register(self, name: str, default: Any, ty: Optional[type] = None,
                 help: str = "") -> str:
        """Idempotent: re-registering keeps the first definition."""
        if name not in self._reg:
            self._reg[name] = Param(name, default,
                                    ty or type(default), help)
        return name

    def get(self, name: str) -> Any:
        p = self._reg[name]
        if p.value is not None or p.source == "set":
            return p.value
        env = os.environ.get(self._env_name(name))
        if env is not None:
            return _coerce(env, p.type)
        fv = self._load_files().get(name)
        if fv is not None:
            return _coerce(fv, p.type)
        return p.default

    def source_of(self, name: str) -> str:
        p = self._reg[name]
        if p.source == "set":
            return "set"
        if os.environ.get(self._env_name(name)) is not None:
            return "env"
        if name in self._load_files():
            return "file"
        return "default"

    def set(self, name: str, value: Any):
        p = self._reg[name]
        # bool is an int subclass: route bools given for int params (and
        # any non-exact type) through the param's constructor, not str()
        if type(value) is p.type:
            p.value = value
        elif isinstance(value, str):
            p.value = _coerce(value, p.type)
        else:
            p.value = p.type(value)
        p.source = "set"

    def unset(self, name: str):
        p = self._reg[name]
        p.value = None
        p.source = "default"

    def reload_files(self):
        self._file_vals = None

    def dump_help(self, write: Callable[[str], None] = None) -> str:
        lines = []
        for name in sorted(self._reg):
            p = self._reg[name]
            lines.append(f"{name} <{p.type.__name__}> "
                         f"[{self.get(name)!r} from {self.source_of(name)}]"
                         f"  {p.help}")
        text = "\n".join(lines)
        if write:
            write(text)
        return text


params = Params()
register = params.register
get = params.get
set_param = params.set
dump_help = params.dump_help

register("runtime.sched", "lws", str,
         "scheduler module (reference: --mca sched <m>)")
register("debug.runtime", 0, int,
         "runtime-subsystem verbosity: >=1 prints taskpool lifecycle "
         "diagnostics (reference: the per-subsystem debug output "
         "streams, parsec/utils/debug.c)")
register("debug.comm", 0, int,
         "comm-subsystem verbosity: >=1 prints mesh/fence diagnostics")
register("debug.device", 0, int,
         "device-subsystem verbosity: >=1 prints stage/flush "
         "diagnostics")
register("runtime.vpmap", "flat", str,
         "virtual-process map: 'flat' (one vp) or an explicit "
         "comma-separated vp id per worker ('0,0,1,1')")
register("runtime.bind", "none", str,
         "worker thread binding: none|core — core pins workers "
         "round-robin over the allowed cpuset")
register("runtime.nb_workers", 0, int,
         "worker threads; 0 = hardware count")
register("runtime.profile", False, bool, "enable event tracing at init")
register("runtime.trace_ring", 0, int,
         "flight-recorder mode: bound each worker's trace buffer to this "
         "many bytes, overwriting oldest events when full; 0 = unbounded")
register("runtime.trace_dump", "", str,
         "flight-recorder dump path prefix for the first taskpool abort")
register("runtime.stats", False, bool,
         "print the counter dump (stats_dump) to stderr at context "
         "teardown")
register("runtime.metrics", True, bool,
         "always-on native latency histograms; 0 disables recording")
register("runtime.metrics_relsample", 64, int,
         "release-latency sampling stride (rounded up to a power of two)")
# observability hooks (profiling/): applied at Context init
register("runtime.pins", "", str,
         "comma-separated PINS instrumentation modules to install at init "
         "(reference: --mca pins <list>, parsec/mca/pins/pins.h); "
         "names from parsec_tpu_torch.profiling.pins.REGISTRY")
register("runtime.live", "", str,
         "live metrics sampling interval in seconds (empty = off): a "
         "sampler thread appends JSON counter snapshots to "
         "$TMPDIR/ptc_live_{rank}.jsonl (reference: the aggregator_visu "
         "live-metrics role, minimal file-sink form)")
register("runtime.live_max_bytes", 64 * 1024 * 1024, int,
         "LiveMonitor JSONL sink rotation threshold: when the sink "
         "exceeds this many bytes it rotates to <path>.1 (one "
         "generation kept) so long serving runs cannot grow /tmp "
         "unboundedly; <= 0 disables rotation")
register("runtime.metrics_port", 0, int,
         "Prometheus scrape endpoint port (127.0.0.1): GET /metrics = "
         "exposition text, /stats.json = raw counters, /healthz = "
         "watchdog status.  0 = no endpoint; a fixed port is per-rank "
         "(SPMD ranks on one host each need their own)")
register("runtime.watchdog", "", str,
         "health watchdog interval in seconds (empty/0 = off): a "
         "monitor thread detects stuck tasks (EXEC open past the "
         "per-class adaptive deadline k*p99), starved workers, "
         "rendezvous pulls not advancing, and slow ranks (fence-time "
         "clock-sync RTT outliers, rank 0).  Each detection emits a "
         "structured event and triggers a flight-recorder dump when "
         "tracing is on")
register("runtime.watchdog_k", 8.0, float,
         "stuck-task deadline multiplier: a body is stuck when its open "
         "time exceeds max(k * p99(class), watchdog_floor_s)")
register("runtime.watchdog_floor_s", 30.0, float,
         "stuck-task deadline floor in seconds: bodies with thin "
         "histograms (cold classes, first kernel builds) are never "
         "flagged before this — the tier-1-suite no-false-positive "
         "guard")
register("runtime.journal", "", str,
         "black-box event journal directory (ptc-blackbox; empty = off): "
         "each rank appends schema-versioned JSONL records (watchdog, "
         "scope/control events, serve admission, fence epochs, peer "
         "loss, inventory checkpoints) to <dir>/journal.<rank>.jsonl "
         "with size-capped rotation and batched fsync, and arms the "
         "fatal-signal crash dump to <dir>/crash.<rank>.ptt")
register("runtime.journal_fsync_s", 0.5, float,
         "journal fsync cadence in seconds: records are buffered and "
         "flushed+fsynced by the cadence thread so the hot path never "
         "blocks on disk; <= 0 fsyncs on every flush tick")
register("runtime.journal_max_bytes", 64 * 1024 * 1024, int,
         "journal rotation threshold (like runtime.live_max_bytes): "
         "past this many bytes the journal rotates to <path>.1, one "
         "generation kept; <= 0 disables rotation")
register("runtime.journal_checkpoint_s", 5.0, float,
         "inventory checkpoint cadence in seconds: the journal "
         "periodically records recovery-relevant inventory (live scope "
         "ids, QoS pool census, registered providers such as frozen "
         "page keys) in the local journal (one rank: nothing is sent "
         "to peers); <= 0 disables checkpoints")
register("runtime.journal_crash_dump", True, bool,
         "arm the async-signal-safe SIGSEGV/SIGABRT/SIGBUS handler when "
         "the journal is enabled: on a fatal signal the flight-recorder "
         "ring + inflight-slots snapshot is write()n to "
         "<dir>/crash.<rank>.ptt before re-raising")
register("runtime.fleet_scrape_s", 2.0, float,
         "FleetView scrape cadence in seconds (used when a FleetView is "
         "started without an explicit interval): each tick scrapes every "
         "replica's stats + health and folds tenant histograms fleet-wide")
register("dtd.window_size", 8000, int,
         "DTD discovery window (reference: parsec_dtd_window_size)")
register("dtd.insert_batch", 256, int,
         "tasks per native crossing for DtdTaskpool.insert_tasks: the "
         "batched spec stream is chunked at this size so the window "
         "throttle still engages mid-batch and the spec buffer stays "
         "bounded; <= 1 degenerates to one crossing per task")
register("sched.bypass", True, bool,
         "same-worker ready-task bypass: a worker completing a task "
         "executes its highest-priority ready successor directly")
register("sched.qos_preempt", True, bool,
         "per-pool QoS wave-boundary preemption under the lws scheduler")
register("serve.admission_grace_s", 0.0, float,
         "Server: seconds a rejected submission is retried internally "
         "before the reject counter ticks (0 = reject immediately; "
         "backpressure-sensitive clients can poll the ticket instead)")
register("control.spec_k_max", 4, int,
         "ptc-pilot adaptive speculation ceiling: engines built with "
         "spec_k='auto' size their verify scratch for this k and the "
         "per-tenant bandit picks 0..max from live acceptance")
register("control.spec_window", 4, int,
         "adaptive-speculation acceptance window, in verify waves per "
         "tenant: shrink/grow decisions read the mean acceptance over "
         "this many most recent waves")
register("control.spec_accept_low", 0.45, float,
         "shrink threshold: a tenant whose windowed draft acceptance "
         "falls below this fraction has its spec_k halved (floor 1 — "
         "only page pressure disables speculation outright)")
register("control.spec_accept_high", 0.80, float,
         "re-expand threshold: a tenant whose windowed acceptance "
         "sustains at or above this fraction for a full spec_window "
         "grows its spec_k by one, up to control.spec_k_max")
register("control.spec_page_floor", 0.25, float,
         "page-pressure disable: when the pool's free+cached fraction "
         "drops below this floor (or a speculative reservation just "
         "failed), adaptive tenants decode plainly (k=0) until the "
         "fraction recovers above the floor")
register("device.cache_bytes", 0, int,
         "device byte-budget override: when > 0 every CudaDevice created "
         "without an explicit cache_bytes argument uses this budget "
         "instead of the 4 GiB constructor default")
register("device.affinity_skew", 4.0, float,
         "data-affinity spill guard for best-device routing: a queue "
         "holding a current mirror of a task's flow wins over pure load "
         "unless its load exceeds skew * the least-loaded candidate; "
         "<=0 disables the affinity pass")
register("device.prefetch", True, bool,
         "device prefetch lane: a dedicated thread walks the runtime's "
         "ready-task lookahead (ptc_peek_ready) and stages the NEXT "
         "wave's h2d while the manager computes the current one; a wave "
         "whose inputs were all prefetched dispatches with zero "
         "synchronous h2d (reference analog: the CUDA stage-in stream "
         "overlapping the exec stream, device_cuda_module.c:2197)")
register("device.prefetch_depth", 64, int,
         "max ready tasks the prefetch lane peeks per sweep (the "
         "lookahead window fed to ptc_peek_ready)")
register("device.staging_slots", 2, int,
         "bounded in-flight prefetch wave buffers: the lane stages at "
         "most this many waves (of batch_max tasks each) beyond the one "
         "executing, double-buffered so prefetch writes never collide "
         "with in-flight reads; a slot frees when its wave's tiles have "
         "been consumed or invalidated")
register("device.out_of_core", True, bool,
         "degrade to panel-cyclic out-of-core execution when the "
         "working set exceeds the device byte budget: dirty mirrors of "
         "persistent (collection-backed) tiles spill through the "
         "writeback lane — d2h, host becomes authoritative, mirror "
         "evicted, re-staged on demand — instead of pinning HBM until "
         "the pool OOMs (reference: the reserve/evict protocol of "
         "parsec_gpu_data_reserve_device_space, device_cuda_module.c:864)")
register("device.overcommit", 1.5, float,
         "hard residency cap as a multiple of cache_bytes: when spills "
         "are in flight the manager may transiently run the cache past "
         "budget, but at overcommit * cache_bytes it drains the "
         "writeback lane between waves (bounded memory under "
         "out-of-core pressure); <= 1 drains at any overrun")
register("device.plan_check", "off", str,
         "pre-run static residency check (parsec_tpu_torch.analysis."
         "plan): off|warn|error.  At Taskpool.run, every attached device "
         "plans the pool's device-class working set and compares the "
         "predicted per-rank peak against its cache_bytes budget: "
         "over-budget with device.out_of_core=0 warns (or raises with "
         "'error'); with out-of-core on it reports the predicted spill "
         "count instead.  Counters export as stats()['plan']")
register("device.wave_fuse", True, bool,
         "wave fusion (device/fuse.py): certified homogeneous waves "
         "popped by the device manager dispatch through the wave "
         "compiler — counted and span-marked — and waves the static "
         "plan proves form a producer->consumer chain run as ONE chain: "
         "the consumer waves' kernels run right after the producer "
         "wave's on the exec stream, fed from its output stacks on the "
         "card, and their results are parked, so their tasks complete "
         "with ZERO device launches (every parked result is "
         "version-checked against the real task's input copies at "
         "consumption — any mismatch falls back to a normal dispatch).  "
         "0 reproduces the per-group batched dispatch bit-exactly")
register("device.wave_fuse_depth", 8, int,
         "max waves fused into one chain (the chain segment length): "
         "each extra wave removes one dispatch but holds one more wave "
         "of output stacks on the card until its tasks consume them")

# the static analyses (analysis/) and the controller
register("plan.max_instances", 200_000, int,
         "ptc-plan concrete-enumeration budget (shared with the "
         "verifier's default): execution spaces past this many "
         "instances degrade to the symbolic interval bounds with an "
         "explicit note instead of silently truncating")
register("scope.conformance_window", 2048, int,
         "pools per conformance epoch (profiling/scope.py): the "
         "fold-only aggregates roll over to a fresh generation every "
         "this-many retired pools (one previous generation kept), so a "
         "long soak's conformance rollup reads O(window) state and "
         "tracks the RECENT plan-vs-measured ratio — what the ptc-pilot "
         "controller's drift detection needs — instead of a "
         "run-lifetime average; <= 0 restores the unbounded fold")
register("tune.cache_path", "", str,
         "persisted autotuning winners (analysis/tune.py TuneStore): "
         "JSON keyed by (graph signature, host fingerprint), applied "
         "by Taskpool.run(tuned=True).  Empty = ~/.ptc/tuned.json")
register("control.drift_ratio", 1.25, float,
         "ptc-pilot drift threshold: the controller declares model "
         "drift when the median measured/lower-bound makespan ratio "
         "over its control.window most recent planned pools exceeds "
         "this value — then re-runs the schedule simulator on the "
         "recalibrated cost model and hot-swaps the winning knob "
         "vector at the next pool boundary")
register("control.window", 8, int,
         "ptc-pilot observation window, in retired planned pools: "
         "drift must be sustained across a FULL window before a retune "
         "fires (single-pool spikes never trigger), and the window "
         "clears after every evaluation")
register("control.cooldown", 16, int,
         "ptc-pilot retune cooldown, in retired pools: after an "
         "evaluation the controller ignores drift for this many pools "
         "so a swap's own transient (caches refilling, knobs "
         "re-binding) cannot trigger an immediate second retune")
register("control.budget_min_share", 0.10, float,
         "dynamic cached-page budgets: the smallest cached-free LRU "
         "share a tenant can be squeezed to when the controller "
         "re-weights shares by prefix hit rate (keeps a cold tenant "
         "from being evicted to zero)")

# the comm engine (native/comm.cpp reads the PTC_MCA_comm_* env spelling
# at comm_init) and the runtime-native collectives (comm/coll.py)
register("comm.base_port", 29650, int, "TCP rendezvous base port")
register("comm.bcast_topo", "star", str,
         "activation broadcast topology: star|chain|binomial "
         "(reference: runtime_comm_coll_bcast)")
register("comm.engine", "tcp", str,
         "comm-engine transport module (reference: the parsec_comm_engine "
         "vtable seam, parsec_comm_engine.h:14-21)")
register("comm.eager_limit", 64 * 1024, int,
         "payloads <= this ride inline in ACTIVATE; larger ones are pulled "
         "via GET rendezvous (reference: runtime_comm_short_limit, "
         "remote_dep_mpi.c:241-253); negative disables rendezvous.  Set "
         "the env form (PTC_MCA_comm_eager_limit) to the string 'auto' "
         "to derive the threshold at comm init from the measured "
         "per-peer round trip and host memcpy rate (Context.comm_tuning() "
         "reports the threshold in force)")
register("comm.eager_adaptive", False, bool,
         "derive the eager/rendezvous threshold at comm init instead of "
         "using the fixed comm.eager_limit: PING/PONG probes measure the "
         "per-peer RTT, a memcpy calibration measures the per-byte copy "
         "cost, and the threshold lands where the payload's copy time is "
         "4x the round trip a rendezvous adds (<=25% RTT overhead at the "
         "crossover; clamped to [16 KiB, 16 MiB]).  The derived value is "
         "reported by Context.comm_tuning()")
register("comm.chunk_size", 1 << 20, int,
         "rendezvous payloads above this stream as pipelined ranged "
         "chunks (GET[offset,len] -> PUT_CHUNK) instead of one frame: "
         "the wire, the producer's serve and the consumer's reassembly "
         "overlap, and fences/activations interleave between chunks "
         "instead of stalling behind one giant frame.  <= 0 disables "
         "chunking (whole-payload pulls)")
register("comm.inflight", 4, int,
         "chunked-pull window: how many ranged GETs a consumer keeps "
         "outstanding per pull.  Bounds in-flight memory to "
         "inflight * chunk_size per pull while keeping the pipe full")
register("comm.topology", "", str,
         "hosts-and-islands topology spec (';' separates islands, '|' "
         "hosts, ',' ranks: \"0,1|2,3;4,5|6,7\"), or a path to a JSON "
         "file {\"islands\": [[[ranks...],...],...]}.  Empty = flat "
         "mesh (every non-self pair classes 'ici').  Drives link-class "
         "pricing, hierarchical collective trees, plan.remap_ranks and "
         "the per-class stats split (comm/topology.py)")
register("comm.stream", True, bool,
         "progressive streaming serve (wire v4): a chunked pull of a "
         "device-resident payload streams d2h slices through "
         "ptc_dp_serve_progress — ranged GETs at or below the ready-"
         "bytes watermark are answered immediately, the rest park on "
         "the session and flush as the watermark advances, so the wire "
         "starts after the FIRST d2h slice instead of the last.  0 "
         "reproduces the serialized d2h-then-wire serve "
         "bit-exactly")
register("coll.topo", "auto", str,
         "runtime-native collective topology (parsec_tpu_torch.comm.coll): "
         "ring|binomial|star, or 'auto' to choose per (message size, "
         "rank count) from the BENCH_comm.json transfer-economics fits "
         "(fixed overhead + per-byte cost; see comm/economics.py).  The "
         "fan-out legs of bcast/all_gather map star|chain|binomial onto "
         "the native ACTIVATE_BCAST trees (comm.bcast_topo machinery)")
register("coll.slice", 0, int,
         "collective slice quantum in bytes: a producer tile enters a "
         "runtime-native collective in slices of this size, each its own "
         "pipelined dataflow chain, so the wire (and the downstream "
         "partial reduction) starts after the FIRST slice instead of "
         "the last (T3, arXiv:2401.16677).  0 = use comm.chunk_size, "
         "so collective slicing and wire chunking stay aligned")
register("coll.max_slices", 16, int,
         "cap on slices per collective segment (bounds task count per "
         "op; tiny messages collapse to one slice)")
register("comm.chunk_size.ici", "", str,
         "per-class override of comm.chunk_size for intra-island "
         "(ici) legs; '' = inherit comm.chunk_size")
register("comm.chunk_size.dcn", "", str,
         "per-class override of comm.chunk_size for inter-island "
         "(dcn) legs — bigger chunks amortize the higher DCN fixed "
         "cost; '' = inherit comm.chunk_size")
register("comm.eager_limit.ici", "", str,
         "per-class override of comm.eager_limit for ici legs; "
         "'' = inherit comm.eager_limit.  Read by the tuner's simulator, "
         "which prices each cross-rank edge at its class; the engine "
         "runs one comm.eager_limit")
register("comm.eager_limit.dcn", "", str,
         "per-class override of comm.eager_limit for dcn legs — the "
         "eager/rendezvous crossover sits lower where per-byte cost is "
         "higher; '' = inherit comm.eager_limit.  Read by the tuner's "
         "simulator; the engine runs one comm.eager_limit")
register("coll.topo.ici", "", str,
         "per-class override of coll.topo for the intra-island phase "
         "of hierarchical collectives; '' = inherit coll.topo")
register("coll.topo.dcn", "", str,
         "per-class override of coll.topo for the inter-island "
         "(leader) phase of hierarchical collectives; '' = inherit "
         "coll.topo")
register("device.stream_serve", True, bool,
         "accept the comm engine's progressive-serve offers "
         "(dp_serve_stream): the writeback lane d2h's the remote-pulled "
         "mirror in comm.chunk_size slices, each advancing the serve "
         "session's watermark, so the wire overlaps the d2h instead of "
         "waiting for the whole-tile snapshot.  0 declines every offer "
         "(the synchronous dp_serve path serves, as in comm.stream=0)")
register("device.dp_transfer", False, bool,
         "cross-process device data plane over CUDA IPC: a PK_DEVICE "
         "payload pulled by a NON-colocated rank in another process on "
         "this host and card is served as a token (the payload's CUDA "
         "IPC memory and event handles) instead of d2h+TCP+h2d, and the "
         "consumer copies it card to card.  Each rank probes at device "
         "init what one process can check (CUDA is up and a tensor "
         "shares under the allocator settings in force; "
         "expandable_segments refuses it) and advertises the verdict on "
         "GET frames, together with its host and card identity, so a "
         "producer serves tokens only to capable pullers on its own "
         "card and real bytes to everyone else.  The probe does NOT "
         "open a handle (a process cannot open its own): a pull that "
         "fails after its token was sent counts in dp_errors and ABORTS "
         "the consuming pool (the real bytes were never sent).  Create "
         "the device after comm_init: the identity rides the comm "
         "engine")
register("device.dp_pull", True, bool,
         "this rank's willingness to PULL through the transfer plane; "
         "set 0 to force producers to serve this rank host bytes even "
         "when the probe would succeed (a per-rank escape hatch)")

# runtime.mag_batch, one of the tuner's knob axes, is read by the
# native core at context creation.  The tuner acts on the comm.* and
# coll.* knobs registered above too; the rails are constants
# (analysis/tune.py's FIXED_KNOBS, comm/topology.COMM_KNOBS).
register("runtime.mag_batch", 64, int,
         "task/arena freelist magazine batch: items moved between a "
         "worker's private magazine and the shared pool per lock "
         "acquisition (PTC_MAG_BATCH as a knob).  Bigger "
         "batches amortize the free-lock crossing further but hoard "
         "more memory per idle worker; read from the env at context "
         "creation (a live context keeps its batch).  One of the "
         "ptc-tune knob axes")
register("coll.econ_path", "", str,
         "path to a transfer-economics JSON (BENCH_comm.json schema) "
         "that the analyses price transfers with (plan, tune); empty = "
         "the repo's BENCH_comm.json when present, else built-in "
         "loopback defaults.  Neither is a fit of a CUDA card: pass a "
         "fit measured on the card (chip_smoke.py phase 10 writes one)")
