"""Typed parameter registry (the MCA param system).

Parameters are registered with type+default and resolved with ascending
priority
    defaults  <  config file  <  environment  <  programmatic set
Environment spelling: PTC_MCA_<name with '.' -> '_'>.  The config file is
./ptc.conf ("name = value" lines, '#' comments).  Registered: runtime.*,
sched.*, serve.* (the reference's, read by nothing yet there either),
the control.spec_* knobs of the serving engine, device.cache_bytes,
device.affinity_skew and the device pipeline's knobs (device.prefetch,
prefetch_depth, staging_slots, out_of_core, overcommit), and the DTD
front end's dtd.window_size and dtd.insert_batch.  The runtime.*
hooks whose modules are not ported yet (pins, live, metrics_port,
watchdog, journal) are registered so that setting one is refused loudly
by Context instead of ignored.
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
# hooks of modules this package does not port yet: Context refuses them
register("runtime.pins", "", str, "PINS modules (not ported: refused)")
register("runtime.live", "", str, "live sampler (not ported: refused)")
register("runtime.metrics_port", 0, int,
         "Prometheus endpoint (not ported: refused)")
register("runtime.watchdog", "", str, "health watchdog (not ported: refused)")
register("runtime.journal", "", str, "event journal (not ported: refused)")
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
