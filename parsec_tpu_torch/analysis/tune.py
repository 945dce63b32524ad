"""ptc-tune: static schedule simulation and plan-driven autotuning of
the runtime knob space.

The runtime exposes a hand-tuned knob surface (chunk size, rails, eager
threshold, collective topology, staging slots, cache budget, magazine
batch) while ptc-plan's engine-exact concretized instance DAG, the
histogram-seeded CostModel and the fitted transfer economics
(comm/economics.py, arXiv:2112.09017-style alpha/beta legs) already
contain everything needed to price a knob vector WITHOUT running the
job — the closed loop.  Three layers:

  simulator   `ScheduleSimulator`: a deterministic discrete-event list
              scheduling simulation over the concretized DAG — workers
              x waves x wire.  Task cost from the CostModel plus a
              modeled per-task dispatch overhead (amortized by the
              magazine batch), cross-rank edges priced by the fitted
              alpha/beta legs with eager/rendezvous split, chunk
              pipelining and rail striping, device h2d stalls gated by
              the staging slots, and cache-budget spills priced through
              `Plan.predict_spills`.  No wall clock anywhere: same
              inputs -> same numbers, bit for bit.

  search      `propose()`: deterministic coordinate descent over the
              graph-relevant knob axes (axes that cannot matter — comm
              knobs on a single-rank DAG, device knobs without device
              chores — are pruned), ranked by simulated makespan.
              `autotune()` validates the top-k with REAL runs through a
              caller-supplied `measure(knobs)` callback and records the
              `compare_critpath` predicted-vs-measured ratio per
              validation run — the regression signal that keeps the
              model honest.

  persistence `TuneStore`: winners keyed by (graph signature, host
              provenance fingerprint) in a JSON cache
              (PTC_MCA_tune_cache_path, default ~/.ptc/tuned.json) that
              `Taskpool.run(tuned=True)` looks up and holds its run
              to: the run raises unless the vector is in force on the
              runtime the pool runs on (below).

The knob vector is applied through `apply_knobs()`: both the Python MCA
registry (programmatic set) and the PTC_MCA_* environment (the native
context reads env at init), snapshotting and restoring both.

Port of parsec_tpu/analysis/tune.py.  The knob registry is the
reference's, so that the simulator prices the same vector to the same
nanosecond, and the tuner acts on the same axes (`ACTED_KNOBS`) but
the engine's rails: device.staging_slots, device.cache_bytes and
device.wave_fuse (read by a CudaDevice at construction),
runtime.mag_batch (read by the native core at context creation), and
the comm.* and coll.* knobs, MCA parameters read by the comm engine at
comm_init (comm.eager_limit, comm.chunk_size) and by the collectives
and the plans when they are built (the rest).  `FIXED_KNOBS` — the
rails, comm.rails and its per-class overrides — are constants here
(comm/topology.COMM_KNOBS): the simulator prices them, `apply_knobs`
refuses to change them, and `ScheduleSimulator.knob_axes` (so
`propose` and `autotune`) keeps them at their value.  Every acted knob
binds when the runtime is created or the comm engine starts, so a
vector takes effect only for a Context and CudaDevice created under
`apply_knobs(vector)` (the tuner's validation runs do so);
`Taskpool.run(tuned=)` checks that its vector is the one in force
(`knobs_in_force`) and raises where it is not, instead of reporting a
vector that changed nothing as applied.  The closed-form collective and
streaming price models (`price_collective`, `price_stream`) and their
proposers rank the comm engine's collective and streaming knobs.

Model constants: the dispatch constants and the default transfer
economics are the reference's, calibrated on its own host (its
BENCH_dispatch and BENCH_comm reports), and are no measurement of a
CUDA host or card.  A device transfer is priced with the
`TransferEconomics` in force: pass `econ=` (or set coll.econ_path) to a
fit measured on the card, as chip_smoke.py's phase 10 does.
"""
from __future__ import annotations

import contextlib
import hashlib
import heapq
import json
import os
import sys
from typing import Callable, Dict, List, Optional, Tuple

from .. import _native as N
from ..comm.topology import COMM_KNOBS, comm_knob
from ..core import expr as E
from ..core.taskclass import Mem, Ref
from .flowgraph import FlowGraph, extract_flowgraph
from .plan import CostModel, Plan, compare_critpath, plan_graph

# ------------------------------------------------------ knob registry
# The tunable surface.  Each knob's value is applied through BOTH the
# MCA registry and the PTC_MCA_* env spelling (native init paths read
# env); see apply_knobs().
TUNE_KNOBS: Tuple[str, ...] = (
    "comm.chunk_size",      # rendezvous chunk quantum (wire pipelining)
    "comm.rails",           # striped TCP connections per peer
    "comm.eager_limit",     # eager/rendezvous payload split
    "coll.topo",            # collective topology (ring|binomial|star|auto)
    "coll.max_slices",      # slices per collective segment
    "device.staging_slots", # prefetch double-buffering depth
    "device.cache_bytes",   # device byte budget (0 = constructor default)
    "device.wave_fuse",     # wave mega-kernelization (ptc-fuse)
    "runtime.mag_batch",    # task/arena freelist magazine batch
    # ptc-topo: per-link-class overrides ("" = inherit the base knob).
    # The simulator prices each cross-rank edge at ITS class, so these
    # axes only matter (and are only searched) on multi-island meshes.
    "comm.chunk_size.ici",
    "comm.chunk_size.dcn",
    "comm.rails.ici",
    "comm.rails.dcn",
    "comm.eager_limit.ici",
    "comm.eager_limit.dcn",
    "coll.topo.ici",
    "coll.topo.dcn",
)

# The knobs of TUNE_KNOBS this package prices but does not tune: the
# engine's rails, constants here (comm.topology.COMM_KNOBS).  The
# simulator prices their value and apply_knobs refuses to change it.
FIXED_KNOBS: Tuple[str, ...] = tuple(
    k for k in TUNE_KNOBS if k in COMM_KNOBS)
# Knobs this package acts on (module docstring): every other knob.
ACTED_KNOBS: Tuple[str, ...] = tuple(
    k for k in TUNE_KNOBS if k not in FIXED_KNOBS)

# Modeled dispatch-path constants (nanoseconds), the reference's,
# calibrated against its committed BENCH_dispatch level-0 numbers (its
# host, not this package's: the card's DTD launch costs ~1 ms of
# host): the per-task dispatch floor at the default magazine batch (64)
# sits near the reference's measured ~0.25 us single-chain p50, and the
# magazine term prices the amortized free-lock crossing a refill/spill
# costs (one mutex pair per batch).
DISPATCH_BASE_NS = 220.0
DISPATCH_MAG_NS = 1600.0   # per-batch lock crossing, amortized /batch
# Per-chunk envelope floor on the streamed rendezvous path (frame
# header + ranged-GET bookkeeping): the real per-chunk cost is modeled
# as the path's fitted ALPHA leg (every chunk is its own ranged round
# on the serve lane), floored here when a fit clamps to zero.  Rail
# striping gets DIMINISHING returns (1 + (rails-1) * RAIL_EFF as the
# effective per-byte divisor): rails divide wire serialization, not
# the host memcpy/d2h legs the fits also contain.  The h2d per-byte
# cost prices dispatch stalls when staging cannot double-buffer.
# Deliberately coarse: the simulator prices RELATIVE knob changes,
# the validation runs price reality.
CHUNK_ENVELOPE_NS = 4000.0
RAIL_EFF = 0.25
H2D_BYTE_NS = 0.05
SPILL_ALPHA_NS = 20000.0


def _stripe_div(rails: int, nchunks: int) -> float:
    """Effective per-byte divisor of `rails` striped connections."""
    stripe = max(1, min(int(rails), int(nchunks)))
    return 1.0 + (stripe - 1) * RAIL_EFF


def host_fingerprint() -> str:
    """Stable host provenance fingerprint: cpu count, architecture,
    platform, page size and the CPU feature flags — the tuner's
    persistence key (a knob vector tuned on one box must not silently
    apply on a different one).  Shared with bench.host_provenance()."""
    cpus = os.cpu_count() or 1
    try:
        page = os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        page = 4096
    flags = ""
    model = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not model and line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                if not flags and line.startswith("flags"):
                    flags = " ".join(sorted(
                        line.split(":", 1)[1].split()))
                if model and flags:
                    break
    except OSError:
        pass
    import platform
    blob = "|".join([str(cpus), platform.machine(), sys.platform,
                     str(page), model, flags])
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# --------------------------------------------------- graph signature
def _sig_expr(e) -> str:
    """Canonical, process-stable serialization of an expression tree
    (the signature analog of ExprCompiler._gen: opcode ints + symbol
    names + escape source; pt.call callbacks key by name + purity)."""
    if e is None:
        return "_"
    if isinstance(e, bool):
        return f"c{int(e)}"
    if isinstance(e, int):
        return f"c{e}"
    if isinstance(e, E.Const):
        return f"c{int(e.v)}"
    if isinstance(e, E.L):
        return f"l:{e.name}"
    if isinstance(e, E.G):
        return f"g:{e.name}"
    if isinstance(e, E.BinOp):
        return f"b{e.op}({_sig_expr(e.a)},{_sig_expr(e.b)})"
    if isinstance(e, E.UnOp):
        return f"u{e.op}({_sig_expr(e.a)})"
    if isinstance(e, E.Select):
        return (f"s({_sig_expr(e.c)},{_sig_expr(e.a)},"
                f"{_sig_expr(e.b)})")
    if isinstance(e, E.Call):
        nm = getattr(e.fn, "__name__", "fn")
        return f"call:{nm}:{int(getattr(e, 'pure', False))}"
    if isinstance(e, E.Range):
        return (f"r({_sig_expr(e.lo)},{_sig_expr(e.hi)},"
                f"{_sig_expr(e.step)})")
    if isinstance(e, E.Compr):
        return (f"cp({_sig_expr(e.lo)},{_sig_expr(e.hi)},"
                f"{_sig_expr(e.step)},{_sig_expr(e.value)},"
                f"{getattr(e, 'iter_name', None)})")
    # JDF nodes (duck-typed to avoid the import cycle)
    code = getattr(e, "code", None)
    if code is not None:
        return f"esc:{code}"
    name = getattr(e, "name", None)
    if name is not None:
        return f"n:{name}"
    return f"?{type(e).__name__}"


def _sig_target(t) -> str:
    if t is None:
        return "none"
    if isinstance(t, Ref):
        ps = ",".join(_sig_expr(p) for p in t.params)
        return f"ref:{t.task}({ps})@{t.flow}"
    if isinstance(t, Mem):
        ix = ",".join(_sig_expr(x) for x in t.idx)
        return f"mem:{t.collection}[{ix}]"
    return f"?{type(t).__name__}"


def graph_signature(tp) -> str:
    """Content hash of a taskpool's compiled shape: classes (locals,
    flows, deps, guards, targets, bodies, affinity), global values, and
    the registered collections' geometry.  Two pools built the same way
    over the same problem size share a signature — the tuning-cache
    key's graph half."""
    parts: List[str] = []
    gdict = {nm: int(N.lib.ptc_tp_global(tp._ptr, idx))
             for nm, idx in tp.globals_map.items()}
    parts.append("G:" + ",".join(f"{k}={v}"
                                 for k, v in sorted(gdict.items())))
    colls = getattr(tp.ctx, "collection_objs", {})
    for name in sorted(colls):
        c = colls[name]
        geo = [name]
        for attr in ("mt", "nt", "mb", "nb", "nodes", "elem_size"):
            if hasattr(c, attr):
                geo.append(f"{attr}={getattr(c, attr)}")
        if hasattr(c, "dtype"):
            geo.append(f"dtype={c.dtype}")
        parts.append("C:" + ";".join(str(g) for g in geo))
    for tc in tp.classes:
        cparts = [f"T:{tc.name}"]
        for (nm, is_range, payload) in tc.locals:
            cparts.append(f"p:{nm}:{int(is_range)}:{_sig_expr(payload)}")
        aff = getattr(tc, "_affinity", None)
        if aff is not None:
            cparts.append("a:" + _sig_target(aff))
        for fl in tc.flows:
            fparts = [f"f:{fl.name}:{fl.access}:{fl.arena}"]
            for d in fl.deps:
                its = ";".join(
                    f"{inm}:{_sig_expr(lo)}:{_sig_expr(hi)}:{_sig_expr(st)}"
                    for (inm, lo, hi, st) in d.iters)
                fparts.append(
                    f"d{d.direction}:{_sig_target(d.target)}"
                    f":{_sig_expr(d.guard)}:{d.dtype}:{d.ltype}:{its}")
            cparts.append("|".join(fparts))
        for ch in tc.chores:
            cparts.append(f"ch:{ch.device_type}:{ch.body_kind}:"
                          f"{int(getattr(ch, 'pure', False))}")
        parts.append("||".join(cparts))
    blob = "\n".join(parts)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ------------------------------------------------------ knob handling
def default_knobs() -> Dict[str, object]:
    """The knob vector currently in force (MCA resolution order; a comm
    knob that is no parameter here answers its constant)."""
    return {k: comm_knob(k) for k in TUNE_KNOBS}


def _refuse_unacted(name: str, value) -> object:
    """The value of a knob this package does not act on, when `value`
    leaves it unchanged; raises when it would change it (ValueError) or
    when no such knob exists (KeyError).  Acted knobs pass through."""
    from ..utils import params as reg
    from ..utils.config import _coerce
    if name in ACTED_KNOBS:
        return value
    if name in reg._reg:
        cur = reg.get(name)
        same = _coerce(str(value), reg._reg[name].type) == cur
    elif name in FIXED_KNOBS:
        cur = comm_knob(name)
        same = _coerce(str(value), type(cur)) == cur
    else:
        raise KeyError(f"unknown tuning knob {name!r}")
    if not same:
        raise ValueError(
            f"tuning knob {name!r}: parsec_tpu_torch does not act on it "
            f"yet (acted knobs: {', '.join(ACTED_KNOBS)})")
    return cur


@contextlib.contextmanager
def apply_knobs(knobs: Optional[Dict[str, object]]):
    """Apply a knob vector for the duration of the with-block, through
    BOTH the MCA registry (Python-side reads) and the PTC_MCA_* env
    spelling (the native core reads env at context creation), then
    RESTORE both — the snapshot/restore that keeps one run's knobs from
    leaking into the next.  The acted knobs are read when a Context or
    CudaDevice is created, so create them inside the block.  Unknown
    knob names raise (a persisted cache from a newer version must not
    be silently half-applied), and so does a CHANGE of a knob this
    package does not act on yet (not in ACTED_KNOBS): a vector that
    changes nothing on the card must not pass for a tuned one."""
    if not knobs:
        yield {}
        return
    from ..utils import params as reg
    saved_param: Dict[str, Tuple[object, str]] = {}
    saved_env: Dict[str, Optional[str]] = {}
    applied: Dict[str, object] = {}
    try:
        for name, value in knobs.items():
            if name not in ACTED_KNOBS:
                applied[name] = _refuse_unacted(name, value)
                continue
            p = reg._reg[name]
            saved_param[name] = (p.value, p.source)
            reg.set(name, value)
            env = reg._env_name(name)
            saved_env[env] = os.environ.get(env)
            os.environ[env] = str(value)
            applied[name] = reg.get(name)
        yield applied
    finally:
        for name, (value, source) in saved_param.items():
            p = reg._reg[name]
            p.value, p.source = value, source
        for env, old in saved_env.items():
            if old is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = old


def bound_value(name: str, value):
    """An acted knob's value as the runtime binds it: the native core
    keeps a magazine batch in [1, 8192] (else its default, 64), a
    CudaDevice at least one staging slot, a cache budget of 0 is the
    device's default of 4 GiB, and wave fusion is on or off; a comm or
    collective knob is its registered type's value."""
    from ..utils import params as reg
    from ..utils.config import _coerce
    if name == "device.wave_fuse":
        return _coerce(str(value), bool)
    if name.startswith(("comm.", "coll.")):
        return _coerce(str(value), reg._reg[name].type)
    v = int(value or 0)
    if name == "runtime.mag_batch":
        return v if 1 <= v <= 8192 else 64
    if name == "device.staging_slots":
        return max(1, v)
    return v or 4 << 30


def knobs_in_force(ctx) -> Dict[str, list]:
    """The acted knobs' values bound on `ctx`'s runtime: the magazine
    batch its native core read at creation; each attached CudaDevice's
    staging slots, cache budget and wave compiler (on when it has one;
    with no device attached, the value a device created now would
    read); the eager threshold and chunk quantum the comm engine runs
    when it is up (an adaptive threshold is not a knob's value, so the
    registry's answers then); and the registry's value of every other
    comm and collective knob, which is read when a collective or a plan
    is built."""
    from ..utils import params as _mca
    devs = list(ctx._devices)

    def fresh(name):
        return [bound_value(name, _mca.get(name))]
    out = {k: fresh(k) for k in ACTED_KNOBS
           if k.startswith(("comm.", "coll."))}
    if ctx.comm_enabled:
        tuning = ctx.comm_tuning()
        if not tuning["eager_adaptive"]:
            out["comm.eager_limit"] = [tuning["eager_limit"]]
        out["comm.chunk_size"] = [tuning["chunk_size"]]
    return dict(out, **{
        "runtime.mag_batch": [ctx.mag_batch],
        "device.staging_slots": [d._pf_slots_max for d in devs]
        or fresh("device.staging_slots"),
        "device.cache_bytes": [d._cache_bytes for d in devs]
        or fresh("device.cache_bytes"),
        "device.wave_fuse": [d._fuser is not None for d in devs]
        or fresh("device.wave_fuse"),
    })


def check_tuned(ctx, knobs: Dict[str, object]) -> None:
    """Raise unless the vector `knobs` is the one in force on `ctx`'s
    runtime: an unknown knob (KeyError), a change of a knob this
    package does not act on, or an acted knob that the runtime holds
    at another value (ValueError; create the Context and CudaDevice
    under apply_knobs(knobs))."""
    force = knobs_in_force(ctx)
    off = {}
    for name, value in knobs.items():
        _refuse_unacted(name, value)
        if name in ACTED_KNOBS and any(
                v != bound_value(name, value) for v in force[name]):
            off[name] = (bound_value(name, value), force[name])
    if off:
        raise ValueError(
            "tuned knob vector not in force: " + ", ".join(
                f"{k} wants {w}, the runtime holds {h}"
                for k, (w, h) in off.items())
            + " (these knobs are read when the Context and CudaDevice "
            "are created: create them under analysis.tune.apply_knobs)")


def hold_knobs(knobs: Dict[str, object]):
    """apply_knobs, held open: apply the vector NOW (same MCA + env
    double-write, same unknown-name check) and return a zero-argument
    `restore()` that puts the snapshot back — the ptc-pilot
    controller's hot-swap primitive, where the swap must outlive any
    single with-block (it stays in force across pools until the next
    retune or teardown; the acted knobs bind the Contexts and
    CudaDevices created while it holds).  Restore is idempotent."""
    cm = apply_knobs(dict(knobs) if knobs else None)
    applied = cm.__enter__()
    done = []

    def restore():
        if done:
            return
        done.append(True)
        cm.__exit__(None, None, None)

    return applied, restore


def knob_env(knobs: Dict[str, object]) -> Dict[str, str]:
    """The PTC_MCA_* env spelling of a knob vector — what a spawned
    SPMD rank needs in its environment to run under the vector."""
    from ..utils import params as reg
    return {reg._env_name(name): str(v) for name, v in knobs.items()}


def resolve_tuned(tp, tuned) -> Optional[Dict[str, object]]:
    """Resolve Taskpool.run's `tuned=` argument to a knob vector:
    a dict passes through, True looks up the persisted store by
    (graph signature, host fingerprint) — None when no winner is
    recorded for this graph on this box."""
    if not tuned:
        return None
    if isinstance(tuned, dict):
        return dict(tuned)
    rec = TuneStore().get(graph_signature(tp), host_fingerprint())
    return dict(rec["knobs"]) if rec else None


# ------------------------------------------------------- persistence
class TuneStore:
    """Persisted tuning winners: {"version": 1, "entries":
    {graph_signature: {host_fingerprint: record}}} where record =
    {"knobs", "predicted_ns", "measured_s", "critpath_ratio",
    "source"}.  Written atomically (tmp + rename); a missing or
    garbled file reads as empty — the tuner must work on fresh
    hosts.  Path: PTC_MCA_tune_cache_path, default ~/.ptc/tuned.json
    (the reference's MIGRATION.md states the format)."""

    VERSION = 1

    def __init__(self, path: Optional[str] = None):
        if path is None:
            from ..utils import params as _mca
            path = _mca.get("tune.cache_path") or os.path.expanduser(
                "~/.ptc/tuned.json")
        self.path = path
        self._doc: Optional[dict] = None

    def load(self) -> dict:
        if self._doc is None:
            try:
                with open(self.path) as f:
                    doc = json.load(f)
                if not isinstance(doc, dict) \
                        or doc.get("version") != self.VERSION:
                    doc = {"version": self.VERSION, "entries": {}}
            except (OSError, ValueError):
                doc = {"version": self.VERSION, "entries": {}}
            self._doc = doc
        return self._doc

    def get(self, signature: str, host: str) -> Optional[dict]:
        return self.load()["entries"].get(signature, {}).get(host)

    def put(self, signature: str, host: str, record: dict):
        doc = self.load()
        doc["entries"].setdefault(signature, {})[host] = record
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        os.replace(tmp, self.path)


# -------------------------------------------------------- simulator
class ScheduleSimulator:
    """Deterministic discrete-event schedule simulation of one
    concretized taskpool under a knob vector.

    List scheduling over the engine-exact instance DAG: per-rank
    `workers` worker resources, task durations from the CostModel plus
    the modeled dispatch overhead, cross-rank delivery edges delayed by
    the fitted wire model (eager/rdv split at the knob threshold,
    chunk-pipelined + rail-striped above the chunk quantum, topology
    factor on collective-class edges), device-chore h2d stalls when
    staging cannot double-buffer, and a cache-budget spill penalty from
    the plan's residency simulation.  Pure arithmetic end to end:
    NO wall-clock reads, NO randomness — same inputs, same makespan."""

    def __init__(self, plan: Plan, cost: Optional[CostModel] = None,
                 econ=None, workers: Optional[int] = None,
                 tmodel=None):
        if plan.bounded or plan.cg is None:
            raise ValueError(
                "ScheduleSimulator needs a concrete plan (enumeration "
                "was refused; raise plan.max_instances)")
        self.plan = plan
        self.fg: FlowGraph = plan.fg
        self.cg = plan.cg
        if cost is None:
            src = plan.makespan.get("per_class_cost") or {}
            cost = CostModel(dict(src),
                             source=plan.makespan.get("cost_source",
                                                      "uniform"))
        self.cost = cost
        if econ is None:
            from ..comm.economics import default_economics
            econ = default_economics()
        self.econ = econ
        if workers is None:
            workers = int(plan.makespan.get("workers_per_rank", 1) or 1)
        self.workers = max(1, workers)
        self._prepare()
        if tmodel is None:
            from ..comm.topology import default_topology
            tmodel = default_topology(max(self.ranks, default=0) + 1)
        self.tmodel = tmodel
        self._cls_cache: Dict[Tuple[int, int], str] = {}

    # ------------------------------------------------------- prepare
    def _prepare(self):
        fg, cg = self.fg, self.cg
        from .plan import _Analyzer, _has_device_chore
        an = _Analyzer(fg, cg, Plan(fg))
        an.compute_waves()
        self._an = an
        nodes = sorted(an.inst_set)
        self.order = {n: i for i, n in enumerate(nodes)}
        self.nodes = nodes
        self.rank = {n: an._rank(n) for n in nodes}
        self.ranks = sorted(set(self.rank.values()))
        dev_cls = {cm.id for cm in fg.classes
                   if _has_device_chore(cm.tc)}
        coll_cls = {cm.id for cm in fg.classes if cm.is_coll}
        self.has_device = bool(dev_cls)
        self.has_coll = bool(coll_cls)
        self.has_wire = False
        self.exec_ns = {}
        self.in_bytes: Dict[tuple, int] = {}
        self.is_dev = {}
        for n in nodes:
            cm = fg.classes[n[0]]
            self.exec_ns[n] = float(self.cost.ns(cm.name))
            self.is_dev[n] = n[0] in dev_cls
        # ptc-fuse pricing input: nodes sitting in a CERTIFIED fusable
        # wave (plan.certify) share ONE dispatch-overhead charge when
        # the wave_fuse knob is on — the simulator's model of the wave
        # compiler collapsing a wave into one launch.  Only device
        # nodes qualify (fusion lives in the device layer).
        self.fused_width: Dict[tuple, int] = {}
        cert_w = {(c["rank"], c["wave"]): c["width"]
                  for c in self.plan.fusability
                  if c.get("fusable") and c.get("width", 0) > 1}
        for n in nodes:
            if not self.is_dev[n]:
                continue
            w = cert_w.get((self.rank[n], an.wave[n]))
            if w:
                self.fused_width[n] = w
        # per-edge payloads: mirror the release walk once, keep the max
        # payload per (src, dst) node pair + the collective flag
        self.edge_payload: Dict[Tuple[tuple, tuple], int] = {}
        self.edge_coll: Dict[Tuple[tuple, tuple], bool] = {}
        for n in nodes:
            cm = fg.classes[n[0]]
            l = an.locals_of(n)
            for fi, fl in enumerate(cm.flows):
                is_ctl = fl.access == N.FLOW_CTL
                for di, d in enumerate(fl.deps):
                    if d.direction != 1:
                        continue
                    info = cm._dep_info[(fi, di)]
                    if info["kind"] != "task":
                        continue
                    payload = 0
                    if not is_ctl:
                        if d.dtype is not None:
                            payload = fg.datatype_bytes.get(d.dtype) or 0
                        if payload == 0:
                            datum = an.datum_of(n, fi)
                            payload = an.datum_bytes(datum, n, fi)
                    peer = fg.by_name.get(info["peer"])
                    if peer is None:
                        continue
                    for kind, vals, _cert in cm.out_emissions(fi, di, l):
                        if kind != "task":
                            continue
                        dst = (peer.id, vals)
                        if dst not in self.order:
                            continue
                        key = (n, dst)
                        if payload > self.edge_payload.get(key, -1):
                            self.edge_payload[key] = payload
                        if n[0] in coll_cls or dst[0] in coll_cls:
                            self.edge_coll[key] = True
                        # h2d staging volume per destination device task
                        if dst[0] in dev_cls and not is_ctl:
                            self.in_bytes[dst] = \
                                self.in_bytes.get(dst, 0) + payload
                        if self.rank[n] != self.rank[dst]:
                            self.has_wire = True
        # predecessors (all delivery edges; a dynamically-guarded edge
        # that fires at runtime delays its consumer like any other, so
        # the simulator includes maybe-edges — the conservative read)
        self.preds: Dict[tuple, List[tuple]] = {}
        self.indeg0: Dict[tuple, int] = {n: 0 for n in nodes}
        self.succ: Dict[tuple, List[tuple]] = {}
        for src, outs in cg.succ.items():
            for dst, _certain in outs:
                if dst in self.indeg0:
                    self.indeg0[dst] += 1
                    self.succ.setdefault(src, []).append(dst)

    # ------------------------------------------------------- pricing
    def _edge_cls(self, src_rank: int, dst_rank: int) -> Optional[str]:
        """Link class of a cross-rank edge (memoized; None = unclassed
        flat pricing when no topology model is present)."""
        key = (src_rank, dst_rank)
        c = self._cls_cache.get(key)
        if c is None:
            tm = self.tmodel
            c = tm.class_of(src_rank, dst_rank) if tm is not None \
                else "ici"
            self._cls_cache[key] = c
        return c

    def _mesh_cls(self) -> Optional[str]:
        """The class collectives resolve against: 'dcn' when the mesh
        spans islands, 'ici' otherwise (matches coll._mesh_class)."""
        tm = self.tmodel
        if tm is None or len(self.ranks) <= 1:
            return None
        return "dcn" if tm.n_islands > 1 else "ici"

    @staticmethod
    def _knob_cls(kv: Dict[str, object], name: str,
                  cls: Optional[str]) -> object:
        """Per-class override of a base knob inside a knob VECTOR: the
        `{name}.{cls}` spelling when present and non-empty, else the
        base value — the vector-local mirror of
        topology.resolve_class_knob (which reads the MCA registry)."""
        if cls in ("ici", "dcn"):
            v = kv.get(f"{name}.{cls}")
            if v not in (None, ""):
                return v
        return kv[name]

    def _wire_ns(self, payload: int, kv: Dict[str, object],
                 cls: Optional[str] = None) -> float:
        econ = self.econ
        eager = int(self._knob_cls(kv, "comm.eager_limit", cls))
        if payload <= eager:
            return econ.cost(payload, "eager", cls=cls) * 1e9
        chunk = int(self._knob_cls(kv, "comm.chunk_size", cls))
        rails = max(1, int(self._knob_cls(kv, "comm.rails", cls)))
        a = econ.alpha("rdv", cls=cls) * 1e9
        b = econ.beta("rdv", cls=cls) * 1e9
        env = max(a, CHUNK_ENVELOPE_NS)
        if chunk > 0 and payload > chunk:
            nch = (payload + chunk - 1) // chunk
            return (a + (nch - 1) * env
                    + payload * b / _stripe_div(rails, nch))
        return a + payload * b

    def _coll_factor(self, payload: int, kv: Dict[str, object]) -> float:
        cls = self._mesh_cls()
        topo = self._knob_cls(kv, "coll.topo", cls) or "auto"
        nranks = max(2, len(self.ranks))
        costs = self.econ.topology_costs("reduce", max(1, payload),
                                         nranks, cls=cls,
                                         tmodel=self.tmodel)
        best = min(costs.values())
        if best <= 0:
            return 1.0
        if topo in costs:
            return costs[topo] / best
        return 1.0  # auto = the selector picks the best

    def _slice_overhead_ns(self, kv: Dict[str, object],
                           payload: int) -> float:
        """Per-collective-edge slicing cost: more slices pipeline the
        wire but each slice is its own task chain (dispatch + frame)."""
        ms = max(1, int(kv["coll.max_slices"]))
        return (ms - 1) * CHUNK_ENVELOPE_NS / 2.0

    def simulate(self, knobs: Optional[Dict[str, object]] = None) -> dict:
        """Price one knob vector: returns {"makespan_ns", "wire_ns",
        "stall_ns", "spill_ns", "spills", "dispatch_ns_per_task",
        "tasks"} — all derived deterministically."""
        kv = default_knobs()
        if knobs:
            kv.update(knobs)
        mag = max(1, int(kv["runtime.mag_batch"]))
        slots = max(1, int(kv["device.staging_slots"]))
        cache = int(kv["device.cache_bytes"] or 0)
        wave_fuse = bool(kv.get("device.wave_fuse", True))
        dispatch = DISPATCH_BASE_NS + DISPATCH_MAG_NS / mag

        indeg = dict(self.indeg0)
        ready_at: Dict[tuple, float] = {}
        heap: List[Tuple[float, int, tuple]] = []
        for n in self.nodes:
            if indeg[n] == 0:
                heapq.heappush(heap, (0.0, self.order[n], n))
        worker_free: Dict[int, List[float]] = {
            r: [0.0] * self.workers for r in self.ranks}
        for wf in worker_free.values():
            heapq.heapify(wf)
        makespan = 0.0
        wire_total = 0.0
        stall_total = 0.0
        done = 0
        while heap:
            t_ready, _ord, n = heapq.heappop(heap)
            r = self.rank[n]
            wf = worker_free.setdefault(r, [0.0] * self.workers)
            t_w = heapq.heappop(wf)
            start = max(t_ready, t_w)
            stall = 0.0
            if self.is_dev[n] and slots < 2:
                # single staging slot: the wave's h2d cannot overlap
                # the previous wave's compute — the dispatch stalls for
                # the task's staged input volume
                stall = self.in_bytes.get(n, 0) * H2D_BYTE_NS
            disp_n = dispatch
            if wave_fuse:
                # certified fusable wave -> ONE launch for the whole
                # wave: the per-task share of the dispatch overhead is
                # 1/width (ptc-fuse; the certificate is the gate, so
                # uncertified waves keep the full per-task charge)
                fw = self.fused_width.get(n)
                if fw:
                    disp_n = dispatch / fw
            dur = self.exec_ns[n] + disp_n + stall
            finish = start + dur
            stall_total += stall
            heapq.heappush(wf, finish)
            makespan = max(makespan, finish)
            done += 1
            for dst in self.succ.get(n, ()):
                delay = 0.0
                if self.rank[n] != self.rank[dst]:
                    payload = self.edge_payload.get((n, dst), 0)
                    delay = self._wire_ns(
                        payload, kv,
                        self._edge_cls(self.rank[n], self.rank[dst]))
                    if self.edge_coll.get((n, dst)):
                        delay *= self._coll_factor(payload, kv)
                        delay += self._slice_overhead_ns(kv, payload)
                    wire_total += delay
                arr = finish + delay
                if arr > ready_at.get(dst, -1.0):
                    ready_at[dst] = arr
                indeg[dst] -= 1
                if indeg[dst] == 0:
                    heapq.heappush(heap, (ready_at[dst],
                                          self.order[dst], dst))
        if done != len(self.nodes):
            # cycle-parked tail (V003): count the unreachable tasks as
            # serial work so the number stays finite and comparable
            makespan += sum(self.exec_ns[n] + dispatch
                            for n in self.nodes if indeg.get(n, 0) > 0)
        spills = 0
        spill_ns = 0.0
        if self.has_device and cache > 0:
            spills = self.plan.predict_spills(cache)
            if spills:
                tile = max(self.plan._datum_bytes.values(), default=0)
                d2h = self.econ.beta("device") * 1e9
                spill_ns = spills * (SPILL_ALPHA_NS + tile * d2h)
        return {
            "makespan_ns": makespan + spill_ns,
            "wire_ns": wire_total,
            "stall_ns": stall_total,
            "spill_ns": spill_ns,
            "spills": spills,
            "dispatch_ns_per_task": dispatch,
            "tasks": len(self.nodes),
        }

    # --------------------------------------------------------- axes
    def knob_axes(self) -> Dict[str, List[object]]:
        """Graph-relevant candidate values per knob.  Axes that cannot
        change this DAG's simulated cost (wire knobs on a single-rank
        DAG, device knobs without device chores, wave fusion without a
        certified fusable wave) collapse to the current default so the
        search space stays small and the proposals deterministic; so do
        the axes this package does not act on (FIXED_KNOBS: the rails,
        which the reference searches on multi-rank DAGs)."""
        kv = default_knobs()
        multi = (self.tmodel is not None
                 and self.tmodel.n_islands > 1
                 and len(self.ranks) > 1)
        axes: Dict[str, List[object]] = {k: [kv[k]] for k in TUNE_KNOBS}
        axes["runtime.mag_batch"] = [16, 64, 128, 256]
        if self.has_wire:
            axes["comm.chunk_size"] = [256 << 10, 1 << 20, 4 << 20]
            axes["comm.eager_limit"] = [16 << 10, 64 << 10, 256 << 10]
        if self.has_coll and self.has_wire:
            axes["coll.topo"] = ["auto", "ring", "binomial", "star"]
            if multi:
                axes["coll.topo"].append("hier")
            axes["coll.max_slices"] = [1, 4, 16]
        # per-class overrides: only a multi-island mesh has a 'dcn' class
        # for them to act on, so the dcn axes open there ("" = inherit
        # base always a candidate) and collapse to the current value
        # everywhere else.  The ici spellings stay collapsed — on a
        # single-island mesh they ARE the base knob.
        if self.has_wire and multi:
            axes["comm.chunk_size.dcn"] = ["", 1 << 20, 4 << 20,
                                           16 << 20]
            axes["comm.eager_limit.dcn"] = ["", 8 << 10, 64 << 10]
        if self.has_coll and self.has_wire and multi:
            axes["coll.topo.dcn"] = ["", "hier", "star", "binomial"]
        if self.has_device:
            axes["device.staging_slots"] = [1, 2, 4]
            peak = int(self.plan.peak_bytes(device_only=True) or 0)
            cands = [0]
            if peak > 0:
                cands += [peak, 2 * peak]
            axes["device.cache_bytes"] = cands
        if self.has_device and self.fused_width:
            # fusion width vs staging: only worth searching when a
            # certified fusable wave exists for the compiler to fuse
            axes["device.wave_fuse"] = [True, False]
        return axes

    # ------------------------------------------------------- search
    def propose(self, topk: int = 3, rounds: int = 2) -> List[dict]:
        """Deterministic coordinate descent over knob_axes(): sweep
        each axis in declared order holding the others, keep the best,
        repeat up to `rounds` or to a fixed point.  Returns the top-k
        DISTINCT vectors ranked by simulated makespan, the incumbent
        default vector always included (rank whatever it earns) so a
        validation pass always has the baseline to beat."""
        axes = self.knob_axes()
        seen: Dict[tuple, dict] = {}

        def key(kv):
            return tuple(kv[k] for k in TUNE_KNOBS)

        def price(kv):
            k = key(kv)
            if k not in seen:
                seen[k] = {"knobs": dict(kv),
                           "sim": self.simulate(kv),
                           }
                seen[k]["predicted_ns"] = seen[k]["sim"]["makespan_ns"]
            return seen[k]["predicted_ns"]

        best = default_knobs()
        best_ns = price(best)
        for _round in range(max(1, rounds)):
            changed = False
            for name in TUNE_KNOBS:
                for v in axes.get(name, [best[name]]):
                    cand = dict(best)
                    cand[name] = v
                    ns = price(cand)
                    if ns < best_ns * (1 - 1e-9):
                        best, best_ns = cand, ns
                        changed = True
            if not changed:
                break
        # ties break by the vector; a per-class axis mixes "" (inherit)
        # with ints, so each value sorts within its own type (the
        # reference compares them raw and raises on a two-island mesh)
        ranked = sorted(seen.values(),
                        key=lambda r: (r["predicted_ns"], tuple(
                            (isinstance(v, str), v)
                            for v in key(r["knobs"]))))
        out, have = [], set()
        for r in ranked:
            k = key(r["knobs"])
            if k in have:
                continue
            have.add(k)
            out.append(r)
            if len(out) >= max(1, topk):
                break
        # the incumbent defaults always ride along for the validator
        dk = key(default_knobs())
        if dk not in have:
            out.append(seen[dk])
        return out


# ---------------------------------------------------------- driver
def autotune(tp, measure: Optional[Callable] = None, topk: int = 3,
             cost: Optional[CostModel] = None, econ=None,
             workers: Optional[int] = None,
             max_instances: Optional[int] = None,
             store: Optional[TuneStore] = None,
             persist: bool = True) -> dict:
    """Tune one taskpool: plan it, propose knob vectors from the
    schedule simulator, optionally validate the top-k with real runs,
    and persist the winner keyed by (graph signature, host
    fingerprint) for Taskpool.run(tuned=True) to auto-apply.

    `measure(knobs) -> seconds | (seconds, trace)`: the caller-supplied
    real-run validator, called once per top-k candidate (and for the
    default vector).  When it returns a level-2 Trace alongside the
    wall time, the `compare_critpath` predicted-vs-measured ratio is
    recorded per validation run — the regression signal that keeps the
    model honest.  Without `measure`, the best PREDICTED vector wins
    and nothing persists (model-only proposals are hints, not
    winners).

    Returns {"signature", "host", "candidates", "validated", "winner",
    "persisted", "notes"}."""
    fg = extract_flowgraph(tp)
    plan = plan_graph(fg, max_instances=max_instances, cost=cost,
                      econ=econ, workers=workers)
    sig = graph_signature(tp)
    host = host_fingerprint()
    result = {"signature": sig, "host": host, "candidates": [],
              "validated": [], "winner": None, "persisted": False,
              "notes": list(plan.notes)}
    if plan.bounded:
        result["notes"].append(
            "autotune refused: enumeration past plan.max_instances — "
            "no simulation possible")
        return result
    sim = ScheduleSimulator(plan, cost=cost, econ=econ, workers=workers)
    ranked = sim.propose(topk=topk)
    result["candidates"] = [
        {"knobs": r["knobs"], "predicted_ns": r["predicted_ns"]}
        for r in ranked]
    if measure is None:
        result["winner"] = {
            "knobs": ranked[0]["knobs"],
            "predicted_ns": ranked[0]["predicted_ns"],
            "measured_s": None, "critpath_ratio": None,
            "source": "model-only",
        }
        return result
    validated = []
    for r in ranked:
        out = measure(dict(r["knobs"]))
        trace = None
        if isinstance(out, tuple):
            secs, trace = out
        else:
            secs = out
        row = {"knobs": r["knobs"],
               "predicted_ns": r["predicted_ns"],
               "measured_s": float(secs),
               # simulated-vs-wall, always recorded (the model-honesty
               # signal even when the executed critpath degenerates)
               "predicted_vs_wall": (round(r["predicted_ns"]
                                           / (secs * 1e9), 4)
                                     if secs > 0 else None)}
        if trace is not None:
            try:
                row["critpath"] = compare_critpath(plan, trace)
                row["critpath_ratio"] = row["critpath"]["ratio"]
            except Exception as exc:  # a truncated trace must not
                row["critpath_error"] = str(exc)  # kill the tuner
        validated.append(row)
    result["validated"] = validated
    winner = min(validated, key=lambda r: (r["measured_s"],
                                           r["predicted_ns"]))
    result["winner"] = {
        "knobs": winner["knobs"],
        "predicted_ns": winner["predicted_ns"],
        "measured_s": winner["measured_s"],
        "predicted_vs_wall": winner.get("predicted_vs_wall"),
        "critpath_ratio": winner.get("critpath_ratio"),
        "source": "validated",
    }
    if persist:
        st = store or TuneStore()
        st.put(sig, host, result["winner"])
        result["persisted"] = True
        result["store_path"] = st.path
    return result


# ------------------------------------------- collective knob pricing
def price_collective(knobs: Dict[str, object], size_bytes: int,
                     nranks: int, econ=None,
                     task_overhead_ns: float = DISPATCH_BASE_NS) -> float:
    """Model-side price (ns) of one runtime-native collective of
    `size_bytes` across `nranks` under a knob vector — the proposal
    model a collective's knobs are searched with (the graph itself is
    built rank-side inside gemm_panel_reduce, so the proposals come
    from this closed-form model and are validated with real multi-rank
    runs, the simulator->validate loop in miniature).

    Prices the fitted topology cost of the reduction — on the EAGER
    legs when the per-rank segment fits under the knob's eager
    threshold (the fitted eager path is markedly cheaper per byte than
    rendezvous on loopback: the single biggest lever this model
    surfaces), rendezvous otherwise — plus the slicing trade-off: more
    slices overlap wire and compute (T3-style) but each slice is its
    own task chain and frame."""
    if econ is None:
        from ..comm.economics import default_economics
        econ = default_economics()
    topo = knobs.get("coll.topo", "auto")
    slices = max(1, int(knobs.get("coll.max_slices", 16)))
    limit = knobs.get("comm.eager_limit")
    if limit is None:
        limit = comm_knob("comm.eager_limit")
    seg = max(1, size_bytes) / max(2, nranks)
    path = "eager" if seg <= int(limit) else "rdv"
    costs = econ.topology_costs("reduce", max(1, size_bytes),
                                max(2, nranks), path=path)
    base = (min(costs.values()) if topo in (None, "", "auto")
            else costs.get(topo, min(costs.values())))
    base_ns = base * 1e9
    # slicing: up to PIPE_DEPTH slices genuinely overlap (wire vs the
    # downstream partial reduction), every slice beyond that is pure
    # per-slice chain overhead (step tasks + frames on every rank)
    PIPE_DEPTH = 4
    per_slice = 3 * task_overhead_ns + CHUNK_ENVELOPE_NS
    alpha_ns = econ.alpha(path) * 1e9
    wire_ns = max(0.0, base_ns - alpha_ns)
    return (alpha_ns + wire_ns / min(slices, PIPE_DEPTH)
            + slices * per_slice)


def price_stream(knobs: Dict[str, object], size_bytes: int,
                 hops: int = 1, econ=None) -> float:
    """Model-side price (ns) of a `hops`-deep cross-rank DEVICE tile
    chain under a knob vector (a streamed tile chain): per hop the
    fitted device-path alpha leg, one more alpha-sized envelope per
    extra chunk (every chunk is its own d2h-slice + ranged wire
    round), and the per-byte leg divided by the diminishing-returns
    rail stripe.  Like price_collective, this is the proposal half of
    the miniature simulate->validate loop; the validation half is real
    two-process runs."""
    if econ is None:
        from ..comm.economics import default_economics
        econ = default_economics()
    chunk = int(knobs.get("comm.chunk_size", 1 << 20))
    rails = max(1, int(knobs.get("comm.rails", 2)))
    a = econ.alpha("device") * 1e9
    b = econ.beta("device") * 1e9
    if chunk > 0 and size_bytes > chunk:
        nch = (size_bytes + chunk - 1) // chunk
        hop = (a + (nch - 1) * max(a, CHUNK_ENVELOPE_NS)
               + size_bytes * b / _stripe_div(rails, nch))
    else:
        hop = a + size_bytes * b
    return hops * hop


def propose_stream(size_bytes: int, hops: int = 1, econ=None,
                   topk: int = 3) -> List[dict]:
    """Ranked streaming knob proposals (chunk quantum x rails) from
    price_stream, defaults included."""
    default = {"comm.chunk_size": comm_knob("comm.chunk_size"),
               "comm.rails": comm_knob("comm.rails")}
    cands = []
    seen_behavior = set()
    for chunk in (256 << 10, 1 << 20, 4 << 20, 2 * size_bytes):
        for rails in (1, 2, 4):
            kv = {"comm.chunk_size": chunk, "comm.rails": rails}
            # behavioral dedupe: a single-chunk payload never stripes,
            # so the rails axis collapses (validating three identical
            # configs would waste the top-k slots)
            nch = ((size_bytes + chunk - 1) // chunk
                   if chunk > 0 and size_bytes > chunk else 1)
            key = (chunk, rails if nch > 1 else 0)
            if key in seen_behavior and kv != default:
                continue
            seen_behavior.add(key)
            cands.append({
                "knobs": kv,
                "predicted_ns": price_stream(kv, size_bytes, hops,
                                             econ)})
    cands.sort(key=lambda r: (r["predicted_ns"],
                              str(sorted(r["knobs"].items()))))
    out = cands[:max(1, topk)]
    if not any(r["knobs"] == default for r in out):
        out.append({"knobs": default,
                    "predicted_ns": price_stream(default, size_bytes,
                                                 hops, econ)})
    return out


def propose_collective(size_bytes: int, nranks: int, econ=None,
                       topk: int = 3) -> List[dict]:
    """Ranked collective knob proposals from the closed-form model:
    the cross product of topology x slicing x eager threshold, priced
    by price_collective, defaults included."""
    default = {"coll.topo": comm_knob("coll.topo"),
               "coll.max_slices": comm_knob("coll.max_slices"),
               "comm.eager_limit": comm_knob("comm.eager_limit")}
    cands = []
    seen_behavior = set()
    seg = max(1, size_bytes) / max(2, nranks)
    for topo in ("auto", "ring", "binomial", "star"):
        for slices in (1, 4, 16):
            for eager in sorted({default["comm.eager_limit"],
                                 1 << 20, 4 << 20}):
                kv = {"coll.topo": topo, "coll.max_slices": slices,
                      "comm.eager_limit": eager}
                # behavioral dedupe: two thresholds on the same side of
                # the segment size run identically
                key = (topo, slices, seg <= eager)
                if key in seen_behavior and kv != default:
                    continue
                seen_behavior.add(key)
                cands.append({
                    "knobs": kv,
                    "predicted_ns": price_collective(kv, size_bytes,
                                                     nranks, econ)})
    cands.sort(key=lambda r: (r["predicted_ns"],
                              str(sorted(r["knobs"].items()))))
    out = cands[:max(1, topk)]
    if not any(r["knobs"] == default for r in out):
        pred = price_collective(default, size_bytes, nranks, econ)
        out.append({"knobs": default, "predicted_ns": pred})
    return out
