"""Concurrency soak of the native core, run under ThreadSanitizer or UBSan.

Drives from many threads in one process the paths that a one-core host
runs effectively one at a time: the lock-free Chase-Lev work-stealing
deque (lws) and the other schedulers, the dense and hashed dependency
engines under concurrent release, DTD accessor chains, the comm thread's
delivery path against worker releases (colocated ranks, a thread each),
the runtime-native collectives, the serving runtime, the journal, the
fleet router, the feedback controller and the device manager with wave
fusion.  TSan's happens-before analysis finds missing synchronization
even when the kernel timeslices, so the soak means something on one core.

Run (from the root of the checkout):

    make tsan
    PTC_NATIVE_LIB=build/libparsec_core_tsan.so \\
    LD_PRELOAD=$(g++ -print-file-name=libtsan.so) \\
    TSAN_OPTIONS="suppressions=parsec_tpu_torch/tools/tsan.supp \\
                  exitcode=66 report_thread_leaks=0" \\
    STRESS_REPS=1 timeout 900 \\
    python -m parsec_tpu_torch.tools.stress_tsan --device cpu

    make build/libparsec_core_ubsan.so
    PTC_NATIVE_LIB=build/libparsec_core_ubsan.so \\
    LD_PRELOAD=$(g++ -print-file-name=libubsan.so) \\
    UBSAN_OPTIONS="halt_on_error=1 print_stacktrace=1 exitcode=67" \\
    STRESS_REPS=1 timeout 900 \\
    python -m parsec_tpu_torch.tools.stress_tsan --device cpu

Exit 0, "stress ok" on stdout and no "WARNING: ThreadSanitizer" line on
stderr is clean.  STRESS_REPS (3 by default) repeats the whole job set;
stderr gets "job <name> <seconds> s" after each job and "rep i/n done"
after each rep.

Only wave_fuse_gemm and tp_decode_churn reach a device: a CudaDevice on
`--device` ("cuda", the card, by default; it raises without one, and
nothing falls back to the host).  The TSAN and UBSan runs take `--device
cpu`, the plain versions of the chores on the host.

Each colocated job takes its ports from comm.launch.free_port_base (as
many consecutive ports as it has ranks) unless the caller passes `port`,
restores every PTC_MCA_* variable it sets, and keeps its temporary files
under TMPDIR.  Job and argument names are the reference's; `CALLS` lists
what main runs in one rep, in order.

Port of tools/stress_tsan.py.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

import parsec_tpu_torch as pt
from parsec_tpu_torch.comm.launch import free_port_base
from parsec_tpu_torch.tools import torch_device

# a colocated rank thread that has not joined by then is hung
_JOIN_S = 300.0
_DEVICE_JOIN_S = 600.0


@contextlib.contextmanager
def environ(env: Optional[dict]):
    """Set `env` in os.environ for the block; restore every key after,
    exceptions included (colocated ranks and both packages read the same
    process-wide PTC_MCA_* environment)."""
    env = env or {}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def colocated(nodes: int, rank_prog: Callable[[int], object],
              timeout: float = _JOIN_S) -> dict:
    """Run rank_prog(rank) for `nodes` ranks, a thread each, in this
    process; fail on a rank that raised or has not joined within
    `timeout`.  Returns {rank: what rank_prog returned}."""
    errs, out = [], {}

    def run(rank):
        try:
            out[rank] = rank_prog(rank)
        except Exception as e:  # reported below, with its rank
            errs.append((rank, repr(e)))

    ts = [threading.Thread(target=run, args=(r,), name=f"rank{r}")
          for r in range(nodes)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    hung = [t.name for t in ts if t.is_alive()]
    assert not hung, f"deadlocked rank threads: {hung}"
    assert not errs, errs
    return out


def _rank_context(workers: int, rank: int, nodes: int, port: int):
    ctx = pt.Context(nb_workers=workers, scheduler="lws")
    ctx.set_rank(rank, nodes)
    ctx.comm_init(port)
    return ctx


def _chain(tp, name: str, flow: str, n, arena: str = "t"):
    """A RW chain `name`(k), k = 0..n, of no-op bodies over `flow`."""
    k = pt.L("k")
    tc = tp.task_class(name)
    tc.param("k", 0, n)
    tc.flow(flow, "RW",
            pt.In(None, guard=(k == 0)),
            pt.In(pt.Ref(name, k - 1, flow=flow)),
            pt.Out(pt.Ref(name, k + 1, flow=flow), guard=(k < n)),
            arena=arena)
    tc.body_noop()
    return tc


def _check_streams(model, handles, n: int = 4) -> None:
    """The first `n` finished requests' tokens and outputs bit for bit
    the model's own unbatched generation."""
    for h in handles[:n]:
        rt, ro = model.reference_generate(h.prompt, h.max_new)
        assert h.tokens == rt
        assert np.array_equal(np.stack(h.outputs), ro)


def _all_done(handles, hlock) -> list:
    with hlock:
        done = [h for h in handles if h.state == "done"]
        assert len(done) == len(handles), \
            [(h.state, getattr(h, "tenant", None)) for h in handles]
    return done


# ------------------------------------------------------------------ jobs
def ep_burst(sched: str, workers: int, n: int) -> None:
    """Independent tasks: pure produce/steal churn on the deques."""
    with pt.Context(nb_workers=workers, scheduler=sched) as ctx:
        tp = pt.Taskpool(ctx, globals={"NB": n - 1})
        tc = tp.task_class("EP")
        tc.param("k", 0, pt.G("NB"))
        tc.body_noop()
        tp.run()
        tp.wait()
        assert tp.nb_total_tasks == n


def chain_mesh(sched: str, workers: int, nb: int, lanes: int) -> None:
    """`lanes` independent RW chains: concurrent release_deps traffic
    through the dense dependency engine while workers steal."""
    with pt.Context(nb_workers=workers, scheduler=sched) as ctx:
        ctx.register_arena("t", 8)
        tp = pt.Taskpool(ctx, globals={"NB": nb - 1, "L": lanes - 1})
        k, l = pt.L("k"), pt.L("l")
        tc = tp.task_class("Chain")
        tc.param("l", 0, pt.G("L"))
        tc.param("k", 0, pt.G("NB"))
        tc.flow("A", "RW",
                pt.In(None, guard=(k == 0)),
                pt.In(pt.Ref("Chain", l, k - 1, flow="A")),
                pt.Out(pt.Ref("Chain", l, k + 1, flow="A"),
                       guard=(k < pt.G("NB"))),
                arena="t")
        tc.body_noop()
        tp.run()
        tp.wait()
        assert tp.nb_total_tasks == nb * lanes


def dtd_churn(workers: int, tiles: int, rounds: int) -> None:
    """Dynamic insertion racing execution: accessor-chain updates, window
    throttling, freelist reuse."""
    from parsec_tpu_torch.dsl.dtd import DtdTaskpool
    with pt.Context(nb_workers=workers, scheduler="lws") as ctx:
        datas = [ctx.data(i, np.zeros(8, dtype=np.int64))
                 for i in range(tiles)]
        dtp = DtdTaskpool(ctx, window=32)
        tls = [dtp.tile_of(d, owner=0) for d in datas]

        def bump(view):
            view.data(0, dtype=np.int64)[0] += 1

        for _ in range(rounds):
            for t in range(tiles):
                dtp.insert_task(bump, (tls[t], "INOUT"))
        dtp.wait()
        for i, d in enumerate(datas):
            v = np.frombuffer(d.array, dtype=np.int64)[0]
            assert v == rounds, (i, v)
        dtp.destroy()


def colocated_comm(workers: int, nb: int = 64, port: Optional[int] = None,
                   elems: int = 1, env=None) -> None:
    """Two ranks in ONE process (a thread per rank, loopback TCP): the
    comm threads' delivery paths run against both ranks' workers on a
    cross-rank RW chain, all in one address space.

    elems > 1 (with `env` forcing rendezvous, small chunks and 2 rails)
    drives the wire-v4 socket/session paths: ranged-chunk sessions,
    zero-copy sendmsg frames pinned by shared_ptr, multi-rail striping."""
    port = free_port_base(2) if port is None else port

    def rank_prog(rank):
        ctx = _rank_context(workers, rank, 2, port)
        with ctx:
            size = 8 * elems
            arr = np.zeros((2, elems), dtype=np.int64)
            ctx.register_linear_collection("A", arr, elem_size=size,
                                           nodes=2, myrank=rank)
            ctx.register_arena("t", size)
            tp = pt.Taskpool(ctx, globals={"NB": nb})
            k = pt.L("k")
            tc = tp.task_class("Task")
            tc.param("k", 0, pt.G("NB"))
            tc.affinity("A", k % 2)
            tc.flow("A", "RW",
                    pt.In(pt.Mem("A", 0), guard=(k == 0)),
                    pt.In(pt.Ref("Task", k - 1, flow="A")),
                    pt.Out(pt.Ref("Task", k + 1, flow="A"),
                           guard=(k < pt.G("NB"))),
                    arena="t")

            def body(view):
                a = view.data("A", dtype=np.int64, shape=(elems,))
                assert (a == view["k"]).all()
                a += 1

            tc.body(body)
            tp.run()
            tp.wait()
            ctx.comm_fence()
            ctx.comm_fini()

    with environ(env):
        colocated(2, rank_prog)


def _contributions(nodes: int, elems: int) -> list:
    return [torch.arange(elems, dtype=torch.float32).numpy() + 100.0 * r
            for r in range(nodes)]


def colocated_coll(workers: int, elems: int, port: Optional[int] = None,
                   env=None) -> None:
    """Two ranks in ONE process running the runtime-native streamed
    collectives (ptc_coll_* task classes, comm.coll): the reduction and
    fan-out step deliveries, the coll-stats counters, the native
    bcast-tree switches and (with `env` forcing rendezvous and small
    chunks) the chunked wire sessions, every topology."""
    from parsec_tpu_torch.comm import coll
    port = free_port_base(2) if port is None else port

    def rank_prog(rank):
        ctx = _rank_context(workers, rank, 2, port)
        with ctx:
            alls = _contributions(2, elems)
            total = alls[0] + alls[1]
            for topo in ("ring", "binomial", "star"):
                got = coll.all_reduce(ctx, alls[rank], topo=topo)
                assert (got == total).all(), topo
            got = coll.broadcast(ctx, alls[rank].copy(), root=1)
            assert (got == alls[1]).all()
            st = ctx.coll_stats()
            assert st["steps"] > 0, st
            ctx.comm_fence()
            ctx.comm_fini()

    with environ(env):
        colocated(2, rank_prog)


def colocated_hier_coll(workers: int, elems: int,
                        port: Optional[int] = None, env=None) -> None:
    """FOUR ranks in one process on a two-island topology spec running
    the hierarchical two-level collectives (intra-island binomial reduce
    onto the heads, a leaders-only exchange, the followers' fan-out) and
    the per-class counter folds: the island leaders' step deliveries, the
    route table's -1 deactivations and the classed counter reads."""
    from parsec_tpu_torch.comm import coll
    nodes = 4
    port = free_port_base(nodes) if port is None else port
    env = dict(env or {})
    env.setdefault("PTC_MCA_comm_topology", "0,1;2,3")

    def rank_prog(rank):
        ctx = _rank_context(workers, rank, nodes, port)
        with ctx:
            alls = _contributions(nodes, elems)
            total = torch.stack([torch.from_numpy(a) for a in alls]) \
                .sum(0).numpy()
            for _ in range(2):
                got = coll.all_reduce(ctx, alls[rank], topo="hier")
                assert (got == total).all()
            got = coll.broadcast(ctx, alls[rank].copy(), root=1,
                                 topo="hier")
            assert (got == alls[1]).all()
            st = ctx.coll_stats()
            assert st["by_topo"].get("hier", 0) >= 3, st
            ts = ctx.comm_topo_stats()
            assert ts["n_islands"] == 2, ts
            ctx.comm_fence()
            ctx.comm_fini()

    with environ(env):
        colocated(nodes, rank_prog)


def metrics_watchdog_coll(workers: int, elems: int,
                          port: Optional[int] = None, env=None) -> None:
    """The observability paths: the lock-free metrics hot path (per-class
    EXEC records from the bodies on every worker; h2d, release and
    comm-wait records), the watchdog thread scanning inflight slots and
    histograms, the Prometheus endpoint serializing snapshots and the
    fence-time MSG_METRICS rank-wide merge, all concurrent with a 2-rank
    streamed collective over the chunked wire."""
    import urllib.request

    from parsec_tpu_torch.comm import coll
    from parsec_tpu_torch.profiling.metrics import (MetricsExporter,
                                                    MetricsRegistry,
                                                    Watchdog)
    port = free_port_base(2) if port is None else port

    def rank_prog(rank):
        ctx = _rank_context(workers, rank, 2, port)
        with ctx:
            wd = Watchdog(ctx, interval=0.05, floor_s=30.0)
            exporter = MetricsExporter(ctx, 0) if rank == 0 else None
            stop_scrape = threading.Event()

            def scrape():
                while not stop_scrape.is_set():
                    try:
                        urllib.request.urlopen(
                            f"http://127.0.0.1:{exporter.port}/metrics",
                            timeout=5).read()
                    except Exception:  # a scrape may race the teardown
                        pass
                    stop_scrape.wait(0.02)

            scraper = None
            if exporter is not None:
                scraper = threading.Thread(target=scrape, daemon=True)
                scraper.start()
            alls = _contributions(2, elems)
            total = alls[0] + alls[1]
            for _ in range(3):
                got = coll.all_reduce(ctx, alls[rank], topo="ring")
                assert (got == total).all()
                ctx.comm_fence()  # fires the MSG_METRICS merge
            reg = MetricsRegistry(ctx)
            assert reg.prometheus_text(merged=(rank == 0))
            assert not wd.events, wd.events  # no false positives
            stop_scrape.set()
            if scraper is not None:
                scraper.join(timeout=10)
            if exporter is not None:
                exporter.stop()
            wd.stop()
            ctx.comm_fence()
            ctx.comm_fini()

    with environ(env):
        colocated(2, rank_prog)


def _host_model():
    """The serving soaks' model: the reference's PagedLM (vocab 24, d 8,
    page 4, seed 5), its weights on the host (these engines have no
    device; their folds run on the host)."""
    from parsec_tpu_torch.serve import PagedLM, PagedLMConfig
    return PagedLM(PagedLMConfig(vocab=24, d=8, page=4, seed=5),
                   device="cpu")


def _drive(threads, busy, run, what: str) -> None:
    """Run the continuous-batching loop until every submitter thread has
    ended and nothing is pending (busy() false)."""
    deadline = time.monotonic() + 300
    while any(t.is_alive() for t in threads) or busy():
        assert time.monotonic() < deadline, f"{what} deadlocked"
        run(timeout_s=240)
        time.sleep(0.001)
    for t in threads:
        t.join(timeout=60)


def prefix_spec_churn(workers: int, reqs_per_thread: int = 6,
                      env=None) -> None:
    """Shared-prefix churn: 2 QoS tenants x 2 submitter threads hammer
    OVERLAPPING prompts through a live InferenceEngine with speculative
    decoding on and a page pool small enough to force the whole
    shared-prefix life cycle (concurrent acquire_prefix check-and-reserve
    against the pump thread's retirements, freeze/hit/refcount churn,
    COW clones, eviction of cached frozen pages, speculative page
    rollback) while the main thread runs the continuous-batching loop
    and a reader scrapes the pool counters, stats()["serve"] and the
    tenant-labelled Prometheus text; a final bit-exactness spot check
    keeps the soak honest."""
    from parsec_tpu_torch.serve import InferenceEngine, TenantConfig

    with environ(env):
        model = _host_model()
        rng0 = np.random.RandomState(3)
        common = [list(rng0.randint(0, 24, size=12)) for _ in range(3)]
        with pt.Context(nb_workers=workers, scheduler="lws") as ctx:
            eng = InferenceEngine(
                ctx, model, n_pages=40, max_seqs=8,
                tenants=[TenantConfig("hi", priority=4, weight=3,
                                      max_pools=4, max_queue=128),
                         TenantConfig("lo", max_pools=4, max_queue=128)],
                spec_k=2)
            reg = ctx.metrics_registry()
            handles, hlock = [], threading.Lock()

            def submitter(tenant, seed):
                rng = np.random.RandomState(seed)
                for _ in range(reqs_per_thread):
                    c = common[rng.randint(len(common))]
                    tail = list(rng.randint(0, 24, size=rng.randint(0, 3)))
                    h = eng.submit(c[:rng.randint(4, 13)] + tail,
                                   int(rng.randint(2, 5)), tenant)
                    with hlock:
                        handles.append(h)

            stop = threading.Event()

            def reader():
                while not stop.is_set():
                    eng.pool.stats()
                    ctx.stats()["serve"]
                    reg.prometheus_text()
                    stop.wait(0.005)

            subs = [threading.Thread(target=submitter, args=(t, s))
                    for s, t in enumerate(("hi", "lo", "hi", "lo"))]
            rd = threading.Thread(target=reader, daemon=True)
            rd.start()
            for t in subs:
                t.start()
            _drive(subs, lambda: eng.pending() or eng._inflight, eng.run,
                   "churn")
            stop.set()
            rd.join(timeout=10)
            st = eng.pool.stats()
            assert st["free"] + st["cached_free"] == st["n_pages"], st
            assert st["prefix_hits"] > 0, st
            _check_streams(model, _all_done(handles, hlock))
            eng.close()


def fleet_churn(workers: int, reqs_per_thread: int = 5, env=None) -> None:
    """Fleet churn: TWO replica engines (own contexts, one address space)
    behind one Router; two submitter threads route OVERLAPPING
    shared-prefix prompts through the scored placement path (advertise
    -> digest -> placement_cost) while a migration thread moves pages by
    content hash in BOTH directions between the live pools, concurrent
    with each engine's own freeze/acquire/eviction churn and the pump
    threads' retirements, and a reader scrapes router.stats() (which
    walks every replica's advertisement and pool counters).  Bit-exact
    spot checks and exact page accounting on both pools keep the soak
    honest."""
    from parsec_tpu_torch.ops.paged_attention import prefix_page_keys
    from parsec_tpu_torch.serve import (InferenceEngine, Replica, Router,
                                        TenantConfig)

    with environ(env):
        model = _host_model()
        rng0 = np.random.RandomState(11)
        common = [list(rng0.randint(0, 24, size=12)) for _ in range(3)]
        ckeys = [prefix_page_keys(model.model_id, c, 4) for c in common]
        ctxs = [pt.Context(nb_workers=workers, scheduler="lws")
                for _ in range(2)]
        try:
            reps = [Replica(InferenceEngine(
                c, model, n_pages=28, max_seqs=6,
                tenants=[TenantConfig("t", max_pools=4, max_queue=128)],
                name=f"r{i}")) for i, c in enumerate(ctxs)]
            router = Router(reps)
            handles, hlock = [], threading.Lock()

            def submitter(seed):
                rng = np.random.RandomState(seed)
                for _ in range(reqs_per_thread):
                    c = common[rng.randint(len(common))]
                    tail = list(rng.randint(0, 24, size=rng.randint(0, 3)))
                    fh = router.submit(c + tail, int(rng.randint(2, 5)),
                                       "t")
                    with hlock:
                        handles.append(fh)

            stop = threading.Event()

            def migrator():
                i = 0
                while not stop.is_set():
                    router.migrate(ckeys[i % len(ckeys)], dst=reps[i % 2],
                                   src=reps[(i + 1) % 2])
                    i += 1
                    stop.wait(0.002)

            def reader():
                while not stop.is_set():
                    router.stats()
                    stop.wait(0.005)

            subs = [threading.Thread(target=submitter, args=(s,))
                    for s in (1, 2)]
            aux = [threading.Thread(target=migrator, daemon=True),
                   threading.Thread(target=reader, daemon=True)]
            for t in aux:
                t.start()
            for t in subs:
                t.start()
            _drive(subs, router._busy, router.run, "fleet")
            stop.set()
            for t in aux:
                t.join(timeout=10)
            for rep in reps:
                st = rep.pool.stats()
                assert st["free"] + st["cached_free"] == st["n_pages"], st
            _check_streams(model, _all_done(handles, hlock))
            router.close()
        finally:
            for c in ctxs:
                c.destroy()


def _serve_rank(ctx, tenants, pools_per_tenant: int, reader_calls,
                fences: int = 0):
    """A Server over `tenants` on a ranked context, fed 15-task RW chain
    pools by one submitter thread a tenant while a reader thread calls
    each of reader_calls(srv) every 5 ms (and the rank runs `fences`
    comm fences).  Returns the drained, closed Server."""
    from parsec_tpu_torch.serve import Server

    srv = Server(ctx, tenants)

    def mk(priority, weight):
        tp = ctx.taskpool(globals={"N": 15}, priority=priority,
                          weight=weight)
        _chain(tp, "C", "X", pt.G("N"))
        return tp

    def submitter(tenant):
        for _ in range(pools_per_tenant):
            srv.submit(tenant, mk)

    calls = reader_calls(srv)
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            for call in calls:
                call()
            stop.wait(0.005)

    subs = [threading.Thread(target=submitter, args=(t.name,))
            for t in tenants]
    rd = threading.Thread(target=reader, daemon=True)
    rd.start()
    for t in subs:
        t.start()
    # fences interleave the journal's MSG_BLOB checkpoints with clock
    # sync and the MSG_METRICS merges
    for _ in range(fences):
        ctx.comm_fence()
        time.sleep(0.05)
    for t in subs:
        t.join(timeout=120)
    assert srv.drain(timeout=120)
    stop.set()
    rd.join(timeout=10)
    return srv


def journal_churn(workers: int, port: Optional[int] = None,
                  pools_per_tenant: int = 10, env=None) -> None:
    """The black box under a 2-rank context: each rank runs a Server and
    a crash-armed Journal with aggressive cadences.  record() from the
    submitter, pump and worker threads (serve and scope-event hooks)
    races the cadence thread's drain/fsync/rotation; inventory
    checkpoints snapshot live scopes and inflight slots; MSG_BLOB
    replication rides the comm engine; crash-header refreshes
    (ptc_crash_update_meta reading the clock and ring atomics) race the
    fence-time clock sync; a FleetView scrapes the local server and a
    reader thread calls stats()/prometheus (with the ptc_fleet_*
    family).  The fatal-signal writer never fires here: its bounded-spin
    read of the profiling buffer is crash-path-only by design (a
    deliberate data race TSan must not see in healthy runs).  The
    journals live in a temporary directory under TMPDIR."""
    from parsec_tpu_torch.profiling.blackbox import FleetView, Journal
    from parsec_tpu_torch.serve import TenantConfig
    port = free_port_base(2) if port is None else port

    def rank_prog(rank, jdir):
        ctx = _rank_context(workers, rank, 2, port)
        with ctx:
            ctx.register_arena("t", 8)
            ctx.profile_enable(1)
            ctx.profile_ring(1 << 16)
            jr = Journal(ctx, dirpath=jdir, max_bytes=1 << 16,
                         fsync_s=0.02, checkpoint_s=0.05)
            jr.register_inventory(
                "frozen_page_keys",
                lambda: [f"page:{rank}:{i}" for i in range(4)])
            reg = ctx.metrics_registry()
            fv = []

            def reader_calls(srv):
                fv.append(FleetView(ctx=ctx, servers=[srv],
                                    interval_s=0.01))
                return (lambda: ctx.stats()["fleet"], reg.prometheus_text,
                        jr.stats, jr.lost_peers)

            srv = _serve_rank(ctx, [
                TenantConfig("hi", priority=4, weight=3, max_pools=3,
                             max_queue=64),
                TenantConfig("lo", priority=0, weight=1, max_pools=3,
                             max_queue=64)], pools_per_tenant,
                reader_calls, fences=3)
            fv[0].stop()
            srv.close()
            ctx.comm_fence()
            jr.stop()
            st = jr.stats()
            assert st["records"] > 0 and st["checkpoints"] >= 0, st
            ctx.comm_fini()

    with environ(env), tempfile.TemporaryDirectory() as td:
        colocated(2, lambda r: rank_prog(r, os.path.join(td, f"r{r}")))


def control_churn(workers: int, reqs_per_thread: int = 5,
                  env=None) -> None:
    """Feedback-controller churn: a live InferenceEngine with ADAPTIVE
    speculation (spec_k='auto') and a Controller bound to it, under fire
    from every side at once: submitter threads on two tenants (the
    per-tenant bandit windows and the page-pressure pause/resume gate
    against a small pool), an observer thread feeding drifted makespan
    ratios and watchdog interrupts (retune evaluation and the
    pool-boundary hot swap's hold_knobs snapshot/restore racing
    everything), and a scraper calling ctrl.stats(),
    Context.stats()['control'] and ctrl.poll() (budget-share pushes into
    the pool, admission-pressure pushes into the server) while the
    main thread runs the continuous-batching loop (whose _reap polls
    too).  A final bit-exactness spot check keeps the adaptive path
    honest."""
    from parsec_tpu_torch.analysis.control import Controller
    from parsec_tpu_torch.serve import InferenceEngine, TenantConfig

    with environ(env):
        model = _host_model()
        rng0 = np.random.RandomState(7)
        common = [list(rng0.randint(0, 24, size=10)) for _ in range(3)]
        with pt.Context(nb_workers=workers, scheduler="lws") as ctx:
            ctrl = Controller(ctx, window=4, cooldown=2, drift_ratio=1.25)
            # a small never-run chain as the retune target: evaluate()
            # simulates it again concurrently with the serving loop
            ctx.register_arena("t", 8)
            tp = pt.Taskpool(ctx, globals={"NB": 199})
            _chain(tp, "Task", "A", pt.G("NB"))
            ctrl.attach_target(tp, workers=workers)
            eng = InferenceEngine(  # binds to ctx._controller itself
                ctx, model, n_pages=40, max_seqs=8,
                tenants=[TenantConfig("hi", priority=4, weight=3,
                                      max_pools=4, max_queue=128),
                         TenantConfig("lo", max_pools=4, max_queue=128)],
                spec_k="auto")
            handles, hlock = [], threading.Lock()

            def submitter(tenant, seed):
                rng = np.random.RandomState(seed)
                for _ in range(reqs_per_thread):
                    c = common[rng.randint(len(common))]
                    h = eng.submit(c[:rng.randint(4, 11)],
                                   int(rng.randint(2, 5)), tenant)
                    with hlock:
                        handles.append(h)

            stop = threading.Event()

            def observer():
                i = 0
                while not stop.is_set():
                    ctrl.observe_pool(2.5 if i % 3 else 0.9)
                    if i % 17 == 11:
                        ctrl.interrupt("stuck_task", key=f"Pool#{i}")
                    i += 1
                    stop.wait(0.002)

            def scraper():
                while not stop.is_set():
                    ctrl.stats()
                    ctx.stats()["control"]
                    ctrl.poll()
                    stop.wait(0.004)

            subs = [threading.Thread(target=submitter, args=(t, s))
                    for s, t in enumerate(("hi", "lo", "hi", "lo"))]
            aux = [threading.Thread(target=observer, daemon=True),
                   threading.Thread(target=scraper, daemon=True)]
            for t in aux:
                t.start()
            for t in subs:
                t.start()
            _drive(subs, lambda: eng.pending() or eng._inflight, eng.run,
                   "churn")
            stop.set()
            for t in aux:
                t.join(timeout=10)
            s = ctrl.stats()
            assert s["retunes"] >= 1, s
            assert s["decisions"] >= 1, s
            _check_streams(model, _all_done(handles, hlock))
            eng.close()
            ctrl.stop()


def serve_churn(workers: int, port: Optional[int] = None,
                pools_per_tenant: int = 24, env=None) -> None:
    """The serving runtime under a 2-rank context (one process, a thread
    per rank): each rank runs a Server with two QoS tenants and TWO
    concurrent submitter threads hammering admission (per-pool QoS lane
    pushes and pops from every worker, concurrent taskpool creation and
    retirement, the pump thread's destroys racing worker completions,
    admission queue/reject churn, qos_stats reads from the stats thread)
    while comm fences run.  Every admitted pool is scope-stamped by the
    Server (tp->scope_id loads on the EXEC span path, the u64 scope word
    on every cross-rank ACTIVATE), tracing level 1 keeps those paths
    hot, and the reader thread scrapes Context.stats()["scope"] and the
    tenant-labelled Prometheus text while the pools churn."""
    from parsec_tpu_torch.serve import TenantConfig
    port = free_port_base(2) if port is None else port

    def rank_prog(rank):
        ctx = _rank_context(workers, rank, 2, port)
        with ctx:
            ctx.register_arena("t", 8)
            # scope span stamps and SCOPE wire instants stay hot (ring
            # mode bounds the buffers over the pool churn)
            ctx.profile_enable(1)
            ctx.profile_ring(1 << 16)
            reg = ctx.metrics_registry()
            srv = _serve_rank(ctx, [
                TenantConfig("hi", priority=4, weight=3, max_pools=3,
                             max_queue=64, slo_ms=60_000),
                TenantConfig("lo", priority=0, weight=1, max_pools=3,
                             max_queue=64)], pools_per_tenant,
                lambda srv: (ctx.sched_stats, srv.stats,
                             lambda: ctx.stats()["scope"],
                             reg.prometheus_text))
            st = srv.stats()["totals"]
            assert st["completed"] == 2 * pools_per_tenant, st
            srv.close()
            ctx.comm_fence()
            ctx.comm_fini()

    with environ(env):
        colocated(2, rank_prog)


def wave_fuse_gemm(workers: int, port: Optional[int] = None, N: int = 32,
                   nb: int = 8, env=None, device="cuda") -> dict:
    """Wave fusion under load: two colocated ranks (a thread per rank)
    run a distributed GEMM with the WAVE COMPILER ON over the streamed
    wire, each rank a CudaDevice on `device`: the fuse cache and online
    certification on each device manager thread, the prefetch lane's
    peeks and hint staging, and the comm threads' deliveries all race in
    one address space.  The chain path rightly refuses on gemm_dist
    (task-sourced panels); the certification and counter paths are what
    this job drives concurrently with wire deliveries.  Every tile of C
    is held to float64 at 2e-3, and each rank's data plane to no error
    (dp_errors 0).  Returns {(m, n): C tile} over both ranks."""
    from parsec_tpu_torch.algos.gemm import build_gemm_dist
    from parsec_tpu_torch.data.collections import TwoDimBlockCyclic
    from parsec_tpu_torch.device import CudaDevice
    dev_t = torch_device(str(device))
    port = free_port_base(2) if port is None else port
    env = dict(env or {})
    env.setdefault("PTC_MCA_device_wave_fuse", "1")

    def rank_prog(rank):
        ctx = _rank_context(workers, rank, 2, port)
        tiles = {}
        with ctx:
            rng = np.random.default_rng(3)
            a = rng.normal(size=(N, N)).astype(np.float32)
            b = rng.normal(size=(N, N)).astype(np.float32)
            c0 = rng.normal(size=(N, N)).astype(np.float32)
            mats = []
            for name, x in (("A", a), ("B", b), ("C", c0)):
                m = TwoDimBlockCyclic(N, N, nb, nb, P=2, Q=1, nodes=2,
                                      myrank=rank, dtype=np.float32)
                m.register(ctx, name)
                m.from_dense(x)
                mats.append(m)
            A, B, C = mats
            dev = CudaDevice(ctx, device=dev_t)
            try:
                tp = build_gemm_dist(ctx, A, B, C, dev=dev)
                tp.run()
                tp.wait()
                ctx.comm_fence()
                dev.flush()
                ref = torch.from_numpy(c0).double() + \
                    torch.from_numpy(a).double() @ torch.from_numpy(b).double()
                for m in range(C.mt):
                    for n in range(C.nt):
                        if C.rank_of(m, n) != rank:
                            continue
                        got = torch.from_numpy(np.array(C.tile(m, n)))
                        want = ref[m * nb:(m + 1) * nb, n * nb:(n + 1) * nb]
                        err = float((got.double() - want).abs().max())
                        assert err < 2e-3, (m, n, err)
                        tiles[(m, n)] = got.numpy()
                assert dev.stats["dp_errors"] == 0, dev.stats
            finally:
                dev.stop()
            ctx.comm_fence()
            ctx.comm_fini()
        return tiles

    with environ(env):
        out = colocated(2, rank_prog, timeout=_DEVICE_JOIN_S)
    return {k: v for r in sorted(out) for k, v in out[r].items()}


def tp_decode_churn(workers: int, port: Optional[int] = None,
                    max_new: int = 5, env=None, device="cuda") -> dict:
    """Tensor-parallel decode: TWO colocated ranks serve ONE
    tensor-parallel PagedLM (qkv/ffn rows and KV pages sharded by head,
    one PagePool a rank), each with a CudaDevice on `device`; every
    prefill/decode/verify pool embeds a RefReduce ptc_coll_* chain whose
    slice-granular step deliveries race the wave compiler (per-rank
    shard-wave certification and fused dispatch on the device manager
    thread) and the prefetch lane's peeks, all over the streamed
    (rendezvous, chunked, 2-rail) wire.  A reader thread per rank
    scrapes the head-sharded pool counters, stats()["serve"]["tp"] and
    device_stats() while the SPMD step loop and both comm threads mutate
    them.  Each rank's tokens and pre-logits are held bit for bit to the
    single-rank reference, with fused_waves > 0, coll_pools > 0 and
    dp_errors 0.  Returns {rank: [each request's tokens]}."""
    from parsec_tpu_torch.device import CudaDevice
    from parsec_tpu_torch.serve import (InferenceEngine, PagedLM,
                                        PagedLMConfig)
    dev_t = torch_device(str(device))
    port = free_port_base(2) if port is None else port
    env = dict(env or {})
    env.setdefault("PTC_MCA_device_wave_fuse", "1")
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 5, 6, 7, 8, 9],
               [3, 1, 4, 1, 5]]

    def rank_prog(rank):
        ctx = _rank_context(workers, rank, 2, port)
        ctx.comm_set_colocated([1 - rank])
        with ctx:
            model = PagedLM(PagedLMConfig(heads=4, qlog=True),
                            device=dev_t)
            dev = CudaDevice(ctx, device=dev_t)
            try:
                eng = InferenceEngine(ctx, model, n_pages=64, max_seqs=4,
                                      tp=2, spec_k=2, dev=dev)
                stop = threading.Event()

                def reader():
                    while not stop.is_set():
                        eng.pool.stats()
                        ctx.stats()["serve"]
                        ctx.device_stats()
                        stop.wait(0.003)

                rd = threading.Thread(target=reader, daemon=True)
                rd.start()
                hs = []
                t0 = time.monotonic()
                for p in prompts:
                    h = eng.submit(p, max_new)
                    hs.append(h)
                    while h.state == "submitted":
                        assert time.monotonic() - t0 < 240, "prefill stuck"
                        time.sleep(0.001)
                while eng.pending() or eng._inflight:
                    assert time.monotonic() - t0 < 240, "decode stuck"
                    eng.step()
                stop.set()
                rd.join(timeout=10)
                tp_st = eng._tp_stats()
                assert tp_st["coll_pools"] > 0, tp_st
                fuse = ctx.device_stats().get("fuse", {})
                assert fuse.get("fused_waves", 0) > 0, fuse
                for h in hs:
                    rt, ro = model.reference_generate(h.prompt, h.max_new)
                    assert list(h.tokens) == rt
                    for j, o in enumerate(h.outputs):
                        assert np.array_equal(o, model.pre_logits(ro[j]))
                assert dev.stats["dp_errors"] == 0, dev.stats
                eng.close()
            finally:
                dev.stop()
            ctx.comm_fence()
            ctx.comm_fini()
        return [list(h.tokens) for h in hs]

    with environ(env):
        return colocated(2, rank_prog, timeout=_DEVICE_JOIN_S)


def reshape_churn(workers: int, fanout: int, rounds: int) -> None:
    """Concurrent consumers of the same (copy, [type]): the memoized
    reshape cache's create/hit race, plus write-back version bumps that
    take the stale-entry eviction path against racing readers
    (ptc_reshape_get, the ReshapeCache)."""
    n = 16
    tile = np.arange(n * n, dtype=np.int32).reshape(n, n)
    with pt.Context(nb_workers=workers) as ctx:
        segs = [(i * n * 4, (i + 1) * 4) for i in range(n)]
        ctx.register_datatype_indexed("LOW", segs)
        ctx.register_datatype_cast("I2L", np.int32, np.int64)
        ctx.register_linear_collection("A", tile, elem_size=tile.nbytes)
        tp = pt.Taskpool(ctx, globals={"NR": rounds - 1, "NF": fanout - 1})
        r = pt.L("r")
        w = tp.task_class("W")
        w.param("r", 0, pt.G("NR"))
        w.flow("A", "RW",
               pt.In(pt.Mem("A", 0), guard=(r == 0)),
               pt.In(pt.Ref("W", r - 1, flow="A")),
               pt.Out(pt.Ref("R", r, pt.Range(0, pt.G("NF")), flow="X")),
               pt.Out(pt.Ref("C", r, pt.Range(0, pt.G("NF")), flow="X")),
               pt.Out(pt.Ref("W", r + 1, flow="A"), guard=(r < pt.G("NR"))),
               pt.Out(pt.Mem("A", 0), ltype="LOW", guard=(r == pt.G("NR"))))

        def wbody(t):
            t.data("A", np.int32)[0] += 1  # a version bump a round

        w.body(wbody)
        for name, ltype in (("R", "LOW"), ("C", "I2L")):
            tc = tp.task_class(name)
            tc.param("r", 0, pt.G("NR"))
            tc.param("f", 0, pt.G("NF"))
            tc.flow("X", "READ", pt.In(pt.Ref("W", r, flow="A"),
                                       ltype=ltype))
            tc.body_noop()
        tp.run()
        tp.wait()


# ------------------------------------------------------------------ main
_WIRE = {"PTC_MCA_comm_eager_limit": "0", "PTC_MCA_comm_chunk_size": "2048",
         "PTC_MCA_comm_rails": "2"}

# one rep of main, in order: (job, keyword arguments, environment set
# around the call).  A job that takes `port` picks a free range itself;
# the two device jobs also get main's `device`.
CALLS = [
    *[call for sched in ("lws", "lfq", "ll", "lhq") for call in (
        ("ep_burst", {"sched": sched, "workers": 8, "n": 20000}, None),
        ("chain_mesh", {"sched": sched, "workers": 8, "nb": 200,
                        "lanes": 16}, None))],
    ("dtd_churn", {"workers": 8, "tiles": 8, "rounds": 100}, None),
    ("reshape_churn", {"workers": 8, "fanout": 8, "rounds": 60}, None),
    # the magazine-batch knob: a tiny batch maximizes free_lock traffic,
    # a big one the size of each spill; it binds when a context is
    # created, so each call runs its own contexts under the environment
    ("chain_mesh", {"sched": "lws", "workers": 8, "nb": 120, "lanes": 16},
     {"PTC_MCA_runtime_mag_batch": "4"}),
    ("chain_mesh", {"sched": "lws", "workers": 8, "nb": 120, "lanes": 16},
     {"PTC_MCA_runtime_mag_batch": "512"}),
    ("colocated_comm", {"workers": 4}, None),
    # wire-v4 socket/session paths: chunk sessions, zero-copy sendmsg
    # pins, 2-rail striping (16 KiB payloads, 2 KiB chunks)
    ("colocated_comm", {"workers": 4, "nb": 24, "elems": 2048,
                        "env": dict(_WIRE, PTC_MCA_comm_inflight="3")}, None),
    # the runtime-native collectives over the chunked wire, every
    # topology, sliced contributions riding 2 KiB chunks
    ("colocated_coll", {"workers": 4, "elems": 4096,
                        "env": {"PTC_MCA_comm_eager_limit": "0",
                                "PTC_MCA_comm_chunk_size": "2048",
                                "PTC_MCA_coll_slice": "4096",
                                "PTC_MCA_comm_rails": "2"}}, None),
    # level-2 tracing and the flight-recorder RING on a 2-rank job:
    # worker pushes racing the ring's wraparound, the comm thread's COMM
    # instants and clock-sync PONGs on buffer 0
    ("colocated_comm", {"workers": 4, "nb": 48,
                        "env": {"PTC_MCA_runtime_profile": "1",
                                "PTC_MCA_runtime_trace_ring": "16384"}},
     None),
    ("metrics_watchdog_coll", {"workers": 4, "elems": 4096,
                               "env": dict(_WIRE)}, None),
    ("colocated_hier_coll", {"workers": 2, "elems": 4096,
                             "env": dict(_WIRE)}, None),
    ("serve_churn", {"workers": 4}, None),
    ("journal_churn", {"workers": 4}, None),
    ("prefix_spec_churn", {"workers": 4}, None),
    ("fleet_churn", {"workers": 4}, None),
    ("control_churn", {"workers": 4}, None),
    ("wave_fuse_gemm", {"workers": 2, "env": dict(_WIRE)}, None),
    ("tp_decode_churn", {"workers": 1, "env": dict(_WIRE)}, None),
]

JOBS = {f.__name__: f for f in (
    ep_burst, chain_mesh, dtd_churn, reshape_churn, colocated_comm,
    colocated_coll, colocated_hier_coll, metrics_watchdog_coll,
    serve_churn, journal_churn, prefix_spec_churn, fleet_churn,
    control_churn, wave_fuse_gemm, tp_decode_churn)}
DEVICE_JOBS = ("wave_fuse_gemm", "tp_decode_churn")


def run_call(name: str, kwargs: dict, env=None, device="cuda"):
    """One entry of CALLS: the job under its environment; returns what
    the job returned."""
    kw = dict(kwargs)
    if name in DEVICE_JOBS:
        kw["device"] = device
    with environ(env):
        return JOBS[name](**kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="parsec_tpu_torch.tools.stress_tsan",
        description="Concurrency soak of the native core (run it under "
                    "ThreadSanitizer or UBSan: see the module's "
                    "docstring).")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the device jobs (default: the "
                         "card; cpu runs their plain versions on the host)")
    args = ap.parse_args(argv)
    device = torch_device(args.device)  # no card: raises before any job
    reps = int(os.environ.get("STRESS_REPS", "3"))
    for rep in range(reps):
        for name, kwargs, env in CALLS:
            t0 = time.perf_counter()
            run_call(name, kwargs, env, device=device)
            sys.stderr.write(f"job {name} "
                             f"{time.perf_counter() - t0:.3f} s\n")
        sys.stderr.write(f"rep {rep + 1}/{reps} done\n")
    print("stress ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
