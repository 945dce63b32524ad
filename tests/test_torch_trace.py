"""The port's trace layer (parsec_tpu_torch.profiling: trace.py,
critpath.py, the Context's profile_* methods and flight_dump) and the
device's own spans, held against parsec_tpu on the same DAGs.

Traces compare by their structure — event counts per key, begin/end
pairs, the (class, l0, l1) of spans and edges, the critical path's class
names — never by their times.  The .ptt file format is one format: a
trace either package saves loads in the other's Trace.load with equal
events, dictionary and meta.  Device spans: the port's CudaDevice(ctx,
device="cpu") against the reference's TpuDevice on JAX's CPU platform,
with the reference's wave compiler off (device.wave_fuse=0: the port has
no wave compiler yet, and a fused wave is one span for several waves).
Mirrors tests/profiling/test_trace.py, test_flight.py and
test_critpath.py."""
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import parsec_tpu as jpt
import parsec_tpu.profiling as jprof
import parsec_tpu_torch as tpt
import parsec_tpu_torch.profiling as tprof
from parsec_tpu import algos as jalgos
from parsec_tpu import data as jdata
from parsec_tpu.device import TpuDevice
from parsec_tpu_torch import algos as talgos
from parsec_tpu_torch import data as tdata
from parsec_tpu_torch.device import CudaDevice
from parsec_tpu_torch.device.prefetch import _PrefetchLane
from parsec_tpu_torch.profiling import (KEY_DEVICE, KEY_DEVICE_COMPLETE,
                                        KEY_DEVICE_PLAN, KEY_DEVICE_WAIT,
                                        KEY_EDGE, KEY_EXEC, KEY_GC_PAUSE,
                                        KEY_H2D, KEY_H2D_AHEAD, KEY_RELEASE)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = SimpleNamespace(
    name="ref", pt=jpt, prof=jprof, data=jdata, algos=jalgos,
    device=lambda ctx, **kw: TpuDevice(ctx, jax_device=jax.devices()[0],
                                       **kw))
PORT = SimpleNamespace(
    name="port", pt=tpt, prof=tprof, data=tdata, algos=talgos,
    device=lambda ctx, **kw: CudaDevice(ctx, device="cpu", **kw))


@pytest.fixture(autouse=True)
def _no_wave_fuse(monkeypatch):
    """The reference's wave compiler off: one DEVICE_DISPATCH span per
    launch on both packages."""
    monkeypatch.setenv("PTC_MCA_device_wave_fuse", "0")


def both(scenario, *args):
    return scenario(REF, *args), scenario(PORT, *args)


def _chain(P, ctx, nb, arena="int", body=None):
    pt = P.pt
    ctx.register_arena(arena, 8)
    tp = pt.Taskpool(ctx, globals={"NB": nb})
    k = pt.L("k")
    tc = tp.task_class("Task")
    tc.param("k", 0, pt.G("NB"))
    tc.flow("A", "RW",
            pt.In(None, guard=(k == 0)),
            pt.In(pt.Ref("Task", k - 1, flow="A")),
            pt.Out(pt.Ref("Task", k + 1, flow="A"), guard=(k < pt.G("NB"))),
            arena=arena)
    if body is None:
        tc.body(lambda t: None)
    else:
        tc.body(body)
    return tp, tc


def run_chain(P, nb=10):
    """A traced chain of nb + 1 host tasks (level 2: edges)."""
    with P.pt.Context(nb_workers=2) as ctx:
        ctx.profile_enable(True)
        tp, _ = _chain(P, ctx, nb)
        tp.run()
        tp.wait()
        return P.prof.take_trace(ctx, class_names=["Task"])


# the port's own keys: the device manager's time partition and the GC
# pauses (the reference has neither)
PORT_ONLY = (KEY_DEVICE_WAIT, KEY_DEVICE_PLAN, KEY_DEVICE_COMPLETE,
             KEY_GC_PAUSE)


def structure(tr):
    """What of a trace both packages must agree on: per-key begin counts,
    every event paired, and the (key, class, l0, l1) multiset of spans.
    The port's own keys are left out, and its lane's DEVICE_H2D_AHEAD
    spans count as what the reference traces them as, lane-1 DEVICE_H2D
    spans."""
    ev = tr.events[~np.isin(tr.events[:, 0], PORT_ONLY)].copy()
    ev[ev[:, 0] == KEY_H2D_AHEAD, 0] = KEY_H2D
    tr = type(tr)(ev, tr.dict, tr.rank, tr.meta, tr.class_names)
    spans = sorted((s[2], s[3], s[4], s[5]) for s in tr.spans())
    ev = tr.events
    nonedge = ev[ev[:, 0] != KEY_EDGE]
    return tr.counts(), len(spans) * 2 == len(nonedge), spans


# ------------------------------------------------------ host traces
def test_exec_spans_and_counts():
    nb = 10
    ref, port = both(run_chain, nb)
    assert structure(port) == structure(ref)
    for tr in (ref, port):
        counts = tr.counts()
        assert counts["EXEC"] == nb + 1 and counts["RELEASE_DEPS"] == nb + 1
        df = tr.to_pandas()
        ex = df[df["key"] == KEY_EXEC]
        assert len(ex) == nb + 1 and (ex["dur_ns"] >= 0).all()
        assert (ex["class_name"] == "Task").all()
        assert len(df[df["key"] == KEY_RELEASE]) == nb + 1


def test_edges_capture_chain_dag():
    nb = 8
    ref, port = both(run_chain, nb)
    assert sorted(port.edges()) == sorted(ref.edges())
    assert {(s[1], d[1]) for s, d in port.edges()} == \
        {(k, k + 1) for k in range(nb)}
    dot = tprof.to_dot(port)
    assert dot == jprof.to_dot(ref)
    assert "Task_0_0" in dot and "->" in dot


def save_load_merge(P, tmp_path):
    tr = run_chain(P, 5)
    p = str(tmp_path / f"{P.name}_r0.ptt")
    tr.save(p)
    lt = P.prof.Trace.load(p)
    np.testing.assert_array_equal(lt.events, tr.events)
    tr2 = run_chain(P, 3)
    tr2.rank = 1
    tr2.ranks[:] = 1
    m = P.prof.Trace.merge([tr, tr2])
    df = m.to_pandas()
    return (lt.dict.name(KEY_EXEC), len(m.events) == len(tr.events)
            + len(tr2.events), sorted(df["rank"].unique().tolist()),
            [len(df[(df["rank"] == r) & (df["key"] == KEY_EXEC)])
             for r in (0, 1)])


def test_trace_save_load_merge(tmp_path):
    ref, port = both(save_load_merge, tmp_path)
    assert port == ref == ("EXEC", True, [0, 1], [6, 4])


def merge_conflicts(P):
    a, b = run_chain(P, 3), run_chain(P, 3)
    b.rank = 1
    b.ranks[:] = 1
    b.dict.add(40, "RANK1_ONLY", "#123456")
    adopted = P.prof.Trace.merge([a, b]).dict.name(40)
    b.dict.add(KEY_EXEC, "NOT_EXEC")  # same key, different name
    with pytest.raises(ValueError, match="dictionary conflict"):
        P.prof.Trace.merge([a, b])
    b.dict.add(KEY_EXEC, "EXEC")
    b.class_names = ["Task", "Extra"]  # superset: adopted
    names = P.prof.Trace.merge([a, b]).class_names
    b.class_names = ["Other"]
    with pytest.raises(ValueError, match="class_names conflict"):
        P.prof.Trace.merge([a, b])
    return adopted, names


def test_merge_dictionary_and_class_names_conflicts():
    ref, port = both(merge_conflicts)
    assert port == ref == ("RANK1_ONLY", ["Task", "Extra"])


def merge_offsets(P):
    a, b = run_chain(P, 3), run_chain(P, 3)
    b.rank = 1
    b.ranks[:] = 1
    b.meta["clock_offset_ns"] = 1_000_000
    t_before = b.events[:, 7].copy()
    m = P.prof.Trace.merge([a, b], causal=False)
    np.testing.assert_array_equal(m.events[m.ranks == 1][:, 7],
                                  t_before + 1_000_000)
    m2 = P.prof.Trace.merge([a, b], apply_offsets=False, causal=False)
    np.testing.assert_array_equal(m2.events[m2.ranks == 1][:, 7], t_before)
    return m.meta["clock_offsets_ns"][1]


def test_merge_applies_clock_offsets():
    assert both(merge_offsets) == (1_000_000, 1_000_000)


def test_spans_nested_same_signature_fallback():
    """The vectorized pairing falls back to the LIFO stack for nested
    spans of one signature: the same pairs on both packages."""
    E = KEY_EXEC
    ev = np.array([
        [E, 0, 7, 1, 2, 0, 0, 100], [E, 0, 7, 1, 2, 0, 0, 110],
        [E, 1, 7, 1, 2, 0, 0, 120], [E, 1, 7, 1, 2, 0, 0, 130],
        [E, 0, 9, 0, 0, 0, 5, 200], [E, 1, 9, 0, 0, 0, 9, 210],
    ], dtype=np.int64)
    got = [sorted(P.prof.Trace(ev.copy()).spans(), key=lambda s: s[7])
           for P in (REF, PORT)]
    assert got[1] == got[0]
    assert [(s[7], s[8]) for s in got[1]] == [(100, 130), (110, 120),
                                              (200, 210)]
    assert got[1][2][6] == 9  # aux = max(begin, end)


def test_spans_matches_reference_pairing():
    """spans() of the port == the historical per-event stack loop, and
    == the reference's spans() on the same events."""
    tr = run_chain(PORT, 20)

    def stack_loop(trace):
        open_spans = {}
        for i in range(len(trace.events)):
            key, phase, cid, l0, l1, worker, aux, t = (
                int(x) for x in trace.events[i])
            if key == KEY_EDGE:
                continue
            sig = (int(trace.ranks[i]), worker, key, cid, l0, l1)
            if phase == 0:
                open_spans.setdefault(sig, []).append((aux, t))
            else:
                st = open_spans.get(sig)
                if st:
                    aux0, t0 = st.pop()
                    yield (sig[0], worker, key, cid, l0, l1,
                           max(aux, aux0), t0, t)

    assert list(tr.spans()) == list(stack_loop(tr))
    assert list(tr.spans()) == list(jprof.Trace(tr.events.copy()).spans())


def test_trace_v2_roundtrip_meta(tmp_path):
    tr = run_chain(PORT, 4)
    tr.meta["clock_offset_ns"] = 42
    tr.meta["clock_err_ns"] = 7
    p = str(tmp_path / "v2.ptt")
    tr.save(p)
    lt = tprof.Trace.load(p)
    assert lt.meta["clock_offset_ns"] == 42 and lt.meta["clock_err_ns"] == 7
    np.testing.assert_array_equal(lt.events, tr.events)


@pytest.mark.parametrize("writer,reader", [(PORT, REF), (REF, PORT)],
                         ids=["port_to_ref", "ref_to_port"])
def test_ptt_loads_in_the_other_package(tmp_path, writer, reader):
    """One .ptt format: a trace one package saves loads in the other's
    Trace.load with equal events, dictionary, meta and class names."""
    tr = run_chain(writer, 6)
    tr.meta["note"] = writer.name
    p = str(tmp_path / f"{writer.name}.ptt")
    tr.save(p)
    lt = reader.prof.Trace.load(p)
    np.testing.assert_array_equal(lt.events, tr.events)
    assert lt.dict.keys == tr.dict.keys
    assert lt.meta == tr.meta and lt.class_names == tr.class_names
    assert lt.rank == tr.rank


def test_take_trace_meta_and_lazy_pandas():
    """take_trace stamps the flight recorder's counters; importing the
    trace module does not import pandas (to_pandas imports it when
    called: the card's machine has none)."""
    tr = run_chain(PORT, 2)
    assert tr.meta["dropped_events"] == 0 and tr.meta["ring_bytes"] == 0
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, parsec_tpu_torch.profiling as p; "
         "p.Trace(__import__('numpy').zeros((0, 8), 'int64')).spans(); "
         "print('pandas' in sys.modules)"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0 and r.stdout.strip() == "False", r


# ------------------------------------------------------- device spans
def potrf_traced(P):
    """Tile potrf on a device, traced; stop() before the drain."""
    n, nb = 96, 32
    M = np.random.default_rng(0).standard_normal((n, n), dtype=np.float32)
    spd = M @ M.T + n * np.eye(n, dtype=np.float32)
    with P.pt.Context(nb_workers=2) as ctx:
        ctx.profile_enable(True)
        A = P.data.TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32)
        A.from_dense(spd)
        A.register(ctx, "A")
        dev = P.device(ctx)
        tp = P.algos.build_potrf(ctx, A, dev=dev)
        tp.run()
        tp.wait()
        tasks = dev.stats["tasks"]
        dev.stop()
        tr = P.prof.take_trace(ctx, class_names=["POTRF", "TRSM", "SYRK",
                                                 "GEMM"])
    return tr, tasks


def test_device_dispatch_spans():
    """A device-run potrf is visible in the trace: DEVICE_DISPATCH spans
    whose lanes sum to the device's tasks, on both packages."""
    for tr, tasks in both(potrf_traced):
        df = tr.to_pandas()
        dd = df[df["key"] == KEY_DEVICE]
        assert len(dd) > 0 and dd["name"].eq("DEVICE_DISPATCH").all()
        assert (dd["dur_ns"] >= 0).all() and dd["l0"].min() >= 1
        assert int(dd["l0"].sum()) == tasks


def wave_span(P):
    """The device queue pre-filled with a fan of 8 before the manager
    starts: the first drain is one launch of 8 lanes."""
    pt = P.pt
    nb = 8
    with pt.Context(nb_workers=2) as ctx:
        ctx.profile_enable(True)
        arr = np.zeros((nb, 4), dtype=np.float32)
        ctx.register_linear_collection("A", arr, elem_size=16, nodes=1,
                                       myrank=0)
        ctx.register_arena("t", 16)
        dev = P.device(ctx, autostart=False)
        tp = pt.Taskpool(ctx, globals={"NB": nb - 1})
        k = pt.L("k")
        tc = tp.task_class("T")
        tc.param("k", 0, pt.G("NB"))
        tc.flow("A", "RW", pt.In(pt.Mem("A", k)), pt.Out(pt.Mem("A", k)),
                arena="t")
        dev.attach(tc, tp, kernel=lambda x: x + 1.0, reads=["A"],
                   writes=["A"], shapes={"A": (4,)})
        tp.run()
        deadline = time.monotonic() + 30
        while ctx.device_queue_depth(dev.qid) < nb and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        dev.start()
        tp.wait()
        dev.stop()
        tr = P.prof.take_trace(ctx, class_names=["T"])
    np.testing.assert_array_equal(arr, np.ones((nb, 4), dtype=np.float32))
    return tr


def test_device_wave_span_deterministic():
    """One span of 8 lanes on the device's queue, and one 16-byte
    staging span per tile (DEVICE_H2D, or DEVICE_H2D_AHEAD where the
    port's lane staged it first), on both packages."""
    ref, port = both(wave_span)
    assert structure(port) == structure(ref)
    dd = [s for s in port.spans() if s[2] == KEY_DEVICE]
    assert len(dd) == 1 and dd[0][4] == 8 and dd[0][3] == 0
    h2d = [s for s in port.spans() if s[2] in (KEY_H2D, KEY_H2D_AHEAD)]
    assert len(h2d) == 8 and {s[4] for s in h2d} == {16}


def gemm_traced(P, batch_max):
    """GEMM 64^2 in 16^2 tiles on a device, level 2, the lane off;
    batch_max 1 makes every launch one task (deterministic spans)."""
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((64, 64)).astype(np.float32)
            for _ in range(2))
    with P.pt.Context(nb_workers=2) as ctx:
        ctx.profile_enable(2)
        colls = []
        for name, x in (("A", a), ("B", b), ("C", None)):
            c = P.data.TwoDimBlockCyclic(64, 64, 16, 16, dtype=np.float32)
            if x is not None:
                c.from_dense(x)
            c.register(ctx, name)
            # each tile's Data made before the run: the reference's
            # data_of is not thread-safe (two workers touching a tile
            # first at once can make two Data, staged twice)
            for m in range(4):
                for j in range(4):
                    c.data_of(m, j)
            colls.append(c)
        dev = P.device(ctx, prefetch=False)
        if batch_max:
            dev.batch_max = batch_max
        tp = P.algos.build_gemm(ctx, *colls, dev)
        tp.run()
        tp.wait()
        dev.flush()
        st = dict(dev.stats)
        tr = P.prof.take_trace(ctx, class_names=["Gemm"])
        dev.stop()
        out = colls[2].to_dense()
    return tr, st, out, a @ b


def test_device_spans_match_the_reference():
    """The same DAG, one task a launch: the port's DEVICE_DISPATCH and
    DEVICE_H2D spans have the reference's count, keys, class, l0 (lanes;
    bytes) and l1 (the device queue), and its EDGE/RELEASE structure; C
    within the reference's device tolerance (1e-4)."""
    (ref, rst, rc, want), (port, pst, pc, _) = both(gemm_traced, 1)
    assert structure(port) == structure(ref)
    assert sorted(port.edges()) == sorted(ref.edges())
    assert port.counts()["DEVICE_DISPATCH"] == 64
    assert port.counts()["DEVICE_H2D"] == 48  # each tile staged once
    np.testing.assert_allclose(pc, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pc, rc, rtol=1e-4, atol=1e-4)


def _device_sums(tr):
    ev = tr.events
    beg = ev[:, 1] == 0
    d, h = ev[:, 0] == KEY_DEVICE, ev[:, 0] == KEY_H2D
    return {"dispatch_begins": int((d & beg).sum()),
            "dispatch_ends": int((d & ~beg).sum()),
            "lanes": int(ev[d & beg, 3].sum()),
            "h2d_bytes": int(ev[h & beg, 3].sum()),
            "stall_ns": int(ev[d & ~beg, 6].sum())}


def test_device_spans_account_for_the_stats():
    """Waves of any width (batch_max free): dispatch begins and ends
    pair, their lanes sum to stats["tasks"], the DEVICE_H2D bytes to
    stats["h2d_bytes"] and the ends' aux to stats["h2d_stall_ns"]; the
    reference's sums hold the same way."""
    for tr, st, out, want in both(gemm_traced, None):
        s = _device_sums(tr)
        assert s["dispatch_begins"] == s["dispatch_ends"] > 0
        assert s["lanes"] == st["tasks"] == 64
        assert s["h2d_bytes"] == st["h2d_bytes"] == 48 * 1024
        assert s["stall_ns"] == st["h2d_stall_ns"] > 0
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_lane_spans_account_for_the_stats():
    """With the prefetch lane: a deterministic lane sweep before the
    manager starts stages the lookahead as DEVICE_H2D_AHEAD spans (class
    -1, l1 = the queue, aux 1); the dispatch-time rest as DEVICE_H2D
    spans (aux 0); together they sum to stats["h2d_bytes"], and only the
    dispatch ones to the dispatch stall."""
    nb, elems = 8, 256
    src = np.random.default_rng(1).standard_normal((nb, elems)) \
        .astype(np.float32)
    with tpt.Context(nb_workers=2) as ctx:
        ctx.profile_enable(1)
        dst = np.zeros_like(src)
        ctx.register_linear_collection("X", src, elem_size=elems * 4)
        ctx.register_linear_collection("Y", dst, elem_size=elems * 4)
        dev = CudaDevice(ctx, device="cpu", autostart=False, prefetch=True)
        tp = tpt.Taskpool(ctx, globals={"NB": nb - 1})
        k = tpt.L("k")
        tc = tp.task_class("T")
        tc.param("k", 0, tpt.G("NB"))
        tc.flow("X", "READ", tpt.In(tpt.Mem("X", k)))
        tc.flow("Y", "RW", tpt.In(tpt.Mem("Y", k)), tpt.Out(tpt.Mem("Y", k)))
        dev.attach(tc, tp, kernel=lambda x, y: x * 2.0 + y,
                   reads=["X", "Y"], writes=["Y"],
                   shapes={"X": (elems,), "Y": (elems,)})
        tp.run()
        deadline = time.monotonic() + 30
        while ctx.device_queue_depth(dev.qid) < nb and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        _PrefetchLane(dev)._sweep()
        dev.start()
        tp.wait()
        dev.flush()
        st = dict(dev.stats)
        dev.stop()
        tr = tprof.take_trace(ctx)
    np.testing.assert_array_equal(dst, src * 2.0)
    ev = tr.events
    lane = (ev[:, 0] == KEY_H2D_AHEAD) & (ev[:, 1] == 0)
    h = ((ev[:, 0] == KEY_H2D) & (ev[:, 1] == 0)) | lane
    assert lane.sum() == st["prefetch_staged"] > 0
    assert set(ev[lane, 2]) == {-1} and set(ev[lane, 6]) == {1}
    assert set(ev[h & ~lane, 6]) <= {0} and set(ev[h, 4]) == {dev.qid}
    assert int(ev[h, 3].sum()) == st["h2d_bytes"]
    s = _device_sums(tr)
    assert s["stall_ns"] == st["h2d_stall_ns"]
    assert s["lanes"] == st["tasks"] == nb


def test_to_perfetto_of_a_device_trace(tmp_path):
    tr, _, _, _ = gemm_traced(PORT, None)
    doc = tr.to_perfetto(str(tmp_path / "t.json"))
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"DEVICE_DISPATCH", "DEVICE_H2D"} <= names
    assert os.path.getsize(tmp_path / "t.json") > 0


# ------------------------------------------------------ flight recorder
RING_EVENTS = 64  # 64 events/worker: 64 * 8 words * 8 bytes = 4096 B


def ring_drops_oldest(P, tmp_path):
    nb = 1000
    with P.pt.Context(nb_workers=1) as ctx:
        ctx.profile_enable(1)
        unbounded = ctx.profile_ring()
        ctx.profile_ring(RING_EVENTS * 8 * 8)
        ring = ctx.profile_ring()
        tp, tc = _chain(P, ctx, nb - 1, arena="t")
        tc.body_noop()
        tp.run()
        tp.wait()
        dropped = ctx.profile_dropped()
        dump = str(tmp_path / f"{P.name}_manual.ptt")
        ctx.flight_dump(dump)  # a dump does NOT drain
        tr = P.prof.take_trace(ctx, class_names=["Task"])
    assert dropped > 0 and len(tr.events) <= RING_EVENTS
    ex = tr.events[tr.events[:, 0] == KEY_EXEC]
    ft = P.prof.Trace.load(dump)
    np.testing.assert_array_equal(ft.events, tr.events)
    # overwrite-OLDEST: the final task of the chain survived
    return (unbounded, ring, int(ex[:, 3].max()),
            tr.meta["dropped_events"] == dropped,
            tr.meta["ring_bytes"], ft.meta["flight"],
            ft.meta["dropped_events"] == dropped)


def test_ring_drops_oldest_keeps_newest(tmp_path):
    ref, port = both(ring_drops_oldest, tmp_path)
    assert port == ref == (0, 4096, 999, True, 4096, 1, True)


def ring_take_then_refill(P):
    with P.pt.Context(nb_workers=1) as ctx:
        ctx.profile_enable(1)
        ctx.profile_ring(RING_EVENTS * 8 * 8)
        tp, tc = _chain(P, ctx, 9, arena="t")
        tc.body_noop()
        tp.run()
        tp.wait()
        first = len(ctx.profile_take())
        drained = len(ctx.profile_take())
        tp2, tc2 = _chain(P, ctx, 9, arena="t2")
        tc2.body_noop()
        tp2.run()
        tp2.wait()
        return first > 0, drained, len(ctx.profile_take()) > 0


def test_ring_take_then_refill():
    assert both(ring_take_then_refill) == ((True, 0, True),) * 2


def unbounded_drops_nothing(P):
    with P.pt.Context(nb_workers=1) as ctx:
        ctx.profile_enable(1)
        tp, tc = _chain(P, ctx, 499, arena="t")
        tc.body_noop()
        tp.run()
        tp.wait()
        dropped = ctx.profile_dropped()
        tr = P.prof.take_trace(ctx, class_names=["Task"])
    return dropped, int(np.sum((tr.events[:, 0] == KEY_EXEC)
                               & (tr.events[:, 1] == 0)))


def test_unbounded_mode_drops_nothing():
    assert both(unbounded_drops_nothing) == ((0, 500),) * 2


def dump_on_abort(P, tmp_path, monkeypatch):
    prefix = str(tmp_path / f"fl_{P.name}")
    monkeypatch.setenv("PTC_MCA_runtime_trace_ring", "8192")
    monkeypatch.setenv("PTC_MCA_runtime_trace_dump", prefix)

    def body(view):
        if view["k"] == 10:
            raise RuntimeError("boom")

    with P.pt.Context(nb_workers=1) as ctx:
        ctx.profile_enable(1)
        tp, _ = _chain(P, ctx, 19, arena="t", body=body)
        tp.run()
        with pytest.raises(RuntimeError, match="aborted"):
            tp.wait()
    path = f"{prefix}.0.ptt"
    assert os.path.exists(path), os.listdir(tmp_path)
    ft = P.prof.Trace.load(path)
    ex = ft.events[(ft.events[:, 0] == KEY_EXEC) & (ft.events[:, 1] == 0)]
    return ft.meta["flight"], len(ex) > 0


def test_dump_on_abort(tmp_path, monkeypatch):
    """An aborting pool leaves '<prefix>.<rank>.ptt' behind; the prefix
    is under tmp_path (runtime.trace_dump), so no other test's dump, in
    this process or another, shares its file."""
    assert both(dump_on_abort, tmp_path, monkeypatch) == ((1, True),) * 2


# ---------------------------------------------- critical path, lost time
def run_diamond(P, slow="B", sleep_slow=0.04, sleep_fast=0.004):
    """A -> {B, C} -> D with one slow middle task; the level-2 trace.
    Hand-computed critical path: [A, <slow>, D]."""
    pt = P.pt
    with pt.Context(nb_workers=2) as ctx:
        ctx.profile_enable(2)
        ctx.register_arena("t", 8)
        tp = pt.Taskpool(ctx)
        sleeps = {"A": 0.002, "B": sleep_fast, "C": sleep_fast,
                  "D": 0.002, slow: sleep_slow}

        def body_of(name):
            return lambda view: time.sleep(sleeps[name])

        a = tp.task_class("A")
        a.flow("X", "W", pt.Out(pt.Ref("B", flow="X")),
               pt.Out(pt.Ref("C", flow="X")), arena="t")
        a.body(body_of("A"))
        b = tp.task_class("B")
        b.flow("X", "RW", pt.In(pt.Ref("A", flow="X")),
               pt.Out(pt.Ref("D", flow="X")), arena="t")
        b.body(body_of("B"))
        c = tp.task_class("C")
        c.flow("X", "RW", pt.In(pt.Ref("A", flow="X")),
               pt.Out(pt.Ref("D", flow="Y")), arena="t")
        c.body(body_of("C"))
        d = tp.task_class("D")
        d.flow("X", "R", pt.In(pt.Ref("B", flow="X")), arena="t")
        d.flow("Y", "R", pt.In(pt.Ref("C", flow="X")), arena="t")
        d.body(body_of("D"))
        tp.run()
        tp.wait()
        return P.prof.take_trace(ctx, class_names=["A", "B", "C", "D"])


def _path_shape(P, tr):
    cp = P.prof.critical_path(tr)
    per = cp["per_class_ns"]
    return (cp["nodes"], cp["edges"], [p[0] for p in cp["path"]],
            cp["total_ns"] == sum(p[3] for p in cp["path"]),
            max(per, key=per.get), 0 < cp["coverage"] <= 1)


@pytest.mark.parametrize("slow", ["B", "C"])
def test_diamond_critical_path_exact(slow):
    """The path's class names, node and edge counts and attribution are
    the reference's and the hand-computed ones."""
    ref, port = (_path_shape(P, run_diamond(P, slow)) for P in (REF, PORT))
    assert port == ref == (4, 4, ["A", slow, "D"], True, slow, True)


def test_diamond_method_alias():
    tr = run_diamond(PORT)
    assert tr.critical_path()["path"] == tprof.critical_path(tr)["path"]
    # the reference's analysis reads the port's trace the same way
    assert jprof.critical_path(jprof.Trace(tr.events.copy(),
                                           class_names=tr.class_names)
                               )["path"] == tr.critical_path()["path"]


def level1_path(P):
    with P.pt.Context(nb_workers=1) as ctx:
        ctx.profile_enable(1)
        tp = P.pt.Taskpool(ctx, globals={"NB": 3})
        tc = tp.task_class("T")
        tc.param("k", 0, P.pt.G("NB"))
        tc.body(lambda t: None)
        tp.run()
        tp.wait()
        tr = P.prof.take_trace(ctx, class_names=["T"])
    cp = P.prof.critical_path(tr)
    return cp["edges"], len(cp["path"])


def test_critical_path_needs_edges():
    """Level-1 traces (no EDGE events) degrade to one EXEC span."""
    assert both(level1_path) == ((0, 1),) * 2


def test_cycle_detection():
    ev = []
    for cid in (0, 1):
        ev.append([KEY_EXEC, 0, cid, 0, 0, 0, 0, 1000])
        ev.append([KEY_EXEC, 1, cid, 0, 0, 0, 0, 1010])
    ev += [[2, 0, 0, 0, 0, 0, 0, 1000], [2, 1, 1, 0, 0, 0, 0, 1000],
           [2, 0, 1, 0, 0, 0, 0, 1000], [2, 1, 0, 0, 0, 0, 0, 1000]]
    for P in (REF, PORT):
        with pytest.raises(ValueError, match="cycle"):
            P.prof.critical_path(P.prof.Trace(np.array(ev, np.int64)))


def test_lost_time_breakdown():
    tr = run_diamond(PORT)
    lt = tprof.lost_time(tr)
    assert lt["workers"], lt
    tot = lt["totals"]
    for bucket in ("compute", "release", "h2d_stall", "comm_wait", "idle"):
        assert bucket in tot and tot[bucket] >= 0
    assert tot["compute"] > 0
    for b in lt["workers"].values():
        assert b["window_ns"] >= b["compute"] and b["comm_wait"] == 0, b
    # the reference's analysis on the same events gives the same numbers
    jt = jprof.Trace(tr.events.copy(), class_names=tr.class_names)
    assert jprof.lost_time(jt) == lt


def test_lost_time_coll_wait_split():
    """A synthetic trace, hand-computed: 100 us idle before a plain
    delivery, 200 us before a collective one; both packages split them
    exactly."""
    from parsec_tpu_torch.profiling import KEY_COLL, KEY_COMM_RECV
    us = 1000
    ev = [[KEY_EXEC, 0, 0, 0, 0, 0, 0, 0],
          [KEY_EXEC, 1, 0, 0, 0, 0, 0, 10 * us],
          [KEY_COMM_RECV, 0, 0, 1, 7, -1, 64, 110 * us],
          [KEY_EXEC, 0, 0, 0, 1, 0, 0, 110 * us],
          [KEY_EXEC, 1, 0, 0, 1, 0, 0, 120 * us],
          [KEY_COMM_RECV, 0, 1, 1, 9, -1, 64, 320 * us],
          [KEY_COLL, 0, 1, 1, 9, -1, 64, 320 * us],
          [KEY_EXEC, 0, 0, 0, 2, 0, 0, 320 * us],
          [KEY_EXEC, 1, 0, 0, 2, 0, 0, 330 * us]]
    got = [P.prof.lost_time(P.prof.Trace(np.array(ev, np.int64)))
           for P in (REF, PORT)]
    assert got[1] == got[0]
    b = got[1]["workers"][(0, 0)]
    assert (b["comm_wait"], b["coll_wait"], b["compute"]) == \
        (100 * us, 200 * us, 30 * us)
    assert (b["compute"] + b["comm_wait"] + b["coll_wait"] + b["release"]
            + b["idle"]) == b["window_ns"]


@pytest.mark.parametrize("name,value", [
    ("runtime.pins", "print_steals"), ("runtime.live", "1"),
    ("runtime.metrics_port", "9100"), ("runtime.watchdog", "1"),
    ("runtime.journal", "journal.jsonl")])
def test_next_slice_hooks_still_refused(monkeypatch, tmp_path, name, value):
    """The hooks this test once found refused (PINS, the live sampler,
    the metrics exporter, the watchdog, the journal) are ported now:
    each parameter installs its module at Context init, and the
    Context's teardown stops it.  (The exporter binds a free localhost
    port in place of 9100, and the journal a directory under tmp_path.)"""
    if name == "runtime.journal":
        value = str(tmp_path / value)
    if name == "runtime.metrics_port":
        import socket
        with socket.socket() as sock:  # a free localhost port
            sock.bind(("127.0.0.1", 0))
            value = str(sock.getsockname()[1])
    monkeypatch.setenv("PTC_MCA_" + name.replace(".", "_"), value)
    monkeypatch.chdir(tmp_path)
    with tpt.Context(nb_workers=1) as ctx:
        installed = {"runtime.pins": ctx._pins_chain,
                     "runtime.live": (ctx._monitors or [None])[0],
                     "runtime.metrics_port": ctx._metrics_exporter,
                     "runtime.watchdog": ctx._watchdog,
                     "runtime.journal": ctx._journal}
        assert sum(v is not None for v in installed.values()) == 1
        obj = installed[name]
        assert obj is not None
        live = getattr(obj, "_thread", None)
    if live is not None:
        assert not live.is_alive()
    if name == "runtime.journal":
        assert os.path.exists(os.path.join(value, "journal.0.jsonl"))
