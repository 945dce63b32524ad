"""Binary trace format + pandas trace tables + DOT grapher.

File format (".ptt", the dbp analog — parsec/parsec_binary_profile.h:45
magic "#PARSEC BINARY PROFILE" becomes "#PTCPROF"):
  bytes 0..7   magic b"#PTCPROF"
  bytes 8..11  version (u32 LE) = 2
  bytes 12..15 header length H (u32 LE)
  bytes 16..16+H  JSON header {rank, dictionary:{key:{name,color}}, meta}
  rest         int64 LE event words, 8 per event:
               (key, phase, class_id, l0, l1, worker, aux, t_ns)

Header v2 (distributed tracing): `meta` carries the rank's measured
clock offset to rank 0 (`clock_offset_ns`, PING/PONG midpoint estimate
with `clock_err_ns` = the winning sample's RTT), flight-recorder
provenance (`dropped_events`, `ring_bytes`), and COMM_SEND/COMM_RECV
events carry a flow-correlation id — (peer, cookie) in (l0, l1) — so
`Trace.merge` can align per-rank timelines and pair sends with their
deliveries across ranks (reference: the dbp merge's cross-rank clock
resolution + OTF2 message matching, parsec/profiling.c,
parsec/profiling_otf2.c).  v1 files still load (offset 0, no flows).

Port of parsec_tpu/profiling/trace.py.  The file format is the same byte
for byte, so a trace the port writes on the card loads in the
reference's Trace.load (and its tools, tools/ptt_critpath.py and
tools/ptt2tables.py, read it on a machine with JAX), and the reverse.
take_trace stamps each rank's clock offset from Context.comm_clock, so
Trace.merge lines up the ranks of a multi-rank run.
"""
import json
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

KEY_EXEC = 0       # task body begin/end
KEY_RELEASE = 1    # release_deps begin/end
KEY_EDGE = 2       # dep edge, consecutive src(phase0)/dst(phase1) pair
KEY_COMM_SEND = 3  # per-frame activation send (instant span),
                   # l0 = destination rank, l1 = correlation cookie,
                   # aux = payload bytes
KEY_COMM_RECV = 4  # per-frame activation delivery (instant span),
                   # l0 = source rank, l1 = correlation cookie (matches
                   # the producer's COMM_SEND), aux = payload bytes
KEY_DEVICE = 5     # device dispatch call begin/end, l0 = lanes, l1 =
                   # device queue, class = the task class (-1: a DTD
                   # body); the END event's aux = the launch's
                   # dispatch-time h2d stall ns (0 == prefetch-hit wave).
                   # The span brackets the host's work (staging, the
                   # asynchronous enqueue), not the kernel on the card
KEY_H2D = 6        # h2d staging span, l0 = bytes, l1 = device queue,
                   # aux = lane (0 dispatch-time stall, 1 staged off the
                   # dispatch path: the prefetch lane, stage_collection);
                   # the span brackets the copy into pinned staging and
                   # the enqueue of the asynchronous copy on the h2d
                   # stream, not the copy itself
KEY_STREAM = 7     # progressive-serve d2h span (writeback lane slicing a
                   # remote-pulled mirror), l0 = bytes, l1 = device queue
KEY_COLL = 8       # collective-step delivery on a ptc_coll_* task class
                   # (instant span, emitted ALONGSIDE the COMM_RECV of
                   # the same frame): l0 = source rank, l1 = correlation
                   # cookie, aux = payload bytes — the evidence behind
                   # the coll_wait lost-time bucket (critpath.lost_time)
KEY_SCOPE = 9      # request-scope flow tag (instant span, emitted
                   # alongside COMM_SEND on the producer and COMM_RECV
                   # on the consumer when the sending pool carries a
                   # scope stamp): l0 = source rank, l1 = correlation
                   # cookie, aux = scope_id — maps each wire flow back
                   # to the request it served.  EXEC/RELEASE spans of a
                   # scoped pool carry the scope in their aux word, and
                   # the device layer stamps dispatch-lane H2D spans'
                   # class slot with it (prefetch-lane/STREAM spans stay
                   # -1: overlapped staging is not request lost time).
                   # See profiling/scope.py.
KEY_INFLIGHT = 10  # crash-dump synthetic (ptc-blackbox): one instant
                   # span per OPEN EXEC body at fatal-signal / peer-loss
                   # dump time, built from the watchdog inflight slots
                   # inside the async-signal-safe crash writer.
                   # class = metrics class id (mid), l0 = worker,
                   # aux = scope_id, begin = the body's open timestamp.
                   # Never emitted on the normal path; ptc_postmortem
                   # reads these to name what a dead rank was executing.
# The device manager's own time (device/cuda.py), worker -1, l1 = the
# device's queue.  Its thread's time is partitioned: every instant of its
# loop lies in exactly one DEVICE_WAIT, DEVICE_PLAN, DEVICE_DISPATCH or
# DEVICE_COMPLETE span, each the span of one stats["mgr_*_ns"] counter.
KEY_DEVICE_WAIT = 11      # blocked on the device queue, no device task
                          # ready: from the first empty pop to the pop
                          # that returns a task, or one batch-wait poll
KEY_DEVICE_PLAN = 12      # grouping a popped batch, the wave compiler's
                          # planning and certification before a launch,
                          # the prefetch lane's handoff
KEY_DEVICE_COMPLETE = 13  # completing device tasks on the manager thread
                          # (the native release of their dependencies):
                          # class = the task class (-1: a DTD body or
                          # none), l0 = tasks, aux = 1 where they complete
                          # from parked chain or epilogue results (l0 is
                          # then the tasks looked up; a stale result goes
                          # on to a launch, counted in chain/spec_misses)
KEY_GC_PAUSE = 14         # one pass of Python's cyclic collector while a
                          # CudaDevice runs, on the thread that triggered
                          # it: l0 = the generation.  It overlaps the
                          # manager span it interrupts (no fifth bucket)
KEY_H2D_AHEAD = 15        # h2d staged off the dispatch path (the prefetch
                          # lane, stage_collection, a check's read): as
                          # DEVICE_H2D, class -1, aux 1.  A key of its own
                          # so that its spans never pair with a
                          # dispatch's of the same bytes and queue
# The device data plane's callbacks (device/cuda.py), on the comm thread,
# worker -1: l0 = the payload's bytes, l1 = the device's queue.  Each
# key's durations add up to one stats counter.
KEY_DEVICE_DP_SERVE = 16  # a remote pull served from the device: the d2h
                          # into pinned memory (or the token) and the
                          # handoff to the engine; aux = the pulling
                          # rank; stats["dp_serve_ns"]
KEY_DEVICE_DP_RECV = 17   # a remote payload landed in a device mirror:
                          # the pinned staging copy and the h2d's enqueue
                          # (or the clone or pull of a token); aux -1;
                          # stats["dp_recv_ns"]
# The wave compiler (device/fuse.py), on the manager thread, worker -1,
# inside the DEVICE_PLAN span under way: l0 = 0, l1 = the device's queue.
KEY_DEVICE_CERT = 18      # a pool's chain certificates had once: the
                          # structure key and, on a miss, the pass; the
                          # END's aux = 0 a miss, 1 a cache hit, 2 a pool
                          # the key cannot render (uncached); their
                          # durations add up to stats["cert_ns"]
# The device's write-back of its dirty mirrors to the host
# (CudaDevice.flush), on the calling thread: l0 = the bytes written
# back, l1 = the device's queue, class -1, aux 0.
KEY_DEVICE_FLUSH = 19     # one flush(): the stacked d2h copies and their
                          # landing in the host tiles, after the writeback
                          # lane's queue has drained; their durations add
                          # up to stats["flush_ns"]

_MAGIC = b"#PTCPROF"
_VERSION = 2
_LOADABLE_VERSIONS = (1, 2)

_DEFAULT_KEYS = {
    KEY_EXEC: ("EXEC", "#00ff00"),
    KEY_RELEASE: ("RELEASE_DEPS", "#0000ff"),
    KEY_EDGE: ("EDGE", "#888888"),
    KEY_COMM_SEND: ("COMM_SEND", "#ff0000"),
    KEY_COMM_RECV: ("COMM_RECV", "#ff8800"),
    KEY_DEVICE: ("DEVICE_DISPATCH", "#aa00ff"),
    KEY_H2D: ("DEVICE_H2D", "#00aaff"),
    KEY_STREAM: ("STREAM_D2H", "#ffaa00"),
    KEY_COLL: ("COLL_RECV", "#00ffcc"),
    KEY_SCOPE: ("SCOPE", "#ff00aa"),
    KEY_INFLIGHT: ("INFLIGHT", "#ff4444"),
    KEY_DEVICE_WAIT: ("DEVICE_WAIT", "#dddddd"),
    KEY_DEVICE_PLAN: ("DEVICE_PLAN", "#ffdd00"),
    KEY_DEVICE_COMPLETE: ("DEVICE_COMPLETE", "#0066ff"),
    KEY_GC_PAUSE: ("GC_PAUSE", "#ff0000"),
    KEY_H2D_AHEAD: ("DEVICE_H2D_AHEAD", "#66ccff"),
    KEY_DEVICE_DP_SERVE: ("DEVICE_DP_SERVE", "#cc6600"),
    KEY_DEVICE_DP_RECV: ("DEVICE_DP_RECV", "#669900"),
    KEY_DEVICE_CERT: ("DEVICE_CERT", "#996600"),
    KEY_DEVICE_FLUSH: ("DEVICE_FLUSH", "#339999"),
}

# a device op on the wall clock, as torch.profiler's CUDA events carry it
DeviceOp = Tuple[str, int, int]  # (name, start_ns, end_ns)


def clock_anchor(samples: int = 5) -> Tuple[int, int]:
    """One (trace clock, wall clock) pair in ns: ptc_clock_ns read
    between two time.time_ns() reads, against their midpoint, from the
    tightest of `samples` brackets."""
    from .. import _native as N
    best = None
    for _ in range(samples):
        w0 = time.time_ns()
        c = N.lib.ptc_clock_ns()
        w1 = time.time_ns()
        if best is None or w1 - w0 < best[0]:
            best = (w1 - w0, c, (w0 + w1) // 2)
    return best[1], best[2]


class Dictionary:
    """Event-key registry (reference: parsec/profiling.c dictionary with
    name + color + typed info, consumed by pbt2ptt)."""

    def __init__(self):
        self.keys: Dict[int, dict] = {
            k: {"name": n, "color": c} for k, (n, c) in _DEFAULT_KEYS.items()}

    def add(self, key: int, name: str, color: str = "#cccccc"):
        self.keys[int(key)] = {"name": name, "color": color}
        return key

    def name(self, key: int) -> str:
        return self.keys.get(int(key), {}).get("name", f"KEY{key}")

    def to_json(self):
        return {str(k): v for k, v in self.keys.items()}

    @classmethod
    def from_json(cls, d):
        """The dictionary a file's header carries, as written (so a
        trace loads with the keys it was saved with); an empty one (the
        native flight dump's) gets the default keys."""
        out = cls()
        if d:
            out.keys = {}
        for k, v in d.items():
            out.keys[int(k)] = dict(v)
        return out


class Trace:
    """An event table + dictionary for one or more ranks."""

    def __init__(self, events: np.ndarray, dictionary: Optional[Dictionary]
                 = None, rank: int = 0, meta: Optional[dict] = None,
                 class_names: Optional[List[str]] = None):
        assert events.ndim == 2 and events.shape[1] == 8, events.shape
        self.events = events.astype(np.int64, copy=False)
        self.dict = dictionary or Dictionary()
        self.rank = rank
        self.meta = meta or {}
        self.class_names = class_names or []
        # per-event rank column (merged traces carry several ranks)
        self.ranks = np.full(len(events), rank, dtype=np.int64)

    # ---------------------------------------------------------- file IO
    def save(self, path: str):
        header = json.dumps({
            "rank": self.rank, "dictionary": self.dict.to_json(),
            "meta": self.meta, "class_names": self.class_names,
        }).encode()
        with open(path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<II", _VERSION, len(header)))
            f.write(header)
            f.write(self.events.astype("<i8").tobytes())

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:8] != _MAGIC:
            raise ValueError(f"{path}: not a ptt trace (bad magic)")
        ver, hlen = struct.unpack("<II", raw[8:16])
        if ver not in _LOADABLE_VERSIONS:
            raise ValueError(f"{path}: unsupported trace version {ver}")
        hdr = json.loads(raw[16:16 + hlen])
        ev = np.frombuffer(raw[16 + hlen:], dtype="<i8").reshape(-1, 8)
        return cls(ev.copy(), Dictionary.from_json(hdr["dictionary"]),
                   hdr.get("rank", 0), hdr.get("meta"),
                   hdr.get("class_names"))

    @classmethod
    def merge(cls, traces: List["Trace"], apply_offsets: bool = True,
              causal: bool = True) -> "Trace":
        """Merge per-rank traces into one causally-consistent timeline
        (the dbp-merge analog, now with cross-rank clock resolution).

        - Dictionaries and class_names are merged with CONFLICT
          DETECTION: the same key id (or class id) mapped to two
          different names raises ValueError instead of silently taking
          traces[0]'s — dynamic keys registered on one rank no longer
          mislabel merged events; a name present on only some ranks is
          adopted.
        - `apply_offsets` shifts each trace's timestamps by its
          `meta["clock_offset_ns"]` (the PING/PONG estimate against
          rank 0 taken at comm bring-up/fence), putting every rank on
          rank 0's clock.
        - `causal` then enforces the physical invariant the estimate
          can only approximate: every matched COMM_RECV begins at or
          after its COMM_SEND.  Residual violations first move whole
          ranks (difference-constraint relaxation), then clamp the few
          stragglers event-wise; the corrections applied are recorded in
          meta ("causal_shift_ns", "clamped_recvs").
        """
        dictionary = Dictionary()
        dictionary.keys = {}
        for t in traces:
            for k, v in t.dict.keys.items():
                k = int(k)
                have = dictionary.keys.get(k)
                if have is not None and have["name"] != v["name"]:
                    raise ValueError(
                        f"dictionary conflict merging rank {t.rank}: key "
                        f"{k} is {have['name']!r} on an earlier rank but "
                        f"{v['name']!r} here — register dynamic keys "
                        "identically on every rank")
                if have is None:
                    dictionary.keys[k] = dict(v)
        class_names: List[str] = []
        for t in traces:
            for i, nm in enumerate(t.class_names or []):
                if i < len(class_names):
                    if class_names[i] != nm:
                        raise ValueError(
                            f"class_names conflict merging rank {t.rank}: "
                            f"class {i} is {class_names[i]!r} on an "
                            f"earlier rank but {nm!r} here")
                else:
                    class_names.append(nm)
        offsets = {}
        evs = []
        for t in traces:
            e = t.events.copy()
            off = int(t.meta.get("clock_offset_ns", 0)) if apply_offsets \
                else 0
            if off:
                e[:, 7] += off
            offsets[int(t.rank)] = off
            evs.append(e)
        meta = {"merged_ranks": [t.rank for t in traces],
                "clock_offsets_ns": offsets}
        if traces and traces[0].meta.get("wall_anchors"):
            # every rank is on the first trace's clock now: its anchors,
            # shifted as its events were, map the merged timeline
            off0 = offsets[int(traces[0].rank)]
            meta["wall_anchors"] = [[c + off0, w] for c, w in
                                    traces[0].meta["wall_anchors"]]
        out = cls(np.concatenate(evs) if evs else
                  np.empty((0, 8), dtype=np.int64),
                  dictionary, traces[0].rank if traces else 0, meta,
                  class_names)
        out.ranks = np.concatenate([t.ranks for t in traces]) if traces \
            else out.ranks
        if causal:
            out._enforce_causality()
        return out

    def _enforce_causality(self, max_passes: int = 16):
        """Post-offset fix-up: recv-before-send across ranks is a clock
        artifact, never physics.  Pass 1..n relax whole-rank shifts (the
        difference-constraint system recv >= send per rank pair); an
        infeasible system — offset error larger than true wire latency,
        common on loopback where both are microseconds — falls back to
        clamping the violated recv instants to their send time."""
        shifts: Dict[int, int] = {}
        for _ in range(max_passes):
            fl = self._match_flows()
            viol = fl["send_ns"] - fl["recv_ns"]
            bad = viol > 0
            if not bad.any():
                break
            worst_dst = {}
            for dst in np.unique(fl["dst"][bad]):
                worst_dst[int(dst)] = int(
                    viol[bad & (fl["dst"] == dst)].max())
            # relax: shift each violated receiver's whole rank forward
            for dst, d in worst_dst.items():
                self.events[self.ranks == dst, 7] += d
                shifts[dst] = shifts.get(dst, 0) + d
        clamped = 0
        fl = self._match_flows()
        viol = fl["send_ns"] - fl["recv_ns"]
        bad = np.flatnonzero(viol > 0)
        for i in bad:
            ri = int(fl["recv_idx"][i])
            t_send = int(fl["send_ns"][i])
            self.events[ri, 7] = t_send
            # the paired instant END row rides directly after the begin
            if (ri + 1 < len(self.events)
                    and self.events[ri + 1, 0] == KEY_COMM_RECV
                    and self.events[ri + 1, 1] == 1
                    and self.events[ri + 1, 4] == self.events[ri, 4]):
                self.events[ri + 1, 7] = max(
                    int(self.events[ri + 1, 7]), t_send)
            clamped += 1
        if shifts:
            self.meta["causal_shift_ns"] = shifts
        self.meta["clamped_recvs"] = clamped

    # ------------------------------------------------------ wall clock
    def to_wall(self) -> "Trace":
        """A copy whose timestamps are on the wall clock (time.time_ns,
        the base torch.profiler's CUDA events carry), mapped linearly
        through meta["wall_anchors"]: the (trace clock, wall clock) pairs
        take_trace stamps when profiling was enabled and when the buffers
        were drained.  The line through the first and last anchor
        corrects the trace clock's drift against the wall clock between
        them (one anchor: an offset alone); the anchors map exactly.
        Trace.merge's cross-rank offsets, already in the timestamps,
        stay as they are.  Raises ValueError without anchors."""
        anchors = self.meta.get("wall_anchors")
        if not anchors:
            raise ValueError("the trace has no wall_anchors in its meta "
                             "(take_trace stamps them)")
        (c0, w0), (c1, w1) = anchors[0], anchors[-1]
        rate = (w1 - w0) / (c1 - c0) if c1 != c0 else 1.0
        ev = self.events.copy()
        ev[:, 7] = w0 + np.rint((ev[:, 7] - c0) * rate).astype(np.int64)
        out = Trace(ev, self.dict, self.rank, dict(self.meta, wall=True),
                    self.class_names)
        out.ranks = self.ranks.copy()
        return out

    def wall_drift_ns(self) -> int:
        """How far the trace clock drifted from the wall clock between
        the first and the last anchor (wall minus trace clock, ns; 0 with
        fewer than two anchors)."""
        anchors = self.meta.get("wall_anchors") or []
        if len(anchors) < 2:
            return 0
        (c0, w0), (c1, w1) = anchors[0], anchors[-1]
        return int((w1 - w0) - (c1 - c0))

    # ----------------------------------------------------- trace tables
    def _spans_table(self) -> np.ndarray:
        """Vectorized begin/end pairing: an (n, 10) int64 table with
        columns (rank, worker, key, class_id, l0, l1, aux, begin_ns,
        end_ns, end_event_index), ordered like the historical per-event
        loop (by end-event position).  Pairing is per (rank, worker,
        key, class, l0, l1); the numpy fast path pairs each end with its
        immediate predecessor inside the group (the alternating-span
        common case — one pass, no Python loop); groups where that rule
        fails (nested same-signature spans) re-pair with the LIFO stack
        the old implementation used."""
        ev = self.events
        empty = np.empty((0, 10), dtype=np.int64)
        if not len(ev):
            return empty
        keep = ev[:, 0] != KEY_EDGE
        idx = np.flatnonzero(keep)
        if not len(idx):
            return empty
        e = ev[idx]
        rk = self.ranks[idx]
        sig = np.stack([rk, e[:, 5], e[:, 0], e[:, 2], e[:, 3], e[:, 4]],
                       axis=1)
        _, ginv = np.unique(sig, axis=0, return_inverse=True)
        ginv = ginv.reshape(-1)
        order = np.lexsort((np.arange(len(e)), ginv))
        g = ginv[order]
        ph = e[order, 1]
        ends = np.flatnonzero(ph == 1)
        ok = np.zeros(len(ends), dtype=bool)
        valid = ends > 0
        pv = ends[valid] - 1
        ok[valid] = (g[pv] == g[ends[valid]]) & (ph[pv] == 0)
        bad_groups = np.unique(g[ends[~ok]])
        pairs_b: List[np.ndarray] = []
        pairs_e: List[np.ndarray] = []
        good = ok.copy()
        if len(bad_groups):
            good &= ~np.isin(g[ends], bad_groups)
        ge = ends[good]
        pairs_b.append(order[ge - 1])
        pairs_e.append(order[ge])
        if len(bad_groups):
            # stack fallback, only for the (rare) nested groups
            fb_b, fb_e = [], []
            stacks: Dict[int, list] = {}
            for p in np.flatnonzero(np.isin(g, bad_groups)):
                i_e = order[p]
                if ph[p] == 0:
                    stacks.setdefault(int(g[p]), []).append(i_e)
                else:
                    st = stacks.get(int(g[p]))
                    if st:
                        fb_b.append(st.pop())
                        fb_e.append(i_e)
            pairs_b.append(np.asarray(fb_b, dtype=np.int64))
            pairs_e.append(np.asarray(fb_e, dtype=np.int64))
        bi = np.concatenate(pairs_b) if pairs_b else np.empty(0, np.int64)
        ei = np.concatenate(pairs_e) if pairs_e else np.empty(0, np.int64)
        if not len(ei):
            return empty
        eb, ee = e[bi], e[ei]
        table = np.column_stack([
            rk[ei], ee[:, 5], ee[:, 0], ee[:, 2], ee[:, 3], ee[:, 4],
            np.maximum(eb[:, 6], ee[:, 6]), eb[:, 7], ee[:, 7], idx[ei]])
        return table[np.argsort(table[:, 9], kind="stable")]

    def spans(self):
        """Pair begin/end events into spans — the single pairing rule
        shared by to_pandas and to_perfetto.  Yields tuples
        (rank, worker, key, class_id, l0, l1, aux, begin_ns, end_ns);
        EDGE events are excluded (use edges()/to_dot).  Pairing is per
        (rank, worker, key, class, l0, l1) with a begin stack; aux is the
        max of the begin/end words.  (Generator API preserved; the
        pairing itself is vectorized — see _spans_table.)"""
        for row in self._spans_table():
            yield tuple(int(x) for x in row[:9])

    def to_pandas(self):
        """Paired begin/end events -> one row per span (the reference's
        pbt2ptt "trace tables": tools/profiling/python/pbt2ptt.pyx).

        Returns a DataFrame with columns: rank, worker, key, name, class_id,
        class_name, l0, l1, aux, begin_ns, end_ns, dur_ns."""
        import pandas as pd
        t = self._spans_table()
        df = pd.DataFrame({
            "rank": t[:, 0], "worker": t[:, 1], "key": t[:, 2],
            "name": [self.dict.name(int(k)) for k in t[:, 2]],
            "class_id": t[:, 3],
            "class_name": [self._cname(int(c)) for c in t[:, 3]],
            "l0": t[:, 4], "l1": t[:, 5], "aux": t[:, 6],
            "begin_ns": t[:, 7], "end_ns": t[:, 8],
            "dur_ns": t[:, 8] - t[:, 7],
        })
        return df

    def _cname(self, cid: int) -> str:
        if 0 <= cid < len(self.class_names):
            return self.class_names[cid]
        return f"class{cid}"

    def edges(self):
        """EDGE pairs -> list of ((src_cid, l0, l1), (dst_cid, l0, l1))."""
        ev = self.events
        out = []
        i = 0
        n = len(ev)
        while i < n:
            if ev[i][0] == KEY_EDGE and ev[i][1] == 0 and i + 1 < n \
                    and ev[i + 1][0] == KEY_EDGE and ev[i + 1][1] == 1:
                s, d = ev[i], ev[i + 1]
                out.append(((int(s[2]), int(s[3]), int(s[4])),
                            (int(d[2]), int(d[3]), int(d[4]))))
                i += 2
            else:
                i += 1
        return out

    # ------------------------------------------------ flow correlation
    def _match_flows(self) -> Dict[str, np.ndarray]:
        """Pair COMM_SEND with COMM_RECV across ranks by the flow key
        (src_rank, correlation cookie) — the wire-v5 (l0, l1) stamps.
        Returns parallel arrays: src, dst, corr, bytes, send_ns,
        recv_ns, send_idx, recv_idx (begin-row indices into events)."""
        ev, rk = self.events, self.ranks
        nothing = {k: np.empty(0, dtype=np.int64) for k in
                   ("src", "dst", "corr", "bytes", "send_ns", "recv_ns",
                    "send_idx", "recv_idx")}
        si = np.flatnonzero((ev[:, 0] == KEY_COMM_SEND) & (ev[:, 1] == 0)
                            & (ev[:, 4] > 0))
        ri = np.flatnonzero((ev[:, 0] == KEY_COMM_RECV) & (ev[:, 1] == 0)
                            & (ev[:, 4] > 0) & (ev[:, 3] >= 0))
        if not len(si) or not len(ri):
            return nothing
        # flow key: src rank in the high bits, per-sender cookie low
        skey = (rk[si] << 44) | ev[si, 4]
        rkey = (ev[ri, 3] << 44) | ev[ri, 4]
        so = np.argsort(skey, kind="stable")
        skey_s = skey[so]
        pos = np.searchsorted(skey_s, rkey)
        pos_c = np.minimum(pos, len(skey_s) - 1)
        hit = skey_s[pos_c] == rkey
        rsel = np.flatnonzero(hit)
        if not len(rsel):
            return nothing
        s_at = si[so[pos_c[rsel]]]
        r_at = ri[rsel]
        return {
            "src": ev[r_at, 3], "dst": rk[r_at], "corr": ev[r_at, 4],
            "bytes": ev[s_at, 6], "send_ns": ev[s_at, 7],
            "recv_ns": ev[r_at, 7], "send_idx": s_at, "recv_idx": r_at,
        }

    def flows(self) -> np.ndarray:
        """Matched cross-rank messages: an (m, 7) int64 array with
        columns (src, dst, corr, bytes, send_ns, recv_ns, latency_ns).
        Requires a merged (or at least multi-rank) trace whose COMM
        events carry wire-v5 correlation ids."""
        m = self._match_flows()
        return np.column_stack([
            m["src"], m["dst"], m["corr"], m["bytes"], m["send_ns"],
            m["recv_ns"], m["recv_ns"] - m["send_ns"],
        ]) if len(m["src"]) else np.empty((0, 7), dtype=np.int64)

    def wire_latency(self):
        """Per-message wire latency table (pandas): one row per matched
        COMM_SEND -> COMM_RECV pair, post clock sync.  The per-(src,dst)
        aggregate of `latency_ns` is the measured wire cost the
        transfer-economics harness models."""
        import pandas as pd
        f = self.flows()
        return pd.DataFrame(f, columns=[
            "src", "dst", "corr", "bytes", "send_ns", "recv_ns",
            "latency_ns"])

    # -------------------------------------------------- request scopes
    def scope_flows(self) -> Dict:
        """(src_rank, corr) -> scope_id from the SCOPE flow tags —
        the map that attributes matched wire flows to requests.  Both
        the producer and the consumer emit the tag under the same key,
        so single-rank and merged traces resolve identically."""
        ev = self.events
        out: Dict = {}
        for i in np.flatnonzero((ev[:, 0] == KEY_SCOPE)
                                & (ev[:, 1] == 0)):
            out[(int(ev[i, 3]), int(ev[i, 4]))] = int(ev[i, 6])
        return out

    def scope_ids(self) -> List[int]:
        """Distinct request-scope ids present in this trace (EXEC aux
        stamps + SCOPE flow tags), sorted."""
        ev = self.events
        ids = set()
        ex = (ev[:, 0] == KEY_EXEC) & (ev[:, 1] == 0) & (ev[:, 6] > 0)
        ids.update(int(v) for v in np.unique(ev[ex, 6]))
        ids.update(self.scope_flows().values())
        ids.discard(0)
        return sorted(ids)

    def filter_scope(self, scope_id: int) -> "Trace":
        """The sub-trace of ONE request: EXEC/RELEASE spans whose aux
        carries `scope_id`, H2D/STREAM staging spans the device layer
        stamped with it (class slot), the COMM/COLL instants of its
        wire flows, its SCOPE tags, and the EDGE pairs between its own
        EXEC nodes.  Everything else — other tenants' pools, unscoped
        work — is dropped, so per-request critical_path()/lost_time()
        cannot conflate same-numbered classes across pools (class ids
        are per-pool)."""
        ev, rk = self.events, self.ranks
        sid = int(scope_id)
        keep = np.zeros(len(ev), dtype=bool)
        keep |= ((ev[:, 0] == KEY_EXEC) | (ev[:, 0] == KEY_RELEASE)) & \
            (ev[:, 6] == sid)
        keep |= ((ev[:, 0] == KEY_H2D) | (ev[:, 0] == KEY_STREAM)) & \
            (ev[:, 2] == sid)
        keep |= (ev[:, 0] == KEY_SCOPE) & (ev[:, 6] == sid)
        # wire flows of this scope: (src, corr) keys from the SCOPE tags
        fkeys = {k for k, v in self.scope_flows().items() if v == sid}
        if fkeys:
            send = ev[:, 0] == KEY_COMM_SEND
            recvish = (ev[:, 0] == KEY_COMM_RECV) | (ev[:, 0] == KEY_COLL)
            for i in np.flatnonzero(send):
                if (int(rk[i]), int(ev[i, 4])) in fkeys:
                    keep[i] = True
            for i in np.flatnonzero(recvish):
                if (int(ev[i, 3]), int(ev[i, 4])) in fkeys:
                    keep[i] = True
        # EDGE pairs whose src or dst is one of this scope's EXEC nodes
        nodes = {(int(e[2]), int(e[3]), int(e[4]))
                 for e in ev[(ev[:, 0] == KEY_EXEC) & (ev[:, 6] == sid)]}
        ei = np.flatnonzero((ev[:, 0] == KEY_EDGE) & (ev[:, 1] == 0))
        for i in ei:
            if i + 1 >= len(ev) or ev[i + 1, 0] != KEY_EDGE or \
                    ev[i + 1, 1] != 1:
                continue
            s = (int(ev[i, 2]), int(ev[i, 3]), int(ev[i, 4]))
            d = (int(ev[i + 1, 2]), int(ev[i + 1, 3]), int(ev[i + 1, 4]))
            if s in nodes or d in nodes:
                keep[i] = keep[i + 1] = True
        out = Trace(ev[keep].copy(), self.dict, self.rank,
                    dict(self.meta, scope=sid), self.class_names)
        out.ranks = rk[keep].copy()
        return out

    # -------------------------------------------------------- analysis
    def critical_path(self, **kw):
        """Executed-DAG critical path (see profiling.critpath): walks
        EDGE pairs weighted by EXEC span durations and returns the
        longest chain with per-class attribution."""
        from .critpath import critical_path
        return critical_path(self, **kw)

    def lost_time(self, **kw):
        """Per-(rank, worker) lost-time breakdown (compute / release /
        h2d stall / comm wait / idle) — see profiling.critpath."""
        from .critpath import lost_time
        return lost_time(self, **kw)

    def to_perfetto(self, path: Optional[str] = None,
                    device_ops: Optional[List[DeviceOp]] = None):
        """Standard-tool sink: Chrome/Perfetto trace-event JSON (the
        reference ships an OTF2 writer, parsec/profiling_otf2.c, for
        Vampir/Score-P interop; Perfetto's trace-event format is the
        TPU-era equivalent — ui.perfetto.dev opens it directly).

        Spans become "X" complete events with pid=rank / tid=worker;
        COMM instant spans (begin==end) become "i" instant events, and
        matched send/recv pairs additionally emit "s"/"f" FLOW events so
        the UI draws arrows between ranks.  `device_ops`, (name, start_ns,
        end_ns) on the trace's clock (the wall clock: map the trace with
        to_wall() first), become one more track of the rank, "device"
        (tid -2), beside the host spans.  Returns the JSON object;
        writes it to `path` when given."""
        out = []
        if device_ops:
            out.append({"ph": "M", "name": "thread_name", "pid": self.rank,
                        "tid": -2, "args": {"name": "device"}})
            for name, t0, t1 in device_ops:
                out.append({"name": name, "cat": "device", "ph": "X",
                            "pid": self.rank, "tid": -2, "ts": t0 / 1e3,
                            "dur": (t1 - t0) / 1e3})
        for (rank, worker, key, cid, l0, l1, aux, t0, t1) in self.spans():
            name = (self._cname(cid) if key == KEY_EXEC and cid >= 0
                    else self.dict.name(key))
            rec = {
                "name": name,
                "cat": self.dict.name(key),
                "pid": rank,
                "tid": worker,
                "ts": t0 / 1e3,          # perfetto wants microseconds
                "args": {"l0": l0, "l1": l1, "bytes": aux},
            }
            if t1 == t0:
                rec["ph"] = "i"
                rec["s"] = "t"  # thread-scoped instant
            else:
                rec["ph"] = "X"
                rec["dur"] = (t1 - t0) / 1e3
            out.append(rec)
        for row in self.flows():
            src, dst, corr, nbytes, t_s, t_r, _lat = (int(x) for x in row)
            fid = f"{src}:{corr}"
            out.append({"ph": "s", "id": fid, "name": "msg", "cat": "comm",
                        "pid": src, "tid": -1, "ts": t_s / 1e3})
            out.append({"ph": "f", "bp": "e", "id": fid, "name": "msg",
                        "cat": "comm", "pid": dst, "tid": -1,
                        "ts": t_r / 1e3})
        doc = {"traceEvents": out, "displayTimeUnit": "ns"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc

    def counts(self) -> Dict[str, int]:
        """Event counts per key name — the cheap oracle used by trace
        assertions (reference: tests/profiling/check-comms.py)."""
        out: Dict[str, int] = {}
        for k in np.unique(self.events[:, 0]):
            out[self.dict.name(int(k))] = int(
                np.sum((self.events[:, 0] == k) & (self.events[:, 1] == 0)))
        return out


def take_trace(ctx, rank: Optional[int] = None,
               class_names: Optional[List[str]] = None,
               meta: Optional[dict] = None) -> Trace:
    """Drain a Context's native profiling buffers into a Trace.  The
    header meta is stamped with the rank's clock-sync estimate
    (Context.comm_clock, once measured: a later Trace.merge aligns the
    ranks with it), the flight recorder's drop count and ring size, the
    wall clock's anchors (`wall_anchors`, see Trace.to_wall) and the
    request-scope legend when a ScopeRegistry is attached.  `rank`
    defaults to the context's rank."""
    m = dict(meta or {})
    if rank is None:
        rank = getattr(ctx, "myrank", 0)
    ck = ctx.comm_clock()
    if ck["measured"]:
        m.setdefault("clock_offset_ns", ck["offset_ns"])
        m.setdefault("clock_err_ns", ck["err_ns"])
    m.setdefault("dropped_events", ctx.profile_dropped())
    m.setdefault("ring_bytes", ctx.profile_ring())
    # the wall clock's anchors: profiling's enable (or the last drain)
    # and this drain; the drain's anchors the next trace
    taken = clock_anchor()
    first = getattr(ctx, "_wall_anchor", None)
    m.setdefault("wall_anchors", [list(a) for a in (first, taken)
                                  if a is not None])
    ctx._wall_anchor = taken
    # request-scope legend (header stays v2: meta is free-form JSON) —
    # a trace names the requests its spans belong to
    reg = getattr(ctx, "_scope_registry", None)
    if reg is not None:
        legend = reg.scope_legend()
        if legend:
            m.setdefault("scopes", legend)
    return Trace(ctx.profile_take(), rank=rank, class_names=class_names,
                 meta=m)


def _node_id(cid, l0, l1, cname):
    return f"{cname(cid)}_{l0}_{l1}"


def to_dot(trace: Trace, name: str = "dag") -> str:
    """Executed-DAG capture as DOT (reference:
    parsec/parsec_prof_grapher.c:86-135, the --parsec dot flag)."""
    lines = [f"digraph {name} {{"]
    seen = set()
    for (sc, sl0, sl1), (dc, dl0, dl1) in trace.edges():
        a = _node_id(sc, sl0, sl1, trace._cname)
        b = _node_id(dc, dl0, dl1, trace._cname)
        for nd in (a, b):
            if nd not in seen:
                seen.add(nd)
                lines.append(f'  "{nd}";')
        lines.append(f'  "{a}" -> "{b}";')
    lines.append("}")
    return "\n".join(lines)
