"""ptc_postmortem — cross-rank incident report from a journal directory.

Input is the artifact directory the ptc-blackbox recorder writes
(`PTC_MCA_runtime_journal=<dir>`):

  journal.<rank>.jsonl[.1]          per-rank schema-v1 JSONL journals
  crash.<rank>.ptt                  fatal-signal flight-recorder dumps
  *.watchdog.<run>.<rank>.<n>.ptt   watchdog anomaly dumps

The assembler merges every rank's records onto rank 0's clock (each
rank's checkpointed `clock.offset_ns`, same convention as Trace.merge),
then answers the three on-call questions:

  1. WHO died / misbehaved first (`dead_ranks`, `first_cause`) —
     peer-loss observations name the dead rank; its own last record is
     causally BEFORE every survivor's observation of the loss, so the
     dead rank's final activity wins first-cause even when survivor
     clocks lag.
  2. WHAT the dead rank held (`holdings`) — live scopes, inflight EXEC
     bodies, QoS census and registered inventory (e.g. frozen page
     keys), recovered from the checkpoint blob each peer replicated
     BEFORE the death (MSG_BLOB) and from crash-dump INFLIGHT events.
     The dead rank's own journal is NOT required.
  3. WHEN — a merged last-N-seconds timeline ending at the incident.

Usage:
  python -m parsec_tpu_torch.tools.ptc_postmortem <dir>              # text report
  python -m parsec_tpu_torch.tools.ptc_postmortem <dir> --json       # machine-readable
  python -m parsec_tpu_torch.tools.ptc_postmortem <dir> --window 30  # timeline seconds
  python -m parsec_tpu_torch.tools.ptc_postmortem <dir> --expect expected.json
        # assert report fields match (smoke harness; exit 1 on drift)

Exit status: 0 ok, 1 --expect mismatch, 2 no journals found.

Reads the journals and dumps either package writes.  Port of
tools/ptc_postmortem.py.
"""
import argparse
import glob
import json
import os
import re
import struct
import sys

from parsec_tpu_torch.profiling.trace import KEY_INFLIGHT, Trace

SCHEMA = "ptc-postmortem-v1"

#: inventory keys that are structural; everything else in a checkpoint
#: inventory is a registered provider (e.g. frozen page keys)
_INV_CORE = ("rank", "live_scopes", "qos_pools", "inflight", "clock")

#: journal record types that count as anomalies for first-cause ranking
_ANOMALY = ("watchdog", "peer_loss")


def load_journals(d):
    """{rank: [records sorted by seq]} from journal.<rank>.jsonl[.1]."""
    ranks = {}
    for path in sorted(glob.glob(os.path.join(d, "journal.*.jsonl*"))):
        m = re.match(r"journal\.(\d+)\.jsonl(\.1)?$", os.path.basename(path))
        if not m:
            continue
        rank = int(m.group(1))
        for line in open(path, errors="replace"):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail line of a crashed writer
            if isinstance(rec, dict) and rec.get("v") == 1:
                ranks.setdefault(rank, []).append(rec)
    for rank in ranks:
        ranks[rank].sort(key=lambda r: r.get("seq", 0))
    return ranks


def load_dumps(d):
    """{rank: [trace,...]} for crash.*.ptt + *.watchdog.*.ptt (best
    effort: unreadable dumps are skipped, never fatal)."""
    out = {}
    for path in sorted(glob.glob(os.path.join(d, "crash.*.ptt"))
                       + glob.glob(os.path.join(d, "*.watchdog.*.ptt"))):
        try:
            t = Trace.load(path)
        except (OSError, ValueError, KeyError, struct.error):
            continue  # a torn or truncated dump
        t.meta["_path"] = os.path.basename(path)
        out.setdefault(int(t.rank), []).append(t)
    return out


def clock_offsets(journals, dumps):
    """Per-rank additive offset onto rank 0's clock: the newest
    checkpointed comm_clock estimate, else the dump header's."""
    off = {}
    for rank, recs in journals.items():
        for rec in recs:
            if rec.get("type") != "checkpoint":
                continue
            ck = (rec.get("inventory") or {}).get("clock") or {}
            if ck.get("measured"):
                off[rank] = int(ck.get("offset_ns", 0))
    for rank, traces in dumps.items():
        for t in traces:
            if rank not in off and "clock_offset_ns" in t.meta:
                off[rank] = int(t.meta["clock_offset_ns"])
    return off


def _aligned(rec, offsets):
    return int(rec.get("t_ns", 0)) + offsets.get(int(rec.get("rank", 0)), 0)


def _unwrap_blob(blob):
    """peer_loss embeds the MSG_BLOB wrapper {rank, t_ns, inventory}."""
    if not isinstance(blob, dict):
        return None, None
    return blob.get("inventory"), blob.get("t_ns")


def holdings_from_inventory(inv):
    """The recovery-relevant holdings view of one checkpoint inventory."""
    inv = inv or {}
    providers = {k: v for k, v in inv.items() if k not in _INV_CORE}
    frozen = []
    for name, v in providers.items():
        if "frozen" in name and isinstance(v, (list, tuple)):
            frozen.extend(v)
    return {
        "live_scopes": inv.get("live_scopes") or [],
        "inflight": inv.get("inflight") or [],
        "qos_pools": inv.get("qos_pools") or [],
        "frozen_keys": frozen,
        "providers": providers,
    }


def assemble(d, window_s=30.0):
    journals = load_journals(d)
    if not journals:
        return None
    dumps = load_dumps(d)
    offsets = clock_offsets(journals, dumps)

    # -- dead ranks: every peer a survivor journalled a peer_loss for —
    #    UNLESS that peer's own journal ends with a clean journal_close
    #    (an orderly exit drops the connection too, and a survivor that
    #    outlives it still records the disconnect; closed = not dead)
    closed_ranks = {rank for rank, recs in journals.items()
                    if any(r.get("type") == "journal_close" for r in recs)}
    dead, losses = set(), []
    for rank, recs in journals.items():
        for rec in recs:
            if rec.get("type") == "peer_loss":
                losses.append(rec)
                if int(rec["peer"]) not in closed_ranks:
                    dead.add(int(rec["peer"]))
    # a rank that left a crash dump but no journal_close also died
    for rank, traces in dumps.items():
        for t in traces:
            if t.meta.get("crash"):
                closed = any(r.get("type") == "journal_close"
                             for r in journals.get(rank, []))
                if not closed:
                    dead.add(rank)

    # -- holdings of each dead rank: newest replicated checkpoint blob
    #    (survivor-held), overlaid with crash-dump INFLIGHT spans
    holdings = {}
    for rank in sorted(dead):
        best, best_t = None, -1
        for rec in losses:
            if int(rec["peer"]) != rank:
                continue
            inv, t_ns = _unwrap_blob(rec.get("inventory"))
            if inv is not None and int(t_ns or 0) >= best_t:
                best, best_t = inv, int(t_ns or 0)
        if best is None:  # fall back to the dead rank's own journal
            for rec in journals.get(rank, []):
                if rec.get("type") == "checkpoint":
                    best = rec.get("inventory")
        h = holdings_from_inventory(best)
        h["checkpoint_t_ns"] = best_t if best_t >= 0 else None
        for t in dumps.get(rank, []):
            if not t.meta.get("crash"):
                continue
            ev = t.events
            for row in ev[ev[:, 0] == KEY_INFLIGHT]:
                if int(row[1]) != 0:  # begin phase only
                    continue
                h.setdefault("crash_inflight", []).append(
                    {"worker": int(row[3]), "class_id": int(row[2]),
                     "scope_id": int(row[6]), "begin_ns": int(row[7])})
            h["crash_dump"] = t.meta.get("_path")
        holdings[rank] = h

    # -- undelivered wire expectations the survivors still hold
    for rec in losses:
        rdv = rec.get("rdv")
        if rdv and int(rec["peer"]) in holdings:
            holdings[int(rec["peer"])].setdefault(
                "survivor_rdv", {})[str(rec["rank"])] = rdv

    # -- first cause: the dead rank's last aligned record beats every
    #    survivor observation (causality); else earliest anomaly record
    first = None
    if dead:
        cand = []
        for rank in sorted(dead):
            last = None
            for rec in journals.get(rank, []):
                last = rec
            for rec in losses:
                if int(rec["peer"]) == rank:
                    inv, t_ns = _unwrap_blob(rec.get("inventory"))
                    if t_ns and (last is None
                                 or int(t_ns) > int(last.get("t_ns", 0))):
                        last = {"type": "checkpoint(replicated)",
                                "t_ns": int(t_ns), "rank": rank}
            cand.append((rank, last))
        rank, last = min(cand, key=lambda c: _aligned(c[1] or {}, offsets))
        first = {"rank": rank, "kind": "rank_death",
                 "t_ns": _aligned(last or {}, offsets),
                 "last_record": (last or {}).get("type")}
    else:
        anomalies = [r for recs in journals.values() for r in recs
                     if r.get("type") in _ANOMALY]
        if anomalies:
            a = min(anomalies, key=lambda r: _aligned(r, offsets))
            first = {"rank": int(a["rank"]), "kind": a["type"],
                     "t_ns": _aligned(a, offsets),
                     "last_record": a.get("reason") or a.get("type")}

    # -- merged timeline: last `window_s` before the incident end
    merged = sorted((r for recs in journals.values() for r in recs),
                    key=lambda r: _aligned(r, offsets))
    end = _aligned(merged[-1], offsets) if merged else 0
    if first:
        end = max(end, first["t_ns"])
    lo = end - int(window_s * 1e9)
    timeline = [{"t_ns": _aligned(r, offsets), "rank": int(r["rank"]),
                 "type": r["type"], "seq": r.get("seq"),
                 "detail": _detail(r)}
                for r in merged if _aligned(r, offsets) >= lo]

    return {
        "schema": SCHEMA,
        "dir": os.path.abspath(d),
        "ranks": sorted(journals),
        "dead_ranks": sorted(dead),
        "clock_offsets_ns": {str(k): v for k, v in sorted(offsets.items())},
        "first_cause": first,
        "holdings": {str(k): v for k, v in sorted(holdings.items())},
        "anomalies": [{"rank": int(r["rank"]), "type": r["type"],
                       "t_ns": _aligned(r, offsets), "detail": _detail(r)}
                      for recs in journals.values() for r in recs
                      if r.get("type") in _ANOMALY],
        "timeline": timeline,
    }


def _detail(rec):
    """One-line summary of a record for the timeline."""
    t = rec.get("type")
    if t == "peer_loss":
        return f"peer {rec.get('peer')} lost"
    if t == "watchdog":
        return str(rec.get("reason") or rec.get("kind") or "watchdog")
    if t == "serve":
        return f"{rec.get('op')} tenant={rec.get('tenant')} " \
               f"scope={rec.get('scope_id')}"
    if t == "scope_event":
        return f"{rec.get('event')} scope={rec.get('scope_id')}"
    if t == "fence":
        return f"epoch={rec.get('epoch')}" + \
               (f" error={rec['error']}" if rec.get("error") else "")
    if t == "checkpoint":
        inv = rec.get("inventory") or {}
        return f"{len(inv.get('live_scopes') or [])} live scopes, " \
               f"{len(inv.get('inflight') or [])} inflight"
    if t == "fleet":
        return f"{rec.get('healthy')}/{rec.get('replicas')} healthy"
    return ""


def render_text(rep, out=sys.stdout):
    w = out.write
    w(f"ptc postmortem — {rep['dir']}\n")
    w(f"  ranks seen : {rep['ranks']}\n")
    w(f"  dead ranks : {rep['dead_ranks'] or 'none'}\n")
    fc = rep["first_cause"]
    if fc:
        w(f"  first cause: rank {fc['rank']} ({fc['kind']}, "
          f"last={fc['last_record']}, t={fc['t_ns']} ns)\n")
    else:
        w("  first cause: no anomaly recorded\n")
    for rank, h in rep["holdings"].items():
        w(f"\n  rank {rank} holdings (from survivor-replicated "
          f"checkpoint):\n")
        for s in h["live_scopes"]:
            w(f"    scope {s.get('scope_id')} [{s.get('state')}] "
              f"tenant={s.get('tenant')} kind={s.get('kind')}\n")
        if not h["live_scopes"]:
            w("    (no live scopes)\n")
        if h["frozen_keys"]:
            w(f"    frozen keys ({len(h['frozen_keys'])}): "
              f"{', '.join(map(str, h['frozen_keys'][:8]))}"
              f"{' ...' if len(h['frozen_keys']) > 8 else ''}\n")
        for fl in h["inflight"]:
            w(f"    inflight: worker={fl[0]} class={fl[1]} "
              f"scope={fl[3] if len(fl) > 3 else '?'}\n")
        for fl in h.get("crash_inflight", []):
            w(f"    crash-dump inflight: worker={fl['worker']} "
              f"scope={fl['scope_id']}\n")
        if h.get("crash_dump"):
            w(f"    crash dump: {h['crash_dump']}\n")
    if rep["anomalies"]:
        w("\n  anomalies:\n")
        for a in rep["anomalies"]:
            w(f"    t={a['t_ns']} rank={a['rank']} {a['type']}: "
              f"{a['detail']}\n")
    w(f"\n  timeline (last {len(rep['timeline'])} records, "
      f"rank-0 clock):\n")
    for r in rep["timeline"][-40:]:
        w(f"    {r['t_ns']:>16} r{r['rank']} {r['type']:<12} "
          f"{r['detail']}\n")


def check_expected(rep, expect):
    """Compare the report against an expectation file: exact match for
    scalars/lists, subset match for dicts (recursing one level into
    holdings rows).  Returns a list of mismatch strings."""
    errs = []

    def _cmp(path, want, got):
        if isinstance(want, dict):
            if not isinstance(got, dict):
                errs.append(f"{path}: expected dict, got {type(got).__name__}")
                return
            for k, v in want.items():
                _cmp(f"{path}.{k}", v, got.get(k))
        elif want != got:
            errs.append(f"{path}: expected {want!r}, got {got!r}")

    for k, v in expect.items():
        _cmp(k, v, rep.get(k))
    return errs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir", help="journal directory")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--window", type=float, default=30.0,
                    help="timeline window in seconds (default 30)")
    ap.add_argument("--expect", help="expected.json to assert against")
    args = ap.parse_args(argv)

    rep = assemble(args.dir, window_s=args.window)
    if rep is None:
        sys.stderr.write(f"ptc_postmortem: no journals in {args.dir}\n")
        return 2
    if args.as_json:
        json.dump(rep, sys.stdout, indent=1, default=str)
        sys.stdout.write("\n")
    else:
        render_text(rep)
    if args.expect:
        expect = json.load(open(args.expect))
        errs = check_expected(rep, expect)
        if errs:
            sys.stderr.write("ptc_postmortem: expectation mismatches:\n")
            for e in errs:
                sys.stderr.write(f"  {e}\n")
            return 1
        sys.stderr.write("ptc_postmortem: expectations met\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
