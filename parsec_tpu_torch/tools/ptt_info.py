"""Trace inspector (reference: tools/profiling/dbpinfos.c).

Usage: python -m parsec_tpu_torch.tools.ptt_info trace.ptt [more.ptt ...]
Prints per-file dictionary, event counts, span statistics per task class.
Reads the #PTCPROF files either package writes.

Port of tools/ptt_info.py.  The per-class statistics (count, median,
sum of span durations, classes in sorted order) are computed with numpy
over the paired spans, so the tool needs no pandas.
"""
import argparse
import sys

import numpy as np

from parsec_tpu_torch.profiling import Trace


def class_stats(t: Trace) -> dict:
    """{class name: (count, median ns, total ns)} over the trace's spans."""
    durs = {}
    for row in t.spans():
        durs.setdefault(t._cname(row[3]), []).append(row[8] - row[7])
    return {c: (len(d), float(np.median(d)), int(np.sum(d)))
            for c, d in sorted(durs.items())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("traces", nargs="+")
    args = ap.parse_args(argv)
    for path in args.traces:
        t = Trace.load(path)
        print(f"== {path} (rank {t.rank}, {len(t.events)} events)")
        for k, v in sorted(t.dict.keys.items()):
            print(f"   key {k}: {v['name']} {v['color']}")
        for name, cnt in sorted(t.counts().items()):
            print(f"   {name}: {cnt}")
        for cname, (n, med, total) in class_stats(t).items():
            print(f"   {cname}: n={n} p50={med / 1e3:.2f}us "
                  f"total={total / 1e6:.3f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
