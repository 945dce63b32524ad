"""Trace(s) -> trace tables on disk (reference: the Cython pbt2ptt
converter + profile2h5.py, tools/profiling/python/).

Usage: python -m parsec_tpu_torch.tools.ptt2tables out.h5 rank0.ptt \
           rank1.ptt ...
Merges per-rank traces and writes one table of spans (the columns of
Trace.to_pandas); falls back to CSV when no HDF5 backend is available in
the environment.

Port of tools/ptt2tables.py.  A .csv target is written with the csv
module, byte for byte what pandas' to_csv writes, so the tool runs
where pandas is not installed; HDF5 needs pandas and its tables backend.
"""
import argparse
import csv
import sys

from parsec_tpu_torch.profiling import Trace

COLUMNS = ("rank", "worker", "key", "name", "class_id", "class_name", "l0",
           "l1", "aux", "begin_ns", "end_ns", "dur_ns")


def write_csv(trace: Trace, path: str) -> int:
    """One row per span under COLUMNS; returns the number of rows."""
    n = 0
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(COLUMNS)
        for rank, worker, key, cid, l0, l1, aux, t0, t1 in trace.spans():
            w.writerow((rank, worker, key, trace.dict.name(key), cid,
                        trace._cname(cid), l0, l1, aux, t0, t1, t1 - t0))
            n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out")
    ap.add_argument("traces", nargs="+")
    args = ap.parse_args(argv)
    traces = [Trace.load(p) for p in args.traces]
    merged = Trace.merge(traces) if len(traces) > 1 else traces[0]
    if args.out.endswith(".csv"):
        rows = write_csv(merged, args.out)
    else:
        try:
            df = merged.to_pandas()
            df.to_hdf(args.out, key="events", mode="w")
            rows = len(df)
        except ImportError:
            out = args.out.rsplit(".", 1)[0] + ".csv"
            print(f"no HDF5 backend; writing {out}", file=sys.stderr)
            rows = write_csv(merged, out)
    print(f"{rows} spans from {len(traces)} rank(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
