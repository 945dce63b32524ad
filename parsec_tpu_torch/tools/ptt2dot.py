"""Per-rank executed-DAG capture -> one merged DOT file (reference:
tools/parsec-dotmerger + parsec/parsec_prof_grapher.c).

Usage: python -m parsec_tpu_torch.tools.ptt2dot out.dot rank0.ptt \
           [rank1.ptt ...] [--classes Name0,Name1,...]
Needs traces taken at profile level 2 (EDGE events).

Reads the #PTCPROF files either package writes.  Port of
tools/ptt2dot.py.
"""
import argparse
import sys

from parsec_tpu_torch.profiling import Trace, to_dot


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out")
    ap.add_argument("traces", nargs="+")
    ap.add_argument("--classes", default=None,
                    help="comma-separated class names for node labels")
    args = ap.parse_args(argv)
    traces = [Trace.load(p) for p in args.traces]
    merged = Trace.merge(traces) if len(traces) > 1 else traces[0]
    if args.classes:
        merged.class_names = args.classes.split(",")
    dot = to_dot(merged)
    with open(args.out, "w") as f:
        f.write(dot + "\n")
    print(f"{dot.count('->')} edges -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
