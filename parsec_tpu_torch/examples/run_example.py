"""Run a tutorial JDF:

    python -m parsec_tpu_torch.examples.run_example Ex04_ChainData.jdf

A name that is not a path is looked up in the repo's examples/.  Ex08
(Reshape) registers its LOWER datatype and checks that the lower
triangles were zeroed and the upper halves untouched.

Port of examples/run_example.py.
"""
import os
import sys

import numpy as np

import parsec_tpu_torch as pt
from parsec_tpu_torch.dsl.jdf import compile_jdf

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "examples")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "Ex04_ChainData.jdf"
    if not os.path.exists(path):
        path = os.path.join(EXAMPLES, path)
    with open(path) as f:
        src = f.read()
    reshape_demo = "Reshape" in os.path.basename(path)
    with pt.Context() as ctx:
        if reshape_demo:
            # Ex08: NB+1 tiles of n x n int64; LOWER selects the lower
            # triangle (incl. diagonal) of a row-major tile
            n, nb_tiles = 4, 11
            tile_bytes = n * n * 8
            buf = np.ones(nb_tiles * n * n, dtype=np.int64)
            ctx.register_linear_collection("descA", buf,
                                           elem_size=tile_bytes)
            ctx.register_datatype_indexed(
                "LOWER", [(i * n * 8, (i + 1) * 8) for i in range(n)])
        else:
            buf = np.zeros(64, dtype=np.int64)
            buf[0] = 300
            ctx.register_linear_collection("mydata", buf, elem_size=8)
        ctx.register_arena("default", 64)
        b = compile_jdf(src, ctx, globals={"NB": 10, "N": 10},
                        dtype=np.int64,
                        arenas={"A": "default"})
        tp = b.run()
        tp.wait()
        if reshape_demo:
            tiles = buf.reshape(nb_tiles, n, n)
            low = np.tril(np.ones((n, n), dtype=bool))
            assert (tiles[:, low] == 0).all(), "lower zeroed"
            assert (tiles[:, ~low] == 1).all(), "upper untouched"
            conv, hits = ctx.reshape_stats()
            print(f"reshape futures: {conv} conversions, {hits} hits; "
                  "lower triangles zeroed, upper halves untouched")
    print("done;", tp.nb_total_tasks, "tasks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
