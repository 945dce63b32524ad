"""Ex10: correctness cross-checks — the runtime validating itself.

Three tools the reference ships as PINS modules / test infrastructure,
shown here as library calls on a user DAG:

  * ptg_to_dtd  (reference: parsec/mca/pins/ptg_to_dtd): re-execute a
                PTG spec through the DTD engine and compare the data —
                the two dataflow front-ends cross-validate.
  * hwcounters  (reference: parsec/mca/pins/papi): per-class OS counter
                deltas (cpu time, minor faults, context switches) over
                task execution spans.
  * EDGE trace  (reference: parsec/mca/pins/iterators_checker's
                subject): the delivered dependency edges, which
                tests/runtime/test_iterators_checker.py checks against a
                brute-force oracle for randomized classes.

Run:  python -m parsec_tpu_torch.examples.Ex10_CrossCheck

Port of examples/Ex10_CrossCheck.py.
"""
import sys

import numpy as np

import parsec_tpu_torch as pt
from parsec_tpu_torch.dsl.ptg_to_dtd import run_ptg_as_dtd
from parsec_tpu_torch.profiling.pins import HwCounters, enable_pins


def build(ctx, n):
    """A small 2-class DAG: P(k) stamps its tile, C(k) folds its
    neighbor in — enough structure for edges to be interesting."""
    arr = np.zeros(n, dtype=np.int64)
    ctx.register_linear_collection("A", arr, elem_size=8, nodes=1,
                                   myrank=0)
    ctx.register_arena("t", 8)
    tp = pt.Taskpool(ctx, globals={"NB": n - 1})
    k = pt.L("k")
    P = tp.task_class("P")
    P.param("k", 0, pt.G("NB"))
    P.flow("X", "RW", pt.In(pt.Mem("A", k)),
           pt.Out(pt.Ref("C", k, flow="X")), arena="t")
    P.body(lambda v: v.data("X", dtype=np.int64, shape=(1,))
           .__setitem__(0, 100 + v.local("k")))
    C = tp.task_class("C")
    C.param("k", 0, pt.G("NB"))
    C.flow("X", "RW", pt.In(pt.Ref("P", k, flow="X")),
           pt.Out(pt.Mem("A", k)), arena="t")
    C.body(lambda v: v.data("X", dtype=np.int64, shape=(1,))
           .__setitem__(0, v.data("X", dtype=np.int64, shape=(1,))[0] * 3))
    return tp, arr


def main(argv=None):
    n = 12
    # --- PTG run, instrumented with the papi-analog counters
    with pt.Context(nb_workers=2) as ctx:
        hw = HwCounters()
        enable_pins(ctx, hw)  # context destroy uninstalls the chain
        tp, arr = build(ctx, n)
        tp.run()
        tp.wait()
        # counters are complete once wait() returns (events fire
        # synchronously at execution); read them directly
        ptg = arr.copy()
    print("PTG result :", ptg[:6], "...")
    print("hwcounters :")
    for line in hw.report({0: "P", 1: "C"}).splitlines():
        print("   ", line)

    # --- the same spec through the DTD engine
    with pt.Context(nb_workers=2) as ctx:
        tp, arr = build(ctx, n)
        stats = run_ptg_as_dtd(ctx, tp, {"A": None})
        assert np.array_equal(arr, ptg), (arr, ptg)
    print(f"DTD re-run : {stats['tasks']} tasks across "
          f"{stats['classes']} classes — results identical")
    print("cross-check ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
