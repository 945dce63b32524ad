"""The tuner's comm axes in the port (analysis/tune.py) against the JAX
package's: the closed-form collective and streaming price models and
their proposers at the same inputs, and the split of the knob registry
into the axes the tuner acts on and the constants it prices (the rails:
comm.rails and its per-class overrides, constants of
comm/topology.COMM_KNOBS in the port).  Both packages price with the
same transfer economics, each loaded from the repo's BENCH_comm.json.
"""
import os

import numpy as np
import pytest

import parsec_tpu as jpt
import parsec_tpu.analysis.tune as jtune
import parsec_tpu.comm.economics as jecon
import parsec_tpu.comm.topology as jtopo
import parsec_tpu_torch as tpt
import parsec_tpu_torch.analysis.tune as ttune
import parsec_tpu_torch.comm.economics as tecon
import parsec_tpu_torch.comm.topology as ttopo
from parsec_tpu.algos.gemm import build_gemm_dist as jgemm
from parsec_tpu.data.collections import TwoDimBlockCyclic as JBC
from parsec_tpu_torch.algos.gemm import build_gemm_dist as tgemm
from parsec_tpu_torch.data.collections import TwoDimBlockCyclic as TBC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_COMM = os.path.join(REPO, "BENCH_comm.json")
ECON = {"ref": jecon.TransferEconomics.load(BENCH_COMM),
        "port": tecon.TransferEconomics.load(BENCH_COMM)}
RAILS = ("comm.rails", "comm.rails.ici", "comm.rails.dcn")


@pytest.mark.parametrize("size", [4096, 2 << 20, 64 << 20])
@pytest.mark.parametrize("nranks", [2, 4])
def test_price_and_propose_collective_match_reference(size, nranks):
    for topo in ("auto", "ring", "binomial", "star"):
        for slices in (1, 4, 16):
            for eager in (None, 0, 1 << 20):
                kv = {"coll.topo": topo, "coll.max_slices": slices}
                if eager is not None:
                    kv["comm.eager_limit"] = eager
                assert ttune.price_collective(
                    kv, size, nranks, ECON["port"]) == \
                    jtune.price_collective(kv, size, nranks, ECON["ref"])
    got = ttune.propose_collective(size, nranks, ECON["port"], topk=4)
    assert got == jtune.propose_collective(size, nranks, ECON["ref"],
                                           topk=4)
    assert got == ttune.propose_collective(size, nranks, ECON["port"],
                                           topk=4)


@pytest.mark.parametrize("size", [256 << 10, 4 << 20, 64 << 20])
@pytest.mark.parametrize("hops", [1, 8])
def test_price_and_propose_stream_match_reference(size, hops):
    for chunk in (0, 64 << 10, 1 << 20, 8 << 20):
        for rails in (1, 2, 4):
            kv = {"comm.chunk_size": chunk, "comm.rails": rails}
            assert ttune.price_stream(kv, size, hops, ECON["port"]) == \
                jtune.price_stream(kv, size, hops, ECON["ref"])
    got = ttune.propose_stream(size, hops, ECON["port"])
    assert got == jtune.propose_stream(size, hops, ECON["ref"])
    # behavioral dedupe: no two proposals run identically (the default
    # vector is always kept, whatever it duplicates)
    default = {"comm.chunk_size": ttopo.comm_knob("comm.chunk_size"),
               "comm.rails": ttopo.comm_knob("comm.rails")}
    keys = set()
    for r in got:
        if r["knobs"] == default:
            continue
        chunk = r["knobs"]["comm.chunk_size"]
        nch = (size + chunk - 1) // chunk if chunk and size > chunk else 1
        k = (chunk, r["knobs"]["comm.rails"] if nch > 1 else 0)
        assert k not in keys
        keys.add(k)


def test_price_models_read_the_registry_like_reference(monkeypatch):
    """The defaults the proposers carry (and the eager threshold a vector
    without one is priced at) come from the knobs in force."""
    monkeypatch.setenv("PTC_MCA_comm_eager_limit", "4096")
    monkeypatch.setenv("PTC_MCA_coll_topo", "ring")
    kv = {"coll.topo": "auto", "coll.max_slices": 4}
    assert ttune.price_collective(kv, 1 << 20, 2, ECON["port"]) == \
        jtune.price_collective(kv, 1 << 20, 2, ECON["ref"])
    got = ttune.propose_collective(1 << 20, 2, ECON["port"])
    assert got == jtune.propose_collective(1 << 20, 2, ECON["ref"])
    assert any(r["knobs"] == {"coll.topo": "ring", "coll.max_slices": 16,
                              "comm.eager_limit": 4096} for r in got)


def test_fixed_knobs_are_the_rails_and_the_rest_is_acted():
    """The split: the tuner acts on every knob of the reference's registry
    but the rails, which are constants here."""
    assert ttune.TUNE_KNOBS == jtune.TUNE_KNOBS
    assert ttune.FIXED_KNOBS == RAILS
    assert set(ttune.ACTED_KNOBS) | set(ttune.FIXED_KNOBS) == \
        set(jtune.TUNE_KNOBS)
    assert not set(ttune.ACTED_KNOBS) & set(ttune.FIXED_KNOBS)
    assert set(ttune.FIXED_KNOBS) <= set(ttopo.COMM_KNOBS)
    for k in ttune.ACTED_KNOBS:
        assert tpt.utils.params.get(k) == jpt.utils.params.get(k), k


def _dist_gemm_plan(pkg, BC, build, nodes=2):
    with pkg.Context(nb_workers=1) as ctx:
        kw = dict(dtype=np.float32, nodes=nodes, P=nodes, Q=1, myrank=0)
        A, B, C = (BC(m, n, 16, 16, **kw) for m, n in ((128, 32), (32, 128), (128, 128)))
        for name, M in (("A", A), ("B", B), ("C", C)):
            M.register(ctx, name)
        return build(ctx, A, B, C).plan()


@pytest.mark.parametrize("spec", [None, "0;1"])
def test_knob_axes_open_the_comm_axes_like_reference(spec):
    """A two-rank GEMM's plan: the wire axes open on both packages (and
    the dcn overrides on a two-island mesh); the port's axes are the
    reference's but the rails, which stay at their constant; every
    proposal the port ranks prices to the same nanosecond on the
    reference's simulator."""
    jplan = _dist_gemm_plan(jpt, JBC, jgemm)
    tplan = _dist_gemm_plan(tpt, TBC, tgemm)
    jsim = jtune.ScheduleSimulator(
        jplan, workers=2, econ=ECON["ref"],
        tmodel=jtopo.TopologyModel.parse(spec) if spec else None)
    tsim = ttune.ScheduleSimulator(
        tplan, workers=2, econ=ECON["port"],
        tmodel=ttopo.TopologyModel.parse(spec) if spec else None)
    ja, ta = jsim.knob_axes(), tsim.knob_axes()
    assert set(ja) == set(ta)
    for k in ja:
        if k in RAILS:
            assert ta[k] == [ttopo.comm_knob(k)], (k, ta[k])
        else:
            assert ta[k] == ja[k], (k, ja[k], ta[k])
    opened = {k for k, v in ta.items() if len(v) > 1}
    assert {"comm.chunk_size", "comm.eager_limit"} <= opened
    assert opened <= set(ttune.ACTED_KNOBS)
    if spec:
        assert "comm.chunk_size.dcn" in opened
    ranked = tsim.propose(topk=3)
    if spec is not None:
        # the reference's ranking compares "" with ints on this mesh's
        # dcn axes and raises; the port sorts each value within its type
        with pytest.raises(TypeError):
            jsim.propose(topk=3)
    dflt = ttune.default_knobs()
    for r in ranked:
        assert jsim.simulate(r["knobs"])["makespan_ns"] == \
            r["predicted_ns"]
        assert all(r["knobs"][k] == dflt[k] for k in RAILS)


def test_apply_knobs_acts_on_the_comm_axes():
    """A comm or collective knob of a vector is applied for the block
    (registry and PTC_MCA_* environment, the spelling the engine reads
    at comm_init) and restored after; knobs_in_force reads it back on a
    Context created inside the block, and check_tuned holds a vector to
    it; a rails change is refused."""
    vec = {"comm.chunk_size": 256 << 10, "coll.max_slices": 4,
           "comm.eager_limit.dcn": "8192"}
    before = {k: ttune.default_knobs()[k] for k in vec}
    with ttune.apply_knobs(vec) as applied:
        assert applied == {"comm.chunk_size": 256 << 10,
                           "coll.max_slices": 4,
                           "comm.eager_limit.dcn": "8192"}
        assert os.environ["PTC_MCA_comm_chunk_size"] == str(256 << 10)
        ctx = tpt.Context(nb_workers=1)
        force = ttune.knobs_in_force(ctx)
        assert force["comm.chunk_size"] == [256 << 10]
        assert force["coll.max_slices"] == [4]
        ttune.check_tuned(ctx, vec)
        ctx.destroy()
    assert {k: ttune.default_knobs()[k] for k in vec} == before
    with tpt.Context(nb_workers=1) as ctx:
        with pytest.raises(ValueError, match="not in force"):
            ttune.check_tuned(ctx, vec)
    with pytest.raises(ValueError, match="does not act"):
        with ttune.apply_knobs({"comm.rails": 4}):
            pass
