"""Link-class topology model (ptc-topo).

Real pods are not a flat mesh: ranks share a host (loopback-fast), hosts
share an ICI island (fast dedicated links), islands talk over DCN (slow,
oversubscribed — Large Scale Distributed Linear Algebra With TPUs,
arXiv:2112.09017, and the PaRSEC remote-dep hierarchy lineage).  This
module is the ONE place that knows which of the four link classes

    loopback   src == dst (the in-process shortcut; never hits the wire)
    host       same host, different rank (kernel loopback TCP)
    ici        same island, different host (the fast interconnect)
    dcn        different islands (the slow inter-island network)

a (src, dst) pair belongs to.  Everyone who prices or moves bytes —
the transfer-economics selector, the collective tree builder, the
ptc-plan traffic split, the ScheduleSimulator, the router's placement
cost, page migration — asks this model instead of assuming flatness.

Spec sources, in priority order:

  1. An explicit hosts-and-islands string (`TopologyModel.parse`;
     ';' separates islands, '|' separates hosts, ',' separates ranks:
     "0,1|2,3;4,5|6,7" = two islands of two 2-rank hosts each), or a
     path to a JSON file {"islands": [[[0,1],[2,3]], [[4,5],[6,7]]]}.
     The reference reads it from PTC_MCA_comm_topology; here that
     parameter is a COMM_KNOBS constant (flat), which the tuner does
     not search.
  2. RTT auto-detect (`TopologyModel.from_rtts`): cluster this rank's
     measured PING/PONG round trips at the largest relative gap into a
     near set (my island) and a far set.  Per-rank and therefore NOT
     SPMD-consistent across ranks — good enough for class-aware pricing
     and the per-class stats split, but hierarchical collective trees
     (which every rank must build identically) require an explicit spec.
  3. `TopologyModel.flat(nranks)` — one island, one host per rank: every
     non-self pair is "ici", all per-class knobs inherit their base, and
     behavior is bit-identical to the pre-topo runtime.

Port of parsec_tpu/comm/topology.py.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

LINK_CLASSES = ("loopback", "host", "ici", "dcn")

# The comm knobs that are no MCA parameters here, at the reference's
# defaults: nothing in the port acts on them (the engine's rails, the
# relay's DCN penalty), but the analyses price them.  Every other comm.*
# and coll.* knob, the topology spec (comm.topology) included, is
# registered (utils/config.py) and read only there; `comm_knob` answers
# for both.  A per-class override ("" = inherit the base knob) exists
# for the ici and dcn classes only.
COMM_KNOBS: Dict[str, object] = {
    "comm.rails": 2,
    "comm.rails.ici": "",
    "comm.rails.dcn": "",
    "comm.dcn_nonleader_penalty": 4.0,
}


def comm_knob(name: str):
    """A comm knob's value in force: the MCA registry's for a registered
    knob, else its COMM_KNOBS constant (KeyError when it is neither)."""
    from ..utils import params as _mca
    try:
        return _mca.get(name)
    except KeyError:
        return COMM_KNOBS[name]


class TopologyModel:
    """Islands -> hosts -> ranks, plus the class_of / leader queries.

    `islands` is a list of islands; each island a list of hosts; each
    host a list of global ranks.  Ranks must form a dense [0, nranks)
    set with no duplicates.  Island LEADERS (min rank per island) are
    the designated inter-island talkers for hierarchical collectives
    and relay forwarding."""

    def __init__(self, islands: Sequence[Sequence[Sequence[int]]],
                 source: str = "spec"):
        self.islands: List[List[List[int]]] = [
            [sorted(int(r) for r in host) for host in island]
            for island in islands]
        self.source = source
        self._island_of: Dict[int, int] = {}
        self._host_of: Dict[int, Tuple[int, int]] = {}
        for i, island in enumerate(self.islands):
            for h, host in enumerate(island):
                for r in host:
                    if r in self._island_of:
                        raise ValueError(
                            f"rank {r} appears twice in topology spec")
                    self._island_of[r] = i
                    self._host_of[r] = (i, h)
        self.nranks = (max(self._island_of) + 1) if self._island_of else 0
        missing = [r for r in range(self.nranks)
                   if r not in self._island_of]
        if missing:
            raise ValueError(f"topology spec missing ranks {missing} "
                             f"(ranks must be dense 0..{self.nranks - 1})")

    # ----------------------------------------------------------- queries
    @property
    def n_islands(self) -> int:
        return len(self.islands)

    def island_of(self, rank: int) -> int:
        return self._island_of.get(int(rank), 0)

    def island_ranks(self, island: int) -> List[int]:
        return sorted(r for h in self.islands[island] for r in h)

    def leader_of(self, island: int) -> int:
        return min(r for h in self.islands[island] for r in h)

    def leaders(self) -> List[int]:
        return [self.leader_of(i) for i in range(self.n_islands)]

    def class_of(self, src: int, dst: int) -> str:
        """The link class of the (src, dst) leg.  Unknown ranks (a
        collection larger than the spec) degrade to 'ici' — the flat
        default — rather than raising mid-placement."""
        src, dst = int(src), int(dst)
        if src == dst:
            return "loopback"
        hs, hd = self._host_of.get(src), self._host_of.get(dst)
        if hs is None or hd is None:
            return "ici"
        if hs == hd:
            return "host"
        if hs[0] == hd[0]:
            return "ici"
        return "dcn"

    def matrix(self) -> List[List[str]]:
        """The full nranks x nranks class matrix (stats / debugging)."""
        return [[self.class_of(s, d) for d in range(self.nranks)]
                for s in range(self.nranks)]

    def to_dict(self) -> dict:
        return {"islands": [[list(h) for h in isl] for isl in self.islands],
                "n_islands": self.n_islands, "nranks": self.nranks,
                "leaders": self.leaders(), "source": self.source}

    def __repr__(self) -> str:
        return (f"TopologyModel(islands={self.n_islands}, "
                f"nranks={self.nranks}, source={self.source!r})")

    # ------------------------------------------------------ constructors
    @classmethod
    def flat(cls, nranks: int) -> "TopologyModel":
        """One island, one host per rank: the pre-topo flat mesh.  Every
        non-self pair classes 'ici' so per-class knobs inherit base."""
        return cls([[[r] for r in range(max(0, int(nranks)))]],
                   source="flat")

    @classmethod
    def parse(cls, spec: str, source: Optional[str] = None
              ) -> "TopologyModel":
        """Parse the hosts-and-islands grammar, or load a JSON file when
        `spec` names one ({"islands": [[[ranks...], ...], ...]})."""
        spec = spec.strip()
        if spec.endswith(".json") or os.path.isfile(spec):
            with open(spec) as f:
                doc = json.load(f)
            return cls(doc["islands"], source=spec)
        islands: List[List[List[int]]] = []
        for island_s in spec.split(";"):
            hosts: List[List[int]] = []
            for host_s in island_s.split("|"):
                ranks = [int(tok) for tok in host_s.split(",")
                         if tok.strip()]
                if ranks:
                    hosts.append(ranks)
            if hosts:
                islands.append(hosts)
        if not islands:
            raise ValueError(f"empty topology spec {spec!r}")
        return cls(islands, source=source or "spec")

    @classmethod
    def from_rtts(cls, rtts_ns: Dict[int, int], my_rank: int,
                  nranks: int, gap_ratio: float = 2.0) -> "TopologyModel":
        """RTT-clustered auto-detect: split this rank's peers at the
        largest relative RTT gap into near (my island) and far.  When no
        gap exceeds `gap_ratio` the mesh is flat.  Per-rank view only —
        see the module docstring for why an explicit spec is required
        for SPMD collective building."""
        pairs = sorted((int(ns), int(p)) for p, ns in rtts_ns.items()
                       if int(p) != int(my_rank) and ns and int(ns) > 0)
        if len(pairs) < 2:
            return cls.flat(nranks)
        best_i, best_r = -1, gap_ratio
        for i in range(len(pairs) - 1):
            lo, hi = pairs[i][0], pairs[i + 1][0]
            r = hi / lo if lo > 0 else float("inf")
            if r >= best_r:
                best_i, best_r = i, r
        if best_i < 0:
            return cls.flat(nranks)
        near = {my_rank} | {p for _, p in pairs[:best_i + 1]}
        far = set(range(nranks)) - near
        islands = [[[r] for r in sorted(near)]]
        if far:
            islands.append([[r] for r in sorted(far)])
        # deterministic island order: by min member rank
        islands.sort(key=lambda isl: min(r for h in isl for r in h))
        return cls(islands, source="rtt-autodetect")


# ---------------------------------------------------------------- lookup
_cached: Dict[Tuple[str, int], TopologyModel] = {}


def default_topology(nranks: int,
                     rtts_ns: Optional[Dict[int, int]] = None,
                     my_rank: int = 0) -> TopologyModel:
    """The process-default TopologyModel for an `nranks` mesh: the
    explicit comm.topology spec (PTC_MCA_comm_topology), else RTT
    auto-detect when probe data is handed in, else flat.  Spec parses
    are cached per (spec, nranks)."""
    spec = str(comm_knob("comm.topology") or "").strip()
    if spec:
        key = (spec, int(nranks))
        if key not in _cached:
            _cached[key] = TopologyModel.parse(spec)
        return _cached[key]
    if rtts_ns:
        return TopologyModel.from_rtts(rtts_ns, my_rank, nranks)
    return TopologyModel.flat(nranks)


def resolve_class_knob(name: str, cls: Optional[str] = None):
    """A comm knob with its per-class override: `{name}.{cls}` (e.g.
    comm.chunk_size.dcn) wins when non-empty, else the base knob
    answers; both read through `comm_knob`.  Per-class overrides are
    strings with '' = inherit, so 0 stays a legal override value."""
    base = comm_knob(name)
    if cls not in ("ici", "dcn"):
        return base
    try:
        ov = comm_knob(f"{name}.{cls}")
    except KeyError:
        return base
    if ov is None or str(ov).strip() == "":
        return base
    if isinstance(base, bool):
        return str(ov).strip().lower() in ("1", "true", "yes", "on")
    if isinstance(base, int):
        return int(str(ov).strip())
    if isinstance(base, float):
        return float(str(ov).strip())
    return str(ov).strip()


def relay_beats_direct(nbytes: int, src: int, dst: int,
                       topo: TopologyModel, econ=None) -> bool:
    """True when forwarding an inter-island bulk pull through the island
    leaders is modeled cheaper than the direct classed link.  Non-leader
    DCN legs pay comm.dcn_nonleader_penalty on their per-byte term (host
    uplinks into the DCN are oversubscribed; the leader's is the
    provisioned one), leader-to-leader legs do not — that asymmetry is
    what makes the relay win at bulk sizes."""
    if topo.class_of(src, dst) != "dcn":
        return False
    if econ is None:
        from .economics import default_economics
        econ = default_economics()
    pen = float(comm_knob("comm.dcn_nonleader_penalty"))
    ls = topo.leader_of(topo.island_of(src))
    ld = topo.leader_of(topo.island_of(dst))
    if src == ls and dst == ld:
        return False          # already the leader-to-leader leg
    a, b = econ.alpha("rdv", cls="dcn"), econ.beta("rdv", cls="dcn")
    direct = a + nbytes * b * pen
    relay = a + nbytes * b    # leader-to-leader, unpenalized
    if src != ls:
        relay += econ.cost(nbytes, "rdv", cls=topo.class_of(src, ls))
    if dst != ld:
        relay += econ.cost(nbytes, "rdv", cls=topo.class_of(ld, dst))
    return relay < direct
