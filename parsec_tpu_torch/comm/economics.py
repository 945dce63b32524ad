"""Transfer-economics model + collective topology selector.

The transfer-economics harness (tools/testbandwidth.py) sweeps the
eager / rendezvous / device transfer paths on loopback and fits, per
path,  t(size) = fixed_overhead + size * per_byte  over the per-size
minima (BENCH_comm.json).  This module is the REUSABLE side of that
harness: the least-squares fit itself (`fit_points`, imported by the
harness so the model can never diverge from its producer), a loader
over the JSON report (`TransferEconomics`), and the collective topology
selector that consumes the fitted (alpha, beta) legs — the classic
LogP-style choice (reference: PaRSEC's remote_dep bcast trees,
parsec/remote_dep.c:39-47, pick chain vs binomial by size; the TPU
distributed-linear-algebra work, arXiv:2112.09017, shows topology-
matched collective shapes dominate at pod scale):

  star      1 round, root serializes (R-1) messages — minimal latency
            terms, worst bandwidth term
  binomial  ceil(log2 R) rounds of full-size messages — log-depth
            latency, log bandwidth factor
  ring      R-1 rounds of size/R messages — (R-1) latency terms, but
            the bandwidth-optimal 1x payload factor

ptc-topo: the model is keyed per LINK CLASS (loopback / host / ici /
dcn — comm/topology.py).  A classed testbandwidth sweep publishes
per-class fits under doc["classes"]; absent a measured fit for a class
the base fit is scaled by DEFAULT_CLASS_FACTORS (dcn ~4x the fixed
cost, ~8x the per-byte cost of the flat loopback fit — the
inter-island network is both farther and oversubscribed).  `cls=None`
everywhere means the un-classed base model, bit-identical to pre-topo.

Port of parsec_tpu/comm/economics.py.  `TransferEconomics.load()`
reads coll.econ_path, else the repo's BENCH_comm.json, as the reference
does: that report is the reference's own sweep (JAX CPU loopback on its
host, `meta.platform` "cpu-loopback"), so its `device` path is no
measurement of the card.  A fit of the card's h2d path (pinned staging
on the h2d stream, chip_smoke.py phase 10, written under build/) is
passed as `econ=` or through coll.econ_path where a device transfer is
priced on the card.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# Fallback (alpha seconds, beta seconds/byte) when no BENCH_comm.json is
# available: the reference's loopback-TCP numbers, in the ballpark of its
# committed report (rdv path: ~50 us fixed, ~1 ns/B).  They are model
# constants kept so that a prediction here equals the reference's; they
# measure no CUDA host or card.
DEFAULT_FIT = {"fixed_overhead_us": 50.0, "per_byte_ns": 1.0}

TOPOLOGIES = ("ring", "binomial", "star")

# The hierarchical two-level tree (ptc-topo): intra-island reduce, then
# leaders-only exchange, then fan back out.  Kept out of TOPOLOGIES —
# it only exists (and is only offered by the selector) when a
# multi-island TopologyModel is in force.
HIER = "hier"

# (alpha_factor, beta_factor) applied to the base fit when a class has
# no measured fit of its own.  loopback/host/ici keep the base numbers
# (the sweep that produced them ran on exactly those paths); dcn scales
# the fixed cost ~4x (cross-fabric round trip) and the per-byte cost
# ~8x (oversubscribed inter-island bandwidth).
DEFAULT_CLASS_FACTORS = {
    "loopback": (1.0, 1.0),
    "host": (1.0, 1.0),
    "ici": (1.0, 1.0),
    "dcn": (4.0, 8.0),
}


def fit_points(points: Sequence[Tuple[float, float]]) -> Optional[dict]:
    """Least-squares t = a + b*size over (size_bytes, seconds) points.
    Returns the model's two headline quantities (fixed per-transfer
    overhead, per-byte cost) plus fit quality, or None with fewer than
    two distinct sizes.  This is THE fit testbandwidth.py publishes into
    BENCH_comm.json — selector and harness share one definition."""
    if len({s for s, _ in points}) < 2:
        return None
    xs = np.array([s for s, _ in points], dtype=np.float64)
    ys = np.array([t for _, t in points], dtype=np.float64)
    A = np.vstack([np.ones_like(xs), xs]).T
    (a, b), *_ = np.linalg.lstsq(A, ys, rcond=None)
    pred = a + b * xs
    ss_res = float(((ys - pred) ** 2).sum())
    ss_tot = float(((ys - ys.mean()) ** 2).sum())
    return {
        "fixed_overhead_us": round(a * 1e6, 2),
        "per_byte_ns": round(b * 1e9, 6),
        "eff_gbps": round(8.0 / b / 1e9, 3) if b > 0 else None,
        "r2": round(1.0 - ss_res / ss_tot, 4) if ss_tot > 0 else None,
        "npoints": len(points),
    }


class TransferEconomics:
    """Fitted transfer costs per path, loaded from a BENCH_comm.json.

    `alpha(path)` / `beta(path)` return the fixed (seconds) and per-byte
    (seconds/byte) legs; `cost(nbytes, path)` the modeled one-transfer
    time.  Negative fitted intercepts (a 3-point fit can dip below zero)
    clamp to 0 — a transfer cannot have negative fixed cost, and the
    selector only needs the relative ordering."""

    def __init__(self, fits: Dict[str, dict], source: str = "defaults",
                 class_fits: Optional[Dict[str, Dict[str, dict]]] = None):
        self.fits = fits
        self.source = source
        # ptc-topo: {link_class: {path: fit}} from a classed sweep
        self.class_fits: Dict[str, Dict[str, dict]] = class_fits or {}

    # ------------------------------------------------------------ loading
    @classmethod
    def load(cls, path: Optional[str] = None) -> "TransferEconomics":
        """Load from `path`, else coll.econ_path, else the repo's
        BENCH_comm.json, else built-in defaults (never raises for a
        missing/garbled file — the selector must work on fresh hosts)."""
        if path is None:
            from ..utils import params as _mca
            path = _mca.get("coll.econ_path") or None
        if path is None:
            repo = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            cand = os.path.join(repo, "BENCH_comm.json")
            path = cand if os.path.exists(cand) else None
        if path is None:
            return cls({}, source="defaults")
        try:
            with open(path) as f:
                doc = json.load(f)
            fits = {name: p["fit"] for name, p in doc.get("paths", {}).items()
                    if isinstance(p, dict) and p.get("fit")}
            class_fits = {
                lc: {name: p["fit"]
                     for name, p in paths.items()
                     if isinstance(p, dict) and p.get("fit")}
                for lc, paths in doc.get("classes", {}).items()
                if isinstance(paths, dict)}
            class_fits = {lc: f for lc, f in class_fits.items() if f}
            if not fits and not class_fits:
                return cls({}, source="defaults")
            return cls(fits, source=path, class_fits=class_fits)
        except (OSError, ValueError, KeyError):
            return cls({}, source="defaults")

    # ------------------------------------------------------------- model
    def path_fit(self, path: str = "rdv",
                 cls: Optional[str] = None) -> dict:
        """The (fixed_overhead_us, per_byte_ns) legs for `path`, falling
        back eager -> rdv -> defaults so a partial sweep still answers.
        With a link class: that class's measured fit when the classed
        sweep ran, else the base fit scaled by DEFAULT_CLASS_FACTORS."""
        if cls is not None:
            cfits = self.class_fits.get(cls)
            if cfits:
                for cand in (path, "rdv", "eager"):
                    if cand in cfits:
                        return cfits[cand]
            fa, fb = DEFAULT_CLASS_FACTORS.get(cls, (1.0, 1.0))
            base = self.path_fit(path)
            if fa == 1.0 and fb == 1.0:
                return base
            scaled = dict(base)
            scaled["fixed_overhead_us"] = base["fixed_overhead_us"] * fa
            scaled["per_byte_ns"] = base["per_byte_ns"] * fb
            return scaled
        for cand in (path, "rdv", "eager"):
            if cand in self.fits:
                return self.fits[cand]
        return dict(DEFAULT_FIT)

    def alpha(self, path: str = "rdv", cls: Optional[str] = None) -> float:
        return max(0.0, self.path_fit(path, cls)["fixed_overhead_us"]) * 1e-6

    def beta(self, path: str = "rdv", cls: Optional[str] = None) -> float:
        return max(0.0, self.path_fit(path, cls)["per_byte_ns"]) * 1e-9

    def cost(self, nbytes: int, path: str = "rdv",
             cls: Optional[str] = None) -> float:
        """Modeled seconds for one transfer of `nbytes` on `path` (over
        link class `cls` when given)."""
        return self.alpha(path, cls) + nbytes * self.beta(path, cls)

    def eager_threshold(self, fallback: int = 64 * 1024,
                        cls: Optional[str] = None) -> int:
        """Fitted eager/rendezvous crossover in bytes: the payload size
        where the modeled eager cost overtakes the rendezvous cost
        (alpha_e + n*beta_e = alpha_r + n*beta_r), clamped to the same
        [16 KiB, 16 MiB] window the adaptive calibration uses.  When the
        sweep carries no separate eager and rdv fits (or eager's
        per-byte cost does not exceed rdv's, so the lines never cross),
        `fallback` — typically the static comm.eager_limit — answers.
        This is the split ptc-plan's comm-volume analysis models."""
        fits = self.class_fits.get(cls) if cls is not None else None
        if fits is None:
            fits = self.fits
        if "eager" not in fits or "rdv" not in fits:
            return fallback
        be, br = self.beta("eager", cls), self.beta("rdv", cls)
        if be <= br:
            return fallback
        n = (self.alpha("rdv", cls) - self.alpha("eager", cls)) / (be - br)
        return int(min(16 << 20, max(16 << 10, n)))

    # ---------------------------------------------------------- selector
    def topology_costs(self, kind: str, nbytes: int, nranks: int,
                       path: str = "rdv", cls: Optional[str] = None,
                       tmodel=None) -> Dict[str, float]:
        """Modeled completion time per topology for one collective of
        `nbytes` (the per-rank contribution / broadcast payload) across
        `nranks`.  `kind`: "reduce" (reduce-scatter-shaped: the unit is
        a 1/R segment converging on its root) or "fanout" (bcast /
        all-gather-shaped: the full payload leaves one root).  With a
        multi-island `tmodel` (comm/topology.py) the dict gains "hier":
        the two-level tree that reduces inside each island at ici cost
        and exchanges only between the island leaders at dcn cost —
        (islands - 1) DCN crossings instead of O(nranks)."""
        if nranks <= 1:
            return {t: 0.0 for t in TOPOLOGIES}
        a, b = self.alpha(path, cls), self.beta(path, cls)
        R = nranks
        L = max(1, math.ceil(math.log2(R)))
        if kind == "reduce":
            seg = nbytes / R
            costs = {
                # R-1 pipelined hops of one segment each
                "ring": (R - 1) * (a + seg * b),
                # log rounds, each hop carries a segment
                "binomial": L * (a + seg * b),
                # one round, but the root's link serializes R-1 segments
                "star": a + (R - 1) * seg * b,
            }
        else:
            # fanout: full payload from the root
            costs = {
                # chain pipeline: R-1 latency terms, one payload down the
                # pipe (wire chunking overlaps the hops for large payloads)
                "ring": (R - 1) * a + nbytes * b,
                "binomial": L * (a + nbytes * b),
                "star": a + (R - 1) * nbytes * b,
            }
        if tmodel is not None and getattr(tmodel, "n_islands", 1) > 1:
            # Multi-island mesh: reprice the flat trees honestly — their
            # crossing hops pay DCN cost (assuming island-contiguous
            # ranks, remap_ranks' invariant) — and offer the two-level
            # hier tree that crosses DCN only between island leaders.
            ai = self.alpha(path, "ici")
            bi = self.beta(path, "ici")
            ad = self.alpha(path, "dcn")
            bd = self.beta(path, "dcn")
            I = tmodel.n_islands
            Rl = max(len(tmodel.island_ranks(i)) for i in range(I))
            Li = max(1, math.ceil(math.log2(max(2, Rl))))
            Ld = max(1, math.ceil(math.log2(I)))
            unit = nbytes / R if kind == "reduce" else nbytes
            hop_i = ai + unit * bi
            hop_d = ad + unit * bd
            # chain/ring: R-1 hops, I-1 of them cross islands
            costs["ring"] = (R - I) * hop_i + (I - 1) * hop_d
            # binomial: log2(R) rounds; the top log2(I) pair across
            costs["binomial"] = max(0, L - Ld) * hop_i + Ld * hop_d
            # star: the root's link serializes R-1 transfers, the ones
            # to/from other islands at DCN per-byte cost
            far = R - R // I
            costs["star"] = ad + (R - 1 - far) * unit * bi + far * unit * bd
            intra = Li * hop_i if Rl > 1 else 0.0
            costs[HIER] = intra + ad + (I - 1) * unit * bd
        return costs

    def choose_topology(self, kind: str, nbytes: int, nranks: int,
                        path: str = "rdv",
                        override: Optional[str] = None,
                        cls: Optional[str] = None,
                        tmodel=None) -> str:
        """Pick the cheapest topology under the fitted model.  `override`
        (or the coll.topo knob when it is not 'auto': a constant here,
        an MCA parameter in the reference) wins unconditionally — the
        knob is the escape hatch when the model is wrong for a
        deployment.  "hier" is only legal/offered alongside
        a multi-island `tmodel` (the tree needs island structure)."""
        hier_ok = tmodel is not None and getattr(tmodel, "n_islands", 1) > 1
        if override is None:
            from .topology import resolve_class_knob
            ov = resolve_class_knob("coll.topo", cls)
            override = None if ov in (None, "", "auto") else ov
        if override is not None:
            legal = TOPOLOGIES + ((HIER,) if hier_ok else ())
            if override not in legal:
                raise ValueError(
                    f"unknown collective topology {override!r} "
                    f"(coll.topo): expected one of {list(legal)} "
                    "or 'auto'")
            return override
        costs = self.topology_costs(kind, nbytes, nranks, path, cls,
                                    tmodel if hier_ok else None)
        # on modeled-time ties prefer hier: it moves strictly fewer
        # DCN-crossing bytes than any flat tree of the same cost
        return min(costs, key=lambda t: (costs[t], 0 if t == HIER else 1))


_cached: Optional[TransferEconomics] = None


def default_economics() -> TransferEconomics:
    """Process-wide cached TransferEconomics.load() (the selector runs
    per collective build; re-reading the JSON each time would be silly)."""
    global _cached
    if _cached is None:
        _cached = TransferEconomics.load()
    return _cached


def choose_topology(kind: str, nbytes: int, nranks: int,
                    override: Optional[str] = None,
                    econ: Optional[TransferEconomics] = None,
                    tmodel=None) -> str:
    """Module-level convenience over default_economics()."""
    return (econ or default_economics()).choose_topology(
        kind, nbytes, nranks, override=override, tmodel=tmodel)
