"""Continuous-batching LLM inference engine over paged KV-cache DAGs.

Port of parsec_tpu/serve/engine.py.  Many concurrent sequences, each
owned by a tenant, generate tokens step by step.  Every PREFILL is one
admission-controlled taskpool (Server front door: per-tenant budgets,
QoS priority/weight); every DECODE step builds one taskpool PER TENANT
batching that tenant's active sequences (continuous batching: sequences
join after prefill and retire mid-stream, pools churn every step).  KV
pages are runtime tiles (ops/paged_attention.PagePool) budgeted by the
admission layer and staged to the card by the device module when a
CudaDevice is attached.

The model (PagedLM) is a deterministic single-layer attention LM in f32
whose weights live on a torch device — the card unless the caller asks
for the CPU.  Its projections run there, one token at a time, so every
caller sees the same bytes for a token; the attention folds of the DAG
are host numpy (bit-identical across schedules) or, for frozen pages
with a device attached, the torch fold on the card.

Not ported yet: tensor-parallel serving (tp > 1, the comm engine) and
plan conformance (conformance=True, the analysis layer); both raise
NotImplementedError.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..data.collections import TwoDimBlockCyclic
from ..ops.paged_attention import (PagePool, SeqSpec, attend_heads,
                                   build_paged_decode, build_paged_prefill,
                                   build_paged_verify, finalize_heads,
                                   make_slot_collections, prefix_page_keys,
                                   reset_acc)
from ..utils import params as _mca
from .server import ResourceBusy, Server, TenantConfig, _no_conformance

__all__ = ["PagedLMConfig", "PagedLM", "InferenceEngine", "RequestHandle"]

_WEIGHTS = ("embed", "wq", "wk", "wv", "wo")


# ---------------------------------------------------------------- model
class PagedLMConfig:
    def __init__(self, vocab: int = 64, d: int = 16, page: int = 8,
                 seed: int = 0, heads: int = 1):
        self.vocab, self.d, self.page, self.seed = vocab, d, page, seed
        # `heads` independent attention heads (d must divide evenly)
        if d % max(1, heads):
            raise ValueError("d must divide by heads")
        self.heads = max(1, int(heads))


def _seeded_weights(cfg: PagedLMConfig) -> Dict[str, np.ndarray]:
    """The reference's weights bit for bit: one RandomState(seed), drawn
    in the reference's order (embed, wq, wk, wv, wo)."""
    rng = np.random.RandomState(cfg.seed)
    d, v = cfg.d, cfg.vocab
    out = {"embed": rng.randn(v, d).astype(np.float32) * np.float32(0.5)}
    for name in _WEIGHTS[1:]:
        out[name] = rng.randn(d, d).astype(np.float32) * \
            np.float32(d ** -0.5)
    return out


class PagedLM(nn.Module):
    """Deterministic toy attention LM: fixed random embed/projections
    (f32) held as buffers on `device` ("cuda" unless the caller passes
    "cpu"; no card raises).  qkv() projects ONE token per call and the
    head (next_token) takes one output row per call,
    so every caller — the engine, its reference_generate, an oracle —
    sees the same bytes for the same token: a product's rounding never
    depends on how many rows a call held."""

    def __init__(self, cfg: PagedLMConfig, device="cuda",
                 params: Optional[Dict[str, np.ndarray]] = None):
        super().__init__()
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PagedLM: no CUDA device is available; pass device='cpu' "
                "to hold the weights on the host")
        self.cfg = cfg
        # prefix-cache identity: a page's KV bytes are a pure function
        # of (model_id, token-id prefix), so the content-hash index is
        # keyed by both (the reference's ids, bit for bit)
        self.model_id = (f"paged-lm:v{cfg.vocab}:d{cfg.d}:"
                         f"p{cfg.page}:s{cfg.seed}")
        if cfg.heads != 1:
            self.model_id += f":h{cfg.heads}"
        if params is None:
            params = _seeded_weights(cfg)
        shapes = {"embed": (cfg.vocab, cfg.d)}
        for name in _WEIGHTS:
            a = np.ascontiguousarray(params[name], dtype=np.float32)
            if a.shape != shapes.get(name, (cfg.d, cfg.d)):
                raise ValueError(f"PagedLM: {name} has shape {a.shape}")
            self.register_buffer(name, torch.from_numpy(a).to(dev))
        self.dh = cfg.d // cfg.heads
        self.scale = float(self.dh) ** -0.5  # == d**-0.5 for heads=1

    @classmethod
    def from_params(cls, cfg: PagedLMConfig, params: Dict[str, np.ndarray],
                    device="cuda") -> "PagedLM":
        """A PagedLM holding `params` (convert.paged_lm_params of a
        reference PagedLM) instead of drawing weights from the seed."""
        return cls(cfg, device=device, params=params)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def qkv(self, token: int):
        """(q, k, v) of one token as host float32 rows."""
        e = self.embed[int(token)]
        out = torch.stack([e @ self.wq, e @ self.wk, e @ self.wv]).cpu()
        q, k, v = out.numpy()
        return q, k, v

    @torch.no_grad()
    def _pre(self, o: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(o, np.float32)) \
            .to(self.device) @ self.wo

    @torch.no_grad()
    def _logits(self, pre: torch.Tensor) -> torch.Tensor:
        return pre @ self.embed.T

    def next_token(self, o: np.ndarray) -> int:
        return int(torch.argmax(self._logits(self._pre(o))))

    # ------------------------------------------------- numpy reference
    def reference_generate(self, prompt: Sequence[int], max_new: int,
                           page: Optional[int] = None):
        """Sequential oracle using the SAME page blocking and fold order
        as the DAG (attend_heads per page) and the same per-token model
        calls — bit-identical to the engine run without device chores.
        Returns (tokens, outputs[n_steps, d])."""
        P = self.cfg.page if page is None else page
        d, H = self.cfg.d, self.cfg.heads
        ks: List[np.ndarray] = []
        vs: List[np.ndarray] = []
        toks = [int(t) for t in prompt]
        for t in toks:
            _, k, v = self.qkv(t)
            ks.append(k)
            vs.append(v)
        outs = []
        at = np.zeros((1, d + 2 * H), np.float32)
        for _ in range(max_new):
            q = self.qkv(toks[-1])[0]
            reset_acc(at, H)
            for off in range(0, len(ks), P):
                K = np.stack(ks[off:off + P])
                V = np.stack(vs[off:off + P])
                attend_heads(q, K, V, at, self.scale, H)
            o = finalize_heads(at, H)
            outs.append(o)
            nxt = self.next_token(o)
            toks.append(nxt)
            _, k, v = self.qkv(nxt)
            ks.append(k)
            vs.append(v)
        return toks, np.stack(outs) if outs else np.zeros((0, d), np.float32)


# ------------------------------------------------------------- requests
class RequestHandle:
    """One inference request's lifecycle: prefill ticket (admission) +
    generated tokens/outputs filled in by the decode loop."""

    __slots__ = ("rid", "tenant", "prompt", "max_new", "ticket", "tokens",
                 "outputs", "state", "submitted_t", "done_t", "_seq",
                 "scope_id")

    def __init__(self, rid: int, tenant: str, prompt: Sequence[int],
                 max_new: int):
        self.rid = rid
        self.tenant = tenant
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.ticket = None
        self.scope_id: Optional[int] = None  # request scope id
        self.tokens: List[int] = list(self.prompt)
        self.outputs: List[np.ndarray] = []
        self.state = "submitted"  # -> active -> done | rejected | failed
        self.submitted_t = time.monotonic()
        self.done_t: Optional[float] = None
        self._seq = None

    @property
    def latency_s(self) -> Optional[float]:
        if self.done_t is None:
            return None
        return self.done_t - self.submitted_t

    @property
    def generated(self) -> List[int]:
        return self.tokens[len(self.prompt):]


class _Seq:
    """Engine-internal active-sequence state."""

    __slots__ = ("req", "slot", "pages", "length", "remaining")

    def __init__(self, req: RequestHandle, slot: int, pages: List[int],
                 length: int):
        self.req = req
        self.slot = slot
        self.pages = pages
        self.length = length          # tokens materialized in pages
        self.remaining = req.max_new  # decode steps left


# --------------------------------------------------------------- engine
class InferenceEngine:
    """Continuous-batching engine.

    submit() routes each request's PREFILL pool through the Server
    (admission + tenant QoS); step() builds one DECODE pool per tenant
    over that tenant's active sequences, runs them concurrently (the
    scheduler's QoS lanes arbitrate), applies the model head, appends
    tokens, and retires finished sequences (pages + slots freed, pools
    destroyed).  run() loops until every request is terminal.

    `prefix_cache` (default on) maps a prompt's warm page-aligned prefix
    onto shared frozen pages; `spec_k` > 0 turns on speculative decoding
    (the draft `spec_draft` — "self", the target's own argmax chain, or
    any PagedLM — proposes k tokens per sequence and ONE verify wave
    checks them; "auto" adapts k per tenant from its acceptance).
    `dev` attaches a CudaDevice: frozen-page folds run on it.
    `body_wrap` wraps every decode PATTL body (fault-injection seam)."""

    def __init__(self, ctx, model: PagedLM, n_pages: int = 64,
                 max_seqs: int = 16, server: Optional[Server] = None,
                 tenants: Optional[List[TenantConfig]] = None,
                 name: str = "eng", body_wrap: Optional[Callable] = None,
                 dev=None, conformance: bool = False,
                 prefix_cache: bool = True, spec_k=0,
                 spec_draft="self", tp: int = 1):
        _no_conformance(conformance)
        if int(tp) > 1:
            raise NotImplementedError(
                "tensor-parallel serving (tp > 1) needs the comm engine, "
                "which is not ported to parsec_tpu_torch yet")
        cfg = model.cfg
        self.ctx = ctx
        self.model = model
        self._nh = cfg.heads
        # adaptive speculation: spec_k="auto" sizes the verify scratch
        # for control.spec_k_max, and each tenant's live k tracks its
        # own acceptance window (shrink on low acceptance, pause under
        # page pressure, grow back on sustained high acceptance).  Every
        # k emits the same token stream.
        self._spec_auto = (spec_k == "auto")
        if self._spec_auto:
            self.spec_k = max(1, int(_mca.get("control.spec_k_max")))
        else:
            self.spec_k = max(0, int(spec_k))
        self._spec_window = max(1, int(_mca.get("control.spec_window")))
        self._spec_low = float(_mca.get("control.spec_accept_low"))
        self._spec_high = float(_mca.get("control.spec_accept_high"))
        self._spec_floor = float(_mca.get("control.spec_page_floor"))
        self._spec_state: Dict[str, dict] = {}  # tenant -> bandit state
        self.prefix_cache = bool(prefix_cache)
        self.spec_draft = (model if spec_draft in (None, "self")
                           else spec_draft)
        # per-request scopes (TTFT/tokens-per-s SLO feed) + per-decode-
        # step shared scopes
        self.scope = ctx.scope_registry()
        self.pool = PagePool(ctx, n_pages, cfg.page, cfg.d,
                             name=f"{name}_KV")
        (self.Qc, self.ACCc, self.Oc, self.KNc,
         self.slot_names) = make_slot_collections(ctx, max_seqs, cfg.d,
                                                  name=f"{name}_PA",
                                                  nh=self._nh)
        self.max_seqs = max_seqs
        self._free_slots = list(range(max_seqs - 1, -1, -1))
        # speculative verify scratch: one (Q, ACC, O) row per (sequence
        # slot, query position) — slot s's query i lives at row
        # s * (spec_k + 1) + i, so no allocator is needed
        if self.spec_k:
            (self.SQc, self.SACCc, self.SOc, _,
             self.spec_names) = make_slot_collections(
                ctx, max_seqs * (self.spec_k + 1), cfg.d,
                name=f"{name}_SV", nh=self._nh)
        self.server = server or Server(
            ctx, tenants or [TenantConfig("default")], name=name)
        # stats()["serve"] grows the pool's prefix-cache counters and
        # the engine's speculative-decode counters
        self.server.register_resource_stats("prefix", self.pool.stats)
        self.server.register_resource_stats("spec", self._spec_stats)
        self.body_wrap = body_wrap
        self.dev = dev
        self._lock = threading.Lock()
        self._active: List[_Seq] = []
        self._inflight: Dict[str, tuple] = {}  # tenant -> pool record
        self._next_rid = 0
        self._prompt_coll_name = f"{name}_PR"
        # staged prompt k|v pages: a cold page is staged in the tile with
        # its KV page's id, so no two running prefills share a tile (a
        # reserved page is not handed out again until its owner frees
        # it).  Tiles are allocated at first touch, so an unused tile
        # costs nothing.
        self.PRc = TwoDimBlockCyclic(n_pages * cfg.page,
                                     2 * cfg.d, cfg.page, 2 * cfg.d,
                                     dtype=np.float32)
        self.PRc.register(ctx, self._prompt_coll_name)
        self.requests: List[RequestHandle] = []
        self.stats = {"decode_pools": 0, "decode_steps": 0,
                      "prefills": 0, "retired": 0, "page_stalls": 0,
                      "prefix_hits": 0, "prefix_misses": 0,
                      "cow_copies": 0, "spec_steps": 0,
                      "spec_proposed": 0, "spec_accepted": 0,
                      "spec_fallbacks": 0}

    def _spec_stats(self) -> dict:
        with self._lock:
            prop = self.stats["spec_proposed"]
            acc = self.stats["spec_accepted"]
            return {
                "enabled": self.spec_k > 0, "k": self.spec_k,
                "auto": self._spec_auto,
                "k_by_tenant": {t: (0 if st["paused"] else st["k"])
                                for t, st in
                                sorted(self._spec_state.items())},
                "steps": self.stats["spec_steps"],
                "proposed": prop, "accepted": acc,
                "fallbacks": self.stats["spec_fallbacks"],
                "accept_rate": (acc / prop) if prop else 0.0,
            }

    # ------------------------------------------------------ prefix keys
    def _page_keys(self, prompt: Sequence[int]) -> List[str]:
        """Content-hash keys for a prompt's FULL pages (the shared
        ops.paged_attention.prefix_page_keys chain)."""
        return prefix_page_keys(self.model.model_id, prompt,
                                self.model.cfg.page)

    # ------------------------------------------------------------ submit
    def submit(self, prompt: Sequence[int], max_new: int,
               tenant: str = "default") -> RequestHandle:
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
        req = RequestHandle(rid, tenant, prompt, max_new)
        req.scope_id = self.scope.new_scope(tenant, rid=rid,
                                            meta={"prompt": len(req.prompt),
                                                  "max_new": max_new})
        self.requests.append(req)
        P = self.model.cfg.page
        n_pages = (len(req.prompt) + P - 1) // P
        est = n_pages * self.pool.bytes_per_page
        # admission-time prefix discount: pages predicted to map onto
        # existing frozen pages cost the pool nothing — the byte budget
        # sees only the cold tail
        discount = 0
        if self.prefix_cache:
            discount = self.pool.probe(self._page_keys(req.prompt)) * \
                self.pool.bytes_per_page
        req.ticket = self.server.submit(
            tenant, lambda priority, weight, req=req: self._build_prefill(
                req, priority, weight),
            est_bytes=est, est_discount_bytes=discount,
            meta={"rid": rid}, scope=req.scope_id)
        if req.ticket.state == "rejected":
            req.state = "rejected"
            req.done_t = time.monotonic()
        return req

    def _build_prefill(self, req: RequestHandle, priority, weight):
        """Server-side builder: admit the page table ATOMICALLY —
        `acquire_prefix` maps the longest warm prefix onto existing
        frozen pages (refcount++) and reserves only the cold tail in
        one pool-lock transaction (ResourceBusy when it doesn't fit) —
        then stage the COLD prompt k|v and build the pool: a warm page
        never re-prefills."""
        cfg = self.model.cfg
        P, d = cfg.page, cfg.d
        T = len(req.prompt)
        n_pages = (T + P - 1) // P
        keys = self._page_keys(req.prompt) if self.prefix_cache else []
        with self._lock:
            if not self._free_slots:
                self.stats["page_stalls"] += 1
                raise ResourceBusy("slots=0")
            got = self.pool.acquire_prefix(keys, n_pages)
            if got is None:
                self.stats["page_stalls"] += 1
                raise ResourceBusy(
                    f"pages={self.pool.free_pages}<{n_pages}")
            pages, warm = got
            slot = self._free_slots.pop()
            self.stats["prefix_hits"] += warm
            self.stats["prefix_misses"] += n_pages - warm
        self.scope.record_prefix(req.tenant, hits=warm,
                                 misses=n_pages - warm)
        # stage COLD prompt k|v into the PR collection + the last
        # token's q; warm pages already hold their rows (frozen)
        kv = np.zeros((n_pages * P, 2 * d), np.float32)
        for i, tok in enumerate(req.prompt):
            if i < warm * P:
                continue
            _, k, v = self.model.qkv(tok)
            kv[i, :d] = k
            kv[i, d:] = v
        for i in range(warm, n_pages):
            self.PRc.tile(pages[i], 0)[...] = kv[i * P:(i + 1) * P]
            self.ctx.host_wrote(self.PRc, pages[i])
        self.Qc.tile(slot, 0)[0] = self.model.qkv(req.prompt[-1])[0]
        reset_acc(self.ACCc.tile(slot, 0), self._nh)
        self.ctx.host_wrote(self.Qc, slot)
        self.ctx.host_wrote(self.ACCc, slot)
        fill = T - (n_pages - 1) * P
        spec = SeqSpec(slot, pages, fill)
        tp = build_paged_prefill(
            self.ctx, self.pool, [spec],
            {"Q": self.slot_names["Q"], "ACC": self.slot_names["ACC"],
             "O": self.slot_names["O"]},
            self._prompt_coll_name, [pages],
            scale=self.model.scale,
            priority=priority, weight=weight, warm=[warm], nh=self._nh)
        tp.on_complete(lambda: self._prefill_done(req, spec, warm, keys,
                                                  tp))
        self.stats["prefills"] += 1
        return tp

    def _prefill_done(self, req: RequestHandle, spec: SeqSpec,
                      warm: int, keys: List[str], tp):
        """Worker-thread callback: activate the sequence + consume the
        first decode output (the prefill chain already attended the
        last prompt position).  A failed pool fails the request: its
        pages hold no trustworthy rows, so none is frozen."""
        if tp.nb_errors > 0:
            seq = _Seq(req, spec.slot, spec.pages, len(req.prompt))
            req._seq = seq
            with self._lock:
                self._retire_locked(seq, state="failed")
            return
        # freeze the cold FULL pages under their content keys — the
        # next request sharing this prefix maps onto them (first
        # writer wins; the mutable last page never freezes)
        if keys:
            for j in range(warm, len(keys)):
                self.pool.freeze(spec.pages[j], keys[j],
                                 owner=req.tenant)
        if req.max_new <= 0:
            # prefill-warm: the request exists only to POPULATE the
            # prefix cache — no token is emitted, no TTFT recorded
            seq = _Seq(req, spec.slot, spec.pages, len(req.prompt))
            req._seq = seq
            with self._lock:
                self._retire_locked(seq)
            return
        o = self.Oc.tile(spec.slot, 0)[0].copy()
        req.outputs.append(o)
        req.tokens.append(self.model.next_token(o))
        # the prefill chain attended the last prompt position: this IS
        # the first generated token — the tenant TTFT histogram's feed
        self.scope.record_first_token(req.scope_id)
        seq = _Seq(req, spec.slot, spec.pages, len(req.prompt))
        seq.remaining = req.max_new - 1
        req._seq = seq
        req.state = "active"
        with self._lock:
            if seq.remaining <= 0:
                self._retire_locked(seq)
            else:
                self._active.append(seq)

    # -------------------------------------------------------------- step
    def _launch(self) -> int:
        """Build + run one decode pool per tenant that has active
        sequences and no decode pool in flight.  Tenants advance
        INDEPENDENTLY — a high-priority tenant's pools complete faster
        under the QoS lanes."""
        P = self.model.cfg.page
        with self._lock:
            ready: Dict[str, List[_Seq]] = {}
            for seq in self._active:
                tenant = seq.req.tenant
                if tenant in self._inflight:
                    continue
                # grow the page list when the last page is full
                if seq.length % P == 0 and len(seq.pages) * P <= \
                        seq.length:
                    p = self.pool.alloc()
                    if p is None:
                        self.stats["page_stalls"] += 1
                        continue
                    seq.pages.append(p)
                ready.setdefault(tenant, []).append(seq)
        launched = 0
        for tenant, seqs in ready.items():
            ts = self.server._tenants.get(tenant)
            prio, wt = (ts.cfg.priority, ts.cfg.weight) if ts else (0, 1)
            rec = None
            k = self._spec_k_for(tenant)
            if k:
                rec = self._stage_spec(seqs, prio, wt, k)
                if rec is None:  # page reservation failed: plain decode
                    with self._lock:
                        self.stats["spec_fallbacks"] += 1
                    self._spec_reserve_failed(tenant)
            if rec is None:
                rec = self._stage_decode(seqs, prio, wt)
            tp, staged, spec_info = rec
            if not staged:
                tp.destroy()  # nothing stageable this wave (COW dry)
                continue
            # one shared scope per decode step
            dsid = self.scope.new_scope(
                tenant,
                kind="spec_verify_step" if spec_info else "decode_step")
            self.scope.stamp(tp, dsid)
            done = threading.Event()
            tp.on_complete(done.set)
            self._inflight[tenant] = (tp, staged, done, dsid,
                                      time.monotonic_ns(), spec_info)
            tp.run()
            self.stats["decode_pools"] += 1
            launched += 1
        return launched

    def _stage_decode(self, seqs, prio, wt):
        """Stage + build one NORMAL decode step over `seqs`.  A shared
        (prefix-cache) or frozen last page goes copy-on-write first:
        PUPD appends in place, and a sharer's view must never move.
        Returns (taskpool, staged sequences, None)."""
        P = self.model.cfg.page
        d = self.model.cfg.d
        specs, staged = [], []
        for seq in seqs:
            last = seq.pages[-1]
            if self.pool.refcount(last) > 1 or self.pool.is_frozen(last):
                priv = self.pool.make_private(last)
                if priv is None:  # clone pool dry: retry next wave
                    with self._lock:
                        self.stats["page_stalls"] += 1
                    continue
                if priv != last:
                    with self._lock:
                        self.stats["cow_copies"] += 1
                    seq.pages[-1] = priv
            q, k, v = self.model.qkv(seq.req.tokens[-1])
            self.Qc.tile(seq.slot, 0)[0] = q
            knrow = self.KNc.tile(seq.slot, 0)
            knrow[0, :d] = k
            knrow[0, d:] = v
            reset_acc(self.ACCc.tile(seq.slot, 0), self._nh)
            for coll in (self.Qc, self.KNc, self.ACCc):
                self.ctx.host_wrote(coll, seq.slot)
            specs.append(SeqSpec(seq.slot, seq.pages, seq.length % P))
            staged.append(seq)
        tp = build_paged_decode(
            self.ctx, self.pool, specs, self.slot_names,
            scale=self.model.scale,
            priority=prio, weight=wt, body_wrap=self.body_wrap,
            dev=self.dev, nh=self._nh)
        return tp, staged, None

    # -------------------------------------------- adaptive speculation
    def _spec_tenant_locked(self, tenant: str) -> dict:
        st = self._spec_state.get(tenant)
        if st is None:
            # optimistic start at k_max: the first windows measure the
            # tenant's real acceptance and shrink from there
            st = {"k": self.spec_k, "paused": False,
                  "accepts": deque(maxlen=self._spec_window)}
            self._spec_state[tenant] = st
        return st

    def _spec_event(self, tenant: str, ev: Optional[dict]):
        if ev is not None:
            self.scope.record_event("control_spec", tenant=tenant, **ev)

    def _spec_k_for(self, tenant: str) -> int:
        """The k this tenant speculates with THIS wave.  Fixed spec_k
        passes through; auto mode reads the tenant's bandit state and
        the pool's free fraction — under page pressure speculation
        pauses (k=0), resuming at the remembered k once pressure
        clears."""
        if not self.spec_k:
            return 0
        if not self._spec_auto:
            return self.spec_k
        frac = self.pool.free_pages / max(1, self.pool.n_pages)
        ev, k = None, 0
        with self._lock:
            st = self._spec_tenant_locked(tenant)
            if frac < self._spec_floor:
                if not st["paused"]:
                    st["paused"] = True
                    ev = {"k_from": st["k"], "k_to": 0,
                          "reason": "page_pressure",
                          "free_frac": round(frac, 4)}
            else:
                if st["paused"]:
                    st["paused"] = False
                    st["accepts"].clear()
                    ev = {"k_from": 0, "k_to": st["k"],
                          "reason": "pressure_cleared",
                          "free_frac": round(frac, 4)}
                k = st["k"]
        self._spec_event(tenant, ev)  # outside the engine lock
        return k

    def _spec_reserve_failed(self, tenant: str):
        """All-or-nothing page reservation failed mid-stage: treat it
        as pressure and pause this tenant's speculation."""
        if not self._spec_auto:
            return
        ev = None
        with self._lock:
            st = self._spec_tenant_locked(tenant)
            if not st["paused"]:
                st["paused"] = True
                ev = {"k_from": st["k"], "k_to": 0,
                      "reason": "reserve_failed"}
        self._spec_event(tenant, ev)

    def _spec_observe(self, tenant: str, proposed: int, accepted: int):
        """Fold one reaped verify wave's acceptance into the tenant's
        window; on a FULL window, halve k below control.spec_accept_low
        and grow k+1 at/above control.spec_accept_high (window clears on
        every move)."""
        if not self._spec_auto or proposed <= 0:
            return
        ev = None
        with self._lock:
            st = self._spec_tenant_locked(tenant)
            st["accepts"].append(accepted / proposed)
            if len(st["accepts"]) == self._spec_window:
                mean = sum(st["accepts"]) / self._spec_window
                k = st["k"]
                if mean < self._spec_low and k > 1:
                    st["k"] = max(1, k // 2)
                    st["accepts"].clear()
                    ev = {"k_from": k, "k_to": st["k"],
                          "reason": "accept_low",
                          "accept": round(mean, 4)}
                elif mean >= self._spec_high and k < self.spec_k:
                    st["k"] = k + 1
                    st["accepts"].clear()
                    ev = {"k_from": k, "k_to": st["k"],
                          "reason": "accept_high",
                          "accept": round(mean, 4)}
        self._spec_event(tenant, ev)

    def _stage_spec(self, seqs, prio, wt, k: Optional[int] = None):
        """Stage + build one SPECULATIVE decode step over `seqs`: the
        draft proposes up to k tokens per sequence, and the k+1 query
        positions (current token + each draft token) verify in ONE
        batched target-model wave (build_paged_verify).

        Per (sequence, query i): the query window's pages — every page
        touched by rows L..L+i — are PRIVATE clones (existing rows
        copied, speculative k|v rows host-staged), while pages wholly
        below row L stay shared read-only.  Page reservation is
        all-or-nothing: a shortfall returns None and the caller falls
        back to plain decode.  Returns (taskpool, sequences, per-seq
        speculation records)."""
        P = self.model.cfg.page
        dm = self.spec_draft
        # per-wave k (adaptive speculation): scratch rows and vslot
        # stride stay sized for spec_k (the max), only nq shrinks
        k = self.spec_k if k is None else min(int(k), self.spec_k)
        layout = []
        for seq in seqs:
            L = seq.length
            nq = min(k + 1, seq.remaining)
            pbase = L // P
            cnt = sum(((L + i) // P + 1) - pbase for i in range(nq))
            layout.append((seq, L, nq, pbase, cnt))
        pages = self.pool.reserve(sum(c for _, _, _, _, c in layout))
        if pages is None:
            return None
        take = iter(pages)
        vspecs, recs = [], []
        for seq, L, nq, pbase, _cnt in layout:
            # draft proposals: the draft model's own greedy chain over
            # the sequence's tokens
            toks = list(seq.req.tokens)
            g = dm.reference_generate(toks, nq - 1)[0][len(toks):] \
                if nq > 1 else []
            u = [toks[-1]] + [int(t) for t in g]
            kvs = [self.model.qkv(t) for t in u]  # (q, k, v) per query
            base_rows = L - pbase * P  # existing rows in the base page
            privs = []
            for i in range(nq):
                npg = (L + i) // P + 1
                priv = [next(take) for _ in range(npg - pbase)]
                # copy the base page's existing rows, then host-stage
                # the speculative rows u[0..i] at absolute rows L..L+i
                if base_rows:
                    src = seq.pages[pbase]
                    self.pool.k_tile(priv[0])[:base_rows] = \
                        self.pool.k_tile(src)[:base_rows]
                    self.pool.v_tile(priv[0])[:base_rows] = \
                        self.pool.v_tile(src)[:base_rows]
                for r in range(L, L + i + 1):
                    pg = priv[r // P - pbase]
                    _, kr, vr = kvs[r - L]
                    self.pool.k_tile(pg)[r % P] = kr
                    self.pool.v_tile(pg)[r % P] = vr
                for pg in priv:
                    self.pool.host_wrote(pg)
                vslot = seq.slot * (self.spec_k + 1) + i
                self.SQc.tile(vslot, 0)[0] = kvs[i][0]
                reset_acc(self.SACCc.tile(vslot, 0), self._nh)
                self.ctx.host_wrote(self.SQc, vslot)
                self.ctx.host_wrote(self.SACCc, vslot)
                R = L + 1 + i
                vspecs.append(SeqSpec(
                    vslot, seq.pages[:pbase] + priv,
                    R - ((L + i) // P) * P))
                privs.append(priv)
            recs.append({"seq": seq, "nq": nq, "g": [int(t) for t in g],
                         "pbase": pbase, "privs": privs})
        tp = build_paged_verify(
            self.ctx, self.pool, vspecs, self.spec_names,
            scale=self.model.scale,
            priority=prio, weight=wt, body_wrap=self.body_wrap,
            dev=self.dev, nh=self._nh)
        return tp, seqs, recs

    def _reap(self) -> int:
        """Consume completed decode pools: apply the model head, append
        tokens, retire finished sequences, destroy the pools.  Returns
        sequences advanced."""
        done = [(t, rec) for t, rec in self._inflight.items()
                if rec[2].is_set()]
        advanced = 0
        for tenant, (tp, seqs, _, dsid, t0_ns, spec) in done:
            del self._inflight[tenant]
            if tp.nb_errors > 0:
                # a failed chore (a fold on the card included) aborted
                # the pool: its outputs are never read, its requests fail
                for rec in spec or ():
                    self.pool.release([p for priv in rec["privs"]
                                       for p in priv])
                with self._lock:
                    for seq in seqs:
                        self._retire_locked(seq, state="failed")
            elif spec is not None:
                advanced += self._reap_spec(tenant, spec)
            else:
                for seq in seqs:
                    o = self.Oc.tile(seq.slot, 0)[0].copy()
                    seq.req.outputs.append(o)
                    seq.req.tokens.append(self.model.next_token(o))
                    seq.length += 1
                    seq.remaining -= 1
                    advanced += 1
            # decode-step pool retired: its measured wall + lane counters
            self.scope.record_pool_done(
                dsid, qos=tp.qos_stats(),
                measured={"wall_ns": time.monotonic_ns() - t0_ns})
            tp.destroy()
            self.stats["decode_steps"] += 1
        with self._lock:
            for seq in [s for s in self._active if s.remaining <= 0]:
                self._retire_locked(seq)
        return advanced

    def _reap_spec(self, tenant: str, recs) -> int:
        """Consume one speculative verify wave: greedy accept — query i
        is valid while every earlier draft matched the target's own
        argmax — so the emitted (token, output) stream equals sequential
        decode regardless of draft quality.  Rejected tokens roll back
        by truncating the page table: the losing queries' private pages
        release (refcounts make this free)."""
        advanced = 0
        wave_prop = wave_acc = 0
        for rec in recs:
            seq, nq, g = rec["seq"], rec["nq"], rec["g"]
            pbase, privs = rec["pbase"], rec["privs"]
            outs, nxts = [], []
            for i in range(nq):
                vslot = seq.slot * (self.spec_k + 1) + i
                o = self.SOc.tile(vslot, 0)[0].copy()
                outs.append(o)
                nxts.append(self.model.next_token(o))
            j = 0  # query 0 is the plain decode position: always valid
            while j < nq - 1 and g[j] == nxts[j]:
                j += 1
            for i in range(j + 1):
                seq.req.outputs.append(outs[i])
                seq.req.tokens.append(nxts[i])
            # the deepest accepted query's window becomes the canonical
            # page-table tail; everything else rolls back to the pool
            old_tail = seq.pages[pbase:]
            seq.pages = seq.pages[:pbase] + privs[j]
            self.pool.release(old_tail + [
                p for i, priv in enumerate(privs) if i != j for p in priv])
            seq.length += j + 1
            seq.remaining -= j + 1
            advanced += j + 1
            with self._lock:
                self.stats["spec_steps"] += 1
                self.stats["spec_proposed"] += nq - 1
                self.stats["spec_accepted"] += j
            self.scope.record_spec(tenant, proposed=nq - 1, accepted=j)
            wave_prop += nq - 1
            wave_acc += j
        # adaptive speculation: one acceptance sample per verify wave
        self._spec_observe(tenant, wave_prop, wave_acc)
        return advanced

    def step(self) -> int:
        """Synchronous decode wave: launch every launchable tenant pool,
        wait for ALL in-flight pools, reap.  Returns sequences
        advanced (0 = nothing active)."""
        self._launch()
        for rec in list(self._inflight.values()):
            rec[2].wait()
        return self._reap()

    def _retire_locked(self, seq: _Seq, state: str = "done"):
        if seq in self._active:
            self._active.remove(seq)
        self.pool.free(seq.pages)
        self._free_slots.append(seq.slot)
        seq.req.state = state
        seq.req.done_t = time.monotonic()
        self.stats["retired"] += 1
        # request terminal: tenant latency/tokens-per-s SLO feed
        self.scope.record_done(seq.req.scope_id, state=state,
                               tokens=len(seq.req.generated))
        # pages/slots freed outside pool completion: unblock
        # ResourceBusy-paused tenants (lock order: engine -> server is
        # safe — the server never calls into the engine under its lock)
        self.server.notify_resources()

    # --------------------------------------------------------------- run
    def pending(self) -> bool:
        with self._lock:
            active = bool(self._active)
        if active:
            return True
        for req in self.requests:
            if req.state in ("submitted", "active") and \
                    req.ticket is not None and \
                    req.ticket.state not in ("rejected", "failed"):
                return True
        return False

    def settle(self):
        """Give requests that never passed admission (or whose prefill
        failed) their ticket's terminal state."""
        for req in self.requests:
            if req.state == "submitted" and req.ticket is not None and \
                    req.ticket.state in ("rejected", "failed"):
                req.state = req.ticket.state
                req.done_t = req.done_t or time.monotonic()

    def run(self, timeout_s: float = 120.0):
        """Drive the continuous-batching loop until every request is
        terminal: tenants launch and reap decode pools independently
        (QoS latency separation), the admission queue drains through
        the server's pump as capacity frees."""
        deadline = time.monotonic() + timeout_s
        while self.pending() or self._inflight:
            if time.monotonic() > deadline:
                raise TimeoutError("serving loop exceeded its deadline")
            launched = self._launch()
            reaped = self._reap()
            if not launched and not reaped:
                time.sleep(0.0005)  # waiting on pools / prefills
        self.settle()

    def close(self):
        self.server.close()
