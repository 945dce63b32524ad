"""Multi-tenant serving runtime over the task runtime (port of
parsec_tpu/serve):

  Server            admission-controlled front door: per-tenant
                    concurrent-pool and queued-bytes budgets, queue or
                    reject beyond them, per-pool QoS (priority/weight)
                    stamped on every admitted taskpool; counters export
                    through Context.stats()["serve"]
  InferenceEngine   continuous-batching LLM inference: paged KV-cache
                    attention DAGs (ops/paged_attention) for prefill and
                    per-step decode, sequences admitted and retired
                    continuously as mixed-priority tenants
  PagedLM           deterministic single-layer attention LM (f32) whose
                    weights live on the card (or the CPU when asked)
  Router            the fleet front door: prefix-locality placement over
                    Replica engines (KeyDigest adverts, RoutePolicy),
                    disaggregated prefill/decode with page migration,
                    re-placement of queued work off unhealthy replicas
"""
from .engine import InferenceEngine, PagedLM, PagedLMConfig, RequestHandle
from .router import FleetHandle, KeyDigest, Replica, RoutePolicy, Router
from .server import (AdmissionError, ResourceBusy, Server, TenantConfig,
                     Ticket)

__all__ = [
    "Server", "TenantConfig", "Ticket", "AdmissionError", "ResourceBusy",
    "InferenceEngine", "PagedLM", "PagedLMConfig", "RequestHandle",
    "Router", "KeyDigest", "RoutePolicy", "Replica", "FleetHandle",
]
