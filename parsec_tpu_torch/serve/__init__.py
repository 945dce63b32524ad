"""Multi-tenant serving runtime over the task runtime (port of
parsec_tpu/serve without the fleet router, which waits for the analysis
layer and the comm engine):

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
"""
from .engine import InferenceEngine, PagedLM, PagedLMConfig, RequestHandle
from .server import (AdmissionError, ResourceBusy, Server, TenantConfig,
                     Ticket)

__all__ = [
    "Server", "TenantConfig", "Ticket", "AdmissionError", "ResourceBusy",
    "InferenceEngine", "PagedLM", "PagedLMConfig", "RequestHandle",
]
