"""Static analysis over PTG/DTD graphs: `flowgraph` extracts the symbolic
and concrete flow graphs the other analyses share, `verify` runs the
V-rule engine over them, `plan` computes the quantitative bounds
(residency, waves, comm volume, makespan), `tune` simulates schedules
and searches the knob space, `control` is the feedback controller over
the serving stack's conformance record, and `dtdlint` is the
insertion-time linter of the dynamic (DTD) path.

Port of parsec_tpu/analysis; it exports the same names.
"""
from .flowgraph import (ConcreteGraph, FlowGraph, collection_tile_bytes,
                        extract_flowgraph, flowgraph_to_dot)
from .verify import (RULES, Finding, Report, VerifyError, verify_graph,
                     verify_taskpool)
from .plan import (CostModel, Plan, PlanCheckError, certify_waves,
                   chain_certificates, compare_critpath, plan_graph,
                   plan_taskpool)
from .tune import (ScheduleSimulator, TuneStore, apply_knobs, autotune,
                   graph_signature, hold_knobs, host_fingerprint)
from .control import Controller, SimClock
from .dtdlint import DTD_RULES, DtdLintError, DtdLinter

__all__ = [
    "FlowGraph", "ConcreteGraph", "extract_flowgraph", "flowgraph_to_dot",
    "collection_tile_bytes",
    "Finding", "Report", "RULES", "VerifyError", "verify_graph",
    "verify_taskpool",
    "CostModel", "Plan", "PlanCheckError", "plan_graph", "plan_taskpool",
    "compare_critpath", "certify_waves", "chain_certificates",
    "ScheduleSimulator", "TuneStore", "apply_knobs", "hold_knobs",
    "autotune", "graph_signature", "host_fingerprint",
    "Controller", "SimClock",
    "DtdLinter", "DtdLintError",
]
