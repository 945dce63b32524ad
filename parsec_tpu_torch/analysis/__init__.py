"""Static analysis over PTG/DTD graphs.

Port of parsec_tpu/analysis, so far its JAX-free front: `dtdlint`, the
insertion-time linter of the dynamic (DTD) path, and the collection
geometry helper of `flowgraph`.  The verifier, the planner, the tuner
and the controller are not ported yet.
"""
from .dtdlint import DTD_RULES, DtdLintError, DtdLinter
from .flowgraph import collection_tile_bytes

__all__ = ["DtdLinter", "DtdLintError", "DTD_RULES",
           "collection_tile_bytes"]
