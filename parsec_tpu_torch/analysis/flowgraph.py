"""Flow-graph helpers of the analysis layer.

Port of parsec_tpu/analysis/flowgraph.py, for now only its collection
geometry helper, which the DTD front end reads for the insertion
linter's D104 rule (dsl/dtd.py DtdTaskpool.tile_of).  The symbolic and
concrete flow-graph extraction the verifier and the planner share is
not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def collection_tile_bytes(coll) -> Optional[int]:
    """Per-datum payload bytes of a collection, from its declared
    geometry (the full mb x nb allocation the device stages and the
    arena-backed wire path assumes; boundary tiles are padded to it).
    None when the collection exposes no recognizable geometry."""
    if coll is None:
        return None
    try:
        if hasattr(coll, "mb") and hasattr(coll, "nb") \
                and hasattr(coll, "dtype"):
            return int(coll.mb) * int(coll.nb) * \
                int(np.dtype(coll.dtype).itemsize)
        if hasattr(coll, "nb") and hasattr(coll, "dtype"):
            return int(coll.nb) * int(np.dtype(coll.dtype).itemsize)
        if hasattr(coll, "elem_size"):
            return int(coll.elem_size)
    except (TypeError, ValueError):
        return None
    return None
