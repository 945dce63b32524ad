from .collections import Collection, TwoDimBlockCyclic, VectorCyclic

__all__ = ["Collection", "TwoDimBlockCyclic", "VectorCyclic"]
