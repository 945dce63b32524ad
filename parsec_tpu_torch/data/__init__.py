from .collections import (Collection, HashDatadist, SubtileView,
                          SymTwoDimBlockCyclic, SymTwoDimBlockCyclicBand,
                          TwoDimBlockCyclic, TwoDimBlockCyclicBand,
                          TwoDimTabular, VectorCyclic)

__all__ = ["Collection", "TwoDimBlockCyclic", "SymTwoDimBlockCyclic",
           "TwoDimBlockCyclicBand", "SymTwoDimBlockCyclicBand",
           "TwoDimTabular", "VectorCyclic", "SubtileView", "HashDatadist"]
