from .dtd import INOUT, INPUT, OUTPUT, DtdTaskpool, DtdTile, DtdView

__all__ = ["DtdTaskpool", "DtdTile", "DtdView", "INPUT", "OUTPUT", "INOUT"]
