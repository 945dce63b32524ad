"""Observability: request scopes (scope.py) over the native histogram
bucket scheme (metrics.py)."""
from .scope import ScopeHist, ScopeRegistry

__all__ = ["ScopeRegistry", "ScopeHist"]
