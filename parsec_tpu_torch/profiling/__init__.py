"""Observability: paired-event binary traces (trace.py), the critical
path and lost-time analysis over them (critpath.py), and request scopes
(scope.py) over the native histogram bucket scheme (metrics.py)."""
from .critpath import critical_path, lost_time
from .scope import ScopeHist, ScopeRegistry
from .trace import (KEY_COLL, KEY_COMM_RECV, KEY_COMM_SEND, KEY_DEVICE,
                    KEY_EDGE, KEY_EXEC, KEY_H2D, KEY_INFLIGHT, KEY_RELEASE,
                    KEY_SCOPE, KEY_STREAM, Dictionary, Trace, take_trace,
                    to_dot)

__all__ = ["KEY_EXEC", "KEY_RELEASE", "KEY_EDGE",
           "KEY_COMM_SEND", "KEY_COMM_RECV", "KEY_DEVICE", "KEY_H2D",
           "KEY_STREAM", "KEY_COLL", "KEY_SCOPE", "KEY_INFLIGHT",
           "Dictionary", "Trace", "take_trace", "to_dot",
           "critical_path", "lost_time",
           "ScopeRegistry", "ScopeHist"]
