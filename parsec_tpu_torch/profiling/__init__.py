"""Observability: paired-event binary traces (trace.py) and the critical
path and lost-time analysis over them (critpath.py), the PINS
instrumentation chain (pins.py), the always-on metrics registry, its
exporter and the watchdog (metrics.py), the live sampler (live.py),
request scopes with plan conformance and the request timeline
(scope.py), and the crash-durable journal and fleet view (blackbox.py).

Port of parsec_tpu/profiling; it exports the same names, and the keys
and the wall-clock anchor of the device manager's own spans, the keys of
the device data plane's, of the wave compiler's certificates and of the
device's flush.
"""
from .trace import (KEY_EXEC, KEY_RELEASE, KEY_EDGE,
                    KEY_COMM_SEND, KEY_COMM_RECV, KEY_DEVICE, KEY_H2D,
                    KEY_STREAM, KEY_COLL, KEY_SCOPE, KEY_INFLIGHT,
                    KEY_DEVICE_WAIT, KEY_DEVICE_PLAN, KEY_DEVICE_COMPLETE,
                    KEY_GC_PAUSE, KEY_H2D_AHEAD, KEY_DEVICE_DP_SERVE,
                    KEY_DEVICE_DP_RECV, KEY_DEVICE_CERT, KEY_DEVICE_FLUSH,
                    Dictionary, Trace, clock_anchor, take_trace, to_dot)
from .critpath import critical_path, lost_time
from .pins import (PinsModule, PinsChain, TaskCounter, TaskProfiler,
                   CommVolume, DeviceActivity, StragglerLog, REGISTRY,
                   enable_pins)
from .metrics import (Hist, MetricsRegistry, MetricsExporter, Watchdog,
                      snapshot_histograms)
from .scope import ScopeRegistry, request_timeline
from .blackbox import Journal, FleetView

__all__ = ["KEY_EXEC", "KEY_RELEASE", "KEY_EDGE",
           "KEY_COMM_SEND", "KEY_COMM_RECV", "KEY_DEVICE", "KEY_H2D",
           "KEY_STREAM", "KEY_COLL", "KEY_SCOPE", "KEY_INFLIGHT",
           "KEY_DEVICE_WAIT", "KEY_DEVICE_PLAN", "KEY_DEVICE_COMPLETE",
           "KEY_GC_PAUSE", "KEY_H2D_AHEAD", "KEY_DEVICE_DP_SERVE",
           "KEY_DEVICE_DP_RECV", "KEY_DEVICE_CERT", "KEY_DEVICE_FLUSH",
           "Dictionary", "Trace",
           "clock_anchor", "take_trace", "to_dot",
           "critical_path", "lost_time",
           "PinsModule", "PinsChain", "TaskCounter", "TaskProfiler",
           "CommVolume", "DeviceActivity", "StragglerLog", "REGISTRY",
           "enable_pins",
           "Hist", "MetricsRegistry", "MetricsExporter", "Watchdog",
           "snapshot_histograms",
           "ScopeRegistry", "request_timeline",
           "Journal", "FleetView"]
