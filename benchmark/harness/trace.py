"""The device timeline of a traced window, from torch.profiler.

Only the CUDA activity is recorded (kernels, copies and fills as CUPTI
sees them on the card), not the host's operators: the host spans that
label the idle gaps are the harness's own.  Times are nanoseconds on
the host's wall clock (time.time_ns), the base the profiler's events
carry.  Nothing is written to disk.
"""
from __future__ import annotations

from typing import List, Tuple

# (name, kind, start_ns, end_ns); kind is "kernel", "memcpy" or "memset"
DeviceOp = Tuple[str, str, int, int]


def _kind(ev) -> str:
    """kernel, memcpy or memset, from the event's activity type where the
    profiler gives one, else from its name."""
    at = str(getattr(ev, "activity_type", lambda: "")()).lower()
    name = ev.name()
    if "memcpy" in at or name.startswith("Memcpy"):
        return "memcpy"
    if "memset" in at or name.startswith("Memset"):
        return "memset"
    return "kernel"


def _span_ns(ev) -> Tuple[int, int]:
    if hasattr(ev, "start_ns"):
        a = int(ev.start_ns())
        b = int(ev.end_ns()) if hasattr(ev, "end_ns") \
            else a + int(ev.duration_ns())
        return a, b
    a = int(ev.start_us() * 1000)
    return a, a + int(ev.duration_us() * 1000)


class Tracer:
    """torch.profiler over the measured window, CUDA activity only."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.ops: List[DeviceOp] = []

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        """Stop recording and keep the device operations."""
        from torch.autograd import DeviceType
        self._prof.stop()
        results = self._prof.profiler.kineto_results
        for ev in results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            a, b = _span_ns(ev)
            if b > a:
                self.ops.append((ev.name(), _kind(ev), a, b))
