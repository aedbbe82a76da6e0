"""The traced sub-window, reduced: device activity from ``torch.profiler``
(CUPTI, device activity only, so the host runs at nearly its own pace)
and the host spans the harness times around the engine's phases.

The profiler stamps device activity on the system clock
(``time.time_ns``), so the harness stamps its spans and the window's two
ends on that clock too. Busy time is the union of device activity
intervals (kernels, copies, sets) inside the window, so overlapping
streams count once; idle time is the rest. Each idle gap is named by the
innermost host span under its middle, which is what the host was doing
while the device waited."""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

TOP = 10


@dataclasses.dataclass
class TraceData:
    kernels: List[Tuple[str, float, float]]   # (name, start s, end s)
    spans: List[Tuple[str, float, float]]     # harness spans
    t0: float
    t1: float
    busy: List[Tuple[float, float]]           # merged device intervals

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose name contains ``pattern``."""
        return sum(e - s for n, s, e in self.kernels if pattern in n)


def _events(prof):
    """(name, on device, start s, end s) of every profiled event."""
    from torch.autograd import DeviceType
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for e in raw:
            if hasattr(e, "start_ns"):
                s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                s, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
            yield e.name(), e.device_type() == DeviceType.CUDA, s, s + d
        return
    for e in prof.events():
        yield (e.name, e.device_type == DeviceType.CUDA,
               e.time_range.start * 1e-6, e.time_range.end * 1e-6)


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce(prof, spans, window) -> TraceData:
    """``spans``: (name, start, end) and ``window``: (start, end), all in
    seconds of the system clock (``time.time_ns() * 1e-9``)."""
    t0, t1 = window
    kernels = [(n, max(s, t0), min(e, t1)) for n, on_dev, s, e
               in _events(prof) if on_dev and e > t0 and s < t1]
    return TraceData(kernels, list(spans), t0, t1,
                     _merge([(s, e) for _, s, e in kernels]))


def idle_gaps(data: TraceData) -> List[Tuple[float, float]]:
    gaps, cur = [], data.t0
    for s, e in data.busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < data.t1:
        gaps.append((cur, data.t1))
    return gaps


def breakdown(data: TraceData) -> Dict[str, list]:
    """The device operations that took most time, and the idle time by
    what the host was doing (the innermost harness span under each gap's
    middle; "none" outside every span)."""
    ops: Dict[str, float] = {}
    for n, s, e in data.kernels:
        ops[n] = ops.get(n, 0.0) + (e - s)
    spans = sorted(data.spans, key=lambda x: x[1])
    starts = [s for _, s, _ in spans]
    idle: Dict[str, float] = {}
    for s, e in idle_gaps(data):
        mid = 0.5 * (s + e)
        name = "none"
        # the latest-starting span that still covers the middle
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if spans[i][2] >= mid:
                name = spans[i][0]
                break
            if mid - spans[i][1] > 5.0:
                break
        idle[name] = idle.get(name, 0.0) + (e - s)
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}
