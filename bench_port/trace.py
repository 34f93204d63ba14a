"""Reduction of a torch.profiler trace of a stretch of jobs to the device's busy
time, its idle gaps and its kernel table.

Device operations (kernels, copies, fills) are the profiler's CUDA events;
the harness's own spans are the CPU events whose names start with ``bench.``
(``bench.job`` around a job, and inside it the calls into each layer). The
traced window runs from the first ``bench.job``'s start to the last one's end.
The busy time is the union of the device intervals inside it (the pattern of
the program's ``chip_smoke.py::device_busy``), so operations that overlap are
counted once.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

Interval = Tuple[str, float, float]  # (name, start us, end us)

SPAN_PREFIX = "bench."
JOB_SPAN = "bench.job"


@dataclass
class Trace:
    device: List[Interval] = field(default_factory=list)
    spans: List[Interval] = field(default_factory=list)

    @property
    def jobs(self) -> List[Interval]:
        return sorted(s for s in self.spans if s[0] == JOB_SPAN) if self.spans else []

    @property
    def window(self) -> Tuple[float, float]:
        jobs = self.jobs
        return min(s[1] for s in jobs), max(s[2] for s in jobs)


def from_profiler(prof) -> Trace:
    """The device operations and the harness's spans of a finished profile.
    The profiler also shows named ranges on the device's timeline (user
    annotations such as each harness span or ``nccl:_all_gather_base``, not
    operations); those are left out of the operations."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    t = Trace()
    for ev in prof.events():
        item = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == cuda:
            if not (getattr(ev, "is_user_annotation", False) or ev.name.startswith(SPAN_PREFIX)):
                t.device.append(item)
        elif ev.name.startswith(SPAN_PREFIX):
            t.spans.append(item)
    return t


def clip(intervals: List[Interval], lo: float, hi: float) -> List[Interval]:
    return [(n, max(a, lo), min(b, hi)) for n, a, b in intervals if b > lo and a < hi]


def merged(intervals: List[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals as disjoint, sorted (start, end) pairs."""
    out: List[List[float]] = []
    for _, a, b in sorted(intervals, key=lambda x: x[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(intervals: List[Interval], lo: float, hi: float) -> float:
    return sum(b - a for a, b in merged(clip(intervals, lo, hi)))


def idle_gaps(intervals: List[Interval], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] in which no device operation ran."""
    gaps, at = [], lo
    for a, b in merged(clip(intervals, lo, hi)):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def label(t: float, spans: List[Interval]) -> str:
    """The innermost harness span around time ``t`` ("between jobs" if none)."""
    inner: Optional[Interval] = None
    for s in spans:
        if s[1] <= t <= s[2] and (inner is None or s[2] - s[1] < inner[2] - inner[1]):
            inner = s
    return inner[0] if inner else "between jobs"


def kernel_table(intervals: List[Interval], top: int = 10) -> List[List]:
    """[name, seconds] of the device operations that took most time, summed by name."""
    total: Dict[str, float] = defaultdict(float)
    for n, a, b in intervals:
        total[n] += (b - a) * 1e-6
    return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:top]]


def gap_table(trace: Trace, top: int = 10) -> List[List]:
    """[label, seconds] of the longest idle gaps of the traced window, each
    labelled by the harness span the host was in at the gap's middle."""
    lo, hi = trace.window
    gaps = sorted(idle_gaps(trace.device, lo, hi), key=lambda g: g[0] - g[1])[:top]
    return [[label((a + b) / 2, trace.spans), (b - a) * 1e-6] for a, b in gaps]
