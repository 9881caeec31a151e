"""Reads a `torch.profiler` trace of the traced calls: device busy time as
the union of the device's operation intervals, idle gaps, and the device
time of each of the benchmark's ranges.

A range (`torch.profiler.record_function("bench.<name>")`, opened by the
benchmark around a call into one layer of the program) owns every device
operation whose launch, on any host thread, happened while the range was
open. Any thread, because autograd runs a backward on its own thread while
the caller waits inside the range: a guidance nudge's decoder VJP is
launched from there.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, Iterable, List, Tuple

PREFIX = "bench."
Interval = Tuple[float, float]


@dataclasses.dataclass
class Trace:
    """Times in seconds on the profiler's clock."""

    window: Interval  # the traced calls, from the "bench.window" range
    ops: List[Tuple[str, float, float, float]]  # device operations: (name, start, end, launch)
    ranges: Dict[str, List[Interval]]  # the bench ranges by name, each list sorted

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return union_seconds(clip([(s, e) for _, s, e, _ in self.ops], *self.window))

    def range_device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside range `name`."""
        spans = self.ranges.get(name, [])
        starts = [s for s, _ in spans]
        total = 0.0
        for _, s, e, launch in self.ops:
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch <= spans[i][1]:
                total += e - s
        return total

    def range_count(self, name: str) -> int:
        return len(self.ranges.get(name, []))

    def device_ops(self, n: int = 10) -> List[list]:
        by_name: Dict[str, float] = collections.defaultdict(float)
        for name, s, e, _ in self.ops:
            by_name[name] += e - s
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle device time by what the host was inside at each gap's middle:
        the innermost bench range open then, or "host outside ranges"."""
        busy = merge(clip([(s, e) for _, s, e, _ in self.ops], *self.window))
        named = [(name, lst, [s for s, _ in lst]) for name, lst in self.ranges.items()
                 if name != PREFIX + "window"]
        by_label: Dict[str, float] = collections.defaultdict(float)
        for gs, ge in gaps(busy, *self.window):
            mid = (gs + ge) / 2
            inside = []
            for name, lst, starts in named:  # the ranges of one name never overlap
                i = bisect.bisect_right(starts, mid) - 1
                if i >= 0 and mid <= lst[i][1]:
                    inside.append((lst[i][0], name))
            label = max(inside)[1] if inside else "host outside ranges"
            by_label[label] += ge - gs
        return [[k, v] for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:n]]


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_seconds(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in merge(intervals))


def clip(intervals: Iterable[Interval], t0: float, t1: float) -> List[Interval]:
    return [(max(s, t0), min(e, t1)) for s, e in intervals if e > t0 and s < t1]


def gaps(merged: List[Interval], t0: float, t1: float) -> List[Interval]:
    out, cur = [], t0
    for s, e in merged:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        out.append((cur, t1))
    return out


def _ns(ev, what: str) -> float:
    if hasattr(ev, what + "_ns"):
        return getattr(ev, what + "_ns")() * 1e-9
    if what == "start":
        return ev.start_us() * 1e-6
    return (ev.start_us() + ev.duration_us()) * 1e-6


def from_profiler(prof) -> Trace:
    """The Trace of a finished `torch.profiler.profile` (CPU and CUDA
    activities), from its raw events: no per-op tree is built."""
    from torch.autograd import DeviceType

    launches: Dict[int, float] = {}
    device = []
    ranges: Dict[str, List[Interval]] = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not name.startswith(PREFIX):  # a range's mirror on the device timeline
                device.append((name, _ns(ev, "start"), _ns(ev, "end"), ev.correlation_id()))
        elif name.startswith(PREFIX):
            ranges[name].append((_ns(ev, "start"), _ns(ev, "end")))
        elif ev.correlation_id():
            launches[ev.correlation_id()] = _ns(ev, "start")
    for lst in ranges.values():
        lst.sort()
    if PREFIX + "window" not in ranges:
        raise RuntimeError("the trace holds no bench.window range")
    ops = [(n, s, e, launches.get(c, s)) for n, s, e, c in device]
    w = ranges[PREFIX + "window"]
    return Trace((w[0][0], w[-1][1]), ops, dict(ranges))
