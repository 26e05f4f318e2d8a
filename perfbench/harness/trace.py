"""Reading the device's work from a torch.profiler trace.

The kernels and copies are read from the profiler's raw events (kineto's
``events()``), not from ``key_averages()``, which builds the whole event
tree first and takes seconds on a trace of tens of thousands of kernels.
Busy time is the union of the device events' intervals, so work that
overlaps on two streams counts once. An idle gap is named by the innermost
host operation that was running when the gap began (or ``host: untraced``,
where the host ran Python or waited outside any traced operation).
"""

from __future__ import annotations

import bisect
import re
from typing import Callable, List, NamedTuple, Optional


class Event(NamedTuple):
    name: str
    start: int  # ns
    end: int


def kernel_name(key: str) -> str:
    """A device kernel's profiler name without its return type, namespace and arguments."""
    name = key.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return re.sub(r"^blocks::|^sm90::", "", name.removeprefix("void ").replace(", ", ","))


class Trace(NamedTuple):
    device: List[Event]
    host: List[Event]

    def busy_ns(self, span: Optional[tuple] = None) -> int:
        """The union of the device events' intervals; with ``span``,
        ``(start_ns, end_ns)`` on the trace's clock, clipped to it."""
        events = self.device
        if span is not None:
            events = [Event(e.name, max(e.start, span[0]), min(e.end, span[1])) for e in events
                      if e.end > span[0] and e.start < span[1]]
        total, end = 0, None
        for e in sorted(events, key=lambda e: e.start):
            if end is None or e.start > end:
                total += e.end - e.start
                end = e.end
            elif e.end > end:
                total += e.end - end
                end = e.end
        return total

    def by_name(self) -> dict:
        """Each kernel's or copy's (ns, count)."""
        out = {}
        for e in self.device:
            ns, n = out.get(e.name, (0, 0))
            out[e.name] = (ns + e.end - e.start, n + 1)
        return out

    def top_ops(self, k: int = 10) -> list:
        rows = sorted(self.by_name().items(), key=lambda kv: -kv[1][0])[:k]
        return [[name, ns / 1e9] for name, (ns, _) in rows]

    def idle_gaps(self, span: Optional[tuple] = None, k: int = 10, namer: Optional[Callable] = None) -> list:
        """The idle time between device events (and at the ends of ``span``,
        ``(start_ns, end_ns)``), summed by what the host was doing, the
        largest first: ``namer(ns)`` names it, or else the innermost traced
        host operation running when the gap began."""
        dev = sorted(self.device, key=lambda e: e.start)
        if not dev:
            return []
        gaps, end = [], dev[0].start if span is None else span[0]
        for e in dev:
            if e.start > end:
                gaps.append((end, e.start))
            end = max(end, e.end)
        if span is not None and span[1] > end:
            gaps.append((end, span[1]))
        host = sorted(self.host, key=lambda e: e.start)
        starts = [e.start for e in host]
        totals = {}
        for g0, g1 in gaps:
            if namer is not None:
                name = namer(g0)
            else:
                i = bisect.bisect_right(starts, g0)
                covering = [e for e in host[max(0, i - 64):i] if e.end >= g0]
                name = min(covering, key=lambda e: e.end - e.start).name if covering else "host: untraced"
            totals[name] = totals.get(name, 0) + (g1 - g0)
        return [[n, ns / 1e9] for n, ns in sorted(totals.items(), key=lambda kv: -kv[1])[:k]]


def read_trace(prof) -> Trace:
    """The device's and the host's events of a finished profile."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        ev = Event(e.name(), start, start + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", lambda: False)() and e.duration_ns() > 0:
                device.append(ev._replace(name=kernel_name(ev.name)))
        else:
            host.append(ev)
    return Trace(device, host)


def profile(fn: Callable, host: bool = True):
    """``fn()`` under torch.profiler, recording the card's activity and, with
    ``host``, the host's operators; returns the profiler for ``read_trace``.
    Trace the host only where one thread drives the card: a profile whose
    host tracing stopped while other threads ran the card hung."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    import torch

    on_card = torch.cuda.is_available()
    acts = ([ProfilerActivity.CUDA] if on_card else []) + ([ProfilerActivity.CPU] if host or not on_card else [])
    with torch_profile(activities=acts) as prof:
        fn()
    return prof
