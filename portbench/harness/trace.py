"""A traced stretch of the window, and what the readers take from it.

The profiler (CPU and CUDA activities) starts in the server's worker
thread, at the first pipeline call after `start`, and stops after the
first call that ends after `stop`, so the trace holds whole calls and the
worker's host ranges (pb.*) beside every kernel. A cell traces the last
seconds of its window: the profiler slows the host, and its stop holds
the interpreter for seconds, which must fall after the window. `read` turns it into
plain lists: kernels (name, start, end in ns), the host ranges, and the
traced stretch's bounds.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile

BUSY = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    def __init__(self, start: float, stop: float, calls: list):
        self.start, self.stop, self.calls = start, stop, calls
        self.prof = None
        self.done = False
        self.first = self.last = 0   # the traced calls: calls[first:last]

    def before_call(self, now: float):
        if self.prof is None and not self.done and now >= self.start:
            self.first = len(self.calls)
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            with torch.profiler.record_function("pb.trace_begin"):
                pass

    def after_call(self, now: float):
        if self.prof is not None and not self.done and now >= self.stop:
            torch.cuda.synchronize()
            with torch.profiler.record_function("pb.trace_end"):
                pass
            self.prof.stop()
            self.done = True
            self.last = len(self.calls)


@dataclass
class Trace:
    t0: int
    t1: int
    kernels: list = field(default_factory=list)   # (name, start, end) ns
    busy: list = field(default_factory=list)      # device intervals, ns
    spans: list = field(default_factory=list)     # (name, start, end) host


def _activity(e) -> str:
    """The event's kind (kernel, gpu_memcpy, gpu_memset, ...), or "" where
    this PyTorch does not say: then the name decides."""
    a = getattr(e, "activity_type", None)
    a = a() if callable(a) else a
    if isinstance(a, str) and a:
        return a
    name = e.name()
    if name.startswith("pb.") or getattr(e, "is_user_annotation", lambda: False)():
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def read(tracer: Tracer) -> Trace | None:
    if tracer is None or not tracer.done:
        return None
    events = tracer.prof.profiler.kineto_results.events()
    t0 = t1 = None
    kernels, busy, spans = [], [], []
    for e in events:
        name = e.name()
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = 1000 * e.start_us(), 1000 * e.duration_us()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            act = _activity(e)
            if act in BUSY:
                busy.append((start, start + dur))
                if act == "kernel":
                    kernels.append((name, start, start + dur))
        elif name.startswith("pb."):
            if name == "pb.trace_begin":
                t0 = start
            elif name == "pb.trace_end":
                t1 = start + dur
            else:
                spans.append((name, start, start + dur))
    if t0 is None or t1 is None:
        return None
    return Trace(t0, t1, kernels, busy, spans)


def union_ns(intervals, lo: int, hi: int) -> int:
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def _innermost(spans):
    """[(start, end, name)] of elementary stretches, each named by the
    innermost pb.* range covering it ("server" where none does)."""
    cuts = sorted({t for _, s, e in spans for t in (s, e)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        best, width = "server", None
        for name, s, e in spans:
            if s <= mid <= e and (width is None or e - s < width):
                best, width = name, e - s
        out.append((a, b, best))
    return out


def idle_gaps(tr: Trace):
    """Device idle stretches inside the traced window, each named by the
    innermost pb.* range open on the host at its middle (outside any:
    "server", the worker between pipeline calls) -> {name: seconds}."""
    import bisect
    segs = _innermost(tr.spans)
    starts = [a for a, _, _ in segs]
    out = {}
    cursor = tr.t0
    gaps = []
    for a, b in sorted(tr.busy):
        if a > cursor:
            gaps.append((cursor, min(a, tr.t1)))
        cursor = max(cursor, b)
        if cursor >= tr.t1:
            break
    if cursor < tr.t1:
        gaps.append((cursor, tr.t1))
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = segs[i][2] if i >= 0 and segs[i][1] >= mid else "server"
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out
