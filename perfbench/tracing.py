"""Spans the benchmark records around its calls into the program, and what
the traced run reads from ``torch.profiler``.

A span is (name, start, end) on ``time.perf_counter``; in a traced run it is
also a ``record_function`` range, so the profiler's timeline carries it next
to the device's operations.  Device busy time is the union of the device's
operation intervals (kernels, copies, sets; annotations excluded), and an
idle gap is named by the innermost host range open when it began.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

Interval = Tuple[str, float, float]   # (name, start_s, end_s)


class Spans:
    """Spans kept in memory; thread-safe, so the frontend's thread may add."""

    def __init__(self, profiled: bool = False):
        self.profiled = profiled
        self._lock = threading.Lock()
        self.items: List[Interval] = []

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = contextlib.nullcontext()
        if self.profiled:
            import torch

            ctx = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        with ctx:
            yield
        t1 = time.perf_counter()
        with self._lock:
            self.items.append((name, t0, t1))

    def total(self, name: str):
        """(seconds, count) of the spans of ``name``."""
        sel = [b - a for n, a, b in self.items if n == name]
        return sum(sel), len(sel)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """(start, length) of the gaps in [lo, hi) that no interval covers."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, hi) - end))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi - end))
    return [g for g in gaps if g[1] > 0]


def innermost(host: List[Interval], t: float) -> Optional[str]:
    """The shortest host range that holds time ``t``."""
    best = None
    for name, a, b in host:
        if a <= t < b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else None


def short_name(name: str) -> str:
    """A kernel's qualified name without its return type, template and
    parameter lists; other names as they are."""
    if "::" not in name:
        return name
    name = name.replace("(anonymous namespace)", "anon")
    if name.startswith("void "):
        name = name[5:]
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return name[:min(cut)] if cut else name


def summarize(device: List[Interval], host: List[Interval], lo: float, hi: float,
              top: int = 10) -> dict:
    """Busy seconds, top device operations and the longest idle gaps in the
    window [lo, hi), all on the profiler's clock."""
    clipped = [(n, max(a, lo), min(b, hi)) for n, a, b in device if b > lo and a < hi]
    busy = union_length((a, b) for _, a, b in clipped)
    by_op: Dict[str, float] = {}
    for n, a, b in clipped:
        by_op[short_name(n)] = by_op.get(short_name(n), 0.0) + (b - a)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps([(a, b) for _, a, b in clipped], lo, hi), key=lambda g: -g[1])
    named = [[innermost(host, s) or "host", length] for s, length in gaps[:top]]
    return {"busy_s": busy, "device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def profiler_intervals(prof, annotations: Iterable[str]) -> Tuple[list, list]:
    """(device intervals, host intervals) in seconds from a finished
    ``torch.profiler.profile``.  Device annotations are left out of the first."""
    skip = set(annotations)
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        item = (e.name(), start, start + e.duration_ns() * 1e-9)
        if e.device_type().name == "CPU":
            host.append(item)
        elif not e.is_user_annotation() and e.name() not in skip:
            device.append(item)
    return device, host
