"""Spans at the layer boundaries of the query path, kept in memory.

A span is one stretch of work on one thread: its ``name``, start and end,
its own id, the id of the span that was open around it (its parent), the
``pass_id`` of the kernel pass it belongs to, the ``request_id`` of the
request it serves where there is one, the thread, and its attributes
(``q``, ``reason``).  Its self time is its duration less the part of it that
its child spans cover.

Tracing is decided where work enters the program and carried with that
work, as serving systems sample traces:

* an :func:`entry` span (``SparseEmbeddingIndex.query_batch`` and ``query``)
  and a request submitted to the serving frontend are traced when the
  calling thread's work is traced already, when :func:`recording` is on
  anywhere in the process (the operator's switch), or when a
  ``torch.profiler`` session records the calling thread;
* a submitted request carries that decision into the frontend's thread,
  and a pass is traced when any request in it is (see
  ``serve/frontend.py``);
* in a thread that ``torch.profiler`` records, each span is also a
  ``record_function`` range, so the profiler's timeline names the host work
  between the device's operations.

With tracing off a span site costs one check of a process-wide flag and
returns the shared :data:`NOOP`: no clock read, no ``record_function``.

Spans are timed with :func:`clock_ns` (``time.perf_counter_ns``: on Linux
the clock ``time.monotonic`` reads, which the frontend's policy uses too).
:func:`records` returns them on the profiler's clock (``time.time_ns``,
which Kineto's events follow), through one anchor pair of the two clocks
taken when the first span of a recording is stored.  The store is bounded
(:data:`CAPACITY` spans); spans past it are counted in :func:`dropped`.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

clock_ns = time.perf_counter_ns

# Spans kept: a 51 s serve window at 800 requests/s stores about 41k queue
# spans and 14 spans in each of about 4,900 passes, some 110k in all; this
# holds ten such windows.
CAPACITY = 1 << 20

# Whether a torch.profiler session records this thread.  Asked only while
# the process-wide flag a session sets is up, which costs less to read.
_thread_profiled = torch._C._autograd._profiler_enabled


def _profiler_enabled() -> bool:
    return bool(_autograd_profiler._is_profiler_enabled and _thread_profiled())


class Record(NamedTuple):
    """A finished span; times in nanoseconds on the profiler's clock."""

    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]
    pass_id: Optional[int]
    request_id: Optional[int]
    thread: int
    attrs: Optional[dict]


class _Thread(threading.local):
    def __init__(self):
        self.on = False          # this thread's work is traced
        self.profiled = False    # ... and torch.profiler records this thread
        self.stack: list = []    # the open spans, innermost last


_tls = _Thread()
_lock = threading.Lock()
_ids = itertools.count(1)        # span, pass and request ids alike
_records: list = []
_dropped = 0
_anchor: Optional[tuple] = None  # (time_ns, perf_counter_ns) taken together
_live = 0                        # threads whose work is traced now
_recording = 0                   # open recording() blocks


def new_id() -> int:
    """A fresh id for a pass or a request (never reused in the process)."""
    return next(_ids)


def _store(item: tuple) -> None:
    global _anchor, _dropped
    with _lock:
        if _anchor is None:
            _anchor = (time.time_ns(), clock_ns())
        if len(_records) < CAPACITY:
            _records.append(item)
        else:
            _dropped += 1


class _NoSpan:
    """The shared span of untraced work: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None

    def open(self, start_ns: Optional[int] = None):
        return self

    def close(self, end_ns: Optional[int] = None) -> None:
        return None


NOOP = _NoSpan()


class _Span:
    """An open span on this thread's stack; ``open`` / ``close`` take the
    clock reads a caller already made, ``with`` reads the clock itself."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "pass_id", "request_id",
                 "start_ns", "end_ns", "_new_pass", "_rf")

    def __init__(self, name: str, attrs: dict, pass_id=None, new_pass=False):
        self.name = name
        self.attrs = attrs or None
        self.pass_id = pass_id
        self.request_id = None
        self._new_pass = new_pass
        self._rf = None

    def open(self, start_ns: Optional[int] = None) -> "_Span":
        t = _tls
        parent = t.stack[-1] if t.stack else None
        self.span_id = next(_ids)
        self.parent_id = None
        if parent is not None:
            self.parent_id = parent.span_id
            self.request_id = parent.request_id
            if self.pass_id is None:
                self.pass_id = parent.pass_id
        if self.pass_id is None and self._new_pass:
            self.pass_id = next(_ids)
        if t.profiled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = clock_ns() if start_ns is None else start_ns
        t.stack.append(self)
        return self

    def close(self, end_ns: Optional[int] = None) -> None:
        self.end_ns = clock_ns() if end_ns is None else end_ns
        _tls.stack.pop()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        _store((self.name, self.start_ns, self.end_ns, self.span_id, self.parent_id,
                self.pass_id, self.request_id, threading.get_ident(), self.attrs))

    def __enter__(self) -> "_Span":
        return self.open()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class traced:
    """Within it, this thread's work is traced (the frontend's traced passes,
    the root of an :func:`entry`)."""

    __slots__ = ("_was",)

    def __enter__(self) -> "traced":
        global _live
        t = _tls
        self._was = t.on, t.profiled
        if not t.on:
            with _lock:
                _live += 1
        t.on, t.profiled = True, _profiler_enabled()
        return self

    def __exit__(self, *exc) -> None:
        global _live
        t = _tls
        if not self._was[0]:
            with _lock:
                _live -= 1
            t.stack.clear()     # what an exception left open
        t.on, t.profiled = self._was


class _Entry(_Span):
    """An entry span that turns tracing on for this thread while it is open."""

    __slots__ = ("_traced",)

    def open(self, start_ns: Optional[int] = None) -> "_Span":
        self._traced = traced().__enter__()
        return super().open(start_ns)

    def close(self, end_ns: Optional[int] = None) -> None:
        super().close(end_ns)
        self._traced.__exit__()


def enabled() -> bool:
    """Whether this thread's work is traced now."""
    return bool(_live) and _tls.on


def wanted() -> bool:
    """Whether work entering the program from this thread is traced (asked
    once a request: :func:`_profiler_enabled` inlined)."""
    return bool(_recording or (_autograd_profiler._is_profiler_enabled and _thread_profiled())
                or (_live and _tls.on))


def span(name: str, **attrs):
    """A span around a ``with`` block; :data:`NOOP` where the work is not
    traced."""
    if not _live or not _tls.on:
        return NOOP
    return _Span(name, attrs)


def open_span(name: str, start_ns: int, pass_id: Optional[int] = None, **attrs):
    """A span opened at ``start_ns`` (a :func:`clock_ns` read the caller
    made), closed with ``close(end_ns)``; :data:`NOOP` where not traced."""
    if not _live or not _tls.on:
        return NOOP
    return _Span(name, attrs, pass_id).open(start_ns)


def entry(name: str, **attrs):
    """The span of a door of the program (a query call).  Outside traced
    work it decides, as :func:`wanted` says, whether to trace; a door opens
    a new pass unless a pass is open around it."""
    if _live and _tls.on:
        return _Span(name, attrs, new_pass=True)
    if not (_recording or _profiler_enabled()):
        return NOOP
    return _Entry(name, attrs, new_pass=True)


def add(name: str, start_ns: int, end_ns: int, pass_id: Optional[int] = None,
        request_id: Optional[int] = None, **attrs) -> None:
    """Store a span already finished (clock reads the caller made), under
    the span open on this thread, if any."""
    stack = _tls.stack
    parent = stack[-1] if stack else None
    if parent is not None and pass_id is None:
        pass_id = parent.pass_id
    _store((name, start_ns, end_ns, next(_ids), parent.span_id if parent else None,
            pass_id, request_id, threading.get_ident(), attrs or None))


def current():
    """The innermost span open on this thread, or None."""
    stack = _tls.stack
    return stack[-1] if stack else None


class recording:
    """The operator's switch: within it, every door of the program traces,
    from any thread, with no profiler running."""

    def __enter__(self) -> "recording":
        global _recording
        with _lock:
            _recording += 1
        return self

    def __exit__(self, *exc) -> None:
        global _recording
        with _lock:
            _recording -= 1


def records() -> List[Record]:
    """The stored spans, in the order they finished, on the profiler's clock."""
    with _lock:
        items = list(_records)
        anchor = _anchor
    if anchor is None:
        return []
    shift = anchor[0] - anchor[1]
    return [Record(n, a + shift, b + shift, *rest) for n, a, b, *rest in items]


def dropped() -> int:
    """Spans not stored because the store was full."""
    return _dropped


def reset() -> None:
    """Forget every stored span, the dropped count and the clock anchor."""
    global _anchor, _dropped
    with _lock:
        _records.clear()
        _dropped = 0
        _anchor = None
