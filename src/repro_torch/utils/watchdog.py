"""Wall-clock watchdog for serving deadlines.

A context manager arming a daemon timer for ``timeout_s`` (a copy of the
reference's ``repro/utils/watchdog.py``).  A Python thread cannot interrupt
an in-flight CUDA launch, so the watchdog has two modes: a callback fired
*from the timer thread* when the deadline passes, and — for request
deadlines — ``raise_on_timeout``, which raises :class:`DeadlineExceeded` in
the calling thread as soon as the guarded block finishes, so an overdue
result is never returned to the caller.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional


class DeadlineExceeded(TimeoutError):
    """The guarded operation outlived its wall-clock budget."""


class Watchdog:
    """Flags (and optionally raises) when a guarded block exceeds a timeout.

    ``timeout_s <= 0`` disables the watchdog entirely (no timer thread).
    ``fired`` is readable mid-block for cooperative cancellation points;
    :meth:`check` raises on it.
    """

    def __init__(
        self,
        timeout_s: float,
        on_timeout: Optional[Callable] = None,
        raise_on_timeout: bool = False,
    ):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self.raise_on_timeout = raise_on_timeout
        self._timer: Optional[threading.Timer] = None
        self.fired = False

    def _fire(self) -> None:
        self.fired = True
        if self.on_timeout is not None:
            self.on_timeout()

    def check(self) -> None:
        """Cooperative cancellation point: raise if the deadline passed."""
        if self.fired:
            raise DeadlineExceeded(
                f"deadline of {self.timeout_s}s exceeded"
            )

    def __enter__(self) -> "Watchdog":
        if self.timeout_s > 0:
            self._timer = threading.Timer(self.timeout_s, self._fire)
            self._timer.daemon = True
            self._timer.start()
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        if self._timer is not None:
            self._timer.cancel()
        if self.raise_on_timeout and exc_type is None:
            self.check()
        return False
