"""Straggler and failure handling for the training loop.

The reference's ``repro/train/fault_tolerance.py``, ported.  The failure
modes: (a) a host dies -> restart from the latest checkpoint; (b) a step
hangs on a straggler -> the watchdog fires after ``timeout_s`` so the
launcher can kill and restart; (c) data loss -> impossible by construction,
batches are pure functions of (seed, step).
"""
from __future__ import annotations

from repro_torch.utils.watchdog import DeadlineExceeded, Watchdog

__all__ = ["DeadlineExceeded", "StepWatchdog", "StepTimer", "Watchdog"]


class StepWatchdog(Watchdog):
    """Fires (via callback, and ``fired``) if a step exceeds the timeout: the
    straggler guard.  The training face of the shared
    :class:`repro_torch.utils.watchdog.Watchdog`, which the serving plane arms
    as a per-request deadline."""


class StepTimer:
    """Rolling step-time stats; flags outlier steps (a soft straggler signal)."""

    def __init__(self, window: int = 20, outlier_factor: float = 3.0):
        self.window = window
        self.outlier_factor = outlier_factor
        self.times = []
        self.outliers = 0

    def record(self, dt: float) -> bool:
        is_outlier = False
        if len(self.times) >= 5:
            mean = sum(self.times) / len(self.times)
            if dt > self.outlier_factor * mean:
                self.outliers += 1
                is_outlier = True
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return is_outlier
