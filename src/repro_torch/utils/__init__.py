"""Utilities shared by the port's serving plane."""
from repro_torch.utils.watchdog import DeadlineExceeded, Watchdog

__all__ = ["DeadlineExceeded", "Watchdog"]
