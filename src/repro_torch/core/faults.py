"""Deterministic fault injection for the serving plane.

Crash-safety claims ("the previous snapshot keeps serving until the single
atomic swap", "recovery = last checkpoint + WAL tail") are only as good as
the failure schedule they were tested under.  This module makes that
schedule *deterministic*: the mutation, refresh, checkpoint and dispatch
paths call :func:`fault_point` at every point where a crash would be
interesting, and a :class:`FaultPlan` armed around the operation kills the
process-equivalent (raises :class:`FaultInjected`) at exactly the requested
hit of exactly the requested point.  Tests iterate ``INJECTION_POINTS`` and
assert that after *any* kill (a) the in-memory snapshot is never torn — the
pre-fault snapshot answers bit-identically — and (b) the on-disk state
recovers to bit-identical answers (tests/test_torch_serving.py).

No plan armed means zero overhead beyond a module-global ``None`` check, so
the hooks stay in production code paths permanently.

A copy of the reference's ``repro/core/faults.py`` with the same registered
points.  ``dispatch.shard`` fires in ``ShardedTopKSpMVIndex``'s per-shard
dispatch (the failover path); ``bundle.scatter`` in
``kernels.executor.ShardedDeviceBundle.sync`` (the mesh dispatch), before a
changed shard's bytes move.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

#: Every registered injection point, in dataflow order.  ``fault_point``
#: rejects unknown names so a typo cannot silently disarm a test.
INJECTION_POINTS: Tuple[str, ...] = (
    # MutableTopKSpMVIndex._refresh: dirty partitions re-padded / re-fused,
    # before the COW buffer lease rewrites mutated rows.
    "refresh.cow_rewrite",
    # MutableTopKSpMVIndex._refresh: the fresh snapshot is fully assembled,
    # one assignment away from becoming the served snapshot.
    "refresh.swap",
    # MutableTopKSpMVIndex.compact: live rows re-encoded, before any index
    # state is overwritten.
    "compact.swap",
    # WriteAheadLog.append: the record header and HALF the payload are on
    # disk (a torn record the replay must detect and truncate).
    "wal.append",
    # Checkpoint writer: arrays.npz written into the tmp dir, manifest not.
    "checkpoint.write",
    # Checkpoint writer: tmp dir fully written and renamed, the CURRENT
    # pointer still names the previous checkpoint.
    "checkpoint.rename",
    # ShardedTopKSpMVIndex._per_shard_query: about to dispatch one shard's
    # compiled query fn (the failover trigger).
    "dispatch.shard",
    # ShardedDeviceBundle.sync: a shard's changed block is about to scatter
    # to its device — some families updated, others not yet.
    "bundle.scatter",
)

_STATE = threading.local()


class FaultInjected(RuntimeError):
    """The deterministic stand-in for a crash / transient dispatch failure.

    Carries which point fired and at which hit, so tests can assert the
    schedule executed as planned.
    """

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected fault at {point!r} (hit {hit})")
        self.point = point
        self.hit = hit


class FaultPlan:
    """Arm a deterministic kill schedule: ``{point_name: hit_index}``.

    While the plan is active (as a context manager), the ``hit_index``-th
    execution (0-based) of each named :func:`fault_point` raises
    :class:`FaultInjected`.  Hits are counted per plan, so the same plan
    object re-armed starts a fresh schedule.  ``fired`` records every
    injection that actually happened; ``hits`` the observed per-point
    counts (useful to discover how often a point runs in a scenario).
    """

    def __init__(self, kill_at: Optional[Dict[str, int]] = None):
        for name in (kill_at or {}):
            if name not in INJECTION_POINTS:
                raise ValueError(
                    f"unknown fault point {name!r}; registered points: "
                    f"{INJECTION_POINTS}"
                )
        self.kill_at = dict(kill_at or {})
        self.hits: Dict[str, int] = {}
        self.fired: List[Tuple[str, int]] = []

    def __enter__(self) -> "FaultPlan":
        self.hits = {}
        self.fired = []
        if getattr(_STATE, "plan", None) is not None:
            raise RuntimeError("a FaultPlan is already armed on this thread")
        _STATE.plan = self
        return self

    def __exit__(self, *exc) -> bool:
        _STATE.plan = None
        return False

    def note(self, name: str) -> None:
        hit = self.hits.get(name, 0)
        self.hits[name] = hit + 1
        if self.kill_at.get(name) == hit:
            self.fired.append((name, hit))
            raise FaultInjected(name, hit)


def active_plan() -> Optional[FaultPlan]:
    return getattr(_STATE, "plan", None)


def fault_point(name: str) -> None:
    """Declare an injection point; no-op unless a matching plan is armed."""
    plan = getattr(_STATE, "plan", None)
    if plan is None:
        return
    if name not in INJECTION_POINTS:
        raise ValueError(f"unregistered fault point {name!r}")
    plan.note(name)
