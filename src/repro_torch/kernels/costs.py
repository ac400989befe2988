"""The cost hook that code below the dry run reports through.

``launch/op_costs.OpCounter`` counts the aten ops dispatched under it.  Two
kinds of work need more than the dispatcher sees, and the code that does
them says so here:

  * a kernel wrapper runs its body under :func:`opaque` (its split table
    and output buffers are the kernel's, not ops to count) and adds the
    launch's own cost with :func:`record_kernel`;
  * work done for a mesh position other than the one that computes the
    step (another position's AdamW update, another runner's local pass)
    runs under :func:`elsewhere`: a counter keeps it out of that position's
    costs and peak memory and in its all-positions totals.

The state is per thread, as PyTorch's dispatch-mode stack is: a counter
entered in one thread sees nothing that another thread runs.
"""
from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()


def _state():
    st = _STATE.__dict__
    if not st:
        st.update(counters=[], paused=0, away=0)
    return st


def counters() -> list:
    """The counters entered in this thread, innermost last (a counter adds
    and removes itself)."""
    return _state()["counters"]


def paused() -> bool:
    """True inside an :func:`opaque` region."""
    return _state()["paused"] > 0


def away() -> bool:
    """True inside an :func:`elsewhere` region."""
    return _state()["away"] > 0


def counting() -> bool:
    """True when a counter would take a record now."""
    st = _state()
    return bool(st["counters"]) and not st["paused"]


@contextlib.contextmanager
def opaque():
    """Pause every counter of this thread: a kernel wrapper's body, whose
    ops are the kernel's and counted by its :func:`record_kernel`."""
    st = _state()
    st["paused"] += 1
    try:
        yield
    finally:
        st["paused"] -= 1


@contextlib.contextmanager
def elsewhere(flag: bool = True):
    """With ``flag``, mark the work inside as another mesh position's."""
    st = _state()
    st["away"] += bool(flag)
    try:
        yield
    finally:
        st["away"] -= bool(flag)


def record_kernel(name: str, *, flops: float, hbm_bytes: float) -> None:
    """Add one launch of kernel ``name`` to every counter of this thread;
    its operations are f32 FMAs outside the tensor cores, as the BS-CSR
    kernels' are.  Inside another wrapper's :func:`opaque` region it adds
    nothing: that wrapper's record holds it."""
    st = _state()
    if st["paused"]:
        return
    for counter in st["counters"]:
        counter.add_kernel(name, flops, hbm_bytes, here=not st["away"])
