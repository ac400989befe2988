"""Operation counts of the port's eager ops: ``launch/hlo_costs.py``'s counterpart.

The reference re-derives its roofline inputs from compiled HLO text.  The
port has no HLO: the aten ops that PyTorch dispatches are what runs on the
card.  :class:`OpCounter` is a ``TorchDispatchMode`` that counts every aten
op dispatched under it, on any device (``meta`` for a dry run, ``cuda`` for
a real step, ``cpu`` in the tests):

  * FLOPs: every matrix product (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    ``mv``, ``dot``: what ``matmul``, ``linear`` and ``einsum`` decompose
    into) counts 2 * prod(result dims) * the contracted dim, the formula of
    ``torch.utils.flop_counter``'s registry and of the reference's ``dot``.
    Products whose operands are float32 are also counted apart as
    ``flops_f32``: on an H100 they run outside the tensor cores, at 67
    TFLOP/s against 989 for bf16 (``analysis.py``).  Elementwise ops count
    no FLOPs, as in the reference.
  * HBM bytes: operand + result bytes of every op that materializes a
    result.  Views (every op whose schema returns an alias of an input:
    ``view``, ``reshape`` without a copy, ``expand``, ``t``, ``select``,
    ``slice``, ...), ``empty*`` and ``arange`` move nothing, like the
    reference's ``FREE_OPS``.  A broadcast operand counts its distinct
    elements once.  The reference's two refinements hold: gather, index and
    slice copies read about their result (2 x result bytes), and an
    in-place write of an update into a larger buffer (``copy_``,
    ``index_put_``, ``index_copy_``, the scatters: the KV-cache insert)
    costs 2 x the update, not the whole buffer.
  * ``convert_bytes``: the bytes of dtype casts (``_to_copy``, ``copy_``
    across dtypes), also counted in ``hbm_bytes``, as the reference counts
    its ``convert`` ops.
  * Collectives: the port's ops hold none (a move between mesh positions is
    a ``.to()``), so ``coll_bytes`` and ``coll_breakdown`` stay 0 here;
    ``dryrun`` books the moves that the port's placement implies.
  * ``peak_temp_bytes``: the peak over the trace of the live bytes of the
    storages that the counted ops created (each storage once, views
    included; a storage leaves when it is freed).

**Trip counts.** A Python loop over layers or microbatches dispatches each
op as often as it runs, so the reference's while-loop trip counts
(``hlo_costs.py`` :199-204, :274-280) have nothing to do here: a loop of
10 products counts 10 products.

**Speed on ``meta``.**  PyTorch runs many ``meta`` kernels in Python
(~100-200 us an elementwise op).  A ``meta`` op's outputs depend only on
its inputs' shapes, strides and dtypes and its other arguments, so the
counter keeps each functional op's output layout by that signature and
makes the next call's outputs with ``torch.empty_strided`` (views,
in-place ops and random ops always run).  Counts are the same either way.

**The hand-written kernels.** The dispatcher cannot see inside a CUDA
launch.  Each kernel wrapper (``kernels/bscsr_topk_spmv.py``) runs its
body under ``kernels.costs.opaque()``, which pauses every counter of the
thread, and adds its own cost with ``kernels.costs.record_kernel`` on
``meta`` and ``cuda`` tensors, so a wrapper counts once however many
counters are active.

**Other mesh positions.** One process dispatches a mesh step's work for
every position.  Work that the port's code marks as another position's
(``kernels.costs.elsewhere()``: each other piece's AdamW update and bf16
rounding, each other runner's local top-k pass) goes into
``costs_all_positions()`` only; ``costs()`` and its ``peak_temp_bytes``
are the computing position's own.  Without such work the two are equal.
"""
from __future__ import annotations

import weakref
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import costs as hook
from repro_torch.launch.analysis import COLLECTIVES

aten = torch.ops.aten

# 2 * prod(result) * contracted dim; the contracted dim is the last of the
# first matrix operand (argument 1 for the add-forms).
_MATMUL = {aten.mm: 0, aten.bmm: 0, aten.mv: 0, aten.dot: 0, aten.addmm: 1,
           aten.baddbmm: 1, aten.addmv: 1}
# Ops that move no bytes besides the views: allocation without a write and
# the reference's iota.
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.arange, aten._unsafe_view, aten.lift_fresh,
         aten.detach, aten.alias}
# Reads about its result: 2 x result bytes.
_GATHER = {aten.gather, aten.index, aten.index_select, aten.embedding, aten.take,
           aten.narrow_copy, aten.slice_copy, aten.select_copy}
# An update written into a destination (the first tensor operand): 2 x the
# other operands' bytes.
_UPDATE = {aten.copy_, aten.index_put_, aten.index_put, aten._index_put_impl_,
           aten.index_copy_, aten.index_copy, aten.slice_scatter, aten.select_scatter,
           aten.scatter_, aten.scatter, aten.scatter_add_, aten.scatter_add,
           aten.index_add_, aten.index_add, aten.masked_scatter_, aten.masked_scatter}
# A workspace that the op's CUDA kernel leaves empty (on the CPU and meta it
# has the input's size): the output, or the argument, at this index moves
# nothing on the card, which is what the counts follow.
_CARD_EMPTY_OUT = {aten.log_sigmoid_forward: 1}
_CARD_EMPTY_IN = {aten.log_sigmoid_backward: 2}
# Writes its result and reads nothing.
_FILL = {aten.zero_, aten.fill_, aten.zeros, aten.zeros_like, aten.ones, aten.ones_like,
         aten.full, aten.full_like, aten.new_zeros, aten.new_ones, aten.new_full,
         aten.scalar_tensor}

_META_LAYOUTS: dict = {}            # (op, input signature) -> its outputs' layouts
_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
            torch.memory_format)


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` views (a broadcast dim, stride
    0, counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x, into=None) -> list:
    """The tensors in an op's arguments or outputs (tensors, lists and
    tuples of them, dicts of kwargs), in order."""
    into = [] if into is None else into
    if isinstance(x, torch.Tensor):
        into.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, into)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, into)
    return into


class _Uncacheable(Exception):
    pass


def _signature(x):
    """A hashable stand-in for an argument: a ``meta`` tensor's layout, a
    scalar, or a list of either; raises ``_Uncacheable`` otherwise."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _Uncacheable
        return (tuple(x.shape), tuple(x.stride()), x.dtype, x.storage_offset())
    if isinstance(x, _SCALARS):
        return (type(x), x)
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_signature(v) for v in x))
    raise _Uncacheable


_CACHEABLE: dict = {}
_ALIASING: dict = {}


def _cacheable(func) -> bool:
    """A functional op: no view, no write to an input, no randomness."""
    ok = _CACHEABLE.get(func)
    if ok is None:
        schema = func._schema
        ok = _CACHEABLE[func] = not (
            func.is_view or schema.is_mutable or func.overloadpacket in _FREE
            or any(r.alias_info is not None for r in schema.returns)
            or torch.Tag.nondeterministic_seeded in func.tags)
    return ok


def _run(func, args, kwargs):
    """``func(*args, **kwargs)``, on ``meta`` tensors from the layouts of an
    earlier call with the same signature where there was one."""
    if not _cacheable(func):
        return func(*args, **kwargs)
    try:
        key = (func, _signature(args), tuple((k, _signature(v)) for k, v in kwargs.items()))
    except _Uncacheable:
        return func(*args, **kwargs)
    layouts = _META_LAYOUTS.get(key)
    if layouts is None:
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if all(isinstance(t, torch.Tensor) and t.device.type == "meta" for t in outs):
            _META_LAYOUTS[key] = (isinstance(out, (tuple, list)), type(out),
                                  [(tuple(t.shape), tuple(t.stride()), t.dtype) for t in outs])
        return out
    many, kind, specs = layouts
    made = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
            for shape, stride, dtype in specs]
    return kind(made) if many else made[0]


def zero_costs() -> dict:
    """The reference's ``analyze`` keys, all 0, plus the port's own."""
    return {"flops": 0.0, "flops_f32": 0.0, "hbm_bytes": 0.0, "coll_bytes": 0.0,
            "convert_bytes": 0.0,
            "coll_breakdown": {c: {"count": 0.0, "bytes": 0.0} for c in COLLECTIVES},
            "ops": 0, "kernels": {}, "peak_temp_bytes": 0}


class OpCounter(TorchDispatchMode):
    """Counts the aten ops dispatched while it is entered.

    ``costs()`` returns the reference's keys (``flops``, ``hbm_bytes``,
    ``coll_bytes``, ``convert_bytes``, ``coll_breakdown``) with
    ``flops_f32``, ``ops`` (ops counted), ``kernels`` (each kernel
    wrapper's calls, FLOPs and bytes, inside the totals) and
    ``peak_temp_bytes``, for the work done here; ``costs_all_positions()``
    the same keys with the work marked ``elsewhere`` too.
    """

    def __init__(self):
        super().__init__()
        self._here = zero_costs()
        self._all = zero_costs()
        self._live: Dict[int, Tuple[int, bool]] = {}
        self._live_here = 0
        self._live_all = 0

    # -- the mode ---------------------------------------------------------
    def __enter__(self):
        hook.counters().append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        hook.counters().remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = _run(func, args, kwargs)
        if not hook.paused():
            self._count(func, args, kwargs, out, not hook.away())
        return out

    # -- counting -----------------------------------------------------------
    def _count(self, func, args, kwargs, out, here: bool) -> None:
        targets = (self._all, self._here) if here else (self._all,)
        for c in targets:
            c["ops"] += 1
        packet = func.overloadpacket
        if func.is_view or packet in _FREE:
            return
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if packet in _CARD_EMPTY_OUT:
            del outs[_CARD_EMPTY_OUT[packet]]
        if packet in _CARD_EMPTY_IN:
            ins = [t for t in ins if t is not args[_CARD_EMPTY_IN[packet]]]
        if not outs:
            return
        flops = flops_f32 = 0.0
        if packet in _MATMUL:
            a = args[_MATMUL[packet]]
            flops = 2.0 * outs[0].numel() * a.shape[-1]
            if a.dtype == torch.float32:
                flops_f32 = flops
        result = sum(t.numel() * t.element_size() for t in outs)
        if packet in _GATHER:
            nbytes = 2 * result
        elif packet in _UPDATE:
            nbytes = 2 * sum(tensor_bytes(t) for t in ins[1:])
        elif packet in _FILL:
            nbytes = result
        else:
            nbytes = result + sum(tensor_bytes(t) for t in ins)
        convert = 0
        if packet is aten._to_copy and ins and ins[0].dtype != outs[0].dtype:
            convert = nbytes
        elif packet is aten.copy_ and len(ins) > 1 and ins[0].dtype != ins[1].dtype:
            convert = nbytes
        for c in targets:
            c["flops"] += flops
            c["flops_f32"] += flops_f32
            c["hbm_bytes"] += nbytes
            c["convert_bytes"] += convert
        self._track(func, ins, outs, here)

    def _track(self, func, ins, outs, here: bool) -> None:
        """Add each new storage among ``outs`` to the live bytes until it is
        freed: to the all-positions bytes, and to this position's when the
        op ran ``here``."""
        aliasing = _ALIASING.get(func)
        if aliasing is None:
            aliasing = _ALIASING[func] = any(r.alias_info is not None
                                             for r in func._schema.returns)
        if aliasing:
            return                       # in place or a view: no new storage
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            nbytes = st.nbytes()
            self._live[key] = (nbytes, here)
            weakref.finalize(st, self._free, key)
            self._live_all += nbytes
            self._all["peak_temp_bytes"] = max(self._all["peak_temp_bytes"], self._live_all)
            if here:
                self._live_here += nbytes
                self._here["peak_temp_bytes"] = max(self._here["peak_temp_bytes"],
                                                    self._live_here)

    def _free(self, key: int) -> None:
        nbytes, here = self._live.pop(key, (0, False))
        self._live_all -= nbytes
        if here:
            self._live_here -= nbytes

    def add_kernel(self, name: str, flops: float, hbm_bytes: float, here: bool = True) -> None:
        for c in (self._all, self._here) if here else (self._all,):
            c["flops"] += flops
            c["flops_f32"] += flops
            c["hbm_bytes"] += hbm_bytes
            k = c["kernels"].setdefault(name, {"calls": 0, "flops": 0.0, "hbm_bytes": 0.0})
            k["calls"] += 1
            k["flops"] += flops
            k["hbm_bytes"] += hbm_bytes

    def costs(self) -> dict:
        """This position's costs: everything not marked ``elsewhere``."""
        return _copy(self._here)

    def costs_all_positions(self) -> dict:
        """Every position's costs: what the process dispatched."""
        return _copy(self._all)


def _copy(c: dict) -> dict:
    out = dict(c)
    out["coll_breakdown"] = {k: dict(v) for k, v in c["coll_breakdown"].items()}
    out["kernels"] = {k: dict(v) for k, v in c["kernels"].items()}
    return out


def count(fn, *args, **kwargs):
    """``(result, costs)`` of ``fn(*args, **kwargs)`` under a fresh counter."""
    with OpCounter() as counter:
        result = fn(*args, **kwargs)
    return result, counter.costs()
