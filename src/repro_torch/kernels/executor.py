"""Device-resident snapshot plane: pin streams once, dispatch with zero copies.

    host plane                      device plane                  dispatch
    ----------                      ------------                  --------
    PackedPartitions --pin once--> DeviceSnapshot ---tensors--> query fn
    (numpy arrays)     per (uid,    (fused words, or split        (kernel +
                        layout,      streams for the oracle,       finalize;
                        row map      + finalize tensors,           one per path,
                        key,         + a row map)                  Q bucket and
                        device)                                    signature)

* ``DeviceSnapshot`` uploads one immutable ``PackedPartitions``'s kernel
  streams and finalize tensors to the device exactly once, keyed by the
  snapshot's ``uid``; the entry dies with the host snapshot (weakref).
* ``QueryExecutor`` keeps one function per (path, Q bucket or
  ``("spmv", n_out)``, shape signature): the top-k query paths ("kernel",
  "reference") and the accumulate paths ("accumulate", "accumulate_ref")
  that the graph workloads step with.  PyTorch runs eagerly, so a "build"
  is only the first touch of a specialisation; ``fn_builds`` and
  ``retraces`` keep the reference's names and meaning.  The power-of-two Q
  bucket is only the cache key: the batch reaches the kernel unpadded (the
  kernel takes any Q, and padding would add stream passes of work for no
  saved compile).
* The sharded plane (``core/sharded.py``) serves a shard-local snapshot
  under the collection's ids: ``row_map=`` pins a local-to-global id map
  beside the snapshot (``row_map_key`` names its contents for that uid) and
  ``n_rows=`` swaps in the collection's row-id sentinel per call, so growth
  of the id space builds nothing.  ``evict_snapshot`` drops every pin of a
  snapshot (shard failover re-pins from the host copy).
* ``stream_layout="split"`` on a kernel path streams the snapshot's split
  arrays, fused on the fly; for a mixed-precision snapshot those are its
  exactly dequantized f32 twins (the reference's split-layout kernel input).
* A mixed-precision snapshot pins one tagged word tensor per width-class
  group (and its core indices), and its functions run each kernel once per
  group and scatter the per-core results back into core order.  The format
  codes and the groups' class names and cores are part of the signature,
  so a format reassignment counts as a retrace and benign ingest does not.
* ``h2d_copies`` counts the tensors uploaded at the pin boundary: the
  snapshot's kernel streams and finalize tensors (on a CPU executor the
  same uploads are counted, so the rule is testable there).  The query
  itself is per-call input, not snapshot state, and is not counted.  A
  steady-state dispatch adds 0 to it.
* Traced work (``utils/tracing.py``) records ``executor.prepare`` (with
  ``executor.pin`` and ``executor.build`` inside it when they happen),
  ``executor.launch`` (each core's k best; its ``walk`` attribute names the
  kernel walk: ``"single"``, ``"chunks1"`` or ``"rows"`` as
  ``multiquery_walk`` says, or ``"reference"``) and ``executor.finalize``
  (the merge into ``big_k``) for every top-k query path.
* One executor serves every thread of the process (a serving frontend
  dispatches from its own thread while callers query from theirs), so its
  caches and counters change under a lock; the query functions run outside
  it.
"""
from __future__ import annotations

import functools
import threading
import weakref
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import faults as faults_lib
from repro_torch.core.quantization import FORMATS
from repro_torch.kernels import ops
from repro_torch.kernels import ref as ref_lib
from repro_torch.launch.mesh import MeshArray
from repro_torch.utils import tracing
from repro_torch.kernels.bscsr_topk_spmv import (
    bscsr_spmv,
    bscsr_topk_spmv,
    bscsr_topk_spmv_multiquery,
    multiquery_walk,
    query_chunks,
    single_splits,
    spmv_split_table,
    spmv_splits,
    topk_splits,
)

PATHS = ("kernel", "reference", "accumulate", "accumulate_ref")

# (snapshot uid, pin layout, row map key, device) -> DeviceSnapshot; entries
# evicted when the host PackedPartitions is garbage collected (a lock-free
# pop: the collector may run inside a section that holds _CACHE_LOCK).
_DEVICE_CACHE: dict = {}
_CACHE_LOCK = threading.Lock()   # pins and evictions from any thread


def device_cache_size() -> int:
    return len(_DEVICE_CACHE)


def _cache_keys() -> set:
    with _CACHE_LOCK:
        return set(list(_DEVICE_CACHE))


def evict_snapshot(uid) -> int:
    """Drop every device pin of snapshot ``uid``; returns the pins dropped.

    Shard failover: the host ``PackedPartitions`` is intact but its device
    copies are suspect, so the next dispatch pins fresh ones.
    """
    with _CACHE_LOCK:
        stale = [key for key in list(_DEVICE_CACHE) if key[0] == uid]
        for key in stale:
            _DEVICE_CACHE.pop(key, None)
    return len(stale)


class DeviceSnapshot:
    """Device-pinned tensors of one immutable ``PackedPartitions`` snapshot.

    ``signature`` keys the executor's query functions: shapes, dtypes and
    static geometry (two snapshots with equal signatures share one).
    ``stream_layout`` is the pin's: "fused" (the native fused words, or a
    mixed snapshot's tagged groups), "split" (the oracle's three arrays) or
    "split-fused" (the split arrays fused into one F32 word stream: a mixed
    snapshot's f32 twins).  ``row_map`` rides in ``finalize``.
    """

    __slots__ = (
        "uid", "stream_layout", "device", "streams", "groups", "num_cores", "finalize",
        "signature", "max_slots", "block_size", "fmt_name", "uploads", "_split_tables",
    )

    def __init__(self, packed: ops.PackedPartitions, stream_layout: str, device,
                 row_map=None):
        self.uid = packed.uid
        self.stream_layout = stream_layout
        self.device = torch.device(device)
        self.num_cores = packed.num_cores
        # Mixed precision: one tagged word tensor per width class, with its
        # core indices; ``groups`` is None for one uniform stream.
        self.groups = None
        groups_meta = None
        if stream_layout == "fused" and ops.uses_groups(packed):
            self.groups = ops.group_tensors(packed, device)
            self.streams = tuple(words for _, _, words in self.groups)
            groups_meta = tuple((g.class_name, g.cores) for g in packed.groups)
        elif stream_layout in ("fused", "split-fused"):
            self.streams = (ops.host_tensor(ops.kernel_words(packed), device),)
        else:
            self.streams = ops.split_tensors(packed, device)
        self.finalize = ops.finalize_tensors(packed, device)
        if row_map is not None:
            self.finalize["row_map"] = ops.host_tensor(row_map, device)
        pinned = list(self.streams) + [
            t for t in self.finalize.values() if isinstance(t, torch.Tensor)
        ]
        if self.groups is not None:
            pinned += [cores for _, cores, _ in self.groups]
        self.uploads = len(pinned)
        self.max_slots = packed.max_slots
        self.block_size = packed.block_size
        self.fmt_name = packed.value_format.name
        self.signature = (
            stream_layout,
            tuple((tuple(t.shape), str(t.dtype)) for t in pinned),
            tuple(sorted(k for k, v in self.finalize.items()
                         if isinstance(v, torch.Tensor))),
            self.max_slots, self.block_size, self.fmt_name,
            packed.fmt_signature, groups_meta,
        )
        self._split_tables: dict = {}

    def split_table(self, packets_per_step: int, splits: int, group: int = 0):
        """The split table of fused stream ``group`` (all three kernels
        walk it), built on the device once per (T, S,
        group): no upload, and a fixed shape, so neither ``h2d_copies`` nor
        the signature moves.  A width-class group's rows lead with a header
        word, which the table skips."""
        key = (packets_per_step, splits) + (() if self.groups is None else (group,))
        table = self._split_tables.get(key)
        if table is None:
            table = spmv_split_table(self.streams[group], packets_per_step=packets_per_step,
                                     block_size=self.block_size, splits=splits,
                                     header=0 if self.groups is None else 1)
            self._split_tables[key] = table
        return table


def _pin(packed: ops.PackedPartitions, stream_layout: str, device, row_map,
         row_map_key) -> Tuple[DeviceSnapshot, bool]:
    """(snapshot, whether this call uploaded it)."""
    key = (packed.uid, stream_layout, row_map_key, str(torch.device(device)))
    with _CACHE_LOCK:
        snap = _DEVICE_CACHE.get(key)
        if snap is not None:
            return snap, False
        with tracing.span("executor.pin"):
            snap = DeviceSnapshot(packed, stream_layout, device, row_map=row_map)
        _DEVICE_CACHE[key] = snap
    weakref.finalize(packed, _DEVICE_CACHE.pop, key, None)
    return snap, True


def device_snapshot(packed: ops.PackedPartitions, stream_layout: str, device,
                    row_map=None, row_map_key=None) -> DeviceSnapshot:
    """The device-pinned form of ``packed``, uploading at most once per
    (uid, layout, row map key, device).  A given ``row_map_key`` must always
    name the same map contents for a given uid."""
    return _pin(packed, stream_layout, device, row_map, row_map_key)[0]


def _q_bucket(q: int) -> int:
    """Next power-of-two batch bucket: the cache key drifting Q shares."""
    return 1 << max(q - 1, 0).bit_length()


class QueryExecutor:
    """Query dispatch over device-resident snapshots.

    One executor per set of query knobs (big_k, k, T, gather, inner loop,
    device); ``get_executor`` interns them process-wide.
    ``path="reference"`` runs the torch oracle through the same plane.
    """

    def __init__(
        self,
        big_k: int,
        k: int = 8,
        packets_per_step: int = 2,
        gather_mode: str = "auto",
        inner_loop: str = "linear",
        device="cuda",
    ):
        self.big_k = big_k
        self.k = k
        self.packets_per_step = packets_per_step
        self.gather_mode = ops.resolve_gather_mode(gather_mode)
        self.inner_loop = inner_loop
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._lock = threading.Lock()   # caches and counters
        self._fns: dict = {}
        self._pinned: set = set()
        self._last_sig: dict = {}
        self.fn_builds = 0
        self.dispatches = 0
        self.retraces = 0
        self.q_bucket_hits = 0
        self.q_exact_hits = 0
        self.h2d_copies = 0

    def prepare(self, packed: ops.PackedPartitions, q=None, path: str = "kernel",
                stream_layout=None, row_map=None, row_map_key=None):
        """Resolve (query fn, device snapshot) without running.

        ``q`` is None for the single-query fn, the Q bucket for a batch, or
        ``("spmv", n_out)`` for the accumulate paths.  ``stream_layout``
        "split" makes a kernel path stream the split arrays fused (a mixed
        snapshot's f32 twins); ``row_map`` / ``row_map_key`` pin a
        local-to-global id map beside the snapshot.
        """
        with self._lock:
            return self._prepare(packed, q, path, stream_layout, row_map, row_map_key)

    def evict_snapshot(self, uid) -> int:
        """Module-level :func:`evict_snapshot`, dropped from this executor's
        pins as well; returns the pins dropped."""
        with self._lock:
            dropped = evict_snapshot(uid)
            self._pinned = {pin for pin in self._pinned if pin[0] != uid}
        return dropped

    def _prepare(self, packed: ops.PackedPartitions, q, path: str, stream_layout,
                 row_map, row_map_key):
        if path not in PATHS:
            raise ValueError(f"path must be one of {PATHS}, got {path!r}")
        if path in ("reference", "accumulate_ref"):
            layout = "split"
        elif stream_layout in (None, "fused"):
            layout = "fused"
        elif stream_layout == "split":
            layout = "split-fused"
        else:
            raise ValueError(f"stream_layout must be 'fused' or 'split', got {stream_layout!r}")
        pin = (packed.uid, layout, row_map_key, str(self.device))
        snap, fresh = _pin(packed, layout, self.device, row_map, row_map_key)
        if fresh:
            self.h2d_copies += snap.uploads
        if pin not in self._pinned:
            self._pinned &= _cache_keys()
            self._pinned.add(pin)
        key = (path, q, snap.signature)
        fn = self._fns.get(key)
        if fn is None:
            with _CACHE_LOCK:
                live = {s.signature for s in list(_DEVICE_CACHE.values())}
            self._fns = {k: f for k, f in self._fns.items() if k[2] in live}
            with tracing.span("executor.build"):
                fn = self._build(path, q, snap)
            self._fns[key] = fn
            self.fn_builds += 1
            prev = self._last_sig.get((path, q))
            if prev is not None and prev != snap.signature and prev not in live:
                self.retraces += 1
            self._last_sig[(path, q)] = snap.signature
        return fn, snap

    def _on_device(self, x) -> torch.Tensor:
        """The query as a float32 tensor on the executor's device."""
        if isinstance(x, torch.Tensor) and x.device == self.device:
            return x.to(torch.float32).contiguous()
        return torch.as_tensor(x, dtype=torch.float32).to(self.device).contiguous()

    @staticmethod
    def _finalize_inputs(snap: DeviceSnapshot, n_rows) -> dict:
        """The snapshot's finalize tensors, with the row-id sentinel swapped
        for ``n_rows`` (an int or a 0-d tensor on the device) when given."""
        return snap.finalize if n_rows is None else dict(snap.finalize, n_rows=n_rows)

    def query(self, x, packed: ops.PackedPartitions, path: str = "kernel",
              stream_layout=None, row_map=None, row_map_key=None,
              n_rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-``big_k`` (values, global rows) for one (M,) query."""
        x = self._on_device(x)
        if x.dim() != 1:
            raise ValueError(f"x must be an (M,) query, got {tuple(x.shape)}")
        with tracing.span("executor.prepare"), self._lock:
            fn, snap = self._prepare(packed, None, path, stream_layout, row_map,
                                     row_map_key)
            self.dispatches += 1
        return fn(x, snap, self._finalize_inputs(snap, n_rows))

    def query_batched(self, xs, packed: ops.PackedPartitions, path: str = "kernel",
                      stream_layout=None, row_map=None, row_map_key=None,
                      n_rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Q, big_k) answers for a (Q, M) batch, one pass over the stream."""
        xs = self._on_device(xs)
        if xs.dim() != 2 or xs.shape[0] == 0:
            raise ValueError(f"xs must be a non-empty (Q, M) batch, got {tuple(xs.shape)}")
        q = xs.shape[0]
        bucket = _q_bucket(q)
        with tracing.span("executor.prepare"), self._lock:
            builds_before = self.fn_builds
            fn, snap = self._prepare(packed, bucket, path, stream_layout, row_map,
                                     row_map_key)
            if self.fn_builds == builds_before:
                if bucket != q:
                    self.q_bucket_hits += 1
                else:
                    self.q_exact_hits += 1
            self.dispatches += 1
        return fn(xs, snap, self._finalize_inputs(snap, n_rows))

    def spmv(self, x, packed: ops.PackedPartitions, *, alpha, beta, y,
             path: str = "accumulate", resident: bool = False, stream_layout=None,
             row_map=None, row_map_key=None) -> torch.Tensor:
        """``alpha * A @ x + beta * y`` with the top-k select stage skipped.

        The iterative-workload dispatch: one accumulate launch plus the
        scatter epilogue per step.  ``y``'s length fixes the output row
        space and keys the function cache.  With ``resident`` every operand
        (x, alpha, beta, y) must already be a tensor on the executor's
        device, or the call raises instead of uploading it: the port's
        stand-in for the reference's host-to-device transfer guard.
        ``path="accumulate_ref"`` runs the torch oracle through the same plane.
        """
        if path not in ("accumulate", "accumulate_ref"):
            raise ValueError(f"spmv path must be 'accumulate' or 'accumulate_ref', "
                             f"got {path!r}")
        operands = {"x": x, "alpha": alpha, "beta": beta, "y": y}
        if resident:
            for name, t in operands.items():
                if not (isinstance(t, torch.Tensor) and t.device == self.device):
                    where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
                    raise RuntimeError(
                        f"spmv operand {name} is not resident on {self.device} "
                        f"(got {where}); a guarded loop uploads nothing")
        else:
            x, y = self._on_device(x), self._on_device(y)
        if x.dim() != 1 or y.dim() != 1:
            raise ValueError(f"x and y must be vectors, got {tuple(x.shape)} and "
                             f"{tuple(y.shape)}")
        with self._lock:
            fn, snap = self._prepare(packed, ("spmv", int(y.shape[0])), path, stream_layout,
                                     row_map, row_map_key)
            self.dispatches += 1
        return fn(x, alpha, beta, y, snap)

    def cache_info(self) -> dict:
        with self._lock:
            return self._cache_info()

    def _cache_info(self) -> dict:
        self._pinned &= _cache_keys()
        return {
            "compiled_fns": len(self._fns),
            "fn_builds": self.fn_builds,
            "retraces": self.retraces,
            "dispatches": self.dispatches,
            "q_bucket_hits": self.q_bucket_hits,
            "q_exact_hits": self.q_exact_hits,
            "device_snapshots": len(self._pinned),
            "device_snapshots_process_wide": device_cache_size(),
            "h2d_copies": self.h2d_copies,
        }

    def _build(self, path: str, q, snap: DeviceSnapshot):
        """The function for this (path, Q or spmv key, signature): the
        per-core top-k (``executor.launch``), then the merge of the c*k
        candidates into ``big_k`` (``executor.finalize``)."""
        big_k = self.big_k
        if path in ("accumulate", "accumulate_ref"):
            return self._build_spmv(path, q[1], snap, FORMATS[snap.fmt_name])
        local = self._build_local(path, q, snap)
        finalize = (ops.finalize_candidates if q is None
                    else ops.finalize_candidates_batched)

        def run(x, s: DeviceSnapshot, fin: dict):
            walk = ("reference" if path == "reference" else "single" if x.dim() == 1
                    else multiquery_walk(x.shape[0]))
            with tracing.span("executor.launch", walk=walk):
                lv, lr = local(x, s)
            with tracing.span("executor.finalize"):
                return finalize(lv, lr, big_k=big_k, **fin)

        return run

    def _build_local(self, path: str, q, snap: DeviceSnapshot):
        """``local(x, snapshot) -> (vals, slots)``: each core's k best."""
        k = self.k
        fmt = FORMATS[snap.fmt_name]
        if path == "reference":

            def local(x, s: DeviceSnapshot):
                xs = x[None] if q is None else x
                lv, lr = ops.reference_local_topk(
                    xs, *s.streams, s.finalize["rows_per_part"], s.max_slots, k, fmt)
                return (lv[:, 0], lr[:, 0]) if q is None else (lv, lr)

            return local

        t = self.packets_per_step
        kwargs = dict(k=k, n_rows=snap.max_slots, packets_per_step=t,
                      block_size=snap.block_size, inner_loop=self.inner_loop)

        def tables(s: DeviceSnapshot, x):
            """Each stream's split table at its own S (a group's core count):
            the single-query kernel's S for one query, the multi-query
            kernel's for a batch."""
            names = ([s.fmt_name] if s.groups is None
                     else [name for name, _, _ in s.groups])
            if x.dim() == 1:
                return [s.split_table(t, single_splits(
                    words.device, words.shape[0], packets_per_step=t, block_size=s.block_size,
                    m=x.shape[0], k=k, width=words.shape[2], fmt_name=name), i)
                    for i, (words, name) in enumerate(zip(s.streams, names))]
            q_chunk, n_chunks = query_chunks(x.shape[0], x.shape[1])
            return [s.split_table(t, topk_splits(words.device, words.shape[0], n_chunks,
                                                 packets_per_step=t, block_size=s.block_size,
                                                 m=x.shape[1], q_chunk=q_chunk, k=k,
                                                 width=words.shape[2], fmt_name=name), i)
                    for i, (words, name) in enumerate(zip(s.streams, names))]

        if snap.groups is not None:

            def local(x, s: DeviceSnapshot):
                return ops.grouped_local_topk(
                    x, s.groups, n_cores=s.num_cores, batched=q is not None,
                    tables=tables(s, x), gather_mode=self.gather_mode, **kwargs)

            return local

        kwargs["fmt_name"] = snap.fmt_name
        if q is None:

            def local(x, s: DeviceSnapshot):
                return bscsr_topk_spmv(x, s.streams[0], table=tables(s, x)[0],
                                       gather_mode=self.gather_mode, **kwargs)

            return local

        def local(x, s: DeviceSnapshot):
            return bscsr_topk_spmv_multiquery(x, s.streams[0], table=tables(s, x)[0],
                                              **kwargs)

        return local

    def _build_spmv(self, path: str, n_out: int, snap: DeviceSnapshot, fmt):
        """An accumulate step: slot sums, the masked scatter, alpha/beta.

        ``finalize_candidates`` never runs here; the masking lives in
        ``ops.scatter_slot_sums``.
        """
        if path == "accumulate_ref":

            def run(x, alpha, beta, y, s: DeviceSnapshot):
                sums = ref_lib.bscsr_slot_sums_stacked(*s.streams, x, s.max_slots, fmt)
                return ops.accumulate_epilogue(sums, s.finalize, n_out, alpha, beta, y)

            return run

        t = self.packets_per_step
        kwargs = dict(packets_per_step=t, block_size=snap.block_size,
                      gather_mode=self.gather_mode, inner_loop=self.inner_loop)

        def tables(s: DeviceSnapshot, x):
            """Each stream's split table at its own S (a group's core count)."""
            return [s.split_table(t, spmv_splits(words.device, words.shape[0],
                                                 packets_per_step=t, block_size=s.block_size,
                                                 m=x.shape[0]), i)
                    for i, words in enumerate(s.streams)]

        if snap.groups is not None:

            def run(x, alpha, beta, y, s: DeviceSnapshot):
                sums = ops.grouped_slot_sums(x, s.groups, n_cores=s.num_cores,
                                             n_rows=s.max_slots, tables=tables(s, x),
                                             **kwargs)
                return ops.accumulate_epilogue(sums, s.finalize, n_out, alpha, beta, y)

            return run

        def run(x, alpha, beta, y, s: DeviceSnapshot):
            sums = bscsr_spmv(x, s.streams[0], n_rows=s.max_slots, fmt_name=s.fmt_name,
                              table=tables(s, x)[0], **kwargs)
            return ops.accumulate_epilogue(sums, s.finalize, n_out, alpha, beta, y)

        return run


def position_split_table(cache: dict, pos, words: torch.Tensor, splits: int, *,
                         packets_per_step: int, block_size: int):
    """The split table of the words pinned at mesh position ``pos``, cached
    in ``cache`` by (position, words tensor): a ship swaps a new tensor in
    at the position, so its tables are rebuilt, and words other than the
    cached ones never walk a stale table."""
    cached = cache.get(pos)
    if cached is None or cached[0] is not words:
        cached = cache[pos] = (words, {})
    table = cached[1].get(splits)
    if table is None:
        table = cached[1][splits] = spmv_split_table(
            words, packets_per_step=packets_per_step, block_size=block_size, splits=splits)
    return table


def local_topk(x: torch.Tensor, words: torch.Tensor, table_cache: dict, pos, *, k: int,
               n_rows: int, packets_per_step: int, block_size: int, fmt_name: str,
               inner_loop: str, gather_mode: str):
    """Per-core top-k of the cores pinned at mesh position ``pos``: an (M,)
    query through the single-query kernel, a (Q, M) batch through the
    multi-query kernel, each on its split table (``position_split_table``)."""
    t, cores = packets_per_step, words.shape[0]
    kw = dict(k=k, n_rows=n_rows, packets_per_step=t, fmt_name=fmt_name,
              block_size=block_size, inner_loop=inner_loop)
    if x.dim() == 2:
        q_chunk, n_chunks = query_chunks(x.shape[0], x.shape[1])
        splits = topk_splits(words.device, cores, n_chunks, packets_per_step=t,
                             block_size=block_size, m=x.shape[1], q_chunk=q_chunk, k=k,
                             width=words.shape[2], fmt_name=fmt_name)
        table = position_split_table(table_cache, pos, words, splits, packets_per_step=t,
                                     block_size=block_size)
        return bscsr_topk_spmv_multiquery(x, words, table=table, **kw)
    splits = single_splits(words.device, cores, packets_per_step=t, block_size=block_size,
                           m=x.shape[0], k=k, width=words.shape[2], fmt_name=fmt_name)
    table = position_split_table(table_cache, pos, words, splits, packets_per_step=t,
                                 block_size=block_size)
    return bscsr_topk_spmv(x, words, table=table, gather_mode=gather_mode, **kw)


class ShardedDeviceBundle:
    """Per-shard host blocks pinned at every position of their mesh column,
    as :class:`~repro_torch.launch.mesh.MeshArray` s: the multi-position
    analogue of the device pin.

    Each *family* (one named array the mesh dispatch takes: word streams,
    slot maps, live-slot counts, tombstone bitmaps, id maps) is a list of
    per-shard host blocks along a leading shard dim.  ``sync`` ships shard
    ``s``'s block to every position of its column (all replicas) ONLY when
    that shard's version changed, and, when per-partition mutation stamps
    are given and the block shape is unchanged, ships only the *dirty
    partitions* (the COW stamps say which).  Steady-state queries then
    dispatch against the cached pieces with no host-to-device copy.

    Pieces are keyed by mesh position, never by device: positions that
    share a card each keep their own pin.  A piece is never written in
    place: a dirty ship scatters into a new tensor (``index_copy``) and
    swaps it in, so a query that took the old pieces reads the old bytes.

    Shipped-byte accounting is per shard (``shard_uploads`` /
    ``shard_bytes``) plus global counters, counted as the reference counts
    them (one upload per position placed); ``counters()`` surfaces them.
    """

    def __init__(self, mesh, shard_axis: str = "shard"):
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.n_shards = int(mesh.shape[shard_axis])
        ax = mesh.axis_names.index(shard_axis)
        # position -> the shard whose block it holds
        self._devmap = {pos: pos[ax] for pos in mesh.positions()}
        self._fams: dict = {}
        self.uploads = 0
        self.host_bytes_shipped = 0
        self.partitions_shipped = 0
        self.shard_uploads = [0] * self.n_shards
        self.shard_bytes = [0] * self.n_shards

    def _count(self, s, nbytes: int) -> None:
        self.uploads += 1
        self.host_bytes_shipped += int(nbytes)
        if s is not None:
            self.shard_uploads[s] += 1
            self.shard_bytes[s] += int(nbytes)

    def _put(self, arr: np.ndarray, pos) -> torch.Tensor:
        return ops.host_tensor(arr, self.mesh.device(pos)).reshape(arr.shape)

    def sync(self, name: str, block_shape: tuple, dtype, blocks_fn, versions,
             stamps=None):
        """The family's :class:`MeshArray`, shipping only what changed.

        ``blocks_fn(s)`` materialises shard ``s``'s host block (only called
        for shards whose version moved).  ``stamps[s]`` (optional) enables
        partition-granular updates along the block's leading dim.  A
        ``block_shape`` change (a common bucket doubled) rebuilds the family
        outright.
        """
        n = self.n_shards
        versions = list(versions)
        gshape = (n,) + tuple(block_shape)
        np_dtype = np.dtype(dtype)
        fam = self._fams.get(name)
        if fam is None or fam["gshape"] != gshape or fam["dtype"] != np_dtype:
            blocks = [np.ascontiguousarray(blocks_fn(s)).astype(np_dtype, copy=False)
                      for s in range(n)]
            pieces = {}
            for pos, s in self._devmap.items():
                pieces[pos] = self._put(blocks[s], pos)
                self._count(s, blocks[s].nbytes)
            fam = {
                "gshape": gshape, "dtype": np_dtype, "pieces": pieces,
                "versions": versions,
                "stamps": [None if stamps is None or stamps[s] is None
                           else np.array(stamps[s]) for s in range(n)],
            }
            fam["global"] = MeshArray(gshape, np_dtype, pieces)
            self._fams[name] = fam
            return fam["global"]

        pieces = dict(fam["pieces"])
        changed = False
        for s in range(n):
            if fam["versions"][s] == versions[s]:
                continue
            blk = np.ascontiguousarray(blocks_fn(s)).astype(np_dtype, copy=False)
            # A crash past this point leaves this shard's version marker
            # unmoved (it advances only after every piece is placed), so the
            # next sync re-ships the shard; pieces are replaced, never
            # written, so a re-ship is safe.
            faults_lib.fault_point("bundle.scatter")
            st_old = fam["stamps"][s]
            st_new = (None if stamps is None or stamps[s] is None
                      else np.asarray(stamps[s]))
            dirty = None
            if st_old is not None and st_new is not None and st_old.shape == st_new.shape:
                dirty = np.nonzero(st_new != st_old)[0]
            if dirty is not None and dirty.size == 0:
                pass  # version moved but every partition's bytes are current
            elif dirty is not None and dirty.size <= max(1, blk.shape[0] // 2):
                rows = np.ascontiguousarray(blk[dirty])
                nb = ops.pow2_bucket(int(dirty.size))
                if nb != dirty.size:
                    # Pad the scatter to a power-of-two width by REPEATING
                    # the first dirty index (the padded rows carry that same
                    # partition's data), as the reference does.
                    pad = nb - dirty.size
                    idxp = np.concatenate([dirty, np.full(pad, dirty[0])]).astype(np.int32)
                    rows = np.concatenate([rows, np.repeat(rows[:1], pad, axis=0)])
                else:
                    idxp = dirty.astype(np.int32)
                for pos, sb in self._devmap.items():
                    if sb != s:
                        continue
                    di = self._put(idxp, pos).long()
                    pieces[pos] = pieces[pos].index_copy(0, di, self._put(rows, pos))
                    self._count(s, idxp.nbytes + rows.nbytes)
                self.partitions_shipped += int(dirty.size)
            else:
                for pos, sb in self._devmap.items():
                    if sb != s:
                        continue
                    pieces[pos] = self._put(blk, pos)
                    self._count(s, blk.nbytes)
                if dirty is not None:
                    self.partitions_shipped += int(dirty.size)
            fam["pieces"] = pieces      # a new dict: earlier MeshArrays keep theirs
            fam["versions"][s] = versions[s]
            fam["stamps"][s] = st_new
            changed = True
        if changed:
            fam["global"] = MeshArray(gshape, np_dtype, fam["pieces"])
        return fam["global"]

    def sync_replicated(self, name: str, value: np.ndarray, version):
        """A fully replicated :class:`MeshArray` (one piece at every
        position) for small metadata such as the global row-id sentinel."""
        value = np.asarray(value)
        fam = self._fams.get(name)
        if fam is not None and fam["versions"] == [version] and fam["gshape"] == value.shape:
            return fam["global"]
        pieces = {}
        for pos in self._devmap:
            pieces[pos] = self._put(value, pos)
            self._count(None, value.nbytes)
        fam = {"gshape": value.shape, "dtype": value.dtype, "pieces": pieces,
               "versions": [version], "stamps": []}
        fam["global"] = MeshArray(value.shape, value.dtype, pieces)
        self._fams[name] = fam
        return fam["global"]

    def counters(self) -> dict:
        return {
            "uploads": self.uploads,
            "host_bytes_shipped": self.host_bytes_shipped,
            "partitions_shipped": self.partitions_shipped,
            "per_shard": [{"uploads": u, "bytes_shipped": b}
                          for u, b in zip(self.shard_uploads, self.shard_bytes)],
        }


def get_executor(big_k: int, k: int = 8, packets_per_step: int = 2,
                 gather_mode: str = "auto", inner_loop: str = "linear",
                 device="cuda") -> QueryExecutor:
    """Process-wide interned executor for one set of query knobs."""
    return _interned_executor(big_k, k, packets_per_step,
                              ops.resolve_gather_mode(gather_mode), inner_loop,
                              str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _interned_executor(big_k, k, packets_per_step, gather_mode, inner_loop, device
                       ) -> QueryExecutor:
    return QueryExecutor(big_k=big_k, k=k, packets_per_step=packets_per_step,
                         gather_mode=gather_mode, inner_loop=inner_loop, device=device)
