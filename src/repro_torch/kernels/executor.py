"""Device-resident snapshot plane: pin streams once, dispatch with zero copies.

    host plane                      device plane                  dispatch
    ----------                      ------------                  --------
    PackedPartitions --pin once--> DeviceSnapshot ---tensors--> query fn
    (numpy arrays)     per (uid,    (fused words, or split        (kernel +
                        layout,      streams for the oracle,       finalize;
                        device)      + finalize tensors)           one per path,
                                                                   Q bucket and
                                                                   signature)

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

import torch

from repro_torch.core.quantization import FORMATS
from repro_torch.kernels import ops
from repro_torch.kernels import ref as ref_lib
from repro_torch.kernels.bscsr_topk_spmv import (
    bscsr_spmv,
    bscsr_topk_spmv,
    bscsr_topk_spmv_multiquery,
    query_chunks,
    single_splits,
    spmv_split_table,
    spmv_splits,
    topk_splits,
)

PATHS = ("kernel", "reference", "accumulate", "accumulate_ref")

# (snapshot uid, stream layout, device) -> DeviceSnapshot; entries evicted
# when the host PackedPartitions is garbage collected.
_DEVICE_CACHE: dict = {}


def device_cache_size() -> int:
    return len(_DEVICE_CACHE)


class DeviceSnapshot:
    """Device-pinned tensors of one immutable ``PackedPartitions`` snapshot.

    ``signature`` keys the executor's query functions: shapes, dtypes and
    static geometry (two snapshots with equal signatures share one).
    """

    __slots__ = (
        "uid", "stream_layout", "device", "streams", "groups", "num_cores", "finalize",
        "signature", "max_slots", "block_size", "fmt_name", "uploads", "_split_tables",
    )

    def __init__(self, packed: ops.PackedPartitions, stream_layout: str, device):
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
        elif stream_layout == "fused":
            self.streams = (ops.host_tensor(ops.kernel_words(packed), device),)
        else:
            self.streams = ops.split_tensors(packed, device)
        self.finalize = ops.finalize_tensors(packed, device)
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


def device_snapshot(packed: ops.PackedPartitions, stream_layout: str, device
                    ) -> DeviceSnapshot:
    """The device-pinned form of ``packed``, uploading at most once per uid."""
    key = (packed.uid, stream_layout, str(torch.device(device)))
    snap = _DEVICE_CACHE.get(key)
    if snap is None:
        snap = DeviceSnapshot(packed, stream_layout, device)
        _DEVICE_CACHE[key] = snap
        weakref.finalize(packed, _DEVICE_CACHE.pop, key, None)
    return snap


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

    def prepare(self, packed: ops.PackedPartitions, q=None, path: str = "kernel"):
        """Resolve (query fn, device snapshot) without running.

        ``q`` is None for the single-query fn, the Q bucket for a batch, or
        ``("spmv", n_out)`` for the accumulate paths.
        """
        with self._lock:
            return self._prepare(packed, q, path)

    def _prepare(self, packed: ops.PackedPartitions, q, path: str):
        if path not in PATHS:
            raise ValueError(f"path must be one of {PATHS}, got {path!r}")
        layout = "split" if path in ("reference", "accumulate_ref") else "fused"
        pin = (packed.uid, layout, str(self.device))
        fresh = pin not in _DEVICE_CACHE
        snap = device_snapshot(packed, layout, self.device)
        if fresh:
            self.h2d_copies += snap.uploads
        if pin not in self._pinned:
            self._pinned &= set(_DEVICE_CACHE.keys())
            self._pinned.add(pin)
        key = (path, q, snap.signature)
        fn = self._fns.get(key)
        if fn is None:
            live = {s.signature for s in list(_DEVICE_CACHE.values())}
            self._fns = {k: f for k, f in self._fns.items() if k[2] in live}
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

    def query(self, x, packed: ops.PackedPartitions, path: str = "kernel"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-``big_k`` (values, global rows) for one (M,) query."""
        x = self._on_device(x)
        if x.dim() != 1:
            raise ValueError(f"x must be an (M,) query, got {tuple(x.shape)}")
        with self._lock:
            fn, snap = self._prepare(packed, None, path)
            self.dispatches += 1
        return fn(x, snap)

    def query_batched(self, xs, packed: ops.PackedPartitions, path: str = "kernel"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Q, big_k) answers for a (Q, M) batch, one pass over the stream."""
        xs = self._on_device(xs)
        if xs.dim() != 2 or xs.shape[0] == 0:
            raise ValueError(f"xs must be a non-empty (Q, M) batch, got {tuple(xs.shape)}")
        q = xs.shape[0]
        bucket = _q_bucket(q)
        with self._lock:
            builds_before = self.fn_builds
            fn, snap = self._prepare(packed, bucket, path)
            if self.fn_builds == builds_before:
                if bucket != q:
                    self.q_bucket_hits += 1
                else:
                    self.q_exact_hits += 1
            self.dispatches += 1
        return fn(xs, snap)

    def spmv(self, x, packed: ops.PackedPartitions, *, alpha, beta, y,
             path: str = "accumulate", resident: bool = False) -> torch.Tensor:
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
            fn, snap = self._prepare(packed, ("spmv", int(y.shape[0])), path)
            self.dispatches += 1
        return fn(x, alpha, beta, y, snap)

    def cache_info(self) -> dict:
        with self._lock:
            return self._cache_info()

    def _cache_info(self) -> dict:
        self._pinned &= set(_DEVICE_CACHE.keys())
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
        """The function for this (path, Q or spmv key, signature)."""
        big_k, k = self.big_k, self.k
        fmt = FORMATS[snap.fmt_name]
        if path in ("accumulate", "accumulate_ref"):
            return self._build_spmv(path, q[1], snap, fmt)
        finalize = (ops.finalize_candidates if q is None
                    else ops.finalize_candidates_batched)
        if path == "reference":

            def run(x, s: DeviceSnapshot):
                xs = x[None] if q is None else x
                lv, lr = ops.reference_local_topk(
                    xs, *s.streams, s.finalize["rows_per_part"], s.max_slots, k, fmt)
                if q is None:
                    lv, lr = lv[:, 0], lr[:, 0]
                return finalize(lv, lr, big_k=big_k, **s.finalize)

            return run

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
            q_chunk, n_chunks = query_chunks(x.shape[0])
            return [s.split_table(t, topk_splits(words.device, words.shape[0], n_chunks,
                                                 packets_per_step=t, block_size=s.block_size,
                                                 m=x.shape[1], q_chunk=q_chunk, k=k), i)
                    for i, words in enumerate(s.streams)]

        if snap.groups is not None:

            def run(x, s: DeviceSnapshot):
                lv, lr = ops.grouped_local_topk(
                    x, s.groups, n_cores=s.num_cores, batched=q is not None,
                    tables=tables(s, x), gather_mode=self.gather_mode, **kwargs)
                return finalize(lv, lr, big_k=big_k, **s.finalize)

            return run

        kwargs["fmt_name"] = snap.fmt_name
        if q is None:

            def run(x, s: DeviceSnapshot):
                lv, lr = bscsr_topk_spmv(x, s.streams[0], table=tables(s, x)[0],
                                         gather_mode=self.gather_mode, **kwargs)
                return finalize(lv, lr, big_k=big_k, **s.finalize)

            return run

        def run(x, s: DeviceSnapshot):
            lv, lr = bscsr_topk_spmv_multiquery(x, s.streams[0], table=tables(s, x)[0],
                                                **kwargs)
            return finalize(lv, lr, big_k=big_k, **s.finalize)

        return run

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
