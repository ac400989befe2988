"""High-level Top-K SpMV API: build an index, query it, exact ground truth.

``TopKSpMVConfig.device`` takes the place of the reference's ``interpret``
knob: queries run on ``"cuda"`` (the hand-written kernels) unless the caller
asks for ``"cpu"`` (the kernels' plain versions).  Asking for ``"cuda"`` on
a machine without a card raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import adaptive as adaptive_lib
from repro_torch.core import bscsr as bscsr_lib
from repro_torch.core import faults as faults_lib
from repro_torch.core import partition as partition_lib
from repro_torch.core.precision_model import expected_precision, min_partitions_for_precision
from repro_torch.kernels import executor as executor_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as ref_lib
from repro_torch.core.quantization import F32, FORMATS, width_class_of


@dataclasses.dataclass(frozen=True)
class TopKSpMVConfig:
    """User-facing knobs; mirrors the paper's design space (Table II)."""

    big_k: int = 100               # K
    k: int = 8                     # per-core scratchpad size (paper: 8)
    num_partitions: Optional[int] = None   # c; None -> auto from precision target
    precision_target: float = 0.99
    block_size: int = 256          # B (nnz per tile-packet)
    value_format: str = "F32"      # F32 | BF16 | Q15 | Q7 (uniform)
    recall_target: Optional[float] = None  # per-partition mixed precision:
                                   # one ValueFormat per partition so predicted
                                   # quantization-induced recall@k vs exact
                                   # stays >= this target (overrides
                                   # value_format; see core/adaptive.py)
    calibration_queries: int = 16  # query sample size for the autotuner
    calibration_seed: int = 0      # deterministic per (seed, collection)
    packets_per_step: int = 2      # T
    gather_mode: str = "auto"      # take | onehot | auto: all served by one gather
    inner_loop: str = "linear"     # linear | legacy | linear-seg | linear-topk
    stream_layout: str = "fused"   # fused | split (the kernels read fused words)
    incremental_snapshots: bool = True  # mutable index: re-pad only mutated parts
    use_executor: bool = True      # device-resident snapshot plane
                                   # (False: per-call upload dispatch)
    cow_snapshots: bool = True     # mutable index: copy-on-write stacked buffers
                                   # (False: np.stack per refresh)
    parallel_compaction: bool = True  # compact(): re-encode partitions in a pool
    parallel_compaction_min_nnz: int = 100_000  # per-partition nnz below which
                                   # compact() stays serial
    churn_stable: bool = True      # mutable index: pad the churn-varying dims
                                   # (packets, slot-map width, tombstone length)
                                   # to power-of-two buckets, so ingest reuses
                                   # one executor signature per bucket
    device: str = "cuda"           # cuda (kernels) | cpu (plain versions)

    def resolve_partitions(self, n_rows: int) -> int:
        if self.num_partitions is not None:
            return self.num_partitions
        c = min_partitions_for_precision(
            n_rows, self.k, self.big_k, self.precision_target
        )
        return max(c, -(-self.big_k // self.k))

    def resolve_device(self) -> torch.device:
        """The query device; raises when a card is asked for and absent."""
        dev = torch.device(self.device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device {self.device!r} requested but no CUDA device is "
                    "available; pass device='cpu' to run the plain versions"
                )
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"device must be 'cuda' or 'cpu', got {self.device!r}")
        return dev


@dataclasses.dataclass(frozen=True)
class TopKSpMVIndex:
    """An immutable, queryable packed index over one embedding collection."""

    packed: kernel_ops.PackedPartitions
    config: TopKSpMVConfig
    format_plan: Optional[adaptive_lib.PartitionFormatPlan] = None

    @property
    def n_rows(self) -> int:
        return self.packed.plan.n_rows

    @property
    def expected_precision(self) -> float:
        return expected_precision(
            self.n_rows, self.packed.num_cores, self.config.k, self.config.big_k
        )


def _assign_formats(csr: bscsr_lib.CSRMatrix, num_partitions: int, config: TopKSpMVConfig):
    """(format plan, calibration) for ``config.recall_target`` over ``csr``."""
    return adaptive_lib.assign_partition_formats(
        csr, num_partitions, config.recall_target, k=config.k,
        n_queries=config.calibration_queries, seed=config.calibration_seed,
    )


def _quantized_planes(exact: list, formats) -> Tuple[list, list]:
    """Mixed precision: the native plane (each exact F32 stream re-quantized
    into its partition's format) and its f32 twins, both exact functions of
    ``exact`` and ``formats``."""
    native = [bscsr_lib.requantize_stream(e, FORMATS[f]) for e, f in zip(exact, formats)]
    return native, [bscsr_lib.dequantize_stream(n) for n in native]


def build_index(csr: bscsr_lib.CSRMatrix, config: TopKSpMVConfig) -> TopKSpMVIndex:
    """Pack a collection; with ``config.recall_target`` each partition gets
    the format ``adaptive.assign_partition_formats`` chooses for it."""
    c = config.resolve_partitions(csr.shape[0])
    fmt_plan = None
    value_formats = None
    if config.recall_target is not None:
        fmt_plan, _ = _assign_formats(csr, c, config)
        value_formats = fmt_plan.formats
    packed = kernel_ops.pack_partitions(
        csr,
        num_partitions=c,
        block_size=config.block_size,
        value_format=config.value_format,
        packets_multiple=config.packets_per_step,
        stream_layout=config.stream_layout,
        value_formats=value_formats,
    )
    return TopKSpMVIndex(packed=packed, config=config, format_plan=fmt_plan)


class MutableTopKSpMVIndex:
    """A live, serve-while-ingest index: base + per-partition delta segments.

    ``add_rows`` appends, ``replace_rows`` tombstones the old copy and
    appends the new one, ``delete_rows`` tombstones.  Updates are encoded as
    delta packets (``bscsr.encode_delta_rows``) and appended after the
    owning partition's stream (``bscsr.append_packets``); retired slots and
    deleted ids are masked in finalize (and in the accumulate scatter).  The
    kernels are untouched.  Every update batch swaps in a fresh immutable
    ``PackedPartitions`` under a ``version`` counter, so a query holding the
    previous snapshot keeps answering from it.

    Duck-types ``TopKSpMVIndex`` (``.packed`` / ``.config``).  With
    ``config.incremental_snapshots`` a refresh re-pads (and re-fuses) only
    the partitions that mutated; with ``config.cow_snapshots`` the stacking
    is copy-on-write (``kernel_ops.SnapshotBufferPool``).  With
    ``config.churn_stable`` the padded packet count, the slot-map width and
    the tombstone length are power-of-two buckets, so refreshes reuse one
    executor signature until a bucket doubles.

    With ``config.recall_target`` each partition has its own value format
    (mixed precision), and the index keeps three aligned planes of streams:
    ``_exact`` (F32, the source of truth), ``_native`` (each partition's
    format, which the tagged width-class groups stream) and ``_streams``
    (the native values exactly dequantized: the f32 twins the oracle and the
    pad/stack machinery read).  Refresh re-scores mutated partitions and only
    ever promotes; ``compact`` re-assigns every format.

    Crash safety: ``export_state`` / ``from_state`` round-trip the whole
    state (``core/persistence.py`` writes it to disk), and refresh and
    compact call ``faults.fault_point`` where a crash would be interesting.
    A fault anywhere before the one assignment that swaps in a snapshot
    leaves the previous snapshot serving bit for bit.
    """

    def __init__(self, csr: bscsr_lib.CSRMatrix, config: TopKSpMVConfig):
        self.config = config
        self._n_cols = csr.shape[1]
        self._fmt = FORMATS[config.value_format]
        c = config.resolve_partitions(csr.shape[0])
        self._plan = partition_lib.PartitionPlan.build(csr.shape[0], c)
        parts = partition_lib.partition_csr(csr, self._plan)
        # Mixed-precision planes (config.recall_target): _exact (F32), _native
        # (each partition's format) and _streams (the f32 twins), all with one
        # flags/cols structure, so slot bookkeeping ignores formats.
        self._part_fmts: Optional[list] = None
        self._calib: Optional[adaptive_lib.PrecisionCalibration] = None
        self._exact: Optional[list] = None
        self._native: Optional[list] = None
        self.last_refresh_promoted = 0
        if config.recall_target is not None:
            self._fmt = F32  # the split twin plane is uniformly f32
            fmt_plan, self._calib = _assign_formats(csr, c, config)
            self._part_fmts = list(fmt_plan.formats)
            self._exact = [bscsr_lib.encode_bscsr(p, config.block_size, F32) for p in parts]
            self._native, self._streams = _quantized_planes(self._exact, self._part_fmts)
        else:
            self._streams = [
                bscsr_lib.encode_bscsr(p, config.block_size, self._fmt) for p in parts
            ]
        self._base_packets = max(e.num_packets for e in self._streams)
        self._slots = [
            list(range(start, start + size))
            for start, size in zip(self._plan.row_starts, self._plan.rows_per_partition)
        ]
        self._loc = {
            gid: (ci, si)
            for ci, slots in enumerate(self._slots)
            for si, gid in enumerate(slots)
        }
        bounds = csr.indptr.tolist()
        self._rows = {
            gid: (csr.indices[a:b].astype(np.int32), csr.data[a:b])
            for gid, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))
        }
        self._deleted = bscsr_lib.TombstoneBitmap.empty(csr.shape[0])
        self._next_gid = csr.shape[0]
        self._live_nnz = csr.nnz
        self._delta_nnz = 0
        self._dead_nnz = 0
        self._tombstone_slots = 0
        self._version = -1
        self._packed: Optional[kernel_ops.PackedPartitions] = None
        self._live_csr_cache = None  # (version, (csr, gids))
        self._buffer_pool = kernel_ops.SnapshotBufferPool()
        self._stamp_counter = 0
        self._reset_padded_cache()
        self.last_refresh_repadded = 0   # partitions re-padded by the last refresh
        self.total_repadded = 0
        self.last_refresh_copied = 0     # partitions copied into the COW stack
        self.total_copied = 0
        self.last_refresh_group_copied = 0  # member streams copied into the
        self.total_group_copied = 0         # COW width-class group stacks
        self.last_compact_parallel = False
        self._refresh()

    def _reset_padded_cache(self) -> None:
        """Invalidate the per-partition padded-stream (+ fused words) cache."""
        c = len(self._streams)
        self._dirty = set(range(c))
        self._mutated = set()  # content-mutated since the last refresh
        self._padded_streams = [None] * c
        self._padded_words = [None] * c
        self._padded_max_p = -1
        # Churn-stable packet cap: anchored at the exact (step-aligned) count
        # on build/compact, bumped to power-of-two buckets by growth.
        self._packet_cap = -1
        # Mixed precision: one cap per width class (same anchor-then-bucket
        # rule) and the per-partition padded tagged words, ci -> (cap, fmt,
        # words).
        self._class_caps: Optional[dict] = None
        self._padded_tagged = [None] * c
        # All partitions' content is new: stamp them past every COW buffer.
        self._stamp_counter += 1
        self._part_stamps = np.full(c, self._stamp_counter, np.int64)

    def _mark_dirty(self, ci: int) -> None:
        """Record that partition ``ci``'s stream content changed."""
        self._dirty.add(ci)
        self._mutated.add(ci)
        self._stamp_counter += 1
        self._part_stamps[ci] = self._stamp_counter

    # -- snapshot bookkeeping ------------------------------------------------

    def _refresh(self, preserve_caps: bool = False) -> None:
        """Swap in a fresh immutable snapshot (bumps the version counter).

        ``preserve_caps`` is the checkpoint-restore mode: the churn-stable
        packet cap and width-class caps were restored verbatim from the
        saved state and are used as they are, so a recovered index keeps
        the crashed process's padded shapes and executor signature.

        Everything builds into locals; the served ``self._packed`` is
        replaced by one assignment at the end.  A fault before it (the
        ``refresh.cow_rewrite`` and ``refresh.swap`` points) leaves the
        previous snapshot serving bit for bit, and a retry (``refresh``)
        converges: the padded caches and COW leases depend only on the
        stream state, and a dropped lease is released with its snapshot.

        Only partitions whose stream mutated since the last snapshot are
        re-padded, unless the common packet count changed.  With
        ``churn_stable`` the packet cap is the exact step-aligned count at
        build/compact and jumps to the power-of-two bucket at the first
        mutation, so steady ingest after it changes the padded shapes only
        when a bucket doubles.  The padded tail is flag-free zero packets,
        which the kernels stream as a continuation of the open sentinel
        row.

        Mixed precision: mutated partitions are first re-scored against the
        stored calibration and the worst promoted up the byte ladder if the
        recall budget is breached (promote only, so benign upserts keep the
        format vector and the executor signature).  The tagged width-class
        groups pad to their own per-class caps, re-fuse only re-padded,
        re-capped or re-formatted partitions, and stack copy-on-write too.
        """
        hetero = self._part_fmts is not None
        # A mixed-precision snapshot never carries uniform fused words: its
        # fused plane is the tagged groups.
        fused = self.config.stream_layout == "fused" and not hetero
        mult = self.config.packets_per_step
        self.last_refresh_promoted = 0
        if hetero and self._mutated and self._calib is not None:
            mutated = {ci: self._partition_live_csr(ci) for ci in sorted(self._mutated)}
            new_fmts, promoted = adaptive_lib.refresh_partition_formats(
                self._part_fmts, self._calib, mutated
            )
            for ci, (old, new) in enumerate(zip(self._part_fmts, new_fmts)):
                if old != new:
                    # Re-quantized from the exact plane: slots, deltas and
                    # flags stay as they are.
                    self._native[ci] = bscsr_lib.requantize_stream(
                        self._exact[ci], FORMATS[new]
                    )
                    self._streams[ci] = bscsr_lib.dequantize_stream(self._native[ci])
            self._part_fmts = list(new_fmts)
            self.last_refresh_promoted = promoted
        self._mutated = set()
        max_p = max(e.num_packets for e in self._streams)
        max_p = max(-(-max_p // mult) * mult, mult)
        if self.config.churn_stable:
            if preserve_caps and self._packet_cap >= 0:
                pass                              # restore: the saved cap holds
            elif self._packet_cap < 0:
                self._packet_cap = max_p          # anchor refresh: exact
            else:                                 # mutation refresh: bucket
                self._packet_cap = max(
                    self._packet_cap, kernel_ops.bucket_packets(max_p, mult)
                )
            max_p = self._packet_cap
        if not self.config.incremental_snapshots or max_p != self._padded_max_p:
            dirty = set(range(len(self._streams)))
        else:
            dirty = self._dirty
        for ci in sorted(dirty):
            padded = bscsr_lib.pad_packets(self._streams[ci], max_p)
            self._padded_streams[ci] = padded
            self._padded_words[ci] = bscsr_lib.fuse_stream(padded) if fused else None
            # Its tagged words re-fuse in _refresh_groups, also on a retry
            # after a fault past the clearing of the dirty set.
            self._padded_tagged[ci] = None
        self._padded_max_p = max_p
        self._dirty = set()
        self.last_refresh_repadded = len(dirty)
        self.total_repadded += len(dirty)
        # Padded streams rebuilt and the dirty set cleared, stacked buffers
        # not yet written: a retry re-stacks from the same caches.
        faults_lib.fault_point("refresh.cow_rewrite")
        groups, fmt_codes, group_bufs, group_copied = None, None, [], 0
        if hetero:
            groups, group_bufs, group_copied = self._refresh_groups(mult, preserve_caps)
            fmt_codes = np.array([FORMATS[f].code for f in self._part_fmts], np.int32)

        num_slots = np.array([len(s) for s in self._slots], dtype=np.int32)
        width = max(int(num_slots.max()) if num_slots.size else 0, 1)
        tomb_len = max(self._next_gid, 1)
        if self.config.churn_stable:
            # Padded slot entries are INVALID_ROW and padded tombstone bits
            # are False: finalize masks the former and never reads the latter.
            width = kernel_ops.pow2_bucket(width)
            tomb_len = kernel_ops.pow2_bucket(tomb_len)
        slot_map = np.full((len(self._slots), width), bscsr_lib.INVALID_ROW,
                           dtype=np.int32)
        for ci, slots in enumerate(self._slots):
            if slots:
                slot_map[ci, : len(slots)] = np.asarray(slots, dtype=np.int32)
        self._deleted.grow(self._next_gid)
        tombs = np.zeros(tomb_len, dtype=bool)
        tombs[: self._next_gid] = self._deleted.bits[: self._next_gid]
        segment_fields = dict(
            slot_to_row=slot_map,
            num_slots=num_slots,
            n_rows_total=self._next_gid,
            tombstones=tombs,
            base_packets=self._base_packets,
            delta_nnz=self._delta_nnz,
            dead_nnz=self._dead_nnz,
            tombstone_count=self._tombstone_slots,
            fmt_codes=fmt_codes,
            groups=groups,
        )
        if self.config.cow_snapshots:
            buf, copied = self._buffer_pool.lease(
                self._padded_streams, self._padded_words if fused else None,
                self._part_stamps, max_p, packets_multiple=mult,
            )
            new_packed = kernel_ops.PackedPartitions(
                vals=buf.view("vals"),
                cols=buf.view("cols"),
                flags=buf.view("flags"),
                plan=self._plan,
                n_cols=self._n_cols,
                nnz=self._live_nnz,
                block_size=self._padded_streams[0].block_size,
                value_format=self._fmt,
                stream_layout=self.config.stream_layout,
                words=buf.view("words") if fused else None,
                **segment_fields,
            )
            buf.attach(new_packed)
        else:
            copied = len(self._padded_streams)  # np.stack copies everything
            new_packed = kernel_ops.stack_padded_streams(
                self._padded_streams, self._plan, self._n_cols, self._live_nnz,
                stream_layout=self.config.stream_layout,
                words=self._padded_words if fused else None,
                **segment_fields,
            )
        for gbuf in group_bufs:
            gbuf.attach(new_packed)
        # The fresh snapshot exists and the served one is still the old one:
        # a fault here drops ``new_packed`` (its leases release with it).
        faults_lib.fault_point("refresh.swap")
        self._packed = new_packed
        self.last_refresh_group_copied = group_copied
        self.total_group_copied += group_copied
        self.last_refresh_copied = copied
        self.total_copied += copied
        self._version += 1

    def _refresh_groups(self, mult: int, preserve_caps: bool):
        """The tagged width-class groups of a refresh -> (groups, leased
        buffers, member streams copied).

        Each class pads to its own packet cap (anchored exactly at
        build/compact, bucketed by mutations, like ``_packet_cap``, and kept
        as restored under ``preserve_caps``), so a narrow class never
        inherits the widest one's packets.  Only re-padded, re-capped or
        re-formatted partitions re-fuse.
        """
        nat: dict = {}
        for n in self._native:
            cname = width_class_of(n.value_format).name
            nat[cname] = max(nat.get(cname, 0), max(-(-n.num_packets // mult) * mult, mult))
        if self.config.churn_stable:
            if preserve_caps and self._class_caps is not None:
                pass                                  # restore: the saved caps hold
            elif self._class_caps is None:
                self._class_caps = dict(nat)          # anchor refresh: exact
            else:                                     # mutation refresh: bucket
                for cname, p in nat.items():
                    self._class_caps[cname] = max(self._class_caps.get(cname, 0),
                                                  kernel_ops.bucket_packets(p, mult))
            caps = self._class_caps
        else:
            caps = nat
        by_class: dict = {}
        for ci, n in enumerate(self._native):
            cname = width_class_of(n.value_format).name
            cap = caps[cname]
            cached = self._padded_tagged[ci]
            if cached is None or cached[0] != cap or cached[1] != n.value_format.name:
                words = bscsr_lib.fuse_stream(bscsr_lib.pad_packets(n, cap), tagged=True)
                self._padded_tagged[ci] = (cap, n.value_format.name, words)
            by_class.setdefault(cname, []).append(ci)
        groups, bufs, copied = [], [], 0
        for cname, cores in sorted(by_class.items()):
            words_list = [self._padded_tagged[ci][2] for ci in cores]
            if self.config.cow_snapshots:
                gbuf, gcop = self._buffer_pool.lease_group(
                    tuple(cores), words_list, self._part_stamps[np.asarray(cores)],
                    caps[cname], packets_multiple=mult,
                )
                bufs.append(gbuf)
                copied += gcop
                words = gbuf.view()
            else:
                words = np.stack(words_list)
                copied += len(cores)
            groups.append(kernel_ops.StreamGroup(cname, tuple(cores), words,
                                                 self._streams[0].block_size))
        return tuple(groups), bufs, copied

    def refresh(self) -> None:
        """Rebuild and swap the serving snapshot: the retry after a refresh
        interrupted between a mutation and the swap."""
        self._refresh()

    @property
    def packed(self) -> kernel_ops.PackedPartitions:
        return self._packed

    @property
    def n_cols(self) -> int:
        """Feature dimensionality of the indexed collection."""
        return self._n_cols

    @property
    def version(self) -> int:
        return self._version

    @property
    def n_rows(self) -> int:
        """Live (queryable) rows."""
        return len(self._loc)

    @property
    def n_rows_total(self) -> int:
        """Size of the global row-id space (live + deleted ids)."""
        return self._next_gid

    @property
    def num_cores(self) -> int:
        return self._plan.num_partitions

    @property
    def deleted_rows(self) -> int:
        return self._deleted.count

    @property
    def snapshot_buffers(self) -> int:
        """COW stacked buffers currently pooled (leased + free)."""
        return len(self._buffer_pool)

    @property
    def expected_precision(self) -> float:
        return expected_precision(
            max(self.n_rows, 1), self.num_cores, self.config.k, self.config.big_k
        )

    @property
    def partition_formats(self) -> Optional[Tuple[str, ...]]:
        """Current per-partition ValueFormat names (None when homogeneous)."""
        return tuple(self._part_fmts) if self._part_fmts is not None else None

    @property
    def predicted_recall(self) -> Optional[float]:
        """The calibration's predicted recall@k at the current assignment."""
        return self._calib.predicted_recall() if self._calib is not None else None

    def _rows_csr(self, gids) -> bscsr_lib.CSRMatrix:
        """The rows ``gids``, in that order, as a host CSR."""
        lens = np.asarray([len(self._rows[g][0]) for g in gids], dtype=np.int64)
        indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        if len(gids):
            indices = np.concatenate([self._rows[g][0] for g in gids])
            data = np.concatenate([self._rows[g][1] for g in gids])
        else:
            indices = np.zeros(0, np.int32)
            data = np.zeros(0, np.float32)
        return bscsr_lib.CSRMatrix(indptr=indptr, indices=indices, data=data,
                                   shape=(len(gids), self._n_cols))

    def _partition_live_csr(self, ci: int) -> bscsr_lib.CSRMatrix:
        """Live rows currently owned by partition ``ci``, as a host CSR."""
        return self._rows_csr([g for g in self._slots[ci] if g != int(bscsr_lib.INVALID_ROW)])

    # -- mutation ------------------------------------------------------------

    @staticmethod
    def _normalize_row(cols, vals) -> Tuple[np.ndarray, np.ndarray]:
        cols = np.asarray(cols, dtype=np.int32)
        vals = np.asarray(vals, dtype=np.float32)
        if cols.shape != vals.shape:
            raise ValueError(f"row cols/vals mismatch: {cols.shape} vs {vals.shape}")
        order = np.argsort(cols, kind="stable")
        return cols[order], vals[order]

    def _append_rows(self, items) -> None:
        """Append (gid, (cols, vals)) items as delta packets, least-loaded first."""
        groups: dict = {}
        sizes = [len(s) for s in self._slots]
        for gid, row in items:
            ci = int(np.argmin(sizes))
            groups.setdefault(ci, []).append((gid, row))
            sizes[ci] += 1
        for ci in sorted(groups):
            rows = [row for _, row in groups[ci]]
            delta = bscsr_lib.encode_delta_rows(
                rows, self._n_cols, self.config.block_size, self._fmt
            )
            if self._part_fmts is not None:
                # All three planes stay append-aligned: the delta encodes
                # exactly (F32) once, then re-quantizes into the partition's
                # current format.
                native_delta = bscsr_lib.requantize_stream(
                    delta, FORMATS[self._part_fmts[ci]])
                self._exact[ci] = bscsr_lib.append_packets(self._exact[ci], delta)
                self._native[ci] = bscsr_lib.append_packets(self._native[ci], native_delta)
                self._streams[ci] = bscsr_lib.append_packets(
                    self._streams[ci], bscsr_lib.dequantize_stream(native_delta))
            else:
                self._streams[ci] = bscsr_lib.append_packets(self._streams[ci], delta)
            self._mark_dirty(ci)
            slots = self._slots[ci]
            # The previously-open sentinel becomes a dead candidate slot.
            slots.append(int(bscsr_lib.INVALID_ROW))
            for gid, (cols, vals) in groups[ci]:
                self._loc[gid] = (ci, len(slots))
                slots.append(gid)
                self._rows[gid] = (cols, vals)
                self._live_nnz += len(cols)
                self._delta_nnz += len(cols)

    def _tombstone_slot(self, gid: int) -> None:
        ci, si = self._loc.pop(gid)
        self._slots[ci][si] = int(bscsr_lib.INVALID_ROW)
        self._tombstone_slots += 1
        cols, _ = self._rows.pop(gid)
        self._live_nnz -= len(cols)
        if si >= self._plan.rows_per_partition[ci]:  # slot lives in a delta segment
            self._delta_nnz -= len(cols)
        self._dead_nnz += len(cols)

    def add_rows(self, rows: Sequence[Tuple[np.ndarray, np.ndarray]]) -> list:
        """Append new rows; returns their freshly assigned global row ids."""
        if not rows:
            return []
        normalized = [self._normalize_row(c, v) for c, v in rows]
        gids = list(range(self._next_gid, self._next_gid + len(rows)))
        self._next_gid += len(rows)
        self._append_rows(list(zip(gids, normalized)))
        self._refresh()
        return gids

    def replace_rows(self, row_ids: Sequence[int],
                     rows: Sequence[Tuple[np.ndarray, np.ndarray]]) -> None:
        """Replace rows in place of their ids: tombstone old copy, append new.

        A previously deleted id is resurrected (its tombstone bit clears).
        """
        if len(row_ids) != len(rows):
            raise ValueError("row_ids and rows must be the same length")
        row_ids = self._validate_ids(row_ids)
        normalized = [self._normalize_row(c, v) for c, v in rows]
        for gid in row_ids:
            if gid in self._loc:
                self._tombstone_slot(gid)
        self._deleted.clear(row_ids)
        self._append_rows(list(zip(row_ids, normalized)))
        self._refresh()

    def delete_rows(self, row_ids: Sequence[int]) -> None:
        """Tombstone rows: their slots retire and their ids stay unreturnable."""
        row_ids = self._validate_ids(row_ids, allow_duplicates=True)
        for gid in row_ids:
            if gid in self._loc:
                self._tombstone_slot(gid)
            self._deleted.mark([gid])
        self._refresh()

    def _validate_ids(self, row_ids: Sequence[int], allow_duplicates=False) -> list:
        out = [int(g) for g in row_ids]
        for gid in out:
            if gid < 0 or gid >= self._next_gid:
                raise KeyError(f"row id {gid} was never assigned")
        if not allow_duplicates and len(set(out)) != len(out):
            # a duplicate would append two live slots for one id (ghost copy)
            raise ValueError("duplicate row ids in one replace batch")
        return out

    # -- compaction ----------------------------------------------------------

    def live_csr(self) -> Tuple[bscsr_lib.CSRMatrix, np.ndarray]:
        """Live rows (gid-ascending) as a CSR plus the gid of each CSR row.

        Cached per snapshot version.
        """
        if self._live_csr_cache is not None and self._live_csr_cache[0] == self._version:
            return self._live_csr_cache[1]
        gids = np.asarray(sorted(self._loc), dtype=np.int64)
        csr = self._rows_csr(gids)
        self._live_csr_cache = (self._version, (csr, gids))
        return csr, gids

    def compact(self) -> None:
        """Re-encode live rows into a fresh base segment.

        Reclaims delta packets, dead slots and tombstoned stream bytes.
        With ``config.parallel_compaction`` partitions re-encode in a thread
        pool once per-partition work clears ``parallel_compaction_min_nnz``
        (numpy releases the GIL on large-array work); tiny indexes stay
        serial.  The previous snapshot serves until the one swap; deleted
        ids stay masked through the tombstone bitmap.
        """
        csr, gids = self.live_csr()
        c = max(1, self.config.resolve_partitions(max(csr.shape[0], 1)))
        plan = partition_lib.PartitionPlan.build(csr.shape[0], c)
        parts = partition_lib.partition_csr(csr, plan)

        def encode(p):
            return bscsr_lib.encode_bscsr(p, self.config.block_size, self._fmt)

        parallel = (
            self.config.parallel_compaction
            and len(parts) > 1
            and csr.nnz / len(parts) >= self.config.parallel_compaction_min_nnz
        )
        if parallel:
            workers = min(len(parts), os.cpu_count() or 1)
            with ThreadPoolExecutor(max_workers=workers) as pool:
                streams = list(pool.map(encode, parts))
        else:
            streams = [encode(p) for p in parts]
        self.last_compact_parallel = parallel
        planes = None
        if self._part_fmts is not None:
            # The full re-assignment, the one place formats may demote: a fresh
            # calibration over the live rows, then the three planes anew.
            # ``self._fmt`` is F32 here, so ``streams`` is the exact plane.
            fmt_plan, calib = _assign_formats(csr, plan.num_partitions, self.config)
            fmts = list(fmt_plan.formats)
            planes = (fmts, calib, streams) + _quantized_planes(streams, fmts)
        # Everything above is in locals: a fault up to here leaves the index
        # and its served snapshot as they were.
        faults_lib.fault_point("compact.swap")
        if planes is not None:
            self._part_fmts, self._calib, self._exact, self._native, self._streams = planes
        else:
            self._streams = streams
        self._base_packets = max(e.num_packets for e in streams)
        self._plan = plan
        self._reset_padded_cache()
        self._slots = [
            [int(g) for g in gids[start : start + size]]
            for start, size in zip(plan.row_starts, plan.rows_per_partition)
        ]
        self._loc = {
            gid: (ci, si)
            for ci, slots in enumerate(self._slots)
            for si, gid in enumerate(slots)
        }
        self._delta_nnz = 0
        self._dead_nnz = 0
        self._tombstone_slots = 0
        self._refresh()

    # -- durable state (core/persistence.py writes and reads it) -------------

    def export_state(self) -> Tuple[dict, dict]:
        """The whole logical and stream state as (json-able meta, named arrays).

        Schema 1, with the reference's array names, so ``from_state``
        rebuilds this index bit for bit, churn-stable caps included (the
        restored snapshot keeps the padded shapes and executor signature).
        The config is this package's (``device`` in place of the reference's
        ``interpret``).  A mixed-precision index stores only its exact F32
        plane, the format vector and the calibration: the native and twin
        planes are exact functions of them.
        """
        hetero = self._part_fmts is not None
        plane = self._exact if hetero else self._streams
        arrays: dict = {}
        stream_meta = []
        for ci, s in enumerate(plane):
            arrays[f"s{ci}_vals"] = s.vals
            arrays[f"s{ci}_cols"] = s.cols
            arrays[f"s{ci}_flags"] = s.flags
            stream_meta.append({"n_rows": int(s.n_rows), "nnz": int(s.nnz),
                                "fmt": s.value_format.name})
        arrays["slot_lens"] = np.asarray([len(s) for s in self._slots], np.int64)
        arrays["slots"] = np.concatenate(
            [np.asarray(s, np.int64) for s in self._slots] + [np.zeros(0, np.int64)])
        gids = np.sort(np.fromiter(self._rows, np.int64, len(self._rows)))
        rows = self._rows_csr(gids.tolist())
        arrays["row_gids"] = gids
        arrays["row_lens"] = np.diff(rows.indptr).astype(np.int64)
        arrays["row_cols"] = rows.indices.astype(np.int32, copy=False)
        arrays["row_vals"] = rows.data.astype(np.float32, copy=False)
        self._deleted.grow(self._next_gid)
        arrays["deleted"] = self._deleted.bits[: max(self._next_gid, 1)].copy()
        calib_meta = None
        if self._calib is not None:
            c = self._calib
            arrays["calib_queries"] = c.queries
            arrays["calib_thresholds"] = c.thresholds
            arrays["calib_losses"] = c.losses
            for fname, arr in c.quant_thresholds.items():
                arrays[f"calib_qt_{fname}"] = arr
            calib_meta = {"k": int(c.k), "budget": float(c.budget),
                          "quant_fmts": sorted(c.quant_thresholds)}
        meta = {
            "schema": 1,
            "config": dataclasses.asdict(self.config),
            "n_cols": int(self._n_cols),
            "plan_rows": int(self._plan.n_rows),
            "plan_partitions": int(self._plan.num_partitions),
            "next_gid": int(self._next_gid),
            "live_nnz": int(self._live_nnz),
            "delta_nnz": int(self._delta_nnz),
            "dead_nnz": int(self._dead_nnz),
            "tombstone_slots": int(self._tombstone_slots),
            "base_packets": int(self._base_packets),
            "version": int(self._version),
            "packet_cap": int(self._packet_cap),
            "class_caps": ({k: int(v) for k, v in self._class_caps.items()}
                           if self._class_caps is not None else None),
            "part_fmts": list(self._part_fmts) if hetero else None,
            "streams": stream_meta,
            "calib": calib_meta,
        }
        return meta, arrays

    @classmethod
    def from_state(cls, meta: dict, arrays: dict, device: str = "cuda"
                   ) -> "MutableTopKSpMVIndex":
        """Rebuild an index from ``export_state`` output, serving on ``device``.

        The restored snapshot answers bit for bit like the exported one and
        has the same signature, so resuming re-pins it with zero retraces.
        A state the reference package wrote goes through
        ``repro_torch.convert.state_from_reference`` first.
        """
        if meta.get("schema") != 1:
            raise ValueError(f"unsupported state schema: {meta.get('schema')}")
        if "interpret" in meta["config"]:
            raise ValueError("this state was written by the reference package; convert it "
                             "with repro_torch.convert.state_from_reference")
        config = TopKSpMVConfig(**dict(meta["config"], device=device))
        hetero = meta["part_fmts"] is not None
        obj = cls.__new__(cls)
        obj.config = config
        obj._n_cols = int(meta["n_cols"])
        obj._fmt = F32 if hetero else FORMATS[config.value_format]
        obj._plan = partition_lib.PartitionPlan.build(meta["plan_rows"],
                                                      meta["plan_partitions"])
        plane = [
            bscsr_lib.BSCSRMatrix(
                vals=arrays[f"s{ci}_vals"], cols=arrays[f"s{ci}_cols"],
                flags=arrays[f"s{ci}_flags"], n_rows=int(sm["n_rows"]),
                n_cols=obj._n_cols, nnz=int(sm["nnz"]), block_size=config.block_size,
                value_format=FORMATS[sm["fmt"]])
            for ci, sm in enumerate(meta["streams"])
        ]
        obj.last_refresh_promoted = 0
        obj._part_fmts = obj._calib = obj._exact = obj._native = None
        if hetero:
            obj._part_fmts = list(meta["part_fmts"])
            obj._exact = plane
            obj._native, obj._streams = _quantized_planes(plane, obj._part_fmts)
            cm = meta["calib"]
            if cm is not None:
                obj._calib = adaptive_lib.PrecisionCalibration(
                    queries=arrays["calib_queries"],
                    thresholds=arrays["calib_thresholds"],
                    k=int(cm["k"]),
                    budget=float(cm["budget"]),
                    losses=np.array(arrays["calib_losses"]),
                    quant_thresholds={f: arrays[f"calib_qt_{f}"] for f in cm["quant_fmts"]},
                )
        else:
            obj._streams = plane
        obj._base_packets = int(meta["base_packets"])
        bounds = np.concatenate([[0], np.cumsum(arrays["slot_lens"])]).tolist()
        flat = arrays["slots"]
        obj._slots = [flat[a:b].tolist() for a, b in zip(bounds[:-1], bounds[1:])]
        invalid = int(bscsr_lib.INVALID_ROW)
        obj._loc = {
            gid: (ci, si)
            for ci, slots in enumerate(obj._slots)
            for si, gid in enumerate(slots)
            if gid != invalid
        }
        cols, vals = arrays["row_cols"], arrays["row_vals"]
        bounds = np.concatenate([[0], np.cumsum(arrays["row_lens"])]).tolist()
        obj._rows = {
            gid: (cols[a:b], vals[a:b])
            for gid, a, b in zip(arrays["row_gids"].tolist(), bounds[:-1], bounds[1:])
        }
        obj._next_gid = int(meta["next_gid"])
        obj._deleted = bscsr_lib.TombstoneBitmap(bits=np.array(arrays["deleted"], dtype=bool))
        obj._deleted.grow(obj._next_gid)
        obj._live_nnz = int(meta["live_nnz"])
        obj._delta_nnz = int(meta["delta_nnz"])
        obj._dead_nnz = int(meta["dead_nnz"])
        obj._tombstone_slots = int(meta["tombstone_slots"])
        obj._version = int(meta["version"]) - 1  # _refresh bumps it back
        obj._packed = None
        obj._live_csr_cache = None
        obj._buffer_pool = kernel_ops.SnapshotBufferPool()
        obj._stamp_counter = 0
        obj._reset_padded_cache()
        obj.last_refresh_repadded = 0
        obj.total_repadded = 0
        obj.last_refresh_copied = 0
        obj.total_copied = 0
        obj.last_refresh_group_copied = 0
        obj.total_group_copied = 0
        obj.last_compact_parallel = False
        # The churn-stable caps as saved, then the snapshot around them.
        obj._packet_cap = int(meta["packet_cap"])
        if meta["class_caps"] is not None:
            obj._class_caps = {k: int(v) for k, v in meta["class_caps"].items()}
        obj._refresh(preserve_caps=True)
        return obj


def query_executor(config: TopKSpMVConfig) -> executor_lib.QueryExecutor:
    """The process-wide device-resident executor serving this config."""
    return executor_lib.get_executor(
        big_k=config.big_k,
        k=config.k,
        packets_per_step=config.packets_per_step,
        gather_mode=config.gather_mode,
        inner_loop=config.inner_loop,
        device=config.resolve_device(),
    )


def topk_spmv(
    index: TopKSpMVIndex, x, use_kernel: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-query approximate Top-K -> (big_k,) values and global row ids."""
    cfg = index.config
    device = cfg.resolve_device()
    if cfg.use_executor:
        return query_executor(cfg).query(
            x, index.packed, path="kernel" if use_kernel else "reference"
        )
    if use_kernel:
        return kernel_ops.topk_spmv_blocked(
            x, index.packed, big_k=cfg.big_k, k=cfg.k,
            packets_per_step=cfg.packets_per_step, gather_mode=cfg.gather_mode,
            inner_loop=cfg.inner_loop, device=device,
        )
    return kernel_ops.topk_spmv_reference(x, index.packed, big_k=cfg.big_k, k=cfg.k,
                                          device=device)


def topk_spmv_batched(
    index: TopKSpMVIndex, xs, use_kernel: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched approximate Top-K: Q queries, one pass over the stream.

    ``xs`` is (Q, M); returns (Q, big_k) values and global row ids.  With
    ``use_kernel`` the multi-query kernel reads every packet once for all Q
    queries; otherwise the torch oracle evaluates the same approximation.
    """
    cfg = index.config
    device = cfg.resolve_device()
    if cfg.use_executor:
        return query_executor(cfg).query_batched(
            xs, index.packed, path="kernel" if use_kernel else "reference"
        )
    if use_kernel:
        return kernel_ops.topk_spmv_batched(
            xs, index.packed, big_k=cfg.big_k, k=cfg.k,
            packets_per_step=cfg.packets_per_step, inner_loop=cfg.inner_loop,
            device=device,
        )
    return kernel_ops.topk_spmv_reference_batched(xs, index.packed, big_k=cfg.big_k,
                                                  k=cfg.k, device=device)


def topk_spmv_exact(
    csr: bscsr_lib.CSRMatrix, x, big_k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact CSR Top-K on host — ground truth for accuracy studies."""
    return ref_lib.csr_topk_numpy(
        csr.indptr, csr.indices, csr.data, np.asarray(x, np.float32), big_k
    )
