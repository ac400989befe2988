"""Host-side packing + per-call dispatch around the BS-CSR Top-K SpMV kernels.

``PackedPartitions`` is the host plane: numpy arrays, one stream per core,
stacked to a common step-aligned packet count.  It may be *segmented*: two
optional arrays translate kernel-local slot ids back to the logical index,

  slot_to_row   (C, L) int32 — slot -> global row id; ``INVALID_ROW`` retires
                a slot (dead sentinel between segments, replaced/deleted row)
  tombstones    (n_rows_total,) bool — deleted global row ids

and ``finalize_candidates`` applies both before the merge.  A pure-base
snapshot (``pack_partitions``) leaves them ``None`` and uses the affine
``row_starts`` mapping.  A snapshot built elsewhere (``repro_torch.convert``)
may carry a slot budget ``L`` padded past the live slot counts; padded slots
are only ever NEG_INF sentinels, so they never change an answer.

A mutable index stacks its snapshots copy-on-write through a
``SnapshotBufferPool`` and carries its churn counters (``base_packets``,
``delta_nnz``, ``dead_nnz``, ``tombstone_count``) on the snapshot.

A mixed-precision snapshot (``pack_partitions(value_formats=)``, or a
mutable index with a ``recall_target``) gives each partition its own value
format.  Its ``groups`` hold one tagged fused word array per storage-width
class (``StreamGroup``: TAG4, TAG2, TAG1), each padded to its own packet
count, and the kernels run once per group; its split arrays are the exactly
dequantized F32 twins, which the oracle reads.

The dispatch helpers here upload the snapshot on every call: the simple
baseline.  Serving goes through ``kernels/executor.py``, which pins each
snapshot on the device once.  Both ship only the fused word stream to the
kernels; split-layout snapshots are fused on the fly, bit-identically.  The
accumulate mode (``bscsr_spmv_blocked``, ``bscsr_spmv_reference``) replaces
finalize with the masked dense scatter ``scatter_slot_sums``.
"""
from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bscsr as bscsr_lib
from repro_torch.core import partition as partition_lib
from repro_torch.core.quantization import (
    FORMAT_BY_CODE,
    FORMATS,
    WIDTH_CLASSES,
    ValueFormat,
    width_class_of,
)
from repro_torch.kernels import ref as ref_lib
from repro_torch.kernels.bscsr_topk_spmv import (
    GATHER_MODES,
    bscsr_spmv,
    bscsr_topk_spmv,
    bscsr_topk_spmv_multiquery,
    spmv_splits,
)

NEG_INF = ref_lib.NEG_INF
INVALID_ROW = bscsr_lib.INVALID_ROW


def pow2_bucket(n: int, minimum: int = 1) -> int:
    """Next power-of-two >= max(n, minimum) — the churn-stable dim bucket."""
    return 1 << (max(int(n), minimum, 1) - 1).bit_length()


def bucket_packets(n: int, multiple: int) -> int:
    """Power-of-two packet bucket, kept a multiple of ``packets_per_step``.

    The padded tail is zero packets with no row-start flags, which the
    kernels treat as a continuation of the open sentinel row.
    """
    return -(-pow2_bucket(n) // multiple) * multiple


def host_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy host array as a tensor on ``device`` (bf16 uint16 bits -> int16).

    torch has no general uint16 arithmetic, so 16-bit bit patterns travel as
    int16; the bytes are unchanged.  The tensor never aliases ``arr``: a
    mutable index recycles the host buffers its snapshots view.
    """
    a = np.ascontiguousarray(arr)
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    if np.may_share_memory(a, arr) and (torch.device(device).type == "cpu"
                                     or not a.flags.writeable):
        a = a.copy()
    return torch.from_numpy(a).to(device)


# Monotonic snapshot identities: the executor pins each snapshot's arrays on
# the device once, keyed by this uid, and evicts when the snapshot is collected.
_SNAPSHOT_UIDS = itertools.count()


@dataclasses.dataclass(frozen=True)
class StreamGroup:
    """One storage-width class of a mixed-precision snapshot's fused streams.

    Partitions are grouped by value storage width (``TAG4``/``TAG2``/
    ``TAG1``); each group keeps its own tagged ``(Cg, Pg, 1 + W)`` word array
    with its own packet count, and the dispatchers run one kernel call per
    group and scatter the per-core results back by ``cores``.
    """

    class_name: str               # WIDTH_CLASSES key (TAG4 | TAG2 | TAG1)
    cores: Tuple[int, ...]        # snapshot core indices in this group
    words: np.ndarray             # (Cg, Pg, 1 + W) tagged fused word streams
    block_size: int

    @property
    def stream_bytes(self) -> int:
        return int(self.words.nbytes)

    @property
    def value_stream_bytes(self) -> int:
        """Bytes of this group's value sections (padding packets included)."""
        cg, pg, _ = self.words.shape
        bpv = WIDTH_CLASSES[self.class_name].bytes_per_value
        return cg * pg * self.block_size * bpv


@dataclasses.dataclass(frozen=True)
class PackedPartitions:
    """All core partitions of one matrix, stacked for the one-block-per-core walk.

    Mixed-precision snapshots also carry ``fmt_codes`` (each partition's
    ``ValueFormat`` code) and ``groups`` (the tagged fused streams of each
    width class); their split arrays are the exactly dequantized F32 twins,
    and byte accounting counts the native group words.
    """

    vals: np.ndarray          # (C, P, B) base+delta concatenated streams
    cols: np.ndarray          # (C, P, B)
    flags: np.ndarray         # (C, P, B//32)
    plan: partition_lib.PartitionPlan
    n_cols: int
    nnz: int                  # live nnz (tombstoned stream entries excluded)
    block_size: int
    value_format: ValueFormat
    stream_layout: str = "split"               # "split" | "fused"
    words: Optional[np.ndarray] = None         # (C, P, W) fused word streams
    # --- segmented-extension fields (None for a pure-base index) ---
    slot_to_row: Optional[np.ndarray] = None   # (C, L) int32 slot -> global row
    num_slots: Optional[np.ndarray] = None     # (C,) candidate slots per core
    n_rows_total: Optional[int] = None         # global row-id space size
    tombstones: Optional[np.ndarray] = None    # (n_rows_total,) bool, deleted ids
    base_packets: Optional[int] = None         # packets in the base segment
    delta_nnz: int = 0                         # live nnz held in delta segments
    dead_nnz: int = 0                          # stream nnz under retired slots
    tombstone_count: int = 0                   # retired (tombstoned) slots
    # --- mixed-precision fields (None for a homogeneous snapshot) ---
    fmt_codes: Optional[np.ndarray] = None     # (C,) int32 per-partition codes
    groups: Optional[Tuple[StreamGroup, ...]] = None  # tagged fused streams
    uid: int = dataclasses.field(init=False, compare=False, repr=False, default=-1)
    has_tombstones: bool = dataclasses.field(init=False, compare=False, default=False)

    def __post_init__(self):
        object.__setattr__(self, "uid", next(_SNAPSHOT_UIDS))
        object.__setattr__(
            self, "has_tombstones",
            self.tombstones is not None and bool(self.tombstones.any()),
        )

    @property
    def num_cores(self) -> int:
        return int(self.vals.shape[0])

    @property
    def row_starts(self) -> np.ndarray:
        return np.asarray(self.plan.row_starts, dtype=np.int32)

    @property
    def rows_per_partition(self) -> np.ndarray:
        return np.asarray(self.plan.rows_per_partition, dtype=np.int32)

    @property
    def is_segmented(self) -> bool:
        return self.slot_to_row is not None

    @property
    def delta_fraction(self) -> float:
        return self.delta_nnz / max(self.nnz, 1)

    @property
    def candidate_slots(self) -> np.ndarray:
        """(C,) number of kernel-local candidate slots per core."""
        if self.num_slots is not None:
            return np.asarray(self.num_slots, dtype=np.int32)
        return self.rows_per_partition

    @property
    def max_slots(self) -> int:
        """Per-core candidate-slot budget (the slot-map width when segmented)."""
        if self.slot_to_row is not None:
            return int(self.slot_to_row.shape[1])
        return max(int(self.candidate_slots.max()), 1)

    @property
    def n_rows_logical(self) -> int:
        """Size of the global row-id space (sentinel id for the merge mask)."""
        return self.n_rows_total if self.n_rows_total is not None else self.plan.n_rows

    @property
    def is_heterogeneous(self) -> bool:
        """True when partitions carry per-partition value formats."""
        return self.fmt_codes is not None

    @property
    def fmt_signature(self) -> Optional[Tuple[int, ...]]:
        """The per-partition format codes (None when homogeneous); part of
        the executor signature, so a reassignment counts as a retrace."""
        if self.fmt_codes is None:
            return None
        return tuple(int(c) for c in self.fmt_codes)

    def format_histogram(self) -> dict:
        """{format name: partition count} of the served streams."""
        if self.fmt_codes is None:
            return {self.value_format.name: self.num_cores}
        out: dict = {}
        for c in self.fmt_codes:
            name = FORMAT_BY_CODE[int(c)].name
            out[name] = out.get(name, 0) + 1
        return out

    @property
    def stream_bytes(self) -> int:
        if self.groups is not None:  # native tagged words, not the f32 twins
            return int(sum(g.stream_bytes for g in self.groups))
        return self.vals.nbytes + self.cols.nbytes + self.flags.nbytes

    @property
    def bytes_per_nnz(self) -> float:
        """Effective bytes streamed per *live* nnz."""
        return self.stream_bytes / max(self.nnz, 1)

    @property
    def value_stream_bytes(self) -> int:
        """Bytes of the streamed value sections alone (padding included)."""
        if self.groups is not None:
            return int(sum(g.value_stream_bytes for g in self.groups))
        c, p, _ = self.vals.shape
        return c * p * self.block_size * int(self.value_format.bytes_per_value)

    @property
    def value_bytes_per_nnz(self) -> float:
        return self.value_stream_bytes / max(self.nnz, 1)

    def fused_words(self) -> np.ndarray:
        """The (C, P, W) fused word streams; derived on the fly if not carried."""
        if self.groups is not None:
            raise ValueError(
                "mixed-precision snapshot has no single fused array: dispatch "
                "its StreamGroups (fused) or its f32 split arrays"
            )
        if self.words is not None:
            return self.words
        return bscsr_lib.fuse_words(self.vals, self.cols, self.flags)

    def signature_info(self) -> dict:
        """The dims that key the executor's specialisations, bucket vs live."""
        live_slots = (
            int(np.max(self.num_slots)) if self.num_slots is not None
            else int(np.max(self.rows_per_partition))
        )
        return {
            "packets_bucket": int(self.vals.shape[1]),
            "slot_bucket": self.max_slots,
            "slots_live": live_slots,
            "tombstone_bucket": (
                int(self.tombstones.shape[0]) if self.tombstones is not None else 0
            ),
            "rows_live": self.n_rows_logical,
            "value_formats": self.format_histogram(),
        }


def stack_padded_streams(
    padded: Sequence[bscsr_lib.BSCSRMatrix],
    plan: partition_lib.PartitionPlan,
    n_cols: int,
    nnz: int,
    stream_layout: str = "split",
    words: Optional[Sequence[np.ndarray]] = None,
    **segment_fields,
) -> PackedPartitions:
    """Stack already-padded per-partition streams into one snapshot.

    A mutable index passes its cached per-partition fused ``words`` and the
    segmented fields; otherwise the fused layout fuses each partition here.
    """
    if stream_layout not in bscsr_lib.STREAM_LAYOUTS:
        raise ValueError(
            f"stream_layout must be one of {bscsr_lib.STREAM_LAYOUTS}, "
            f"got {stream_layout!r}"
        )
    words_arr = None
    if stream_layout == "fused" and segment_fields.get("groups") is None:
        # A mixed-precision snapshot never fuses its f32 twins: its fused
        # plane is the tagged ``groups``.
        if words is None:
            words = [bscsr_lib.fuse_stream(e) for e in padded]
        words_arr = np.stack(list(words))
    return PackedPartitions(
        vals=np.stack([e.vals for e in padded]),
        cols=np.stack([e.cols for e in padded]),
        flags=np.stack([e.flags for e in padded]),
        plan=plan,
        n_cols=n_cols,
        nnz=nnz,
        block_size=padded[0].block_size,
        value_format=padded[0].value_format,
        stream_layout=stream_layout,
        words=words_arr,
        **segment_fields,
    )


def stack_streams(
    streams: Sequence[bscsr_lib.BSCSRMatrix],
    plan: partition_lib.PartitionPlan,
    n_cols: int,
    nnz: int,
    packets_multiple: int = 2,
    stream_layout: str = "split",
    **segment_fields,
) -> PackedPartitions:
    """Pad per-partition streams to a common step-aligned packet count & stack.

    ``segment_fields`` go straight into the container.
    """
    if not streams:
        raise ValueError("need at least one partition stream")
    max_p = max(e.num_packets for e in streams)
    max_p = max(-(-max_p // packets_multiple) * packets_multiple, packets_multiple)
    padded = [bscsr_lib.pad_packets(e, max_p) for e in streams]
    return stack_padded_streams(padded, plan, n_cols, nnz, stream_layout=stream_layout,
                                **segment_fields)


def build_stream_groups(
    encoded: Sequence[bscsr_lib.BSCSRMatrix],
    packets_multiple: int = 2,
    pad_to: Optional[dict] = None,
) -> Tuple[StreamGroup, ...]:
    """Group native-format partition streams by storage width and fuse (tagged).

    Each width class pads to its own step-aligned packet count, so a narrow
    group never inherits the widest partition's packets.  ``pad_to``
    optionally pins per-class packet counts (a churn-stable mutable index
    passes its bucketed caps); other classes use their natural maximum.
    """
    by_class: dict = {}
    for ci, e in enumerate(encoded):
        by_class.setdefault(width_class_of(e.value_format).name, []).append(ci)
    groups = []
    for cname in sorted(by_class):
        cores = by_class[cname]
        max_p = max(encoded[ci].num_packets for ci in cores)
        max_p = max(-(-max_p // packets_multiple) * packets_multiple, packets_multiple)
        if pad_to is not None and cname in pad_to:
            max_p = max(max_p, int(pad_to[cname]))
        words = np.stack([
            bscsr_lib.fuse_stream(bscsr_lib.pad_packets(encoded[ci], max_p), tagged=True)
            for ci in cores
        ])
        groups.append(StreamGroup(cname, tuple(cores), words, encoded[0].block_size))
    return tuple(groups)


def pack_partitions(
    csr: bscsr_lib.CSRMatrix,
    num_partitions: int,
    block_size: int = 256,
    value_format: ValueFormat | str = "F32",
    packets_multiple: int = 2,
    stream_layout: str = "split",
    value_formats: Optional[Sequence[ValueFormat | str]] = None,
) -> PackedPartitions:
    """Partition a CSR row-wise (§III-A) and BS-CSR encode each partition.

    ``value_formats`` (one entry per partition) builds a mixed-precision
    snapshot instead: each partition is encoded in its own format, the
    tagged fused streams are grouped by storage width, and the split arrays
    are the exactly dequantized f32 twins.
    """
    plan = partition_lib.PartitionPlan.build(csr.shape[0], num_partitions)
    parts = partition_lib.partition_csr(csr, plan)
    if value_formats is None:
        fmt = FORMATS[value_format] if isinstance(value_format, str) else value_format
        encoded = [bscsr_lib.encode_bscsr(p, block_size, fmt) for p in parts]
        return stack_streams(
            encoded, plan, csr.shape[1], csr.nnz,
            packets_multiple=packets_multiple, stream_layout=stream_layout,
        )
    if len(value_formats) != len(parts):
        raise ValueError(
            f"value_formats has {len(value_formats)} entries for {len(parts)} partitions"
        )
    fmts = [FORMATS[f] if isinstance(f, str) else f for f in value_formats]
    native = [bscsr_lib.encode_bscsr(p, block_size, f) for p, f in zip(parts, fmts)]
    groups = build_stream_groups(native, packets_multiple=packets_multiple)
    return stack_streams(
        [bscsr_lib.dequantize_stream(e) for e in native],
        plan, csr.shape[1], csr.nnz,
        packets_multiple=packets_multiple, stream_layout=stream_layout,
        fmt_codes=np.array([f.code for f in fmts], np.int32),
        groups=groups,
    )


class _StackBuffer:
    """One preallocated (C, capacity, ·) stacked stream buffer, leased out.

    ``stamps`` records, per partition, the mutation stamp of the data the
    buffer holds; ``sync`` copies in only partitions whose stamp (or the
    common padded packet count) went stale.  ``attach`` registers a snapshot
    viewing the buffer, which may be re-leased only once every attached
    snapshot has been garbage collected: that keeps frozen snapshots
    bit-identical while later refreshes write elsewhere.
    """

    def __init__(self, geometry: tuple, capacity: int):
        c, block, vdtype, cdtype, flag_words, word_width = geometry
        self.geometry = geometry
        self.capacity = capacity      # packet capacity, including headroom
        self.pad_to = -1              # packet count the contents pad to
        self.stamps = np.full(c, -1, np.int64)
        self.vals = np.zeros((c, capacity, block), vdtype)
        self.cols = np.zeros((c, capacity, block), cdtype)
        self.flags = np.zeros((c, capacity, flag_words), np.int32)
        self.words = (
            np.zeros((c, capacity, word_width), np.int32) if word_width else None
        )
        self._leases: list = []

    def is_free(self) -> bool:
        """True when no live snapshot views this buffer."""
        self._leases = [r for r in self._leases if r() is not None]
        return not self._leases

    def attach(self, snapshot) -> None:
        self._leases.append(weakref.ref(snapshot))

    def sync(self, padded: Sequence[bscsr_lib.BSCSRMatrix],
             words: Optional[Sequence[np.ndarray]], stamps: np.ndarray,
             pad_to: int) -> int:
        """Copy in stale partitions; returns how many were copied."""
        stale_all = pad_to != self.pad_to
        copied = 0
        for ci, e in enumerate(padded):
            if not stale_all and self.stamps[ci] == stamps[ci]:
                continue
            self.vals[ci, :pad_to] = e.vals
            self.cols[ci, :pad_to] = e.cols
            self.flags[ci, :pad_to] = e.flags
            if self.words is not None:
                self.words[ci, :pad_to] = words[ci]
            copied += 1
        self.stamps[:] = stamps
        self.pad_to = pad_to
        return copied

    def view(self, name: str) -> np.ndarray:
        """Read-only (C, pad_to, ·) view of one stream for a snapshot.

        Capacity strictly exceeds ``pad_to``, so for C > 1 the view is not
        contiguous and every upload must copy; a single-core view would be
        contiguous (and aliasable by ``torch.from_numpy``), so it is copied.
        """
        if self.capacity <= self.pad_to:
            raise RuntimeError("stack buffer leased without packet headroom")
        v = getattr(self, name)[:, : self.pad_to]
        if v.flags.c_contiguous:
            v = v.copy()
        v.setflags(write=False)
        return v


class _GroupStackBuffer:
    """One preallocated (Cg, capacity, 1+W) tagged width-class stack, leased out.

    The mixed-precision counterpart of ``_StackBuffer``: ``stamps`` holds the
    member cores' mutation stamps in group order, so ``sync`` rewrites only
    members whose partitions mutated.  A format change always rides a
    mutation stamp (refresh promotes only mutated partitions), and a change
    of membership changes the geometry key, so equal stamps mean fresh data.
    """

    def __init__(self, geometry: tuple, capacity: int):
        cores, word_width = geometry
        self.geometry = geometry
        self.capacity = capacity
        self.pad_to = -1
        self.stamps = np.full(len(cores), -1, np.int64)
        self.words = np.zeros((len(cores), capacity, word_width), np.int32)
        self._leases: list = []

    def is_free(self) -> bool:
        self._leases = [r for r in self._leases if r() is not None]
        return not self._leases

    def attach(self, snapshot) -> None:
        self._leases.append(weakref.ref(snapshot))

    def sync(self, words_list: Sequence[np.ndarray], stamps: np.ndarray,
             pad_to: int) -> int:
        """Copy in stale member streams; returns how many were copied."""
        stale_all = pad_to != self.pad_to
        copied = 0
        for j, w in enumerate(words_list):
            if not stale_all and self.stamps[j] == stamps[j]:
                continue
            self.words[j, :pad_to] = w
            copied += 1
        self.stamps[:] = stamps
        self.pad_to = pad_to
        return copied

    def view(self) -> np.ndarray:
        """Read-only (Cg, pad_to, 1+W) view, with ``_StackBuffer.view``'s rules."""
        if self.capacity <= self.pad_to:
            raise RuntimeError("group stack buffer leased without packet headroom")
        v = self.words[:, : self.pad_to]
        if v.flags.c_contiguous:
            v = v.copy()
        v.setflags(write=False)
        return v


class SnapshotBufferPool:
    """Copy-on-write stacked snapshot buffers for a mutable index.

    Each refresh leases a buffer that no live snapshot views (tracked by
    weakref), copies in only the partitions whose mutation stamp differs
    from what the buffer holds, and hands the snapshot read-only views.
    Steady-state serving ping-pongs between two buffers, so a refresh costs
    O(mutated partitions), not O(index bytes).  Liveness is tracked on the
    ``PackedPartitions`` object: keep the snapshot alive, not bare
    references to its arrays.
    """

    def __init__(self, headroom: float = 0.5, max_free: int = 2):
        self.headroom = headroom
        self.max_free = max_free
        self._buffers: list = []
        self._group_buffers: list = []

    def __len__(self) -> int:
        return len(self._buffers) + len(self._group_buffers)

    def _take(self, buffers: list, geometry: tuple, pad_to: int, packets_multiple: int,
              make) -> Tuple[list, object]:
        """(buffers to keep, a free buffer of this geometry with headroom).

        Free buffers of another geometry, with too little capacity or past
        ``max_free`` are dropped; when every fitting buffer is still viewed by
        a live snapshot, a fresh one gets ``headroom`` extra packets.
        """
        buf, keep, free_kept = None, [], 0
        for b in buffers:
            if b.is_free():
                if (b.geometry != geometry or b.capacity <= pad_to
                        or free_kept >= self.max_free):
                    continue              # unusable and unreferenced: drop
                free_kept += 1
                if buf is None:
                    buf = b
            keep.append(b)
        if buf is None:
            extra = -(-int(pad_to * self.headroom) // packets_multiple)
            buf = make(geometry, pad_to + max(packets_multiple, extra * packets_multiple))
            keep.append(buf)
        return keep, buf

    def lease(self, padded: Sequence[bscsr_lib.BSCSRMatrix],
              words: Optional[Sequence[np.ndarray]], stamps: np.ndarray,
              pad_to: int, packets_multiple: int = 2) -> Tuple[_StackBuffer, int]:
        """A free, synced buffer for these streams -> (buffer, copied count)."""
        word_width = words[0].shape[1] if words is not None else 0
        geometry = (
            len(padded), padded[0].vals.shape[1], padded[0].vals.dtype,
            padded[0].cols.dtype, padded[0].flags.shape[1], word_width,
        )
        self._buffers, buf = self._take(self._buffers, geometry, pad_to, packets_multiple,
                                        _StackBuffer)
        return buf, buf.sync(padded, words, stamps, pad_to)

    def lease_group(self, cores: Tuple[int, ...], words_list: Sequence[np.ndarray],
                    stamps: np.ndarray, pad_to: int, packets_multiple: int = 2
                    ) -> Tuple[_GroupStackBuffer, int]:
        """A free, synced width-class stack -> (buffer, copied count).

        ``cores`` (the class's member partitions, in group order) is part of
        the geometry key, so a promotion that moves a core between classes
        lands in a fresh buffer.  Same capacity and aliasing rules as
        ``lease``.
        """
        geometry = (tuple(cores), words_list[0].shape[1])
        self._group_buffers, buf = self._take(self._group_buffers, geometry, pad_to,
                                              packets_multiple, _GroupStackBuffer)
        return buf, buf.sync(words_list, stamps, pad_to)


def finalize_candidates_batched(
    local_vals: torch.Tensor,    # (C, Q, k)
    local_rows: torch.Tensor,    # (C, Q, k) partition-local slot ids
    row_starts: torch.Tensor,    # (C,)
    rows_per_part: torch.Tensor,  # (C,) candidate slots per core
    big_k: int,
    n_rows: int,
    slot_to_row: Optional[torch.Tensor] = None,  # (C, L) slot -> global row id
    tombstones: Optional[torch.Tensor] = None,   # (n_rows,) bool deleted ids
    row_map: Optional[torch.Tensor] = None,      # (L2,) local -> global row id
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask sentinels/tombstones, globalize slot ids, merge per query -> (Q, big_k).

    Pure-base snapshots use ``row_starts + local``; segmented ones look slots
    up in ``slot_to_row``, whose ``INVALID_ROW`` entries retire dead slots.
    ``tombstones`` masks deleted global ids, and ``row_map`` (a shard-local
    to collection-wide id map) applies last, so ``n_rows`` is then the
    collection's sentinel.
    """
    local_rows = local_rows.long()
    valid = local_rows < rows_per_part[:, None, None]
    if slot_to_row is None:
        global_rows = local_rows + row_starts[:, None, None]
    else:
        c, q, k = local_rows.shape
        idx = torch.clamp(local_rows, 0, slot_to_row.shape[1] - 1).reshape(c, q * k)
        global_rows = torch.gather(slot_to_row, 1, idx).reshape(c, q, k).long()
        valid = valid & (global_rows != int(INVALID_ROW))
    if tombstones is not None:
        safe = torch.clamp(global_rows, 0, tombstones.shape[0] - 1)
        valid = valid & ~tombstones[safe]
    if row_map is not None:
        safe = torch.clamp(global_rows, 0, row_map.shape[0] - 1)
        global_rows = row_map[safe].long()
        valid = valid & (global_rows != int(INVALID_ROW))
    vals = torch.where(valid, local_vals, NEG_INF)
    rows = torch.where(valid, global_rows, n_rows)
    nq = vals.shape[1]
    return partition_lib.merge_rows_topk(
        vals.permute(1, 0, 2).reshape(nq, -1),
        rows.permute(1, 0, 2).reshape(nq, -1),
        big_k, n_rows,
    )


def finalize_candidates(local_vals, local_rows, row_starts, rows_per_part, big_k: int,
                        n_rows: int, slot_to_row=None, tombstones=None, row_map=None):
    """Single-query finalize over the (C, k) candidates -> (big_k,) each."""
    v, r = finalize_candidates_batched(
        local_vals[:, None], local_rows[:, None], row_starts, rows_per_part, big_k,
        n_rows, slot_to_row=slot_to_row, tombstones=tombstones, row_map=row_map,
    )
    return v[0], r[0]


def finalize_tensors(packed: PackedPartitions, device) -> dict:
    """The finalize inputs of a snapshot as tensors on ``device``.

    The tombstone bitmap goes along whenever the snapshot carries one (a
    mutable index always does, bucket-padded with False), not only when a
    bit is set: the first delete then changes a tensor's contents, not the
    executor signature.
    """
    kw = dict(
        row_starts=host_tensor(packed.row_starts.astype(np.int64), device),
        rows_per_part=host_tensor(packed.candidate_slots.astype(np.int64), device),
        n_rows=packed.n_rows_logical,
    )
    if packed.slot_to_row is not None:
        kw["slot_to_row"] = host_tensor(packed.slot_to_row, device)
    if packed.tombstones is not None:
        kw["tombstones"] = host_tensor(packed.tombstones, device)
    return kw


def resolve_gather_mode(gather_mode: str) -> str:
    """"auto" -> "take"; the port serves every mode with the same gather."""
    if gather_mode == "auto":
        return "take"
    if gather_mode not in GATHER_MODES:
        raise ValueError(f"gather_mode must be 'auto' or one of {GATHER_MODES}, "
                         f"got {gather_mode!r}")
    return gather_mode


def _query_tensor(x, device, ndim: int) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.dim() != ndim or (ndim == 2 and x.shape[0] == 0):
        want = "an (M,) query" if ndim == 1 else "a non-empty (Q, M) batch"
        raise ValueError(f"x must be {want}, got {tuple(x.shape)}")
    return x.contiguous()


def uses_groups(packed: PackedPartitions) -> bool:
    """True when the kernels stream ``packed``'s tagged width-class groups.

    A mixed-precision snapshot in the split layout streams its f32 twins
    instead, as the reference does.
    """
    return packed.groups is not None and packed.stream_layout == "fused"


def kernel_words(packed: PackedPartitions) -> np.ndarray:
    """The one fused word array a uniform dispatch streams: the snapshot's
    fused words, or, for a mixed snapshot, its f32 twins fused."""
    if packed.groups is None:
        return packed.fused_words()
    return bscsr_lib.fuse_words(packed.vals, packed.cols, packed.flags)


def group_tensors(packed: PackedPartitions, device) -> Tuple[tuple, ...]:
    """``(class name, cores, words)`` of each group, tensors on ``device``."""
    return tuple(
        (g.class_name, host_tensor(np.asarray(g.cores, np.int64), device),
         host_tensor(g.words, device))
        for g in packed.groups
    )


def grouped_local_topk(x: torch.Tensor, groups, *, n_cores: int, k: int, n_rows: int,
                       batched: bool, tables=None, gather_mode: str = "take",
                       **kernel_kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixed-precision top-k: one kernel call per width class.

    ``groups`` is ``group_tensors``' tuple; ``tables`` optionally gives each
    group's split table, at the kernel's S for that group's core count
    (without it each kernel call builds its own).  Each group's per-core
    scratchpads are scattered back into the snapshot's ``(C, [Q,] k)`` core
    order; every core belongs to exactly one group.
    """
    shape = (n_cores, x.shape[0], k) if batched else (n_cores, k)
    lv = torch.full(shape, NEG_INF, dtype=torch.float32, device=x.device)
    lr = torch.full(shape, n_rows, dtype=torch.int32, device=x.device)
    for i, (cname, cores, words) in enumerate(groups):
        kw = dict(kernel_kw, k=k, n_rows=n_rows, fmt_name=cname,
                  table=None if tables is None else tables[i])
        if batched:
            gv, gr = bscsr_topk_spmv_multiquery(x, words, **kw)
        else:
            gv, gr = bscsr_topk_spmv(x, words, gather_mode=gather_mode, **kw)
        lv[cores] = gv
        lr[cores] = gr
    return lv, lr


def grouped_slot_sums(x: torch.Tensor, groups, *, n_cores: int, n_rows: int,
                      tables=None, **kernel_kw) -> torch.Tensor:
    """Mixed-precision accumulate: one kernel call per width class, each
    group's per-core slot sums scattered back into ``(C, L)`` core order."""
    sums = torch.zeros((n_cores, n_rows), dtype=torch.float32, device=x.device)
    for i, (cname, cores, words) in enumerate(groups):
        if tables is None:
            split = dict(splits=spmv_splits(
                words.device, words.shape[0], packets_per_step=kernel_kw["packets_per_step"],
                block_size=kernel_kw["block_size"], m=x.shape[0]))
        else:
            split = dict(table=tables[i])
        sums[cores] = bscsr_spmv(x, words, n_rows=n_rows, fmt_name=cname, **split,
                                 **kernel_kw)
    return sums


def topk_spmv_blocked(
    x,
    packed: PackedPartitions,
    big_k: int,
    k: int = 8,
    packets_per_step: int = 2,
    gather_mode: str = "take",
    inner_loop: str = "linear",
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query through the single-query kernel, uploading the snapshot.

    A mixed-precision snapshot runs the kernel once per width-class group.
    """
    x = _query_tensor(x, device, 1)
    kw = dict(k=k, n_rows=packed.max_slots, packets_per_step=packets_per_step,
              block_size=packed.block_size, gather_mode=resolve_gather_mode(gather_mode),
              inner_loop=inner_loop)
    if uses_groups(packed):
        lv, lr = grouped_local_topk(x, group_tensors(packed, device),
                                    n_cores=packed.num_cores, batched=False, **kw)
    else:
        lv, lr = bscsr_topk_spmv(x, host_tensor(kernel_words(packed), device),
                                 fmt_name=packed.value_format.name, **kw)
    return finalize_candidates(lv, lr, big_k=big_k, **finalize_tensors(packed, device))


def topk_spmv_batched(
    xs,
    packed: PackedPartitions,
    big_k: int,
    k: int = 8,
    packets_per_step: int = 2,
    inner_loop: str = "linear",
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Q queries in ONE pass over the stream via the multi-query kernel
    (one pass per width-class group of a mixed-precision snapshot)."""
    xs = _query_tensor(xs, device, 2)
    kw = dict(k=k, n_rows=packed.max_slots, packets_per_step=packets_per_step,
              block_size=packed.block_size, inner_loop=inner_loop)
    if uses_groups(packed):
        lv, lr = grouped_local_topk(xs, group_tensors(packed, device),
                                    n_cores=packed.num_cores, batched=True, **kw)
    else:
        lv, lr = bscsr_topk_spmv_multiquery(xs, host_tensor(kernel_words(packed), device),
                                            fmt_name=packed.value_format.name, **kw)
    return finalize_candidates_batched(lv, lr, big_k=big_k,
                                       **finalize_tensors(packed, device))


def split_tensors(packed: PackedPartitions, device) -> Tuple[torch.Tensor, ...]:
    """The split (vals, cols, flags) streams as tensors on ``device``."""
    return tuple(host_tensor(a, device) for a in (packed.vals, packed.cols, packed.flags))


def reference_local_topk(xs: torch.Tensor, vals, cols, flags, rows_per_part,
                         max_slots: int, k: int, fmt: ValueFormat):
    """The oracle's per-core top-k for a (Q, M) batch, one query at a time."""
    outs = [
        ref_lib.bscsr_topk_ref_stacked(vals, cols, flags, x, rows_per_part, max_slots,
                                       k, fmt)
        for x in xs
    ]
    return torch.stack([v for v, _ in outs], 1), torch.stack([r for _, r in outs], 1)


def topk_spmv_reference_batched(
    xs,
    packed: PackedPartitions,
    big_k: int,
    k: int = 8,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same partitioned approximation for a (Q, M) batch, via the torch oracle."""
    fin = finalize_tensors(packed, device)
    lv, lr = reference_local_topk(
        _query_tensor(xs, device, 2), *split_tensors(packed, device),
        fin["rows_per_part"], packed.max_slots, k, packed.value_format,
    )
    return finalize_candidates_batched(lv, lr, big_k=big_k, **fin)


def topk_spmv_reference(x, packed: PackedPartitions, big_k: int, k: int = 8,
                        device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """One query via the torch oracle."""
    v, r = topk_spmv_reference_batched(
        _query_tensor(x, device, 1)[None], packed, big_k, k, device
    )
    return v[0], r[0]


# ---------------------------------------------------------------------------
# Accumulate mode: y = alpha * A @ x + beta * y.  The kernel (or the torch
# oracle) emits raw per-core slot sums, and the masking finalize would apply
# to candidates (live-slot counts, retired slots, tombstoned ids, a row map)
# moves into the dense scatter below.  finalize_candidates never sees this
# output: its NEG_INF sentinel algebra is top-k specific.
# ---------------------------------------------------------------------------

def scatter_slot_sums(
    slot_sums: torch.Tensor,       # (C, L) raw per-core slot sums
    row_starts: torch.Tensor,      # (C,)
    rows_per_part: torch.Tensor,   # (C,) live candidate slots per core
    n_out: int,                    # output length (global row space)
    slot_to_row: Optional[torch.Tensor] = None,  # (C, L) slot -> global row
    tombstones: Optional[torch.Tensor] = None,   # bool bitmap over global ids
    row_map: Optional[torch.Tensor] = None,      # (L2,) local -> global row id
) -> torch.Tensor:
    """Scatter per-core slot sums into one dense (n_out,) vector.

    Invalid lanes (padded slots past a core's live count, retired slots,
    tombstoned rows, rows the ``row_map`` marks invalid) leave their output
    at exactly 0.0.  Each live row holds exactly one slot on one core, so
    the store is a masked scatter with unique indices: every output element
    holds the bits of ``0.0 + slot_sum``, as the reference's ``.at[].add``
    onto zeros gives it (no float atomics, whose order varies).
    """
    c, l = slot_sums.shape
    dev = slot_sums.device
    slots = torch.arange(l, device=dev).expand(c, l)
    valid = slots < rows_per_part[:, None]
    if slot_to_row is None:
        rows = slots + row_starts[:, None]
    else:
        rows = slot_to_row.long()
        valid = valid & (rows != int(INVALID_ROW))
    if tombstones is not None:
        valid = valid & ~tombstones[torch.clamp(rows, 0, tombstones.shape[0] - 1)]
    if row_map is not None:
        rows = row_map[torch.clamp(rows, 0, row_map.shape[0] - 1)].long()
        valid = valid & (rows != int(INVALID_ROW))
    valid = valid & (rows >= 0) & (rows < n_out)
    # Invalid lanes store 0.0 into a sink element past the end, so the store
    # keeps a static shape and never syncs with the host.
    out = torch.zeros(n_out + 1, dtype=torch.float32, device=dev)
    out[torch.where(valid, rows, n_out)] = torch.where(valid, slot_sums, 0.0) + 0.0
    return out[:n_out]


def accumulate_epilogue(sums: torch.Tensor, tensors: dict, n_out: int, alpha, beta,
                        y=None) -> torch.Tensor:
    """``alpha * scatter(sums) + beta * y`` (``alpha * scatter(sums)`` without y).

    ``tensors`` holds a snapshot's finalize tensors (``finalize_tensors`` or a
    pinned ``DeviceSnapshot.finalize``).  Every accumulate entry point ends
    here, so the expression order that fixes the result's bits is written once.
    """
    ax = scatter_slot_sums(sums, n_out=n_out,
                           **{k: v for k, v in tensors.items() if k != "n_rows"})
    if y is None:
        return alpha * ax
    return alpha * ax + beta * y


def bscsr_spmv_blocked(
    x,
    packed: PackedPartitions,
    *,
    alpha=1.0,
    beta=0.0,
    y=None,
    n_out: Optional[int] = None,
    packets_per_step: int = 2,
    gather_mode: str = "take",
    inner_loop: str = "linear",
    device="cuda",
) -> torch.Tensor:
    """``y = alpha * A @ x + beta * y`` via the accumulate kernel, uploading
    the snapshot (one launch per width-class group of a mixed-precision
    snapshot).  Iterative workloads go through ``QueryExecutor.spmv``."""
    if n_out is None:
        n_out = int(y.shape[0]) if y is not None else packed.n_rows_logical
    x = _query_tensor(x, device, 1)
    kw = dict(packets_per_step=packets_per_step, block_size=packed.block_size,
              gather_mode=resolve_gather_mode(gather_mode), inner_loop=inner_loop)
    if uses_groups(packed):
        sums = grouped_slot_sums(x, group_tensors(packed, device), n_cores=packed.num_cores,
                                 n_rows=packed.max_slots, **kw)
    else:
        words = host_tensor(kernel_words(packed), device)
        sums = bscsr_spmv(
            x, words, n_rows=packed.max_slots, fmt_name=packed.value_format.name,
            splits=spmv_splits(words.device, words.shape[0],
                               packets_per_step=packets_per_step,
                               block_size=packed.block_size, m=x.shape[0]),
            **kw)
    if y is not None:
        y = torch.as_tensor(y, dtype=torch.float32, device=device)
    return accumulate_epilogue(sums, finalize_tensors(packed, device), n_out, alpha, beta, y)


def bscsr_spmv_reference(
    x,
    packed: PackedPartitions,
    *,
    alpha=1.0,
    beta=0.0,
    y=None,
    n_out: Optional[int] = None,
    device="cuda",
) -> torch.Tensor:
    """Accumulate mode via the torch oracle (same masking epilogue)."""
    if n_out is None:
        n_out = int(y.shape[0]) if y is not None else packed.n_rows_logical
    sums = ref_lib.bscsr_slot_sums_stacked(
        *split_tensors(packed, device), _query_tensor(x, device, 1),
        packed.max_slots, packed.value_format,
    )
    if y is not None:
        y = torch.as_tensor(y, dtype=torch.float32, device=device)
    return accumulate_epilogue(sums, finalize_tensors(packed, device), n_out, alpha, beta, y)
