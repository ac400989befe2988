"""Block-Streaming CSR (BS-CSR) — the paper's §III-B layout, host side.

A copy of the encode plane of ``repro.core.bscsr`` for the PyTorch port:
the same tile-packet streams, byte for byte (the tests pin every array).

  vals   (P, B)        float32 | bf16 bits (uint16) | int16/int8 Q-format
  cols   (P, B)        int32 | int16 (int16 when n_cols <= 32767)
  flags  (P, B // 32)  int32 bit-pack, bit i set <=> nnz i starts a new row

The running row id of nnz ``t`` in a stream is ``popcount(flags[:t+1]) - 1``.
An empty row gets one placeholder (col 0, val 0) nnz, and one trailing
sentinel row-start closes the last real row.  Padding packets carry no
row-start flags, so they only extend the open sentinel row.

The fused form packs each packet's ``flags | cols | vals`` into one int32
word row (little-endian sub-words: value ``2i`` in the low half of a word),
so one kernel program streams one contiguous region per packet::

  word index   0 ........ B/32-1 | B/32 ....... B/32+Wc-1 | ............ end
  packet row   | flags (B bits)  | cols (int16 pairs or   | vals (storage   |
  (W int32)    |                 |  int32 ids)            |  width)         |

The synthetic collection generator draws its random keys in row chunks, so
a 10M-row collection never holds a (n_rows, max_len) key matrix; the random
stream is consumed in the same order, so the output is byte-identical.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.quantization import F32, FORMATS, ValueFormat, host_dequantize, quantize

FLAG_WORD_BITS = 32


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Plain host-side CSR."""

    indptr: np.ndarray   # (N+1,) int64
    indices: np.ndarray  # (nnz,) int32
    data: np.ndarray     # (nnz,) float32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def to_dense(self) -> np.ndarray:
        n, m = self.shape
        out = np.zeros((n, m), dtype=np.float32)
        rows = np.repeat(np.arange(n), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out

    def row_slice(self, start: int, stop: int) -> "CSRMatrix":
        """Rows [start, stop) as a new CSR — used by the partitioner (§III-A)."""
        lo, hi = int(self.indptr[start]), int(self.indptr[stop])
        return CSRMatrix(
            indptr=(self.indptr[start : stop + 1] - lo).astype(np.int64),
            indices=self.indices[lo:hi],
            data=self.data[lo:hi],
            shape=(stop - start, self.shape[1]),
        )


@dataclasses.dataclass(frozen=True)
class BSCSRMatrix:
    """Tile-packet BS-CSR stream for one partition (one 'core')."""

    vals: np.ndarray          # (P, B) storage dtype
    cols: np.ndarray          # (P, B) int32/int16
    flags: np.ndarray         # (P, B // 32) int32 bit-pack (row-start bits)
    n_rows: int               # real rows (excludes the sentinel row)
    n_cols: int
    nnz: int                  # real non-zeros (excludes placeholders/padding)
    block_size: int           # B
    value_format: ValueFormat

    @property
    def num_packets(self) -> int:
        return int(self.vals.shape[0])

    @property
    def stream_bytes(self) -> int:
        return self.vals.nbytes + self.cols.nbytes + self.flags.nbytes

    @property
    def bytes_per_nnz(self) -> float:
        return self.stream_bytes / max(self.nnz, 1)

    def fused_words(self) -> np.ndarray:
        """This stream's fused single-stream form (see :func:`fuse_stream`)."""
        return fuse_stream(self)


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """(..., B) bool -> (..., B//32) int32 little-endian bit-pack."""
    b = bits.shape[-1]
    if b % FLAG_WORD_BITS:
        raise ValueError("block size must be a multiple of 32")
    words = bits.reshape(*bits.shape[:-1], b // FLAG_WORD_BITS, FLAG_WORD_BITS)
    weights = (1 << np.arange(FLAG_WORD_BITS, dtype=np.int64))
    packed = (words.astype(np.int64) * weights).sum(axis=-1)
    # Keep values in int32 range via wrap (bit 31 becomes the sign bit).
    return packed.astype(np.uint32).view(np.int32)


def unpack_bits(packed: np.ndarray, block_size: int) -> np.ndarray:
    """(..., B//32) int32 -> (..., B) bool. Host-side inverse (tests/debug)."""
    w = packed.view(np.uint32).astype(np.uint64)
    shifts = np.arange(FLAG_WORD_BITS, dtype=np.uint64)
    bits = (w[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], block_size).astype(bool)


def col_index_dtype(n_cols: int) -> np.dtype:
    """Paper: 'realistic size bounds (idx < 1024) allow much greater coalescing'."""
    return np.dtype(np.int16) if n_cols <= np.iinfo(np.int16).max else np.dtype(np.int32)


def encode_bscsr(
    csr: CSRMatrix,
    block_size: int = 256,
    value_format: ValueFormat | str = "F32",
    pad_packets_to: Optional[int] = None,
) -> BSCSRMatrix:
    """Encode a CSR partition into the BS-CSR tile-packet stream."""
    fmt = FORMATS[value_format] if isinstance(value_format, str) else value_format
    n, m = csr.shape
    row_lens = np.diff(csr.indptr)

    # Insert a placeholder nnz for every empty row so the stream's row counter
    # stays aligned with real row ids (paper's placeholder-0 rule).
    if (row_lens == 0).any():
        out_lens = np.maximum(row_lens, 1)
        total = int(out_lens.sum())
        vals = np.zeros(total, dtype=np.float32)
        cols = np.zeros(total, dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(out_lens)])[:-1]
        dst = np.repeat(starts, row_lens) + (
            np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], row_lens)
        )
        vals[dst] = csr.data
        cols[dst] = csr.indices
        row_starts = starts
        total_nnz = total
    else:
        vals = csr.data.astype(np.float32)
        cols = csr.indices.astype(np.int64)
        row_starts = csr.indptr[:-1]
        total_nnz = csr.nnz

    # Row-start flags + one sentinel row-start that closes the final real row.
    flags = np.zeros(total_nnz + 1, dtype=bool)
    flags[row_starts] = True
    flags[total_nnz] = True
    vals = np.concatenate([vals, np.zeros(1, dtype=np.float32)])
    cols = np.concatenate([cols, np.zeros(1, dtype=np.int64)])

    # Pad to a whole number of packets (padding continues the sentinel row).
    stream_len = total_nnz + 1
    num_packets = math.ceil(stream_len / block_size)
    if pad_packets_to is not None:
        num_packets = max(num_packets, pad_packets_to)
    padded = num_packets * block_size
    pad = padded - stream_len
    vals = np.concatenate([vals, np.zeros(pad, dtype=np.float32)])
    cols = np.concatenate([cols, np.zeros(pad, dtype=np.int64)])
    flags = np.concatenate([flags, np.zeros(pad, dtype=bool)])

    cdtype = col_index_dtype(m)
    return BSCSRMatrix(
        vals=quantize(vals, fmt).reshape(num_packets, block_size),
        cols=cols.astype(cdtype).reshape(num_packets, block_size),
        flags=_pack_bits(flags.reshape(num_packets, block_size)),
        n_rows=n,
        n_cols=m,
        nnz=csr.nnz,
        block_size=block_size,
        value_format=fmt,
    )


def pad_packets(bs: BSCSRMatrix, num_packets: int) -> BSCSRMatrix:
    """Extend an encoded stream to ``num_packets`` with empty tail packets.

    Padding continues the sentinel row (zero vals/cols, no row-start flags),
    so the result is identical to encoding with ``pad_packets_to``.
    """
    pad = num_packets - bs.num_packets
    if pad < 0:
        raise ValueError(
            f"cannot shrink a stream: have {bs.num_packets} packets, "
            f"asked for {num_packets}"
        )
    if pad == 0:
        return bs
    return dataclasses.replace(
        bs,
        vals=np.concatenate(
            [bs.vals, np.zeros((pad, bs.block_size), dtype=bs.vals.dtype)]
        ),
        cols=np.concatenate(
            [bs.cols, np.zeros((pad, bs.block_size), dtype=bs.cols.dtype)]
        ),
        flags=np.concatenate(
            [bs.flags, np.zeros((pad, bs.flags.shape[1]), dtype=bs.flags.dtype)]
        ),
    )


# ---------------------------------------------------------------------------
# Fused single-stream packet layout (see module docstring diagram)
# ---------------------------------------------------------------------------

STREAM_LAYOUTS = ("split", "fused")


def fused_word_counts(
    block_size: int, value_format: ValueFormat | str, col_dtype
) -> Tuple[int, int, int]:
    """(flag, col, val) int32 words per fused packet of ``block_size`` nnz."""
    fmt = FORMATS[value_format] if isinstance(value_format, str) else value_format
    col_bytes = np.dtype(col_dtype).itemsize
    val_bytes = int(fmt.bytes_per_value)
    if block_size % FLAG_WORD_BITS:
        raise ValueError("block size must be a multiple of 32")
    if (block_size * col_bytes) % 4 or (block_size * val_bytes) % 4:
        raise ValueError("block size must pack cols/vals into whole int32 words")
    return (
        block_size // FLAG_WORD_BITS,
        block_size * col_bytes // 4,
        block_size * val_bytes // 4,
    )


def fuse_words(
    vals: np.ndarray, cols: np.ndarray, flags: np.ndarray, tag: Optional[int] = None
) -> np.ndarray:
    """Pack split ``(..., B)``/``(..., B//32)`` arrays into fused int32 words.

    ``tag`` (mixed-precision snapshots only) prepends one header word per
    packet row carrying the partition's value-format code.
    """
    flag_w = np.ascontiguousarray(flags)
    col_w = np.ascontiguousarray(cols).view(np.int32)
    val_w = np.ascontiguousarray(vals).view(np.int32)
    parts = [flag_w, col_w, val_w]
    if tag is not None:
        header = np.full(flag_w.shape[:-1] + (1,), int(tag), dtype=np.int32)
        parts.insert(0, header)
    return np.concatenate(parts, axis=-1)


def fuse_stream(bs: BSCSRMatrix, tagged: bool = False) -> np.ndarray:
    """A stream's fused ``(P, W)`` int32 word form (see :func:`fuse_words`)."""
    tag = bs.value_format.code if tagged else None
    return fuse_words(bs.vals, bs.cols, bs.flags, tag=tag)


def defuse_stream(
    words: np.ndarray,
    block_size: int,
    value_format: ValueFormat | str,
    col_dtype,
    tagged: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fused ``(P, W)`` words -> ``(vals, cols, flags)`` split arrays (host)."""
    fmt = FORMATS[value_format] if isinstance(value_format, str) else value_format
    wf, wc, wv = fused_word_counts(block_size, fmt, col_dtype)
    header = 1 if tagged else 0
    if words.shape[-1] != header + wf + wc + wv:
        raise ValueError(
            f"fused stream width {words.shape[-1]} != expected "
            f"{header + wf + wc + wv} (B={block_size}, fmt={fmt.name}, "
            f"cols={np.dtype(col_dtype).name}, tagged={tagged})"
        )
    if tagged:
        tags = words[..., 0]
        if tags.size and not (tags == fmt.code).all():
            raise ValueError(
                f"tagged stream header mismatch: expected code {fmt.code} "
                f"({fmt.name}), saw {sorted(np.unique(tags).tolist())}"
            )
        words = words[..., 1:]
    flags = np.ascontiguousarray(words[..., :wf])
    cols = np.ascontiguousarray(words[..., wf : wf + wc]).view(np.dtype(col_dtype))
    vals = np.ascontiguousarray(words[..., wf + wc :]).view(fmt.np_dtype)
    return vals, cols, flags


def dequantize_stream(bs: BSCSRMatrix) -> BSCSRMatrix:
    """An F32 twin of a stream: values exactly dequantized on the host.

    Mixed-precision snapshots keep these as their split arrays, so the
    oracle and the delta machinery see one dtype; the native bytes live in
    the tagged fused groups.  Every ladder format dequantizes exactly.
    """
    if bs.value_format.storage_dtype == "float32":
        return bs
    return dataclasses.replace(
        bs, vals=host_dequantize(bs.vals, bs.value_format), value_format=F32
    )


def requantize_stream(bs: BSCSRMatrix, fmt: ValueFormat) -> BSCSRMatrix:
    """Re-encode a stream's values in another format, structure-preserving.

    Only the value payload changes: flags and cols (and the slot structure a
    mutable index aligns with them) stay, so a per-partition promotion never
    invalidates delta segments or the host-side slot bookkeeping.
    """
    if fmt == bs.value_format:
        return bs
    vals = host_dequantize(bs.vals, bs.value_format)
    return dataclasses.replace(bs, vals=quantize(vals, fmt), value_format=fmt)


INVALID_ROW = np.int32(np.iinfo(np.int32).max)
"""Slot-map entry for a dead candidate slot (sentinel / tombstoned row)."""


# ---------------------------------------------------------------------------
# Base / delta / tombstone layout of a mutable index.  Global row ids are
# never stored, so a stream grows by appending a delta segment's packets:
# the delta's first row-start closes the base's open sentinel row, which
# becomes a dead slot, and the appended rows take the slots after it.
# ---------------------------------------------------------------------------

def encode_delta_rows(
    rows: Sequence[Tuple[np.ndarray, np.ndarray]],
    n_cols: int,
    block_size: int = 256,
    value_format: ValueFormat | str = "F32",
) -> BSCSRMatrix:
    """Encode appended ``(indices, data)`` rows as a delta BS-CSR stream."""
    lens = np.array([len(idx) for idx, _ in rows], dtype=np.int64)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    if len(rows):
        indices = np.concatenate([np.asarray(i, np.int32) for i, _ in rows])
        data = np.concatenate([np.asarray(d, np.float32) for _, d in rows])
    else:
        indices = np.zeros(0, np.int32)
        data = np.zeros(0, np.float32)
    csr = CSRMatrix(indptr=indptr, indices=indices, data=data,
                    shape=(len(rows), n_cols))
    return encode_bscsr(csr, block_size=block_size, value_format=value_format)


def append_packets(
    base: BSCSRMatrix, delta: BSCSRMatrix, pad_packets_to: Optional[int] = None
) -> BSCSRMatrix:
    """Concatenate a delta segment's packets after ``base`` — no re-encode.

    ``n_rows`` of the result counts slots: base rows, the dead sentinel
    slot, then the delta rows.
    """
    if base.block_size != delta.block_size:
        raise ValueError(
            f"block size mismatch: base {base.block_size}, delta {delta.block_size}"
        )
    if base.value_format != delta.value_format:
        raise ValueError(
            f"value format mismatch: base {base.value_format.name}, "
            f"delta {delta.value_format.name}"
        )
    if base.cols.dtype != delta.cols.dtype:
        raise ValueError("column index dtype mismatch between segments")
    out = BSCSRMatrix(
        vals=np.concatenate([base.vals, delta.vals]),
        cols=np.concatenate([base.cols, delta.cols]),
        flags=np.concatenate([base.flags, delta.flags]),
        n_rows=base.n_rows + 1 + delta.n_rows,
        n_cols=max(base.n_cols, delta.n_cols),
        nnz=base.nnz + delta.nnz,
        block_size=base.block_size,
        value_format=base.value_format,
    )
    if pad_packets_to is not None:
        out = pad_packets(out, pad_packets_to)
    return out


@dataclasses.dataclass
class TombstoneBitmap:
    """Deleted global row ids, as a grow-only host-side bitmap.

    Marked ids are masked out of every merge until an upsert resurrects
    them; the bitmap survives compaction.
    """

    bits: np.ndarray  # (n,) bool

    @classmethod
    def empty(cls, n_rows: int) -> "TombstoneBitmap":
        return cls(bits=np.zeros(max(n_rows, 1), dtype=bool))

    def grow(self, n_rows: int) -> None:
        if n_rows > self.bits.shape[0]:
            self.bits = np.concatenate(
                [self.bits, np.zeros(n_rows - self.bits.shape[0], dtype=bool)]
            )

    def mark(self, row_ids) -> None:
        self.grow(int(np.max(row_ids)) + 1)
        self.bits[np.asarray(row_ids, np.int64)] = True

    def clear(self, row_ids) -> None:
        ids = np.asarray(row_ids, np.int64)
        ids = ids[ids < self.bits.shape[0]]
        self.bits[ids] = False

    def __contains__(self, row_id: int) -> bool:
        return 0 <= row_id < self.bits.shape[0] and bool(self.bits[row_id])

    @property
    def count(self) -> int:
        return int(self.bits.sum())


def decode_bscsr(bs: BSCSRMatrix) -> CSRMatrix:
    """Stream -> CSR (host; the row-recovery semantics, for tests)."""
    flags = unpack_bits(bs.flags, bs.block_size).reshape(-1)
    vals = host_dequantize(bs.vals.reshape(-1), bs.value_format)
    cols = bs.cols.reshape(-1).astype(np.int64)
    row_ids = np.cumsum(flags) - 1
    keep = row_ids < bs.n_rows  # drop sentinel + padding
    vals, cols, row_ids = vals[keep], cols[keep], row_ids[keep]
    # Drop placeholder zeros that were inserted for empty rows.
    real = vals != 0.0
    counts = np.bincount(row_ids[real], minlength=bs.n_rows)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return CSRMatrix(
        indptr=indptr,
        indices=cols[real].astype(np.int32),
        data=vals[real].astype(np.float32),
        shape=(bs.n_rows, bs.n_cols),
    )


# ---------------------------------------------------------------------------
# Synthetic matrix generation (paper Table III: Uniform and Gamma(3, 4/3))
# ---------------------------------------------------------------------------

_KEY_CHUNK_ELEMS = 1 << 24  # random keys drawn per chunk (128 MiB of float64)


def _sample_columns(rng, lens: np.ndarray, indptr: np.ndarray) -> np.ndarray:
    """Per row, the sorted positions of its ``lens[i]`` smallest random keys.

    The reference draws one ``(n_rows, max_len)`` key matrix, argsorts each
    row and keeps the first ``lens[i]`` positions, sorted.  With distinct
    keys that set is exactly the positions whose key is at most the row's
    ``lens[i]``-th smallest key, and ``np.nonzero`` already yields them in
    ascending order.  Keys are drawn chunk by chunk from the same generator,
    which consumes its stream in order, so the output is byte-identical.  A
    row whose keys tie at its threshold (the mask then selects too many
    positions) is redone with the reference's own argsort.
    """
    n_rows = lens.shape[0]
    max_len = int(lens.max())
    indices = np.empty(int(indptr[-1]), dtype=np.int32)
    chunk = max(1, _KEY_CHUNK_ELEMS // max_len)
    for lo in range(0, n_rows, chunk):
        hi = min(n_rows, lo + chunk)
        keys = rng.random((hi - lo, max_len))
        ln = lens[lo:hi]
        thr = np.sort(keys, axis=1)[np.arange(hi - lo), ln - 1]
        mask = keys <= thr[:, None]
        counts = mask.sum(axis=1)
        tied = np.nonzero(counts != ln)[0]
        block = indices[indptr[lo] : indptr[hi]]
        if tied.size:
            mask[tied] = False
            ok = np.ones(hi - lo, dtype=bool)
            ok[tied] = False
            block[np.repeat(ok, ln)] = np.nonzero(mask)[1]
        else:
            block[:] = np.nonzero(mask)[1]
        for t in tied:
            i = lo + int(t)
            order = np.argsort(keys[t])[: lens[i]]
            indices[indptr[i] : indptr[i + 1]] = np.sort(order)
    return indices


def synthetic_embedding_csr(
    n_rows: int,
    n_cols: int,
    mean_nnz_per_row: float,
    distribution: str = "uniform",
    seed: int = 0,
    normalize: bool = True,
) -> CSRMatrix:
    """Random sparse embedding collection matching the paper's evaluation set."""
    rng = np.random.default_rng(seed)
    if distribution == "uniform":
        lens = rng.integers(1, int(2 * mean_nnz_per_row), size=n_rows)
    elif distribution == "gamma":
        # Paper: Gamma(k=3, theta=4/3) scaled to the target mean (left-skewed).
        raw = rng.gamma(shape=3.0, scale=4.0 / 3.0, size=n_rows)
        lens = np.maximum(1, np.round(raw * (mean_nnz_per_row / 4.0))).astype(np.int64)
    else:
        raise ValueError(f"unknown distribution {distribution!r}")
    lens = np.minimum(lens, n_cols)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    indices = _sample_columns(rng, lens, indptr)
    nnz = int(indptr[-1])
    data = rng.standard_normal(nnz).astype(np.float32)
    if normalize:  # L2-normalize rows -> dot product == cosine similarity
        sq = np.add.reduceat(data * data, indptr[:-1])
        norms = np.sqrt(np.maximum(sq, 1e-12))
        data = data / np.repeat(norms, lens).astype(np.float32)
    return CSRMatrix(indptr=indptr, indices=indices, data=data, shape=(n_rows, n_cols))


def stream_bytes_per_nnz(
    value_format: ValueFormat | str, n_cols: int, block_size: int = 256
) -> float:
    """Exact bytes moved from HBM per non-zero with the tile-packet layout."""
    fmt = FORMATS[value_format] if isinstance(value_format, str) else value_format
    col_bytes = col_index_dtype(n_cols).itemsize
    flag_bytes = 1.0 / 8.0                      # 1 bit per nnz, bit-packed
    return fmt.bytes_per_value + col_bytes + flag_bytes


def scale_rows(csr: CSRMatrix, scales: np.ndarray) -> CSRMatrix:
    """Row-wise rescale of a CSR's values (``scales``: one factor per row).

    Models collections whose shards carry systematically different score
    magnitudes (hot vs cold partitions), where per-partition value
    precision pays: cold partitions tolerate aggressive quantization.
    """
    scales = np.asarray(scales, np.float32)
    if scales.shape != (csr.shape[0],):
        raise ValueError(f"need one scale per row, got {scales.shape}")
    data = csr.data * np.repeat(scales, np.diff(csr.indptr)).astype(np.float32)
    return dataclasses.replace(csr, data=data)


def sparsify_topm(dense: np.ndarray, m_keep: int, normalize: bool = True) -> CSRMatrix:
    """Magnitude-top-m sparsification of dense embeddings (GloVe stand-in, §V)."""
    n, m = dense.shape
    keep = np.argsort(-np.abs(dense), axis=1)[:, :m_keep]
    keep = np.sort(keep, axis=1)
    data = np.take_along_axis(dense, keep, axis=1).astype(np.float32)
    if normalize:
        norms = np.linalg.norm(data, axis=1, keepdims=True)
        data = data / np.maximum(norms, 1e-12)
    indptr = (np.arange(n + 1) * m_keep).astype(np.int64)
    return CSRMatrix(
        indptr=indptr,
        indices=keep.reshape(-1).astype(np.int32),
        data=data.reshape(-1),
        shape=(n, m),
    )
