"""Torch oracles for the BS-CSR Top-K SpMV kernels (tests + reference path).

``bscsr_row_scores`` evaluates the stream semantics end to end (row recovery
from flag bits + segment sums) without any blocking; ``bscsr_topk_ref_stacked``
is the per-core oracle the kernels and the reference query path are held
against.  It works on one query at a time: on the card a batch is a loop over
queries, so no (Q, nnz) product tensor is ever built.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.quantization import FORMATS, ValueFormat, dequantize

NEG_INF = float(np.finfo(np.float32).min)


def unpack_flags(flags: torch.Tensor, block_size: int) -> torch.Tensor:
    """(..., P, B//32) int32 -> (..., P*B) bool row-start bits (little-endian)."""
    shifts = torch.arange(32, dtype=torch.int32, device=flags.device)
    bits = (flags.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*flags.shape[:-2], -1).bool()


def topk_sorted(scores: torch.Tensor, big_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K over the last axis by value desc, ties toward the lower row id.

    Always returns ``big_k`` entries per row: when fewer scores exist the
    tail is padded with ``NEG_INF`` / sentinel row id ``n``.  One stable
    descending sort does it, since row ids are the positions.  -0.0 and +0.0
    compare equal, as in the reference's ``jnp.lexsort``.
    """
    n = scores.shape[-1]
    rows = torch.arange(n, dtype=torch.int32, device=scores.device)
    rows = rows.expand(scores.shape)
    if n < big_k:
        pad = scores.shape[:-1] + (big_k - n,)
        scores = torch.cat([scores, scores.new_full(pad, NEG_INF)], -1)
        rows = torch.cat([rows, rows.new_full(pad, n)], -1)
    order = torch.sort(scores + 0.0, dim=-1, descending=True, stable=True).indices
    top = order[..., :big_k]
    return torch.gather(scores, -1, top), torch.gather(rows, -1, top)


def _stream_row_ids(flags: torch.Tensor, block: int, max_rows: int) -> torch.Tensor:
    """(C, P, B//32) flags -> (C, P*B) flat segment index into (C, max_rows+1).

    Row ids past ``max_rows`` (sentinel and padding) fold into the extra
    segment ``max_rows`` of their core, which the callers drop.
    """
    f = unpack_flags(flags, block).to(torch.int32)
    row_ids = torch.cumsum(f, dim=-1, dtype=torch.int32) - 1
    row_ids = torch.clamp(row_ids, 0, max_rows)
    base = torch.arange(flags.shape[0], dtype=torch.int64, device=flags.device)
    return row_ids.long() + base[:, None] * (max_rows + 1)


def _gather_x(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """x[cols] with out-of-range ids (padding, negative int16) reading 0."""
    m = x.shape[-1]
    c = cols.long()
    oob = (c < 0) | (c >= m)
    return torch.where(oob, 0.0, x[torch.clamp(c, 0, m - 1)])


def bscsr_row_scores(
    vals: torch.Tensor,
    cols: torch.Tensor,
    flags: torch.Tensor,
    x: torch.Tensor,
    n_rows: int,
    fmt: ValueFormat | str = "F32",
) -> torch.Tensor:
    """All row scores of one BS-CSR stream (sentinel/padding rows dropped)."""
    fmt = FORMATS[fmt] if isinstance(fmt, str) else fmt
    seg = _stream_row_ids(flags[None], vals.shape[-1], n_rows)[0]
    prods = dequantize(vals.reshape(-1), fmt) * _gather_x(x.float(), cols.reshape(-1))
    sums = torch.zeros(n_rows + 1, dtype=torch.float32, device=vals.device)
    return sums.index_add_(0, seg, prods)[:n_rows]


def bscsr_topk_ref_stacked(
    vals: torch.Tensor,          # (C, P, B) storage dtype (bf16 as int16 bits)
    cols: torch.Tensor,          # (C, P, B)
    flags: torch.Tensor,         # (C, P, B//32)
    x: torch.Tensor,             # (M,) f32
    rows_per_core: torch.Tensor,  # (C,) real rows of each partition
    max_rows: int,
    k: int,
    fmt: ValueFormat | str = "F32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All cores' local top-k over a uniform ``max_rows`` slot budget.

    Slots at or beyond a core's real count sum to 0.0, not NEG_INF, so they
    are masked to NEG_INF before the local top-k: a padded slot budget must
    never let a phantom zero-score slot displace a real negative score.
    Returns (C, k) values and partition-local row ids.
    """
    scores = bscsr_slot_sums_stacked(vals, cols, flags, x, max_rows, fmt)
    live = torch.arange(max_rows, device=vals.device)[None, :] < rows_per_core[:, None]
    return topk_sorted(torch.where(live, scores, NEG_INF), k)


def bscsr_slot_sums_stacked(
    vals: torch.Tensor,          # (C, P, B) storage dtype (bf16 as int16 bits)
    cols: torch.Tensor,          # (C, P, B)
    flags: torch.Tensor,         # (C, P, B//32)
    x: torch.Tensor,             # (M,) f32
    max_rows: int,
    fmt: ValueFormat | str = "F32",
) -> torch.Tensor:
    """Accumulate-mode oracle: every core's raw per-slot row sums, (C, max_rows).

    No top-k and no NEG_INF masking: phantom and padded slots stay 0.0, as
    the accumulate kernel leaves them; the caller's slot->row scatter drops
    them.
    """
    fmt = FORMATS[fmt] if isinstance(fmt, str) else fmt
    c = vals.shape[0]
    seg = _stream_row_ids(flags, vals.shape[-1], max_rows).reshape(-1)
    prods = dequantize(vals.reshape(-1), fmt) * _gather_x(x.float(), cols.reshape(-1))
    sums = torch.zeros(c * (max_rows + 1), dtype=torch.float32, device=vals.device)
    return sums.index_add_(0, seg, prods).reshape(c, max_rows + 1)[:, :max_rows]


def csr_topk_numpy(indptr, indices, data, x, big_k: int):
    """Numpy CSR Top-K — the host-side 'sparse_dot_topn' style baseline."""
    prods = data * x[indices]
    scores = np.zeros(len(indptr) - 1, dtype=np.float32)
    np.add.at(scores, np.repeat(np.arange(len(indptr) - 1), np.diff(indptr)), prods)
    order = np.lexsort((np.arange(len(scores)), -scores))[:big_k]
    return scores[order], order.astype(np.int32)
