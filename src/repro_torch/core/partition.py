"""Row-partitioned approximate Top-K (paper §III-A) + the candidate merge.

The matrix is split into ``c`` row partitions ("cores").  Each core keeps
only its local top-``k`` (k < K, k*c >= K), and the union of the c*k
candidates is merged into the approximate Top-K.  ``PartitionPlan`` and
``partition_csr`` are host numpy; ``merge_topk`` and the sharded plane's
``tree_merge_topk`` run in torch on whatever device their candidates live on.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import bscsr as bscsr_lib
from repro_torch.core.precision_model import expected_precision

NEG_INF = float(np.finfo(np.float32).min)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """How N rows are split across c cores (and where each partition starts)."""

    n_rows: int
    num_partitions: int
    row_starts: Tuple[int, ...]   # (c,) global row id of each partition's row 0
    rows_per_partition: Tuple[int, ...]

    @staticmethod
    def build(n_rows: int, num_partitions: int) -> "PartitionPlan":
        base = n_rows // num_partitions
        rem = n_rows % num_partitions
        sizes = [base + (1 if i < rem else 0) for i in range(num_partitions)]
        starts = np.concatenate([[0], np.cumsum(sizes)])[:-1]
        return PartitionPlan(
            n_rows=n_rows,
            num_partitions=num_partitions,
            row_starts=tuple(int(s) for s in starts),
            rows_per_partition=tuple(sizes),
        )

    def expected_precision(self, k: int, big_k: int) -> float:
        return expected_precision(self.n_rows, self.num_partitions, k, big_k)


def partition_csr(
    csr: bscsr_lib.CSRMatrix, plan: PartitionPlan
) -> List[bscsr_lib.CSRMatrix]:
    """Split a CSR into the plan's row partitions (paper Fig. 2)."""
    return [
        csr.row_slice(start, start + size)
        for start, size in zip(plan.row_starts, plan.rows_per_partition)
    ]


def sort_desc_then_row(vals: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Order of each last-axis row by (value desc, row asc) — ``jnp.lexsort``.

    Two stable sorts: by row, then by value.  Values compare as the
    reference's sort does, with -0.0 equal to +0.0: adding 0.0 turns -0.0
    into +0.0 in the sort key only, so no backend's float ordering of the
    two zeros can leak into the tie-break.
    """
    by_row = torch.sort(rows, dim=-1, stable=True).indices
    key = torch.gather(vals, -1, by_row) + 0.0
    by_val = torch.sort(key, dim=-1, descending=True, stable=True).indices
    return torch.gather(by_row, -1, by_val)


Sentinel = Union[int, torch.Tensor, None]


def merge_rows_topk(
    vals: torch.Tensor,
    rows: torch.Tensor,
    big_k: int,
    n_rows: Sentinel = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``merge_topk`` over each row of a (B, n) candidate batch -> (B, big_k).

    ``n_rows`` may be an int or a 0-d tensor on the candidates' device (the
    sharded plane's pinned global sentinel), which is never read back.
    """
    vals = vals.to(torch.float32)
    rows = rows.to(torch.int32)
    if isinstance(n_rows, torch.Tensor):
        n_rows = n_rows.to(device=rows.device, dtype=torch.int32)
    if vals.shape[-1] < big_k:
        shape = vals.shape[:-1] + (big_k - vals.shape[-1],)
        sentinel = n_rows if n_rows is not None else int(np.iinfo(np.int32).max)
        vals = torch.cat([vals, vals.new_full(shape, NEG_INF)], -1)
        pad = (sentinel.expand(shape) if isinstance(sentinel, torch.Tensor)
               else rows.new_full(shape, sentinel))
        rows = torch.cat([rows, pad], -1)
    if n_rows is not None:
        # Every masked entry becomes the identical (NEG_INF, n_rows) pair, so
        # any tree of merges is bit-identical to the flat merge.
        masked = rows >= n_rows
        vals = torch.where(masked, NEG_INF, vals)
        rows = torch.where(masked, n_rows, rows)
    top = sort_desc_then_row(vals, rows)[..., :big_k]
    return torch.gather(vals, -1, top), torch.gather(rows, -1, top)


def merge_topk(
    cand_vals: torch.Tensor,
    cand_rows: torch.Tensor,
    big_k: int,
    n_rows: Sentinel = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge c*k candidates into the final Top-K (values desc, then row asc).

    ``cand_rows`` must already be global row ids.  Candidates with row id
    >= ``n_rows`` are masked.  The output is always ``(big_k,)``: a pool
    smaller than ``big_k`` is padded with masked sentinels.
    """
    v, r = merge_rows_topk(
        cand_vals.reshape(1, -1), cand_rows.reshape(1, -1), big_k, n_rows
    )
    return v[0], r[0]


def tree_merge_topk(
    pool_vals: Sequence[torch.Tensor],
    pool_rows: Sequence[torch.Tensor],
    big_k: int,
    n_rows: Sentinel = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-depth pairwise merge of per-shard candidate pools -> (big_k,).

    ``tree_merge_topk_batched`` on a batch of one query.
    """
    v, r = tree_merge_topk_batched([v.reshape(1, -1) for v in pool_vals],
                                   [r.reshape(1, -1) for r in pool_rows], big_k, n_rows)
    return v[0], r[0]


def tree_merge_topk_batched(
    pool_vals: Sequence[torch.Tensor],
    pool_rows: Sequence[torch.Tensor],
    big_k: int,
    n_rows: Sentinel = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-depth pairwise merge of ``(Q, pool)`` pools -> (Q, big_k).

    Adjacent pools merge pairwise, halving the pool count each level, each
    level one ``merge_rows_topk`` over every query's row at once.
    ``merge_rows_topk`` turns every masked entry into the identical
    ``(NEG_INF, n_rows)`` pair and orders by the total key (value desc, row
    asc), so top-``big_k`` selection is associative: this tree, and any
    other merge order, is bit-identical to the flat concat-then-merge.  A
    real candidate scoring exactly ``NEG_INF`` with a valid row id is kept,
    and ranks above the sentinel only through the row tie-break.  On one
    device the flat merge is one sort where the tree takes S - 1, so the
    sharded plane's per-shard path merges flat; the tree is the merge across
    devices.
    """
    items = list(zip(pool_vals, pool_rows))
    if not items:
        raise ValueError("tree_merge_topk needs at least one candidate pool")
    if len(items) == 1:
        return merge_rows_topk(items[0][0], items[0][1], big_k, n_rows)
    while len(items) > 1:
        merged = [
            merge_rows_topk(torch.cat([v1, v2], -1), torch.cat([r1, r2], -1), big_k, n_rows)
            for (v1, r1), (v2, r2) in zip(items[0::2], items[1::2])
        ]
        if len(items) % 2:
            merged.append(items[-1])
        items = merged
    return items[0]
