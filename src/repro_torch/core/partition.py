"""Row-partitioned approximate Top-K (paper §III-A) + the candidate merge.

The matrix is split into ``c`` row partitions ("cores").  Each core keeps
only its local top-``k`` (k < K, k*c >= K), and the union of the c*k
candidates is merged into the approximate Top-K.  ``PartitionPlan`` and
``partition_csr`` are host numpy; ``merge_topk`` runs in torch on whatever
device its candidates live on.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

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


def merge_rows_topk(
    vals: torch.Tensor,
    rows: torch.Tensor,
    big_k: int,
    n_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``merge_topk`` over each row of a (B, n) candidate batch -> (B, big_k)."""
    vals = vals.to(torch.float32)
    rows = rows.to(torch.int32)
    if vals.shape[-1] < big_k:
        pad = big_k - vals.shape[-1]
        sentinel = n_rows if n_rows is not None else int(np.iinfo(np.int32).max)
        vals = torch.cat([vals, vals.new_full(vals.shape[:-1] + (pad,), NEG_INF)], -1)
        rows = torch.cat([rows, rows.new_full(rows.shape[:-1] + (pad,), sentinel)], -1)
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
    n_rows: Optional[int] = None,
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
