"""The partitioned approximate Top-K (the paper's §III-A) and exact Top-K, plainly.

The collection's rows split into ``c`` contiguous partitions, the first
``n % c`` one row longer.  Each partition keeps its ``k`` best rows by
score; the ``c * k`` candidates merge into the ``K`` best, by score
descending and row id ascending.  A score is a query's dot product with a
row whose values are read in the stated value format: f32 products of the
decoded value and the f32 query, summed in f32.

Scores come from ``torch.sparse.mm`` over a CSR tensor, in blocks of
queries, so the device holds one ``(n_rows, q)`` block at a time.
"""
from __future__ import annotations

import warnings
from typing import Dict, Tuple

import numpy as np
import torch

# Stored value formats: (kind, fractional bits).  Fixed point rounds half
# to even and saturates, as a stream of the paper's Table II stores it.
FORMATS: Dict[str, Tuple[str, int]] = {
    "F32": ("float", 0),
    "BF16": ("bfloat16", 0),
    "Q15": ("int16", 15),
    "Q7": ("int8", 7),
}
_INT_RANGE = {"int16": (-32768, 32767), "int8": (-128, 127)}


def partition_bounds(n_rows: int, c: int) -> np.ndarray:
    """(c + 1,) row boundaries: partition p holds rows [b[p], b[p + 1])."""
    base, rem = divmod(n_rows, c)
    sizes = np.full(c, base, np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def decode(values: torch.Tensor, fmt: str) -> torch.Tensor:
    """f32 ``values`` as the format stores them, read back as f32."""
    kind, frac = FORMATS[fmt]
    values = values.to(torch.float32)
    if kind == "float":
        return values
    if kind == "bfloat16":
        return values.to(torch.bfloat16).to(torch.float32)
    lo, hi = _INT_RANGE[kind]
    q = torch.clamp(torch.round(values * float(2 ** frac)), lo, hi)
    return q * float(2.0 ** -frac)


class Collection:
    """A CSR collection on ``device`` whose values are read in stated formats."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, n_cols: int, device):
        self.indptr = np.asarray(indptr, np.int64)
        self.n_rows = len(self.indptr) - 1
        self.n_cols = int(n_cols)
        self.device = torch.device(device)
        self._crow = torch.as_tensor(self.indptr, device=self.device)
        self._col = torch.as_tensor(np.asarray(indices), device=self.device).to(torch.int64)

    def matrix(self, values: torch.Tensor) -> torch.Tensor:
        """The sparse (n_rows, n_cols) CSR tensor of ``values`` (f32)."""
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
            return torch.sparse_csr_tensor(self._crow, self._col,
                                           values.to(self.device, torch.float32),
                                           size=(self.n_rows, self.n_cols),
                                           check_invariants=False)


def row_scores(matrix: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(n_rows, q) f32 scores of every row against the (q, n_cols) queries."""
    return torch.sparse.mm(matrix, xs.to(matrix.device, torch.float32).T.contiguous())


def _sort_desc_then_row(vals: torch.Tensor, rows: torch.Tensor, keep: int):
    by_row = torch.sort(rows, dim=-1, stable=True).indices
    v = torch.gather(vals, -1, by_row)
    by_val = torch.sort(v + 0.0, dim=-1, descending=True, stable=True).indices[..., :keep]
    top = torch.gather(by_row, -1, by_val)
    return torch.gather(vals, -1, top), torch.gather(rows, -1, top)


def partitioned_topk(scores: torch.Tensor, bounds: np.ndarray, k: int,
                     big_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_rows, q) scores -> (q, big_k) values and row ids of the paper's
    approximation: each partition's ``k`` best, merged into the ``big_k`` best."""
    n, q = scores.shape
    c = len(bounds) - 1
    sizes = np.diff(bounds)
    width = int(sizes.max())
    starts = torch.as_tensor(bounds[:-1], device=scores.device)
    local = torch.arange(width, device=scores.device)
    rows = starts[:, None] + local[None, :]                       # (c, width)
    live = local[None, :] < torch.as_tensor(sizes, device=scores.device)[:, None]
    rows = torch.where(live, rows, 0)
    s = scores[rows.reshape(-1)].reshape(c, width, q)
    s = torch.where(live[:, :, None], s, float("-inf"))
    kk = min(k, width)
    cand_v, cand_i = torch.topk(s, kk, dim=1)                     # (c, kk, q)
    cand_r = torch.gather(rows[:, :, None].expand(c, width, q), 1, cand_i)
    cand_v = cand_v.permute(2, 0, 1).reshape(q, c * kk)
    cand_r = cand_r.permute(2, 0, 1).reshape(q, c * kk)
    ok = torch.isfinite(cand_v)
    cand_v = torch.where(ok, cand_v, float("-inf"))
    cand_r = torch.where(ok, cand_r, n)
    return _sort_desc_then_row(cand_v, cand_r, min(big_k, c * kk))


def exact_topk_rows(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(n_rows, q) scores -> (q, k) row ids of the exact ``k`` best."""
    return torch.topk(scores, min(k, scores.shape[0]), dim=0).indices.T
