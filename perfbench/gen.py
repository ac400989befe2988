"""The benchmark's own inputs, drawn from ``--seed`` on the device.

The collection is the paper's (§V): each row's length is Gamma(3, 4/3)
scaled to the mean (a sum of three unit exponentials times 4/3, times
``mean / 4``, rounded, at least 1 and at most ``n_cols``), its columns are
distinct and sorted, its values standard normal, and the row has unit L2
norm.  Rows are drawn in chunks: the columns of a chunk are the positions of
each row's smallest random keys, a key being a random integer times
``n_cols`` plus the column, so no two keys of a row tie.  Queries are
standard normal with unit norm.  Each stream of random numbers comes from
its own ``torch.Generator`` on the device, seeded from ``(seed, purpose)``.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

CHUNK_ROWS = 1 << 18


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose, from the run's seed."""
    digest = hashlib.blake2b(f"{int(seed)}:{purpose}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, purpose))
    return g


@dataclasses.dataclass
class HostCSR:
    """A host CSR: int64 ``indptr``, int32 ``indices``, f32 ``data``."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    n_cols: int

    @property
    def n_rows(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])


def row_lengths(n_rows: int, n_cols: int, mean_nnz: float, g: torch.Generator,
                device) -> torch.Tensor:
    u = torch.rand((3, n_rows), generator=g, device=device, dtype=torch.float64)
    raw = -(4.0 / 3.0) * torch.log1p(-u).sum(0)
    lens = torch.round(raw * (mean_nnz / 4.0)).to(torch.int64)
    return torch.clamp(lens, 1, n_cols)


def collection(n_rows: int, n_cols: int, mean_nnz: float, seed: int, device,
               chunk_rows: int = CHUNK_ROWS) -> HostCSR:
    """The collection of ``seed``."""
    device = torch.device(device)
    g = generator(seed, "collection", device)
    lens = row_lengths(n_rows, n_cols, mean_nnz, g, device)
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=device)
    torch.cumsum(lens, 0, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = torch.empty(nnz, dtype=torch.int32, device=device)
    data = torch.empty(nnz, dtype=torch.float32, device=device)
    cols = torch.arange(n_cols, dtype=torch.int32, device=device)
    key_bits = 31 - max(int(n_cols - 1).bit_length(), 1)
    for lo in range(0, n_rows, chunk_rows):
        hi = min(n_rows, lo + chunk_rows)
        ln = lens[lo:hi]
        width = int(ln.max())
        keys = torch.randint(0, 1 << key_bits, (hi - lo, n_cols), generator=g, device=device,
                             dtype=torch.int32) * n_cols + cols
        pos = torch.topk(keys, width, dim=1, largest=False, sorted=True).indices
        del keys
        live = torch.arange(width, device=device)[None, :] < ln[:, None]
        pos = torch.sort(torch.where(live, pos, n_cols), dim=1).values
        vals = torch.randn((hi - lo, width), generator=g, device=device)
        vals = torch.where(live, vals, 0.0)
        vals = vals / torch.sqrt((vals * vals).sum(1, keepdim=True)).clamp_min(1e-6)
        a, b = int(indptr[lo]), int(indptr[hi])
        indices[a:b] = pos[live].to(torch.int32)
        data[a:b] = vals[live]
    return HostCSR(indptr=indptr.cpu().numpy(), indices=indices.cpu().numpy(),
                   data=data.cpu().numpy(), n_cols=n_cols)


def queries(n: int, n_cols: int, seed: int, device) -> np.ndarray:
    """(n, n_cols) unit-norm f32 queries of ``seed``, on the host."""
    g = generator(seed, "queries", device)
    xs = torch.randn((n, n_cols), generator=g, device=device)
    xs = xs / torch.linalg.vector_norm(xs, dim=1, keepdim=True)
    return xs.cpu().numpy()

