"""Embedding-similarity service — the paper's end application (§I, Fig. 1).

Matches dense query embeddings against a collection of sparse embeddings and
returns the K most cosine-similar rows.  Wraps index building (sparsify ->
partition -> BS-CSR encode -> quantize) and batched querying behind one class.

In this slice the facade wraps the immutable ``TopKSpMVIndex``.  On a freshly
built collection it answers exactly as the reference's mutable index does:
that index only adds phantom slots, which are masked.  The live-update,
statistics, graph and sharded surfaces raise ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bscsr as bscsr_lib
from repro_torch.core import topk_spmv as topk_lib

_MUTABLE = "the mutable index is not ported yet: ROADMAP Queue 1 item 7"


class SparseEmbeddingIndex:
    """Approximate Top-K cosine-similarity over a sparse embedding collection."""

    def __init__(
        self,
        csr: bscsr_lib.CSRMatrix,
        config: Optional[topk_lib.TopKSpMVConfig] = None,
        nnz_per_row: int = 32,
        recall_target: Optional[float] = None,
        mesh=None,
        n_shards: Optional[int] = None,
    ):
        if recall_target is not None:
            raise NotImplementedError(
                "recall_target (mixed precision) is not ported yet: "
                "ROADMAP Queue 1 item 8"
            )
        if mesh is not None or (n_shards is not None and n_shards > 1):
            raise NotImplementedError(
                "sharded serving is not ported yet: ROADMAP Queue 1 item 11"
            )
        self.csr = csr
        self.config = config or topk_lib.TopKSpMVConfig()
        self.nnz_per_row = nnz_per_row
        self.index = topk_lib.build_index(csr, self.config)

    @property
    def n_cols(self) -> int:
        """Feature dimension served by the backing index."""
        return self.csr.shape[1]

    @classmethod
    def from_dense(
        cls,
        embeddings: np.ndarray,
        nnz_per_row: int = 32,
        config: Optional[topk_lib.TopKSpMVConfig] = None,
        recall_target: Optional[float] = None,
        mesh=None,
        n_shards: Optional[int] = None,
    ) -> "SparseEmbeddingIndex":
        """Sparsify dense embeddings (magnitude top-m) and index them."""
        csr = bscsr_lib.sparsify_topm(embeddings, nnz_per_row)
        return cls(csr, config, nnz_per_row=nnz_per_row,
                   recall_target=recall_target, mesh=mesh, n_shards=n_shards)

    def _validate_query(self, x: np.ndarray, batched: bool) -> None:
        x = np.asarray(x)
        want = 2 if batched else 1
        shape_name = "(Q, M) batch" if batched else "(M,) vector"
        if x.ndim != want:
            raise ValueError(
                f"query must be a {want}-D {shape_name}, got shape {x.shape}"
            )
        if x.shape[-1] != self.n_cols:
            raise ValueError(
                f"query width {x.shape[-1]} != index feature dim "
                f"{self.n_cols}"
            )
        if not np.all(np.isfinite(np.asarray(x, np.float32))):
            raise ValueError(
                "query contains non-finite values (NaN/Inf) — scores would "
                "be meaningless; sanitize upstream"
            )

    def query(
        self, x: np.ndarray, use_kernel: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-K (scores, row ids) for one dense query embedding.

        Routed through the batched dispatch as a Q=1 batch, as in the
        reference, so every door shares one executor plane.
        """
        self._validate_query(x, batched=False)
        v, r = self._dispatch_batch(np.asarray(x)[None, :], use_kernel=use_kernel)
        return v[0], r[0]

    def query_batch(
        self, xs: np.ndarray, use_kernel: Optional[bool] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched queries: the multi-query kernel answers all Q in one pass.

        ``use_kernel=None`` means the kernel.  (The reference defaults to its
        oracle only because its kernel runs interpreted off the TPU.)
        """
        self._validate_query(xs, batched=True)
        return self._dispatch_batch(xs, use_kernel=use_kernel is not False)

    def _dispatch_batch(
        self, xs: np.ndarray, use_kernel: bool
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The one dispatch entry every query path funnels through.

        The query batch is uploaded here, once per call; the executor's
        ``h2d_copies`` counts snapshot pins only, as for any other entry.
        """
        xs = torch.as_tensor(np.ascontiguousarray(xs, dtype=np.float32),
                             device=self.config.resolve_device())
        v, r = topk_lib.topk_spmv_batched(self.index, xs, use_kernel=use_kernel)
        return v.cpu().numpy(), r.cpu().numpy()

    def query_exact(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Exact Top-K over the collection — ground truth for accuracy checks."""
        x = np.asarray(x, np.float32)
        v, local = topk_lib.topk_spmv_exact(self.csr, x, self.config.big_k)
        return v, local.astype(np.int64)

    def dispatch_info(self) -> dict:
        """Executor cache counters merged with the snapshot's signature dims."""
        info = topk_lib.query_executor(self.config).cache_info()
        info["signature"] = self.index.packed.signature_info()
        return info

    # -- surfaces of later slices -------------------------------------------

    def upsert(self, embeddings: np.ndarray, ids: Optional[Sequence[int]] = None,
               nnz_per_row: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError(_MUTABLE)

    def delete(self, ids: Sequence[int]) -> None:
        raise NotImplementedError(_MUTABLE)

    def compact(self) -> None:
        raise NotImplementedError(_MUTABLE)

    def stats(self):
        raise NotImplementedError(
            "stats() reports the mutable index's churn: " + _MUTABLE
        )

    def personalized_pagerank(self, seeds, **kwargs):
        raise NotImplementedError(
            "graph workloads are not ported yet: ROADMAP Queue 1 item 9"
        )

    def topk_eigen(self, k: int, **kwargs):
        raise NotImplementedError(
            "graph workloads are not ported yet: ROADMAP Queue 1 item 9"
        )
