"""Embedding-similarity service — the paper's end application (§I, Fig. 1).

Matches dense query embeddings against a collection of sparse embeddings and
returns the K most cosine-similar rows.  Wraps index building (sparsify ->
partition -> BS-CSR encode -> quantize) and batched querying behind one class.

The backing index is a ``MutableTopKSpMVIndex``, as in the reference: rows
can be ``upsert``-ed and ``delete``-d while serving (delta tile-packets and
tombstones, no re-encode), ``compact()`` reclaims the churn, and the graph
workloads (``personalized_pagerank``, ``topk_eigen``) run over the rows as a
square operator.  ``recall_target`` gives each partition its own value
format (mixed precision, ``core/adaptive.py``).  ``from_index`` wraps an
index that ``core/persistence.py`` recovered.

With ``mesh=`` (a ``launch.mesh.make_serving_mesh`` mesh) or ``n_shards > 1``
the backing index is a
:class:`~repro_torch.core.sharded.ShardedTopKSpMVIndex` instead: the rows
shard at partition granularity (on a mesh, each shard pinned at every
position of its mesh column), the per-shard candidates merge under global
ids, bit for bit equal to the single-device index, and query batches fan
out across the mesh's "replica" axis (``replica_factor``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bscsr as bscsr_lib
from repro_torch.core import graph as graph_lib
from repro_torch.core import sharded as sharded_lib
from repro_torch.core import topk_spmv as topk_lib
from repro_torch.utils import tracing


@dataclasses.dataclass
class SimilaritySearchStats:
    n_rows: int
    n_cols: int
    nnz: int
    num_partitions: int
    bytes_per_nnz: float          # effective: stream bytes / live nnz
    stream_bytes: int
    expected_precision: float
    delta_fraction: float = 0.0   # live nnz held in delta segments / live nnz
    tombstone_count: int = 0      # retired (tombstoned) candidate slots
    deleted_rows: int = 0         # globally tombstoned row ids
    version: int = 0              # snapshot version counter
    stream_layout: str = "split"  # fused (one burst/step) | split (3 arrays)
    last_refresh_repadded: int = 0  # partitions re-padded by the last snapshot
    last_refresh_copied: int = 0  # partitions copied into the COW stack buffers
    snapshot_buffers: int = 0     # COW stacked buffers pooled (leased + free)
    # -- mixed precision (config.recall_target) ------------------------------
    value_format_histogram: dict = dataclasses.field(default_factory=dict)
    value_bytes_per_nnz: float = 0.0  # streamed value bytes / live nnz
    recall_target: Optional[float] = None
    predicted_recall: Optional[float] = None  # calibration's recall@k estimate


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
        native_groups: bool = True,
    ):
        self.csr = csr  # the collection the index was built from (base segment)
        config = config or topk_lib.TopKSpMVConfig()
        if recall_target is not None:
            # Per-partition mixed-precision streams tuned so that predicted
            # recall@k against exact search stays >= the target.
            config = dataclasses.replace(config, recall_target=recall_target)
        self.config = config
        self.nnz_per_row = nnz_per_row  # sparsification level for dense upserts
        if mesh is not None or (n_shards is not None and n_shards > 1):
            # Row shards merged under global ids (core/sharded.py).
            self.index = sharded_lib.ShardedTopKSpMVIndex(
                csr, self.config, mesh=mesh, n_shards=n_shards,
                native_groups=native_groups)
        else:
            self.index = topk_lib.MutableTopKSpMVIndex(csr, self.config)

    @property
    def is_sharded(self) -> bool:
        return isinstance(self.index, sharded_lib.ShardedTopKSpMVIndex)

    @property
    def replica_factor(self) -> int:
        """Query fan-out of one kernel pass (the mesh's replica count).

        A sharded index on a mesh spreads a coalesced batch across its R
        replica rows, so the micro-batching frontend multiplies its target
        Q by it.  1 for a single-device index and for the per-shard path,
        which has no mesh.
        """
        return self.index.n_replicas if self.is_sharded else 1

    @property
    def n_cols(self) -> int:
        """Feature dimension served by the backing index."""
        return self.index.n_cols

    @classmethod
    def from_index(cls, index, nnz_per_row: int = 32) -> "SparseEmbeddingIndex":
        """Wrap an already-built backing index: the recovery constructor.

        ``persistence.DurableIndexStore.recover()`` returns a bare
        ``MutableTopKSpMVIndex``; this attaches the facade to it without
        re-encoding anything.
        """
        obj = cls.__new__(cls)
        obj.config = index.config
        obj.nnz_per_row = nnz_per_row
        obj.index = index
        obj.csr, _ = index.live_csr()
        return obj

    @classmethod
    def from_dense(
        cls,
        embeddings: np.ndarray,
        nnz_per_row: int = 32,
        config: Optional[topk_lib.TopKSpMVConfig] = None,
        recall_target: Optional[float] = None,
        mesh=None,
        n_shards: Optional[int] = None,
        native_groups: bool = True,
    ) -> "SparseEmbeddingIndex":
        """Sparsify dense embeddings (magnitude top-m) and index them."""
        csr = bscsr_lib.sparsify_topm(embeddings, nnz_per_row)
        return cls(csr, config, nnz_per_row=nnz_per_row,
                   recall_target=recall_target, mesh=mesh, n_shards=n_shards,
                   native_groups=native_groups)

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
        with tracing.entry("index.query"):
            with tracing.span("index.validate"):
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
        with tracing.entry("index.query_batch"):
            with tracing.span("index.validate"):
                self._validate_query(xs, batched=True)
            return self._dispatch_batch(xs, use_kernel=use_kernel is not False)

    def _dispatch_batch(
        self, xs: np.ndarray, use_kernel: bool
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The one dispatch entry every query path funnels through.

        The query batch is uploaded here, once per call; the executor's
        ``h2d_copies`` counts snapshot pins only, as for any other entry.
        A sharded index dispatches each shard and merges their pools.

        Traced, ``index.wait`` synchronises the stream before the copies
        back, so that ``index.d2h`` times the copies alone and the wait
        holds the time the host was blocked on the device.
        """
        with tracing.span("index.upload"):
            xs = torch.as_tensor(np.ascontiguousarray(xs, dtype=np.float32),
                                 device=self.config.resolve_device())
        if self.is_sharded:
            v, r = self.index.query_batched(xs, use_kernel=use_kernel)
        else:
            v, r = topk_lib.topk_spmv_batched(self.index, xs, use_kernel=use_kernel)
        if tracing.enabled():
            with tracing.span("index.wait"):
                if v.is_cuda:
                    torch.cuda.current_stream(v.device).synchronize()
        with tracing.span("index.d2h"):
            return v.cpu().numpy(), r.cpu().numpy()

    def query_exact(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Exact Top-K over the *live* rows — ground truth for accuracy checks."""
        x = np.asarray(x, np.float32)
        csr, gids = self.index.live_csr()
        v, local = topk_lib.topk_spmv_exact(csr, x, self.config.big_k)
        return v, gids[local].astype(np.int64)

    # -- live updates (serve-while-ingest) ----------------------------------

    def upsert(self, embeddings: np.ndarray, ids: Optional[Sequence[int]] = None,
               nnz_per_row: Optional[int] = None) -> np.ndarray:
        """Add or replace dense embedding rows; returns their global row ids.

        Rows are magnitude-top-m sparsified like ``from_dense``.  With
        ``ids=None`` they are appended under fresh ids; otherwise each row
        replaces (or resurrects) the given id.  Updates land as delta
        tile-packets, with no re-encode of the existing stream.
        """
        embeddings = np.atleast_2d(np.asarray(embeddings, np.float32))
        if embeddings.shape[1] != self.n_cols:
            raise ValueError(
                f"embedding width {embeddings.shape[1]} != index width {self.n_cols}"
            )
        if not np.all(np.isfinite(embeddings)):
            raise ValueError(
                "upsert embeddings contain non-finite values (NaN/Inf) — they "
                "would poison every score they touch; sanitize upstream"
            )
        m_keep = min(nnz_per_row or self.nnz_per_row, embeddings.shape[1])
        sparse = bscsr_lib.sparsify_topm(embeddings, m_keep)
        rows = [
            (sparse.indices[sparse.indptr[i] : sparse.indptr[i + 1]],
             sparse.data[sparse.indptr[i] : sparse.indptr[i + 1]])
            for i in range(sparse.shape[0])
        ]
        if ids is None:
            return np.asarray(self.index.add_rows(rows), dtype=np.int64)
        self.index.replace_rows(list(ids), rows)
        return np.asarray(list(ids), dtype=np.int64)

    def delete(self, ids: Sequence[int]) -> None:
        """Tombstone rows: never returned again, reclaimed at ``compact()``."""
        self.index.delete_rows(list(ids))

    def compact(self) -> None:
        """Re-encode live rows, restoring base-only bytes/nnz."""
        self.index.compact()

    # -- iterative graph workloads (accumulate-mode SpMV) -------------------

    def personalized_pagerank(self, seeds, **kwargs):
        """Personalized PageRank over this (square) index's rows as a graph
        operator; see :func:`repro_torch.core.graph.personalized_pagerank`."""
        return graph_lib.personalized_pagerank(self.index, seeds, **kwargs)

    def topk_eigen(self, k: int, **kwargs):
        """Top-k eigenpairs of this (symmetric, square) index's operator; see
        :func:`repro_torch.core.graph.topk_eigen`."""
        return graph_lib.topk_eigen(self.index, k, **kwargs)

    def stats(self) -> SimilaritySearchStats:
        if self.is_sharded:
            agg = self.index.aggregate_stats()
            return SimilaritySearchStats(
                n_rows=self.index.n_rows,
                n_cols=agg["n_cols"],
                nnz=agg["nnz"],
                num_partitions=self.index.num_cores,
                bytes_per_nnz=agg["bytes_per_nnz"],
                stream_bytes=agg["stream_bytes"],
                expected_precision=self.index.expected_precision,
                delta_fraction=agg["delta_fraction"],
                tombstone_count=agg["tombstone_count"],
                deleted_rows=self.index.deleted_rows,
                version=self.index.version,
                stream_layout=agg["stream_layout"],
                last_refresh_repadded=self.index.last_refresh_repadded,
                last_refresh_copied=self.index.last_refresh_copied,
                snapshot_buffers=self.index.snapshot_buffers,
                value_format_histogram=agg["format_histogram"],
                value_bytes_per_nnz=agg["value_bytes_per_nnz"],
                recall_target=self.config.recall_target,
                predicted_recall=self.index.predicted_recall,
            )
        packed = self.index.packed
        return SimilaritySearchStats(
            n_rows=self.index.n_rows,
            n_cols=packed.n_cols,
            nnz=packed.nnz,
            num_partitions=packed.num_cores,
            bytes_per_nnz=packed.bytes_per_nnz,
            stream_bytes=packed.stream_bytes,
            expected_precision=self.index.expected_precision,
            delta_fraction=packed.delta_fraction,
            tombstone_count=packed.tombstone_count,
            deleted_rows=self.index.deleted_rows,
            version=self.index.version,
            stream_layout=packed.stream_layout,
            last_refresh_repadded=self.index.last_refresh_repadded,
            last_refresh_copied=self.index.last_refresh_copied,
            snapshot_buffers=self.index.snapshot_buffers,
            value_format_histogram=packed.format_histogram(),
            value_bytes_per_nnz=packed.value_bytes_per_nnz,
            recall_target=self.config.recall_target,
            predicted_recall=self.index.predicted_recall,
        )

    def dispatch_info(self) -> dict:
        """Executor cache counters merged with the snapshot's signature dims;
        a sharded index reports its topology, health and per-shard
        signatures beside the counters."""
        if self.is_sharded:
            return self.index.dispatch_info()
        info = topk_lib.query_executor(self.config).cache_info()
        info["signature"] = self.index.packed.signature_info()
        info["churn_stable"] = self.config.churn_stable
        return info
