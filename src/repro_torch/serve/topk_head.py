"""Approximate Top-K LM / retrieval head: the paper's technique, first-class.

Decode-time top-k over the output embedding table IS Top-K MV: N = vocab rows,
M = d_model, x = the final hidden state.  Each (tied) output embedding row is
sparsified (magnitude top-m), BS-CSR encoded into c partitions, and top-k
queries are answered with the partitioned approximate kernel: the paper's
bandwidth argument (O(k) scratch per partition, no V-length logits vector
written), plus the sparsification approximation on top.

Accuracy has two error sources, both measurable against the exact dense head:
(1) partition approximation (Eq. 1, an exact model), and (2) row
sparsification (embedding-dependent; report overlap@K).

Dispatch goes through the device-resident executor: the sparsified embedding
stream is pinned on the device at the head's first query and every decode
step reuses it.  With ``mesh=`` or ``n_shards > 1`` the vocabulary rows
shard across a ``ShardedTopKSpMVIndex`` (bit for bit the unsharded head's
answers); on a mesh its positions must be of ``device``'s kind.

The reference's ``repro/serve/topk_head.py``, ported; ``TopKHeadConfig.device``
takes the place of the reference's interpret mode (``"cuda"`` unless the
caller asks for ``"cpu"``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import bscsr as bscsr_lib
from repro_torch.core.precision_model import expected_precision
from repro_torch.core.sharded import ShardedTopKSpMVIndex
from repro_torch.core.topk_spmv import TopKSpMVConfig, build_index, query_executor
from repro_torch.core.topk_spmv import topk_spmv as run_topk_spmv
from repro_torch.core.topk_spmv import topk_spmv_batched as run_topk_spmv_batched


@dataclasses.dataclass
class TopKHeadConfig:
    big_k: int = 64                 # tokens kept for sampling / rerank
    k: int = 8
    num_partitions: int = 32
    nnz_per_row: int = 64           # sparsification level of embedding rows
    block_size: int = 256
    value_format: str = "BF16"
    stream_layout: str = "fused"    # one contiguous word stream per core
    mesh: Optional[object] = None   # ("replica", "shard") serving mesh: shard
                                    # the vocab rows, fan queries out
                                    # (launch.mesh.make_serving_mesh)
    n_shards: int = 1               # shard count without a mesh (testing)
    device: str = "cuda"            # cuda (kernels) | cpu (plain versions)


class ApproxTopKHead:
    """Wraps a dense output embedding (V, D) into a partitioned sparse index."""

    def __init__(self, embedding: np.ndarray, cfg: Optional[TopKHeadConfig] = None):
        self.cfg = cfg or TopKHeadConfig()
        self.embedding = np.asarray(embedding, np.float32)
        _, d = embedding.shape
        csr = bscsr_lib.sparsify_topm(
            self.embedding, min(self.cfg.nnz_per_row, d), normalize=False
        )
        index_cfg = TopKSpMVConfig(
            big_k=self.cfg.big_k,
            k=self.cfg.k,
            num_partitions=self.cfg.num_partitions,
            block_size=self.cfg.block_size,
            value_format=self.cfg.value_format,
            stream_layout=self.cfg.stream_layout,
            device=self.cfg.device,
        )
        self._sharded = self.cfg.mesh is not None or self.cfg.n_shards > 1
        if self._sharded:
            self.index = ShardedTopKSpMVIndex(
                csr, index_cfg, mesh=self.cfg.mesh,
                n_shards=self.cfg.n_shards if self.cfg.mesh is None else None,
            )
        else:
            self.index = build_index(csr, index_cfg)

    def dispatch_info(self) -> dict:
        """Cache stats of the device-resident executor serving this head."""
        if self._sharded:
            return self.index.dispatch_info()
        return query_executor(self.index.config).cache_info()

    @property
    def partition_precision(self) -> float:
        """Eq. (1) bound for the partitioning error alone."""
        return expected_precision(
            self.embedding.shape[0], self.cfg.num_partitions, self.cfg.k, self.cfg.big_k,
        )

    def topk_logits(
        self, hidden: np.ndarray, use_kernel: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Approximate top-K (logits, token ids) for one hidden state (D,).

        Runs the single-query kernel by default, as every entry of the port
        does; the reference defaults to its oracle only because its kernel
        runs interpreted off the TPU.  ``use_kernel=False`` is the plain walk.
        """
        x = np.asarray(hidden, np.float32)
        if self._sharded:
            v, r = self.index.query(x, use_kernel=use_kernel)
        else:
            v, r = run_topk_spmv(self.index, x, use_kernel=use_kernel)
        return v.cpu().numpy(), r.cpu().numpy()

    def topk_logits_batch(
        self, hiddens: np.ndarray, use_kernel: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Approximate top-K (logits, token ids) for a batch of hidden states.

        ``hiddens`` is (B, D); all B queries share one multi-query kernel
        pass over the sparsified-embedding stream, returning (B, big_k)
        arrays.
        """
        xs = np.asarray(hiddens, np.float32)
        if self._sharded:
            v, r = self.index.query_batched(xs, use_kernel=use_kernel)
        else:
            v, r = run_topk_spmv_batched(self.index, xs, use_kernel=use_kernel)
        return v.cpu().numpy(), r.cpu().numpy()

    def exact_topk_logits(self, hidden: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        scores = self.embedding @ np.asarray(hidden, np.float32)
        order = np.lexsort((np.arange(len(scores)), -scores))[: self.cfg.big_k]
        return scores[order], order.astype(np.int32)

    def overlap_at_k(self, hidden: np.ndarray, big_k: Optional[int] = None) -> float:
        """Fraction of exact top-K token ids recovered by the approximation."""
        big_k = big_k or self.cfg.big_k
        _, approx = self.topk_logits(hidden)
        _, exact = self.exact_topk_logits(hidden)
        return len(set(approx[:big_k].tolist()) & set(exact[:big_k].tolist())) / big_k
