"""Graph-ranking service: PPR + eigen workloads over a live similarity index.

The port of ``repro.serve.graph_ranking``.  Instead of one top-k pass per
query, each request runs the accumulate kernel (``y = alpha*A@x + beta*y``)
to a fixed point.  The service adds the serving-plane concerns on top of
:mod:`repro_torch.core.graph`:

* **Warm-start caching.**  Every solved personalization vector keeps its
  scores; a repeat ``rank`` for the same seeds after index mutations
  re-solves *incrementally* from the cached solution — fewer kernel
  dispatches, and (thanks to the canonicalization stage) scores
  bit-identical to a cold solve on the mutated index.
  ``incremental_solves`` / ``cold_solves`` count the split.
* **Mutation surface.**  ``update_node`` / ``delete_node`` forward to the
  wrapped index (delta packets + tombstones, no re-encode) and invalidate
  nothing: cached solutions intentionally survive as warm starts.
* **Eigen passthrough.**  ``topk_eigen`` for spectral workloads on
  symmetric operators.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import graph as graph_lib


def _seed_key(seeds) -> tuple:
    """A hashable canonical form of a ``seeds`` argument (dict/seq/int)."""
    if isinstance(seeds, (int, np.integer)):
        return (("node", int(seeds)),)
    if isinstance(seeds, dict):
        return tuple(sorted((int(k), float(v)) for k, v in seeds.items()))
    arr = np.asarray(seeds)
    if arr.ndim == 1 and not np.issubdtype(arr.dtype, np.integer):
        nz = np.nonzero(arr)[0]
        return tuple((int(i), float(arr[i])) for i in nz)
    return tuple(("node", int(i)) for i in np.sort(arr.reshape(-1)))


@dataclasses.dataclass(frozen=True)
class RankedNodes:
    """One graph-ranking answer: the top nodes plus the full solve record."""

    node_ids: np.ndarray      # (top_k,) int64, score-descending
    scores: np.ndarray        # (top_k,) f32 PPR mass of those nodes
    result: graph_lib.PPRResult
    warm_started: bool


class GraphRankingService:
    """Personalized-ranking frontend over a (square) embedding index.

    ``index`` is anything the graph solvers accept: a
    ``SparseEmbeddingIndex``, a ``MutableTopKSpMVIndex`` or a
    ``ShardedTopKSpMVIndex`` (whose ``update_node`` goes through
    ``replace_rows`` on global ids).  Solver keywords (``alpha``, ``tol``,
    ``max_iters``, ...) fix the service's solve contract at construction so
    cached warm starts and fresh solves always agree on the operator.
    """

    def __init__(
        self,
        index,
        *,
        alpha: float = 0.85,
        tol: float = 1e-5,
        max_iters: int = 500,
        use_kernel: bool = True,
        cache_solutions: bool = True,
    ):
        self.index = index
        self.alpha = float(alpha)
        self.tol = float(tol)
        self.max_iters = int(max_iters)
        self.use_kernel = bool(use_kernel)
        self.cache_solutions = bool(cache_solutions)
        self._solutions: dict = {}      # seed key -> scores (np.float32)
        self.cold_solves = 0
        self.incremental_solves = 0
        self.kernel_iterations = 0      # accumulate dispatches, all solves

    # -- ranking ------------------------------------------------------------

    def rank(self, seeds, top_k: int = 10, **overrides) -> RankedNodes:
        """Top ``top_k`` nodes by personalized PageRank mass around ``seeds``.

        A repeat call for the same seeds (by value) warm-starts from the
        cached solution — after ``update_node``/``delete_node`` that is the
        incremental re-solve path, bit-identical to a cold solve.
        """
        key = _seed_key(seeds)
        warm = self._solutions.get(key) if self.cache_solutions else None
        res = graph_lib.personalized_pagerank(
            self.index,
            seeds,
            alpha=overrides.pop("alpha", self.alpha),
            tol=overrides.pop("tol", self.tol),
            max_iters=overrides.pop("max_iters", self.max_iters),
            use_kernel=overrides.pop("use_kernel", self.use_kernel),
            warm_start=warm,
            **overrides,
        )
        if warm is None:
            self.cold_solves += 1
        else:
            self.incremental_solves += 1
        self.kernel_iterations += res.iterations
        if self.cache_solutions:
            self._solutions[key] = res.scores
        ids = res.top_nodes(top_k)
        return RankedNodes(
            node_ids=ids,
            scores=res.scores[ids].astype(np.float32),
            result=res,
            warm_started=warm is not None,
        )

    def topk_eigen(self, k: int, **kwargs) -> graph_lib.EigenResult:
        """Top-k eigenpairs of the wrapped (symmetric) operator."""
        kwargs.setdefault("use_kernel", self.use_kernel)
        return graph_lib.topk_eigen(self.index, k, **kwargs)

    # -- mutations (serve-while-ingest) -------------------------------------

    def update_node(self, node_id: int, embedding: np.ndarray) -> None:
        """Replace one node's outgoing weights; cached solutions become
        warm starts for the next ``rank`` of each seed set."""
        if hasattr(self.index, "upsert"):
            self.index.upsert(np.atleast_2d(embedding), ids=[int(node_id)])
        else:
            emb = np.asarray(embedding, np.float32).reshape(-1)
            cols = np.nonzero(emb)[0].astype(np.int32)
            self.index.replace_rows([int(node_id)], [(cols, emb[cols])])

    def delete_node(self, node_id: int) -> None:
        """Tombstone one node: it stops spreading mass (and receives only
        teleport mass) from the next solve on."""
        if hasattr(self.index, "delete"):
            self.index.delete([int(node_id)])
        else:
            self.index.delete_rows([int(node_id)])

    def forget(self, seeds=None) -> None:
        """Drop cached solutions (all, or one seed set) — next solve is cold."""
        if seeds is None:
            self._solutions.clear()
        else:
            self._solutions.pop(_seed_key(seeds), None)

    def info(self) -> dict:
        return {
            "cold_solves": self.cold_solves,
            "incremental_solves": self.incremental_solves,
            "kernel_iterations": self.kernel_iterations,
            "cached_seed_sets": len(self._solutions),
            "alpha": self.alpha,
            "tol": self.tol,
        }
