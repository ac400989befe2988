"""Iterative graph workloads on the BS-CSR substrate (PPR + top-k eigen).

The port of ``repro.core.graph``: damped power iteration for personalized
PageRank and deflated power iteration for the top-k eigenpairs, each step
ONE accumulate dispatch (``y = alpha * A @ x + beta * y``) through the
executor, with every operand resident on the executor's device.

* :func:`personalized_pagerank` iterates ``y <- alpha * A y + (1 - alpha) p``
  (``x := y_t``, the step's ``y`` operand is the constant ``p`` with
  ``beta = 1 - alpha``) until the L1 residual drops below ``tol``.
* :func:`topk_eigen` returns the top-k eigenpairs of a symmetric operator,
  stepping the shifted operator ``(A + I) / 2``.

Torch has no ``jax.transfer_guard``.  Under ``guard_iterations`` the steps
after the warmup one pass ``resident=True`` to ``QueryExecutor.spmv``, which
raises on any operand (x, alpha, beta, y) not already on the executor's
device instead of uploading it, and the solve raises if the executor's
``h2d_copies`` (snapshot pins) moved across the guarded loop.  ``retraces``
counts function builds after the warmup step, as in the reference.

Incremental re-solve: on a mutated :class:`MutableTopKSpMVIndex` (replace /
delete keep the id space, so shapes survive) pass the previous solution as
``warm_start``.  With ``canonicalize`` (the default) both the cold and the
warm solve finish with the same host float64 refinement, so they return the
*identical* f32 vector.

Graph fixtures (``synthetic_graph_csr``, ``dense_ppr_oracle``) are numpy
copies of the reference's, byte for byte.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import bscsr as bscsr_lib
from repro_torch.core.sharded import ShardedTopKSpMVIndex
from repro_torch.core.topk_spmv import (
    MutableTopKSpMVIndex,
    TopKSpMVIndex,
    query_executor,
)


@functools.lru_cache(maxsize=None)
def _pinned_scalar(value: float, device: str) -> torch.Tensor:
    """A cached f32 scalar on ``device``: alpha/beta pin once per value, so
    re-solves at the same damping run their guarded loops upload-free."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def _l1_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(a - b))


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30)


def _deflate(w: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Project ``w`` off the span of ``basis`` columns ((n, j), j >= 1)."""
    return w - basis @ (basis.T @ w)


def _rayleigh_and_residual(v: torch.Tensor, bv: torch.Tensor):
    """For unit ``v`` and ``bv = (A + I) v / 2``: A's Rayleigh quotient and
    eigen-residual, ``(lambda, ||A v - lambda v||)`` with ``Av = 2 bv - v``."""
    av = 2.0 * bv - v
    lam = torch.dot(v, av)
    return lam, torch.linalg.vector_norm(av - lam * v)


@dataclasses.dataclass(frozen=True)
class PPRResult:
    """One personalized-PageRank solve.

    ``iterations`` counts device dispatches; ``refine_iterations`` the host
    f64 canonicalization matvecs (0 when ``canonicalize`` was off or the
    index keeps no host rows).  ``retraces`` counts function builds after
    the warmup step.  ``canonical`` marks scores that went through the
    refinement and are therefore a pure function of (operator, seeds,
    alpha).
    """

    scores: np.ndarray
    iterations: int
    refine_iterations: int
    residual: float
    converged: bool
    canonical: bool
    retraces: int

    def top_nodes(self, k: int) -> np.ndarray:
        """The k highest-scoring node ids (score desc, id asc on ties)."""
        order = np.lexsort((np.arange(self.scores.size), -self.scores))
        return order[:k].astype(np.int64)


@dataclasses.dataclass(frozen=True)
class EigenResult:
    """Top-k eigenpairs from deflated power iteration (symmetric operators).

    Largest algebraic eigenvalue first; ``residuals[j] = ||A v_j - lambda_j
    v_j||``.
    """

    values: np.ndarray        # (k,)
    vectors: np.ndarray       # (n, k), unit columns
    residuals: np.ndarray     # (k,)
    iterations: Tuple[int, ...]
    converged: bool
    retraces: int


_INDEXES = (TopKSpMVIndex, MutableTopKSpMVIndex, ShardedTopKSpMVIndex)


def _unwrap(index):
    """Accept SparseEmbeddingIndex / (Mutable)TopKSpMVIndex / sharded."""
    inner = getattr(index, "index", None)
    if isinstance(inner, _INDEXES):
        return inner
    return index


def _operator_dims(index) -> Tuple[int, int]:
    """(row-space size, column count) of the index's operator."""
    if isinstance(index, ShardedTopKSpMVIndex):
        return index.n_rows_total, index.n_cols
    packed = index.packed
    return packed.n_rows_logical, packed.n_cols


def _require_square(index) -> int:
    n_rows, n_cols = _operator_dims(index)
    if n_rows != n_cols:
        raise ValueError(
            f"iterative solves need a square operator (the iterate feeds "
            f"back as the next x): got {n_rows} rows over {n_cols} columns. "
            "Mutate with replace_rows/delete_rows only — add_rows grows the "
            "row space past the column space."
        )
    return n_cols


def make_spmv_step(index, use_kernel: bool = True) -> Tuple[Callable, Callable[[], int]]:
    """(step, builds) for an index: ``step(x, alpha, beta, y, resident=False)``
    runs ONE accumulate dispatch; ``builds()`` reads the executor's function
    build counter (for zero-retrace assertions).  A sharded index steps
    through its own ``spmv`` (one dispatch per shard, the partials summed);
    ``builds()`` then reads its mesh dispatch's counter, or the executor of
    its shard-local config."""
    index = _unwrap(index)
    if isinstance(index, ShardedTopKSpMVIndex):
        ex = query_executor(index._local_config)

        def sharded_step(x, alpha, beta, y, resident: bool = False):
            return index.spmv(x, alpha, beta, y, use_kernel=use_kernel, resident=resident)

        def builds() -> int:
            if index._spmd is not None and use_kernel:
                return index._spmd.fn_builds
            return ex.fn_builds

        return sharded_step, builds

    ex = query_executor(index.config)
    path = "accumulate" if use_kernel else "accumulate_ref"

    def step(x, alpha, beta, y, resident: bool = False):
        return ex.spmv(x, index.packed, alpha=alpha, beta=beta, y=y, path=path,
                       resident=resident)

    return step, (lambda: ex.fn_builds)


def seed_vector(
    seeds: Union[int, Sequence[int], dict, np.ndarray, torch.Tensor],
    n: int,
    device="cuda",
) -> torch.Tensor:
    """The L1-normalized personalization vector ``p`` on ``device``.

    ``seeds`` may be one node id, a sequence of ids (uniform mass), an
    id->weight dict, or a full (n,) weight vector (host or device).
    """
    if isinstance(seeds, torch.Tensor) and tuple(seeds.shape) == (n,):
        p = seeds.to(device=device, dtype=torch.float32)
        return p / torch.sum(p)
    p = np.zeros(n, np.float32)
    if isinstance(seeds, (int, np.integer)):
        p[int(seeds)] = 1.0
    elif isinstance(seeds, dict):
        for node, w in seeds.items():
            p[int(node)] = float(w)
    else:
        arr = np.asarray(seeds)
        if arr.shape == (n,) and not np.issubdtype(arr.dtype, np.integer):
            p = arr.astype(np.float32)
        else:
            for node in arr.reshape(-1):
                p[int(node)] += 1.0
    total = float(p.sum())
    if total <= 0.0:
        raise ValueError("personalization vector must carry positive mass")
    return torch.from_numpy(p / total).to(device)


def _canonical_refine(
    idx, y32: np.ndarray, p: np.ndarray, alpha: float, tol: float
) -> Tuple[Optional[np.ndarray], int]:
    """Host f64 refinement: the canonicalization stage of the solve.

    Iterates the same damped contraction in float64 from the device-
    converged f32 iterate, long enough that ANY two tol-converged starting
    points contract to within f64 noise of each other, then rounds to f32:
    the result is a pure function of the live operator, the
    personalization and alpha.  Two converged iterates differ by at most
    ``2 tol / (1 - alpha)`` in L1, so ``R = log(5e-17 / spread) /
    log(alpha)`` steps suffice.  Returns ``(None, 0)`` when the index keeps
    no host rows (immutable snapshot indexes).
    """
    live = getattr(idx, "live_csr", None)
    if live is None:
        return None, 0
    csr, gids = live()
    n = p.shape[0]
    p64 = np.asarray(p, np.float64)
    drive = (1.0 - alpha) * p64
    spread = max(2.0 * tol / (1.0 - alpha), 1e-15)
    steps = int(np.ceil(np.log(5e-17 / spread) / np.log(alpha)))
    steps = min(max(steps, 32), 512)
    y = np.asarray(y32, np.float64)
    if n * csr.shape[1] <= (1 << 22):
        a64 = np.zeros((n, csr.shape[1]), np.float64)
        a64[gids] = csr.to_dense()
        for _ in range(steps):
            y = alpha * (a64 @ y) + drive
    else:
        data = csr.data.astype(np.float64)
        idx_cols = csr.indices.astype(np.int64)
        rows_rep = np.repeat(
            np.arange(csr.shape[0], dtype=np.int64), np.diff(csr.indptr)
        )
        for _ in range(steps):
            live_scores = np.bincount(
                rows_rep, weights=data * y[idx_cols], minlength=csr.shape[0]
            )
            y_new = np.zeros(n, np.float64)
            y_new[gids] = live_scores
            y = alpha * y_new + drive
    return y.astype(np.float32), steps


def _check_flat_copies(ex, before: int) -> None:
    if ex.h2d_copies != before:
        raise RuntimeError(
            f"the guarded loop pinned {ex.h2d_copies - before} host arrays; "
            "iterations must run on resident operands"
        )


def personalized_pagerank(
    index,
    seeds,
    *,
    alpha: float = 0.85,
    tol: float = 1e-6,
    max_iters: int = 500,
    warm_start=None,
    canonicalize: bool = True,
    use_kernel: bool = True,
    guard_iterations: bool = True,
) -> PPRResult:
    """Personalized PageRank over the index's (column-stochastic) operator.

    One accumulate dispatch per step; after the warmup step the loop runs
    on resident operands only (``guard_iterations``), reading back one
    scalar residual per step.  Stops when ``||y_{t+1} - y_t||_1 < tol``.
    ``canonicalize`` finishes with the host f64 refinement
    (:func:`_canonical_refine`), whose f32 rounding depends only on
    (operator, seeds, alpha): a ``warm_start``ed re-solve on a mutated index
    returns scores bit-identical to a cold solve.
    """
    idx = _unwrap(index)
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"damping alpha must be in (0, 1), got {alpha}")
    n = _require_square(idx)
    step, builds = make_spmv_step(idx, use_kernel=use_kernel)
    ex = query_executor(idx.config)
    dev = str(ex.device)
    p = seed_vector(seeds, n, device=dev)
    a = _pinned_scalar(float(alpha), dev)
    b = _pinned_scalar(1.0 - float(alpha), dev)
    y = p if warm_start is None else torch.as_tensor(warm_start, dtype=torch.float32).to(dev)

    # Warmup step: pins the snapshot and builds the step function.
    y_new = step(y, a, b, p)
    res = float(_l1_diff(y_new, y))
    it = 1
    y = y_new
    builds_after_warmup = builds()
    copies = ex.h2d_copies
    while it < max_iters and res >= tol:
        y_new = step(y, a, b, p, resident=guard_iterations)
        res = float(_l1_diff(y_new, y))
        it += 1
        y = y_new
    if guard_iterations:
        _check_flat_copies(ex, copies)
    retraces = builds() - builds_after_warmup

    scores = y.cpu().numpy()
    refine_iters = 0
    canonical = False
    if canonicalize:
        refined, refine_iters = _canonical_refine(
            idx, scores, p.cpu().numpy(), float(alpha), float(tol)
        )
        if refined is not None:
            scores, canonical = refined, True

    return PPRResult(
        scores=scores,
        iterations=it,
        refine_iterations=refine_iters,
        residual=res,
        converged=res < tol,
        canonical=canonical,
        retraces=retraces,
    )


def topk_eigen(
    index,
    k: int,
    *,
    tol: float = 1e-5,
    max_iters: int = 300,
    seed: int = 0,
    use_kernel: bool = True,
    guard_iterations: bool = True,
) -> EigenResult:
    """Top-k eigenpairs of the index's operator by deflated power iteration.

    Assumes a symmetric operator, whose eigenvectors are orthogonal: each
    iterate is projected off the accepted basis every step.  Per step one
    accumulate dispatch of the shifted operator ``B = (A + I) / 2`` (x = v,
    alpha = beta = 1/2, y = v), whose eigenvalues ``(lambda + 1) / 2 >= 0``
    keep power iteration off a +/-lambda pair.  Steps after the first run
    on resident operands, as in :func:`personalized_pagerank`.
    """
    idx = _unwrap(index)
    n = _require_square(idx)
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= {n} eigenpairs, got {k}")
    step, builds = make_spmv_step(idx, use_kernel=use_kernel)
    ex = query_executor(idx.config)
    dev = str(ex.device)
    half = _pinned_scalar(0.5, dev)
    # All random starts are uploaded up front: nothing inside the guarded
    # loop below may upload.
    rng = np.random.default_rng(seed)
    starts = [
        torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
        for _ in range(k)
    ]

    values, residuals, iters = [], [], []
    dev_vectors = []          # accepted eigenvectors, kept on the device
    basis = None
    builds_after_warmup: Optional[int] = None
    copies = None
    converged = True
    for j in range(k):
        v = starts[j]
        if basis is not None:
            v = _deflate(v, basis)
        v = _normalize(v)
        lam_f, res_f = 0.0, float("inf")
        it = 0
        while it < max_iters:
            bv = step(v, half, half, v,
                      resident=guard_iterations and builds_after_warmup is not None)
            if basis is not None:
                bv = _deflate(bv, basis)
            lam, res = _rayleigh_and_residual(v, bv)
            v = _normalize(bv)
            it += 1
            lam_f, res_f = float(lam), float(res)    # device -> host only
            if builds_after_warmup is None:
                builds_after_warmup = builds()
                copies = ex.h2d_copies
            if res_f <= tol * max(1.0, abs(lam_f)):
                break
        else:
            converged = False
        values.append(lam_f)
        residuals.append(res_f)
        iters.append(it)
        dev_vectors.append(v)
        basis = torch.stack(dev_vectors, dim=1)
    if guard_iterations and copies is not None:
        _check_flat_copies(ex, copies)

    return EigenResult(
        values=np.asarray(values, np.float32),
        vectors=np.stack([v.cpu().numpy() for v in dev_vectors], axis=1).astype(
            np.float32
        ),
        residuals=np.asarray(residuals, np.float32),
        iterations=tuple(iters),
        converged=converged,
        retraces=builds() - (builds_after_warmup or builds()),
    )


# ---------------------------------------------------------------------------
# Graph fixtures (numpy copies of the reference's, byte for byte).
# ---------------------------------------------------------------------------

GRAPH_KINDS = ("ring", "er", "ba")


def _graph_edges(kind: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """Undirected edge list (u, v) pairs, connected by construction."""
    if kind == "ring":
        # Ring + random chords: small-world-ish, guaranteed connected.
        edges = [(i, (i + 1) % n) for i in range(n)]
        chords = max(n // 4, 1)
        for _ in range(chords):
            u, v = rng.integers(0, n, 2)
            if u != v:
                edges.append((int(u), int(v)))
    elif kind == "er":
        # Erdos-Renyi G(n, p) over a connecting spanning chain.
        edges = [(i, i + 1) for i in range(n - 1)]
        p = min(4.0 / n, 0.5)
        ii, jj = np.nonzero(rng.random((n, n)) < p)
        edges.extend((int(u), int(v)) for u, v in zip(ii, jj) if u < v)
    elif kind == "ba":
        # Preferential attachment: each new node wires to 2 existing nodes
        # sampled by degree — the heavy-tailed fixture.
        m = 2
        edges = [(0, 1), (1, 2), (0, 2)]
        deg = np.zeros(n, np.int64)
        for u, v in edges:
            deg[u] += 1
            deg[v] += 1
        for u in range(3, n):
            probs = deg[:u] / deg[:u].sum()
            targets = rng.choice(u, size=min(m, u), replace=False, p=probs)
            for v in targets:
                edges.append((u, int(v)))
                deg[u] += 1
                deg[v] += 1
    else:
        raise ValueError(f"kind must be one of {GRAPH_KINDS}, got {kind!r}")
    # Dedup (keep u < v), drop self loops.
    norm = {(min(u, v), max(u, v)) for u, v in edges if u != v}
    return np.asarray(sorted(norm), np.int64)


def synthetic_graph_csr(
    kind: str,
    n_nodes: int,
    seed: int = 0,
    symmetric: bool = False,
) -> bscsr_lib.CSRMatrix:
    """A square graph operator as CSR.

    ``symmetric=False`` (PPR): the column-stochastic transition matrix
    ``A = Adj D^{-1}``.  ``symmetric=True`` (eigen): the symmetric
    normalized adjacency ``D^{-1/2} Adj D^{-1/2}``, spectrum in [-1, 1].
    """
    rng = np.random.default_rng(seed)
    edges = _graph_edges(kind, int(n_nodes), rng)
    n = int(n_nodes)
    rows = np.concatenate([edges[:, 0], edges[:, 1]])
    cols = np.concatenate([edges[:, 1], edges[:, 0]])
    deg = np.bincount(rows, minlength=n).astype(np.float64)
    deg = np.maximum(deg, 1.0)
    if symmetric:
        data = 1.0 / np.sqrt(deg[rows] * deg[cols])
    else:
        data = 1.0 / deg[cols]        # column-stochastic: normalize by source
    order = np.lexsort((cols, rows))
    rows, cols, data = rows[order], cols[order], data[order]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return bscsr_lib.CSRMatrix(
        indptr=indptr.astype(np.int64),
        indices=cols.astype(np.int32),
        data=data.astype(np.float32),
        shape=(n, n),
    )


def dense_ppr_oracle(
    dense: np.ndarray,
    p: np.ndarray,
    alpha: float,
    tol: float = 1e-10,
    max_iters: int = 10_000,
) -> np.ndarray:
    """Dense power-iteration PPR ground truth (float64)."""
    a = np.asarray(dense, np.float64)
    p = np.asarray(p, np.float64)
    p = p / p.sum()
    y = p.copy()
    for _ in range(max_iters):
        y_new = alpha * (a @ y) + (1.0 - alpha) * p
        if np.abs(y_new - y).sum() < tol:
            return y_new
        y = y_new
    return y
