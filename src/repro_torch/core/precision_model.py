"""Expected precision of the partitioned Top-K approximation (paper §III-A, Eq. 1).

Rows holding the true Top-K values land in the ``c`` partitions uniformly at
random (row order carries no score information).  A partition that receives
``k_i > k`` of the true Top-K values can only return ``k`` of them, losing
``k_i - k``.  The count per partition is hypergeometric, so

  E[lost | K_i] = c * sum_{k_i=k+1}^{min(K_i, N/c)} (k_i - k) *
                  C(N/c, k_i) C(N - N/c, K_i - k_i) / C(N, K_i)

  E[P] = mean over K_i in 1..K of  (1 - E[lost | K_i] / K_i)

The paper prints a compact form of the same permutation-counting argument and
validates it by Monte Carlo (Table I); we implement the exact hypergeometric
expectation in log-space (N reaches 1e7) plus the same Monte Carlo estimator.
"""
from __future__ import annotations

import math

import numpy as np


def _log_comb(n: float, k: np.ndarray) -> np.ndarray:
    """log C(n, k) via lgamma, -inf where k > n or k < 0."""
    k = np.asarray(k, dtype=np.float64)
    out = np.full(k.shape, -np.inf)
    ok = (k >= 0) & (k <= n)
    kk = k[ok]
    out[ok] = (
        math.lgamma(n + 1)
        - np.vectorize(math.lgamma)(kk + 1)
        - np.vectorize(math.lgamma)(n - kk + 1)
    )
    return out


def expected_lost(n_rows: int, c: int, k: int, big_k: int) -> float:
    """E[# true Top-``big_k`` values lost] with c partitions keeping k each."""
    rows_per_part = n_rows // c
    hi = min(big_k, rows_per_part)
    if hi <= k:
        return 0.0
    k_i = np.arange(k + 1, hi + 1)
    log_p = (
        _log_comb(rows_per_part, k_i)
        + _log_comb(n_rows - rows_per_part, big_k - k_i)
        - _log_comb(n_rows, np.array([big_k], dtype=np.float64))
    )
    return float(c * np.sum((k_i - k) * np.exp(log_p)))


def expected_precision(n_rows: int, c: int, k: int, big_k: int) -> float:
    """E[P] at a single K = ``big_k`` (fraction of true Top-K retrieved)."""
    return 1.0 - expected_lost(n_rows, c, k, big_k) / big_k


def expected_precision_avg(n_rows: int, c: int, k: int, big_k: int) -> float:
    """Paper Eq. (1): average of E[P] over K_i = 1..K (their reported metric)."""
    vals = [expected_precision(n_rows, c, k, ki) for ki in range(1, big_k + 1)]
    return float(np.mean(vals))


def monte_carlo_precision(
    n_rows: int, c: int, k: int, big_k: int, trials: int = 1000, seed: int = 0
) -> float:
    """Monte Carlo estimate matching the paper's Table I methodology.

    Sample which partition each of the true Top-K rows falls into
    (multivariate hypergeometric; for N >> K a multinomial over c uniform
    partitions is exact enough and is what uniform random row placement gives).
    """
    rng = np.random.default_rng(seed)
    parts = rng.integers(0, c, size=(trials, big_k))
    lost = 0
    for t in range(trials):
        counts = np.bincount(parts[t], minlength=c)
        lost += int(np.maximum(counts - k, 0).sum())
    return 1.0 - lost / (trials * big_k)


# ---------------------------------------------------------------------------
# Quantization-induced recall loss (per-partition mixed-precision assignment)
#
# The hypergeometric Eq. (1) above models the *partition* term of recall
# loss; these helpers model the *quantization* term: a true top-k member is
# lost when value rounding drops its score below the query's k-th exact
# score (the admission threshold).  Counted per row over a calibration query
# sample, the losses are additive across partitions, which is what lets the
# greedy ladder descent in ``core/adaptive.py`` budget them independently.
# ---------------------------------------------------------------------------

# Non-zeros scored per chunk of rows in ``csr_batch_scores``.  Unchunked, a
# 200M-nnz collection and 16 queries would hold two (16, nnz) f32
# temporaries of 12.8 GB each; each row's sum depends only on its own
# segment, so chunking by whole rows leaves every score's bits unchanged.
SCORE_CHUNK_NNZ = 1 << 22


def csr_batch_scores(
    indptr: np.ndarray, indices: np.ndarray, data: np.ndarray, xs: np.ndarray
) -> np.ndarray:
    """(S, M) query batch -> (S, N) exact row scores of a host CSR.

    Rows are scored in chunks of about ``SCORE_CHUNK_NNZ`` non-zeros (whole
    rows).
    """
    xs = np.asarray(xs, np.float32)
    indptr = np.asarray(indptr)
    data = np.asarray(data, np.float32)
    n = len(indptr) - 1
    out = np.zeros((xs.shape[0], n), np.float32)
    lo = 0
    while lo < n:
        hi = int(np.searchsorted(indptr, indptr[lo] + SCORE_CHUNK_NNZ, side="right")) - 1
        hi = min(max(hi, lo + 1), n)
        a, b = int(indptr[lo]), int(indptr[hi])
        nonempty = np.diff(indptr[lo : hi + 1]) > 0
        if nonempty.any():
            prods = data[None, a:b] * xs[:, indices[a:b]]          # (S, chunk nnz)
            # reduceat over nonempty row starts only: empty rows contribute no
            # entries, so each segment is exactly one nonempty row's products
            # (reduceat misbehaves on repeated boundaries otherwise).
            out[:, lo:hi][:, nonempty] = np.add.reduceat(
                prods, indptr[lo:hi][nonempty] - a, axis=1
            )
        lo = hi
    return out


def topk_thresholds(scores: np.ndarray, k: int) -> np.ndarray:
    """(S, N) scores -> (S,) k-th largest value per query (admission bar)."""
    k = min(k, scores.shape[1])
    return np.partition(scores, scores.shape[1] - k, axis=1)[:, scores.shape[1] - k]


def quantization_loss_per_row(
    exact: np.ndarray, quant: np.ndarray, thresholds: np.ndarray
) -> np.ndarray:
    """(N,) count of (query, row) events where rounding loses a top-k member.

    A row is lost for query ``s`` when its exact score clears the query's
    admission threshold but its quantized score does not.
    """
    t = np.asarray(thresholds)[:, None]
    return ((exact >= t) & (quant < t)).sum(axis=0).astype(np.int64)


def min_partitions_for_precision(
    n_rows: int, k: int, big_k: int, target: float = 0.99
) -> int:
    """Smallest c (power of two) with E[P] >= target — used by auto-config."""
    c = 1
    while c <= n_rows:
        if big_k <= c * k and expected_precision(n_rows, c, k, big_k) >= target:
            return c
        c *= 2
    return c
