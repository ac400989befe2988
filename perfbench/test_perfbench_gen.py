"""The collection and queries drawn from the seed: the paper's statistics."""
import math

import numpy as np
import pytest

from perfbench import gen

N, M, MEAN = 40_000, 512, 20.0


@pytest.fixture(scope="module")
def csr():
    return gen.collection(N, M, MEAN, 2**31 + 77, "cpu", chunk_rows=5_000)


def test_mean_and_length_histogram(csr):
    lens = np.diff(csr.indptr)
    assert csr.nnz == lens.sum() == len(csr.indices) == len(csr.data)
    assert abs(lens.mean() - MEAN) < 0.15
    # Gamma(3, 4/3) times MEAN / 4, rounded, at least 1: each length's
    # probability, from the gamma's CDF (shape 3: 1 - e^-t (1 + t + t^2/2)).
    def cdf(x):
        t = max(x, 0.0) / (4.0 / 3.0) / (MEAN / 4.0)
        return 1.0 - math.exp(-t) * (1.0 + t + t * t / 2.0)
    for n in (1, 5, 10, 20, 30, 50):
        lo = 0.0 if n == 1 else n - 0.5
        want = cdf(n + 0.5) - cdf(lo)
        got = float((lens == n).mean())
        assert abs(got - want) < 4 * math.sqrt(want / N) + 1e-4, (n, got, want)
    assert lens.min() >= 1 and lens.max() <= M


def test_columns_sorted_distinct_and_rows_unit(csr):
    rows = np.repeat(np.arange(N), np.diff(csr.indptr))
    inner = rows[1:] == rows[:-1]
    assert (np.diff(csr.indices.astype(np.int64))[inner] > 0).all()
    assert csr.indices.min() >= 0 and csr.indices.max() < M
    norms = np.sqrt(np.add.reduceat(csr.data.astype(np.float64) ** 2, csr.indptr[:-1]))
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    # columns spread evenly and values are standard normal before the norm
    counts = np.bincount(csr.indices, minlength=M)
    assert counts.min() > 0.85 * counts.mean()
    assert abs(np.mean(csr.data)) < 0.01


def test_same_seed_same_inputs_and_another_differs():
    a = gen.collection(3_000, 64, 8.0, 12, "cpu", chunk_rows=700)
    b = gen.collection(3_000, 64, 8.0, 12, "cpu", chunk_rows=700)
    c = gen.collection(3_000, 64, 8.0, 13, "cpu", chunk_rows=700)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.indptr, c.indptr)
    q1, q2 = gen.queries(16, 64, 12, "cpu"), gen.queries(16, 64, 12, "cpu")
    np.testing.assert_array_equal(q1, q2)
    np.testing.assert_allclose(np.linalg.norm(q1, axis=1), 1.0, rtol=1e-6)
    assert q1.dtype == np.float32


def test_large_seeds_are_accepted():
    assert 0 <= gen.sub_seed(2**33 + 5, "collection") < 2**63
    assert gen.sub_seed(1, "a") != gen.sub_seed(1, "b")
