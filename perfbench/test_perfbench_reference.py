"""The plain reference against brute force, and what it may import."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference import topk as topk_ref

BENCH = Path(__file__).resolve().parent


def random_csr(rng, n_rows, n_cols, max_len):
    lens = rng.integers(0, max_len + 1, size=n_rows)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    indices = np.concatenate([np.sort(rng.choice(n_cols, size=n, replace=False))
                              for n in lens]).astype(np.int32)
    data = rng.standard_normal(int(indptr[-1])).astype(np.float32)
    return indptr, indices, data


def dense(indptr, indices, data, n_cols):
    out = np.zeros((len(indptr) - 1, n_cols), np.float64)
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    out[rows, indices] = data
    return out


def brute_partitioned(scores, bounds, k, big_k):
    """numpy: per partition the k best (score desc, row asc), then the K best."""
    cands = []
    for p in range(len(bounds) - 1):
        rows = np.arange(bounds[p], bounds[p + 1])
        order = np.lexsort((rows, -scores[rows]))[:k]
        cands.extend(rows[order])
    cands = np.array(cands)
    order = np.lexsort((cands, -scores[cands]))[:big_k]
    return scores[cands[order]], cands[order]


@pytest.mark.parametrize("n_rows,c,k,big_k", [(97, 4, 3, 10), (256, 8, 8, 32), (50, 7, 2, 14)])
def test_partitioned_topk_matches_brute_force(n_rows, c, k, big_k):
    rng = np.random.default_rng(n_rows)
    indptr, indices, data = random_csr(rng, n_rows, 40, 9)
    xs = rng.standard_normal((5, 40)).astype(np.float32)
    coll = topk_ref.Collection(indptr, indices, 40, "cpu")
    scores = topk_ref.row_scores(coll.matrix(torch.from_numpy(data)), torch.from_numpy(xs))
    bounds = topk_ref.partition_bounds(n_rows, c)
    v, r = topk_ref.partitioned_topk(scores, bounds, k, big_k)
    exact = dense(indptr, indices, data, 40) @ xs.astype(np.float64).T
    for q in range(5):
        s = scores[:, q].numpy()
        np.testing.assert_allclose(s, exact[:, q], rtol=1e-5, atol=1e-5)
        want_v, want_r = brute_partitioned(s, bounds, k, big_k)
        np.testing.assert_array_equal(v[q].numpy(), want_v)
        np.testing.assert_array_equal(r[q].numpy(), want_r)
        top = topk_ref.exact_topk_rows(scores, 6)[q].numpy()
        assert set(top) == set(np.argsort(-exact[:, q], kind="stable")[:6])


def test_partition_bounds_put_the_remainder_first():
    np.testing.assert_array_equal(topk_ref.partition_bounds(10, 4), [0, 3, 6, 8, 10])
    np.testing.assert_array_equal(topk_ref.partition_bounds(10_000_000, 32)[:3],
                                  [0, 312_500, 625_000])


def test_decode_rounds_as_the_formats_store():
    v = torch.tensor([0.30000001, -0.7, 1.5, -2.0, 0.5 / 128, 1.5 / 128, 1e-3])
    bf = topk_ref.decode(v, "BF16")
    bits = v.numpy().view(np.uint32).astype(np.uint64)
    rne = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    np.testing.assert_array_equal(bf.numpy(), rne.astype(np.uint32).view(np.float32))
    q7 = topk_ref.decode(v, "Q7").numpy()
    np.testing.assert_array_equal(q7 * 128, [38, -90, 127, -128, 0, 2, 0])
    q15 = topk_ref.decode(v, "Q15").numpy()
    np.testing.assert_array_equal(q15 * 32768, [9830, -22938, 32767, -32768, 128, 384, 33])
    np.testing.assert_array_equal(topk_ref.decode(v, "F32").numpy(), v.numpy())


def imported_top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


# The yardstick: everything but the one module that builds the program
# (system.py), the entries that call it, the control and the tests.
YARDSTICK = [p for p in sorted(BENCH.rglob("*.py"))
             if p.name not in ("system.py", "run.py", "control.py", "sweep_open.py")
             and not p.name.startswith("test_")]


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: str(p.relative_to(BENCH)))
def test_yardstick_imports_neither_jax_nor_either_package(path):
    names = imported_top_names(path)
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_benchmark_module_imports_jax(path):
    assert not harness.forbidden_modules(imported_top_names(path))


def test_reference_modules_are_scanned():
    assert {p.name for p in YARDSTICK} >= {"topk.py", "check.py", "gen.py",
                                            "roofline.py", "tracing.py", "harness.py"}
