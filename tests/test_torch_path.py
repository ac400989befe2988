"""The port's query path end to end against the reference, on the CPU.

Finalize and merge, ``build_index`` + ``topk_spmv(_batched)``, the executor's
counters, and the ``SparseEmbeddingIndex`` facade (queries, live updates,
stats and the graph calls), each against ``repro`` on the same inputs (made
from a seed with numpy) with ``device="cpu"``.  The
reference's own facade snapshot (segmented, power-of-two padded) is carried
across with ``packed_from_arrays`` and must give the same answers.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import bscsr as jbscsr
from repro.core import partition as jpartition
from repro.core.similarity import SparseEmbeddingIndex as JaxIndex
from repro.kernels import ops as jops
from repro_torch.convert import packed_from_arrays
from repro_torch.core import bscsr as tbscsr
from repro_torch.core import partition as tpartition
from repro_torch.core import topk_spmv as ttopk
from repro_torch.core.similarity import SparseEmbeddingIndex as TorchIndex
from repro_torch.kernels import executor as texecutor
from repro_torch.kernels import ops as tops

# ``repro.core`` re-exports a function named ``topk_spmv`` over its submodule.
jtopk = importlib.import_module("repro.core.topk_spmv")

TOL = 1e-5
N_COLS = 64


def port_csr(csr) -> tbscsr.CSRMatrix:
    return tbscsr.CSRMatrix(csr.indptr, csr.indices, csr.data, csr.shape)


def np_pair(res):
    return tuple(np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a) for a in res)


def assert_bitwise(a, b):
    a, b = np_pair(a), np_pair(b)
    np.testing.assert_array_equal(a[0].view(np.int32), b[0].view(np.int32))
    np.testing.assert_array_equal(a[1], b[1])


def assert_close_rows(a, b, tol=TOL):
    """Values within tol; row ids equal except inside a near-tie of scores."""
    a, b = np_pair(a), np_pair(b)
    np.testing.assert_allclose(a[0], b[0], rtol=tol, atol=tol)
    va = a[0].reshape(-1, a[0].shape[-1])
    for i, j in zip(*np.nonzero(a[1].reshape(va.shape) != b[1].reshape(va.shape))):
        gaps = np.abs(va[i] - va[i, j])
        gaps[j] = np.inf
        assert gaps.min() <= 2 * tol, f"row ids differ outside a tie at {(i, j)}"


def tcfg(**kw):
    return ttopk.TopKSpMVConfig(device="cpu", **kw)


class TestMergeAndFinalize:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_merge_topk_ties(self, seed):
        rng = np.random.default_rng(seed)
        vals = rng.integers(-3, 4, size=60).astype(np.float32) / 2
        vals[rng.random(60) < 0.2] = -0.0
        vals[rng.random(60) < 0.1] = tpartition.NEG_INF
        rows = rng.integers(0, 40, size=60).astype(np.int32)   # duplicate ids too
        for big_k, n_rows in [(10, 35), (10, None), (80, 35)]:
            a = jpartition.merge_topk(jnp.asarray(vals), jnp.asarray(rows), big_k, n_rows)
            b = tpartition.merge_topk(torch.from_numpy(vals), torch.from_numpy(rows),
                                      big_k, n_rows)
            assert_bitwise(a, b)

    @pytest.mark.parametrize("mode", ["affine", "slots", "slots+tombstones+row_map"])
    def test_finalize_candidates(self, mode):
        rng = np.random.default_rng(3)
        c, q, k, width = 4, 3, 6, 16
        lv = (rng.integers(-8, 9, size=(c, q, k)) / 4).astype(np.float32)
        lr = rng.integers(0, width + 2, size=(c, q, k)).astype(np.int32)
        row_starts = np.array([0, 12, 24, 36], np.int32)
        rows_per = np.array([12, 12, 11, 14], np.int32)
        kw = {}
        if mode != "affine":
            slot = rng.permutation(64)[: c * width].reshape(c, width).astype(np.int32)
            slot[rng.random((c, width)) < 0.15] = tops.INVALID_ROW
            kw["slot_to_row"] = slot
        if mode == "slots+tombstones+row_map":
            kw["tombstones"] = rng.random(64) < 0.2
            row_map = rng.permutation(200)[:64].astype(np.int32)
            row_map[rng.random(64) < 0.1] = tops.INVALID_ROW
            kw["row_map"] = row_map
        n_rows = 200 if "row_map" in kw else 64
        jkw = {key: jnp.asarray(v) for key, v in kw.items()}
        tkw = {key: torch.from_numpy(v) for key, v in kw.items()}
        a = jops.finalize_candidates_batched(
            jnp.asarray(lv), jnp.asarray(lr), jnp.asarray(row_starts),
            jnp.asarray(rows_per), 10, n_rows, **jkw)
        b = tops.finalize_candidates_batched(
            torch.from_numpy(lv), torch.from_numpy(lr), torch.from_numpy(row_starts),
            torch.from_numpy(rows_per), 10, n_rows, **tkw)
        assert_bitwise(a, b)
        a1 = jops.finalize_candidates(
            jnp.asarray(lv[:, 0]), jnp.asarray(lr[:, 0]), jnp.asarray(row_starts),
            jnp.asarray(rows_per), 10, n_rows, **jkw)
        b1 = tops.finalize_candidates(
            torch.from_numpy(lv[:, 0]), torch.from_numpy(lr[:, 0]),
            torch.from_numpy(row_starts), torch.from_numpy(rows_per), 10, n_rows, **tkw)
        assert_bitwise(a1, b1)


class TestIndexAPI:
    @pytest.mark.parametrize("fmt", ["F32", "BF16", "Q7"])
    def test_build_index_and_query(self, fmt):
        csr = jbscsr.synthetic_embedding_csr(400, N_COLS, 10, "gamma", seed=4)
        xs = np.random.default_rng(5).standard_normal((3, N_COLS)).astype(np.float32)
        kw = dict(big_k=16, k=8, num_partitions=4, block_size=32, value_format=fmt)
        jidx = jtopk.build_index(csr, jtopk.TopKSpMVConfig(**kw))
        for use_executor in (True, False):
            tidx = ttopk.build_index(port_csr(csr), tcfg(use_executor=use_executor, **kw))
            assert tidx.packed.num_cores == jidx.packed.num_cores
            for use_kernel in (True, False):
                assert_close_rows(
                    jtopk.topk_spmv(jidx, jnp.asarray(xs[0]), use_kernel=use_kernel),
                    ttopk.topk_spmv(tidx, xs[0], use_kernel=use_kernel))
                assert_close_rows(
                    jtopk.topk_spmv_batched(jidx, jnp.asarray(xs), use_kernel=use_kernel),
                    ttopk.topk_spmv_batched(tidx, xs, use_kernel=use_kernel))
        ev, er = jtopk.topk_spmv_exact(csr, xs[0], 16)
        tv, tr = ttopk.topk_spmv_exact(port_csr(csr), xs[0], 16)
        np.testing.assert_array_equal(ev, tv)
        np.testing.assert_array_equal(er, tr)

    def test_resolve_partitions_and_precision(self):
        j = jtopk.TopKSpMVConfig(big_k=100, k=8)
        t = tcfg(big_k=100, k=8)
        for n in (1000, 100_000, 10_000_000):
            assert j.resolve_partitions(n) == t.resolve_partitions(n)
        assert t.resolve_partitions(10_000_000) == 32

    def test_executor_counters(self):
        csr = jbscsr.synthetic_embedding_csr(200, N_COLS, 8, "gamma", seed=6)
        cfg = tcfg(big_k=10, k=8, num_partitions=2, block_size=32)
        idx = ttopk.build_index(port_csr(csr), cfg)
        ex = texecutor.QueryExecutor(big_k=10, k=8, device="cpu")
        xs = torch.from_numpy(
            np.random.default_rng(7).standard_normal((5, N_COLS)).astype(np.float32))
        first = ex.query_batched(xs, idx.packed)
        pins, builds = ex.h2d_copies, ex.fn_builds
        assert pins > 0 and builds == 1
        for _ in range(3):                       # steady state: no copies, no builds
            assert_bitwise(first, ex.query_batched(xs, idx.packed))
        assert (ex.h2d_copies, ex.fn_builds) == (pins, builds)
        assert ex.q_bucket_hits == 3 and ex.q_exact_hits == 0
        ex.query_batched(xs.numpy(), idx.packed)  # a host query pins nothing
        assert ex.h2d_copies == pins
        ex.query(xs[0], idx.packed)
        assert ex.fn_builds == builds + 1
        assert ex.cache_info()["device_snapshots"] == 1

    def test_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        csr = jbscsr.synthetic_embedding_csr(50, N_COLS, 4, "gamma", seed=9)
        idx = ttopk.build_index(port_csr(csr), ttopk.TopKSpMVConfig(num_partitions=2))
        x = np.zeros(N_COLS, np.float32)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttopk.topk_spmv(idx, x)
        svc = TorchIndex(port_csr(csr), ttopk.TopKSpMVConfig(num_partitions=2))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            svc.query(x)


@pytest.fixture(scope="module")
def facades():
    emb = np.random.default_rng(10).standard_normal((120, N_COLS)).astype(np.float32)
    kw = dict(big_k=8, k=16, num_partitions=4, block_size=32, value_format="BF16")
    j = JaxIndex.from_dense(emb, nnz_per_row=12, config=jtopk.TopKSpMVConfig(**kw))
    t = TorchIndex.from_dense(emb, nnz_per_row=12, config=tcfg(**kw))
    return j, t


class TestFacade:
    def test_queries_match_the_reference(self, facades):
        j, t = facades
        xs = np.random.default_rng(11).standard_normal((5, N_COLS)).astype(np.float32)
        assert_close_rows(j.query(xs[0]), t.query(xs[0]))
        assert_close_rows(j.query_batch(xs, use_kernel=True), t.query_batch(xs))
        assert_close_rows(j.query_batch(xs, use_kernel=False),
                          t.query_batch(xs, use_kernel=False))
        ev, er = j.query_exact(xs[1])
        tv, tr = t.query_exact(xs[1])
        np.testing.assert_array_equal(ev, tv)
        np.testing.assert_array_equal(er, tr)
        assert t.query(xs[0])[0].shape == (8,)

    def test_reference_snapshot_carried_across(self, facades):
        """The reference facade's segmented, power-of-two padded snapshot."""
        j, _ = facades
        jp = j.index.packed
        assert jp.slot_to_row is not None and jp.max_slots > int(jp.num_slots.max())
        fields = {name: getattr(jp, name) for name in (
            "vals", "cols", "flags", "words", "n_cols", "nnz", "block_size",
            "stream_layout", "slot_to_row", "num_slots", "n_rows_total",
            "tombstones", "base_packets", "delta_nnz", "dead_nnz", "tombstone_count")}
        fields["plan"] = dataclasses.asdict(jp.plan)
        fields["value_format"] = jp.value_format.name
        packed = packed_from_arrays(fields)
        assert packed.fused_words().tobytes() == np.ascontiguousarray(jp.words).tobytes()
        assert packed.max_slots == jp.max_slots
        xs = np.random.default_rng(12).standard_normal((4, N_COLS)).astype(np.float32)
        want = j.query_batch(xs, use_kernel=True)
        got = tops.topk_spmv_batched(xs, packed, big_k=8, k=16, device="cpu")
        assert_close_rows(want, got)
        assert_close_rows(want, tops.topk_spmv_reference_batched(
            xs, packed, big_k=8, k=16, device="cpu"))

    def test_dispatch_info(self, facades):
        j, t = facades
        t.query(np.ones(N_COLS, np.float32))
        info = t.dispatch_info()
        want = j.index.packed.signature_info()
        assert info["fn_builds"] >= 1 and info["signature"] == want
        assert info["signature"]["slot_bucket"] == 32 and info["churn_stable"] is True
        before = info["h2d_copies"]
        t.query(np.ones(N_COLS, np.float32))
        assert t.dispatch_info()["h2d_copies"] == before

    @pytest.mark.parametrize("call", ["upsert", "delete", "compact", "stats",
                                      "personalized_pagerank", "topk_eigen"])
    def test_mutable_and_graph_surfaces_match_the_reference(self, call):
        """Each call on fresh facades of both packages: same stats, answers and
        (for the graph calls, on a square collection) the same solves."""
        from repro.core import graph as jgraph

        kw = dict(big_k=8, k=8, num_partitions=3, block_size=32)
        rng = np.random.default_rng(14)
        if call in ("personalized_pagerank", "topk_eigen"):
            csr = jgraph.synthetic_graph_csr("er", 64, seed=1,
                                             symmetric=call == "topk_eigen")
            j = JaxIndex(csr, jtopk.TopKSpMVConfig(**kw))
            t = TorchIndex(port_csr(csr), tcfg(**kw))
            if call == "personalized_pagerank":
                a = j.personalized_pagerank([3, 9], tol=1e-5, use_kernel=False)
                b = t.personalized_pagerank([3, 9], tol=1e-5)
                assert b.canonical and b.converged and b.retraces == 0
                np.testing.assert_array_equal(a.scores.view(np.int32),
                                              b.scores.view(np.int32))
            else:
                a = j.topk_eigen(2, tol=1e-5, max_iters=3000, use_kernel=False)
                b = t.topk_eigen(2, tol=1e-5, max_iters=3000)
                assert b.converged and b.retraces == 0
                np.testing.assert_allclose(a.values, b.values, rtol=0, atol=1e-5)
            return
        emb = rng.standard_normal((90, N_COLS)).astype(np.float32)
        new = rng.standard_normal((4, N_COLS)).astype(np.float32)
        j = JaxIndex.from_dense(emb, nnz_per_row=12, config=jtopk.TopKSpMVConfig(**kw))
        t = TorchIndex.from_dense(emb, nnz_per_row=12, config=tcfg(**kw))
        for svc in (j, t):
            if call == "upsert":
                np.testing.assert_array_equal(svc.upsert(new[:2]), [90, 91])
                svc.upsert(new[2:], ids=[5, 6])
            elif call in ("delete", "compact"):
                svc.delete([2, 40])
            if call == "compact":
                svc.compact()
        assert dataclasses.asdict(j.stats()) == dataclasses.asdict(t.stats())
        xs = rng.standard_normal((3, N_COLS)).astype(np.float32)
        assert_close_rows(j.query_batch(xs, use_kernel=False), t.query_batch(xs))
        if call in ("delete", "compact"):
            assert not {2, 40} & set(t.query_batch(xs)[1].reshape(-1).tolist())

    @pytest.mark.parametrize("case", ["mesh", "n_shards", "from_index"])
    def test_later_slices_raise(self, facades, case):
        """The sharded plane raises naming its ROADMAP item; ``from_index``
        (ported with the serving plane) wraps the index it is given."""
        j, t = facades
        csr = port_csr(j.csr)
        if case == "from_index":
            wrapped = TorchIndex.from_index(t.index, nnz_per_row=t.nnz_per_row)
            assert wrapped.index is t.index and wrapped.config == t.config
            assert not wrapped.is_sharded and wrapped.replica_factor == 1
            xs = np.random.default_rng(9).standard_normal((3, N_COLS)).astype(np.float32)
            for a, b in zip(wrapped.query_batch(xs), t.query_batch(xs)):
                np.testing.assert_array_equal(a, b)
            return
        call = {
            "mesh": lambda: TorchIndex(csr, tcfg(), mesh=object()),
            "n_shards": lambda: TorchIndex(csr, tcfg(), n_shards=2),
        }[case]
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


class TestQueryValidation:
    """The query checks of the reference's input-hardening suite."""

    @pytest.mark.parametrize("case,match", [
        ("nan", "non-finite"), ("inf", "non-finite"),
        ("narrow", "width 63 != index feature dim"), ("rank", "1-D"),
        ("batch_nan", "non-finite"), ("batch_rank", "2-D"),
        ("batch_wide", "width 65 != index feature dim"),
    ])
    def test_rejected(self, facades, case, match):
        _, t = facades
        x = np.zeros(N_COLS, np.float32)
        xs = np.zeros((3, N_COLS), np.float32)
        if case == "nan":
            x[3] = np.nan
        elif case == "inf":
            x[0] = np.inf
        elif case == "batch_nan":
            xs[1, 5] = np.nan
        call = {
            "nan": lambda: t.query(x), "inf": lambda: t.query(x),
            "narrow": lambda: t.query(np.zeros(N_COLS - 1, np.float32)),
            "rank": lambda: t.query(np.zeros((2, N_COLS), np.float32)),
            "batch_nan": lambda: t.query_batch(xs),
            "batch_rank": lambda: t.query_batch(np.zeros(N_COLS, np.float32)),
            "batch_wide": lambda: t.query_batch(np.zeros((2, N_COLS + 1), np.float32)),
        }[case]
        with pytest.raises(ValueError, match=match):
            call()

    def test_valid_query_still_served(self, facades):
        _, t = facades
        v, r = t.query(np.random.default_rng(13).standard_normal(N_COLS).astype(np.float32))
        assert v.shape == (8,) and r.shape == (8,)
        assert np.isfinite(v).all()
