"""The port's accumulate kernel and graph workloads against the reference.

* ``bscsr_spmv`` (the plain version, which the CPU runs) against the
  reference's Pallas ``bscsr_spmv(interpret=True)`` on the same fused words:
  dyadic fixtures (values on a 2**-7 grid, queries on a 2**-3 grid) are exact
  in f32 in any summation order, so the slot sums must match bit for bit;
  under "legacy" and "linear-topk" the reference sums segments with a
  one-hot matmul, held within 1e-5.
* ``scatter_slot_sums`` bit for bit, with retired slots, tombstones and a
  row map.
* Whole solves: the reference runs them with ``use_kernel=False`` (its jnp
  oracle; the Pallas interpret loop would cost minutes per solve).
  Canonical PPR on a mutated mutable index must equal the reference bit for
  bit; without canonicalization within 1e-6 in L1.  Eigenvalues within
  1e-5, residuals at most 1e-4.  ``GraphRankingService`` counters and
  answers equal the reference's.
"""
import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import bscsr as jbscsr
from repro.core import graph as jgraph
from repro.core.similarity import SparseEmbeddingIndex as JaxIndex
from repro.kernels import bscsr_topk_spmv as jkern
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serve import GraphRankingService as JaxService
from repro_torch.core import bscsr as tbscsr
from repro_torch.core import graph as tgraph
from repro_torch.core import topk_spmv as ttopk
from repro_torch.core.similarity import SparseEmbeddingIndex as TorchIndex
from repro_torch.kernels import bscsr_topk_spmv as tkern
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.serve import GraphRankingService as TorchService

jtopk = importlib.import_module("repro.core.topk_spmv")

FORMATS = ["F32", "BF16", "Q15", "Q7"]
INNER_LOOPS = ("linear", "legacy", "linear-seg", "linear-topk")


def as_bytes(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def port_csr(csr) -> tbscsr.CSRMatrix:
    return tbscsr.CSRMatrix(csr.indptr, csr.indices, csr.data, csr.shape)


def bits(a) -> np.ndarray:
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def dyadic_csr(n_rows, n_cols, seed, empty_every=7, lens=None):
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(1, 13, size=n_rows)
        lens[::empty_every] = 0
    lens = np.asarray(lens)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.concatenate([np.sort(rng.choice(n_cols, int(n), replace=False))
                          for n in lens if n]).astype(np.int32)
    data = (rng.integers(-128, 128, int(lens.sum())) / 128.0).astype(np.float32)
    return jbscsr.CSRMatrix(indptr, idx, data, (len(lens), n_cols))


def both_words(csr, cores, block, fmt, t):
    jp = jops.pack_partitions(csr, cores, block, fmt, packets_multiple=t,
                              stream_layout="fused")
    tp = tops.pack_partitions(port_csr(csr), cores, block, fmt, packets_multiple=t,
                              stream_layout="fused")
    assert as_bytes(jp.words) == as_bytes(tp.words)
    return tp


def accumulate_pair(x, words, **kw):
    a = jkern.bscsr_spmv(jnp.asarray(x), jnp.asarray(words), stream_layout="fused",
                         interpret=True, **kw)
    b = tkern.bscsr_spmv(torch.from_numpy(x), torch.from_numpy(words), **kw)
    return np.asarray(a), b.numpy()


class TestAccumulateKernel:
    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("n_cols", [64, 40_000])     # int16 and int32 col ids
    def test_dyadic_slot_sums_bitwise(self, fmt, n_cols):
        """Empty rows, flag-free padding packets and a slot budget padded past
        the live count: every slot that never completes reads exactly 0.0."""
        csr = dyadic_csr(90, n_cols, seed=n_cols % 97)
        tp = both_words(csr, 3, 32, fmt, 2)
        words = np.concatenate([tp.words, np.zeros((3, 4, tp.words.shape[2]), np.int32)], 1)
        x = (np.random.default_rng(1).integers(-16, 17, n_cols) / 8.0).astype(np.float32)
        n_rows = 2 * tp.max_slots
        a, b = accumulate_pair(x, words, n_rows=n_rows, packets_per_step=2, fmt_name=fmt,
                               block_size=32)
        np.testing.assert_array_equal(bits(a), bits(b))
        live = np.asarray(tp.candidate_slots)
        phantom = np.arange(n_rows)[None, :] >= live[:, None]
        assert (bits(b)[phantom] == 0).all()                 # +0.0, not -0.0

    @pytest.mark.parametrize("loop", INNER_LOOPS)
    def test_inner_loops(self, loop):
        """A row over five packets, T = 1: linear loops bitwise, one-hot loops
        within 1e-5 (the same on a dyadic fixture, where order cannot matter)."""
        csr = dyadic_csr(7, 200, seed=6, lens=[3, 150, 2, 0, 5, 1, 4])
        tp = both_words(csr, 3, 32, "Q15", 1)
        x = (np.random.default_rng(7).integers(-16, 17, 200) / 8.0).astype(np.float32)
        a, b = accumulate_pair(x, tp.words, n_rows=tp.max_slots, packets_per_step=1,
                               fmt_name="Q15", block_size=32, inner_loop=loop)
        if loop in ("linear", "linear-seg"):
            np.testing.assert_array_equal(bits(a), bits(b))
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("splits", [3, 64])
    def test_split_walk_matches_the_reference(self, splits):
        """The split walk (S blocks per core, joined by the carry fix-up) on a
        row over five packets, empty rows and a padded budget: dyadic, so bit
        for bit against the reference's single walk."""
        csr = dyadic_csr(40, 200, seed=8, lens=np.tile([3, 150, 2, 0, 5, 1, 4, 33], 5))
        tp = both_words(csr, 3, 32, "Q15", 1)
        words = np.concatenate([tp.words, np.zeros((3, 3, tp.words.shape[2]), np.int32)], 1)
        x = (np.random.default_rng(9).integers(-16, 17, 200) / 8.0).astype(np.float32)
        kw = dict(n_rows=2 * tp.max_slots, packets_per_step=1, fmt_name="Q15",
                  block_size=32)
        a = jkern.bscsr_spmv(jnp.asarray(x), jnp.asarray(words), stream_layout="fused",
                             interpret=True, **kw)
        b = tkern.bscsr_spmv(torch.from_numpy(x), torch.from_numpy(words), splits=splits,
                             **kw)
        np.testing.assert_array_equal(bits(a), bits(b))
        bounds, _ = tkern.spmv_split_table(torch.from_numpy(words), packets_per_step=1,
                                           block_size=32, splits=splits)
        assert (bounds[:, 2] > bounds[:, 1]).all()          # at least two splits walk

    def test_random_within_tolerance_and_gather_modes(self):
        csr = jbscsr.synthetic_embedding_csr(300, 64, 9, "gamma", seed=14)
        tp = both_words(csr, 3, 64, "F32", 2)
        x = np.random.default_rng(15).standard_normal(64).astype(np.float32)
        kw = dict(n_rows=tp.max_slots, packets_per_step=2, fmt_name="F32", block_size=64)
        a, b = accumulate_pair(x, tp.words, **kw)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        w = torch.from_numpy(tp.words)
        for gather in tkern.GATHER_MODES:
            np.testing.assert_array_equal(
                bits(b), bits(tkern.bscsr_spmv(torch.from_numpy(x), w, gather_mode=gather,
                                               **kw)))

    def test_cpu_never_launches_and_meta_raises(self):
        tp = both_words(dyadic_csr(30, 64, seed=2), 2, 32, "F32", 2)
        kw = dict(n_rows=tp.max_slots, packets_per_step=2, fmt_name="F32", block_size=32)
        tkern.reset_launch_counts()
        tkern.bscsr_spmv(torch.zeros(64), torch.from_numpy(tp.words), **kw)
        assert tkern.bscsr_spmv.launches == 0
        with pytest.raises(ValueError, match="meta"):
            tkern.bscsr_spmv(torch.zeros(64, device="meta"), torch.from_numpy(tp.words),
                             **kw)
        assert tkern.bscsr_spmv.launches == 0

    def test_slot_sums_oracle(self):
        csr = dyadic_csr(60, 64, seed=22)
        jp = jops.pack_partitions(csr, 3, 32, "Q7", packets_multiple=2)
        tp = tops.pack_partitions(port_csr(csr), 3, 32, "Q7", packets_multiple=2)
        x = (np.random.default_rng(23).integers(-16, 17, 64) / 8.0).astype(np.float32)
        budget = 2 * tp.max_slots
        a = jref.bscsr_slot_sums_stacked(jnp.asarray(jp.vals), jnp.asarray(jp.cols),
                                         jnp.asarray(jp.flags), jnp.asarray(x), budget,
                                         "Q7")
        b = tref.bscsr_slot_sums_stacked(*tops.split_tensors(tp, "cpu"),
                                         torch.from_numpy(x), budget, "Q7")
        np.testing.assert_array_equal(bits(a), bits(b))


class TestScatterAndDispatch:
    @pytest.mark.parametrize("mode", ["affine", "slots+tombstones", "row_map"])
    def test_scatter_slot_sums_bitwise(self, mode):
        rng = np.random.default_rng(3)
        c, l = 4, 16
        sums = (rng.integers(-8, 9, size=(c, l)) / 4).astype(np.float32)
        sums[rng.random((c, l)) < 0.2] = -0.0
        row_starts = np.array([0, 12, 24, 36], np.int32)
        rows_per = np.array([12, 12, 11, 14], np.int32)
        kw = {}
        n_out = 50
        if mode != "affine":
            slot = rng.permutation(64)[: c * l].reshape(c, l).astype(np.int32)
            slot[rng.random((c, l)) < 0.15] = tops.INVALID_ROW
            kw["slot_to_row"] = slot
            kw["tombstones"] = rng.random(64) < 0.2
            n_out = 64
        if mode == "row_map":
            row_map = rng.permutation(200)[:64].astype(np.int32)
            row_map[rng.random(64) < 0.1] = tops.INVALID_ROW
            kw["row_map"] = row_map
            n_out = 200
        a = jops.scatter_slot_sums(jnp.asarray(sums), jnp.asarray(row_starts),
                                   jnp.asarray(rows_per), n_out,
                                   **{k: jnp.asarray(v) for k, v in kw.items()})
        b = tops.scatter_slot_sums(torch.from_numpy(sums), torch.from_numpy(row_starts),
                                   torch.from_numpy(rows_per), n_out,
                                   **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_array_equal(bits(a), bits(b))

    def test_blocked_and_reference_dispatch_on_a_mutated_index(self):
        csr = dyadic_csr(80, 80, seed=5)
        cfg = dict(k=8, num_partitions=3, block_size=32, value_format="Q15")
        j = jtopk.MutableTopKSpMVIndex(csr, jtopk.TopKSpMVConfig(**cfg))
        t = ttopk.MutableTopKSpMVIndex(port_csr(csr),
                                       ttopk.TopKSpMVConfig(device="cpu", **cfg))
        for idx in (j, t):
            idx.replace_rows([3], [(np.array([1, 5], np.int32),
                                    np.array([0.5, -0.25], np.float32))])
            idx.delete_rows([10, 11])
        rng = np.random.default_rng(6)
        x = (rng.integers(-16, 17, 80) / 8.0).astype(np.float32)
        y = (rng.integers(-16, 17, 80) / 8.0).astype(np.float32)
        a = jops.bscsr_spmv_blocked(jnp.asarray(x), j.packed, stream_layout="fused")
        b = tops.bscsr_spmv_blocked(x, t.packed, device="cpu")
        np.testing.assert_array_equal(bits(a), bits(b))
        assert (bits(b)[[10, 11]] == 0).all()
        a = jops.bscsr_spmv_reference(jnp.asarray(x), j.packed)
        np.testing.assert_array_equal(bits(a), bits(tops.bscsr_spmv_reference(
            x, t.packed, device="cpu")))
        a = jops.bscsr_spmv_reference(jnp.asarray(x), j.packed, alpha=0.5, beta=0.25,
                                      y=jnp.asarray(y))
        b = tops.bscsr_spmv_blocked(x, t.packed, alpha=0.5, beta=0.25, y=y, device="cpu")
        np.testing.assert_array_equal(bits(a), bits(b))

    def test_executor_spmv_counters_and_residency(self):
        csr = tgraph.synthetic_graph_csr("er", 96, seed=3)
        cfg = ttopk.TopKSpMVConfig(k=8, num_partitions=2, device="cpu")
        idx = ttopk.MutableTopKSpMVIndex(csr, cfg)
        ex = ttopk.query_executor(cfg)
        a, b = torch.tensor(0.85), torch.tensor(0.15)
        p = torch.zeros(96)
        p[5] = 1.0
        y = ex.spmv(p, idx.packed, alpha=a, beta=b, y=p)
        builds, copies = ex.fn_builds, ex.h2d_copies
        snap = ex.prepare(idx.packed, ("spmv", 96), "accumulate")[1]
        table = snap.split_table(cfg.packets_per_step, tkern.PLAIN_SPLITS)
        for _ in range(10):
            y = ex.spmv(y, idx.packed, alpha=a, beta=b, y=p, resident=True)
        assert (ex.fn_builds, ex.h2d_copies) == (builds, copies)
        # One split table per (snapshot, T, S), built on the device once.
        assert snap.split_table(cfg.packets_per_step, tkern.PLAIN_SPLITS) is table
        assert list(snap._split_tables) == [(cfg.packets_per_step, tkern.PLAIN_SPLITS)]
        ref = ex.spmv(p, idx.packed, alpha=a, beta=b, y=p, path="accumulate_ref")
        np.testing.assert_allclose(ref.numpy(), ex.spmv(
            p, idx.packed, alpha=a, beta=b, y=p).numpy(), rtol=1e-6, atol=1e-7)
        with pytest.raises(RuntimeError, match="not resident"):
            ex.spmv(p.numpy(), idx.packed, alpha=a, beta=b, y=p, resident=True)
        with pytest.raises(RuntimeError, match="alpha"):
            ex.spmv(p, idx.packed, alpha=0.85, beta=b, y=p, resident=True)


def mutable_pair(csr, **cfg):
    j = jtopk.MutableTopKSpMVIndex(csr, jtopk.TopKSpMVConfig(**cfg))
    t = ttopk.MutableTopKSpMVIndex(port_csr(csr), ttopk.TopKSpMVConfig(device="cpu", **cfg))
    return j, t


def mutate_both(pair, csr):
    seg = csr.row_slice(7, 8)
    for idx in pair:
        idx.replace_rows([7], [(seg.indices, (seg.data * 1.02).astype(np.float32))])
        idx.delete_rows([11])


class TestPersonalizedPageRank:
    @pytest.mark.parametrize("kind,n,seed", [("ring", 80, 0), ("er", 96, 3), ("ba", 72, 7)])
    def test_canonical_bit_identical_on_a_mutated_index(self, kind, n, seed):
        csr = jgraph.synthetic_graph_csr(kind, n, seed=seed)
        pair = mutable_pair(csr, k=8, num_partitions=2)
        mutate_both(pair, csr)
        j, t = pair
        a = jgraph.personalized_pagerank(j, 5, tol=1e-5, use_kernel=False)
        b = tgraph.personalized_pagerank(t, 5, tol=1e-5)
        assert b.converged and b.canonical and b.retraces == 0
        np.testing.assert_array_equal(bits(a.scores), bits(b.scores))
        assert b.refine_iterations == a.refine_iterations
        a = jgraph.personalized_pagerank(j, 5, tol=1e-7, canonicalize=False,
                                         use_kernel=False)
        b = tgraph.personalized_pagerank(t, 5, tol=1e-7, canonicalize=False)
        assert not b.canonical
        assert np.abs(a.scores.astype(np.float64) - b.scores).sum() < 1e-6

    def test_converges_to_the_dense_oracle(self):
        csr = tgraph.synthetic_graph_csr("er", 96, seed=3)
        idx = ttopk.MutableTopKSpMVIndex(csr, ttopk.TopKSpMVConfig(
            k=8, num_partitions=2, device="cpu"))
        res = tgraph.personalized_pagerank(idx, 5, alpha=0.85, tol=1e-5)
        oracle = tgraph.dense_ppr_oracle(csr.to_dense(), np.eye(96, dtype=np.float32)[5],
                                         0.85)
        assert np.abs(res.scores.astype(np.float64) - oracle).sum() < 1e-6
        assert abs(float(res.scores.sum()) - 1.0) < 1e-5
        ref = tgraph.personalized_pagerank(idx, 5, alpha=0.85, tol=1e-5, use_kernel=False)
        np.testing.assert_array_equal(res.scores, ref.scores)

    def test_incremental_equals_cold_in_the_port(self):
        csr = tgraph.synthetic_graph_csr("er", 96, seed=3)
        idx = ttopk.MutableTopKSpMVIndex(csr, ttopk.TopKSpMVConfig(
            k=8, num_partitions=4, device="cpu"))
        base = tgraph.personalized_pagerank(idx, 5, tol=1e-5)
        seg = csr.row_slice(7, 8)
        idx.replace_rows([7], [(seg.indices, (seg.data * 1.02).astype(np.float32))])
        cold = tgraph.personalized_pagerank(idx, 5, tol=1e-5)
        warm = tgraph.personalized_pagerank(idx, 5, tol=1e-5, warm_start=base.scores)
        np.testing.assert_array_equal(cold.scores, warm.scores)
        assert warm.iterations < cold.iterations
        assert not np.array_equal(cold.scores, base.scores)
        idx.delete_rows([11])
        cold2 = tgraph.personalized_pagerank(idx, 5, tol=1e-5)
        warm2 = tgraph.personalized_pagerank(idx, 5, tol=1e-5,
                                             warm_start=torch.from_numpy(cold.scores))
        np.testing.assert_array_equal(cold2.scores, warm2.scores)
        assert warm2.retraces == 0 and cold2.retraces == 0

    def test_warm_and_cold_at_scale_match_the_reference(self):
        """Phase 6 of ``chip_smoke.py`` in both packages at 2**17 nodes.

        The service's cold rank, ``update_node`` (weights x 1.02), warm rank
        and forget + cold rank: the port equals the reference bit for bit in
        every solve.  On this operator the reference's own warm and cold
        solves differ in one score by 1 ulp: the canonical refinement leaves
        two tol-converged iterates ~5e-17 apart in L1 before rounding to f32,
        so a score whose ulp is below that spread can round either way.
        Bit-identity of warm and cold therefore holds for small graphs only,
        in both packages, and the port shows the same entries.
        """
        n, seeds, node = 1 << 17, [5, 17, 4242], 4243
        csr = jgraph.synthetic_graph_csr("ring", n, seed=5)
        pair = mutable_pair(csr, k=8, num_partitions=4, block_size=256, value_format="F32",
                            packets_per_step=2, stream_layout="fused")
        row = np.zeros(n, np.float32)
        seg = csr.row_slice(node, node + 1)
        row[seg.indices] = seg.data * 1.02
        solves = []
        for idx, service in zip(pair, (JaxService, TorchService)):
            svc = service(idx, tol=1e-5, use_kernel=False)
            cold = svc.rank(seeds, top_k=10).result
            svc.update_node(node, row)
            warm = svc.rank(seeds, top_k=10).result
            svc.forget(seeds)
            cold2 = svc.rank(seeds, top_k=10).result
            assert warm.iterations < cold2.iterations
            solves.append([r.scores for r in (cold, warm, cold2)])
        for a, b in zip(*solves):
            np.testing.assert_array_equal(bits(a), bits(b))
        _, warm, cold2 = solves[1]
        gap = np.abs(bits(warm).astype(np.int64) - bits(cold2))
        assert np.count_nonzero(gap) == 1 and gap.max() == 1

    def test_seed_forms_and_validation(self):
        csr = tgraph.synthetic_graph_csr("er", 64, seed=0)
        idx = ttopk.MutableTopKSpMVIndex(csr, ttopk.TopKSpMVConfig(
            k=8, num_partitions=2, device="cpu"))
        full = np.zeros(64, np.float32)
        full[5] = 1.0
        runs = [tgraph.personalized_pagerank(idx, s, tol=1e-5)
                for s in (5, [5], {5: 2.0}, full, torch.from_numpy(full))]
        for other in runs[1:]:
            np.testing.assert_array_equal(runs[0].scores, other.scores)
        for seeds in ([1, 2, 2], {3: 0.5, 9: 1.5}, full):
            np.testing.assert_array_equal(
                np.asarray(jgraph.seed_vector(seeds, 64)),
                tgraph.seed_vector(seeds, 64, device="cpu").numpy())
        with pytest.raises(ValueError, match="alpha"):
            tgraph.personalized_pagerank(idx, 0, alpha=1.5)
        with pytest.raises(ValueError, match="positive mass"):
            tgraph.seed_vector(np.zeros(64, np.float32), 64, device="cpu")
        square = ttopk.MutableTopKSpMVIndex(
            port_csr(jbscsr.synthetic_embedding_csr(100, 64, 8, "gamma", 0)),
            ttopk.TopKSpMVConfig(k=8, num_partitions=2, device="cpu"))
        with pytest.raises(ValueError, match="square"):
            tgraph.personalized_pagerank(square, 0)
        r = tgraph.PPRResult(np.asarray([0.1, 0.5, 0.5, 0.05], np.float32), 1, 0, 0.0,
                             True, False, 0)
        assert list(r.top_nodes(3)) == [1, 2, 0]

    def test_guard_raises_on_a_host_operand(self, monkeypatch):
        """The guarded steps upload nothing: a step handed a host operand raises."""
        csr = tgraph.synthetic_graph_csr("ba", 72, seed=7)
        idx = ttopk.MutableTopKSpMVIndex(csr, ttopk.TopKSpMVConfig(
            k=8, num_partitions=2, device="cpu"))
        ex = ttopk.query_executor(idx.config)
        real = ex.spmv

        def host_y(x, packed, *, alpha, beta, y, **kw):
            return real(x, packed, alpha=alpha, beta=beta, y=y.numpy(), **kw)

        monkeypatch.setattr(ex, "spmv", host_y)
        with pytest.raises(RuntimeError, match="not resident"):
            tgraph.personalized_pagerank(idx, 3, tol=1e-5)
        res = tgraph.personalized_pagerank(idx, 3, tol=1e-5, guard_iterations=False)
        assert res.converged


class TestTopKEigen:
    @pytest.mark.parametrize("kind,n,seed", [("er", 64, 1), ("ba", 64, 2)])
    def test_values_and_residuals(self, kind, n, seed):
        csr = jgraph.synthetic_graph_csr(kind, n, seed=seed, symmetric=True)
        j, t = mutable_pair(csr, k=4, num_partitions=2)
        a = jgraph.topk_eigen(j, 3, tol=1e-5, max_iters=3000, use_kernel=False)
        b = tgraph.topk_eigen(t, 3, tol=1e-5, max_iters=3000)
        assert b.converged and b.retraces == 0
        np.testing.assert_allclose(a.values, b.values, rtol=0, atol=1e-5)
        dense = csr.to_dense().astype(np.float64)
        for lam, v in zip(b.values, b.vectors.T):
            assert np.linalg.norm(dense @ v - lam * v) <= 1e-4
        np.testing.assert_allclose(b.vectors.T @ b.vectors, np.eye(3), atol=1e-4)
        with pytest.raises(ValueError, match="eigenpairs"):
            tgraph.topk_eigen(t, 0)


class TestGraphRankingService:
    def test_counters_and_answers_match_the_reference(self):
        csr = jgraph.synthetic_graph_csr("er", 96, seed=3)
        j, t = mutable_pair(csr, k=8, num_partitions=4)
        js, ts = JaxService(j, tol=1e-5, use_kernel=False), TorchService(t, tol=1e-5)
        row = np.zeros(96, np.float32)
        seg = csr.row_slice(9, 10)
        row[seg.indices] = seg.data * 1.05
        steps = [
            lambda s: s.rank(5, top_k=5),
            lambda s: s.update_node(9, row),
            lambda s: s.rank(5, top_k=5),
            lambda s: s.forget(5),
            lambda s: s.rank([5, 17], top_k=5),
            lambda s: s.rank(5, top_k=5),
            lambda s: s.delete_node(11),
            lambda s: s.rank(5, top_k=5),
        ]
        for step in steps:
            a, b = step(js), step(ts)
            if a is not None:
                np.testing.assert_array_equal(a.node_ids, b.node_ids)
                np.testing.assert_array_equal(bits(a.scores), bits(b.scores))
                assert a.warm_started == b.warm_started
                assert b.result.retraces == 0
            info_a, info_b = js.info(), ts.info()
            info_a.pop("kernel_iterations")
            assert info_a == {k: v for k, v in info_b.items() if k != "kernel_iterations"}
        assert ts.info()["incremental_solves"] == 2 and ts.info()["cold_solves"] == 3
        e = ts.topk_eigen(1, tol=1e-4, max_iters=2000)
        assert e.retraces == 0

    def test_facade_surface(self):
        """The facade's graph calls and the service over the facade (upsert
        path) against the reference facade."""
        csr = jgraph.synthetic_graph_csr("er", 64, seed=1)
        kw = dict(k=8, num_partitions=2)
        j = JaxIndex(csr, jtopk.TopKSpMVConfig(**kw))
        t = TorchIndex(port_csr(csr), ttopk.TopKSpMVConfig(device="cpu", **kw))
        a = j.personalized_pagerank(3, tol=1e-5, use_kernel=False)
        b = t.personalized_pagerank(3, tol=1e-5)
        np.testing.assert_array_equal(bits(a.scores), bits(b.scores))
        js, ts = JaxService(j, tol=1e-5, use_kernel=False), TorchService(t, tol=1e-5)
        row = csr.to_dense()[4] * 1.02
        for svc in (js, ts):
            svc.rank(3)
            svc.update_node(4, row)
        a, b = js.rank(3), ts.rank(3)
        assert b.warm_started and b.result.canonical
        np.testing.assert_array_equal(bits(a.scores), bits(b.scores))
        np.testing.assert_array_equal(a.node_ids, b.node_ids)
        scsr = jgraph.synthetic_graph_csr("er", 64, seed=1, symmetric=True)
        eig = TorchIndex(port_csr(scsr), ttopk.TopKSpMVConfig(device="cpu", **kw)) \
            .topk_eigen(1, tol=1e-4, max_iters=2000)
        assert eig.converged and abs(eig.values[0] - 1.0) < 1e-3


class TestFixtures:
    @pytest.mark.parametrize("kind", tgraph.GRAPH_KINDS)
    @pytest.mark.parametrize("symmetric", [False, True])
    def test_synthetic_graph_csr_bytes(self, kind, symmetric):
        for n, seed in ((40, 0), (257, 5)):
            a = jgraph.synthetic_graph_csr(kind, n, seed=seed, symmetric=symmetric)
            b = tgraph.synthetic_graph_csr(kind, n, seed=seed, symmetric=symmetric)
            for name in ("indptr", "indices", "data"):
                assert as_bytes(getattr(a, name)) == as_bytes(getattr(b, name))
            assert a.shape == b.shape
            np.testing.assert_array_equal(a.to_dense(), b.to_dense())

    def test_dense_ppr_oracle_and_decode(self):
        csr = jgraph.synthetic_graph_csr("ring", 50, seed=2)
        p = np.eye(50)[3]
        np.testing.assert_array_equal(jgraph.dense_ppr_oracle(csr.to_dense(), p, 0.85),
                                      tgraph.dense_ppr_oracle(csr.to_dense(), p, 0.85))
