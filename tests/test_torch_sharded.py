"""The port's sharded serving plane and approximate top-k head, on the CPU.

The same seeded inputs go through ``repro`` and ``repro_torch``
(``device="cpu"``, the kernels' plain versions):

- Tree merge: ``partition.tree_merge_topk(_batched)`` against the
  reference's, bit for bit, over 1-5 pools (non-powers of two, all-negative
  scores, pools smaller than ``big_k``, a global sentinel as an int and as
  a 0-d tensor), and against the flat merge.
- ``ShardedTopKSpMVIndex`` (S = 1, 3, 4) against the port's single-device
  mutable index, bit for bit, over inner loops, layouts, batches, the
  oracle path, churn, tombstones and compaction; and against the
  reference's ``ShardedTopKSpMVIndex`` under the same mutations: the same
  ids from ``add_rows``, the same ``deleted_rows``, answers bit for bit on
  dyadic fixtures (values on a 2**-7 grid, queries on a 2**-3 grid, exact in
  f32 in any summation order), otherwise within rtol = atol = 1e-5 with
  equal row ids outside near-ties.  The reference answers through its jnp
  oracle (``use_kernel=False``), which evaluates the same approximation as
  its interpreted kernel.
- Mixed precision (shard-local width classes, f32 twins == native),
  ``dispatch.shard`` failover, the sharded accumulate (``spmv``, PPR,
  eigen, ``GraphRankingService``) bit for bit against a single device, the
  facade and ``ApproxTopKHead`` sharded against unsharded and against the
  reference, and a store refused beside a sharded facade.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bscsr as jbscsr
from repro.core import faults as jfaults
from repro.core import graph as jgraph
from repro.core import partition as jpartition
from repro.core.sharded import ShardedTopKSpMVIndex as JSharded
from repro.core.similarity import SparseEmbeddingIndex as JIndex
from repro.serve.topk_head import ApproxTopKHead as JHead
from repro.serve.topk_head import TopKHeadConfig as JHeadConfig
from repro_torch.core import bscsr as tbscsr
from repro_torch.core import faults as tfaults
from repro_torch.core import graph as tgraph
from repro_torch.core import partition as tpartition
from repro_torch.core import topk_spmv as ttopk
from repro_torch.core.persistence import DurableIndexStore
from repro_torch.core.sharded import ShardedTopKSpMVIndex
from repro_torch.core.similarity import SparseEmbeddingIndex as TIndex
from repro_torch.kernels import executor as texecutor
from repro_torch.launch.mesh import DeviceMesh, make_serving_mesh
from repro_torch.serve import (
    ApproxTopKHead,
    FrontendConfig,
    GraphRankingService,
    StreamingSimilarityService,
    TopKHeadConfig,
)

jtopk = importlib.import_module("repro.core.topk_spmv")
jmesh_lib = importlib.import_module("repro.launch.mesh")
CPU = torch.device("cpu")

N_COLS = 96
TOL = 1e-5
INNER_LOOPS = ("linear", "legacy", "linear-seg", "linear-topk")


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

def port_csr(csr) -> tbscsr.CSRMatrix:
    return tbscsr.CSRMatrix(csr.indptr, csr.indices, csr.data, csr.shape)


def tcfg(**kw) -> ttopk.TopKSpMVConfig:
    return ttopk.TopKSpMVConfig(device="cpu", **kw)


def gamma_csr(n_rows=240, seed=0):
    return jbscsr.synthetic_embedding_csr(n_rows, N_COLS, 10, "gamma", seed)


def dyadic_csr(n_rows=240, seed=0):
    """About 10 nnz a row on a 2**-7 grid (exact in F32 and BF16)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 20, size=n_rows)
    lens[::11] = 0
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.concatenate([np.sort(rng.choice(N_COLS, int(n), replace=False))
                          for n in lens if n]).astype(np.int32)
    data = (rng.integers(-128, 128, int(lens.sum())) / 128.0).astype(np.float32)
    return jbscsr.CSRMatrix(indptr, idx, data, (n_rows, N_COLS))


def queries(rng, q, dyadic):
    if dyadic:
        return (rng.integers(-16, 17, (q, N_COLS)) / 8.0).astype(np.float32)
    return rng.standard_normal((q, N_COLS)).astype(np.float32)


def sparse_rows(rng, n, dyadic=False, nnz=10):
    rows = []
    for _ in range(n):
        cols = np.sort(rng.choice(N_COLS, size=nnz, replace=False)).astype(np.int32)
        if dyadic:
            vals = (rng.integers(-128, 128, nnz) / 128.0).astype(np.float32)
        else:
            vals = rng.standard_normal(nnz).astype(np.float32)
        rows.append((cols, vals))
    return rows


def to_np(pair):
    return tuple(t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
                 for t in pair)


def assert_bits(a, b, msg=""):
    (av, ar), (bv, br) = to_np(a), to_np(b)
    np.testing.assert_array_equal(np.ascontiguousarray(av, np.float32).view(np.int32),
                                  np.ascontiguousarray(bv, np.float32).view(np.int32),
                                  err_msg=msg)
    np.testing.assert_array_equal(ar.astype(np.int64), br.astype(np.int64), err_msg=msg)


def assert_close_rows(want, got, tol=TOL):
    """Values within tol; row ids equal except inside a near-tie of scores."""
    (wv, wr), (gv, gr) = to_np(want), to_np(got)
    np.testing.assert_allclose(gv, wv, rtol=tol, atol=tol)
    va = wv.reshape(-1, wv.shape[-1])
    for i, j in zip(*np.nonzero(wr.reshape(va.shape) != gr.reshape(va.shape))):
        gaps = np.abs(va[i] - va[i, j])
        gaps[j] = np.inf
        assert gaps.min() <= 2 * tol, f"row ids differ outside a tie at {(i, j)}"


def assert_like_reference(want, got, dyadic):
    if dyadic:
        assert_bits(want, got)
    else:
        assert_close_rows(want, got)


def trio(csr, n_shards, **kw):
    """(port single-device, port sharded, reference sharded) over one CSR."""
    single = ttopk.MutableTopKSpMVIndex(port_csr(csr), tcfg(**kw))
    sharded = ShardedTopKSpMVIndex(port_csr(csr), tcfg(**kw), n_shards=n_shards)
    ref = JSharded(csr, jtopk.TopKSpMVConfig(**kw), n_shards=n_shards)
    return single, sharded, ref


def ref_query(ref, x):
    return ref.query(jnp.asarray(x), use_kernel=False)


# ---------------------------------------------------------------------------
# Tree merge
# ---------------------------------------------------------------------------

def merge_pools(rng, n_pools, pool, n_rows, all_negative=False):
    vals, rows = [], []
    for _ in range(n_pools):
        v = rng.standard_normal(pool).astype(np.float32)
        if all_negative:
            v = -np.abs(v) - 1.0
        # Exact ties across pools and sentinel entries the mask must hide.
        v[::3] = np.float32(-0.5 if all_negative else 0.5)
        r = rng.integers(0, n_rows + 4, size=pool).astype(np.int32)
        v[r >= n_rows] = tpartition.NEG_INF
        vals.append(v)
        rows.append(r)
    return vals, rows


class TestTreeMerge:
    @pytest.mark.parametrize("all_negative", [False, True])
    @pytest.mark.parametrize("n_pools", [1, 2, 3, 4, 5])
    def test_tree_equals_reference_and_flat(self, n_pools, all_negative):
        rng = np.random.default_rng(n_pools + 100 * all_negative)
        n_rows = 60 if all_negative else 100
        vals, rows = merge_pools(rng, n_pools, 24, n_rows, all_negative)
        want = jpartition.tree_merge_topk([jnp.asarray(v) for v in vals],
                                          [jnp.asarray(r) for r in rows], 16, n_rows)
        tv, tr = [torch.from_numpy(v) for v in vals], [torch.from_numpy(r) for r in rows]
        for sentinel in (n_rows, torch.tensor(n_rows, dtype=torch.int32)):
            got = tpartition.tree_merge_topk(tv, tr, 16, sentinel)
            assert_bits(want, got, f"n_pools={n_pools}")
            assert_bits(tpartition.merge_topk(torch.cat(tv), torch.cat(tr), 16, n_rows), got)
        valid = to_np(got)[1] < n_rows
        assert valid[:valid.sum()].all(), "a sentinel sorted before a candidate"

    def test_merge_order_invariance(self):
        rng = np.random.default_rng(7)
        vals, rows = merge_pools(rng, 5, 20, 80)
        tv, tr = [torch.from_numpy(v) for v in vals], [torch.from_numpy(r) for r in rows]
        want = tpartition.tree_merge_topk(tv, tr, 12, 80)
        for seed in range(4):
            perm = np.random.default_rng(seed).permutation(5)
            assert_bits(want, tpartition.tree_merge_topk([tv[i] for i in perm],
                                                         [tr[i] for i in perm], 12, 80))

    @pytest.mark.parametrize("sentinel_tensor", [False, True])
    def test_pool_smaller_than_big_k(self, sentinel_tensor):
        vals = [np.asarray([1.0, 2.0], np.float32), np.asarray([0.5], np.float32)]
        rows = [np.asarray([4, 1], np.int32), np.asarray([12], np.int32)]
        want = jpartition.tree_merge_topk([jnp.asarray(v) for v in vals],
                                          [jnp.asarray(r) for r in rows], 8, 10)
        sentinel = torch.tensor(10) if sentinel_tensor else 10
        got = tpartition.tree_merge_topk([torch.from_numpy(v) for v in vals],
                                         [torch.from_numpy(r) for r in rows], 8, sentinel)
        assert_bits(want, got)
        v, r = to_np(got)
        assert v.shape == (8,) and list(r[:2]) == [1, 4] and (r[2:] == 10).all()

    @pytest.mark.parametrize("n_pools", [1, 3, 4])
    def test_batched_matches_reference_and_per_query(self, n_pools):
        rng = np.random.default_rng(11 + n_pools)
        q, pool, n_rows, big_k = 5, 16, 50, 12
        vals = [rng.standard_normal((q, pool)).astype(np.float32) for _ in range(n_pools)]
        rows = [rng.integers(0, n_rows + 3, (q, pool)).astype(np.int32)
                for _ in range(n_pools)]
        want = jpartition.tree_merge_topk_batched([jnp.asarray(v) for v in vals],
                                                  [jnp.asarray(r) for r in rows],
                                                  big_k, n_rows)
        tv, tr = [torch.from_numpy(v) for v in vals], [torch.from_numpy(r) for r in rows]
        got = tpartition.tree_merge_topk_batched(tv, tr, big_k, torch.tensor(n_rows))
        assert_bits(want, got)
        assert_bits(tpartition.merge_rows_topk(torch.cat(tv, -1), torch.cat(tr, -1), big_k,
                                               torch.tensor(n_rows)), got)
        for i in range(q):
            one = tpartition.tree_merge_topk([v[i] for v in tv], [r[i] for r in tr],
                                             big_k, n_rows)
            assert_bits((got[0][i], got[1][i]), one, f"query {i}")

    def test_no_pool_raises(self):
        with pytest.raises(ValueError, match="at least one"):
            tpartition.tree_merge_topk([], [], 4, 10)
        with pytest.raises(ValueError, match="at least one"):
            tpartition.tree_merge_topk_batched([], [], 4, 10)


# ---------------------------------------------------------------------------
# Sharded == single device (per-shard dispatch)
# ---------------------------------------------------------------------------

class TestPerShardEquivalence:
    @pytest.mark.parametrize("dyadic", [False, True])
    @pytest.mark.parametrize("n_shards", [1, 3, 4])
    def test_static_query(self, n_shards, dyadic):
        csr = dyadic_csr() if dyadic else gamma_csr()
        single, sharded, ref = trio(csr, n_shards, big_k=16, k=8, num_partitions=12,
                                    block_size=64)
        x = queries(np.random.default_rng(1), 1, dyadic)[0]
        got = sharded.query(x)
        assert_bits(ttopk.topk_spmv(single, x), got)
        assert_like_reference(ref_query(ref, x), got, dyadic)

    @pytest.mark.parametrize("inner_loop", INNER_LOOPS)
    @pytest.mark.parametrize("layout", ["fused", "split"])
    def test_inner_loops_and_layouts(self, inner_loop, layout):
        csr = gamma_csr(seed=3)
        kw = dict(big_k=16, k=8, num_partitions=8, block_size=64, inner_loop=inner_loop,
                  stream_layout=layout)
        single = ttopk.MutableTopKSpMVIndex(port_csr(csr), tcfg(**kw))
        sharded = ShardedTopKSpMVIndex(port_csr(csr), tcfg(**kw), n_shards=4)
        x = queries(np.random.default_rng(4), 1, False)[0]
        got = sharded.query(x)
        assert_bits(ttopk.topk_spmv(single, x), got, f"{inner_loop}/{layout}")
        assert_close_rows(jtopk.topk_spmv(
            jtopk.MutableTopKSpMVIndex(csr, jtopk.TopKSpMVConfig(**kw)), jnp.asarray(x),
            use_kernel=False), got)

    @pytest.mark.parametrize("dyadic", [False, True])
    def test_batched(self, dyadic):
        csr = dyadic_csr(seed=5) if dyadic else gamma_csr(seed=5)
        single, sharded, ref = trio(csr, 4, big_k=16, k=8, num_partitions=8, block_size=64)
        xs = queries(np.random.default_rng(9), 6, dyadic)
        got = sharded.query_batched(xs)
        assert_bits(ttopk.topk_spmv_batched(single, xs), got)
        assert_like_reference(ref.query_batched(jnp.asarray(xs), use_kernel=False), got,
                              dyadic)
        for i in range(6):
            assert_bits((got[0][i], got[1][i]), sharded.query(xs[i]))

    def test_reference_path(self):
        csr = dyadic_csr(seed=6)
        single, sharded, ref = trio(csr, 2, big_k=16, k=8, num_partitions=8, block_size=64)
        x = queries(np.random.default_rng(6), 1, True)[0]
        got = sharded.query(x, use_kernel=False)
        assert_bits(ttopk.topk_spmv(single, x, use_kernel=False), got)
        assert_bits(got, sharded.query(x))
        assert_bits(ref_query(ref, x), got)

    @pytest.mark.parametrize("dyadic", [False, True])
    @pytest.mark.parametrize("n_shards", [3, 4])
    def test_churn_and_tombstones(self, n_shards, dyadic):
        """add / replace / delete / compact route to the single-device state,
        and to the reference's sharded state, step for step."""
        csr = dyadic_csr(n_rows=180, seed=8) if dyadic else gamma_csr(n_rows=180, seed=8)
        single, sharded, ref = trio(csr, n_shards, big_k=16, k=8, num_partitions=12,
                                    block_size=64)
        rng = np.random.default_rng(42)
        xs = queries(rng, 3, dyadic)

        def check(what):
            got = sharded.query_batched(xs)
            assert_bits(ttopk.topk_spmv_batched(single, xs), got, what)
            assert_like_reference(ref.query_batched(jnp.asarray(xs), use_kernel=False),
                                  got, dyadic)
            assert_bits(ttopk.topk_spmv(single, xs[0]), sharded.query(xs[0]), what)
            assert (sharded.n_rows, sharded.n_rows_total, sharded.deleted_rows) == (
                ref.n_rows, ref.n_rows_total, ref.deleted_rows)
            return got

        batch = sparse_rows(rng, 7, dyadic)
        ids = sharded.add_rows(batch)
        assert ids == single.add_rows(batch) == ref.add_rows(batch)
        check("after add")
        ids = [3, 50, 170, 181]                 # spans shards, includes a fresh id
        rep = sparse_rows(rng, len(ids), dyadic)
        for idx in (single, sharded, ref):
            idx.replace_rows(ids, rep)
        check("after replace")
        dels = [0, 44, 95, 179]
        for idx in (single, sharded, ref):
            idx.delete_rows(dels)
        assert sharded.deleted_rows == single.deleted_rows == ref.deleted_rows
        _, rows = to_np(check("after delete"))
        assert not set(rows.reshape(-1).tolist()) & set(dels)
        for idx in (single, sharded, ref):
            idx.compact()
        check("after compact")
        more = sparse_rows(rng, 5, dyadic)        # post-compact: fresh maps and stamps
        assert sharded.add_rows(more) == single.add_rows(more) == ref.add_rows(more)
        check("post-compact add")
        csr_t, gids_t = sharded.live_csr()
        csr_j, gids_j = ref.live_csr()
        np.testing.assert_array_equal(gids_t, gids_j)
        for name in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(csr_t, name), getattr(csr_j, name))

    def test_steady_state_pins_and_retraces(self):
        csr = gamma_csr(seed=12)
        cfg = tcfg(big_k=16, k=8, num_partitions=8, block_size=64)
        sharded = ShardedTopKSpMVIndex(port_csr(csr), cfg, n_shards=4)
        ex = ttopk.query_executor(cfg)
        xs = queries(np.random.default_rng(3), 8, False)
        sharded.query_batched(xs)
        before = ex.cache_info()
        for _ in range(3):
            sharded.query_batched(xs)
        after = ex.cache_info()
        assert after["h2d_copies"] == before["h2d_copies"]
        assert after["fn_builds"] == before["fn_builds"]
        assert after["dispatches"] == before["dispatches"] + 12
        rng = np.random.default_rng(5)
        sharded.add_rows(sparse_rows(rng, 2))
        sharded.query_batched(xs)
        first = ex.cache_info()["retraces"]
        for _ in range(3):                        # within the buckets: no retrace
            sharded.add_rows(sparse_rows(rng, 1))
            sharded.query_batched(xs)
        assert ex.cache_info()["retraces"] == first

    def test_dispatch_info_topology(self):
        sharded = ShardedTopKSpMVIndex(port_csr(gamma_csr()), tcfg(
            big_k=16, k=8, num_partitions=12, block_size=64), n_shards=3)
        ref = JSharded(gamma_csr(), jtopk.TopKSpMVConfig(
            big_k=16, k=8, num_partitions=12, block_size=64), n_shards=3)
        info, want = sharded.dispatch_info(), ref.dispatch_info()
        assert info["path"] == want["path"] == "per_shard"
        assert info["topology"] == want["topology"]
        assert info["health"] == want["health"]
        assert len(info["per_shard"]) == 3
        for got, exp in zip(info["per_shard"], want["per_shard"]):
            assert got == exp

    def test_shard_count_must_divide_partitions(self):
        with pytest.raises(ValueError, match="divide"):
            ShardedTopKSpMVIndex(port_csr(gamma_csr()), tcfg(
                big_k=16, k=8, num_partitions=12, block_size=64), n_shards=5)

    def test_mesh_raises_naming_its_roadmap_item(self):
        """The mesh path (ported since) holds the per-shard answers bit for
        bit; a mesh without a "shard" axis and an ``n_shards`` that
        contradicts the mesh raise with the reference's texts."""
        csr = gamma_csr()
        cfg = tcfg(big_k=16, k=8, num_partitions=4, block_size=64)
        per_shard = ShardedTopKSpMVIndex(port_csr(csr), cfg, n_shards=2)
        mesh = make_serving_mesh(n_shards=2, n_replicas=1, devices=[CPU] * 2)
        on_mesh = ShardedTopKSpMVIndex(port_csr(csr), cfg, mesh=mesh)
        xs = queries(np.random.default_rng(4), 3, False)
        assert_bits(per_shard.query(xs[0]), on_mesh.query(xs[0]))
        assert_bits(per_shard.query_batched(xs), on_mesh.query_batched(xs))
        jcfg = jtopk.TopKSpMVConfig(big_k=16, k=8, num_partitions=4, block_size=64)
        no_shard = DeviceMesh(np.array([CPU], dtype=object), ("data",))
        jno_shard = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
        for make, m, c in ((ShardedTopKSpMVIndex, no_shard, cfg), (JSharded, jno_shard, jcfg)):
            with pytest.raises(ValueError, match="serving mesh needs a 'shard' axis"):
                make(csr if make is JSharded else port_csr(csr), c, mesh=m)
        for make, m, c in ((ShardedTopKSpMVIndex, mesh, cfg),
                           (JSharded, jmesh_lib.make_serving_mesh(1, 1), jcfg)):
            with pytest.raises(ValueError, match="contradicts the mesh's shard axis"):
                make(csr if make is JSharded else port_csr(csr), c, mesh=m, n_shards=3)

    def test_evict_snapshot_repins(self):
        csr = gamma_csr(seed=2)
        cfg = tcfg(big_k=16, k=8, num_partitions=4, block_size=64)
        sharded = ShardedTopKSpMVIndex(port_csr(csr), cfg, n_shards=2)
        ex = ttopk.query_executor(cfg)
        x = queries(np.random.default_rng(0), 1, False)[0]
        want = sharded.query(x)
        copies = ex.h2d_copies
        uid = sharded.shards[0].packed.uid
        assert texecutor.evict_snapshot(uid) == 1
        assert texecutor.evict_snapshot(uid) == 0
        assert_bits(want, sharded.query(x))
        assert ex.h2d_copies > copies

    def test_executor_evict_drops_its_pins(self):
        csr = gamma_csr(seed=2)
        cfg = tcfg(big_k=16, k=8, num_partitions=4, block_size=64)
        sharded = ShardedTopKSpMVIndex(port_csr(csr), cfg, n_shards=2)
        ex = ttopk.query_executor(cfg)
        x = queries(np.random.default_rng(0), 1, False)[0]
        want = sharded.query(x)
        uid = sharded.shards[0].packed.uid
        assert any(pin[0] == uid for pin in ex._pinned)
        assert ex.evict_snapshot(uid) == 1
        assert not any(pin[0] == uid for pin in ex._pinned)
        assert_bits(want, sharded.query(x))
        assert any(pin[0] == uid for pin in ex._pinned)


# ---------------------------------------------------------------------------
# Mixed precision
# ---------------------------------------------------------------------------

class TestMixedPrecisionSharding:
    KW = dict(big_k=16, k=8, num_partitions=8, block_size=64, recall_target=0.95)

    def test_shard_local_groups(self):
        csr = gamma_csr(n_rows=320, seed=12)
        sharded = ShardedTopKSpMVIndex(port_csr(csr), tcfg(**self.KW), n_shards=4)
        ref = JSharded(csr, jtopk.TopKSpMVConfig(**self.KW), n_shards=4)
        assert sharded.partition_formats == ref.partition_formats
        assert len(sharded.partition_formats) == 8
        agg = sharded.aggregate_stats()
        assert agg == ref.aggregate_stats()
        assert sum(agg["format_histogram"].values()) == 8
        assert sharded.predicted_recall == ref.predicted_recall
        for sh in sharded.shards:
            assert sh.packed.groups is not None
        xs = queries(np.random.default_rng(2), 4, False)
        got = sharded.query_batched(xs)
        assert got[0].shape == (4, 16)
        assert_close_rows(ref.query_batched(jnp.asarray(xs), use_kernel=False), got)

    def test_f32_twins_match_native(self):
        csr = gamma_csr(n_rows=320, seed=12)
        native = ShardedTopKSpMVIndex(port_csr(csr), tcfg(**self.KW), n_shards=4,
                                      native_groups=True)
        twins = ShardedTopKSpMVIndex(port_csr(csr), tcfg(**self.KW), n_shards=4,
                                     native_groups=False)
        xs = queries(np.random.default_rng(3), 5, False)
        assert_bits(native.query(xs[0]), twins.query(xs[0]))
        assert_bits(native.query_batched(xs), twins.query_batched(xs))
        rng = np.random.default_rng(4)
        batch = sparse_rows(rng, 6)
        assert native.add_rows(batch) == twins.add_rows(batch)
        native.delete_rows([1, 200])
        twins.delete_rows([1, 200])
        assert_bits(native.query_batched(xs), twins.query_batched(xs))
        y = torch.zeros(native.n_rows_total)
        x = torch.from_numpy(queries(rng, 1, False)[0])
        np.testing.assert_array_equal(
            native.spmv(x, 1.0, 0.0, y).numpy().view(np.int32),
            twins.spmv(x, 1.0, 0.0, y).numpy().view(np.int32))
        ex = ttopk.query_executor(native._local_config)
        pins = {key[1] for key in texecutor._DEVICE_CACHE
                if key[0] in {sh.packed.uid for sh in twins.shards}}
        assert pins == {"split-fused"}
        assert ex.cache_info()["device_snapshots"] >= 8


# ---------------------------------------------------------------------------
# Failover (tests/test_fault_injection.py::TestShardFailover)
# ---------------------------------------------------------------------------

class TestShardFailover:
    @staticmethod
    def pair():
        csr = jbscsr.synthetic_embedding_csr(240, N_COLS, 8, "gamma", seed=5)
        kw = dict(big_k=8, k=32, num_partitions=4, block_size=32)
        return (ShardedTopKSpMVIndex(port_csr(csr), tcfg(**kw), n_shards=2),
                JSharded(csr, jtopk.TopKSpMVConfig(**kw), n_shards=2))

    @pytest.mark.parametrize("use_kernel", [False, True])
    def test_degraded_serving_and_recovery(self, use_kernel):
        sharded, ref = self.pair()
        rng = np.random.default_rng(3)
        x = rng.standard_normal(N_COLS).astype(np.float32)
        v_full, r_full = to_np(sharded.query(x, use_kernel=use_kernel))
        with tfaults.FaultPlan({"dispatch.shard": 0}) as plan:
            degraded = to_np(sharded.query(x, use_kernel=use_kernel))
        with jfaults.FaultPlan({"dispatch.shard": 0}):
            ref_degraded = ref.query(jnp.asarray(x), use_kernel=False)
        assert plan.fired == [("dispatch.shard", 0)]
        assert_close_rows(ref_degraded, degraded)
        assert sharded.last_query_degraded
        assert sharded.dead_shards == (0,) == ref.dead_shards
        assert sharded.live_shard_fraction == 0.5
        assert sharded.failovers == 1
        assert "FaultInjected" in sharded.shard_errors[0]
        # The degraded answer is exactly the survivors' rows, in order.
        shard1 = set(sharded._l2g[1])
        expect = [g for g in r_full if g in shard1]
        got = [int(g) for g in degraded[1] if g < sharded.n_rows_total]
        n = min(len(expect), len(got))
        assert n > 0 and got[:n] == expect[:n]
        info = sharded.dispatch_info()
        assert info["health"]["dead_shards"] == [0]
        assert info["health"] == ref.dispatch_info()["health"]
        with pytest.raises(RuntimeError, match="needs every shard"):
            sharded.spmv(np.zeros(N_COLS, np.float32), 1.0, 0.0,
                         np.zeros(sharded.n_rows_total, np.float32))
        # Mutations keep applying to the dead shard's host copy.
        rows = sparse_rows(rng, 3, nnz=6)
        ids = sharded.add_rows(rows)
        assert ids == ref.add_rows(rows)
        sharded.recover_shard(0)
        assert sharded.live_shard_fraction == 1.0
        assert not sharded.dispatch_info()["health"]["last_query_degraded"]
        _, r_rec = to_np(sharded.query(x, use_kernel=use_kernel))
        assert set(int(g) for g in r_rec) <= set(sharded._live)
        sharded.delete_rows(ids)                 # pre-failure answers come back
        assert_bits((v_full, r_full), sharded.query(x, use_kernel=use_kernel))

    def test_all_shards_dead_raises(self):
        sharded, _ = self.pair()
        x = np.ones(N_COLS, np.float32)
        with tfaults.FaultPlan({"dispatch.shard": 0}):
            sharded.query(x)
        with tfaults.FaultPlan({"dispatch.shard": 0}):
            with pytest.raises(RuntimeError, match="all shards failed") as err:
                sharded.query_batched(x[None])
        assert isinstance(err.value.__cause__, tfaults.FaultInjected)
        sharded.recover_shard(0)
        sharded.recover_shard(1)
        assert sharded.query(x)[0].shape == (8,)

    @pytest.mark.parametrize("batched, shape", [
        (False, (N_COLS - 1,)), (False, (2, N_COLS)), (False, (0,)),
        (True, (2, N_COLS - 1)), (True, (N_COLS,)), (True, (0, N_COLS)),
    ])
    def test_malformed_query_kills_no_shard(self, batched, shape):
        sharded, _ = self.pair()
        x = np.ones(shape, np.float32)
        with pytest.raises(ValueError, match="must be a non-empty"):
            (sharded.query_batched if batched else sharded.query)(x)
        assert sharded.dead_shards == () and sharded.failovers == 0
        assert not sharded.last_query_degraded
        assert sharded.query(np.ones(N_COLS, np.float32))[0].shape == (8,)

    def test_recover_shard_validates_index(self):
        sharded, _ = self.pair()
        with pytest.raises(ValueError, match="out of range"):
            sharded.recover_shard(7)


# ---------------------------------------------------------------------------
# Sharded accumulate: spmv, PPR, eigen, graph ranking
# ---------------------------------------------------------------------------

def graph_pair(kind, n, seed, n_shards, num_partitions=4):
    csr = tgraph.synthetic_graph_csr(kind, n, seed=seed)
    cfg = tcfg(k=8, num_partitions=num_partitions)
    return (csr, ttopk.MutableTopKSpMVIndex(csr, cfg),
            ShardedTopKSpMVIndex(csr, cfg, n_shards=n_shards))


def mutate(index, csr):
    seg = csr.row_slice(7, 8)
    index.replace_rows([7], [(seg.indices, (seg.data * 1.02).astype(np.float32))])
    index.delete_rows([11])


class TestShardedAccumulate:
    @pytest.mark.parametrize("use_kernel", [True, False])
    @pytest.mark.parametrize("n_shards", [2, 4])
    def test_spmv_equals_single_device(self, n_shards, use_kernel):
        csr, single, sharded = graph_pair("er", 96, 3, n_shards)
        ex = ttopk.query_executor(single.config)
        rng = np.random.default_rng(n_shards)
        path = "accumulate" if use_kernel else "accumulate_ref"
        for step in range(2):
            x = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
            y = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
            alpha, beta = torch.tensor(0.85), torch.tensor(0.15)
            want = ex.spmv(x, single.packed, alpha=alpha, beta=beta, y=y, path=path)
            got = sharded.spmv(x, alpha, beta, y, use_kernel=use_kernel, resident=True)
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          want.numpy().view(np.int32))
            mutate(single, csr)
            mutate(sharded, csr)

    def test_short_y_and_dead_shard_raise(self):
        _, _, sharded = graph_pair("ring", 64, 0, 2)
        x = np.ones(64, np.float32)
        with pytest.raises(ValueError, match="cover every id"):
            sharded.spmv(x, 1.0, 0.0, np.zeros(63, np.float32))
        with tfaults.FaultPlan({"dispatch.shard": 1}):
            sharded.query(x)
            sharded.query(x)
        assert sharded.dead_shards == (1,)
        with pytest.raises(RuntimeError, match="recover shards \\[1\\] first"):
            sharded.spmv(x, 1.0, 0.0, np.zeros(64, np.float32))
        sharded.recover_shard(1)
        assert sharded.spmv(x, 1.0, 0.0, np.zeros(64, np.float32)).shape == (64,)

    @pytest.mark.parametrize("kind,n,seed", [("ring", 80, 0), ("er", 96, 3)])
    def test_ppr_equals_single_device_and_reference(self, kind, n, seed):
        csr, single, sharded = graph_pair(kind, n, seed, 4)
        a = tgraph.personalized_pagerank(single, 5, tol=1e-5)
        b = tgraph.personalized_pagerank(sharded, 5, tol=1e-5)
        assert b.converged and b.canonical and b.retraces == 0
        np.testing.assert_array_equal(a.scores.view(np.int32), b.scores.view(np.int32))
        assert (a.iterations, a.refine_iterations) == (b.iterations, b.refine_iterations)
        ref = JSharded(jgraph.synthetic_graph_csr(kind, n, seed=seed),
                       jtopk.TopKSpMVConfig(k=8, num_partitions=4), n_shards=4)
        mutate(single, csr)
        mutate(sharded, csr)
        mutate(ref, csr)
        c = tgraph.personalized_pagerank(single, 5, tol=1e-5, warm_start=a.scores)
        d = tgraph.personalized_pagerank(sharded, 5, tol=1e-5, warm_start=b.scores)
        np.testing.assert_array_equal(c.scores.view(np.int32), d.scores.view(np.int32))
        assert c.iterations == d.iterations
        e = jgraph.personalized_pagerank(ref, 5, tol=1e-5, use_kernel=False)
        np.testing.assert_array_equal(np.asarray(e.scores).view(np.int32),
                                      d.scores.view(np.int32))

    def test_eigen_equals_single_device(self):
        csr = tgraph.synthetic_graph_csr("ba", 72, seed=7, symmetric=True)
        cfg = tcfg(k=8, num_partitions=4)
        single = ttopk.MutableTopKSpMVIndex(csr, cfg)
        sharded = ShardedTopKSpMVIndex(csr, cfg, n_shards=2)
        a = tgraph.topk_eigen(single, 2, tol=1e-5, max_iters=500)
        b = tgraph.topk_eigen(sharded, 2, tol=1e-5, max_iters=500)
        np.testing.assert_array_equal(a.values.view(np.int32), b.values.view(np.int32))
        np.testing.assert_array_equal(a.vectors.view(np.int32), b.vectors.view(np.int32))
        assert a.iterations == b.iterations and b.retraces == 0

    def test_graph_ranking_over_a_sharded_facade(self):
        csr = tgraph.synthetic_graph_csr("ring", 96, seed=1)
        cfg = tcfg(k=8, num_partitions=4)
        one = GraphRankingService(TIndex(csr, cfg).index)
        fac = TIndex(csr, cfg, n_shards=2)
        assert fac.is_sharded and fac.replica_factor == 1
        two = GraphRankingService(fac.index)
        for svc in (one, two):
            svc.rank([5, 17], top_k=10)
        seg = csr.row_slice(40, 41)
        emb = np.zeros(96, np.float32)
        emb[seg.indices] = seg.data * 1.02
        answers = []
        for svc in (one, two):
            svc.update_node(40, emb)             # replace_rows on global ids
            warm = svc.rank([5, 17], top_k=10)
            svc.forget([5, 17])
            cold = svc.rank([5, 17], top_k=10)
            assert warm.warm_started and not cold.warm_started
            answers.append((warm, cold))
        for a, b in zip(*answers):
            np.testing.assert_array_equal(a.node_ids, b.node_ids)
            np.testing.assert_array_equal(a.scores.view(np.int32), b.scores.view(np.int32))
            assert a.result.iterations == b.result.iterations
        assert one.info() == two.info()
        assert fac.index.n_rows_total == 96 and fac.index.deleted_rows == 0


# ---------------------------------------------------------------------------
# Facade, head, service
# ---------------------------------------------------------------------------

class TestFacade:
    def test_similarity_index_sharded(self):
        rng = np.random.default_rng(0)
        emb = rng.standard_normal((96, 40)).astype(np.float32)
        kw = dict(big_k=16, k=8, num_partitions=8)
        a = TIndex.from_dense(emb, nnz_per_row=8, config=tcfg(**kw))
        b = TIndex.from_dense(emb, nnz_per_row=8, config=tcfg(**kw), n_shards=4)
        j = JIndex.from_dense(emb, nnz_per_row=8, config=jtopk.TopKSpMVConfig(**kw),
                              n_shards=4)
        assert b.is_sharded and not a.is_sharded and b.replica_factor == 1
        q = rng.standard_normal((3, 40)).astype(np.float32)
        assert_bits(a.query(q[0]), b.query(q[0]))
        assert_bits(a.query_batch(q), b.query_batch(q))
        new = rng.standard_normal((4, 40)).astype(np.float32)
        ids = b.upsert(new)
        np.testing.assert_array_equal(a.upsert(new), ids)
        np.testing.assert_array_equal(j.upsert(new), ids)
        for fac in (a, b, j):
            fac.delete([3])
            fac.upsert(new[:1], ids=[5])
        assert_bits(a.query_batch(q), b.query_batch(q))
        assert_close_rows(j.query_batch(q, use_kernel=False), b.query_batch(q))
        assert_bits(a.query_exact(q[1]), b.query_exact(q[1]))
        sa, sb, sj = (dataclasses.asdict(f.stats()) for f in (a, b, j))
        assert (sa["n_rows"], sa["nnz"], sa["deleted_rows"]) == (
            sb["n_rows"], sb["nnz"], sb["deleted_rows"])
        assert sb == sj
        info = b.dispatch_info()
        assert info["topology"]["n_shards"] == 4 and info["path"] == "per_shard"
        b.compact()
        a.compact()
        assert_bits(a.query_batch(q), b.query_batch(q))

    def test_facade_mesh_raises(self):
        """The facade on a 2 x 2 mesh (ported since) == the unsharded facade
        bit for bit, through an upsert and a delete; its replica factor is
        the mesh's replica count."""
        rng = np.random.default_rng(1)
        emb = rng.standard_normal((32, 40)).astype(np.float32)
        cfg = tcfg(num_partitions=4, big_k=8)
        a = TIndex.from_dense(emb, nnz_per_row=8, config=cfg)
        b = TIndex.from_dense(emb, nnz_per_row=8, config=cfg,
                              mesh=make_serving_mesh(2, 2, devices=[CPU] * 4))
        assert b.replica_factor == 2 and b.dispatch_info()["path"] == "spmd"
        q = rng.standard_normal((3, 40)).astype(np.float32)
        assert_bits(a.query_batch(q), b.query_batch(q))
        new = rng.standard_normal((2, 40)).astype(np.float32)
        assert np.array_equal(a.upsert(new), b.upsert(new))
        a.delete([3])
        b.delete([3])
        assert_bits(a.query_batch(q), b.query_batch(q))
        assert_bits(a.query(q[0]), b.query(q[0]))

    @pytest.mark.parametrize("n_shards", [2, 4])
    def test_topk_head_sharded(self, n_shards):
        rng = np.random.default_rng(1)
        emb = rng.standard_normal((64, 40)).astype(np.float32)
        kw = dict(big_k=16, k=4, num_partitions=8, nnz_per_row=8)
        h1 = ApproxTopKHead(emb, TopKHeadConfig(device="cpu", **kw))
        h2 = ApproxTopKHead(emb, TopKHeadConfig(device="cpu", n_shards=n_shards, **kw))
        jh = JHead(emb, JHeadConfig(**kw))
        hs = rng.standard_normal((5, 40)).astype(np.float32)
        assert_bits(h1.topk_logits(hs[0], use_kernel=False),
                    h2.topk_logits(hs[0], use_kernel=False))
        assert_bits(h1.topk_logits(hs[0]), h2.topk_logits(hs[0]))
        assert_bits(h1.topk_logits_batch(hs), h2.topk_logits_batch(hs))
        assert_close_rows(jh.topk_logits(hs[0]), h1.topk_logits(hs[0], use_kernel=False))
        assert_close_rows(jh.topk_logits(hs[0]), h1.topk_logits(hs[0]))
        assert_close_rows(jh.topk_logits_batch(hs, use_kernel=False),
                          h2.topk_logits_batch(hs))
        assert_bits(jh.exact_topk_logits(hs[1]), h2.exact_topk_logits(hs[1]))
        assert h2.partition_precision == jh.partition_precision
        assert h2.overlap_at_k(hs[2]) == jh.overlap_at_k(hs[2])
        assert h2.dispatch_info()["path"] == "per_shard"
        assert "fn_builds" in h1.dispatch_info()

    def test_topk_head_defaults_and_mesh(self):
        assert dataclasses.asdict(TopKHeadConfig()) == dict(
            dataclasses.asdict(JHeadConfig()), device="cuda")
        rng = np.random.default_rng(2)
        emb = rng.standard_normal((64, 40)).astype(np.float32)
        kw = dict(big_k=16, k=4, num_partitions=8, nnz_per_row=8, device="cpu")
        plain = ApproxTopKHead(emb, TopKHeadConfig(**kw))
        meshed = ApproxTopKHead(emb, TopKHeadConfig(
            mesh=make_serving_mesh(4, 2, devices=[CPU] * 8), **kw))
        hs = rng.standard_normal((5, 40)).astype(np.float32)
        assert_bits(plain.topk_logits_batch(hs), meshed.topk_logits_batch(hs))
        assert_bits(plain.topk_logits(hs[0]), meshed.topk_logits(hs[0]))
        assert meshed.dispatch_info()["path"] == "spmd"

    def test_topk_head_decodes_through_the_kernel_by_default(self, monkeypatch):
        """Unlike the reference (whose kernel runs interpreted off the TPU),
        the port's single-query decode and ``overlap_at_k`` take the kernel
        path unless the caller asks for the plain walk."""
        head_mod = importlib.import_module("repro_torch.serve.topk_head")
        seen = []

        def spy(index, x, use_kernel):
            seen.append(use_kernel)
            return ttopk.topk_spmv(index, x, use_kernel=use_kernel)

        monkeypatch.setattr(head_mod, "run_topk_spmv", spy)
        rng = np.random.default_rng(6)
        emb = rng.standard_normal((64, 40)).astype(np.float32)
        head = ApproxTopKHead(emb, TopKHeadConfig(device="cpu", big_k=16, k=4,
                                                  num_partitions=8, nnz_per_row=8))
        h = rng.standard_normal(40).astype(np.float32)
        head.topk_logits(h)
        head.overlap_at_k(h)
        head.topk_logits(h, use_kernel=False)
        assert seen == [True, True, False]


class TestServiceOverShards:
    def test_store_with_a_sharded_facade_raises(self, tmp_path):
        emb = np.random.default_rng(3).standard_normal((64, 40)).astype(np.float32)
        fac = TIndex.from_dense(emb, nnz_per_row=8, config=tcfg(num_partitions=4),
                                n_shards=2)
        with pytest.raises(ValueError, match="single-device"):
            StreamingSimilarityService(fac, store=DurableIndexStore(tmp_path, device="cpu"))

    def test_frontend_serves_the_shards(self):
        rng = np.random.default_rng(4)
        emb = rng.standard_normal((64, 40)).astype(np.float32)
        fac = TIndex.from_dense(emb, nnz_per_row=8, config=tcfg(big_k=8, num_partitions=4),
                                n_shards=2)
        svc = StreamingSimilarityService(fac, frontend=FrontendConfig(adaptive=False, target_batch=4))
        try:
            assert svc.frontend.replica_factor == 1
            xs = rng.standard_normal((4, 40)).astype(np.float32)
            futures = [svc.submit(x) for x in xs]
            svc.flush()
            got = [f.result(timeout=30) for f in futures]
        finally:
            svc.close()
        want = fac.query_batch(xs)
        for i, (v, r) in enumerate(got):
            assert_bits((want[0][i], want[1][i]), (v, r))
