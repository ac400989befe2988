"""The port's mutable index against the reference's, on the CPU.

The same build and the same sequence of mutations (append, replace,
delete, resurrect, compact, serial and in a thread pool) go through both
packages' ``SparseEmbeddingIndex`` facades, made from a seed with numpy.
After every step the snapshots must be byte-identical, the counters and
``stats()`` equal, and the answers equal (values within 1e-5, row ids equal
outside near-ties; deleted ids never returned).  ``churn_stable`` and
``cow_snapshots`` are covered on and off.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import bscsr as jbscsr
from repro.core.similarity import SparseEmbeddingIndex as JaxIndex
from repro.kernels import ops as jops
from repro_torch.convert import packed_from_arrays
from repro_torch.core import bscsr as tbscsr
from repro_torch.core import topk_spmv as ttopk
from repro_torch.core.similarity import SparseEmbeddingIndex as TorchIndex
from repro_torch.kernels import ops as tops

jtopk = importlib.import_module("repro.core.topk_spmv")

N_COLS = 48
TOL = 1e-5
INNER_LOOPS = ("linear", "legacy", "linear-seg", "linear-topk")
SNAPSHOT_ARRAYS = ("vals", "cols", "flags", "words", "slot_to_row", "num_slots",
                   "tombstones")
SNAPSHOT_COUNTS = ("n_rows_total", "base_packets", "delta_nnz", "dead_nnz",
                   "tombstone_count", "nnz", "max_slots")
INDEX_COUNTERS = ("version", "last_refresh_repadded", "last_refresh_copied",
                  "snapshot_buffers", "n_rows", "n_rows_total", "deleted_rows",
                  "last_compact_parallel")


def as_bytes(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def port_csr(csr) -> tbscsr.CSRMatrix:
    return tbscsr.CSRMatrix(csr.indptr, csr.indices, csr.data, csr.shape)


def assert_close_rows(a, b, tol=TOL):
    """Values within tol; row ids equal except inside a near-tie of scores."""
    a = tuple(np.asarray(t) for t in a)
    b = tuple(np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t) for t in b)
    np.testing.assert_allclose(a[0], b[0], rtol=tol, atol=tol)
    va = a[0].reshape(-1, a[0].shape[-1])
    for i, j in zip(*np.nonzero(a[1].reshape(va.shape) != b[1].reshape(va.shape))):
        gaps = np.abs(va[i] - va[i, j])
        gaps[j] = np.inf
        assert gaps.min() <= 2 * tol, f"row ids differ outside a tie at {(i, j)}"


def assert_same_state(j, t):
    jp, tp = j.index.packed, t.index.packed
    for name in SNAPSHOT_ARRAYS:
        a, b = getattr(jp, name), getattr(tp, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert as_bytes(a) == as_bytes(b), name
    for name in SNAPSHOT_COUNTS:
        assert getattr(jp, name) == getattr(tp, name), name
    assert jp.signature_info() == tp.signature_info()
    for name in INDEX_COUNTERS:
        assert getattr(j.index, name) == getattr(t.index, name), name
    assert dataclasses.asdict(j.stats()) == dataclasses.asdict(t.stats())


def facades(emb, **cfg):
    kw = dict(big_k=8, k=8, num_partitions=3, block_size=32, value_format="BF16",
              **cfg)
    j = JaxIndex.from_dense(emb, nnz_per_row=10, config=jtopk.TopKSpMVConfig(**kw))
    t = TorchIndex.from_dense(emb, nnz_per_row=10,
                              config=ttopk.TopKSpMVConfig(device="cpu", **kw))
    return j, t


MUTATIONS = [
    ("append", lambda s, e: s.upsert(e[:5])),
    ("replace", lambda s, e: s.upsert(e[5:8], ids=[3, 50, 121])),
    ("delete", lambda s, e: s.delete([7, 60, 122, 60])),
    ("resurrect", lambda s, e: s.upsert(e[8:9], ids=[7])),
    ("compact", lambda s, e: s.compact()),
    ("append after compact", lambda s, e: s.upsert(e[9:12])),
    ("delete after compact", lambda s, e: s.delete([0, 1])),
]


@pytest.mark.parametrize("churn_stable,cow,min_nnz", [
    (True, True, 0), (True, False, 100_000), (False, True, 100_000), (False, False, 0),
])
def test_mutation_sequence_matches_the_reference(churn_stable, cow, min_nnz):
    rng = np.random.default_rng(30)
    emb = rng.standard_normal((120, N_COLS)).astype(np.float32)
    new = rng.standard_normal((12, N_COLS)).astype(np.float32)
    xs = rng.standard_normal((4, N_COLS)).astype(np.float32)
    j, t = facades(emb, churn_stable=churn_stable, cow_snapshots=cow,
                   parallel_compaction_min_nnz=min_nnz)
    assert_same_state(j, t)
    deleted = set()
    for name, mutate in MUTATIONS:
        ja, ta = mutate(j, new), mutate(t, new)
        if ja is not None:
            np.testing.assert_array_equal(ja, ta)
        if name.startswith("delete"):
            deleted |= {0, 1} if "compact" in name else {7, 60, 122}
        if name == "resurrect":
            deleted.discard(7)
        assert_same_state(j, t)
        want = j.query_batch(xs, use_kernel=False)
        for use_kernel in (True, False):
            got = t.query_batch(xs, use_kernel=use_kernel)
            assert_close_rows(want, got)
            assert not deleted & set(got[1].reshape(-1).tolist()), name
        np.testing.assert_array_equal(j.query_exact(xs[0])[1], t.query_exact(xs[0])[1])
    assert t.index.last_compact_parallel == (min_nnz == 0)


def test_live_csr_matches_the_reference():
    rng = np.random.default_rng(31)
    j, t = facades(rng.standard_normal((130, N_COLS)).astype(np.float32))
    new = rng.standard_normal((12, N_COLS)).astype(np.float32)
    for _, mutate in MUTATIONS[:4]:
        mutate(j, new)
        mutate(t, new)
    (jc, jg), (tc, tg) = j.index.live_csr(), t.index.live_csr()
    for name in ("indptr", "indices", "data"):
        assert as_bytes(getattr(jc, name)) == as_bytes(getattr(tc, name))
    np.testing.assert_array_equal(jg, tg)
    assert t.index.live_csr()[0] is tc           # cached per version


class TestChurnStable:
    """Padded slot budgets never let a phantom zero-score slot displace a real
    negative score: all-negative collections, bit-identical to unpadded."""

    @staticmethod
    def arms(mutable_cls, config_cls, **cfg_kw):
        base = jbscsr.synthetic_embedding_csr(60, 32, 6, "gamma", 21, normalize=False)
        csr = jbscsr.CSRMatrix(base.indptr, base.indices,
                               (-np.abs(base.data) - 0.01).astype(np.float32),
                               base.shape)
        arms = []
        for stable in (True, False):
            cfg = config_cls(big_k=8, k=8, num_partitions=2, block_size=32,
                             churn_stable=stable, **cfg_kw)
            index = mutable_cls(csr if config_cls is jtopk.TopKSpMVConfig
                                else port_csr(csr), cfg)
            r = np.random.default_rng(22)
            index.add_rows([(np.arange(5, dtype=np.int32),
                             -np.abs(r.standard_normal(5)).astype(np.float32) - 0.01)
                            for _ in range(2)])
            index.replace_rows([4], [(np.arange(4, dtype=np.int32),
                                      -np.abs(r.standard_normal(4)).astype(np.float32)
                                      - 0.01)])
            index.delete_rows([9])
            arms.append(index)
        info = arms[0].packed.signature_info()
        assert info["slot_bucket"] > info["slots_live"]
        assert info["tombstone_bucket"] > info["rows_live"]
        return arms

    @pytest.mark.parametrize("layout", ["split", "fused"])
    def test_negative_scores_padded_equals_unpadded(self, layout):
        padded, exact = self.arms(ttopk.MutableTopKSpMVIndex, ttopk.TopKSpMVConfig,
                                  device="cpu", stream_layout=layout)
        jpadded, _ = self.arms(jtopk.MutableTopKSpMVIndex, jtopk.TopKSpMVConfig,
                               stream_layout=layout)
        assert as_bytes(jpadded.packed.fused_words()) == \
            as_bytes(padded.packed.fused_words())
        x = np.abs(np.random.default_rng(22).standard_normal(32)).astype(np.float32) + 0.1
        xs = np.stack([x, x[::-1].copy()])
        want = jops.topk_spmv_blocked(jnp.asarray(x), jpadded.packed, 8, k=8,
                                      stream_layout=layout)
        for loop in INNER_LOOPS:
            got = tops.topk_spmv_blocked(x, padded.packed, 8, k=8, inner_loop=loop,
                                         device="cpu")
            ref = tops.topk_spmv_blocked(x, exact.packed, 8, k=8, inner_loop=loop,
                                         device="cpu")
            assert float(ref[0][0]) < 0
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
            assert_close_rows(want, got)         # random values: summation order
        got = tops.topk_spmv_batched(xs, padded.packed, 8, k=8, device="cpu")
        ref = tops.topk_spmv_batched(xs, exact.packed, 8, k=8, device="cpu")
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), b.numpy())

    def test_zero_retraces_after_the_first_mutation(self):
        rng = np.random.default_rng(40)
        emb = rng.standard_normal((100, N_COLS)).astype(np.float32)
        j, t = facades(emb, packets_per_step=1)
        x = rng.standard_normal(N_COLS).astype(np.float32)
        ups = rng.standard_normal((6, N_COLS)).astype(np.float32)
        counts = []
        for svc in (j, t):
            svc.query(x)
            before = svc.dispatch_info()["retraces"]
            trace = []
            for i in range(6):
                svc.upsert(ups[i:i + 1])
                if i == 2:
                    svc.delete([i])
                svc.query(x)
                trace.append(svc.dispatch_info()["retraces"] - before)
            counts.append(trace)
        assert counts[1] == [1] * 6              # one retrace, at the first mutation
        assert counts[0] == counts[1]
        info = t.dispatch_info()
        assert info["churn_stable"] is True
        assert info["signature"] == j.dispatch_info()["signature"]


def test_mutated_reference_snapshot_carried_across():
    """A reference snapshot after delete + upsert rebuilds in the port with
    the same churn counters and stats inputs, and answers the same."""
    rng = np.random.default_rng(50)
    j, _ = facades(rng.standard_normal((90, N_COLS)).astype(np.float32))
    j.delete([4, 5, 40])
    j.upsert(rng.standard_normal((3, N_COLS)).astype(np.float32), ids=[10, 11, 4])
    jp = j.index.packed
    fields = {name: getattr(jp, name) for name in (
        "vals", "cols", "flags", "words", "n_cols", "nnz", "block_size",
        "stream_layout", "slot_to_row", "num_slots", "n_rows_total", "tombstones",
        "base_packets", "delta_nnz", "dead_nnz", "tombstone_count")}
    fields["plan"] = dataclasses.asdict(jp.plan)
    fields["value_format"] = jp.value_format.name
    packed = packed_from_arrays(fields)
    for name in ("delta_fraction", "tombstone_count", "bytes_per_nnz", "stream_bytes",
                 "value_bytes_per_nnz", "nnz", "base_packets", "dead_nnz",
                 "is_segmented"):
        assert getattr(packed, name) == getattr(jp, name), name
    assert packed.delta_fraction > 0 and packed.tombstone_count == 5
    assert packed.format_histogram() == jp.format_histogram()
    xs = rng.standard_normal((3, N_COLS)).astype(np.float32)
    want = j.query_batch(xs, use_kernel=False)
    got = tops.topk_spmv_batched(xs, packed, big_k=8, k=8, device="cpu")
    assert_close_rows(want, got)
    assert not {5, 40} & set(got[1].reshape(-1).tolist())


def test_validation_matches_the_reference():
    rng = np.random.default_rng(60)
    j, t = facades(rng.standard_normal((30, N_COLS)).astype(np.float32))
    for svc in (j, t):
        with pytest.raises(KeyError, match="never assigned"):
            svc.delete([30])
        with pytest.raises(ValueError, match="duplicate"):
            svc.upsert(np.ones((2, N_COLS), np.float32), ids=[1, 1])
        with pytest.raises(ValueError, match="width"):
            svc.upsert(np.ones((1, N_COLS + 1), np.float32))
        with pytest.raises(ValueError, match="non-finite"):
            svc.upsert(np.full((1, N_COLS), np.nan, np.float32))
    assert t.index.version == j.index.version == 0
