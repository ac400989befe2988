"""The port's mixed precision against the reference's, on the CPU.

Per-partition value formats (``core/adaptive.py``), the tagged width-class
streams (``ops.StreamGroup``: TAG4, TAG2, TAG1), their grouped dispatch and
the mutable index's three planes go through both packages on the same
inputs, made from a seed with numpy, on the reference's own fixture
(``hot_cold_csr``, C = 4, B = 32, k = 8, as in
``tests/test_mixed_precision.py``).  Host encodings, plans and calibrations
must be byte-identical; the grouped single, batched and accumulate paths
must give the reference's (Pallas interpret) results bit for bit on dyadic
data and within 1e-5 (row ids equal outside near-ties) on random data; and
within the port the grouped tagged dispatch must give the bits of the same
snapshot's f32 twins streamed as one uniform F32 stream.
"""
import dataclasses
import gc
import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import adaptive as jadaptive
from repro.core import bscsr as jbscsr
from repro.core import precision_model as jprecision
from repro.core.similarity import SparseEmbeddingIndex as JaxIndex
from repro.kernels import ops as jops
from repro_torch.core import adaptive as tadaptive
from repro_torch.core import bscsr as tbscsr
from repro_torch.core import precision_model as tprecision
from repro_torch.core import topk_spmv as ttopk
from repro_torch.core.quantization import FORMAT_BY_CODE, FORMATS
from repro_torch.core.similarity import SparseEmbeddingIndex as TorchIndex
from repro_torch.kernels import bscsr_topk_spmv as tkern
from repro_torch.kernels import executor as texec
from repro_torch.kernels import ops as tops

jtopk = importlib.import_module("repro.core.topk_spmv")

C = 4
BLOCK = 32
K = 8
N_COLS = 64
TOL = 1e-5
INNER_LOOPS = ("linear", "legacy", "linear-seg", "linear-topk")
# Every width class, and TAG2 with both of its members.
MIXED = ("F32", "BF16", "Q15", "Q7")


def hot_cold_csr(n_rows=256, n_cols=N_COLS, mean_nnz=8, seed=0, hot_rows=64,
                 cold_scale=0.1):
    """The reference's fixture: partition 0 at full magnitude, the rest scaled."""
    csr = jbscsr.synthetic_embedding_csr(n_rows, n_cols, mean_nnz, "gamma", seed)
    scales = np.ones(n_rows, np.float32)
    scales[hot_rows:] = cold_scale
    return jbscsr.scale_rows(csr, scales)


def dyadic(csr, seed=1):
    """The same structure with values k/128, exact in every format."""
    rng = np.random.default_rng(seed)
    data = (rng.integers(-128, 128, size=csr.nnz) / 128.0).astype(np.float32)
    return dataclasses.replace(csr, data=data)


def queries(q, seed, exact):
    rng = np.random.default_rng(seed)
    if exact:
        return (rng.integers(-8, 9, size=(q, N_COLS)) / 8.0).astype(np.float32)
    return rng.standard_normal((q, N_COLS)).astype(np.float32)


def port_csr(csr) -> tbscsr.CSRMatrix:
    return tbscsr.CSRMatrix(csr.indptr, csr.indices, csr.data, csr.shape)


def as_bytes(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def packs(csr, formats, layout="fused"):
    kw = dict(packets_multiple=2, stream_layout=layout, value_formats=formats)
    return (jops.pack_partitions(csr, C, BLOCK, **kw),
            tops.pack_partitions(port_csr(csr), C, BLOCK, **kw))


def assert_bitwise(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y)
        assert x.shape == y.shape and x.dtype.itemsize == y.dtype.itemsize
        assert as_bytes(x) == as_bytes(y)


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


def assert_same_packed(jp, tp):
    """Two snapshots byte-identical, groups and twins included."""
    for name in ("vals", "cols", "flags", "words", "fmt_codes", "slot_to_row",
                 "num_slots", "tombstones"):
        a, b = getattr(jp, name), getattr(tp, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert as_bytes(a) == as_bytes(b), name
    assert (jp.groups is None) == (tp.groups is None)
    for jg, tg in zip(jp.groups or (), tp.groups or ()):
        assert (jg.class_name, jg.cores, jg.block_size) == (tg.class_name, tg.cores,
                                                             tg.block_size)
        assert jg.words.shape == tg.words.shape and as_bytes(jg.words) == as_bytes(tg.words)
    for name in ("stream_bytes", "value_stream_bytes", "bytes_per_nnz",
                 "value_bytes_per_nnz", "fmt_signature", "is_heterogeneous", "nnz",
                 "max_slots"):
        assert getattr(jp, name) == getattr(tp, name), name
    assert jp.format_histogram() == tp.format_histogram()
    assert jp.signature_info() == tp.signature_info()


# ---------------------------------------------------------------------------
# Host plane: copied helpers, calibration, plans, groups
# ---------------------------------------------------------------------------

class TestHostPlane:
    @pytest.mark.parametrize("fmt", list(FORMATS))
    def test_bscsr_helpers_byte_equal(self, fmt):
        csr = hot_cold_csr(seed=2)
        j = jbscsr.encode_bscsr(csr, BLOCK, fmt)
        t = tbscsr.encode_bscsr(port_csr(csr), BLOCK, fmt)
        jd, td = jbscsr.dequantize_stream(j), tbscsr.dequantize_stream(t)
        assert jd.value_format.name == td.value_format.name == "F32"
        assert as_bytes(jd.vals) == as_bytes(td.vals)
        for other in FORMATS:
            jr = jbscsr.requantize_stream(j, FORMATS[other])
            tr = tbscsr.requantize_stream(t, FORMATS[other])
            assert jr.value_format.name == tr.value_format.name == other
            for name in ("vals", "cols", "flags"):
                assert as_bytes(getattr(jr, name)) == as_bytes(getattr(tr, name)), other
        assert (j.stream_bytes, j.bytes_per_nnz) == (t.stream_bytes, t.bytes_per_nnz)
        for n_cols in (64, 40_000):
            assert (jbscsr.stream_bytes_per_nnz(fmt, n_cols)
                    == tbscsr.stream_bytes_per_nnz(fmt, n_cols))
        scales = np.random.default_rng(3).random(csr.shape[0]).astype(np.float32)
        assert as_bytes(jbscsr.scale_rows(csr, scales).data) == as_bytes(
            tbscsr.scale_rows(port_csr(csr), scales).data)

    @pytest.mark.parametrize("chunk", [1, 37, 1 << 22])
    def test_chunked_batch_scores_byte_equal(self, chunk, monkeypatch):
        monkeypatch.setattr(tprecision, "SCORE_CHUNK_NNZ", chunk)
        rng = np.random.default_rng(4)
        lens = rng.integers(0, 12, size=300)
        lens[::7] = 0
        lens[5] = 150                      # one row longer than a chunk
        indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        indices = rng.integers(0, 200, size=int(indptr[-1])).astype(np.int32)
        data = rng.standard_normal(int(indptr[-1])).astype(np.float32)
        xs = rng.standard_normal((16, 200)).astype(np.float32)
        want = jprecision.csr_batch_scores(indptr, indices, data, xs)
        got = tprecision.csr_batch_scores(indptr, indices, data, xs)
        assert as_bytes(want) == as_bytes(got)

    @pytest.mark.parametrize("seed,target", [(6, 0.99), (12, 0.9), (4, 1.0), (16, 0.999)])
    def test_plans_and_calibrations_equal(self, seed, target):
        csr = hot_cold_csr(seed=seed, cold_scale=0.5 if seed == 16 else 0.1)
        jp, jc = jadaptive.assign_partition_formats(csr, C, target, k=K)
        tp, tc = tadaptive.assign_partition_formats(port_csr(csr), C, target, k=K)
        assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
        for name in ("queries", "thresholds", "losses"):
            assert as_bytes(getattr(jc, name)) == as_bytes(getattr(tc, name)), name
        assert (jc.k, jc.budget) == (tc.k, tc.budget)
        assert sorted(jc.quant_thresholds) == sorted(tc.quant_thresholds)
        for f, v in jc.quant_thresholds.items():
            assert as_bytes(v) == as_bytes(tc.quant_thresholds[f])
        # Promote-only refresh of a partition that took hot rows.
        part = hot_cold_csr(n_rows=40, seed=seed + 1, hot_rows=40)
        jf, jn = jadaptive.refresh_partition_formats(jp.formats, jc, {C - 1: part})
        tf, tn = tadaptive.refresh_partition_formats(tp.formats, tc, {C - 1: port_csr(part)})
        assert (jf, jn) == (tf, tn)
        assert as_bytes(jc.losses) == as_bytes(tc.losses)
        # The uniform planner and its calibration.
        jv = jadaptive.calibrate_value_precision(csr, K, n_queries=4, seed=seed)
        tv = tadaptive.calibrate_value_precision(port_csr(csr), K, n_queries=4, seed=seed)
        assert {f: dataclasses.asdict(v) for f, v in jv.items()} == {
            f: dataclasses.asdict(v) for f, v in tv.items()}
        assert dataclasses.asdict(jadaptive.plan_for_target(
            10_000, N_COLS, 100, 0.9, value_precisions=jv)) == dataclasses.asdict(
            tadaptive.plan_for_target(10_000, N_COLS, 100, 0.9, value_precisions=tv))

    @pytest.mark.parametrize("layout", ["fused", "split"])
    @pytest.mark.parametrize("formats", [MIXED, ("Q7", "BF16", "Q7", "Q15"), "plan"])
    def test_stream_groups_byte_equal(self, layout, formats):
        csr = hot_cold_csr(seed=6)
        if formats == "plan":
            formats = jadaptive.assign_partition_formats(csr, C, 0.99, k=K)[0].formats
        jp, tp = packs(csr, formats, layout)
        assert tp.is_heterogeneous and len(tp.groups) == len({
            {"F32": 4, "BF16": 2, "Q15": 2, "Q7": 1}[f] for f in formats})
        assert_same_packed(jp, tp)
        with pytest.raises(ValueError, match="no single fused array"):
            tp.fused_words()
        native = [tbscsr.encode_bscsr(p, BLOCK, FORMATS[f]) for p, f in zip(
            tbscsr_partitions(port_csr(csr)), formats)]
        pad = {"TAG1": 40, "TAG2": 14}
        jg = jops.build_stream_groups(
            [jbscsr.encode_bscsr(p, BLOCK, FORMATS[f].name) for p, f in zip(
                jbscsr_partitions(csr), formats)], pad_to=pad)
        tg = tops.build_stream_groups(native, pad_to=pad)
        assert [(g.class_name, g.cores, as_bytes(g.words)) for g in jg] == [
            (g.class_name, g.cores, as_bytes(g.words)) for g in tg]


def jbscsr_partitions(csr):
    from repro.core import partition as jpartition
    return jpartition.partition_csr(csr, jpartition.PartitionPlan.build(csr.shape[0], C))


def tbscsr_partitions(csr):
    from repro_torch.core import partition as tpartition
    return tpartition.partition_csr(csr, tpartition.PartitionPlan.build(csr.shape[0], C))


# ---------------------------------------------------------------------------
# The grouped kernel paths
# ---------------------------------------------------------------------------

class TestGroupedKernels:
    @pytest.mark.parametrize("data", ["dyadic", "random"])
    @pytest.mark.parametrize("loop", INNER_LOOPS)
    def test_grouped_paths_match_the_reference(self, loop, data):
        exact = data == "dyadic"
        csr = hot_cold_csr(seed=6)
        if exact:
            csr = dyadic(csr)
        jp, tp = packs(csr, MIXED)
        xs = queries(3, 7, exact)
        check = assert_bitwise if exact else assert_close_rows
        check(jops.topk_spmv_blocked(jnp.asarray(xs[0]), jp, 16, k=K, inner_loop=loop),
              tops.topk_spmv_blocked(xs[0], tp, 16, k=K, inner_loop=loop, device="cpu"))
        check(jops.topk_spmv_batched(jnp.asarray(xs), jp, 16, k=K, inner_loop=loop),
              tops.topk_spmv_batched(xs, tp, 16, k=K, inner_loop=loop, device="cpu"))
        want = np.asarray(jops.bscsr_spmv_blocked(jnp.asarray(xs[1]), jp, inner_loop=loop))
        got = tops.bscsr_spmv_blocked(xs[1], tp, inner_loop=loop, device="cpu").numpy()
        if exact:
            assert as_bytes(want) == as_bytes(got)
        else:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("formats", [MIXED, ("Q15", "BF16", "Q7", "BF16")])
    def test_grouped_equals_f32_twins_bitwise(self, formats):
        """Grouped tagged dispatch == the f32 twins as one F32 stream, per-call
        and through the executor, on random data (the same decoded values in
        the same scan order)."""
        _, tp = packs(hot_cold_csr(seed=8), formats)
        twins = dataclasses.replace(tp, stream_layout="split")
        assert tops.uses_groups(tp) and not tops.uses_groups(twins)
        xs = queries(5, 9, exact=False)
        kw = dict(k=K, device="cpu")
        assert_bitwise(tops.topk_spmv_blocked(xs[0], tp, 16, **kw),
                       tops.topk_spmv_blocked(xs[0], twins, 16, **kw))
        assert_bitwise(tops.topk_spmv_batched(xs, tp, 16, **kw),
                       tops.topk_spmv_batched(xs, twins, 16, **kw))
        assert_bitwise((tops.bscsr_spmv_blocked(xs[0], tp, device="cpu"),),
                       (tops.bscsr_spmv_blocked(xs[0], twins, device="cpu"),))
        ex = texec.QueryExecutor(big_k=16, k=K, device="cpu")
        assert_bitwise(ex.query(xs[0], tp), ex.query(xs[0], twins))
        assert_bitwise(ex.query_batched(xs, tp), ex.query_batched(xs, twins))
        y = torch.zeros(tp.n_rows_logical)
        assert_bitwise((ex.spmv(xs[0], tp, alpha=1.0, beta=0.0, y=y),),
                       (ex.spmv(xs[0], twins, alpha=1.0, beta=0.0, y=y),))
        info = ex.cache_info()
        assert info["device_snapshots"] == 2

    @pytest.mark.parametrize("splits", [1, 2, 5, 64])
    def test_tagged_split_table_equals_untagged(self, splits):
        _, tp = packs(hot_cold_csr(seed=10), MIXED)
        for g in tp.groups:
            words = torch.from_numpy(np.ascontiguousarray(g.words))
            tagged = tkern.spmv_split_table(words, packets_per_step=2, block_size=BLOCK,
                                            splits=splits, header=1)
            plain = tkern.spmv_split_table(words[..., 1:].contiguous(), packets_per_step=2,
                                           block_size=BLOCK, splits=splits)
            for a, b in zip(tagged, plain):
                assert torch.equal(a, b), g.class_name

    def test_per_step_tag_read_equals_per_core_read(self):
        """The plain walk reads the tag of each step's first packet, as the
        reference does; the CUDA walk reads each core's first header once.
        On a TAG2 buffer whose tail rows hold header 0 both give the bits of
        each core decoded as its own format."""
        formats = ("BF16", "Q15", "Q15", "BF16")
        _, tp = packs(hot_cold_csr(seed=11), formats)
        (g,) = tp.groups
        assert g.class_name == "TAG2"
        tail = np.zeros((C, 4, g.words.shape[2]), np.int32)
        words = torch.from_numpy(np.concatenate([g.words, tail], 1))
        n_rows = tp.max_slots * 2
        xs = torch.from_numpy(queries(3, 12, exact=False))
        kw = dict(n_rows=n_rows, packets_per_step=2, block_size=BLOCK)

        def per_core(fn, **extra):
            outs = [fn(words[c : c + 1, :, 1:].contiguous(),
                       FORMAT_BY_CODE[int(words[c, 0, 0])].name, **extra) for c in range(C)]
            return tuple(torch.cat(parts) for parts in zip(*outs))

        assert_bitwise(
            tkern.bscsr_topk_spmv_plain(xs[0], words, k=K, fmt_name="TAG2", **kw),
            per_core(lambda w, f: tkern.bscsr_topk_spmv_plain(xs[0], w, k=K, fmt_name=f, **kw)))
        for splits in (None, 1, 3):
            assert_bitwise(
                tkern.bscsr_topk_spmv_multiquery_plain(xs, words, k=K, fmt_name="TAG2",
                                                       splits=splits, **kw),
                per_core(lambda w, f: tkern.bscsr_topk_spmv_multiquery_plain(
                    xs, w, k=K, fmt_name=f, splits=splits, **kw)))
            assert_bitwise(
                (tkern.bscsr_spmv_plain(xs[0], words, fmt_name="TAG2", splits=splits, **kw),),
                per_core(lambda w, f: (tkern.bscsr_spmv_plain(xs[0], w, fmt_name=f,
                                                              splits=splits, **kw),)))

    def test_tagged_wrappers_check_their_geometry(self):
        _, tp = packs(hot_cold_csr(seed=13), MIXED)
        words = {g.class_name: torch.from_numpy(g.words) for g in tp.groups}
        x = torch.zeros(N_COLS)
        with pytest.raises(ValueError, match="width"):   # a TAG2 stream read as TAG1
            tkern.bscsr_topk_spmv(x, words["TAG2"], k=2, n_rows=tp.max_slots,
                                  fmt_name="TAG1", block_size=BLOCK)
        with pytest.raises(ValueError, match="width"):   # untagged width as TAG4
            tkern.bscsr_spmv(x, words["TAG4"][..., 1:].contiguous(), n_rows=tp.max_slots,
                             fmt_name="TAG4", block_size=BLOCK)
        assert tkern.bscsr_topk_spmv.launches == tkern.bscsr_spmv.launches == 0


# ---------------------------------------------------------------------------
# Recall target, the mutable index and the executor signature
# ---------------------------------------------------------------------------

def mixed_config(pkg, **kw):
    base = dict(big_k=K, k=K, num_partitions=C, block_size=BLOCK, recall_target=0.99)
    if pkg is ttopk:
        base["device"] = "cpu"
    return pkg.TopKSpMVConfig(**{**base, **kw})


class TestRecallTarget:
    def test_build_index_meets_target_through_the_kernel(self):
        csr = hot_cold_csr(seed=9)
        j = jtopk.build_index(csr, mixed_config(jtopk))
        t = ttopk.build_index(port_csr(csr), mixed_config(ttopk))
        assert dataclasses.asdict(j.format_plan) == dataclasses.asdict(t.format_plan)
        assert_same_packed(j.packed, t.packed)
        xs = tadaptive.sample_calibration_queries(port_csr(csr), 16)
        _, rows = ttopk.topk_spmv_batched(t, xs)
        rec = []
        for i, x in enumerate(xs):
            _, exact = ttopk.topk_spmv_exact(port_csr(csr), x, K)
            rec.append(len(set(rows[i].tolist()) & set(exact.tolist())) / K)
        assert float(np.mean(rec)) >= 0.99
        assert ttopk.build_index(port_csr(csr), mixed_config(
            ttopk, recall_target=None)).format_plan is None


def assert_same_planes(j, t):
    """The mutable indexes' planes, formats, counters and snapshots equal."""
    ji, ti = j.index, t.index
    assert ji.partition_formats == ti.partition_formats
    assert ji.predicted_recall == ti.predicted_recall
    for name in ("last_refresh_promoted", "last_refresh_group_copied",
                 "total_group_copied", "last_refresh_copied", "version"):
        assert getattr(ji, name) == getattr(ti, name), name
    for plane in ("_exact", "_native", "_streams"):
        for a, b in zip(getattr(ji, plane), getattr(ti, plane)):
            assert a.value_format.name == b.value_format.name, plane
            for name in ("vals", "cols", "flags"):
                assert as_bytes(getattr(a, name)) == as_bytes(getattr(b, name)), plane
    assert_same_packed(ji.packed, ti.packed)
    assert dataclasses.asdict(j.stats()) == dataclasses.asdict(t.stats())


class TestMutableIndex:
    def test_three_planes_match_the_reference(self):
        """Benign cold upserts, deletes, hot upserts that force a promote-only
        refresh, then compact: the same planes and answers in both."""
        csr = hot_cold_csr(seed=14)
        j = JaxIndex(csr, mixed_config(jtopk, recall_target=None), recall_target=0.99)
        t = TorchIndex(port_csr(csr), mixed_config(ttopk, recall_target=None),
                       recall_target=0.99)
        rng = np.random.default_rng(15)
        xs = queries(4, 16, exact=False)
        assert_same_planes(j, t)
        cold = (0.05 * rng.standard_normal((6, N_COLS))).astype(np.float32)
        hot = (4.0 * rng.standard_normal((8, N_COLS))).astype(np.float32)
        # Single-value rows that Q7 saturates (3.0 -> 127/128): they enter
        # the calibration top-k exactly and drop out quantized, so the
        # refresh must promote the partition that takes them.
        spikes = [(np.array([c], np.int32), np.array([3.0], np.float32))
                  for c in (1, 9, 17, 33)]
        steps = [
            lambda f: f.upsert(cold),
            lambda f: f.delete([3, 70, 200]),
            lambda f: f.upsert(hot),
            lambda f: f.index.add_rows(spikes),
            lambda f: f.upsert(hot[:2], ids=[80, 81]),
            lambda f: f.compact(),
        ]
        promoted = 0
        for step in steps:
            step(j)
            step(t)
            assert_same_planes(j, t)
            promoted += t.index.last_refresh_promoted
            assert_close_rows(j.query_batch(xs), t.query_batch(xs))
            assert_close_rows(j.query(xs[0]), t.query(xs[0]))
        assert promoted > 0, "no step exercised a promotion"

    def test_reassignment_is_one_retrace(self):
        csr = port_csr(hot_cold_csr(seed=16))
        x = queries(1, 17, exact=False)[0]
        ex = texec.QueryExecutor(big_k=K, k=K, device="cpu")
        pack = lambda f: tops.pack_partitions(  # noqa: E731
            csr, C, BLOCK, packets_multiple=2, stream_layout="fused", value_formats=f)
        p1 = pack(("F32", "Q7", "Q7", "Q7"))
        ex.query(x, p1)
        builds = ex.fn_builds
        p1b = pack(("F32", "Q7", "Q7", "Q7"))
        ex.query(x, p1b)
        assert ex.fn_builds == builds and ex.retraces == 0
        del p1, p1b
        gc.collect()
        ex.query(x, pack(("BF16", "Q7", "Q7", "Q7")))
        assert ex.retraces == 1

    def test_zero_retraces_across_upsert_query_cycles(self):
        index = ttopk.MutableTopKSpMVIndex(port_csr(hot_cold_csr(seed=18)),
                                           mixed_config(ttopk))
        ex = texec.QueryExecutor(big_k=K, k=K, device="cpu")
        x = queries(2, 19, exact=False)
        rng = np.random.default_rng(20)

        def cold_rows(n=4):
            return [(np.arange(5, dtype=np.int32),
                     (0.05 * rng.standard_normal(5)).astype(np.float32)) for _ in range(n)]

        ex.query(x[0], index.packed)
        ex.query_batched(x, index.packed)
        index.add_rows(cold_rows())              # the one-time packet-cap jump
        ex.query(x[0], index.packed)
        ex.query_batched(x, index.packed)
        builds, retraces, copies = ex.fn_builds, ex.retraces, ex.h2d_copies
        fmts = index.partition_formats
        for _ in range(3):
            index.add_rows(cold_rows())
            assert index.last_refresh_promoted == 0
            ex.query(x[0], index.packed)
            ex.query_batched(x, index.packed)
        assert index.partition_formats == fmts
        assert (ex.fn_builds, ex.retraces) == (builds, retraces)
        assert ex.h2d_copies > copies            # each new snapshot pins once
