"""The port's host encode plane, byte for byte against the reference.

``repro_torch`` keeps its own copies of the numpy host code (it may not
import ``repro``); these tests pin every copy to its original on the same
inputs, made from a seed with numpy.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import bscsr as jbscsr
from repro.core import partition as jpartition
from repro.core import precision_model as jprecision
from repro.core import quantization as jquant
from repro.kernels import ops as jops
from repro_torch.core import bscsr as tbscsr
from repro_torch.core import partition as tpartition
from repro_torch.core import precision_model as tprecision
from repro_torch.core import quantization as tquant
from repro_torch.kernels import ops as tops

FORMATS = ["F32", "BF16", "Q15", "Q7"]
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
SRC_PORT = Path(SRC) / "repro_torch"


def as_bytes(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def port_csr(csr) -> tbscsr.CSRMatrix:
    return tbscsr.CSRMatrix(csr.indptr, csr.indices, csr.data, csr.shape)


def csr_with_empty_rows(n_rows=90, n_cols=64, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 12, size=n_rows)
    lens[::4] = 0
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.concatenate(
        [np.sort(rng.choice(n_cols, size=n, replace=False)) for n in lens if n]
    ).astype(np.int32)
    data = rng.standard_normal(int(lens.sum())).astype(np.float32)
    return jbscsr.CSRMatrix(indptr, idx, data, (n_rows, n_cols))


class TestQuantization:
    @pytest.mark.parametrize("fmt", FORMATS)
    def test_quantize_bytes(self, fmt):
        rng = np.random.default_rng(1)
        vals = np.concatenate([
            rng.standard_normal(4000).astype(np.float32),
            np.array([0.0, -0.0, 1.0, -1.0, 1e30, -1e30, 1e-40, -1e-40,
                      0.9999, -1.0001, 2.5, 1 / 3], np.float32),
        ])
        j = jquant.quantize(vals, jquant.FORMATS[fmt])
        t = tquant.quantize(vals, tquant.FORMATS[fmt])
        assert t.dtype == tquant.FORMATS[fmt].np_dtype
        assert as_bytes(j) == as_bytes(t)
        np.testing.assert_array_equal(
            jquant.host_dequantize(j, jquant.FORMATS[fmt]).view(np.int32),
            tquant.host_dequantize(t, tquant.FORMATS[fmt]).view(np.int32),
        )

    def test_format_tables(self):
        assert list(jquant.STREAM_FORMATS) == list(tquant.STREAM_FORMATS)
        for name, f in jquant.FORMATS.items():
            g = tquant.FORMATS[name]
            assert (f.storage_dtype, f.frac_bits, f.code, f.scale) == (
                g.storage_dtype, g.frac_bits, g.code, g.scale)
        for name, c in jquant.WIDTH_CLASSES.items():
            assert (c.bytes_per_value, c.members) == (
                tquant.WIDTH_CLASSES[name].bytes_per_value,
                tquant.WIDTH_CLASSES[name].members)


class TestEncode:
    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("n_cols", [64, 40_000])   # int16 and int32 col ids
    @pytest.mark.parametrize("block", [32, 64])
    def test_encode_fuse_pad_bytes(self, fmt, n_cols, block):
        csr = csr_with_empty_rows(n_cols=n_cols, seed=block + n_cols)
        j = jbscsr.encode_bscsr(csr, block, fmt)
        t = tbscsr.encode_bscsr(port_csr(csr), block, fmt)
        for name in ("vals", "cols", "flags"):
            assert as_bytes(getattr(j, name)) == as_bytes(getattr(t, name)), name
        assert t.cols.dtype == j.cols.dtype
        assert (j.n_rows, j.nnz, j.num_packets) == (t.n_rows, t.nnz, t.num_packets)
        assert as_bytes(jbscsr.fuse_stream(j)) == as_bytes(tbscsr.fuse_stream(t))
        assert as_bytes(jbscsr.fuse_stream(j, tagged=True)) == as_bytes(
            tbscsr.fuse_stream(t, tagged=True))
        jp, tp = jbscsr.pad_packets(j, j.num_packets + 3), tbscsr.pad_packets(
            t, t.num_packets + 3)
        assert as_bytes(jp.fused_words()) == as_bytes(tp.fused_words())
        v, c, f = tbscsr.defuse_stream(tp.fused_words(), block, fmt, t.cols.dtype)
        assert as_bytes(v) == as_bytes(tp.vals) and as_bytes(c) == as_bytes(tp.cols)
        assert as_bytes(f) == as_bytes(tp.flags)
        assert tbscsr.fused_word_counts(block, fmt, t.cols.dtype) == \
            jbscsr.fused_word_counts(block, fmt, j.cols.dtype)

    @pytest.mark.parametrize("n_cols", [100, 40_000])
    def test_col_index_dtype(self, n_cols):
        assert tbscsr.col_index_dtype(n_cols) == jbscsr.col_index_dtype(n_cols)


class TestSynthetic:
    @pytest.mark.parametrize("dist", ["uniform", "gamma"])
    @pytest.mark.parametrize("chunk_elems", [7, 1000, 1 << 24])
    def test_chunked_generation_byte_identical(self, dist, chunk_elems, monkeypatch):
        monkeypatch.setattr(tbscsr, "_KEY_CHUNK_ELEMS", chunk_elems)
        for n_rows, n_cols, mean in [(700, 64, 9), (300, 20, 40)]:
            j = jbscsr.synthetic_embedding_csr(n_rows, n_cols, mean, dist, seed=5)
            t = tbscsr.synthetic_embedding_csr(n_rows, n_cols, mean, dist, seed=5)
            for name in ("indptr", "indices", "data"):
                assert as_bytes(getattr(j, name)) == as_bytes(getattr(t, name))
            assert j.shape == t.shape

    def test_tied_keys_follow_reference_argsort(self):
        """Rows whose keys tie at the cut fall back to the reference's argsort."""
        keys = np.array([[0.5, 0.1, 0.5, 0.9],     # tie at the 2nd-smallest key
                         [0.3, 0.2, 0.1, 0.4],
                         [0.7, 0.7, 0.7, 0.2]])    # three-way tie
        lens = np.array([2, 3, 2])
        indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

        class Keys:
            def random(self, shape):
                return keys[: shape[0]].copy()

        got = tbscsr._sample_columns(Keys(), lens, indptr)
        order = np.argsort(keys, axis=1)
        want = np.concatenate([np.sort(order[i, : lens[i]]) for i in range(3)])
        np.testing.assert_array_equal(got, want)

    def test_sparsify_topm(self):
        dense = np.random.default_rng(2).standard_normal((50, 40)).astype(np.float32)
        j, t = jbscsr.sparsify_topm(dense, 7), tbscsr.sparsify_topm(dense, 7)
        for name in ("indptr", "indices", "data"):
            assert as_bytes(getattr(j, name)) == as_bytes(getattr(t, name))


class TestDeltaPlane:
    """The mutable index's host plane: delta streams, appends, tombstones."""

    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("n_cols", [64, 40_000])
    def test_delta_append_decode_bytes(self, fmt, n_cols):
        rng = np.random.default_rng(7)
        base_csr = csr_with_empty_rows(n_rows=30, n_cols=n_cols, seed=n_cols)
        rows = [(np.sort(rng.choice(n_cols, n, replace=False)).astype(np.int32),
                 rng.standard_normal(n).astype(np.float32)) for n in (3, 0, 40, 1)]
        jd = jbscsr.encode_delta_rows(rows, n_cols, 32, fmt)
        td = tbscsr.encode_delta_rows(rows, n_cols, 32, fmt)
        jb = jbscsr.encode_bscsr(base_csr, 32, fmt)
        tb = tbscsr.encode_bscsr(port_csr(base_csr), 32, fmt)
        ja = jbscsr.append_packets(jb, jd, pad_packets_to=jb.num_packets + td.num_packets + 2)
        ta = tbscsr.append_packets(tb, td, pad_packets_to=tb.num_packets + td.num_packets + 2)
        for j, t in ((jd, td), (ja, ta)):
            for name in ("vals", "cols", "flags"):
                assert as_bytes(getattr(j, name)) == as_bytes(getattr(t, name)), name
            assert (j.n_rows, j.nnz, j.n_cols) == (t.n_rows, t.nnz, t.n_cols)
            jc, tc = jbscsr.decode_bscsr(j), tbscsr.decode_bscsr(t)
            for name in ("indptr", "indices", "data"):
                assert as_bytes(getattr(jc, name)) == as_bytes(getattr(tc, name)), name
        with pytest.raises(ValueError, match="block size"):
            tbscsr.append_packets(tb, tbscsr.encode_delta_rows(rows, n_cols, 64, fmt))

    def test_tombstone_bitmap_and_to_dense(self):
        j, t = jbscsr.TombstoneBitmap.empty(5), tbscsr.TombstoneBitmap.empty(5)
        for bm in (j, t):
            bm.mark([1, 9])
            bm.clear([9, 40])
            bm.grow(12)
            bm.mark([11])
        assert as_bytes(j.bits) == as_bytes(t.bits)
        assert j.count == t.count == 2 and (11 in t) and (9 not in t) and (50 not in t)
        csr = csr_with_empty_rows(n_rows=20, seed=3)
        np.testing.assert_array_equal(csr.to_dense(), port_csr(csr).to_dense())


class TestPartitionAndPack:
    @pytest.mark.parametrize("n_rows,c", [(333, 4), (100, 1), (50, 7)])
    def test_partition_plan(self, n_rows, c):
        j = jpartition.PartitionPlan.build(n_rows, c)
        t = tpartition.PartitionPlan.build(n_rows, c)
        assert (j.row_starts, j.rows_per_partition) == (t.row_starts, t.rows_per_partition)
        assert j.expected_precision(8, 16) == t.expected_precision(8, 16)

    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("layout", ["split", "fused"])
    def test_pack_partitions_bytes(self, fmt, layout):
        csr = jbscsr.synthetic_embedding_csr(250, 64, 8, "gamma", seed=3)
        j = jops.pack_partitions(csr, 3, 32, fmt, packets_multiple=2,
                                 stream_layout=layout)
        t = tops.pack_partitions(port_csr(csr), 3, 32, fmt, packets_multiple=2,
                                 stream_layout=layout)
        for name in ("vals", "cols", "flags"):
            assert as_bytes(getattr(j, name)) == as_bytes(getattr(t, name)), name
        assert as_bytes(j.fused_words()) == as_bytes(t.fused_words())
        assert (j.words is None) == (t.words is None)
        assert j.max_slots == t.max_slots and j.nnz == t.nnz
        np.testing.assert_array_equal(j.candidate_slots, t.candidate_slots)
        assert j.signature_info() == t.signature_info()
        assert j.stream_bytes == t.stream_bytes

    def test_buckets(self):
        for n in [0, 1, 2, 3, 17, 64, 65]:
            assert tops.pow2_bucket(n) == jops.pow2_bucket(n)
            assert tops.bucket_packets(n, 2) == jops.bucket_packets(n, 2)


class TestPrecisionModel:
    @pytest.mark.parametrize("n,c,k,big_k", [(10_000, 16, 8, 100), (1_000_000, 32, 8, 100),
                                             (500, 4, 4, 20)])
    def test_same_numbers(self, n, c, k, big_k):
        assert tprecision.expected_precision(n, c, k, big_k) == \
            jprecision.expected_precision(n, c, k, big_k)
        assert tprecision.expected_precision_avg(n, c, k, big_k) == \
            jprecision.expected_precision_avg(n, c, k, big_k)
        assert tprecision.monte_carlo_precision(n, c, k, big_k, trials=50) == \
            jprecision.monte_carlo_precision(n, c, k, big_k, trials=50)
        assert tprecision.min_partitions_for_precision(n, k, big_k) == \
            jprecision.min_partitions_for_precision(n, k, big_k)


def test_import_hygiene():
    """Every module of the port imports neither jax, repro nor ml_dtypes."""
    modules = sorted(
        ".".join(("repro_torch",) + path.relative_to(SRC_PORT).with_suffix("").parts)
        .removesuffix(".__init__")
        for path in SRC_PORT.rglob("*.py"))
    assert {"repro_torch.core.adaptive", "repro_torch.core.persistence",
            "repro_torch.serve.streaming", "repro_torch.utils.watchdog"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
