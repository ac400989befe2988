"""The port's kernels against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; here that version is
held against ``repro``'s Pallas kernel run with ``interpret=True`` on the
same fused words, made from a seed with numpy.

* Dyadic fixtures (values on a 2**-7 grid, queries on a 2**-3 grid) keep
  every product and partial sum exact in f32, so summation order cannot
  matter: the outputs must be bit-identical, sign bits included.
* Random fixtures agree within rtol = atol = 1e-5, the reference's own
  tolerance between its inner loops, which differ in summation order; row
  ids are equal wherever scores are not within 1e-5 of a tie.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import bscsr as jbscsr
from repro.kernels import bscsr_topk_spmv as jkern
from repro.kernels import ops as jops
from repro_torch.core import bscsr as tbscsr
from repro_torch.kernels import bscsr_topk_spmv as tkern
from repro_torch.kernels import ops as tops

FORMATS = ["F32", "BF16", "Q15", "Q7"]
TOL = 1e-5


def dyadic_csr(n_rows=120, n_cols=64, seed=0, max_len=12, empty_every=0, sign=0):
    """Values k/128 (exact in every stream format); ``sign`` forces a sign."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, size=n_rows)
    if empty_every:
        lens[::empty_every] = 0
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.concatenate(
        [np.sort(rng.choice(n_cols, size=n, replace=False)) for n in lens if n]
    ).astype(np.int32)
    data = rng.integers(-128, 128, size=int(lens.sum())) / 128.0
    if sign:
        data = sign * np.maximum(np.abs(data), 1 / 128)
    return jbscsr.CSRMatrix(indptr, idx, data.astype(np.float32), (n_rows, n_cols))


def dyadic_queries(q, n_cols, seed=1, positive=False):
    rng = np.random.default_rng(seed)
    lo = 1 if positive else -16
    return (rng.integers(lo, 17, size=(q, n_cols)) / 8.0).astype(np.float32)


def random_queries(q, n_cols, seed=1):
    return np.random.default_rng(seed).standard_normal((q, n_cols)).astype(np.float32)


def fused_words(csr, cores, block, fmt, t):
    """The same fused words from both packages (asserted byte-equal)."""
    jp = jops.pack_partitions(csr, cores, block, fmt, packets_multiple=t,
                              stream_layout="fused")
    tp = tops.pack_partitions(
        tbscsr.CSRMatrix(csr.indptr, csr.indices, csr.data, csr.shape), cores, block,
        fmt, packets_multiple=t, stream_layout="fused")
    assert jp.words.tobytes() == tp.words.tobytes()
    return tp.words, tp.max_slots


def pallas(xs, words, multi, **kw):
    fn = jkern.bscsr_topk_spmv_multiquery if multi else jkern.bscsr_topk_spmv
    x = jnp.asarray(xs if multi else xs[0])
    v, r = fn(x, jnp.asarray(words), stream_layout="fused", interpret=True, **kw)
    return np.asarray(v), np.asarray(r)


def plain(xs, words, multi, **kw):
    fn = tkern.bscsr_topk_spmv_multiquery if multi else tkern.bscsr_topk_spmv
    x = torch.from_numpy(xs if multi else xs[0])
    v, r = fn(x, torch.from_numpy(words), **kw)
    return v.numpy(), r.numpy()


def assert_bitwise(a, b):
    np.testing.assert_array_equal(a[0].view(np.int32), b[0].view(np.int32))
    np.testing.assert_array_equal(a[1], b[1])


def assert_close_rows(a, b, tol=TOL):
    """Values within tol; row ids equal except inside a near-tie of scores."""
    np.testing.assert_allclose(a[0], b[0], rtol=tol, atol=tol)
    va = a[0].reshape(-1, a[0].shape[-1])
    diff = np.nonzero(a[1].reshape(va.shape) != b[1].reshape(va.shape))
    for i, j in zip(*diff):
        gaps = np.abs(va[i] - va[i, j])
        gaps[j] = np.inf
        assert gaps.min() <= 2 * tol, f"row ids differ outside a tie at {(i, j)}"


def both(xs, words, multi, **kw):
    return pallas(xs, words, multi, **kw), plain(xs, words, multi, **kw)


def poison_padding(words, block, fmt, rows_per_core):
    """Garbage col ids (far out of range, and negative) in sentinel/padding nnz."""
    out = words.copy()
    for c in range(words.shape[0]):
        vals, cols, flags = tbscsr.defuse_stream(words[c], block, fmt, np.int16)
        row_ids = np.cumsum(tbscsr.unpack_bits(flags, block).reshape(-1)) - 1
        pad = (row_ids >= rows_per_core[c]).reshape(cols.shape)
        cols = cols.copy()
        cols[pad] = 30_000
        half = pad.copy()
        half[::2] = False
        cols[half] = -7
        out[c] = tbscsr.fuse_words(vals, cols, flags)
    return out


class TestDyadicBitIdentical:
    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("block,t", [(32, 1), (64, 2)])
    @pytest.mark.parametrize("multi", [False, True])
    def test_formats(self, fmt, block, t, multi):
        csr = dyadic_csr(seed=block, empty_every=7)
        words, slots = fused_words(csr, 3, block, fmt, t)
        xs = dyadic_queries(3 if multi else 1, 64, seed=t)
        a, b = both(xs, words, multi, k=8, n_rows=slots, packets_per_step=t,
                    fmt_name=fmt, block_size=block)
        assert_bitwise(a, b)

    @pytest.mark.parametrize("multi", [False, True])
    def test_all_negative_padded_budget(self, multi):
        """Every score < 0 and a slot budget past the live count, with extra
        flag-free packets: phantom slots must never enter the scratchpad."""
        csr = dyadic_csr(n_rows=40, seed=3, sign=-1)
        words, slots = fused_words(csr, 2, 32, "Q7", 2)
        words = np.concatenate([words, np.zeros((2, 4, words.shape[2]), np.int32)], 1)
        xs = dyadic_queries(3 if multi else 1, 64, seed=4, positive=True)
        a, b = both(xs, words, multi, k=8, n_rows=4 * slots, packets_per_step=2,
                    fmt_name="Q7", block_size=32)
        assert_bitwise(a, b)
        assert (a[0] < 0).all() and (a[1] < slots).all()

    @pytest.mark.parametrize("t", [1, 2])
    def test_row_spanning_packets_and_short_cores(self, t):
        """One row of 150 nnz spans five 32-nnz packets; some cores hold
        fewer than k rows, so their scratchpads keep (NEG_INF, n_rows)."""
        rng = np.random.default_rng(6)
        lens = np.array([3, 150, 2, 0, 5, 1, 4])
        indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        idx = np.concatenate([np.sort(rng.choice(200, n, replace=False))
                              for n in lens if n]).astype(np.int32)
        data = (rng.integers(-128, 128, int(lens.sum())) / 128.0).astype(np.float32)
        csr = jbscsr.CSRMatrix(indptr, idx, data, (7, 200))
        words, slots = fused_words(csr, 3, 32, "Q15", t)
        for multi in (False, True):
            xs = dyadic_queries(3 if multi else 1, 200, seed=7)
            a, b = both(xs, words, multi, k=8, n_rows=slots, packets_per_step=t,
                        fmt_name="Q15", block_size=32)
            assert_bitwise(a, b)
        assert (a[1] == slots).any()

    @staticmethod
    def signed_zero_fixture():
        """Q7 rows whose entries quantise to 0 score zero against a negative
        query; they compete with negative rows under the stage-4 rule."""
        rng = np.random.default_rng(8)
        n_rows, n_cols = 48, 32
        lens = rng.integers(1, 6, size=n_rows)
        indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        idx = np.concatenate([np.sort(rng.choice(n_cols, n, replace=False))
                              for n in lens]).astype(np.int32)
        data = (rng.integers(1, 64, int(lens.sum())) / 128.0).astype(np.float32)
        zero_rows = np.repeat(rng.random(n_rows) < 0.5, lens)
        data[zero_rows] = 0.001                       # rounds to a stored 0
        csr = jbscsr.CSRMatrix(indptr, idx, data, (n_rows, n_cols))
        words, slots = fused_words(csr, 2, 32, "Q7", 1)
        xs = -np.abs(dyadic_queries(3, n_cols, seed=9, positive=True))
        return words, slots, xs

    def test_signed_zero_scores(self):
        words, slots, xs = self.signed_zero_fixture()
        for multi in (False, True):
            a, b = both(xs, words, multi, k=12, n_rows=slots, packets_per_step=1,
                        fmt_name="Q7", block_size=32)
            assert_bitwise(a, b)
            assert (a[0] == 0).any()

    @pytest.mark.parametrize("loop", ["legacy", "linear-seg"])
    def test_k_pass_loops_differ_only_beside_neg_inf(self, loop):
        """The reference's k-pass admission is served by the threshold rule:
        scores bit-identical (no candidate scores -0.0), row ids equal beside
        every score above NEG_INF.  Unfilled entries of short cores keep
        ``n_rows`` here; the reference repeats an earlier row there."""
        words, slots, xs = self.signed_zero_fixture()
        short = dyadic_csr(n_rows=5, n_cols=64, seed=24)
        short_words, short_slots = fused_words(short, 2, 32, "Q15", 1)
        cases = [(words, slots, xs, 12, "Q7"),
                 (short_words, short_slots, dyadic_queries(3, 64, seed=25), 8, "Q15")]
        for w, n_rows, q, k, fmt in cases:
            for multi in (False, True):
                a, b = both(q if multi else q[:1], w, multi, k=k, n_rows=n_rows,
                            packets_per_step=1, fmt_name=fmt, block_size=32,
                            inner_loop=loop)
                np.testing.assert_array_equal(a[0].view(np.int32), b[0].view(np.int32))
                filled = a[0] > tkern.NEG_INF
                np.testing.assert_array_equal(a[1][filled], b[1][filled])
                assert (b[1][~filled] == n_rows).all()
        assert not np.signbit(a[0][a[0] == 0]).any()
        assert (~filled).any()

    def test_poisoned_padding_and_int32_cols(self):
        """Garbage padding ids read 0; n_cols >= 32768 selects int32 ids."""
        csr = dyadic_csr(n_rows=30, seed=10)
        words, slots = fused_words(csr, 2, 32, "BF16", 2)
        rows = np.asarray([15, 15])
        dirty = poison_padding(words, 32, "BF16", rows)
        assert not np.array_equal(dirty, words)
        xs = dyadic_queries(3, 64, seed=11)
        for multi in (False, True):
            assert_bitwise(*both(xs, dirty, multi, k=8, n_rows=slots, packets_per_step=2,
                                 fmt_name="BF16", block_size=32))
            clean = plain(xs, words, multi, k=8, n_rows=slots, packets_per_step=2,
                          fmt_name="BF16", block_size=32)
            assert_bitwise(clean, plain(xs, dirty, multi, k=8, n_rows=slots,
                                        packets_per_step=2, fmt_name="BF16",
                                        block_size=32))
        wide = dyadic_csr(n_rows=40, n_cols=40_000, seed=12)
        words, slots = fused_words(wide, 2, 32, "F32", 2)
        assert words.shape[2] == 1 + 32 + 32
        xs = dyadic_queries(3, 40_000, seed=13)
        assert_bitwise(*both(xs, words, True, k=8, n_rows=slots, packets_per_step=2,
                             fmt_name="F32", block_size=32))


class TestRandomWithinTolerance:
    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("multi", [False, True])
    def test_formats(self, fmt, multi):
        csr = jbscsr.synthetic_embedding_csr(300, 64, 9, "gamma", seed=14)
        words, slots = fused_words(csr, 3, 64, fmt, 2)
        xs = random_queries(3 if multi else 1, 64, seed=15)
        a, b = both(xs, words, multi, k=8, n_rows=slots, packets_per_step=2,
                    fmt_name=fmt, block_size=64)
        assert_close_rows(a, b)


def split_csr(kind, block, n_cols, seed, sign=0, dyadic=False):
    """Random F32 rows for the split walk (``dyadic``: values k/128).

    "long": empty rows and, every ninth row, one over five packets, so many
    steps hold no flag bit.  "aligned": rows of whole steps (multiples of
    2B), so rows open at bit 0 of a step and segment 0 of a split's first
    step is empty.
    """
    rng = np.random.default_rng(seed)
    if kind == "long":
        lens = rng.integers(0, 13, size=48)
        lens[::7] = 0
        lens[4::9] = rng.integers(5 * block + 1, 6 * block, size=len(lens[4::9]))
    else:
        lens = 2 * block * rng.integers(1, 4, size=24)
        lens[5::6] = rng.integers(1, 2 * block, size=len(lens[5::6]))
    lens = np.minimum(lens, n_cols)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.concatenate([np.sort(rng.choice(n_cols, int(n), replace=False))
                          for n in lens if n]).astype(np.int32)
    n = int(lens.sum())
    data = (rng.integers(-128, 128, n) / 128.0 if dyadic else rng.standard_normal(n))
    data = data.astype(np.float32)
    if sign:
        data = sign * (np.maximum(np.abs(data), 1 / 128) if dyadic else np.abs(data))
    return tbscsr.CSRMatrix(indptr, idx, data, (len(lens), n_cols))


def split_words(csr, cores, block, fmt, t, pad_steps=2, flagless_core=True):
    """Port-packed fused words with flag-free padding steps at the tail and,
    optionally, an extra core that holds no flag bit at all."""
    tp = tops.pack_partitions(csr, cores, block, fmt, packets_multiple=t,
                              stream_layout="fused")
    words = np.concatenate(
        [tp.words, np.zeros((cores, pad_steps * t, tp.words.shape[2]), np.int32)], 1)
    if flagless_core:
        dead = words[:1].copy()
        dead[..., : block // 32] = 0
        words = np.concatenate([words, dead], 0)
    return words, tp


def brute_split_table(words, t, block, splits):
    """spmv_split_table's rule, one core and one bound at a time."""
    n_cores, n_packets, _ = words.shape
    n_steps = n_packets // t
    flags = words[..., : block // 32].view(np.uint32)
    bounds = np.zeros((n_cores, splits + 1), np.int32)
    heads = np.zeros((n_cores, splits), np.int32)
    for c in range(n_cores):
        counts = [sum(bin(int(w)).count("1") for w in flags[c, s * t:(s + 1) * t].ravel())
                  for s in range(n_steps)]
        flagged = [s for s in range(n_steps) if counts[s]]
        end = flagged[-1] + 1 if flagged else 0
        b = [0] + [min([s for s in flagged if s >= i * end // splits], default=end)
                   for i in range(1, splits)] + [end]
        b = sorted(end if i and b[i] == b[i - 1] else b[i] for i in range(splits + 1))
        bounds[c] = b
        heads[c] = [sum(counts[: b[i]]) - 1 for i in range(splits)]
    return bounds, heads


def spmv(words, x, splits=None, **kw):
    return tkern.bscsr_spmv(torch.from_numpy(x), torch.from_numpy(words), splits=splits,
                            **kw).numpy()


class TestAccumulateSplit:
    """The accumulate kernel's split walk (what S blocks per core compute)
    equals the single walk bit for bit on random data: it is the
    specification the CUDA kernel is transcribed from."""

    @pytest.mark.parametrize("splits", [1, 2, 3, 5, 64])
    @pytest.mark.parametrize("kind,block,t", [("long", 32, 1), ("long", 32, 2),
                                              ("aligned", 32, 2), ("long", 256, 2)])
    def test_split_table_matches_brute_force(self, splits, kind, block, t):
        csr = split_csr(kind, block, 2000, seed=splits + t)
        words, _ = split_words(csr, 3, block, "F32", t)
        bounds, heads = tkern.spmv_split_table(torch.from_numpy(words), packets_per_step=t,
                                               block_size=block, splits=splits)
        want_b, want_h = brute_split_table(words, t, block, splits)
        np.testing.assert_array_equal(bounds.numpy(), want_b)
        np.testing.assert_array_equal(heads.numpy(), want_h)
        assert bounds.dtype == heads.dtype == torch.int32
        assert (want_b[-1] == 0).all()                          # the flagless core
        assert (want_b[:-1, -1] < words.shape[1] // t).all()    # padded tails cut

    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("n_cols", [2000, 40_000])          # int16 and int32 ids
    @pytest.mark.parametrize("block,t", [(32, 1), (32, 2), (256, 1), (256, 2)])
    def test_split_walk_equals_single_walk(self, fmt, n_cols, block, t):
        x = random_queries(1, n_cols, seed=block + t)[0]
        for kind in ("long", "aligned"):
            csr = split_csr(kind, block, n_cols, seed=n_cols % 89 + t)
            words, tp = split_words(csr, 3, block, fmt, t)
            assert (words.shape[2] - block // 32 - block * tp.value_format.bytes_per_value
                    // 4 == (block if n_cols > 32_767 else block // 2))
            kw = dict(n_rows=2 * tp.max_slots, packets_per_step=t, fmt_name=fmt,
                      block_size=block)
            single = spmv(words, x, **kw)
            assert np.abs(single).max() > 0
            for splits in (1, 2, 5, 64):
                np.testing.assert_array_equal(spmv(words, x, splits, **kw).view(np.int32),
                                              single.view(np.int32))

    def test_all_negative_padded_budget(self):
        csr = split_csr("long", 32, 64, seed=3, sign=-1)
        words, tp = split_words(csr, 2, 32, "Q7", 2, pad_steps=4)
        x = np.abs(random_queries(1, 64, seed=4)[0])
        kw = dict(n_rows=4 * tp.max_slots, packets_per_step=2, fmt_name="Q7",
                  block_size=32)
        single = spmv(words, x, **kw)
        assert (single <= 0).all() and (single < 0).any()
        live = np.append(np.asarray(tp.candidate_slots), 0)
        phantom = np.arange(kw["n_rows"])[None, :] >= live[:, None]
        for splits in (1, 2, 5, 64):
            got = spmv(words, x, splits, **kw)
            np.testing.assert_array_equal(got.view(np.int32), single.view(np.int32))
            assert (got.view(np.int32)[phantom] == 0).all()     # +0.0, not -0.0

    def test_poisoned_padding_ids(self):
        csr = split_csr("long", 32, 64, seed=10)
        words, tp = split_words(csr, 2, 32, "BF16", 2, flagless_core=False)
        dirty = poison_padding(words, 32, "BF16", np.asarray(tp.candidate_slots))
        assert not np.array_equal(dirty, words)
        x = random_queries(1, 64, seed=11)[0]
        kw = dict(n_rows=tp.max_slots, packets_per_step=2, fmt_name="BF16", block_size=32)
        single = spmv(words, x, **kw)
        for splits in (1, 2, 5, 64):
            np.testing.assert_array_equal(spmv(dirty, x, splits, **kw).view(np.int32),
                                          single.view(np.int32))

    def test_fix_up_carries_across_splits(self):
        """The split walk joins rows that open in one split and close in the
        next; without the previous split's carry the sums would differ."""
        csr = split_csr("long", 32, 2000, seed=12)
        words, tp = split_words(csr, 3, 32, "F32", 1)
        t_words = torch.from_numpy(words)
        bounds, heads = tkern.spmv_split_table(t_words, packets_per_step=1, block_size=32,
                                               splits=5)
        bounds_np = bounds.numpy()
        opens_early = False
        for c in range(words.shape[0]):
            for i in range(1, 5):
                b = bounds_np[c, i]
                if b < bounds_np[c, i + 1]:
                    first_bit = int(words[c, b, 0]) & 1
                    opens_early |= not first_bit and heads.numpy()[c, i] >= 0
        assert opens_early                      # some head piece joins a carry
        x = random_queries(1, 2000, seed=13)[0]
        kw = dict(n_rows=tp.max_slots, packets_per_step=1, fmt_name="F32", block_size=32)
        np.testing.assert_array_equal(
            tkern.bscsr_spmv(torch.from_numpy(x), t_words, table=(bounds, heads),
                             **kw).numpy().view(np.int32),
            spmv(words, x, **kw).view(np.int32))

    def test_table_rules(self):
        words = torch.zeros((2, 4, 1 + 16 + 32), dtype=torch.int32)
        with pytest.raises(ValueError, match="splits"):
            tkern.spmv_split_table(words, packets_per_step=2, block_size=32, splits=0)
        bounds, heads = tkern.spmv_split_table(words, packets_per_step=2, block_size=32,
                                               splits=3)
        assert bounds.tolist() == [[0] * 4] * 2 and heads.tolist() == [[-1] * 3] * 2
        assert tkern.spmv_splits("cpu", 2, packets_per_step=2, block_size=32, m=64) == \
            tkern.PLAIN_SPLITS
        assert tkern.bscsr_spmv(torch.zeros(64), words, n_rows=4, packets_per_step=2,
                                fmt_name="F32", block_size=32, splits=3).abs().max() == 0


def mq(words, xs, splits=None, table=None, **kw):
    v, r = tkern.bscsr_topk_spmv_multiquery(torch.from_numpy(xs), torch.from_numpy(words),
                                            splits=splits, table=table, **kw)
    return v.numpy(), r.numpy()


def mq_single(words, xs, **kw):
    """The single walk: the plain version with no splits and no table."""
    v, r = tkern.bscsr_topk_spmv_multiquery_plain(torch.from_numpy(xs),
                                                  torch.from_numpy(words), **kw)
    return v.numpy(), r.numpy()


class TestTopkSplit:
    """The multi-query kernel's split walk (S blocks per core, each with its
    own scratchpad, joined by the in-order fold) equals the single walk bit
    for bit, on random data too: it is the specification the CUDA kernel is
    transcribed from."""

    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("n_cols", [2000, 40_000])          # int16 and int32 ids
    @pytest.mark.parametrize("block,t", [(32, 1), (32, 2), (64, 1), (64, 2)])
    def test_split_walk_equals_single_walk(self, fmt, n_cols, block, t):
        for kind, dyadic in (("long", False), ("aligned", False), ("long", True)):
            csr = split_csr(kind, block, n_cols, seed=n_cols % 89 + t + block, dyadic=dyadic)
            words, tp = split_words(csr, 3, block, fmt, t)
            kw = dict(k=8, n_rows=tp.max_slots, packets_per_step=t, fmt_name=fmt,
                      block_size=block)
            for q in (1, 3):
                xs = (dyadic_queries(q, n_cols, seed=q + t) if dyadic
                      else random_queries(q, n_cols, seed=q + t))
                single = mq_single(words, xs, **kw)
                assert (single[0] > tkern.NEG_INF).any()
                for splits in (1, 2, 5, 64):
                    assert_bitwise(mq(words, xs, splits, **kw), single)

    @pytest.mark.parametrize("splits", [2, 5, 64])
    def test_signed_zero_scores(self, splits):
        words, slots, xs = TestDyadicBitIdentical.signed_zero_fixture()
        kw = dict(k=12, n_rows=slots, packets_per_step=1, fmt_name="Q7", block_size=32)
        single = mq_single(words, xs, **kw)
        assert (single[0] == 0).any()
        assert_bitwise(mq(words, xs, splits, **kw), single)

    @pytest.mark.parametrize("splits", [2, 5, 64])
    def test_all_negative_padded_budget(self, splits):
        """Every score < 0, a slot budget past the live count and flag-free
        padding steps (cut at e_c): no phantom slot enters a scratchpad."""
        csr = split_csr("long", 32, 64, seed=3, sign=-1, dyadic=True)
        words, tp = split_words(csr, 2, 32, "Q7", 2, pad_steps=4)
        xs = dyadic_queries(3, 64, seed=4, positive=True)
        kw = dict(k=8, n_rows=4 * tp.max_slots, packets_per_step=2, fmt_name="Q7",
                  block_size=32)
        single = mq_single(words, xs, **kw)
        got = mq(words, xs, splits, **kw)
        assert_bitwise(got, single)
        filled = got[0] > tkern.NEG_INF
        assert (got[0][filled] <= 0).all() and (got[0][filled] < 0).any()   # empty rows: 0
        assert (got[1][~filled] == kw["n_rows"]).all()
        live = np.append(np.asarray(tp.candidate_slots), 0)
        for c in range(words.shape[0]):
            assert (got[1][c][filled[c]] < live[c]).all()

    @pytest.mark.parametrize("t", [1, 2])
    def test_row_spanning_packets_and_short_cores(self, t):
        rng = np.random.default_rng(6)
        lens = np.array([3, 150, 2, 0, 5, 1, 4])
        indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        idx = np.concatenate([np.sort(rng.choice(200, n, replace=False))
                              for n in lens if n]).astype(np.int32)
        data = (rng.integers(-128, 128, int(lens.sum())) / 128.0).astype(np.float32)
        csr = jbscsr.CSRMatrix(indptr, idx, data, (7, 200))
        words, slots = fused_words(csr, 3, 32, "Q15", t)
        xs = dyadic_queries(3, 200, seed=7)
        kw = dict(k=8, n_rows=slots, packets_per_step=t, fmt_name="Q15", block_size=32)
        single = mq_single(words, xs, **kw)
        assert (single[1] == slots).any()
        for splits in (2, 5, 64):
            assert_bitwise(mq(words, xs, splits, **kw), single)

    def test_poisoned_padding_ids(self):
        csr = split_csr("long", 32, 64, seed=10, dyadic=True)
        words, tp = split_words(csr, 2, 32, "BF16", 2, flagless_core=False)
        dirty = poison_padding(words, 32, "BF16", np.asarray(tp.candidate_slots))
        assert not np.array_equal(dirty, words)
        xs = random_queries(3, 64, seed=11)
        kw = dict(k=8, n_rows=tp.max_slots, packets_per_step=2, fmt_name="BF16",
                  block_size=32)
        single = mq_single(words, xs, **kw)
        for splits in (2, 5, 64):
            assert_bitwise(mq(dirty, xs, splits, **kw), single)

    @pytest.mark.parametrize("splits", [2, 3, 7, 64])
    def test_ties_at_the_kth_place_across_splits(self, splits):
        """Most rows score exactly 3/8: the k-th place is a tie that the fold
        must break by the lower slot, across every split boundary, and the
        head rows tie too."""
        rng = np.random.default_rng(30)
        lens = np.full(90, 3)
        lens[::11] = rng.integers(40, 70, size=len(lens[::11]))   # rows over packets
        lens[5::13] = 4
        indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        idx = np.concatenate([np.sort(rng.choice(80, int(n), replace=False))
                              for n in lens]).astype(np.int32)
        data = np.full(int(lens.sum()), 1 / 8, np.float32)
        long_rows = np.repeat(lens > 4, lens)
        data[long_rows] = -1 / 128
        csr = tbscsr.CSRMatrix(indptr, idx, data, (len(lens), 80))
        words, tp = split_words(csr, 2, 32, "F32", 1)
        xs = np.ones((2, 80), np.float32)
        xs[1, ::2] = 0.5
        kw = dict(k=8, n_rows=tp.max_slots, packets_per_step=1, fmt_name="F32",
                  block_size=32)
        single = mq_single(words, xs, **kw)
        assert (single[0][:2, 0, -1] == 3 / 8).all()               # the k-th place ties
        bounds, _ = tkern.spmv_split_table(torch.from_numpy(words), packets_per_step=1,
                                           block_size=32, splits=splits)
        assert (bounds[:2, 1] < bounds[:2, -1]).all()               # more than one split
        assert_bitwise(mq(words, xs, splits, **kw), single)

    def test_split_walk_against_pallas(self):
        """One dyadic S > 1 case against the reference's Pallas kernel."""
        csr = dyadic_csr(n_rows=150, seed=31, max_len=40, empty_every=6)
        words, slots = fused_words(csr, 2, 32, "BF16", 2)
        xs = dyadic_queries(3, 64, seed=32)
        kw = dict(k=8, n_rows=slots, packets_per_step=2, fmt_name="BF16", block_size=32)
        want = pallas(xs, words, True, **kw)
        bounds, heads = tkern.spmv_split_table(torch.from_numpy(words), packets_per_step=2,
                                               block_size=32, splits=5)
        assert (bounds[:, 2] < bounds[:, -1]).all()
        assert_bitwise(mq(words, xs, table=(bounds, heads), **kw), want)

    def test_splits_on_the_cpu(self):
        assert tkern.topk_splits("cpu", 32, 1, packets_per_step=2, block_size=256, m=512,
                                 q_chunk=1, k=8) == tkern.PLAIN_SPLITS
        assert tkern.query_chunks(1) == (1, 1)
        assert tkern.query_chunks(64) == (tkern.MQ_QUERIES_PER_CTA,
                                          64 // tkern.MQ_QUERIES_PER_CTA)
        words = torch.zeros((2, 4, 1 + 16 + 32), dtype=torch.int32)
        v, r = tkern.bscsr_topk_spmv_multiquery(torch.zeros((2, 64)), words, k=3, n_rows=4,
                                                packets_per_step=2, fmt_name="F32",
                                                block_size=32, splits=3)
        assert (v == tkern.NEG_INF).all() and (r == 4).all() and v.shape == (2, 2, 3)


def rows(words, xs, splits=None, table=None, **kw):
    """The card's multi-query walk at Q >= 2, emulated on the CPU."""
    v, r = tkern.bscsr_topk_spmv_multiquery_emulated(
        torch.from_numpy(xs), torch.from_numpy(words), splits=splits, table=table, **kw)
    return v.numpy(), r.numpy()


class TestRowsWalk:
    """The emulation of the card's walk at Q >= 2, which sums a row's
    products in stream order: plain's bits on dyadic data, within 1e-5 of
    them otherwise, and a query's bits independent of S, of the walkers'
    layout (each walks one split of the table) and of the other queries."""

    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("n_cols", [200, 40_000])           # int16 and int32 ids
    @pytest.mark.parametrize("block,t", [(32, 1), (32, 2), (256, 1), (256, 2)])
    def test_dyadic_fixtures_give_plain_bits(self, fmt, n_cols, block, t):
        csr = dyadic_csr(n_rows=150, n_cols=n_cols, seed=block + t, max_len=40,
                         empty_every=7)
        words, slots = fused_words(csr, 3, block, fmt, t)
        value_words = block * tkern.STREAM_FORMATS[fmt].bytes_per_value // 4
        assert words.shape[2] - block // 32 - value_words == (
            block if n_cols > 32767 else block // 2)
        xs = dyadic_queries(5, n_cols, seed=t)
        kw = dict(k=8, n_rows=slots, packets_per_step=t, fmt_name=fmt, block_size=block)
        single = mq_single(words, xs, **kw)
        assert (single[0] > tkern.NEG_INF).any()
        assert_bitwise(rows(words, xs, **kw), single)
        assert_bitwise(rows(words, xs, 5, **kw), single)

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_random_data_within_tolerance(self, fmt):
        csr = split_csr("long", 64, 2000, seed=41, dyadic=False)
        words, tp = split_words(csr, 3, 64, fmt, 2)
        xs = random_queries(6, 2000, seed=42)
        kw = dict(k=8, n_rows=tp.max_slots, packets_per_step=2, fmt_name=fmt, block_size=64)
        got, want = rows(words, xs, **kw), mq_single(words, xs, **kw)
        assert_close_rows(got, want)
        assert not np.array_equal(got[0].view(np.int32), want[0].view(np.int32))

    @pytest.mark.parametrize("splits", [1, 2, 5, 64, 32, 66])
    def test_every_walker_layout_gives_the_same_bits(self, splits):
        """S = 1, 2, 5, 64, and the S of 8 warps x 4 and of 16 warps x 4 + 2
        walkers: each walker walks one split, so only the table matters."""
        csr = split_csr("long", 32, 2000, seed=43, dyadic=False)
        words, tp = split_words(csr, 3, 32, "BF16", 2)
        xs = random_queries(4, 2000, seed=44)
        kw = dict(k=8, n_rows=tp.max_slots, packets_per_step=2, fmt_name="BF16",
                  block_size=32)
        assert_bitwise(rows(words, xs, splits, **kw), rows(words, xs, **kw))

    def test_a_querys_bits_do_not_depend_on_q(self):
        csr = split_csr("long", 32, 2000, seed=45, dyadic=False)
        words, tp = split_words(csr, 3, 32, "Q15", 2)
        xs = random_queries(37, 2000, seed=46)
        kw = dict(k=8, n_rows=tp.max_slots, packets_per_step=2, fmt_name="Q15",
                  block_size=32)
        full = rows(words, xs, 5, **kw)
        eight = rows(words, np.ascontiguousarray(xs[:8]), **kw)
        assert_bitwise((full[0][:, :8], full[1][:, :8]), eight)
        two = rows(words, np.ascontiguousarray(xs[30:32]), 2, **kw)
        assert_bitwise((full[0][:, 30:32], full[1][:, 30:32]), two)

    def test_signed_zero_scores_at_k12(self):
        words, slots, xs = TestDyadicBitIdentical.signed_zero_fixture()
        kw = dict(k=12, n_rows=slots, packets_per_step=1, fmt_name="Q7", block_size=32)
        single = mq_single(words, xs, **kw)
        assert (single[0] == 0).any()
        for splits in (None, 2, 5, 64):
            got = rows(words, xs, splits, **kw)
            assert_bitwise(got, single)
            assert not np.signbit(got[0][got[0] == 0]).any()

    @pytest.mark.parametrize("t", [1, 2])
    def test_a_row_of_150_nnz_across_steps(self, t):
        rng = np.random.default_rng(47)
        lens = np.array([3, 150, 2, 0, 5, 1, 4])
        indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        idx = np.concatenate([np.sort(rng.choice(200, n, replace=False))
                              for n in lens if n]).astype(np.int32)
        data = rng.standard_normal(int(lens.sum())).astype(np.float32)
        csr = jbscsr.CSRMatrix(indptr, idx, data, (7, 200))
        words, slots = fused_words(csr, 3, 32, "F32", t)
        xs = random_queries(3, 200, seed=48)
        kw = dict(k=8, n_rows=slots, packets_per_step=t, fmt_name="F32", block_size=32)
        got = rows(words, xs, **kw)
        for splits in (2, 5, 64):
            assert_bitwise(rows(words, xs, splits, **kw), got)
        # The long row (slot 1 of core 0) against its products summed in
        # stream order within each step, the steps' pieces then chained.
        v = data[3:153].astype(np.float32)
        prods = (v * xs[:, idx[3:153]]).astype(np.float32)
        step = 32 * t
        first = step - 3                         # nnz of the row in the first step
        cuts = [0, first] + list(range(first + step, 150, step)) + [150]
        score = np.zeros(3, np.float32)
        for i, (a, b) in enumerate(zip(cuts, cuts[1:])):
            piece = np.zeros(3, np.float32)
            for j in range(a, b):
                piece = (piece + prods[:, j]).astype(np.float32)
            score = piece if i == 0 else (piece + score).astype(np.float32)
        want = (score + np.float32(0.0)).astype(np.float32)
        hit = got[1][0] == 1
        assert hit.sum() == 3                    # every query kept the long row
        np.testing.assert_array_equal(got[0][0][hit].view(np.int32),
                                      want[hit.any(-1)].view(np.int32))

    def test_chunks_walks_and_splits_on_the_cpu(self):
        assert tkern.query_chunks(1, 512) == (1, 1)
        assert tkern.query_chunks(2, 512) == (2, 1)
        assert tkern.query_chunks(64, 512) == (64, 1)
        assert tkern.query_chunks(65, 512) == (33, 2)
        assert tkern.query_chunks(100, 2048) == (15, 7)          # 16 a block at m = 2048
        assert tkern.query_chunks(100, 40_000) == (50, 2)        # x from global memory
        assert tkern.multiquery_walk(1) == "chunks1"
        assert tkern.multiquery_walk(2) == tkern.multiquery_walk(64) == "rows"
        for q_chunk in (1, 8, 64):
            assert tkern.topk_splits("cpu", 32, 1, packets_per_step=2, block_size=256,
                                     m=512, q_chunk=q_chunk, k=8) == tkern.PLAIN_SPLITS
        assert tkern.topk_splits("meta", 32, 1, packets_per_step=2, block_size=256, m=512,
                                 q_chunk=64, k=8) == 1


def single(words, x, splits=None, table=None, **kw):
    """The single-query wrapper on the CPU: the plain split walk."""
    v, r = tkern.bscsr_topk_spmv(torch.from_numpy(x), torch.from_numpy(words), splits=splits,
                                 table=table, **kw)
    return v.numpy(), r.numpy()


def single_walk(words, x, **kw):
    """The single walk: the plain version with no splits and no table."""
    v, r = tkern.bscsr_topk_spmv_plain(torch.from_numpy(x), torch.from_numpy(words), **kw)
    return v.numpy(), r.numpy()


def flagged_steps(words, t, block, header=0):
    """The most steps holding a flag bit on any core."""
    flags = words[..., header : header + block // 32] != 0
    return int(flags.reshape(words.shape[0], -1, t * (block // 32)).any(-1).sum(-1).max())


def tagged_words(csr, formats, block, t):
    """The one width-class group of a snapshot whose cores take ``formats``."""
    tp = tops.pack_partitions(csr, len(formats), block, packets_multiple=t,
                              stream_layout="fused", value_formats=formats)
    (g,) = tp.groups
    return np.ascontiguousarray(g.words), g.class_name, tp


# One width class each: TAG2 holds BF16 and Q15 cores in one stream.
TAGGED = {"TAG4": ("F32",) * 3, "TAG2": ("BF16", "Q15", "BF16"), "TAG1": ("Q7",) * 3}


class TestSingleSplit:
    """The single-query kernel's split walk (S blocks per core, each with its
    own scratchpad, joined in order by the multi-query kernel's fold at one
    query) equals the single walk bit for bit, on random data too: it is
    the specification the CUDA kernel is transcribed from."""

    @pytest.mark.parametrize("fmt", FORMATS + list(TAGGED))
    @pytest.mark.parametrize("block,t", [(32, 1), (64, 2)])
    def test_split_walk_equals_single_walk(self, fmt, block, t):
        for kind, dyadic in (("long", False), ("aligned", False), ("long", True)):
            csr = split_csr(kind, block, 2000, seed=block + t + len(fmt), dyadic=dyadic)
            if fmt in TAGGED:
                words, fmt_name, tp = tagged_words(csr, TAGGED[fmt], block, t)
                header = 1
            else:
                words, tp = split_words(csr, 3, block, fmt, t)
                fmt_name, header = fmt, 0
            kw = dict(k=8, n_rows=tp.max_slots, packets_per_step=t, fmt_name=fmt_name,
                      block_size=block)
            x = (dyadic_queries(1, 2000, seed=t) if dyadic
                 else random_queries(1, 2000, seed=t))[0]
            want = single_walk(words, x, **kw)
            assert (want[0] > tkern.NEG_INF).any()
            past = flagged_steps(words, t, block, header) + 3   # more splits than steps
            for splits in (1, 2, 3, 5, past):
                assert_bitwise(single(words, x, splits, **kw), want)

    @pytest.mark.parametrize("splits", [2, 5, 64])
    def test_all_negative_padded_budget(self, splits):
        """Every score < 0, a slot budget past the live count and flag-free
        padding steps (cut at e_c): no phantom slot enters the scratchpad."""
        csr = split_csr("long", 32, 64, seed=3, sign=-1, dyadic=True)
        words, tp = split_words(csr, 2, 32, "Q7", 2, pad_steps=4)
        x = dyadic_queries(1, 64, seed=4, positive=True)[0]
        kw = dict(k=8, n_rows=4 * tp.max_slots, packets_per_step=2, fmt_name="Q7",
                  block_size=32)
        want = single_walk(words, x, **kw)
        got = single(words, x, splits, **kw)
        assert_bitwise(got, want)
        filled = got[0] > tkern.NEG_INF
        assert (got[0][filled] <= 0).all() and (got[0][filled] < 0).any()
        assert (got[1][~filled] == kw["n_rows"]).all()
        live = np.append(np.asarray(tp.candidate_slots), 0)
        for c in range(words.shape[0]):
            assert (got[1][c][filled[c]] < live[c]).all()

    @pytest.mark.parametrize("t", [1, 2])
    def test_row_spanning_packets_and_short_cores(self, t):
        rng = np.random.default_rng(6)
        lens = np.array([3, 150, 2, 0, 5, 1, 4])
        indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        idx = np.concatenate([np.sort(rng.choice(200, n, replace=False))
                              for n in lens if n]).astype(np.int32)
        data = (rng.integers(-128, 128, int(lens.sum())) / 128.0).astype(np.float32)
        csr = jbscsr.CSRMatrix(indptr, idx, data, (7, 200))
        words, slots = fused_words(csr, 3, 32, "Q15", t)
        x = dyadic_queries(1, 200, seed=7)[0]
        kw = dict(k=8, n_rows=slots, packets_per_step=t, fmt_name="Q15", block_size=32)
        want = single_walk(words, x, **kw)
        assert (want[1] == slots).any()
        for splits in (2, 5, 64):
            assert_bitwise(single(words, x, splits, **kw), want)

    @pytest.mark.parametrize("splits", [2, 5, 64])
    def test_signed_zero_scores(self, splits):
        words, slots, xs = TestDyadicBitIdentical.signed_zero_fixture()
        kw = dict(k=12, n_rows=slots, packets_per_step=1, fmt_name="Q7", block_size=32)
        for x in xs:
            want = single_walk(words, x, **kw)
            assert_bitwise(single(words, x, splits, **kw), want)
        assert (want[0] == 0).any()

    def test_poisoned_padding_ids(self):
        csr = split_csr("long", 32, 64, seed=10, dyadic=True)
        words, tp = split_words(csr, 2, 32, "BF16", 2, flagless_core=False)
        dirty = poison_padding(words, 32, "BF16", np.asarray(tp.candidate_slots))
        assert not np.array_equal(dirty, words)
        x = random_queries(1, 64, seed=11)[0]
        kw = dict(k=8, n_rows=tp.max_slots, packets_per_step=2, fmt_name="BF16",
                  block_size=32)
        want = single_walk(words, x, **kw)
        for splits in (2, 5, 64):
            assert_bitwise(single(dirty, x, splits, **kw), want)

    @pytest.mark.parametrize("splits", [2, 3, 7, 64])
    def test_ties_at_the_kth_place_across_splits(self, splits):
        """Most rows score exactly 3/8 at x = 1: the k-th place is a tie that
        the fold must break by the lower slot across every split boundary,
        and the head rows tie too; then a query with half weights."""
        rng = np.random.default_rng(30)
        lens = np.full(90, 3)
        lens[::11] = rng.integers(40, 70, size=len(lens[::11]))
        lens[5::13] = 4
        indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        idx = np.concatenate([np.sort(rng.choice(80, int(n), replace=False))
                              for n in lens]).astype(np.int32)
        data = np.full(int(lens.sum()), 1 / 8, np.float32)
        data[np.repeat(lens > 4, lens)] = -1 / 128
        csr = tbscsr.CSRMatrix(indptr, idx, data, (len(lens), 80))
        words, tp = split_words(csr, 2, 32, "F32", 1)
        kw = dict(k=8, n_rows=tp.max_slots, packets_per_step=1, fmt_name="F32",
                  block_size=32)
        bounds, _ = tkern.spmv_split_table(torch.from_numpy(words), packets_per_step=1,
                                           block_size=32, splits=splits)
        assert (bounds[:2, 1] < bounds[:2, -1]).all()               # more than one split
        for scale in (1.0, 0.5):
            x = np.ones(80, np.float32)
            x[::2] = scale
            want = single_walk(words, x, **kw)
            if scale == 1.0:
                assert (want[0][:2, -1] == 3 / 8).all()             # the k-th place ties
            assert_bitwise(single(words, x, splits, **kw), want)

    @pytest.mark.parametrize("fmt", ["BF16", "Q7"])
    def test_wrapper_on_the_cpu_against_pallas(self, fmt):
        """The wrapper with neither splits nor a table walks PLAIN_SPLITS splits
        on the CPU; against the reference's Pallas kernel (interpret mode) it
        is bit for bit on dyadic data and within rtol = atol = 1e-5 (the
        reference's tolerance between summation orders) on random data."""
        csr = dyadic_csr(n_rows=150, seed=33, max_len=40, empty_every=6)
        words, slots = fused_words(csr, 2, 32, fmt, 2)
        bounds, _ = tkern.spmv_split_table(torch.from_numpy(words), packets_per_step=2,
                                           block_size=32, splits=tkern.PLAIN_SPLITS)
        assert (bounds[:, 2] < bounds[:, -1]).all()                 # the fold joins splits
        kw = dict(k=8, n_rows=slots, packets_per_step=2, fmt_name=fmt, block_size=32)
        xs = dyadic_queries(1, 64, seed=34)
        assert_bitwise(plain(xs, words, False, **kw), pallas(xs, words, False, **kw))
        rand = jbscsr.synthetic_embedding_csr(300, 64, 9, "gamma", seed=35)
        words, slots = fused_words(rand, 2, 32, fmt, 2)
        kw["n_rows"] = slots
        xs = random_queries(1, 64, seed=36)
        assert_close_rows(plain(xs, words, False, **kw), pallas(xs, words, False, **kw))

    def test_splits_and_executor_tables_on_the_cpu(self):
        """S is PLAIN_SPLITS on the CPU; the executor's single-query path walks
        a split table built once per snapshot, with no upload."""
        from repro_torch.core import topk_spmv as ttopk
        from repro_torch.kernels import executor as texec

        assert tkern.single_splits("cpu", 32, packets_per_step=2, block_size=256, m=512,
                                   k=8, width=264, fmt_name="BF16") == tkern.PLAIN_SPLITS
        words = torch.zeros((2, 4, 1 + 16 + 32), dtype=torch.int32)
        v, r = tkern.bscsr_topk_spmv(torch.zeros(64), words, k=3, n_rows=4,
                                     packets_per_step=2, fmt_name="F32", block_size=32)
        assert (v == tkern.NEG_INF).all() and (r == 4).all() and v.shape == (2, 3)
        csr = dyadic_csr(n_rows=200, seed=37, max_len=30)
        cfg = ttopk.TopKSpMVConfig(big_k=10, k=8, num_partitions=2, block_size=32,
                                   device="cpu")
        idx = ttopk.build_index(tbscsr.CSRMatrix(csr.indptr, csr.indices, csr.data,
                                                 csr.shape), cfg)
        ex = texec.QueryExecutor(big_k=10, k=8, device="cpu")
        x = torch.from_numpy(dyadic_queries(1, 64, seed=38)[0])
        tkern.reset_launch_counts()
        first = ex.query(x, idx.packed)
        snap = texec.device_snapshot(idx.packed, "fused", "cpu")
        tables = dict(snap._split_tables)
        pins = ex.h2d_copies
        for _ in range(2):
            assert_bitwise(tuple(t.numpy() for t in ex.query(x, idx.packed)),
                           tuple(t.numpy() for t in first))
        assert ex.h2d_copies == pins and ex.retraces == 0
        assert list(snap._split_tables) == list(tables) == [(2, tkern.PLAIN_SPLITS)]
        assert all(snap._split_tables[key] is tables[key] for key in tables)
        want = ttopk.topk_spmv(idx, x, use_kernel=False)
        assert_bitwise(tuple(t.numpy() for t in first), tuple(t.numpy() for t in want))
        assert tkern.bscsr_topk_spmv.launches == 0


class TestWrapperRules:
    def test_inner_loops_and_gather_modes_share_one_rule(self):
        csr = dyadic_csr(seed=16)
        words, slots = fused_words(csr, 2, 32, "Q7", 2)
        xs = dyadic_queries(1, 64, seed=17)
        kw = dict(k=8, n_rows=slots, packets_per_step=2, fmt_name="Q7", block_size=32)
        base = plain(xs, words, False, **kw)
        for loop in tkern.INNER_LOOPS:
            for gather in tkern.GATHER_MODES:
                assert_bitwise(base, plain(xs, words, False, inner_loop=loop,
                                           gather_mode=gather, **kw))
        with pytest.raises(ValueError):
            plain(xs, words, False, inner_loop="quadratic", **kw)

    def test_cpu_tensors_never_launch(self):
        csr = dyadic_csr(seed=18)
        words, slots = fused_words(csr, 2, 32, "F32", 2)
        xs = dyadic_queries(2, 64, seed=19)
        tkern.reset_launch_counts()
        kw = dict(k=8, n_rows=slots, packets_per_step=2, fmt_name="F32", block_size=32)
        plain(xs, words, False, **kw)
        plain(xs, words, True, **kw)
        assert tkern.bscsr_topk_spmv.launches == 0
        assert tkern.bscsr_topk_spmv_multiquery.launches == 0

    def test_non_cpu_tensors_take_the_kernel_route_or_raise(self):
        """A query off the CPU never drops to the plain version."""
        csr = dyadic_csr(seed=20)
        words, slots = fused_words(csr, 2, 32, "F32", 2)
        x = torch.zeros(64, device="meta")
        with pytest.raises(ValueError, match="meta"):
            tkern.bscsr_topk_spmv(x, torch.from_numpy(words), k=8, n_rows=slots,
                                  packets_per_step=2, fmt_name="F32", block_size=32)
        assert tkern.bscsr_topk_spmv.launches == 0

    def test_rejects_bad_geometry(self):
        words = torch.zeros((1, 3, 1 + 16 + 32), dtype=torch.int32)
        with pytest.raises(ValueError, match="multiple of packets_per_step"):
            tkern.bscsr_topk_spmv(torch.zeros(8), words, k=2, n_rows=1,
                                  packets_per_step=2, fmt_name="F32", block_size=32)
        with pytest.raises(ValueError, match="width"):
            tkern.bscsr_topk_spmv(torch.zeros(8), words[..., :-1].contiguous(), k=2,
                                  n_rows=1, packets_per_step=1, fmt_name="F32",
                                  block_size=32)


class TestOracles:
    """The port's torch oracles against ``repro.kernels.ref``."""

    def test_row_scores_and_stacked_topk(self):
        from repro.kernels import ref as jref
        from repro_torch.kernels import ref as tref

        csr = dyadic_csr(n_rows=60, seed=22, empty_every=5, sign=-1)
        jp = jops.pack_partitions(csr, 3, 32, "Q15", packets_multiple=2)
        tp = tops.pack_partitions(
            tbscsr.CSRMatrix(csr.indptr, csr.indices, csr.data, csr.shape), 3, 32, "Q15",
            packets_multiple=2)
        x = dyadic_queries(1, 64, seed=23, positive=True)[0]
        vals, cols, flags = (tops.host_tensor(a, "cpu") for a in (tp.vals, tp.cols,
                                                                   tp.flags))
        a = jref.bscsr_row_scores(jnp.asarray(jp.vals[0]), jnp.asarray(jp.cols[0]),
                                  jnp.asarray(jp.flags[0]), jnp.asarray(x), 20, "Q15")
        b = tref.bscsr_row_scores(vals[0], cols[0], flags[0], torch.from_numpy(x), 20,
                                  "Q15")
        np.testing.assert_array_equal(np.asarray(a).view(np.int32), b.numpy().view(np.int32))
        budget = 2 * tp.max_slots                      # phantom slots past the live count
        rows = np.asarray(tp.candidate_slots)
        a = jref.bscsr_topk_ref_stacked(jnp.asarray(jp.vals), jnp.asarray(jp.cols),
                                        jnp.asarray(jp.flags), jnp.asarray(x),
                                        jnp.asarray(rows), budget, 8, "Q15")
        b = tref.bscsr_topk_ref_stacked(vals, cols, flags, torch.from_numpy(x),
                                        torch.from_numpy(rows), budget, 8, "Q15")
        assert_bitwise(tuple(np.asarray(t) for t in a), tuple(t.numpy() for t in b))
        assert (np.asarray(a[1]) < rows[:, None]).all()   # no phantom slot admitted

    @pytest.mark.parametrize("n,big_k", [(30, 8), (5, 8)])
    def test_topk_sorted_ties(self, n, big_k):
        from repro.kernels import ref as jref
        from repro_torch.kernels import ref as tref

        scores = (np.random.default_rng(n).integers(-2, 3, size=n) / 2).astype(np.float32)
        scores[::4] = -0.0
        a = jref.topk_sorted(jnp.asarray(scores), big_k)
        b = tref.topk_sorted(torch.from_numpy(scores), big_k)
        assert_bitwise(tuple(np.asarray(t) for t in a), tuple(t.numpy() for t in b))
