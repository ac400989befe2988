"""The CUDA kernels on the card, against their plain PyTorch versions.

Run on a machine with a CUDA device:

    python -m pytest -q tests/test_torch_gpu.py

This file imports only ``repro_torch`` (no jax), so it runs where the
reference package cannot.  Every test is marked ``gpu`` and skips, with the
reason, where ``torch.cuda.is_available()`` is false.  Dyadic fixtures
(values on a 2**-7 grid, queries on a 2**-3 grid) are exact in f32 in any
summation order, so kernel and plain version must agree bit for bit.

The tagged width classes of mixed-precision snapshots (TAG4, TAG2 with
BF16 and Q15 cores in one launch, TAG1) run through all three kernels
against their plain versions and against the same snapshot's f32 twins
streamed as one F32 stream.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import bscsr
from repro_torch.core import topk_spmv as api
from repro_torch.core.quantization import FORMAT_BY_CODE
from repro_torch.core.similarity import SparseEmbeddingIndex
from repro_torch.kernels import bscsr_topk_spmv as K
from repro_torch.kernels import ops

FORMATS = ["F32", "BF16", "Q15", "Q7"]
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


def dyadic_csr(n_rows, n_cols, seed, empty_every=9):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 13, size=n_rows)
    lens[::empty_every] = 0
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.concatenate([np.sort(rng.choice(n_cols, n, replace=False))
                          for n in lens if n]).astype(np.int32)
    data = (rng.integers(-128, 128, int(lens.sum())) / 128.0).astype(np.float32)
    return bscsr.CSRMatrix(indptr, idx, data, (n_rows, n_cols))


def to_np(pair):
    return tuple(t.cpu().numpy() for t in pair)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("block,t,n_cols", [(32, 1, 64), (256, 2, 512), (64, 2, 40_000)])
def test_kernels_match_plain_bitwise(cuda, fmt, block, t, n_cols):
    csr = dyadic_csr(400, n_cols, seed=block + t)
    packed = ops.pack_partitions(csr, 4, block, fmt, packets_multiple=t,
                                 stream_layout="fused")
    kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=t, fmt_name=fmt,
              block_size=block)
    w = torch.from_numpy(packed.words)
    rng = np.random.default_rng(t)
    for q in (1, 3, 64):
        xs = torch.from_numpy((rng.integers(-16, 17, (q, n_cols)) / 8.0).astype(np.float32))
        if q == 1:
            want = K.bscsr_topk_spmv(xs[0], w, **kw)
            got = K.bscsr_topk_spmv(xs[0].to(cuda), w.to(cuda), **kw)
        else:
            want = K.bscsr_topk_spmv_multiquery_plain(xs, w, **kw)
            got = K.bscsr_topk_spmv_multiquery(xs.to(cuda), w.to(cuda), **kw)
        torch.cuda.synchronize()
        (gv, gr), (wv, wr) = to_np(got), to_np(want)
        np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))
        np.testing.assert_array_equal(gr, wr)


def test_main_path_on_the_card(cuda):
    csr = bscsr.synthetic_embedding_csr(20_000, 128, 12, "gamma", seed=3)
    svc = SparseEmbeddingIndex(csr, api.TopKSpMVConfig(
        big_k=20, k=8, value_format="BF16", num_partitions=8, device="cuda"))
    xs = np.random.default_rng(4).standard_normal((8, 128)).astype(np.float32)
    svc.query(xs[0])
    api.topk_spmv(svc.index, torch.from_numpy(xs[0]).to(cuda))
    copies = svc.dispatch_info()["h2d_copies"]
    K.reset_launch_counts()
    v, r = svc.query_batch(xs)
    one = api.topk_spmv(svc.index, torch.from_numpy(xs[0]).to(cuda))
    assert K.bscsr_topk_spmv.launches == 1
    assert K.bscsr_topk_spmv_multiquery.launches == 1
    assert svc.dispatch_info()["h2d_copies"] == copies
    ov, orow = svc.query_batch(xs, use_kernel=False)
    np.testing.assert_allclose(v, ov, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(r, orow)
    np.testing.assert_array_equal(one[1].cpu().numpy(), r[0])


def test_kernel_route_never_takes_host_queries(cuda):
    csr = dyadic_csr(50, 64, seed=5)
    packed = ops.pack_partitions(csr, 2, 32, "F32", stream_layout="fused")
    with pytest.raises(ValueError, match="cpu"):
        K.bscsr_topk_spmv(torch.zeros(64), torch.from_numpy(packed.words).to(cuda), k=8,
                          n_rows=packed.max_slots, fmt_name="F32", block_size=32)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("block,t,n_cols", [(32, 1, 64), (256, 2, 512), (64, 2, 40_000)])
def test_accumulate_kernel_matches_plain_bitwise(cuda, fmt, block, t, n_cols):
    """Slot sums bit for bit, with a slot budget padded past the live count
    and flag-free padding packets: slots that never complete read 0.0."""
    csr = dyadic_csr(400, n_cols, seed=block + t + 1)
    packed = ops.pack_partitions(csr, 4, block, fmt, packets_multiple=t,
                                 stream_layout="fused")
    words = np.concatenate(
        [packed.words, np.zeros((4, 2 * t, packed.words.shape[2]), np.int32)], 1)
    n_rows = 2 * packed.max_slots
    kw = dict(n_rows=n_rows, packets_per_step=t, fmt_name=fmt, block_size=block)
    x = torch.from_numpy((np.random.default_rng(t).integers(-16, 17, n_cols) / 8.0)
                         .astype(np.float32))
    w = torch.from_numpy(words)
    want = K.bscsr_spmv(x, w, **kw)
    got = K.bscsr_spmv(x.to(cuda), w.to(cuda), **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                  want.numpy().view(np.int32))
    live = np.asarray(packed.candidate_slots)
    assert (want.numpy()[np.arange(n_rows)[None, :] >= live[:, None]] == 0).all()


def long_row_csr(n_rows, n_cols, block, seed, dyadic):
    """Empty rows and, every ninth row, one over five packets."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 13, size=n_rows)
    lens[::7] = 0
    lens[4::9] = rng.integers(5 * block + 1, 6 * block, size=len(lens[4::9]))
    lens = np.minimum(lens, n_cols)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.concatenate([np.sort(rng.choice(n_cols, int(n), replace=False))
                          for n in lens if n]).astype(np.int32)
    n = int(lens.sum())
    data = (rng.integers(-128, 128, n) / 128.0 if dyadic else rng.standard_normal(n))
    return bscsr.CSRMatrix(indptr, idx, data.astype(np.float32), (n_rows, n_cols))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("block,t,n_cols", [(32, 1, 2000), (256, 2, 2000), (64, 2, 40_000)])
def test_split_kernel_matches_one_split_bitwise(cuda, fmt, block, t, n_cols):
    """Random data: every S gives the one-block walk's bits (the kernel's
    scans are one tree at every S, so the fix-up is the only join)."""
    csr = long_row_csr(300, n_cols, block, seed=block + t, dyadic=False)
    packed = ops.pack_partitions(csr, 4, block, fmt, packets_multiple=t,
                                 stream_layout="fused")
    w = torch.from_numpy(packed.words).to(cuda)
    x = torch.from_numpy(np.random.default_rng(t).standard_normal(n_cols)
                         .astype(np.float32)).to(cuda)
    kw = dict(n_rows=packed.max_slots, packets_per_step=t, fmt_name=fmt, block_size=block)
    one = K.bscsr_spmv(x, w, splits=1, **kw)
    assert float(one.abs().max()) > 0
    for splits in (None, 2, 5, 64):
        got = K.bscsr_spmv(x, w, splits=splits, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), one.view(torch.int32)), splits
    np.testing.assert_allclose(one.cpu().numpy(),
                               K.bscsr_spmv_plain(x, w, **kw).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt", FORMATS)
def test_split_kernel_matches_plain_bitwise_on_a_padded_budget(cuda, fmt):
    """Dyadic data, flag-free padding steps and a doubled slot budget: the
    split kernel equals the plain walk bit for bit and leaves every slot that
    never completes at +0.0."""
    csr = long_row_csr(200, 512, 32, seed=7, dyadic=True)
    packed = ops.pack_partitions(csr, 4, 32, fmt, packets_multiple=2,
                                 stream_layout="fused")
    words = np.concatenate(
        [packed.words, np.zeros((4, 8, packed.words.shape[2]), np.int32)], 1)
    n_rows = 2 * packed.max_slots
    kw = dict(n_rows=n_rows, packets_per_step=2, fmt_name=fmt, block_size=32)
    x = torch.from_numpy((np.random.default_rng(8).integers(-16, 17, 512) / 8.0)
                         .astype(np.float32))
    w = torch.from_numpy(words)
    want = K.bscsr_spmv(x, w, **kw).numpy()
    live = np.asarray(packed.candidate_slots)
    never = np.arange(n_rows)[None, :] >= live[:, None]
    for splits in (None, 1, 3, 64):
        got = K.bscsr_spmv(x.to(cuda), w.to(cuda), splits=splits, **kw)
        torch.cuda.synchronize()
        got = got.cpu().numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        assert (got.view(np.int32)[never] == 0).all()


def test_split_kernel_counts_one_launch_per_call(cuda):
    csr = long_row_csr(100, 256, 32, seed=9, dyadic=True)
    packed = ops.pack_partitions(csr, 2, 32, "F32", packets_multiple=2,
                                 stream_layout="fused")
    w = torch.from_numpy(packed.words).to(cuda)
    x = torch.ones(256, device=cuda)
    kw = dict(n_rows=packed.max_slots, packets_per_step=2, fmt_name="F32", block_size=32)
    table = K.spmv_split_table(w, packets_per_step=2, block_size=32, splits=4)
    K.reset_launch_counts()
    K.bscsr_spmv(x, w, **kw)
    K.bscsr_spmv(x, w, splits=1, **kw)
    K.bscsr_spmv(x, w, table=table, **kw)
    torch.cuda.synchronize()
    assert K.bscsr_spmv.launches == 3
    assert K.bscsr_topk_spmv.launches == K.bscsr_topk_spmv_multiquery.launches == 0
    assert K.spmv_splits(cuda, 2, packets_per_step=2, block_size=32, m=256) >= 1


def mq_queries(q, n_cols, seed, dyadic):
    rng = np.random.default_rng(seed)
    xs = rng.integers(-16, 17, (q, n_cols)) / 8.0 if dyadic else rng.standard_normal((q, n_cols))
    return torch.from_numpy(xs.astype(np.float32))


def assert_same_bits(got, want, what):
    (gv, gr), (wv, wr) = to_np(got), to_np(want)
    np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32), err_msg=what)
    np.testing.assert_array_equal(gr, wr, err_msg=what)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("block,t,n_cols", [(32, 1, 2000), (256, 2, 2000), (64, 2, 40_000)])
def test_mq_split_kernel_matches_one_split_bitwise(cuda, fmt, block, t, n_cols):
    """Random data: the multi-query kernel at the card's S and at S = 64
    gives its S = 1 bits (one shuffle tree at every S; the fold is exact),
    at every chunk width."""
    csr = long_row_csr(300, n_cols, block, seed=block + t + 2, dyadic=False)
    packed = ops.pack_partitions(csr, 4, block, fmt, packets_multiple=t,
                                 stream_layout="fused")
    w = torch.from_numpy(packed.words).to(cuda)
    kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=t, fmt_name=fmt,
              block_size=block)
    for q in (1, 3, 8, 64):
        xs = mq_queries(q, n_cols, seed=q + t, dyadic=False).to(cuda)
        one = K.bscsr_topk_spmv_multiquery(xs, w, splits=1, **kw)
        for splits in (None, 2, 64):
            got = K.bscsr_topk_spmv_multiquery(xs, w, splits=splits, **kw)
            torch.cuda.synchronize()
            assert_same_bits(got, one, f"Q={q} S={splits}")
        want = K.bscsr_topk_spmv_multiquery_plain(xs, w, **kw)
        np.testing.assert_allclose(one[0].cpu().numpy(), want[0].cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt", FORMATS)
def test_mq_split_kernel_matches_plain_bitwise_on_a_padded_budget(cuda, fmt):
    """Dyadic data, flag-free padding steps and a doubled slot budget: every
    S gives the plain walk's bits, and no phantom slot enters."""
    csr = long_row_csr(200, 512, 32, seed=11, dyadic=True)
    packed = ops.pack_partitions(csr, 4, 32, fmt, packets_multiple=2,
                                 stream_layout="fused")
    words = np.concatenate(
        [packed.words, np.zeros((4, 8, packed.words.shape[2]), np.int32)], 1)
    n_rows = 2 * packed.max_slots
    kw = dict(k=8, n_rows=n_rows, packets_per_step=2, fmt_name=fmt, block_size=32)
    w = torch.from_numpy(words)
    live = np.asarray(packed.candidate_slots)
    for q in (1, 5, 16):
        xs = mq_queries(q, 512, seed=q, dyadic=True)
        want = K.bscsr_topk_spmv_multiquery_plain(xs, w, **kw)
        for splits in (None, 1, 3, 64):
            got = K.bscsr_topk_spmv_multiquery(xs.to(cuda), w.to(cuda), splits=splits, **kw)
            torch.cuda.synchronize()
            assert_same_bits(got, want, f"Q={q} S={splits}")
            gv, gr = to_np(got)
            filled = gv > K.NEG_INF
            assert (gr[filled] < np.broadcast_to(live[:, None, None], gr.shape)[filled]).all()


def test_mq_split_kernel_counts_one_launch_per_call(cuda):
    csr = long_row_csr(100, 256, 32, seed=12, dyadic=True)
    packed = ops.pack_partitions(csr, 2, 32, "F32", packets_multiple=2,
                                 stream_layout="fused")
    w = torch.from_numpy(packed.words).to(cuda)
    xs = torch.ones((3, 256), device=cuda)
    kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=2, fmt_name="F32",
              block_size=32)
    table = K.spmv_split_table(w, packets_per_step=2, block_size=32, splits=4)
    K.reset_launch_counts()
    K.bscsr_topk_spmv_multiquery(xs, w, **kw)
    K.bscsr_topk_spmv_multiquery(xs, w, splits=1, **kw)
    K.bscsr_topk_spmv_multiquery(xs, w, table=table, **kw)
    torch.cuda.synchronize()
    assert K.bscsr_topk_spmv_multiquery.launches == 3
    assert K.bscsr_topk_spmv.launches == K.bscsr_spmv.launches == 0
    assert K.topk_splits(cuda, 2, 1, packets_per_step=2, block_size=32, m=256, q_chunk=3,
                         k=8) >= 1


def test_mq_split_kernel_breaks_ties_at_the_kth_place_like_plain(cuda):
    """Every row scores 3/8, 1/2 or below 0 at x = 1, and more than k rows a
    core score 1/2, so the whole scratchpad is a tie broken by the lower
    slot in every split, in the fold and against the kernel's admission
    threshold (which may lag the step start)."""
    rng = np.random.default_rng(30)
    lens = np.full(400, 3)
    lens[::11] = rng.integers(40, 70, size=len(lens[::11]))
    lens[5::13] = 4
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.concatenate([np.sort(rng.choice(80, int(n), replace=False))
                          for n in lens]).astype(np.int32)
    data = np.full(int(lens.sum()), 1 / 8, np.float32)
    data[np.repeat(lens > 4, lens)] = -1 / 128
    csr = bscsr.CSRMatrix(indptr, idx, data, (len(lens), 80))
    packed = ops.pack_partitions(csr, 2, 32, "F32", packets_multiple=1,
                                 stream_layout="fused")
    w = torch.from_numpy(packed.words)
    xs = torch.ones((3, 80))
    xs[1, ::2] = 0.5
    xs[2] = 2.0
    kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=1, fmt_name="F32",
              block_size=32)
    want = K.bscsr_topk_spmv_multiquery_plain(xs, w, **kw)
    assert (want[0][:, 0] == 0.5).all()
    for splits in (None, 1, 3, 64):
        got = K.bscsr_topk_spmv_multiquery(xs.to(cuda), w.to(cuda), splits=splits, **kw)
        torch.cuda.synchronize()
        assert_same_bits(got, want, f"S={splits}")


@pytest.mark.parametrize("k", [2, 8])
def test_mq_split_kernel_holds_plain_bits_over_repeated_calls(cuda, k):
    """One-nnz rows whose scores climb slowly with noise, 16 warps a block:
    every step brings candidates that shift the scratchpads while other
    warps may still admit the previous step's rows near the k-th place.
    Admission must never read a half-shifted scratchpad, whose last entry
    passes through values above the finished state's, which would drop a
    row the plain walk keeps.  Such a fault shows only now and then, so the
    kernel runs many times against the plain bits."""
    rng = np.random.default_rng(50 + k)
    n_rows, n_cols = 20_000, 512
    indptr = np.arange(n_rows + 1, dtype=np.int64)
    idx = rng.integers(0, n_cols, n_rows).astype(np.int32)
    data = ((np.arange(n_rows) // 128 + rng.integers(0, 8, n_rows)) / 64).astype(np.float32)
    csr = bscsr.CSRMatrix(indptr, idx, data, (n_rows, n_cols))
    packed = ops.pack_partitions(csr, 2, 256, "F32", packets_multiple=2,
                                 stream_layout="fused")
    w = torch.from_numpy(packed.words)
    kw = dict(k=k, n_rows=packed.max_slots, packets_per_step=2, fmt_name="F32",
              block_size=256)
    for q in (1, 8):
        xs = torch.from_numpy(2.0 ** rng.integers(-1, 2, (q, n_cols))).float()
        want = [t.to(cuda) for t in K.bscsr_topk_spmv_multiquery_plain(xs, w, **kw)]
        xs, wc = xs.to(cuda), w.to(cuda)
        for splits in (1, 2, 4):
            outs = [K.bscsr_topk_spmv_multiquery(xs, wc, splits=splits, **kw)
                    for _ in range(40)]
            torch.cuda.synchronize()
            bad = [i for i, (v, r) in enumerate(outs)
                   if not (torch.equal(v.view(torch.int32), want[0].view(torch.int32))
                           and torch.equal(r, want[1]))]
            assert not bad, f"Q={q} S={splits}: calls {bad} of 40 differ from plain"


# ---------------------------------------------------------------------------
# The single-query kernel's split walk
# ---------------------------------------------------------------------------

def single_card(x, w, **kw):
    return K.bscsr_topk_spmv(x, w, **kw)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("block,t,n_cols", [(32, 1, 2000), (256, 2, 2000), (64, 2, 40_000)])
def test_single_split_kernel_matches_one_split_bitwise(cuda, fmt, block, t, n_cols):
    """Random data: the single-query kernel at the card's S, at 2 and at 64
    gives its S = 1 bits, and the multi-query kernel's at Q = 1 (the same
    shuffle tree and fold), and S = 1 agrees with plain within 1e-5."""
    csr = long_row_csr(300, n_cols, block, seed=block + t + 3, dyadic=False)
    packed = ops.pack_partitions(csr, 4, block, fmt, packets_multiple=t,
                                 stream_layout="fused")
    w = torch.from_numpy(packed.words).to(cuda)
    kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=t, fmt_name=fmt,
              block_size=block)
    x = mq_queries(1, n_cols, seed=t + 1, dyadic=False).to(cuda)
    one = single_card(x[0], w, splits=1, **kw)
    assert (one[0] > K.NEG_INF).any()
    for splits in (None, 2, 64):
        assert_same_bits(single_card(x[0], w, splits=splits, **kw), one, f"S={splits}")
    for splits in (None, 1):
        mv, mr = K.bscsr_topk_spmv_multiquery(x, w, splits=splits, **kw)
        torch.cuda.synchronize()
        assert_same_bits((mv[:, 0], mr[:, 0]), one, f"multi-query Q=1 S={splits}")
    want = K.bscsr_topk_spmv_plain(x[0], w, **kw)
    np.testing.assert_allclose(one[0].cpu().numpy(), want[0].cpu().numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("block,t,n_cols", [(32, 1, 64), (32, 2, 64), (64, 1, 512),
                                            (64, 2, 40_000), (256, 1, 512), (256, 2, 512)])
def test_single_split_kernel_matches_plain_bitwise(cuda, fmt, block, t, n_cols):
    """Dyadic data at B in {32, 64, 256} and T in {1, 2} (steps of 132 to
    3,136 bytes, most not 16-byte aligned), and with 40,000 columns (x in
    global memory): every S gives the plain single walk's bits."""
    csr = dyadic_csr(400, n_cols, seed=block + 7 * t)
    packed = ops.pack_partitions(csr, 4, block, fmt, packets_multiple=t,
                                 stream_layout="fused")
    w = torch.from_numpy(packed.words)
    kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=t, fmt_name=fmt,
              block_size=block)
    x = mq_queries(1, n_cols, seed=block, dyadic=True)[0]
    want = K.bscsr_topk_spmv_plain(x, w, **kw)
    for splits in (None, 1, 3, 64):
        got = single_card(x.to(cuda), w.to(cuda), splits=splits, **kw)
        torch.cuda.synchronize()
        assert_same_bits(got, want, f"S={splits}")


@pytest.mark.parametrize("fmt", FORMATS)
def test_single_split_kernel_matches_plain_bitwise_on_a_padded_budget(cuda, fmt):
    """All-negative dyadic scores, flag-free padding steps and a doubled slot
    budget: every S gives the plain walk's bits and no phantom slot enters."""
    csr = long_row_csr(200, 512, 32, seed=15, dyadic=True)
    csr = dataclasses.replace(csr, data=-np.abs(csr.data) - 1 / 128)
    packed = ops.pack_partitions(csr, 4, 32, fmt, packets_multiple=2,
                                 stream_layout="fused")
    words = np.concatenate(
        [packed.words, np.zeros((4, 8, packed.words.shape[2]), np.int32)], 1)
    n_rows = 2 * packed.max_slots
    kw = dict(k=8, n_rows=n_rows, packets_per_step=2, fmt_name=fmt, block_size=32)
    w = torch.from_numpy(words)
    x = mq_queries(1, 512, seed=16, dyadic=True)[0].abs() + 0.125
    want = K.bscsr_topk_spmv_plain(x, w, **kw)
    live = np.asarray(packed.candidate_slots)
    for splits in (None, 1, 3, 64):
        got = single_card(x.to(cuda), w.to(cuda), splits=splits, **kw)
        torch.cuda.synchronize()
        assert_same_bits(got, want, f"S={splits}")
        gv, gr = to_np(got)
        filled = gv > K.NEG_INF
        assert (gv[filled] <= 0).all() and (gv[filled] < 0).any()   # empty rows: 0
        assert (gr[filled] < np.broadcast_to(live[:, None], gr.shape)[filled]).all()


def test_single_split_kernel_breaks_ties_at_the_kth_place_like_plain(cuda):
    """The multi-query tie fixture at one query: every row scores 3/8, 1/2
    or below 0 at x = 1, so the scratchpad is a tie broken by the lower slot
    in every split, in the fold and against the lagging threshold."""
    rng = np.random.default_rng(30)
    lens = np.full(400, 3)
    lens[::11] = rng.integers(40, 70, size=len(lens[::11]))
    lens[5::13] = 4
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.concatenate([np.sort(rng.choice(80, int(n), replace=False))
                          for n in lens]).astype(np.int32)
    data = np.full(int(lens.sum()), 1 / 8, np.float32)
    data[np.repeat(lens > 4, lens)] = -1 / 128
    csr = bscsr.CSRMatrix(indptr, idx, data, (len(lens), 80))
    packed = ops.pack_partitions(csr, 2, 32, "F32", packets_multiple=1,
                                 stream_layout="fused")
    w = torch.from_numpy(packed.words)
    kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=1, fmt_name="F32",
              block_size=32)
    for scale in (1.0, 0.5, 2.0):
        x = torch.ones(80)
        x[::2] *= scale
        want = K.bscsr_topk_spmv_plain(x, w, **kw)
        if scale == 1.0:
            assert (want[0][:, 0] == 0.5).all()
        for splits in (None, 1, 3, 64):
            got = single_card(x.to(cuda), w.to(cuda), splits=splits, **kw)
            torch.cuda.synchronize()
            assert_same_bits(got, want, f"x scale {scale} S={splits}")


@pytest.mark.parametrize("k", [2, 8])
def test_single_split_kernel_holds_plain_bits_over_repeated_calls(cuda, k):
    """The multi-query repeated-call fixture at one query, 16 warps a block:
    scores climb slowly with noise, so every step brings candidates while
    other warps may still admit the previous step's rows near the k-th
    place; 40 calls at each S must give the plain bits."""
    rng = np.random.default_rng(60 + k)
    n_rows, n_cols = 20_000, 512
    indptr = np.arange(n_rows + 1, dtype=np.int64)
    idx = rng.integers(0, n_cols, n_rows).astype(np.int32)
    data = ((np.arange(n_rows) // 128 + rng.integers(0, 8, n_rows)) / 64).astype(np.float32)
    csr = bscsr.CSRMatrix(indptr, idx, data, (n_rows, n_cols))
    packed = ops.pack_partitions(csr, 2, 256, "F32", packets_multiple=2,
                                 stream_layout="fused")
    w = torch.from_numpy(packed.words)
    kw = dict(k=k, n_rows=packed.max_slots, packets_per_step=2, fmt_name="F32",
              block_size=256)
    x = torch.from_numpy(2.0 ** rng.integers(-1, 2, n_cols)).float()
    want = [t.to(cuda) for t in K.bscsr_topk_spmv_plain(x, w, **kw)]
    x, wc = x.to(cuda), w.to(cuda)
    for splits in (None, 1, 2, 4):
        outs = [single_card(x, wc, splits=splits, **kw) for _ in range(40)]
        torch.cuda.synchronize()
        bad = [i for i, (v, r) in enumerate(outs)
               if not (torch.equal(v.view(torch.int32), want[0].view(torch.int32))
                       and torch.equal(r, want[1]))]
        assert not bad, f"S={splits}: calls {bad} of 40 differ from plain"


def test_single_split_kernel_counts_one_launch_per_call(cuda):
    """One launch per call at any S (the fold included); S from the
    occupancy calculator fills one wave."""
    csr = long_row_csr(100, 256, 32, seed=17, dyadic=True)
    packed = ops.pack_partitions(csr, 2, 32, "F32", packets_multiple=2,
                                 stream_layout="fused")
    w = torch.from_numpy(packed.words).to(cuda)
    x = torch.ones(256, device=cuda)
    kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=2, fmt_name="F32",
              block_size=32)
    table = K.spmv_split_table(w, packets_per_step=2, block_size=32, splits=4)
    K.reset_launch_counts()
    single_card(x, w, **kw)
    single_card(x, w, splits=1, **kw)
    single_card(x, w, table=table, **kw)
    torch.cuda.synchronize()
    assert K.bscsr_topk_spmv.launches == 3
    assert K.bscsr_topk_spmv_multiquery.launches == K.bscsr_spmv.launches == 0
    splits = K.single_splits(cuda, 2, packets_per_step=2, block_size=32, m=256, k=8,
                             width=w.shape[2], fmt_name="F32")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert splits >= sms // 2


# ---------------------------------------------------------------------------
# Tagged width classes (mixed precision)
# ---------------------------------------------------------------------------

# Eight cores: every class, and TAG2 with BF16 and Q15 cores in one launch.
MIXED8 = ("F32", "BF16", "Q15", "Q7", "Q15", "BF16", "Q7", "F32")


def mixed_pack(csr, block, t, formats=MIXED8):
    packed = ops.pack_partitions(csr, len(formats), block, packets_multiple=t,
                                 stream_layout="fused", value_formats=formats)
    return packed, {g.class_name: g for g in packed.groups}


def poison_tagged(words, block, rows_per_core, cores):
    """Padding col ids of a tagged group poisoned (30,000 and -7): ids past
    the last real row must contribute 0, in any section layout."""
    out = words.copy()
    for j, c in enumerate(cores):
        member = FORMAT_BY_CODE[int(words[j, 0, 0])]
        vals, cols, flags = bscsr.defuse_stream(words[j], block, member, np.int16,
                                                tagged=True)
        row_ids = np.cumsum(bscsr.unpack_bits(flags, block).reshape(-1)) - 1
        pad = (row_ids >= rows_per_core[c]).reshape(cols.shape)
        cols = cols.copy()
        cols[pad] = 30_000
        cols[pad & (np.arange(cols.size).reshape(cols.shape) % 2 == 1)] = -7
        out[j] = bscsr.fuse_words(vals, cols, flags, tag=member.code)
    return out


@pytest.mark.parametrize("block,t,n_cols", [(32, 1, 64), (256, 2, 512), (64, 2, 40_000)])
def test_tagged_kernels_match_plain_bitwise(cuda, block, t, n_cols):
    """Dyadic data: each kernel on TAG4, TAG2 and TAG1 equals its plain
    version bit for bit, at every S the card picks, one and 64."""
    packed, groups = mixed_pack(dyadic_csr(800, n_cols, seed=block + t + 20), block, t)
    assert sorted(groups) == ["TAG1", "TAG2", "TAG4"]
    assert {int(c) for c in groups["TAG2"].words[:, 0, 0]} == {1, 2}
    rng = np.random.default_rng(block)
    for name, g in groups.items():
        w = torch.from_numpy(g.words)
        kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=t, fmt_name=name,
                  block_size=block)
        for q in (1, 3, 64):
            xs = torch.from_numpy((rng.integers(-16, 17, (q, n_cols)) / 8.0)
                                  .astype(np.float32))
            if q == 1:
                assert_same_bits(K.bscsr_topk_spmv(xs[0].to(cuda), w.to(cuda), **kw),
                                 K.bscsr_topk_spmv(xs[0], w, **kw), f"{name} single")
            want = K.bscsr_topk_spmv_multiquery_plain(xs, w, **kw)
            for splits in (None, 1, 64):
                got = K.bscsr_topk_spmv_multiquery(xs.to(cuda), w.to(cuda), splits=splits,
                                                   **kw)
                torch.cuda.synchronize()
                assert_same_bits(got, want, f"{name} Q={q} S={splits}")
        akw = dict(n_rows=packed.max_slots, packets_per_step=t, fmt_name=name,
                   block_size=block)
        want = K.bscsr_spmv(xs[0], w, **akw).numpy()
        for splits in (None, 1, 64):
            got = K.bscsr_spmv(xs[0].to(cuda), w.to(cuda), splits=splits, **akw)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                          want.view(np.int32), err_msg=f"{name} S={splits}")


@pytest.mark.parametrize("block,t,n_cols", [(32, 1, 2000), (256, 2, 2000), (64, 2, 40_000)])
def test_tagged_groups_match_f32_twins_one_split_bitwise(cuda, block, t, n_cols):
    """Random data: the grouped tagged dispatch (one launch per class, at
    each class's S) gives the bits of the f32 twins as one F32 stream, per
    call and through the executor, and every S its S = 1 bits."""
    csr = long_row_csr(600, n_cols, block, seed=block + t + 21, dyadic=False)
    packed, groups = mixed_pack(csr, block, t)
    twins = dataclasses.replace(packed, stream_layout="split")
    xs = mq_queries(8, n_cols, seed=t, dyadic=False)
    kw = dict(k=8, packets_per_step=t, device=cuda)
    K.reset_launch_counts()
    assert_same_bits(ops.topk_spmv_blocked(xs[0], packed, 16, **kw),
                     ops.topk_spmv_blocked(xs[0], twins, 16, **kw), "single")
    assert_same_bits(ops.topk_spmv_batched(xs, packed, 16, **kw),
                     ops.topk_spmv_batched(xs, twins, 16, **kw), "batched")
    got = ops.bscsr_spmv_blocked(xs[0], packed, packets_per_step=t, device=cuda)
    want = ops.bscsr_spmv_blocked(xs[0], twins, packets_per_step=t, device=cuda)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (K.bscsr_topk_spmv.launches, K.bscsr_topk_spmv_multiquery.launches,
            K.bscsr_spmv.launches) == (4, 4, 4)     # three classes + the twins
    for name, g in groups.items():
        w = torch.from_numpy(g.words).to(cuda)
        kwk = dict(k=8, n_rows=packed.max_slots, packets_per_step=t, fmt_name=name,
                   block_size=block)
        one = K.bscsr_topk_spmv_multiquery(xs.to(cuda), w, splits=1, **kwk)
        for splits in (None, 2, 64):
            assert_same_bits(K.bscsr_topk_spmv_multiquery(xs.to(cuda), w, splits=splits,
                                                          **kwk), one, f"{name} S={splits}")


@pytest.mark.parametrize("formats", [("BF16", "Q15", "Q15", "BF16"), ("Q7",) * 4,
                                     ("F32", "F32", "BF16", "Q7")])
def test_tagged_kernels_match_plain_bitwise_on_a_padded_budget(cuda, formats):
    """All-negative dyadic scores, flag-free padding steps (whose rows hold
    header 0), a doubled slot budget and poisoned padding ids: every kernel
    on every class equals plain bit for bit, and no phantom slot enters."""
    csr = long_row_csr(200, 512, 32, seed=13, dyadic=True)
    csr = dataclasses.replace(csr, data=-np.abs(csr.data) - 1 / 128)
    packed, groups = mixed_pack(csr, 32, 2, formats)
    live = np.asarray(packed.candidate_slots)
    n_rows = 2 * packed.max_slots
    xs = mq_queries(5, 512, seed=14, dyadic=True).abs() + 0.125
    for name, g in groups.items():
        words = poison_tagged(g.words, 32, live, g.cores)
        words = np.concatenate([words, np.zeros((len(g.cores), 8, words.shape[2]),
                                                np.int32)], 1)
        w = torch.from_numpy(words)
        kw = dict(k=8, n_rows=n_rows, packets_per_step=2, fmt_name=name, block_size=32)
        assert_same_bits(K.bscsr_topk_spmv(xs[0].to(cuda), w.to(cuda), **kw),
                         K.bscsr_topk_spmv(xs[0], w, **kw), f"{name} single")
        want = K.bscsr_topk_spmv_multiquery_plain(xs, w, **kw)
        akw = dict(n_rows=n_rows, packets_per_step=2, fmt_name=name, block_size=32)
        want_sums = K.bscsr_spmv(xs[0], w, **akw).numpy()
        for splits in (None, 1, 3, 64):
            got = K.bscsr_topk_spmv_multiquery(xs.to(cuda), w.to(cuda), splits=splits, **kw)
            sums = K.bscsr_spmv(xs[0].to(cuda), w.to(cuda), splits=splits, **akw)
            torch.cuda.synchronize()
            assert_same_bits(got, want, f"{name} S={splits}")
            gv, gr = to_np(got)
            filled = gv > K.NEG_INF
            slots = live[list(g.cores)][:, None, None]
            assert (gr[filled] < np.broadcast_to(slots, gr.shape)[filled]).all()
            np.testing.assert_array_equal(sums.cpu().numpy().view(np.int32),
                                          want_sums.view(np.int32))


def test_tagged_mq_split_kernel_breaks_ties_at_the_kth_place_like_plain(cuda):
    """The tie fixture of the uniform test in one TAG2 launch with a BF16
    and a Q15 core: every row scores 3/8, 1/2 or below 0."""
    rng = np.random.default_rng(31)
    lens = np.full(400, 3)
    lens[::11] = rng.integers(40, 70, size=len(lens[::11]))
    lens[5::13] = 4
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.concatenate([np.sort(rng.choice(80, int(n), replace=False))
                          for n in lens]).astype(np.int32)
    data = np.full(int(lens.sum()), 1 / 8, np.float32)
    data[np.repeat(lens > 4, lens)] = -1 / 128
    csr = bscsr.CSRMatrix(indptr, idx, data, (len(lens), 80))
    packed = ops.pack_partitions(csr, 2, 32, packets_multiple=1, stream_layout="fused",
                                 value_formats=("BF16", "Q15"))
    (g,) = packed.groups
    w = torch.from_numpy(g.words)
    xs = torch.ones((3, 80))
    xs[1, ::2] = 0.5
    xs[2] = 2.0
    kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=1, fmt_name="TAG2",
              block_size=32)
    want = K.bscsr_topk_spmv_multiquery_plain(xs, w, **kw)
    assert (want[0][:, 0] == 0.5).all()
    for splits in (None, 1, 3, 64):
        got = K.bscsr_topk_spmv_multiquery(xs.to(cuda), w.to(cuda), splits=splits, **kw)
        torch.cuda.synchronize()
        assert_same_bits(got, want, f"S={splits}")


def test_tagged_mq_split_kernel_holds_plain_bits_over_repeated_calls(cuda):
    """The repeated-call fixture (scores climbing slowly with noise) in one
    TAG2 launch with a BF16 and a Q15 core, 40 calls at each S."""
    rng = np.random.default_rng(52)
    n_rows, n_cols = 20_000, 512
    indptr = np.arange(n_rows + 1, dtype=np.int64)
    idx = rng.integers(0, n_cols, n_rows).astype(np.int32)
    data = ((np.arange(n_rows) // 128 + rng.integers(0, 8, n_rows)) / 256).astype(np.float32)
    csr = bscsr.CSRMatrix(indptr, idx, data, (n_rows, n_cols))
    packed = ops.pack_partitions(csr, 2, 256, packets_multiple=2, stream_layout="fused",
                                 value_formats=("Q15", "BF16"))
    (g,) = packed.groups
    w = torch.from_numpy(g.words)
    kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=2, fmt_name="TAG2",
              block_size=256)
    for q in (1, 8):
        xs = torch.from_numpy(2.0 ** rng.integers(-1, 2, (q, n_cols))).float()
        want = [t.to(cuda) for t in K.bscsr_topk_spmv_multiquery_plain(xs, w, **kw)]
        xs, wc = xs.to(cuda), w.to(cuda)
        for splits in (1, 2, 4):
            outs = [K.bscsr_topk_spmv_multiquery(xs, wc, splits=splits, **kw)
                    for _ in range(40)]
            torch.cuda.synchronize()
            bad = [i for i, (v, r) in enumerate(outs)
                   if not (torch.equal(v.view(torch.int32), want[0].view(torch.int32))
                           and torch.equal(r, want[1]))]
            assert not bad, f"Q={q} S={splits}: calls {bad} of 40 differ from plain"


@pytest.mark.parametrize("block,t,n_cols", [(32, 1, 64), (256, 2, 512), (64, 2, 40_000)])
def test_tagged_single_split_kernel_matches_plain_bitwise(cuda, block, t, n_cols):
    """The single-query kernel on TAG4, TAG2 (BF16 and Q15 cores in one
    launch, its core's header read by every split) and TAG1: dyadic data
    gives the plain walk's bits at every S, random data the S = 1 bits."""
    packed, groups = mixed_pack(dyadic_csr(800, n_cols, seed=block + t + 40), block, t)
    rand, rgroups = mixed_pack(long_row_csr(600, n_cols, block, seed=block + t + 41,
                                            dyadic=False), block, t)
    for name, g in groups.items():
        w = torch.from_numpy(g.words)
        kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=t, fmt_name=name,
                  block_size=block)
        x = mq_queries(1, n_cols, seed=block + 1, dyadic=True)[0]
        want = K.bscsr_topk_spmv_plain(x, w, **kw)
        for splits in (None, 1, 3, 64):
            assert_same_bits(single_card(x.to(cuda), w.to(cuda), splits=splits, **kw), want,
                             f"{name} dyadic S={splits}")
        w = torch.from_numpy(rgroups[name].words).to(cuda)
        kw["n_rows"] = rand.max_slots
        x = mq_queries(1, n_cols, seed=block + 2, dyadic=False)[0].to(cuda)
        one = single_card(x, w, splits=1, **kw)
        for splits in (None, 2, 64):
            assert_same_bits(single_card(x, w, splits=splits, **kw), one,
                             f"{name} random S={splits}")


def test_mixed_facade_on_the_card(cuda):
    """A recall-targeted facade: query, query_batch, topk_spmv and an
    accumulate step launch every kernel once per class, equal the plain
    versions' answers, and ingest keeps the signature."""
    csr = bscsr.synthetic_embedding_csr(8_000, 128, 12, "gamma", seed=5)
    scales = np.where(np.arange(8_000) < 2_000, 1.0, 0.25).astype(np.float32)
    csr = bscsr.scale_rows(csr, scales)
    cfg = api.TopKSpMVConfig(big_k=20, k=8, num_partitions=8, device="cuda")
    svc = SparseEmbeddingIndex(csr, cfg, recall_target=0.99)
    cpu = SparseEmbeddingIndex(csr, dataclasses.replace(cfg, device="cpu"),
                               recall_target=0.99)
    packed = svc.index.packed
    assert packed.is_heterogeneous and svc.index.partition_formats == cpu.index.partition_formats
    n_groups = len(packed.groups)
    xs = np.random.default_rng(6).standard_normal((8, 128)).astype(np.float32)
    K.reset_launch_counts()
    v, r = svc.query_batch(xs)
    one = api.topk_spmv(svc.index, torch.from_numpy(xs[0]).to(cuda))
    n_out = packed.n_rows_logical
    ax = api.query_executor(cfg).spmv(torch.from_numpy(xs[0]).to(cuda), packed, alpha=1.0,
                                      beta=0.0, y=torch.zeros(n_out, device=cuda))
    torch.cuda.synchronize()
    assert K.bscsr_topk_spmv.launches == n_groups
    assert K.bscsr_topk_spmv_multiquery.launches == n_groups
    assert K.bscsr_spmv.launches == n_groups
    cv, cr = cpu.query_batch(xs)
    np.testing.assert_allclose(v, cv, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(r, cr)
    np.testing.assert_array_equal(one[1].cpu().numpy(), r[0])
    cax = api.query_executor(cpu.config).spmv(xs[0], cpu.index.packed, alpha=1.0, beta=0.0,
                                              y=np.zeros(n_out, np.float32))
    np.testing.assert_allclose(ax.cpu().numpy(), cax.numpy(), rtol=1e-5, atol=1e-5)
    retraces = svc.dispatch_info()["retraces"]
    svc.upsert(np.random.default_rng(7).standard_normal((4, 128)).astype(np.float32) * 0.1)
    svc.query_batch(xs)
    svc.upsert(np.random.default_rng(8).standard_normal((4, 128)).astype(np.float32) * 0.1)
    svc.query_batch(xs)
    assert svc.index.partition_formats == cpu.index.partition_formats
    assert svc.dispatch_info()["retraces"] <= retraces + 1


# ---------------------------------------------------------------------------
# Ragged Q (the serving frontend coalesces any Q from 1 to max_batch)
# ---------------------------------------------------------------------------

RAGGED_QS = [9, 37, 63]     # full chunks of 8 and a ragged last one


@pytest.mark.parametrize("fmt", ["BF16", "Q7"])
@pytest.mark.parametrize("q", RAGGED_QS)
def test_mq_kernel_at_ragged_q_matches_plain_bitwise(cuda, fmt, q):
    """Dyadic data: every S gives the plain walk's bits when the last query
    chunk is short."""
    assert K.query_chunks(q)[0] * (K.query_chunks(q)[1] - 1) < q
    csr = long_row_csr(300, 512, 32, seed=q, dyadic=True)
    packed = ops.pack_partitions(csr, 4, 32, fmt, packets_multiple=2, stream_layout="fused")
    w = torch.from_numpy(packed.words)
    kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=2, fmt_name=fmt, block_size=32)
    xs = mq_queries(q, 512, seed=q + 1, dyadic=True)
    want = K.bscsr_topk_spmv_multiquery_plain(xs, w, **kw)
    for splits in (None, 1, 64):
        got = K.bscsr_topk_spmv_multiquery(xs.to(cuda), w.to(cuda), splits=splits, **kw)
        torch.cuda.synchronize()
        assert_same_bits(got, want, f"Q={q} S={splits}")


@pytest.mark.parametrize("fmt", ["BF16", "Q7"])
@pytest.mark.parametrize("q", RAGGED_QS)
def test_mq_kernel_at_ragged_q_on_random_data(cuda, fmt, q):
    """Random data: the card's S gives the S = 1 bits, which agree with
    plain within rtol = atol = 1e-5; the first chunk's bits are those of a
    call with those 8 queries alone."""
    csr = long_row_csr(300, 2000, 256, seed=q + 2, dyadic=False)
    packed = ops.pack_partitions(csr, 4, 256, fmt, packets_multiple=2, stream_layout="fused")
    w = torch.from_numpy(packed.words).to(cuda)
    kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=2, fmt_name=fmt, block_size=256)
    xs = mq_queries(q, 2000, seed=q + 3, dyadic=False).to(cuda)
    one = K.bscsr_topk_spmv_multiquery(xs, w, splits=1, **kw)
    for splits in (None, 64):
        assert_same_bits(K.bscsr_topk_spmv_multiquery(xs, w, splits=splits, **kw), one,
                         f"Q={q} S={splits}")
    want = K.bscsr_topk_spmv_multiquery_plain(xs, w, **kw)
    np.testing.assert_allclose(one[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    eight = K.bscsr_topk_spmv_multiquery(xs[:8].contiguous(), w, splits=1, **kw)
    assert_same_bits((one[0][:, :8], one[1][:, :8]), eight, "the first chunk")


@pytest.mark.parametrize("q", RAGGED_QS)
def test_tagged_mq_kernel_at_ragged_q(cuda, q):
    """Each width class (TAG4, TAG2, TAG1) at a ragged Q: dyadic bit for bit
    against plain at every S; random at the card's S equal to S = 1 and
    within rtol = atol = 1e-5 of plain."""
    for dyadic in (True, False):
        n_cols = 512 if dyadic else 2000
        csr = (dyadic_csr(800, n_cols, seed=q + 20) if dyadic
               else long_row_csr(600, n_cols, 64, seed=q + 21, dyadic=False))
        packed, groups = mixed_pack(csr, 64 if not dyadic else 32, 2)
        xs = mq_queries(q, n_cols, seed=q, dyadic=dyadic)
        for name, g in groups.items():
            w = torch.from_numpy(g.words)
            kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=2, fmt_name=name,
                      block_size=64 if not dyadic else 32)
            want = K.bscsr_topk_spmv_multiquery_plain(xs, w, **kw)
            one = K.bscsr_topk_spmv_multiquery(xs.to(cuda), w.to(cuda), splits=1, **kw)
            for splits in (None, 64):
                got = K.bscsr_topk_spmv_multiquery(xs.to(cuda), w.to(cuda), splits=splits,
                                                   **kw)
                torch.cuda.synchronize()
                assert_same_bits(got, one, f"{name} Q={q} S={splits}")
            if dyadic:
                assert_same_bits(one, want, f"{name} Q={q} plain")
            else:
                np.testing.assert_allclose(one[0].cpu().numpy(), want[0].cpu().numpy(),
                                           rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The serving plane on the card, at test size
# ---------------------------------------------------------------------------

def serving_facade(cuda, n_rows=20_000):
    csr = bscsr.synthetic_embedding_csr(n_rows, 128, 12, "gamma", seed=3)
    return SparseEmbeddingIndex(csr, api.TopKSpMVConfig(
        big_k=20, k=8, value_format="BF16", num_partitions=8, device="cuda"))


def test_frontend_burst_on_the_card(cuda):
    """37 submits and flush() make one pass of Q = 37: one launch of the
    multi-query kernel, bit for bit equal to query_batch."""
    from repro_torch.serve import FrontendConfig, StreamingSimilarityService

    svc = serving_facade(cuda)
    xs = np.random.default_rng(37).standard_normal((37, 128)).astype(np.float32)
    want = svc.query_batch(xs)
    service = StreamingSimilarityService(svc, frontend=FrontendConfig(
        adaptive=False, target_batch=64, max_batch=64, flush_deadline_s=30.0))
    try:
        K.reset_launch_counts()
        futs = [service.submit(x) for x in xs]
        service.flush()
        got = [f.result(timeout=120) for f in futs]
        assert service.frontend.info()["batch_histogram"] == {37: 1}
        assert K.bscsr_topk_spmv_multiquery.launches == 1
    finally:
        service.close()
    for i, (v, r) in enumerate(got):
        np.testing.assert_array_equal(v.view(np.int32), want[0][i].view(np.int32))
        np.testing.assert_array_equal(r, want[1][i])


def test_recovery_round_trip_on_the_card(cuda, tmp_path):
    """Ingest and delete through a durable service, a torn third ingest,
    then recovery onto the card: 2 records replayed, equal state, the same
    bits and signature, no retrace, h2d_copies up by the re-pin only."""
    from repro_torch.core.faults import FaultInjected, FaultPlan
    from repro_torch.core.persistence import DurableIndexStore
    from repro_torch.kernels import executor as executor_lib
    from repro_torch.serve import StreamingSimilarityService

    svc = serving_facade(cuda)
    rng = np.random.default_rng(38)
    service = StreamingSimilarityService(svc, store=DurableIndexStore(tmp_path))
    service.ingest(rng.standard_normal((16, 128)).astype(np.float32))
    service.delete([1, 5, 20_003])
    with FaultPlan({"wal.append": 0}):
        with pytest.raises(FaultInjected):
            service.ingest(rng.standard_normal((16, 128)).astype(np.float32))
    xs = rng.standard_normal((9, 128)).astype(np.float32)
    live = service.search(xs)
    meta, arrays = svc.index.export_state()
    ex = api.query_executor(svc.config)
    copies, retraces = ex.h2d_copies, ex.retraces
    K.reset_launch_counts()
    rec = StreamingSimilarityService.recover(DurableIndexStore(tmp_path))
    assert rec.replayed_records == 2
    got = rec.search(xs)
    assert K.bscsr_topk_spmv_multiquery.launches == 1
    np.testing.assert_array_equal(got[0].view(np.int32), live[0].view(np.int32))
    np.testing.assert_array_equal(got[1], live[1])
    assert not {1, 5, 20_003} & set(got[1].reshape(-1).tolist())
    rmeta, rarrays = rec.index.index.export_state()
    assert rmeta == meta and sorted(rarrays) == sorted(arrays)
    for name in arrays:
        np.testing.assert_array_equal(rarrays[name], arrays[name], err_msg=name)
    assert rec.index.index.packed.signature_info() == svc.index.packed.signature_info()
    pin = executor_lib.device_snapshot(rec.index.index.packed, "fused", ex.device)
    assert ex.retraces == retraces
    assert ex.h2d_copies - copies == pin.uploads
