"""The CUDA kernels on the card, against their plain PyTorch versions.

Run on a machine with a CUDA device:

    python -m pytest -q tests/test_torch_gpu.py

This file imports only ``repro_torch`` (no jax), so it runs where the
reference package cannot.  Every test is marked ``gpu`` and skips, with the
reason, where ``torch.cuda.is_available()`` is false.  Dyadic fixtures
(values on a 2**-7 grid, queries on a 2**-3 grid) are exact in f32 in any
summation order, so kernel and plain version must agree bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bscsr
from repro_torch.core import topk_spmv as api
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
