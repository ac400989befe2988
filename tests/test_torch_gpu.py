"""The CUDA kernels on the card, against their plain PyTorch versions.

Run on a machine with a CUDA device:

    python -m pytest -q tests/test_torch_gpu.py

This file imports only ``repro_torch`` (no jax), so it runs where the
reference package cannot.  Every test is marked ``gpu`` and skips, with the
reason, where ``torch.cuda.is_available()`` is false.  Dyadic fixtures
(values on a 2**-7 grid, queries on a 2**-3 grid) are exact in f32 in any
summation order, so kernel and plain version must agree bit for bit.

The multi-query kernel's walk at Q >= 2 sums each row's products in
stream order, so on random data it is held bit for bit to its CPU emulation
(``bscsr_topk_spmv_multiquery_emulated``) at every S, chunking and x
placement, and at Q = 1 it keeps the single-query kernel's bits.

The tagged width classes of mixed-precision snapshots (TAG4, TAG2 with
BF16 and Q15 cores in one launch, TAG1) run through all three kernels
against their plain versions and against the same snapshot's f32 twins
streamed as one F32 stream.

The LM serving engine on the card against itself on the CPU (the smoke
qwen2.5-3b config at float32, TF32 off: tokens equal, logits within
rtol = atol = 1e-4), ``sample_approx`` against the plain walk at a ragged
and a full decode batch, and ``kv_quant`` decoding.  The hybrid, ssm and
audio families likewise (prefill, decode logits and caches, ``generate``),
and one block of each recurrent kind at full width, chunked against stepped.

The mesh dispatch: a 4 x 2 and a 3 x 1 mesh of this card's positions
against the per-shard path and the single device, and
``distributed_topk_spmv_fn`` over four positions.

Training: one smoke step of ``make_train_step`` on the card against the CPU
(the f32 tolerances of ``test_torch_train.py``), a checkpoint restored onto
the card, and ``launch/train.py --smoke`` on the card by default.  The
training mesh: ``train(mesh=)`` on a 2 x 2 mesh of this card's positions bit
for bit ``mesh=None``, a resume from that mesh's checkpoint on a 4 x 1 one,
and ``pipelined_loss_fn`` on a (4, 1, 1) mesh against the sequential loss.

Tracing: a traced Q = 64 pass at 10M rows keeps its device time between
the launch and the end of ``index.wait``, and its spans meet their profiler
twins.
"""
import dataclasses
import os

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
# The multi-query walk at Q >= 2 ("rows"): held bit for bit to its CPU
# emulation on random data, at every S, chunking and x placement
# ---------------------------------------------------------------------------

def emulated(xs, w, **kw):
    """The rows walk's bits, computed on the CPU."""
    return K.bscsr_topk_spmv_multiquery_emulated(xs.cpu(), w.cpu(), **kw)


@pytest.mark.parametrize("k", [2, 8, 12])
@pytest.mark.parametrize("q", [2, 3, 31, 64, 65, 100])
def test_rows_walk_matches_its_emulation_bitwise(cuda, q, k):
    """Random data, every format: the card's S, one split and 64 give the
    emulation's bits (one chunk up to Q = 64, two or more beyond)."""
    csr = long_row_csr(200, 512, 64, seed=q + k, dyadic=False)
    xs = mq_queries(q, 512, seed=q, dyadic=False)
    for fmt in FORMATS:
        packed = ops.pack_partitions(csr, 4, 64, fmt, packets_multiple=2,
                                     stream_layout="fused")
        w = torch.from_numpy(packed.words)
        kw = dict(k=k, n_rows=packed.max_slots, packets_per_step=2, fmt_name=fmt,
                  block_size=64)
        want = emulated(xs, w, **kw)
        for splits in (None, 1, 64):
            got = K.bscsr_topk_spmv_multiquery(xs.to(cuda), w.to(cuda), splits=splits, **kw)
            torch.cuda.synchronize()
            assert_same_bits(got, want, f"{fmt} Q={q} k={k} S={splits}")


@pytest.mark.parametrize("block,t,n_cols", [(32, 1, 2000), (256, 2, 2000), (64, 2, 40_000)])
def test_rows_walk_on_tagged_classes_and_wide_x(cuda, block, t, n_cols):
    """Each tagged class (TAG2 with BF16 and Q15 cores in one launch) at
    Q = 2, 9 and 64, and x in global memory at m = 40,000 (int32 ids):
    the emulation's bits at the card's S and at S = 3."""
    csr = long_row_csr(600, n_cols, block, seed=block + t + 50, dyadic=False)
    packed, groups = mixed_pack(csr, block, t)
    for q in (2, 9, 64):
        xs = mq_queries(q, n_cols, seed=q + t, dyadic=False)
        for name, g in groups.items():
            w = torch.from_numpy(g.words)
            kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=t, fmt_name=name,
                      block_size=block)
            want = emulated(xs, w, **kw)
            for splits in (None, 3):
                got = K.bscsr_topk_spmv_multiquery(xs.to(cuda), w.to(cuda), splits=splits,
                                                   **kw)
                assert_same_bits(got, want, f"{name} Q={q} S={splits}")


def test_rows_walk_bits_do_not_depend_on_q_or_the_walkers(cuda):
    """A query's bits at Q = 2, 8, 37 and 100, in any chunk and at any S."""
    csr = long_row_csr(300, 2000, 256, seed=61, dyadic=False)
    packed = ops.pack_partitions(csr, 4, 256, "BF16", packets_multiple=2, stream_layout="fused")
    w = torch.from_numpy(packed.words).to(cuda)
    kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=2, fmt_name="BF16",
              block_size=256)
    xs = mq_queries(100, 2000, seed=62, dyadic=False).to(cuda)
    full = K.bscsr_topk_spmv_multiquery(xs, w, splits=1, **kw)
    for q in (2, 8, 37):
        for splits in (None, 1, 5, 64):
            got = K.bscsr_topk_spmv_multiquery(xs[:q].contiguous(), w, splits=splits, **kw)
            assert_same_bits(got, (full[0][:, :q], full[1][:, :q]), f"Q={q} S={splits}")
    tail = K.bscsr_topk_spmv_multiquery(xs[60:62].contiguous(), w, **kw)
    assert_same_bits(tail, (full[0][:, 60:62], full[1][:, 60:62]), "queries 60, 61")


def test_launches_by_walk(cuda):
    """Q = 1 launches the one-query walk, Q >= 2 the rows walk, on every
    route: the wrapper, ops.topk_spmv_batched and the executor."""
    csr = long_row_csr(100, 256, 32, seed=63, dyadic=True)
    packed = ops.pack_partitions(csr, 2, 32, "BF16", packets_multiple=2,
                                 stream_layout="fused")
    w = torch.from_numpy(packed.words).to(cuda)
    kw = dict(k=8, n_rows=packed.max_slots, packets_per_step=2, fmt_name="BF16",
              block_size=32)
    K.reset_launch_counts()
    for q in (1, 2, 3, 64, 1):
        K.bscsr_topk_spmv_multiquery(mq_queries(q, 256, seed=q, dyadic=True).to(cuda), w, **kw)
    ops.topk_spmv_batched(mq_queries(5, 256, seed=5, dyadic=True), packed, 16, k=8,
                          packets_per_step=2, device=cuda)
    torch.cuda.synchronize()
    assert K.bscsr_topk_spmv_multiquery.launches_by_walk == {"rows": 4, "chunks1": 2}
    assert K.bscsr_topk_spmv_multiquery.launches == 6
    K.reset_launch_counts()
    assert K.bscsr_topk_spmv_multiquery.launches_by_walk == {"rows": 0, "chunks1": 0}


@pytest.mark.parametrize("s,r", [(4, 2), (3, 1)])
def test_mesh_at_q_2_and_3_equals_one_device(cuda, s, r):
    """At Q = 2 and 3 every replica row walks at least two queries, so it
    takes the single device's walk and gives its bits."""
    csr = bscsr.synthetic_embedding_csr(20_000, 128, 12, "gamma", seed=5)
    cfg = api.TopKSpMVConfig(big_k=20, k=8, value_format="BF16", num_partitions=24,
                             device="cuda")
    one = SparseEmbeddingIndex(csr, cfg)
    msh = SparseEmbeddingIndex(csr, cfg, mesh=card_mesh(cuda, s, r))
    xs = np.random.default_rng(11).standard_normal((3, 128)).astype(np.float32)
    for q in (2, 3):
        K.reset_launch_counts()
        assert_pair_bits(msh.query_batch(xs[:q]), one.query_batch(xs[:q]), f"Q={q}")
        assert K.bscsr_topk_spmv_multiquery.launches_by_walk["chunks1"] == 0


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


# ---------------------------------------------------------------------------
# The sharded plane on the card, at test size: every shard dispatches its
# kernels on an 8-core snapshot at the S the card picks for it, and every S
# gives the single walk's bits, so sharded == single device bit for bit.
# ---------------------------------------------------------------------------

def sharded_pair(cuda, n_rows=20_000, n_shards=4, **kw):
    csr = bscsr.synthetic_embedding_csr(n_rows, 128, 12, "gamma", seed=4)
    cfg = api.TopKSpMVConfig(big_k=20, k=8, value_format="BF16", num_partitions=32,
                             device="cuda", **kw)
    return SparseEmbeddingIndex(csr, cfg), SparseEmbeddingIndex(csr, cfg, n_shards=n_shards)


def assert_pair_bits(got, want, what=""):
    (gv, gr), (wv, wr) = (tuple(t.cpu().numpy() if isinstance(t, torch.Tensor) else t
                                for t in p) for p in (got, want))
    np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32), err_msg=what)
    np.testing.assert_array_equal(gr, wr, err_msg=what)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_facade_matches_single_device_bitwise(cuda, n_shards):
    """query / query_batch at Q = 1, 8, 37, 64 and the single-query kernel
    through index.query, before and after an ingest and deletes; each shard
    launches each kernel once per call."""
    one, shd = sharded_pair(cuda, n_shards=n_shards)
    rng = np.random.default_rng(n_shards)
    xs = rng.standard_normal((64, 128)).astype(np.float32)

    def check(what):
        for q in (8, 37, 64):
            assert_pair_bits(shd.query_batch(xs[:q]), one.query_batch(xs[:q]), f"{what} Q={q}")
        assert_pair_bits(shd.query(xs[1]), one.query(xs[1]), what)
        x = torch.from_numpy(xs[2]).to(cuda)
        assert_pair_bits(shd.index.query(x), api.topk_spmv(one.index, x), what)

    check("build")
    new = rng.standard_normal((40, 128)).astype(np.float32)
    np.testing.assert_array_equal(shd.upsert(new), one.upsert(new))
    for fac in (one, shd):
        fac.delete([0, 7, 19_999, 20_003])
        fac.upsert(new[:3], ids=[11, 12, 20_001])
    check("after ingest")
    K.reset_launch_counts()
    shd.query_batch(xs)
    shd.index.query(torch.from_numpy(xs[0]).to(cuda))
    assert K.bscsr_topk_spmv_multiquery.launches == n_shards
    assert K.bscsr_topk_spmv.launches == n_shards


def test_sharded_failover_and_recovery_on_the_card(cuda):
    """A failed shard's pool drops out of the merge; recover_shard re-pins it
    from its host copy and the full answers come back bit for bit."""
    from repro_torch.core.faults import FaultPlan

    _, shd = sharded_pair(cuda)
    xs = np.random.default_rng(9).standard_normal((16, 128)).astype(np.float32)
    full = shd.query_batch(xs)
    with FaultPlan({"dispatch.shard": 2}):
        deg = shd.query_batch(xs)
    assert shd.index.dead_shards == (2,)
    owner = shd.index._live
    for i in range(16):
        keep = [j for j, g in enumerate(full[1][i]) if owner[int(g)][0] != 2]
        n = len(keep)
        assert_pair_bits((deg[0][i][:n], deg[1][i][:n]),
                         (full[0][i][keep], full[1][i][keep]), f"query {i}")
    ex = api.query_executor(shd.config)
    copies = ex.h2d_copies
    shd.index.recover_shard(2)
    assert_pair_bits(shd.query_batch(xs), full)
    assert ex.h2d_copies > copies
    assert shd.dispatch_info()["health"]["live_shard_fraction"] == 1.0


def test_sharded_accumulate_matches_single_device_bitwise(cuda):
    """y = alpha A x + beta y and a cold and a warm PPR on 4 shards equal the
    single-device ones bit for bit, with one accumulate launch per shard."""
    from repro_torch.core import graph

    csr = graph.synthetic_graph_csr("ring", 1 << 14, seed=0)
    cfg = api.TopKSpMVConfig(k=8, num_partitions=32, value_format="F32", device="cuda")
    one = SparseEmbeddingIndex(csr, cfg)
    shd = SparseEmbeddingIndex(csr, cfg, n_shards=4)
    n = csr.shape[0]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    a, b = torch.tensor(0.85, device=cuda), torch.tensor(0.15, device=cuda)
    ex = api.query_executor(cfg)
    want = ex.spmv(x, one.index.packed, alpha=a, beta=b, y=y)
    K.reset_launch_counts()
    got = shd.index.spmv(x, a, b, y, resident=True)
    assert K.bscsr_spmv.launches == 4
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    c1 = graph.personalized_pagerank(one.index, [5, 17], tol=1e-5)
    c4 = graph.personalized_pagerank(shd.index, [5, 17], tol=1e-5)
    np.testing.assert_array_equal(c1.scores.view(np.int32), c4.scores.view(np.int32))
    assert c1.iterations == c4.iterations and c4.retraces == 0
    seg = csr.row_slice(40, 41)
    for idx in (one.index, shd.index):
        idx.replace_rows([40], [(seg.indices, (seg.data * 1.02).astype(np.float32))])
    w1 = graph.personalized_pagerank(one.index, [5, 17], tol=1e-5, warm_start=c1.scores)
    w4 = graph.personalized_pagerank(shd.index, [5, 17], tol=1e-5, warm_start=c4.scores)
    np.testing.assert_array_equal(w1.scores.view(np.int32), w4.scores.view(np.int32))
    assert w1.iterations == w4.iterations


def test_sharded_mixed_twins_match_native_on_the_card(cuda):
    """Shard-local width classes through the tagged kernels, and the f32
    twins as one F32 stream a shard, give the same bits."""
    csr = bscsr.synthetic_embedding_csr(8_000, 128, 12, "gamma", seed=6)
    csr = bscsr.scale_rows(csr, np.where(np.arange(8_000) < 2_000, 1.0, 0.25))
    cfg = api.TopKSpMVConfig(big_k=20, k=8, num_partitions=16, recall_target=0.95,
                             device="cuda")
    native = SparseEmbeddingIndex(csr, cfg, n_shards=4)
    twins = SparseEmbeddingIndex(csr, cfg, n_shards=4, native_groups=False)
    assert all(sh.packed.groups is not None for sh in native.index.shards)
    xs = np.random.default_rng(7).standard_normal((64, 128)).astype(np.float32)
    for q in (1, 8, 64):
        assert_pair_bits(native.query_batch(xs[:q]), twins.query_batch(xs[:q]), f"Q={q}")
    x = torch.from_numpy(xs[0]).to(cuda)
    assert_pair_bits(native.index.query(x), twins.index.query(x))
    y = torch.zeros(csr.shape[0], device=cuda)
    xa = torch.from_numpy(np.random.default_rng(8).random(128).astype(np.float32)).to(cuda)
    assert torch.equal(native.index.spmv(xa, 1.0, 0.0, y).view(torch.int32),
                       twins.index.spmv(xa, 1.0, 0.0, y).view(torch.int32))


def test_sharded_topk_head_on_the_card(cuda):
    """The approximate head: 4 shards == unsharded bit for bit; the
    single-query kernel within 1e-5 of the plain answer."""
    from repro_torch.serve import ApproxTopKHead, TopKHeadConfig

    rng = np.random.default_rng(10)
    emb = rng.standard_normal((20_000, 256)).astype(np.float32)
    h1 = ApproxTopKHead(emb, TopKHeadConfig(device="cuda"))
    h4 = ApproxTopKHead(emb, TopKHeadConfig(device="cuda", n_shards=4))
    hs = rng.standard_normal((64, 256)).astype(np.float32)
    assert_pair_bits(h4.topk_logits_batch(hs), h1.topk_logits_batch(hs))
    assert_pair_bits(h4.topk_logits(hs[0], use_kernel=True),
                     h1.topk_logits(hs[0], use_kernel=True))
    kv, kr = h1.topk_logits(hs[1], use_kernel=True)
    pv, pr = h1.topk_logits(hs[1], use_kernel=False)
    np.testing.assert_allclose(kv, pv, rtol=1e-5, atol=1e-5)
    assert h4.dispatch_info()["path"] == "per_shard"


# ---------------------------------------------------------------------------
# The mesh dispatch on the card: meshes whose positions all name this card
# (a 4 x 2 mesh and a 3 x 1 one).  Each position pins its own copy of its
# shard and walks it at the S the card picks for its cores.
# ---------------------------------------------------------------------------

def card_mesh(cuda, n_shards, n_replicas=1):
    from repro_torch.launch.mesh import make_serving_mesh

    return make_serving_mesh(n_shards, n_replicas, devices=[cuda] * (n_shards * n_replicas))


@pytest.mark.parametrize("layout", ["fused", "split"])
@pytest.mark.parametrize("s,r", [(4, 2), (3, 1)])
def test_mesh_matches_per_shard_and_single_device_bitwise(cuda, s, r, layout):
    """query / query_batch at Q = 1, 8, 37, 64, index.query (the single-query
    kernel) and spmv on the mesh equal the per-shard path and the single
    device bit for bit, before and after an ingest and after a dirty
    partition ship in the same buckets (a split table left stale by the
    ship would walk the old packets)."""
    csr = bscsr.synthetic_embedding_csr(20_000, 128, 12, "gamma", seed=4)
    cfg = api.TopKSpMVConfig(big_k=20, k=8, value_format="BF16", num_partitions=24,
                             stream_layout=layout, device="cuda")
    one = SparseEmbeddingIndex(csr, cfg)
    per = SparseEmbeddingIndex(csr, cfg, n_shards=s)
    msh = SparseEmbeddingIndex(csr, cfg, mesh=card_mesh(cuda, s, r))
    assert msh.dispatch_info()["path"] == "spmd" and msh.replica_factor == r
    rng = np.random.default_rng(10 * s + r)
    xs = rng.standard_normal((64, 128)).astype(np.float32)

    def check(what):
        for q in (1, 8, 37, 64):
            want = one.query_batch(xs[:q])
            assert_pair_bits(msh.query_batch(xs[:q]), want, f"{what} Q={q}")
            assert_pair_bits(per.query_batch(xs[:q]), want, f"{what} Q={q} per shard")
        x = torch.from_numpy(xs[2]).to(cuda)
        assert_pair_bits(msh.index.query(x), api.topk_spmv(one.index, x), what)
        y = torch.from_numpy(rng.random(one.index.n_rows_total).astype(np.float32)).to(cuda)
        xa = torch.from_numpy(xs[3]).to(cuda)
        want = api.query_executor(cfg).spmv(xa, one.index.packed, alpha=0.5, beta=2.0, y=y)
        assert torch.equal(msh.index.spmv(xa, 0.5, 2.0, y).view(torch.int32),
                           want.view(torch.int32)), what

    check("build")
    new = rng.standard_normal((40, 128)).astype(np.float32)
    for fac in (one, per, msh):
        np.testing.assert_array_equal(fac.upsert(new), np.arange(20_000, 20_040))
        fac.delete([0, 7, 19_999, 20_003])
    check("after ingest")
    disp = msh.index._spmd
    for attempt in range(4):
        info = msh.dispatch_info()
        row = rng.standard_normal((1, 128)).astype(np.float32)
        for fac in (one, per, msh):
            fac.upsert(row)
        check(f"dirty ship {attempt}")
        after = msh.dispatch_info()
        if (after["retraces"] == info["retraces"] and after["bundle"]["partitions_shipped"]
                > info["bundle"]["partitions_shipped"]):
            break
    else:
        pytest.fail("no mutation shipped dirty partitions within its buckets")
    assert all(t[0] is disp._sync()[0][0].pieces[pos] for pos, t in disp._tables.items())
    K.reset_launch_counts()
    msh.query_batch(xs)
    msh.index.query(torch.from_numpy(xs[0]).to(cuda))
    assert K.bscsr_topk_spmv_multiquery.launches == s * r
    assert K.bscsr_topk_spmv.launches == s


def test_mesh_distributed_topk_spmv_fn_on_the_card(cuda):
    """distributed_topk_spmv_fn over four cuda:0 positions: the single form
    equals topk_spmv and the batched form at Q = 64 topk_spmv_batched, bit
    for bit, with one launch a position."""
    from repro_torch.launch.mesh import DeviceMesh

    csr = bscsr.synthetic_embedding_csr(20_000, 128, 12, "gamma", seed=5)
    cfg = api.TopKSpMVConfig(big_k=20, k=8, value_format="BF16", num_partitions=32,
                             device="cuda")
    xs = torch.from_numpy(np.random.default_rng(11).standard_normal((64, 128))
                          .astype(np.float32)).to(cuda)
    for index in (api.build_index(csr, cfg), api.MutableTopKSpMVIndex(csr, cfg)):
        for axes, shape in ((("data",), (4,)), (("pod", "data"), (2, 2))):
            mesh = DeviceMesh(np.full(shape, cuda, dtype=object), axes)
            axis = axes if len(axes) > 1 else axes[0]
            fn, arrays = api.distributed_topk_spmv_fn(index, mesh, shard_axis=axis)
            want = api.topk_spmv(index, xs[0])
            K.reset_launch_counts()
            got = fn(xs[0], *arrays)
            assert K.bscsr_topk_spmv.launches == 4
            assert_pair_bits(got, want)
            fn, arrays = api.distributed_topk_spmv_fn(index, mesh, shard_axis=axis,
                                                      batched=True)
            assert_pair_bits(fn(xs, *arrays), api.topk_spmv_batched(index, xs))


# ---------------------------------------------------------------------------
# The LM serving engine
# ---------------------------------------------------------------------------

ENGINE_HEAD = dict(big_k=16, k=8, num_partitions=4, nnz_per_row=32, block_size=64)


@pytest.fixture
def no_tf32(cuda):
    """Float32 products in float32 on the card, as on the CPU."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32 = was


def engine_pair(batch, **over):
    """(cpu engine, card engine) over the same smoke model drawn on the CPU."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import ServingEngine, TopKHeadConfig

    cfg = dataclasses.replace(smoke_config("qwen25_3b"), **over)
    host = Transformer(cfg, "cpu").init_params(torch.Generator().manual_seed(0))
    card = Transformer(cfg, "cuda")
    card.load_state_dict(host.state_dict())
    card.keep_head_source(host.head_source)
    return tuple(ServingEngine(cfg, model, batch_size=batch, max_seq=64, use_approx_head=True,
                               head_cfg=TopKHeadConfig(device=dev, **ENGINE_HEAD), device=dev)
                 for model, dev in ((host, "cpu"), (card, "cuda")))


def test_engine_on_the_card_equals_the_cpu(no_tf32):
    cpu, card = engine_pair(4)
    prompt = np.random.default_rng(1).integers(0, cpu.cfg.vocab_size, (4, 6))
    lc, cache_c, pos = cpu.prefill_tokens(prompt)
    lg, cache_g, _ = card.prefill_tokens(prompt)
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4, atol=1e-4)
    for name in cache_c:
        np.testing.assert_allclose(cache_g[name].cpu().numpy(), cache_c[name].numpy(),
                                   rtol=1e-4, atol=1e-4)
    top = np.sort(lc.numpy(), axis=-1)[:, -2:]
    assert (top[:, 1] - top[:, 0]).min() > 1e-3
    np.testing.assert_array_equal(card.generate(prompt, 8).tokens,
                                  cpu.generate(prompt, 8).tokens)
    hc, _ = cpu.decode_hidden(cache_c, prompt[:, -1:], pos)
    hg, _ = card.decode_hidden(cache_g, prompt[:, -1:], pos)
    np.testing.assert_allclose(hg.cpu().numpy(), hc.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(card.sample_approx(hg), cpu.sample_approx(hc))


@pytest.mark.parametrize("batch", [3, 64])
def test_engine_sample_approx_equals_the_plain_walk(no_tf32, batch):
    """The multi-query kernel at the decode batch (3: one ragged chunk)
    against the head's plain walk: ids equal outside near-ties, values
    within 1e-5."""
    _, card = engine_pair(batch)
    prompt = np.random.default_rng(batch).integers(0, card.cfg.vocab_size, (batch, 5))
    _, cache, pos = card.prefill_tokens(prompt)
    hidden, _ = card.decode_hidden(cache, prompt[:, -1:], pos)
    before = K.bscsr_topk_spmv_multiquery.launches
    ids = card.sample_approx(hidden)
    assert K.bscsr_topk_spmv_multiquery.launches == before + 1
    h = hidden.float().cpu().numpy()
    kv, kr = card.head.topk_logits_batch(h)
    pv, pr = card.head.topk_logits_batch(h, use_kernel=False)
    np.testing.assert_allclose(kv, pv, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ids, kr[:, 0])
    clear = pv[:, 0] - pv[:, 1] > 2e-5
    np.testing.assert_array_equal(ids[clear], pr[clear, 0])


def test_engine_kv_quant_decodes_on_the_card(no_tf32):
    cpu, card = engine_pair(2, kv_quant=True)
    prompt = np.random.default_rng(2).integers(0, cpu.cfg.vocab_size, (2, 8))
    lc, cache_c, _ = cpu.prefill_tokens(prompt)
    lg, cache_g, _ = card.prefill_tokens(prompt)
    assert cache_g["k"].dtype == torch.int8 and cache_g["k"].is_cuda
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(lg.argmax(-1).cpu().numpy(), lc.argmax(-1).numpy())
    np.testing.assert_array_equal(card.generate(prompt, 6).tokens, cpu.generate(prompt, 6).tokens)


# ---------------------------------------------------------------------------
# The hybrid, ssm and audio families
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ["zamba2_7b", "xlstm_350m", "whisper_small"]


def family_pair(arch):
    """(cfg, cpu model, card model): the smoke model drawn on the CPU, copied
    to the card (``head_source`` too)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model_zoo import get_model

    cfg = smoke_config(arch)
    api = get_model(cfg)
    host = api.init_params(torch.Generator().manual_seed(0), 64)
    card = api.build("cuda", 64)
    card.load_state_dict(host.state_dict())
    card.keep_head_source(host.head_source)
    return cfg, host, card


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_on_the_card_equals_the_cpu(no_tf32, arch):
    """Smoke config at float32: prefill, 10 decode steps (logits and every
    cache entry; Whisper over a filled cross cache) within rtol = atol =
    1e-4, and ``ServingEngine.generate`` tokens equal."""
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve import ServingEngine

    cfg, host, card = family_pair(arch)
    api = get_model(cfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 10))
    batch = {"tokens": toks}
    if cfg.family == "audio":
        batch["frame_embeds"] = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    on = lambda dev: {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}  # noqa: E731
    np.testing.assert_allclose(api.prefill(card, on("cuda")).cpu().numpy(),
                               api.prefill(host, on("cpu")).numpy(), rtol=1e-4, atol=1e-4)
    caches = {}
    for dev, model in (("cpu", host), ("cuda", card)):
        cache = api.init_cache(2, 64, dev)
        if cfg.family == "audio":
            enc = model.encode(on(dev)["frame_embeds"])
            cache["cross_k"], cache["cross_v"] = model.build_cross_cache(enc, pad_to=64)
            cache["cross_len"].fill_(enc.shape[1])
        steps = []
        for t in range(toks.shape[1]):
            logits, cache = api.decode_step(model, cache, on(dev)["tokens"][:, t:t + 1], t)
            steps.append(logits.cpu().numpy())
        caches[dev] = (np.stack(steps), cache)
    np.testing.assert_allclose(caches["cuda"][0], caches["cpu"][0], rtol=1e-4, atol=1e-4)
    for name, want in caches["cpu"][1].items():
        np.testing.assert_allclose(caches["cuda"][1][name].cpu().float().numpy(),
                                   want.float().numpy(), rtol=1e-4, atol=1e-4)
    prompt = rng.integers(0, cfg.vocab_size, (4, 5))
    got, want = (ServingEngine(cfg, m, batch_size=4, max_seq=64, device=dev).generate(prompt, 6)
                 for m, dev in ((card, "cuda"), (host, "cpu")))
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_full_width_block_chunked_equals_stepped(no_tf32, kind):
    """One block at its deployment's full width (Zamba2-7B's Mamba2, xLSTM-350M's
    mLSTM and sLSTM) at float32: the chunked block over 256 positions (two
    chunks) against its decode block stepped 256 times, within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import ssm, xlstm

    cfg = get_config("zamba2_7b" if kind == "mamba" else "xlstm_350m")
    cfg = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    init, shapes, full_fn = {"mamba": (ssm.init_mamba, ssm.mamba_shapes, ssm.mamba_block),
                             "mlstm": (xlstm.init_mlstm, xlstm.mlstm_shapes, xlstm.mlstm_block),
                             "slstm": (xlstm.init_slstm, xlstm.slstm_shapes,
                                       xlstm.slstm_block)}[kind]
    blk = L.ParamGroup(shapes(cfg), "cuda")
    L.load_tree(blk, init(gen, cfg))
    x = torch.randn((2, 256, cfg.d_model), generator=gen, device="cuda") * 0.5
    full = full_fn(blk, x, cfg)
    if kind == "mamba":
        _, h, p, n, conv_dim = ssm.dims(cfg)
        state = (torch.zeros(2, h, p, n, device="cuda"),
                 torch.zeros(2, cfg.ssm_conv - 1, conv_dim, device="cuda"))
    elif kind == "mlstm":
        di, h, dh = xlstm.dims(cfg)
        state = (torch.zeros(2, h, dh, dh, device="cuda"), torch.zeros(2, h, dh, device="cuda"),
                 torch.full((2, h), xlstm.MIN_LOG, device="cuda"),
                 torch.zeros(2, cfg.ssm_conv - 1, di, device="cuda"))
    else:
        state = xlstm.slstm_state(cfg, 2, "cuda")
    outs = []
    for t in range(256):
        if kind == "mamba":
            o, *state = ssm.mamba_decode_block(blk, x[:, t:t + 1], *state, cfg)
        elif kind == "mlstm":
            o, *state = xlstm.mlstm_decode_block(blk, x[:, t:t + 1], *state, cfg)
        else:
            o, state = xlstm.slstm_decode_block(blk, x[:, t:t + 1], state, cfg)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).cpu().numpy(), full.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Training on the card
# ---------------------------------------------------------------------------

def test_train_step_on_the_card_equals_the_cpu(no_tf32):
    """One step of ``make_train_step`` (smoke smollm, float32, 2 microbatches)
    on the card against the same step on the CPU, from the same masters and
    batch, within ``parity.STEP_TOL``."""
    from repro_torch.train import parity

    diffs = parity.step_vs_cpu("cuda")
    for key, tol in parity.STEP_TOL.items():
        assert diffs[key] <= tol, (key, diffs[key])
    assert diffs["masters_on_device"] and diffs["model_refreshed"]


def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    from repro_torch.train.checkpoint import CheckpointManager

    state = {"params": {"w": torch.randn(4, 5, device="cuda"),
                        "b": torch.randn(7).to(torch.bfloat16)},
             "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(3, state)
    mgr.wait()
    step, back = mgr.restore(state, device="cuda")
    assert step == 3
    assert back["params"]["w"].is_cuda and torch.equal(back["params"]["w"], state["params"]["w"])
    assert back["params"]["b"].dtype == torch.bfloat16 and back["params"]["b"].is_cuda
    assert torch.equal(back["params"]["b"].cpu().view(torch.int16),
                       state["params"]["b"].view(torch.int16))
    assert back["opt"]["step"].shape == () and int(back["opt"]["step"]) == 3


def test_launch_train_smoke_on_the_card(cuda, tmp_path):
    """``launch/train.py --smoke`` with no ``--device``: it trains on the card."""
    from repro_torch.launch import train as launch_train

    out = launch_train.main(["--arch", "smollm-360m", "--smoke", "--steps", "4", "--batch",
                             "4", "--seq", "64", "--microbatches", "2", "--checkpoint-dir",
                             str(tmp_path), "--checkpoint-every", "2"])
    assert len(out["history"]) == 4 and np.isfinite(out["history"]).all()
    assert all(p.is_cuda for p in out["params"].parameters())
    # the launcher trains on the host mesh: the masters are its pieces
    assert all(t.is_cuda for a in out["masters"].values() for t in a.pieces.values())
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000002.npz", "ckpt_00000004.npz"]


# ---------------------------------------------------------------------------
# The training mesh on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def deterministic(no_tf32):
    """Deterministic kernels (the embedding's backward sums in a fixed
    order), so two runs of the same step give the same bits."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield no_tf32
    torch.use_deterministic_algorithms(False)


def train_card_mesh(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import DeviceMesh

    return DeviceMesh(np.full(shape, torch.device("cuda", 0), dtype=object), axes)


def test_train_on_a_card_mesh_is_train_without(deterministic, tmp_path):
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch.mesh import gather
    from repro_torch.train.loop import train

    cfg, shape = smoke_config("smollm_360m"), ShapeConfig("t", "train", 64, 4)
    outs = []
    for i, mesh in enumerate((None, train_card_mesh((2, 2)))):
        tc = TrainConfig(steps=3, warmup_steps=1, learning_rate=1e-3, microbatches=2,
                         checkpoint_every=0, checkpoint_dir=str(tmp_path / str(i)))
        outs.append(train(cfg, shape, tc, mesh=mesh, log_every=100))
    plain, meshed = outs
    assert plain["history"] == meshed["history"]
    for name, t in plain["masters"].items():
        arr = meshed["masters"][name]
        assert all(p.is_cuda for p in arr.pieces.values())
        assert torch.equal(t, gather(arr, "cuda")), name


def test_elastic_resume_on_the_card(deterministic, tmp_path):
    import shutil

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch.mesh import gather
    from repro_torch.train.loop import train

    cfg, shape = smoke_config("smollm_360m"), ShapeConfig("t", "train", 64, 4)
    tc = TrainConfig(steps=4, warmup_steps=1, learning_rate=1e-3, checkpoint_every=2,
                     checkpoint_dir=str(tmp_path / "full"))
    full = train(cfg, shape, tc, mesh=train_card_mesh((2, 2)), log_every=100)
    (tmp_path / "part").mkdir()
    shutil.copy(tmp_path / "full" / "ckpt_00000002.npz", tmp_path / "part")
    again = train(cfg, shape, dataclasses.replace(tc, checkpoint_dir=str(tmp_path / "part")),
                  mesh=train_card_mesh((4, 1)), log_every=100)
    assert again["history"] == full["history"][2:]
    for name, arr in full["masters"].items():
        assert torch.equal(gather(again["masters"][name], "cuda"), gather(arr, "cuda")), name


def test_pipeline_on_a_card_mesh(no_tf32):
    from repro_torch.configs import smoke_config
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train.pipeline import pipelined_loss_fn

    cfg = dataclasses.replace(smoke_config("granite_8b"), num_layers=4)
    model = get_model(cfg).init_params(torch.Generator("cuda").manual_seed(0), 32)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32))
             .cuda() for k in ("tokens", "labels")}
    names, weights = zip(*model.named_parameters())
    for w in weights:
        w.requires_grad_(True)
    want = model.loss_fn(batch)
    g_want = torch.autograd.grad(want, weights)
    mesh = train_card_mesh((4, 1, 1), ("stage", "data", "model"))
    got = pipelined_loss_fn(model, cfg, batch, mesh, 4)
    g_got = torch.autograd.grad(got, weights)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    for name, a, b in zip(names, g_got, g_want):
        assert float((a - b).abs().max()) < 1e-4 * max(float(b.abs().max()), 1.0), name


# ---------------------------------------------------------------------------
# The dry run: counts on the card against the meta traces
# ---------------------------------------------------------------------------

def one_position(device):
    from repro_torch.launch.mesh import DeviceMesh

    return DeviceMesh(np.full((1, 1), torch.device(device), dtype=object), ("data", "model"))


@pytest.mark.parametrize("arch,kind", [("smollm_360m", "train"), ("mixtral_8x7b", "train"),
                                       ("whisper_small", "train"), ("xlstm_350m", "prefill"),
                                       ("qwen25_3b", "decode"), ("zamba2_7b", "decode")])
def test_dryrun_step_counted_on_the_card_equals_its_meta_trace(no_tf32, arch, kind):
    """A smoke cell's step built on a one-position mesh of this card, run
    once under ``op_costs.OpCounter``: the same FLOPs, bytes and argument
    bytes as the ``meta`` trace, to the unit (the ops the port dispatches
    do not depend on the device)."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, op_costs

    cfg = smoke_config(arch)
    shape = ShapeConfig("t", kind, 32, 8)
    mb = 2 if kind == "train" else 1
    trace = dryrun.trace_cell(cfg, shape, one_position("meta"), microbatches=mb)
    fn, args = dryrun.build_cell(cfg, shape, one_position(no_tf32), microbatches=mb)
    held = sum(t.numel() * t.element_size() for t in dryrun._at_first(args, (0, 0)))
    K.reset_launch_counts()
    with op_costs.OpCounter() as counter:
        out = fn(*args)
    torch.cuda.synchronize()
    got = counter.costs()
    assert {t.device.type for t in op_costs._tensors(out)} == {"cuda"}
    assert got["flops"] == trace["roofline"]["flops"] > 0
    assert got["flops_f32"] == trace["roofline"]["flops_f32"]
    assert held == trace["memory"]["argument_size_in_bytes"]
    assert got["hbm_bytes"] == trace["roofline"]["hbm_bytes"]
    assert got["convert_bytes"] == trace["roofline"]["convert_bytes"]
    assert (K.bscsr_topk_spmv.launches, K.bscsr_topk_spmv_multiquery.launches,
            K.bscsr_spmv.launches) == (0, 0, 0)


def test_kernel_wrappers_record_the_same_cost_on_the_card_and_on_meta(cuda):
    """Each wrapper once on card tensors and once on ``meta`` tensors of the
    same shapes under two counters: one record each, equal on both devices,
    one launch on the card and none on ``meta``."""
    from repro_torch.launch import op_costs

    csr = dyadic_csr(400, 512, seed=5)
    packed = ops.pack_partitions(csr, 4, 256, "BF16", packets_multiple=2, stream_layout="fused")
    kw = dict(n_rows=packed.max_slots, packets_per_step=2, fmt_name="BF16", block_size=256)
    words = torch.from_numpy(packed.words).to(cuda)
    xs = torch.ones((37, 512), device=cuda)
    calls = {"bscsr_topk_spmv": lambda x, w: K.bscsr_topk_spmv(x[0], w, k=8, **kw),
             "bscsr_topk_spmv_multiquery":
                 lambda x, w: K.bscsr_topk_spmv_multiquery(x, w, k=8, **kw),
             "bscsr_spmv": lambda x, w: K.bscsr_spmv(x[0], w, **kw)}
    for name, call in calls.items():
        records = {}
        for dev in (cuda, torch.device("meta")):
            x, w = xs.to(dev), words.to(dev)
            K.reset_launch_counts()
            with op_costs.OpCounter() as outer, op_costs.OpCounter() as inner:
                out = call(x, w)
            torch.cuda.synchronize()
            assert getattr(K, name).launches == (1 if dev.type == "cuda" else 0)
            assert outer.costs()["kernels"] == inner.costs()["kernels"]
            assert outer.costs()["hbm_bytes"] == outer.costs()["kernels"][name]["hbm_bytes"]
            records[dev.type] = (outer.costs()["kernels"], [
                (tuple(t.shape), t.dtype) for t in (out if isinstance(out, tuple) else (out,))])
        assert records["cuda"] == records["meta"]
        assert records["cuda"][0][name]["calls"] == 1


def test_index_wait_holds_the_device_time_of_a_traced_pass(cuda):
    """A traced Q = 64 pass over the paper's 10M rows: the device's time for
    the pass (CUDA events around the executor's pass on a batch already on
    the card) lies between the start of ``executor.launch`` and the end of
    ``index.wait`` within 10% (the host's enqueue of the finalize overlaps
    the kernel, and the wait holds the rest); the copies back are short
    beside the wait; and a span's start on the profiler's clock is within
    200 us of its ``record_function`` twin's.  The pass must outlast the
    host's enqueue (about 1.5 ms) for the wait to hold anything: at 1M rows
    the kernel takes about 0.5 ms on an H100, at 10M about 5 ms."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.utils import tracing

    csr = bscsr.synthetic_embedding_csr(10_000_000, 512, 20, "gamma", seed=7)
    index = SparseEmbeddingIndex(csr, api.TopKSpMVConfig(
        big_k=100, k=8, num_partitions=32, block_size=256, packets_per_step=2,
        stream_layout="fused", value_format="BF16", device="cuda"))
    xs = np.random.default_rng(8).standard_normal((64, 512)).astype(np.float32)
    for _ in range(3):             # pin, build, warm
        index.query_batch(xs)
    xd, ex = torch.from_numpy(xs).to(cuda), api.query_executor(index.config)
    device_ns = []
    for _ in range(7):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        ex.query_batched(xd, index.index.packed)
        b.record()
        torch.cuda.synchronize()
        device_ns.append(a.elapsed_time(b) * 1e6)
    tracing.reset()
    try:
        with tracing.recording():
            for _ in range(7):
                index.query_batch(xs)
        recs = tracing.records()
        spans = {name: [r for r in recs if r.name == name]
                 for name in ("executor.launch", "index.wait", "index.d2h")}
        assert all(len(v) == 7 for v in spans.values())
        covered = [w.end_ns - la.start_ns
                   for la, w in zip(spans["executor.launch"], spans["index.wait"])]
        waits = [w.end_ns - w.start_ns for w in spans["index.wait"]]
        device = np.median(device_ns)
        assert 0.9 * device <= np.median(covered) <= 1.1 * device, (covered, device_ns)
        copies = [d.end_ns - d.start_ns for d in spans["index.d2h"]]
        assert np.median(copies) < 0.1 * np.median(waits), (copies, waits)
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                index.query_batch(xs)
        ours = [r.start_ns for r in tracing.records() if r.name == "index.query_batch"]
        twins = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                       if e.name() == "index.query_batch")
        assert len(ours) == len(twins) == 4
        gaps = [abs(t - o) for t, o in zip(twins[1:], ours[1:])]
        assert max(gaps) < 200_000, gaps
    finally:
        tracing.reset()
