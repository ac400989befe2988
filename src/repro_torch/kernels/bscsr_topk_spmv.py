"""BS-CSR Top-K SpMV kernels for Hopper, with their plain PyTorch versions.

Three kernels, each the port of one Pallas TPU kernel of
``repro.kernels.bscsr_topk_spmv``:

  bscsr_topk_spmv             one query per stream pass      -> (C, k)
  bscsr_topk_spmv_multiquery  Q queries share one stream pass -> (C, Q, k)
  bscsr_spmv                  accumulate mode, every slot sum -> (C, n_rows)

All three take the fused word stream ``(C, P, W)`` int32 (``flags | cols |
vals`` per packet, see ``core/bscsr.py``).  Split-layout snapshots reach
them as ``fused_words()``, which is bit-identical.  The CUDA source is
``repro_torch/csrc/bscsr_topk_spmv.cu``.  All three split each core's
stream among S CTAs at steps that hold a flag bit (``spmv_split_table``)
and stop at the core's last flagged step, though the stage-3 row carry
crosses packet boundaries.  The accumulate kernel joins the splits with an
exact carry fix-up; the two top-k kernels give each split its own
scratchpads and fold them (one fold kernel serves both: the top k of
every split's scratchpad and head row, gathered over a warp's lanes), with
each split's head row scored as head piece + the previous split's carry.
Every S gives the single walk's bits.  The single-query kernel stages its
steps through a ring in shared memory with bulk copies.

A mixed-precision snapshot streams one tagged word array per storage-width
class (``fmt_name`` TAG4, TAG2 or TAG1): each packet row leads with one
header word holding the partition's format code, every section moves right
by one word, and in TAG2 the code picks BF16 or Q15 for the shared 2-byte
value words.  The plain versions read the tag of each step's first packet,
as the Pallas kernels do; the CUDA kernels take the words one int32 past
the first header and read each core's header once.  The two agree because
every row of a partition's stream, padding included, carries its code.

Each wrapper dispatches on where its tensors lie.  CPU tensors go to the
plain version; CUDA tensors launch the kernel (and add one to the wrapper's
``launches`` count) or raise.  Nothing falls back from one to the other.
``meta`` tensors (the dry run's device, ``launch/dryrun.py``) get outputs
of the right shape and dtype and launch nothing.  On ``meta`` and CUDA
tensors the wrapper's body runs under ``costs.opaque()`` and records the
kernel's cost with every active ``launch.op_costs.OpCounter``
(:func:`_record_cost`).

The plain versions are step-faithful to the Pallas kernels: the same tile
walk of T packets per step, the same stages, vectorised over cores and
queries with a Python loop over steps.

  stage 1  decode the fused tile, gather x (out-of-range ids read 0), multiply
  stage 2  segment sums as differences of an inclusive prefix sum
  stage 3  add the carried open row; the last segment of a step stays open
  stage 4  candidates strictly above the scratchpad minimum (taken at the
           start of the step) are merged into the k-sized scratchpad
  stage 4' (accumulate mode) each completed row is stored at its slot

Stages 1-3 are shared by all three (``_plain_steps`` here; in the CUDA
source ``single_walk``, ``mq_walk`` and ``accum_walk``, with the same
arithmetic).  The multi-query kernel's walk at Q >= 2 (``rows_walk``) sums
each segment's products in stream order instead of as a prefix
difference: the same bits on dyadic data, and
:func:`bscsr_topk_spmv_multiquery_emulated` (``_plain_steps`` with
``sums="rows"``) gives its bits on any data.

Stage 4 ranks as ``lax.top_k`` does: float total order (-0.0 below +0.0),
lower position first on ties, which puts scratchpad entries before
candidates and lower slots first.  The admission test is an IEEE ``>``
against the step-start minimum, so a +0.0 candidate never displaces a -0.0
incumbent across steps but can within one step.  The kernel follows the same
rule; ``torch.topk`` is neither stable nor ordered like ``lax.top_k`` and is
not used.

``gather_mode`` ("take" | "onehot") and ``inner_loop`` (the four reference
loop variants) are accepted and served by one gather and one stage rule: on
the TPU they work around MXU and Mosaic limits.  The rule is that of
"linear" and "linear-topk", which these versions reproduce exactly.  Under
"legacy" and "linear-seg" the reference admits with a k-pass argmax
instead.  Its scores are the same, bit for bit: the two rules part only at
a tie of +0.0 with -0.0, and no candidate scores -0.0 (stage 3 adds +0.0 or
the carry, which is never -0.0, to every segment sum).  Its row ids are the
same beside every score above NEG_INF; an unfilled scratchpad entry keeps
``n_rows`` here but repeats an earlier row there.  The merge rewrites both
to the sentinel, so the answers agree.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.quantization import STREAM_FORMATS, TaggedFormatClass, ValueFormat
from repro_torch.kernels import costs

NEG_INF = float(np.finfo(np.float32).min)
FLAG_WORD_BITS = 32
INNER_LOOPS = ("linear", "legacy", "linear-seg", "linear-topk")
GATHER_MODES = ("take", "onehot")
# The kernels' format codes.  TAG4 and TAG1 have one member each and launch
# as it; TAG2's kernels read each core's header word once and decode BF16 or
# Q15 by it.
_FMT_IDS = {"F32": 0, "BF16": 1, "Q15": 2, "Q7": 3, "TAG4": 0, "TAG2": 4, "TAG1": 3}
MAX_TILE_NNZ = 1024  # T*B: one CUDA thread per nnz of a step


# ---------------------------------------------------------------------------
# Shared argument checks
# ---------------------------------------------------------------------------

def _header_words(fmt) -> int:
    """Words before the flag section of a packet row: 1 for a tagged class."""
    return 1 if isinstance(fmt, TaggedFormatClass) else 0


def _fused_geometry(width: int, block: int, fmt) -> int:
    """Validate a fused stream width and return its col-section word count."""
    wf = block // FLAG_WORD_BITS
    wv = block * int(fmt.bytes_per_value) // 4
    col_words = width - _header_words(fmt) - wf - wv
    if col_words not in (block // 2, block):
        raise ValueError(
            f"fused stream width {width} inconsistent with block={block}, "
            f"fmt={fmt.name}: col section would be {col_words} words"
        )
    return col_words


def _resolve(fmt_name: str, words: torch.Tensor, block_size: int,
             packets_per_step: int, k: int, gather_mode: str, inner_loop: str):
    """Checks shared by every kernel -> (fmt, col_words).

    ``fmt`` is a ``ValueFormat`` or, for one width-class group of a
    mixed-precision snapshot, a ``TaggedFormatClass`` (TAG4, TAG2, TAG1),
    whose packet rows lead with one header word holding the partition's
    format code.
    """
    fmt = STREAM_FORMATS[fmt_name]
    if inner_loop not in INNER_LOOPS:
        raise ValueError(f"inner_loop must be one of {INNER_LOOPS}, got {inner_loop!r}")
    if gather_mode not in GATHER_MODES:
        raise ValueError(f"gather_mode must be one of {GATHER_MODES}, got {gather_mode!r}")
    if words.dim() != 3 or words.dtype != torch.int32:
        raise ValueError(f"words must be a (C, P, W) int32 tensor, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if block_size % FLAG_WORD_BITS:
        raise ValueError("block size must be a multiple of 32")
    col_words = _fused_geometry(words.shape[2], block_size, fmt)
    n_packets = words.shape[1]
    if packets_per_step < 1 or n_packets % packets_per_step:
        raise ValueError(
            f"packet count {n_packets} is not a multiple of packets_per_step "
            f"{packets_per_step}"
        )
    tb = packets_per_step * block_size
    if not 1 <= k <= tb + 1:
        raise ValueError(f"k={k} must lie in [1, T*B+1={tb + 1}]")
    return fmt, col_words


# ---------------------------------------------------------------------------
# Plain PyTorch versions (step-faithful to the Pallas kernels)
# ---------------------------------------------------------------------------

def _total_order_key(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 key in float total order (-0.0 below +0.0)."""
    b = v.view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def _stable_topk(v: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: total order desc, lower index first."""
    order = torch.sort(_total_order_key(v), dim=-1, descending=True, stable=True)
    idx = order.indices[..., :k]
    return torch.gather(v, -1, idx), idx


def _decode_val_words(vw: torch.Tensor, fmt: ValueFormat) -> torch.Tensor:
    """Value-section words (C, T, Wv) -> (C, T * values a row) f32."""
    c = vw.shape[0]
    if fmt.storage_dtype == "float32":
        v = vw.view(torch.float32)
    elif fmt.storage_dtype == "bfloat16":
        v = vw.view(torch.bfloat16).float()
    elif fmt.storage_dtype == "int16":
        v = vw.view(torch.int16).float() * fmt.scale
    else:
        v = vw.view(torch.int8).float() * fmt.scale
    return v.reshape(c, -1)


def _decode_fused_tile(tile: torch.Tensor, block: int, fmt, col_words: int):
    """(C, T, W) words -> flag bits (C, TB) int32, cols (C, TB) int64, vals (C, TB) f32.

    For a tagged width class (``TaggedFormatClass``) the packet rows are
    ``header | flags | cols | vals`` and every section moves right by one
    word.  A class of one member decodes as that format.  In TAG2, BF16 and
    Q15 share 2-byte value words: both decodes are made and each core's tag
    picks one, where the tag is the header of the step's first packet (the
    reference's ``words[0, 0, 0]`` of the tile); any tag but Q15's means
    BF16.
    """
    c, t, _ = tile.shape
    h = _header_words(fmt)
    wf = block // FLAG_WORD_BITS
    shifts = torch.arange(FLAG_WORD_BITS, dtype=torch.int32, device=tile.device)
    f = ((tile[..., h : h + wf].unsqueeze(-1) >> shifts) & 1).reshape(c, t * block)
    cw = tile[..., h + wf : h + wf + col_words].contiguous()
    if col_words == block:
        cols = cw.reshape(c, -1)
    else:
        cols = cw.view(torch.int16).reshape(c, -1)
    vw = tile[..., h + wf + col_words :].contiguous()
    if not h:
        return f, cols.long(), _decode_val_words(vw, fmt)
    members = fmt.member_formats
    v = _decode_val_words(vw, members[0])
    tag = tile[:, 0, 0, None]
    for m in members[1:]:
        v = torch.where(tag == m.code, _decode_val_words(vw, m), v)
    return f, cols.long(), v


def _plain_steps(x: torch.Tensor, words: torch.Tensor, *, packets_per_step: int,
                 fmt, block: int, col_words: int, start=None, stop=None,
                 row=None, sums: str = "prefix"):
    """Stages 1-3 of the Pallas tile walk for a (Q, M) batch, step by step.

    Each core walks steps ``[start, stop)`` ((C,) tensors; the whole stream
    by default) from carry row ``row`` ((C,), -1 by default) and a carry of
    0.0.  Yields ``(cand_v, cand_r, complete, carry_sum)`` per step: (C, Q,
    TB+1) segment sums with the carried open row added to segment 0, (C,
    TB+1) int32 slot ids, the (C, TB+1) mask of segments that complete in
    this step, and the (C, Q) carry after it.  A core past its ``stop``
    completes nothing and keeps its carry.

    ``sums`` is the association of a segment's sum in a step: "prefix", the
    difference of the step's inclusive prefix sums (the Pallas kernels and
    the card's one-query walks); "rows", its products added in stream order
    from +0.0 (the card's multi-query walk at Q >= 2).
    """
    dev = words.device
    n_cores = words.shape[0]
    nq, m = x.shape
    t = packets_per_step
    tb = t * block
    n_steps = words.shape[1] // t
    x = x.float()
    if start is None:
        start = torch.zeros(n_cores, dtype=torch.int64, device=dev)
        stop = torch.full((n_cores,), n_steps, dtype=torch.int64, device=dev)
    length = (stop - start).long()
    carry_row = (torch.full((n_cores,), -1, dtype=torch.int32, device=dev) if row is None
                 else row.to(torch.int32))
    carry_sum = torch.zeros((n_cores, nq), dtype=torch.float32, device=dev)
    seg_ids = torch.arange(tb + 1, dtype=torch.int32, device=dev)
    ones = torch.ones((n_cores, 1), dtype=torch.int32, device=dev)
    cores = torch.arange(n_cores, device=dev)[:, None]
    packets = torch.arange(t, device=dev)
    for j in range(int(length.max())):
        active = j < length                                         # (C,)
        step = torch.clamp(start.long() + j, max=n_steps - 1)
        # ---- stage 1: decode, gather x (clip + mask), multiply ----
        f, c, v = _decode_fused_tile(words[cores, step[:, None] * t + packets], block,
                                     fmt, col_words)
        oob = (c < 0) | (c >= m)
        xv = x[:, torch.clamp(c, 0, m - 1)].permute(1, 0, 2)        # (C, Q, TB)
        xv = torch.where(oob[:, None, :], 0.0, xv)
        prods = v[:, None, :] * xv
        # ---- stage 2: segment sums by prefix-sum differencing ----
        seg = torch.cumsum(f, dim=-1, dtype=torch.int32)            # (C, TB)
        s_last = seg[:, -1].long()
        is_last = torch.cat([f[:, 1:], ones], dim=-1) == 1
        slot = torch.where(is_last, seg, tb + 1).long()
        if sums == "rows":
            ps = _segment_runs(prods, f)
        else:
            ps = torch.cumsum(prods, dim=-1)
        ends = torch.zeros((n_cores, nq, tb + 2), dtype=torch.float32, device=dev)
        ends.scatter_(-1, slot[:, None, :].expand(-1, nq, -1), ps)
        ends = ends[..., : tb + 1]
        if sums == "rows":
            seg_sums = ends                                         # (C, Q, TB+1)
        else:
            prev = torch.cat([ends.new_zeros((n_cores, nq, 1)), ends[..., :-1]], dim=-1)
            seg_sums = ends - prev
        # ---- stage 3: cross-step carry of the open row ----
        part = carry_sum
        cand_v = seg_sums + torch.where(seg_ids == 0, part[..., None], 0.0)
        cand_r = carry_row[:, None] + seg_ids                       # (C, TB+1)
        complete = (seg_ids < s_last[:, None]) & (cand_r >= 0) & active[:, None]
        carry_row = torch.where(active, carry_row + s_last.int(), carry_row)
        last_sum = torch.gather(seg_sums, -1, s_last[:, None, None].expand(-1, nq, 1))
        carry_sum = torch.where(
            active[:, None],
            last_sum[..., 0] + torch.where(s_last[:, None] == 0, part, 0.0), carry_sum)
        yield cand_v, cand_r, complete, carry_sum


def _segment_runs(prods: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """(C, Q, TB) products, (C, TB) flag bits -> each nnz's running sum of
    its segment: the products in stream order from +0.0, restarting at every
    flag bit (no reassociation: one f32 addition per nnz)."""
    runs = torch.empty_like(prods)
    acc = prods.new_zeros(prods.shape[:-1])
    starts = (f == 1)[:, None, :]
    for j in range(prods.shape[-1]):
        acc = torch.where(starts[..., j], 0.0, acc) + prods[..., j]
        runs[..., j] = acc
    return runs


def _walk_plain(x: torch.Tensor, words: torch.Tensor, *, k: int, n_rows: int,
                packets_per_step: int, fmt, block: int, col_words: int,
                sums: str = "prefix") -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pallas top-k tile walk for a (Q, M) query batch -> (C, Q, k) each."""
    acc_v, acc_r = _empty_scratchpad(words.shape[0], x.shape[0], k, n_rows, words.device)
    for cand_v, cand_r, complete, _ in _plain_steps(
            x, words, packets_per_step=packets_per_step, fmt=fmt, block=block,
            col_words=col_words, sums=sums):
        acc_v, acc_r = _admit(acc_v, acc_r, cand_v, cand_r, complete, k)
    return acc_v, acc_r


def _empty_scratchpad(n_cores: int, nq: int, k: int, n_rows: int, dev):
    """(C, Q, k) scratchpads of (NEG_INF, n_rows) entries."""
    return (torch.full((n_cores, nq, k), NEG_INF, dtype=torch.float32, device=dev),
            torch.full((n_cores, nq, k), n_rows, dtype=torch.int32, device=dev))


def _admit(acc_v, acc_r, cand_v, cand_r, complete, k):
    """Stage 4: candidates strictly above the step-start minimum, one stable
    top-k merge into the (C, Q, k) scratchpad (entries before candidates)."""
    nq = acc_v.shape[1]
    cand_v = torch.where(complete[:, None, :], cand_v, NEG_INF)
    thr = acc_v.min(dim=-1, keepdim=True).values
    fv = torch.where(cand_v > thr, cand_v, NEG_INF)
    cv, ci = _stable_topk(fv, k)
    cr = torch.gather(cand_r[:, None, :].expand(-1, nq, -1), -1, ci)
    pool_v = torch.cat([acc_v, cv], dim=-1)
    pool_r = torch.cat([acc_r, cr], dim=-1)
    acc_v, mi = _stable_topk(pool_v, k)
    return acc_v, torch.gather(pool_r, -1, mi)


def _walk_plain_split(x: torch.Tensor, words: torch.Tensor, table, *, k: int, n_rows: int,
                      **walk) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k walk as S walkers per core see it, joined by the in-order fold.

    Each split walks its steps of ``table`` (:func:`spmv_split_table`) from
    carry 0.0 at its head row with a scratchpad of (NEG_INF, n_rows).  At the
    first step of a split after the first, segment 0 (the row open there) is
    not a candidate: its per-query head piece is kept, and so is every
    split's final carry.  Then the splits fold in order: the head score is
    head piece + the previous split's carry (the single walk's stage-3
    addition for that row), admitted when ``>`` the fold's minimum, and the
    split's own k entries merge in.  The single walk's scratchpad is the top
    k of its completed rows in ``lax.top_k`` order (slots rise along the
    walk, no candidate scores -0.0, NaN is never admitted), so the fold
    gives its bits.
    """
    dev = words.device
    n_cores, nq = words.shape[0], x.shape[0]
    bounds, head_row = (t.to(dev) for t in table)
    fold_v, fold_r = _empty_scratchpad(n_cores, nq, k, n_rows, dev)
    carry = torch.zeros((n_cores, nq), dtype=torch.float32, device=dev)
    for i in range(bounds.shape[1] - 1):
        first, stop = bounds[:, i], bounds[:, i + 1]
        acc_v, acc_r = _empty_scratchpad(n_cores, nq, k, n_rows, dev)
        head = torch.zeros((n_cores, nq), dtype=torch.float32, device=dev)
        carry_out = torch.zeros((n_cores, nq), dtype=torch.float32, device=dev)
        for j, (cand_v, cand_r, complete, carry_sum) in enumerate(_plain_steps(
                x, words, start=first, stop=stop, row=head_row[:, i], **walk)):
            if i > 0 and j == 0:
                head = cand_v[..., 0]
                complete = complete.clone()
                complete[:, 0] = False
            acc_v, acc_r = _admit(acc_v, acc_r, cand_v, cand_r, complete, k)
            carry_out = carry_sum
        if i == 0:
            fold_v, fold_r = acc_v, acc_r
        else:
            score = head + carry
            live = ((first < stop) & (head_row[:, i] >= 0))[:, None]
            admit = live & (score > fold_v.min(dim=-1).values)
            pool_v = torch.cat([fold_v, torch.where(admit, score, NEG_INF)[..., None], acc_v],
                               dim=-1)
            slot = torch.where(admit, head_row[:, i, None], n_rows).to(torch.int32)
            pool_r = torch.cat([fold_r, slot[..., None], acc_r], dim=-1)
            fold_v, mi = _stable_topk(pool_v, k)
            fold_r = torch.gather(pool_r, -1, mi)
        carry = carry_out
    return fold_v, fold_r


def bscsr_topk_spmv_plain(x, words, *, k, n_rows, packets_per_step=2, fmt_name="F32",
                          block_size=256, gather_mode="take", inner_loop="linear",
                          splits=None, table=None):
    """Plain PyTorch version of :func:`bscsr_topk_spmv` -> (C, k) each.

    With neither ``splits`` nor ``table`` it is the single walk; with either
    it walks each split with its own scratchpad and folds them in order, as
    the kernel's blocks do (``_walk_plain_split`` at one query), which gives
    the single walk's bits.
    """
    _resolve(fmt_name, words, block_size, packets_per_step, k, gather_mode, inner_loop)
    v, r = bscsr_topk_spmv_multiquery_plain(
        x.reshape(1, -1), words, k=k, n_rows=n_rows, packets_per_step=packets_per_step,
        fmt_name=fmt_name, block_size=block_size, inner_loop=inner_loop, splits=splits,
        table=table)
    return v[:, 0], r[:, 0]


def bscsr_topk_spmv_multiquery_plain(x, words, *, k, n_rows, packets_per_step=2,
                                     fmt_name="F32", block_size=256,
                                     inner_loop="linear", splits=None, table=None):
    """Plain PyTorch version of :func:`bscsr_topk_spmv_multiquery` -> (C, Q, k).

    With ``splits`` (or a ``table`` from :func:`spmv_split_table`) it walks
    each split of each core with its own scratchpad, as the kernel's blocks
    do, and folds the splits in order (``_walk_plain_split``).  The result
    equals the single walk bit for bit.
    """
    return _multiquery_plain(x, words, k=k, n_rows=n_rows, packets_per_step=packets_per_step,
                             fmt_name=fmt_name, block_size=block_size, inner_loop=inner_loop,
                             splits=splits, table=table, sums="prefix")


def _multiquery_plain(x, words, *, k, n_rows, packets_per_step, fmt_name, block_size,
                      inner_loop, splits, table, sums):
    """The plain multi-query walk with segment sums by ``sums``
    (:func:`_plain_steps`): the single walk, or the split walk and fold."""
    fmt, col_words = _resolve(fmt_name, words, block_size, packets_per_step, k,
                              "take", inner_loop)
    walk = dict(k=k, n_rows=n_rows, packets_per_step=packets_per_step, fmt=fmt,
                block=block_size, col_words=col_words, sums=sums)
    if table is None and splits is None:
        return _walk_plain(x, words, **walk)
    if table is None:
        table = spmv_split_table(words, packets_per_step=packets_per_step,
                                 block_size=block_size, splits=splits,
                                 header=_header_words(fmt))
    return _walk_plain_split(x.float(), words, table, **walk)


def bscsr_topk_spmv_multiquery_emulated(x, words, *, k, n_rows, packets_per_step=2,
                                        fmt_name="F32", block_size=256, splits=None,
                                        table=None):
    """The card's multi-query walk at Q >= 2 (``rows_walk``), step by step on
    any device -> (C, Q, k); no dispatch path calls it.

    It differs from :func:`bscsr_topk_spmv_multiquery_plain` in one place:
    a segment's sum in a step is its products added in stream order from
    +0.0, where plain takes a difference of prefix sums.  Stage 3 is the
    same (one addition of the carry to the step's first segment; the open
    row's carry is the step's piece, plus the carry it came in with when the
    step holds no flag bit), and so are the admission and the fold of
    splits.  So a query's bits depend on neither the other queries, Q, S nor
    how the card lays out its walkers (every walker walks one split of the
    table), and on dyadic data they are plain's.  With ``splits`` or a
    ``table`` it walks and folds the splits as the card does.
    """
    return _multiquery_plain(x, words, k=k, n_rows=n_rows, packets_per_step=packets_per_step,
                             fmt_name=fmt_name, block_size=block_size, inner_loop="linear",
                             splits=splits, table=table, sums="rows")


def _popcount32(w: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, as int64 (bit arithmetic, any device)."""
    v = w.long() & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def spmv_split_table(words: torch.Tensor, *, packets_per_step: int, block_size: int,
                     splits: int, header: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where ``splits`` walkers start on each core's stream -> (bounds, head_row).

    ``bounds`` (C, S+1) int32: split i of core c walks steps
    ``[bounds[c, i], bounds[c, i+1])``.  The first bound is 0 and the last is
    ``e_c``, one past the core's last step that holds a flag bit (0 for a
    core with none): later steps complete no row, so the walk stops there.
    Interior bound i targets ``i * e_c // S`` and moves to the first step at
    or after it that holds a flag bit.  A bound equal to the one before it
    becomes ``e_c``, so empty splits trail.  ``head_row`` (C, S) int32 is the
    slot of the row open at each split's first step: -1 plus the flag bits
    of the steps before it.

    A split that starts at a flagged step completes the row it opens with,
    inside that step, so its sequential sum is one f32 addition of the
    split's head piece and the carry of the split before it: the accumulate
    kernel's fix-up and the multi-query kernel's fold both use it, and both
    walk this table.  Static shapes only (no host sync); the same on the CPU
    and the card.  ``header`` is the number of words before each packet row's
    flag section: 1 for a tagged width-class stream, whose first word is the
    partition's format code and no flag bits.
    """
    if splits < 1:
        raise ValueError(f"splits must be at least 1, got {splits}")
    n_cores, n_packets, _ = words.shape
    dev = words.device
    n_steps = n_packets // packets_per_step
    wf = block_size // FLAG_WORD_BITS
    flag_words = words[:, : n_steps * packets_per_step, header : header + wf]
    counts = _popcount32(flag_words).reshape(n_cores, n_steps, -1).sum(-1)   # (C, steps)
    flagged = counts > 0
    steps = torch.arange(n_steps, device=dev)
    end = torch.where(flagged, steps + 1, 0).amax(-1, keepdim=True)
    # nxt[c, s]: the first flagged step >= s (n_steps when none); reverse cummin.
    nxt = torch.where(flagged, steps, n_steps).flip(-1).cummin(-1).values.flip(-1)
    nxt = torch.cat([nxt, torch.full((n_cores, 1), n_steps, device=dev)], -1)
    i = torch.arange(1, splits, device=dev)
    targets = (i[None, :] * end) // splits                                 # (C, S-1)
    inner = torch.minimum(torch.gather(nxt, -1, targets), end)
    bounds = torch.cat([torch.zeros_like(end), inner, end], -1)
    dup = torch.cat([torch.zeros_like(end, dtype=torch.bool),
                     bounds[:, 1:] == bounds[:, :-1]], -1)
    bounds = torch.sort(torch.where(dup, end, bounds), dim=-1).values
    before = torch.cat([torch.zeros((n_cores, 1), dtype=torch.int64, device=dev),
                        torch.cumsum(counts, -1)], -1)
    head_row = torch.gather(before, -1, bounds[:, :-1]) - 1
    return bounds.to(torch.int32), head_row.to(torch.int32)


def bscsr_spmv_plain(x, words, *, n_rows, packets_per_step=2, fmt_name="F32",
                     block_size=256, gather_mode="take", inner_loop="linear",
                     splits=None, table=None):
    """Plain PyTorch version of :func:`bscsr_spmv` -> (C, n_rows) slot sums.

    Stage 4': every segment that completes in a step lands at its slot as
    ``0.0 + sum``; slots that never complete (the open trailing sentinel,
    phantom slots of a padded budget) stay 0.0.

    With ``splits`` (or a ``table`` from :func:`spmv_split_table`) it walks
    each split of each core from carry 0.0 and its head row, as the kernel's
    blocks do.  A split after the first stores no segment 0 at its first
    step; that head piece plus the previous split's final carry is the open
    row's sequential sum, stored as ``0.0 + (head + carry)`` at the head row
    (the fix-up).  The result equals the single walk bit for bit.
    """
    fmt, col_words = _resolve(fmt_name, words, block_size, packets_per_step, 1,
                              gather_mode, inner_loop)
    n_cores = words.shape[0]
    dev = words.device
    out = torch.zeros((n_cores, n_rows + 1), dtype=torch.float32, device=dev)
    walk = dict(packets_per_step=packets_per_step, fmt=fmt, block=block_size,
                col_words=col_words)
    x = x.reshape(1, -1)

    def store(slots, sums, keep):
        keep = keep & (slots >= 0) & (slots < n_rows)
        out.scatter_add_(-1, torch.where(keep, slots, n_rows).long(),
                         torch.where(keep, sums, 0.0))

    if table is None and splits is None:
        for cand_v, cand_r, complete, _ in _plain_steps(x, words, **walk):
            store(cand_r, cand_v[:, 0], complete)
        return out[:, :n_rows]
    if table is None:
        table = spmv_split_table(words, packets_per_step=packets_per_step,
                                 block_size=block_size, splits=splits,
                                 header=_header_words(fmt))
    bounds, head_row = (t.to(dev) for t in table)
    carry = torch.zeros(n_cores, dtype=torch.float32, device=dev)
    for i in range(bounds.shape[1] - 1):
        first, stop = bounds[:, i], bounds[:, i + 1]
        head = torch.zeros(n_cores, dtype=torch.float32, device=dev)
        carry_out = torch.zeros(n_cores, dtype=torch.float32, device=dev)
        for j, (cand_v, cand_r, complete, carry_sum) in enumerate(_plain_steps(
                x, words, start=first, stop=stop, row=head_row[:, i], **walk)):
            if i > 0 and j == 0:
                # The head piece (+0.0 when bit 0 is set).  The carry it
                # started from is +0.0, which can only turn a -0.0 head into
                # +0.0; the fix-up's outer 0.0 + ... erases that difference.
                head = cand_v[:, 0, 0]
                complete = complete.clone()
                complete[:, 0] = False
            store(cand_r, cand_v[:, 0], complete)
            carry_out = carry_sum[:, 0]
        if i > 0:
            store(head_row[:, i, None], (head + carry)[:, None], (first < stop)[:, None])
        carry = carry_out
    return out[:, :n_rows]


# ---------------------------------------------------------------------------
# CUDA build and binding (nvcc -> shared library with a C interface, ctypes)
# ---------------------------------------------------------------------------

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "bscsr_topk_spmv.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc")
    return path


def build_library(verbose: bool = False) -> Path:
    """Compile the kernel source (once per source content) and return the .so.

    The library goes to ``build/kernels/`` at the repository root, named by
    a hash of the source, and is written under a temporary name first so a
    concurrent build never loads a half-written file.  nvcc's report
    (``-Xptxas -v``: registers, shared memory and spills per kernel) is kept
    beside it with the suffix ``.log``.
    """
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    lib = _BUILD_DIR / f"libbscsr_topk_spmv_{digest}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    lib.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # x, words, out_v, out_r, bounds, head_row, pad_v, pad_r, heads, carries, C,
    # S, P, W, M, B, T, col_words, fmt, k, n_rows, ring depth, step words, stream
    lib.bscsr_topk_spmv_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, ll, i, i, i, i,
                                           i, i, i, i, i, i, p]
    lib.bscsr_topk_spmv_launch.restype = i
    # x, words, out_v, out_r, bounds, head_row, pad_v, pad_r, heads, carries, C,
    # S, P, W, M, Q, B, T, col_words, fmt, k, n_rows, stream
    lib.bscsr_topk_spmv_multiquery_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i,
                                                      ll, i, i, i, i, i, i, i, i, i, p]
    lib.bscsr_topk_spmv_multiquery_launch.restype = i
    # x, words, out_v, out_r, bounds, head_row, pad_v, pad_r, heads, carries, C,
    # S, P, W, packet words, M, Q, queries a block, B, T, col_words, fmt, k,
    # n_rows, stream
    lib.bscsr_topk_spmv_rows_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, ll, i, i,
                                                i, i, i, i, i, i, i, i, i, p]
    lib.bscsr_topk_spmv_rows_launch.restype = i
    # x, words, out, bounds, head_row, heads, carries, C, S, P, W, M, B, T,
    # col_words, fmt, n_rows, stream
    lib.bscsr_spmv_launch.argtypes = [p, p, p, p, p, p, p, i, i, ll, i, i, i, i, i, i, i,
                                      p]
    lib.bscsr_spmv_launch.restype = i
    # B, T, M, out: resident accumulate blocks per SM
    lib.bscsr_spmv_resident_blocks.argtypes = [i, i, i, p]
    lib.bscsr_spmv_resident_blocks.restype = i
    # B, T, M, k, ring depth, step words, out: resident single-query blocks per SM
    lib.bscsr_topk_spmv_resident_blocks.argtypes = [i, i, i, i, i, i, p]
    lib.bscsr_topk_spmv_resident_blocks.restype = i
    # B, T, M, k, out: resident one-query multi-query blocks per SM
    lib.bscsr_topk_spmv_mq_resident_blocks.argtypes = [i, i, i, i, p]
    lib.bscsr_topk_spmv_mq_resident_blocks.restype = i
    # B, T, packet words, M, queries a block, k, out blocks, out walkers: the
    # rows walk's resident blocks per SM and walkers a block
    lib.bscsr_topk_spmv_rows_resident.argtypes = [i, i, i, i, i, i, p, p]
    lib.bscsr_topk_spmv_rows_resident.restype = i
    return lib


def _check_cuda_args(x: torch.Tensor, words: torch.Tensor) -> None:
    if x.device != words.device:
        raise ValueError(f"x on {x.device} but words on {words.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 tensor")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")


def _kernel_words(words: torch.Tensor, fmt) -> int:
    """The words pointer the kernels take.  For a tagged stream it points one
    int32 past the first header, so with the row stride W unchanged every
    section offset of an untagged row lands on the tagged row's section, and
    a core's first header sits one word before its first row."""
    return words.data_ptr() + 4 * _header_words(fmt)


def _check_tile(packets_per_step: int, block_size: int) -> None:
    tb = packets_per_step * block_size
    if tb > MAX_TILE_NNZ:
        raise ValueError(f"T*B={tb} exceeds the kernel's {MAX_TILE_NNZ} nnz per step")


def _step_words(packets_per_step: int, width: int, fmt) -> int:
    """Words of a step that the single-query kernel stages, from its first:
    T rows, less the header word of the next row in a tagged stream (the
    kernel's words start one word past the first header)."""
    return packets_per_step * width - _header_words(fmt)


def _meta_outputs(shape: tuple, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """A top-k kernel's (values, slots) on ``meta``: shapes and dtypes only."""
    return (torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev))


def _record_cost(name: str, x: torch.Tensor, words: torch.Tensor, outs, block_size: int,
                 nq: int) -> None:
    """One launch's cost with every active ``launch.op_costs.OpCounter``:
    bytes of the word stream, x and the outputs, each once; operations
    2 x slots x Q f32 FMAs, slots = C * P * B the stream's slot capacity (a ``meta``
    stream does not know its nnz, which the padding keeps below it)."""
    if not costs.counting():
        return
    n_cores, n_packets, _ = words.shape
    nbytes = (words.numel() * words.element_size() + x.numel() * x.element_size()
              + sum(t.numel() * t.element_size() for t in outs))
    costs.record_kernel(name, flops=2.0 * n_cores * n_packets * block_size * nq,
                        hbm_bytes=nbytes)


def bscsr_topk_spmv(x, words, *, k, n_rows, packets_per_step=2, fmt_name="F32",
                    block_size=256, gather_mode="take", inner_loop="linear",
                    splits=None, table=None):
    """Per-core top-k of one query over the fused streams -> (C, k) vals, slots.

    ``n_rows`` is the per-core slot budget; it only names the sentinel slot
    of unfilled scratchpad entries.  The kernel walks each core's stream
    with S blocks, one per split of ``table`` (:func:`spmv_split_table`;
    built here when not given, with ``splits`` or, when that is None,
    :func:`single_splits` blocks), its steps staged through a ring of
    ``SINGLE_RING_DEPTH`` steps in shared memory, and the multi-query
    kernel's fold joins the splits at one query.  Every S gives the single
    walk's bits.  One launch is counted per call, the fold included.  CPU
    tensors run the plain version, at ``PLAIN_SPLITS`` when neither
    ``splits`` nor a table is given.
    """
    if x.dim() != 1:
        raise ValueError(f"x must be an (M,) query, got {tuple(x.shape)}")
    if words.device.type == "cpu" and x.device.type == "cpu":
        if table is None and splits is None:
            splits = PLAIN_SPLITS
        return bscsr_topk_spmv_plain(
            x, words, k=k, n_rows=n_rows, packets_per_step=packets_per_step,
            fmt_name=fmt_name, block_size=block_size, gather_mode=gather_mode,
            inner_loop=inner_loop, splits=splits, table=table)
    with costs.opaque():
        out = _single_device(x, words, k=k, n_rows=n_rows, packets_per_step=packets_per_step,
                             fmt_name=fmt_name, block_size=block_size,
                             gather_mode=gather_mode, inner_loop=inner_loop, splits=splits,
                             table=table)
    _record_cost("bscsr_topk_spmv", x, words, out, block_size, 1)
    return out


def _single_device(x, words, *, k, n_rows, packets_per_step, fmt_name, block_size,
                   gather_mode, inner_loop, splits, table):
    """:func:`bscsr_topk_spmv` on CUDA (a launch) or ``meta`` tensors (outputs only)."""
    fmt, col_words = _resolve(fmt_name, words, block_size, packets_per_step, k,
                              gather_mode, inner_loop)
    _check_cuda_args(x, words)
    _check_tile(packets_per_step, block_size)
    n_cores, n_packets, width = words.shape
    dev = words.device
    if dev.type == "meta":
        return _meta_outputs((n_cores, k), dev)
    if table is None:
        if splits is None:
            splits = single_splits(dev, n_cores, packets_per_step=packets_per_step,
                                   block_size=block_size, m=x.shape[0], k=k, width=width,
                                   fmt_name=fmt_name)
        table = spmv_split_table(words, packets_per_step=packets_per_step,
                                 block_size=block_size, splits=splits,
                                 header=_header_words(fmt))
    bounds, head_row = _check_table(table, words, splits)
    n_splits = head_row.shape[1]
    out_v = torch.empty((n_cores, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((n_cores, k), dtype=torch.int32, device=dev)
    if n_splits == 1:                  # (C, 1, 1, k) is the output's layout
        pad_v, pad_r = out_v, out_r
    else:
        pad_v = torch.empty((n_cores, n_splits, 1, k), dtype=torch.float32, device=dev)
        pad_r = torch.empty((n_cores, n_splits, 1, k), dtype=torch.int32, device=dev)
    heads = torch.empty((n_cores, n_splits, 1), dtype=torch.float32, device=dev)
    carries = torch.empty_like(heads)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().bscsr_topk_spmv_launch(
            x.data_ptr(), _kernel_words(words, fmt), out_v.data_ptr(), out_r.data_ptr(),
            bounds.data_ptr(), head_row.data_ptr(), pad_v.data_ptr(), pad_r.data_ptr(),
            heads.data_ptr(), carries.data_ptr(), n_cores, n_splits, n_packets, width,
            x.shape[0], block_size, packets_per_step, col_words, _FMT_IDS[fmt_name], k,
            n_rows, SINGLE_RING_DEPTH, _step_words(packets_per_step, width, fmt), stream,
        )
    if err != 0:
        raise RuntimeError(f"bscsr_topk_spmv_launch failed: CUDA error {err}")
    bscsr_topk_spmv.launches += 1
    return out_v, out_r


bscsr_topk_spmv.launches = 0

# Steps of the single-query kernel's ring in shared memory: D - 1 steps are
# in flight while a block scans one, about 15 KB a block for BF16 at B = 256
# and T = 2, so three blocks an SM keep some 44 KB in flight.
SINGLE_RING_DEPTH = 8

# The most queries a block of the multi-query walk at Q >= 2 carries: two
# for each of a warp's 32 lanes.
MQ_QUERIES_PER_CTA = 64

# x transposed ([m + 1] rows of the block's queries) stays in global memory
# when it would take more shared memory than this (the CUDA source's
# kRowsXBytes).
_ROWS_X_BYTES = 160 * 1024


def _rows_query_width(m) -> int:
    """The widest query chunk whose x transposed fits in shared memory at
    width ``m`` (``m + 1`` rows of the chunk's queries and a pad of one
    lane's, as the kernel's ``rows_x_stride`` lays them out: four queries a
    lane above 32, else two); ``MQ_QUERIES_PER_CTA`` when none fits (x read
    from global memory) or ``m`` is not known."""
    if m is None:
        return MQ_QUERIES_PER_CTA
    width = MQ_QUERIES_PER_CTA
    while width >= 2:
        stride = width + (4 if width > 32 or width == 2 else 2)
        if 4 * (m + 1) * stride <= _ROWS_X_BYTES:
            return width
        width //= 2
    return MQ_QUERIES_PER_CTA


def query_chunks(nq: int, m=None) -> Tuple[int, int]:
    """(queries a block carries, query chunks) of a Q-query pass of the
    multi-query kernel: one query at Q = 1; at Q >= 2 chunks as wide as x
    transposed at width ``m`` allows (:func:`_rows_query_width`), balanced."""
    if nq <= 1:
        return 1, 1
    n_chunks = -(-nq // _rows_query_width(m))
    return -(-nq // n_chunks), n_chunks


def multiquery_walk(nq: int) -> str:
    """The card's walk for a pass of ``nq`` queries: ``"chunks1"``
    (``topk_spmv_mq1_kernel``, the single-query kernel's bits) at one query,
    ``"rows"`` (``topk_spmv_rows_kernel``) at two or more."""
    return "chunks1" if nq == 1 else "rows"


def bscsr_topk_spmv_multiquery(x, words, *, k, n_rows, packets_per_step=2,
                               fmt_name="F32", block_size=256, inner_loop="linear",
                               splits=None, table=None):
    """Per-core top-k of a (Q, M) query batch in one stream pass -> (C, Q, k).

    The kernel walks each core's stream with S walkers, one per split of
    ``table`` (:func:`spmv_split_table`; built here when not given, with
    ``splits`` or, when that is None, :func:`topk_splits` walkers), each with
    its own scratchpads, and a second small kernel folds the splits in
    order.  Every S gives the S = 1 bits.  At one query a block of T*B
    threads walks a split (the single-query kernel's bits); at Q >= 2 a warp
    walks it for up to ``MQ_QUERIES_PER_CTA`` queries, summing each row's
    products in stream order (:func:`bscsr_topk_spmv_multiquery_emulated`
    gives its bits).  One launch is counted per call, the fold included,
    and one in ``launches_by_walk`` under :func:`multiquery_walk`'s name.
    CPU tensors run the plain version, at ``PLAIN_SPLITS`` when neither
    ``splits`` nor a table is given.
    """
    if x.dim() != 2 or x.shape[0] == 0:
        raise ValueError(f"x must be a non-empty (Q, M) batch, got {tuple(x.shape)}")
    nq = x.shape[0]
    q_chunk, n_chunks = query_chunks(nq, x.shape[1])
    if table is None and splits is None:
        splits = topk_splits(words.device, words.shape[0], n_chunks,
                             packets_per_step=packets_per_step, block_size=block_size,
                             m=x.shape[1], q_chunk=q_chunk, k=k, width=words.shape[2],
                             fmt_name=fmt_name)
    if words.device.type == "cpu" and x.device.type == "cpu":
        return bscsr_topk_spmv_multiquery_plain(
            x, words, k=k, n_rows=n_rows, packets_per_step=packets_per_step,
            fmt_name=fmt_name, block_size=block_size, inner_loop=inner_loop,
            splits=splits, table=table)
    with costs.opaque():
        out = _multiquery_device(x, words, k=k, n_rows=n_rows,
                                 packets_per_step=packets_per_step, fmt_name=fmt_name,
                                 block_size=block_size, inner_loop=inner_loop,
                                 splits=splits, table=table, q_chunk=q_chunk)
    _record_cost("bscsr_topk_spmv_multiquery", x, words, out, block_size, nq)
    return out


def _multiquery_device(x, words, *, k, n_rows, packets_per_step, fmt_name, block_size,
                       inner_loop, splits, table, q_chunk):
    """:func:`bscsr_topk_spmv_multiquery` on CUDA (a launch) or ``meta``
    tensors (outputs only)."""
    nq = x.shape[0]
    fmt, col_words = _resolve(fmt_name, words, block_size, packets_per_step, k,
                              "take", inner_loop)
    _check_cuda_args(x, words)
    _check_tile(packets_per_step, block_size)
    n_cores, n_packets, width = words.shape
    if words.device.type == "meta":
        return _meta_outputs((n_cores, nq, k), words.device)
    if table is None:
        table = spmv_split_table(words, packets_per_step=packets_per_step,
                                 block_size=block_size, splits=splits,
                                 header=_header_words(fmt))
    bounds, head_row = _check_table(table, words, splits)
    n_splits = head_row.shape[1]
    dev = words.device
    out_v = torch.empty((n_cores, nq, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((n_cores, nq, k), dtype=torch.int32, device=dev)
    if n_splits == 1:                  # (C, 1, Q, k) is the output's layout
        pad_v, pad_r = out_v, out_r
    else:
        pad_v = torch.empty((n_cores, n_splits, nq, k), dtype=torch.float32, device=dev)
        pad_r = torch.empty((n_cores, n_splits, nq, k), dtype=torch.int32, device=dev)
    heads = torch.empty((n_cores, n_splits, nq), dtype=torch.float32, device=dev)
    carries = torch.empty_like(heads)
    walk = multiquery_walk(nq)
    ptrs = (x.data_ptr(), _kernel_words(words, fmt), out_v.data_ptr(), out_r.data_ptr(),
            bounds.data_ptr(), head_row.data_ptr(), pad_v.data_ptr(), pad_r.data_ptr(),
            heads.data_ptr(), carries.data_ptr(), n_cores, n_splits, n_packets, width)
    tail = (block_size, packets_per_step, col_words, _FMT_IDS[fmt_name], k, n_rows)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if walk == "chunks1":
            err = _library().bscsr_topk_spmv_multiquery_launch(
                *ptrs, x.shape[1], nq, *tail, stream)
        else:
            err = _library().bscsr_topk_spmv_rows_launch(
                *ptrs, _step_words(1, width, fmt), x.shape[1], nq, q_chunk, *tail, stream)
    if err != 0:
        raise RuntimeError(f"bscsr_topk_spmv_multiquery ({walk} walk) failed: CUDA error {err}")
    bscsr_topk_spmv_multiquery.launches += 1
    bscsr_topk_spmv_multiquery.launches_by_walk[walk] += 1
    return out_v, out_r


bscsr_topk_spmv_multiquery.launches = 0
bscsr_topk_spmv_multiquery.launches_by_walk = {"rows": 0, "chunks1": 0}


def _check_table(table, words: torch.Tensor, splits) -> Tuple[torch.Tensor, torch.Tensor]:
    """A split table's (bounds, head_row), checked against the words."""
    bounds, head_row = table
    n_cores, n_splits = words.shape[0], head_row.shape[1]
    if (bounds.shape != (n_cores, n_splits + 1) or head_row.shape != (n_cores, n_splits)
            or bounds.dtype != torch.int32 or head_row.dtype != torch.int32
            or bounds.device != words.device or head_row.device != words.device
            or not (bounds.is_contiguous() and head_row.is_contiguous())):
        raise ValueError("table must be spmv_split_table's (C, S+1) and (C, S) int32 "
                         "tensors on the words' device")
    if splits is not None and splits != n_splits:
        raise ValueError(f"splits={splits} but the table has {n_splits}")
    return bounds, head_row


# The plain split walks' default on the CPU, where no card sets S: enough
# splits that the CPU tests drive the accumulate fix-up and the top-k fold
# through every entry point.
PLAIN_SPLITS = 4


@functools.lru_cache(maxsize=None)
def _resident_blocks(device_index: int, entry: str, *args: int) -> int:
    """Blocks of a kernel that one SM holds at once (the C export ``entry``)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = getattr(_library(), entry)(*args, ctypes.addressof(n))
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    return n.value


def _one_wave(device, divisor: int, entry: str, *args: int) -> int:
    """Splits per stream so that one wave of blocks fills the card: blocks
    per SM times SMs over ``divisor`` streams; ``PLAIN_SPLITS`` on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return PLAIN_SPLITS
    if device.type == "meta":
        return 1                       # no SMs to fill; no count depends on S
    dev = device.index if device.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, _resident_blocks(dev, entry, *args) * sms // divisor)


def spmv_splits(device, n_cores: int, *, packets_per_step: int, block_size: int,
                m: int) -> int:
    """S, the blocks that walk each of ``n_cores`` streams in the accumulate
    kernel on ``device``.

    On the card: the accumulate blocks one SM holds at once (the occupancy
    calculator, for this T*B and x width) times the SM count, over the core
    count, so one wave of blocks fills the card.  On the CPU:
    ``PLAIN_SPLITS``.
    """
    return _one_wave(device, n_cores, "bscsr_spmv_resident_blocks", block_size,
                     packets_per_step, m)


def topk_splits(device, n_cores: int, n_chunks: int, *, packets_per_step: int,
                block_size: int, m: int, q_chunk: int, k: int, width=None,
                fmt_name: str = "F32") -> int:
    """S, the walkers on each of ``n_cores`` streams for each of ``n_chunks``
    query chunks of ``q_chunk`` queries (:func:`query_chunks`) in the
    multi-query kernel on ``device``.

    On the card: the kernel's blocks one SM holds at once (the occupancy
    calculator, for this T*B, x width, chunk, k and packet of ``width``
    words, the widest untagged packet when not given) times the SM count,
    over the chunks, times the walkers a block (one at one query), over the
    cores, so one wave of blocks fills the card.  On the CPU:
    ``PLAIN_SPLITS``.
    """
    if q_chunk <= 1:
        return _one_wave(device, n_cores * n_chunks, "bscsr_topk_spmv_mq_resident_blocks",
                         block_size, packets_per_step, m, k)
    device = torch.device(device)
    if device.type == "cpu":
        return PLAIN_SPLITS
    if device.type == "meta":
        return 1
    if width is None:
        width = block_size // FLAG_WORD_BITS + 2 * block_size
    packet_words = _step_words(1, width, STREAM_FORMATS[fmt_name])
    dev = device.index if device.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, walkers = _rows_resident(dev, block_size, packets_per_step, packet_words, m,
                                     q_chunk, k)
    return max(1, blocks * sms // n_chunks * walkers // n_cores)


@functools.lru_cache(maxsize=None)
def _rows_resident(device_index: int, *args: int) -> Tuple[int, int]:
    """(blocks an SM holds at once, walkers a block) of the rows walk."""
    blocks, walkers = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _library().bscsr_topk_spmv_rows_resident(
            *args, ctypes.addressof(blocks), ctypes.addressof(walkers))
    if err != 0:
        raise RuntimeError(f"bscsr_topk_spmv_rows_resident failed: CUDA error {err}")
    return blocks.value, walkers.value


def single_splits(device, n_cores: int, *, packets_per_step: int, block_size: int, m: int,
                  k: int, width: int, fmt_name: str) -> int:
    """S, the blocks that walk each of ``n_cores`` streams of ``width``-word
    packets in the single-query kernel on ``device``.

    On the card: the kernel's blocks one SM holds at once (the occupancy
    calculator, for this T*B, x width, k and a ring of ``SINGLE_RING_DEPTH``
    steps) times the SM count, over the core count, so one wave of blocks
    fills the card.  On the CPU: ``PLAIN_SPLITS``.
    """
    step_words = _step_words(packets_per_step, width, STREAM_FORMATS[fmt_name])
    return _one_wave(device, n_cores, "bscsr_topk_spmv_resident_blocks", block_size,
                     packets_per_step, m, k, SINGLE_RING_DEPTH, step_words)


def bscsr_spmv(x, words, *, n_rows, packets_per_step=2, fmt_name="F32",
               block_size=256, gather_mode="take", inner_loop="linear", splits=None,
               table=None):
    """Accumulate mode: every core's raw per-slot row sums -> (C, n_rows) f32.

    The top-k scratchpad never runs; each row that completes is stored at
    its slot as ``0.0 + sum`` and every other slot reads exactly 0.0.
    ``n_rows`` is the per-core slot budget (possibly a power-of-two pad).
    Callers map slots to rows, mask tombstones and apply alpha/beta with
    ``ops.scatter_slot_sums``.  Under "linear" and "linear-seg" the reference
    sums segments by prefix differences, as this does; under "legacy" and
    "linear-topk" it uses a one-hot matmul there, so the sums agree only
    within f32 tolerance (bit for bit on dyadic fixtures).  ``gather_mode``
    is served by one gather.

    The kernel walks each core's stream with S blocks, one per split of
    ``table`` (:func:`spmv_split_table`; built here when not given, with
    ``splits`` or, when that is None, :func:`spmv_splits` blocks), and a
    second small kernel joins the splits.  Every S gives the same bits.
    CPU tensors run the plain version (``splits=None`` and no table: the
    single walk).
    """
    if words.device.type == "cpu" and x.device.type == "cpu":
        return bscsr_spmv_plain(
            x, words, n_rows=n_rows, packets_per_step=packets_per_step,
            fmt_name=fmt_name, block_size=block_size, gather_mode=gather_mode,
            inner_loop=inner_loop, splits=splits, table=table)
    with costs.opaque():
        out = _spmv_device(x, words, n_rows=n_rows, packets_per_step=packets_per_step,
                           fmt_name=fmt_name, block_size=block_size, gather_mode=gather_mode,
                           inner_loop=inner_loop, splits=splits, table=table)
    _record_cost("bscsr_spmv", x, words, (out,), block_size, 1)
    return out


def _spmv_device(x, words, *, n_rows, packets_per_step, fmt_name, block_size, gather_mode,
                 inner_loop, splits, table):
    """:func:`bscsr_spmv` on CUDA (a launch) or ``meta`` tensors (the output only)."""
    fmt, col_words = _resolve(fmt_name, words, block_size, packets_per_step, 1,
                              gather_mode, inner_loop)
    _check_cuda_args(x, words)
    if x.dim() != 1:
        raise ValueError(f"x must be an (M,) vector, got {tuple(x.shape)}")
    _check_tile(packets_per_step, block_size)
    n_cores, n_packets, width = words.shape
    if words.device.type == "meta":
        return torch.empty((n_cores, n_rows), dtype=torch.float32, device=words.device)
    if table is None:
        if splits is None:
            splits = spmv_splits(words.device, n_cores, packets_per_step=packets_per_step,
                                 block_size=block_size, m=x.shape[0])
        table = spmv_split_table(words, packets_per_step=packets_per_step,
                                 block_size=block_size, splits=splits,
                                 header=_header_words(fmt))
    bounds, head_row = _check_table(table, words, splits)
    n_splits = head_row.shape[1]
    out = torch.zeros((n_cores, n_rows), dtype=torch.float32, device=words.device)
    heads = torch.empty((n_cores, n_splits), dtype=torch.float32, device=words.device)
    carries = torch.empty_like(heads)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().bscsr_spmv_launch(
            x.data_ptr(), _kernel_words(words, fmt), out.data_ptr(), bounds.data_ptr(),
            head_row.data_ptr(), heads.data_ptr(), carries.data_ptr(), n_cores,
            n_splits, n_packets, width, x.shape[0], block_size, packets_per_step,
            col_words, _FMT_IDS[fmt_name], n_rows, stream,
        )
    if err != 0:
        raise RuntimeError(f"bscsr_spmv_launch failed: CUDA error {err}")
    bscsr_spmv.launches += 1
    return out


bscsr_spmv.launches = 0


def reset_launch_counts() -> None:
    """Set every wrapper's ``launches`` count to 0."""
    bscsr_topk_spmv.launches = 0
    bscsr_topk_spmv_multiquery.launches = 0
    bscsr_topk_spmv_multiquery.launches_by_walk = {"rows": 0, "chunks1": 0}
    bscsr_spmv.launches = 0
