"""Adaptive format selection (the paper's §VI future work), host side.

A copy of ``repro.core.adaptive`` for the port: numpy only, pinned equal to
the reference by the port's tests.

    "Future work will focus on adaptive compressed matrix representations by
     reconfiguring the FPGA in terms of numerical precision to guarantee
     desired targets of accuracy or performance."

The stream format is a run-time choice.  ``plan_for_target`` picks the
cheapest uniform (value format, partition count) whose predicted precision
meets a target, predicted = Eq1(N, c, k, K) * value_precision(format), with
value_precision calibrated per collection on a sample of queries.
``assign_partition_formats`` gives each partition its own format under a
recall@k target, and ``refresh_partition_formats`` promotes mutated
partitions when the recall budget is breached.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import bscsr as bscsr_lib
from repro_torch.core.bscsr import stream_bytes_per_nnz
from repro_torch.core.precision_model import (
    csr_batch_scores,
    expected_precision,
    topk_thresholds,
)

# cheapest first: the selector returns the first format meeting the target
FORMAT_LADDER = ("Q7", "BF16", "Q15", "F32")


@dataclasses.dataclass(frozen=True)
class AdaptivePlan:
    value_format: str
    num_partitions: int
    predicted_precision: float
    bytes_per_nnz: float
    projected_gnnz_per_chip: float


@dataclasses.dataclass(frozen=True)
class FormatPrecision:
    """Calibrated Top-K overlap of one value format, with its uncertainty.

    ``mean`` is the point estimate over the query sample; ``ci_low``/
    ``ci_high`` bound it at ~95% (normal approximation over queries).
    Planning against ``ci_low`` keeps a small calibration sample from
    overpromising a format.
    """

    mean: float
    ci_low: float
    ci_high: float
    n_queries: int


def _collection_rng(csr: bscsr_lib.CSRMatrix, seed: int) -> np.random.Generator:
    """Deterministic per (seed, collection) query sampler.

    The sample is keyed by the matrix *content* (sparsity pattern + values),
    not object identity, so re-encoding or reloading the same collection
    reproduces the same calibration queries — and the same format plan.
    """
    h = hashlib.blake2b(digest_size=8)
    h.update(np.int64(csr.shape[0]).tobytes())
    h.update(np.int64(csr.shape[1]).tobytes())
    h.update(np.ascontiguousarray(csr.indices).tobytes())
    h.update(np.ascontiguousarray(csr.data).tobytes())
    return np.random.default_rng(
        [int(seed), int.from_bytes(h.digest(), "little")]
    )


def sample_calibration_queries(
    csr: bscsr_lib.CSRMatrix, n_queries: int, seed: int = 0
) -> np.ndarray:
    """(S, M) deterministic Gaussian calibration queries for a collection."""
    rng = _collection_rng(csr, seed)
    return rng.standard_normal((n_queries, csr.shape[1])).astype(np.float32)


def _quantized_data(data: np.ndarray, fmt_name: str) -> np.ndarray:
    from repro_torch.core.quantization import FORMATS, host_dequantize, quantize

    fmt = FORMATS[fmt_name]
    return host_dequantize(quantize(data, fmt), fmt)


def calibrate_value_precision(
    csr: bscsr_lib.CSRMatrix,
    big_k: int,
    formats: Sequence[str] = FORMAT_LADDER,
    n_queries: int = 16,
    seed: int = 0,
) -> Dict[str, FormatPrecision]:
    """Measured Top-K overlap of each value format vs fp32, partition-free.

    Uses exact (unpartitioned) scoring so the measurement isolates the
    quantization term from the Eq. (1) partition term.  The query sample is
    deterministic per (seed, collection) — see ``sample_calibration_queries``
    — and each format's overlap comes back as a :class:`FormatPrecision`
    (mean + ~95% confidence interval over the sample), not a bare point
    estimate.
    """
    from repro_torch.kernels.ref import csr_topk_numpy

    xs = sample_calibration_queries(csr, n_queries, seed)
    exact_sets = []
    for x in xs:
        _, exact = csr_topk_numpy(csr.indptr, csr.indices, csr.data, x, big_k)
        exact_sets.append(set(exact.tolist()))
    out: Dict[str, FormatPrecision] = {}
    for fmt_name in formats:
        data_q = _quantized_data(csr.data, fmt_name)
        overlaps = []
        for x, exact in zip(xs, exact_sets):
            _, approx = csr_topk_numpy(csr.indptr, csr.indices, data_q, x,
                                       big_k)
            overlaps.append(len(exact & set(approx.tolist())) / big_k)
        mean = float(np.mean(overlaps))
        half = 1.96 * float(np.std(overlaps)) / max(len(overlaps), 1) ** 0.5
        out[fmt_name] = FormatPrecision(
            mean=mean,
            ci_low=max(0.0, mean - half),
            ci_high=min(1.0, mean + half),
            n_queries=len(overlaps),
        )
    return out


def plan_for_target(
    n_rows: int,
    n_cols: int,
    big_k: int,
    precision_target: float,
    k: int = 8,
    max_partitions: int = 4096,
    value_precisions: Optional[dict] = None,
    hbm_bw: float = 819e9,
) -> AdaptivePlan:
    """Cheapest (format, partitions) meeting the precision target.

    ``value_precisions``: measured per-format precision from
    ``calibrate_value_precision`` (defaults to 1.0 for all formats — the
    partition term only, i.e. the paper's Table I regime).  Entries may be
    bare floats or :class:`FormatPrecision` objects; for the latter the
    conservative ``ci_low`` bound is what must clear the target.
    """
    vp_in = value_precisions or {f: 1.0 for f in FORMAT_LADDER}
    vp = {
        f: (v.ci_low if isinstance(v, FormatPrecision) else float(v))
        for f, v in vp_in.items()
    }
    best: Optional[AdaptivePlan] = None
    for fmt in FORMAT_LADDER:
        c = max(2, -(-big_k // k))
        while c <= max_partitions:
            pred = expected_precision(n_rows, c, k, big_k) * vp.get(fmt, 1.0)
            if pred >= precision_target:
                bpn = stream_bytes_per_nnz(fmt, n_cols)
                plan = AdaptivePlan(
                    value_format=fmt,
                    num_partitions=c,
                    predicted_precision=pred,
                    bytes_per_nnz=bpn,
                    projected_gnnz_per_chip=hbm_bw / bpn / 1e9,
                )
                if best is None or plan.bytes_per_nnz < best.bytes_per_nnz:
                    best = plan
                break
            c *= 2
    if best is None:
        raise ValueError(
            f"target {precision_target} unreachable (value quantization caps "
            f"precision at {max(vp.values()):.3f})"
        )
    return best


# ---------------------------------------------------------------------------
# Per-partition format assignment (the tentpole autotuner)
#
# One format per matrix leaves bandwidth on the table: most partitions
# tolerate Q7 (their top-k margins dwarf the ~2^-8 rounding error), while a
# few quantization-sensitive ones must stay wide.  The assignment below
# calibrates the quantization-induced top-k loss of every (partition,
# format) pair on a deterministic query sample and greedily demotes
# partitions down the byte ladder (4B -> 2B -> 1B) while the summed
# predicted loss stays inside the recall budget ``(1 - target) * k * S``.
# ---------------------------------------------------------------------------

_BYTES_OF = {"F32": 4, "BF16": 2, "Q15": 2, "Q7": 1}


@dataclasses.dataclass(frozen=True)
class PartitionFormatPlan:
    """The autotuner's output: one ValueFormat name per partition."""

    formats: Tuple[str, ...]
    recall_target: float
    predicted_recall: float
    budget: float              # tolerated (query, row) loss events
    total_loss: float          # predicted loss events at this assignment
    histogram: Dict[str, int]


@dataclasses.dataclass
class PrecisionCalibration:
    """Frozen calibration context for incremental (refresh-time) updates.

    ``queries``/``thresholds`` pin the sample the plan was budgeted
    against; ``losses`` tracks each partition's predicted loss at its
    *current* format.  A mutable index re-scores only mutated partitions
    against this context on refresh (promote-only hysteresis) and rebuilds
    the whole calibration at compaction.
    """

    queries: np.ndarray        # (S, M) f32 calibration queries
    thresholds: np.ndarray     # (S,) per-query k-th exact score
    k: int
    budget: float
    losses: np.ndarray         # (C,) float predicted loss per partition
    # (S,) per-query k-th score under whole-matrix quantization, per format:
    # a member is LOST only if its quantized score also misses the quantized
    # admission bar (both-threshold model; exactly matches measured set
    # overlap, where the single-threshold count overstates ~2x).
    quant_thresholds: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict
    )

    @property
    def total_loss(self) -> float:
        return float(self.losses.sum())

    def predicted_recall(self) -> float:
        denom = max(self.k * self.queries.shape[0], 1)
        return 1.0 - self.total_loss / denom


def partition_quantization_loss(
    part: bscsr_lib.CSRMatrix,
    queries: np.ndarray,
    thresholds: np.ndarray,
    fmt_name: str,
    quant_thresholds: Optional[np.ndarray] = None,
) -> float:
    """Predicted top-k loss events of ONE partition at one format.

    Scores only this partition's rows against the stored global admission
    thresholds — additive across partitions, so refresh-time updates can
    re-score a mutated partition in isolation.  ``quant_thresholds`` is the
    quantized-side admission bar (both-threshold model); it defaults to the
    exact thresholds, which is strictly more conservative.
    """
    if fmt_name == "F32" or part.nnz == 0:
        return 0.0
    exact = csr_batch_scores(part.indptr, part.indices, part.data, queries)
    quant = csr_batch_scores(
        part.indptr, part.indices, _quantized_data(part.data, fmt_name), queries
    )
    tq = thresholds if quant_thresholds is None else quant_thresholds
    t = np.asarray(thresholds)[:, None]
    return float(((exact >= t) & (quant < np.asarray(tq)[:, None])).sum())


def assign_partition_formats(
    csr: bscsr_lib.CSRMatrix,
    num_partitions: int,
    recall_target: float,
    k: int = 8,
    n_queries: int = 16,
    seed: int = 0,
) -> Tuple[PartitionFormatPlan, PrecisionCalibration]:
    """Choose one ValueFormat per partition to hit ``recall@k >= target``.

    Two greedy byte-level passes over partitions sorted by marginal loss:
    first 4B -> best 2-byte format (BF16 vs Q15, whichever loses less),
    then 2B -> Q7 — demoting while the cumulative predicted loss stays
    within the budget.  Deterministic per (seed, collection).
    """
    from repro_torch.core import partition as partition_lib

    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target must be in (0, 1], got {recall_target}")
    plan = partition_lib.PartitionPlan.build(csr.shape[0], num_partitions)
    c = plan.num_partitions
    starts = np.asarray(plan.row_starts, np.int64)

    xs = sample_calibration_queries(csr, n_queries, seed)
    exact = csr_batch_scores(csr.indptr, csr.indices, csr.data, xs)
    thresholds = topk_thresholds(exact, k)

    # Per-row loss counts under each narrower format, folded per partition.
    # Both-threshold model: a member is lost only when its quantized score
    # also misses the quantized admission bar (matches measured set overlap).
    loss: Dict[str, np.ndarray] = {"F32": np.zeros(c)}
    quant_thresholds: Dict[str, np.ndarray] = {}
    for fmt_name in ("BF16", "Q15", "Q7"):
        quant = csr_batch_scores(
            csr.indptr, csr.indices, _quantized_data(csr.data, fmt_name), xs
        )
        tq = topk_thresholds(quant, k)
        quant_thresholds[fmt_name] = tq
        per_row = (
            (exact >= thresholds[:, None]) & (quant < tq[:, None])
        ).sum(axis=0).astype(np.int64)
        loss[fmt_name] = np.add.reduceat(per_row, starts).astype(np.float64) \
            if c > 1 else np.array([per_row.sum()], np.float64)

    budget = (1.0 - recall_target) * k * len(xs)
    fmts = ["F32"] * c
    cur = np.zeros(c)

    # Pass 1: 4B -> cheapest-loss 2-byte format.
    two_byte = np.where(loss["BF16"] <= loss["Q15"], "BF16", "Q15")
    cost2 = np.minimum(loss["BF16"], loss["Q15"])
    for p in np.argsort(cost2, kind="stable"):
        if cur.sum() + cost2[p] <= budget:
            fmts[p] = str(two_byte[p])
            cur[p] = cost2[p]
    # Pass 2: 2B -> Q7, by marginal loss.
    delta = loss["Q7"] - cur
    for p in np.argsort(delta, kind="stable"):
        if fmts[p] in ("BF16", "Q15") and cur.sum() + delta[p] <= budget:
            fmts[p] = "Q7"
            cur[p] = loss["Q7"][p]

    total = float(cur.sum())
    hist: Dict[str, int] = {}
    for f in fmts:
        hist[f] = hist.get(f, 0) + 1
    fmt_plan = PartitionFormatPlan(
        formats=tuple(fmts),
        recall_target=recall_target,
        predicted_recall=1.0 - total / max(k * len(xs), 1),
        budget=budget,
        total_loss=total,
        histogram=hist,
    )
    calib = PrecisionCalibration(
        queries=xs, thresholds=thresholds, k=k, budget=budget, losses=cur,
        quant_thresholds=quant_thresholds,
    )
    return fmt_plan, calib


def refresh_partition_formats(
    formats: Sequence[str],
    calib: PrecisionCalibration,
    mutated: Dict[int, bscsr_lib.CSRMatrix],
) -> Tuple[Tuple[str, ...], int]:
    """Promote-only incremental reassignment after partition mutations.

    Re-scores each mutated partition at its current format against the
    stored calibration; if the summed predicted loss breaches the budget,
    the worst mutated offenders are promoted up the byte ladder until it
    fits again.  Formats never *demote* here — demotions wait for the full
    re-assignment at compaction — so benign upserts keep the format vector
    (and therefore the executor signature) bit-stable.  Returns the new
    format tuple and how many partitions were promoted.
    """
    fmts = list(formats)
    for ci, part in mutated.items():
        calib.losses[ci] = partition_quantization_loss(
            part, calib.queries, calib.thresholds, fmts[ci],
            calib.quant_thresholds.get(fmts[ci]),
        )
    promoted = 0
    ladder = list(FORMAT_LADDER)  # cheapest -> widest
    while calib.total_loss > calib.budget:
        candidates = [
            ci for ci in mutated if fmts[ci] != "F32" and calib.losses[ci] > 0
        ]
        if not candidates:
            break  # breach not attributable to mutated partitions
        worst = max(candidates, key=lambda ci: calib.losses[ci])
        nxt = ladder[ladder.index(fmts[worst]) + 1]
        # Skip lateral moves within a byte class (BF16 -> Q15 buys nothing).
        while _BYTES_OF[nxt] == _BYTES_OF[fmts[worst]]:
            nxt = ladder[ladder.index(nxt) + 1]
        fmts[worst] = nxt
        calib.losses[worst] = partition_quantization_loss(
            mutated[worst], calib.queries, calib.thresholds, nxt,
            calib.quant_thresholds.get(nxt),
        )
        promoted += 1
    return tuple(fmts), promoted
