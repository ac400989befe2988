#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main query path on one card.

    python3 chip_smoke.py [--rows N] [--seed S] [--only accumulate]

Phases (any failure ends the run with a non-zero exit and no result line):

1. build     nvcc builds every kernel source of the paths (sm_90a) and
             prints each kernel's registers (``-Xptxas -v``).
2. parity    each kernel against its plain PyTorch version on the card, on
             small fixtures: all four value formats, int16 and int32 column
             ids, Q in {1, 3, 64}, B in {32, 256}, T in {1, 2}, empty rows, a
             row spanning several packets, cores with fewer than k rows, all
             negative scores under a padded slot budget (whose phantom slots
             the accumulate kernel must leave at exactly 0.0), flag-free
             padding packets, poisoned padding ids.  Dyadic fixtures must be
             bit-identical; random ones agree within rtol = atol = 1e-5 with
             equal row ids outside near-ties.  The multi-query kernel (at
             Q in {1, 3, 64}) and the accumulate kernel run at the card's S
             blocks per core, at one and at 64, and every S must give the
             bits of S = 1.
3. main path the deployment configuration of ``repro.configs.topk_spmv``
             (10M rows x 512 columns, gamma row lengths with mean 20, BF16,
             B=256, K=100, k=8, T=2, fused layout, c=32) through the mutable
             ``SparseEmbeddingIndex``: ``query`` / ``query_batch`` and
             ``topk_spmv(...)`` checked against the torch oracle per query
             and against exact search for precision@K; then ``upsert`` of 64
             rows and ``delete`` of 64, and the same queries at Q = 1, 8, 64
             on the new snapshot (deleted ids never returned), one retrace
             per dispatch key at the first mutation and none over further
             upserts.  Both top-k kernels' launch counts must rise here, and
             the executor's host-to-device copies stay flat in steady state.
4. timings   each top-k kernel at every Q the main path gives it on the main
             path's streams before and after ingest (the multi-query kernel
             at the card's S and at one split, in turns, with its S,
             q_chunk and split-table build time printed; at the card's S
             bit-identical to S = 1), and the accumulate kernel on phase 6's
             streams before and after the first mutation (run after phase 6;
             bit-identical to plain on dyadic values, within a stated
             rounding bound on random x, and at the card's S bit-identical
             to S = 1 on random x; both S timed in turns with the split
             table built beforehand, and the table's build time printed),
             CUDA events (device time: the stream is held while the
             launches are queued), each checked against its plain version
             on the same inputs, with its bound on an H100 SXM and a library
             yardstick (torch.sparse.mm).
6. graph     personalized PageRank and top-k eigen at full width: the "ring"
             operator at 2**21 nodes (5,242,878 nnz, the scale of SNAP's
             com-Youtube), F32, B=256, T=2, fused, c=32, through
             ``GraphRankingService`` over a ``SparseEmbeddingIndex``'s
             mutable index: cold, warm (after ``update_node``, weights
             x 1.02) and forget+cold solves, all converged, canonical and
             retrace-free, the cold and warm solves bit-identical to their
             ``use_kernel=False`` counterparts, warm with fewer iterations
             and within 1 ulp of cold (in the same entries on both paths),
             host-to-device copies flat across the iterations; then
             ``topk_eigen(3)`` on the "ba" operator at 1024 nodes with float64
             residuals at most 1e-4.  The accumulate kernel's launch count
             must rise here; ``PPR_SPLIT`` prints a device iteration's time.
5. summary   a ``kernels`` JSON line, the card's name and power limit, and
             the result line.

``--only accumulate`` runs phases 1 and 2 and the accumulate timing on the
graph's streams (built and mutated once, no solves), and stops without the
result line: a short check of a kernel change before the full run.

The script needs one CUDA device and imports only ``repro_torch`` (from
``src/`` beside it) and torch/numpy.
"""
from __future__ import annotations

import argparse
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS = 67e12              # H100 SXM f32, outside the tensor cores
TOL = 1e-5
FORMATS = ("F32", "BF16", "Q15", "Q7")
SOURCE = "src/repro_torch/csrc/bscsr_topk_spmv.cu"
REPLACES = {
    "bscsr_topk_spmv": "src/repro/kernels/bscsr_topk_spmv.py:419",
    "bscsr_topk_spmv_multiquery": "src/repro/kernels/bscsr_topk_spmv.py:790",
    "bscsr_spmv": "src/repro/kernels/bscsr_topk_spmv.py:603",
}
# Clock cycles of the sleep that holds the stream while time_cuda queues
# its launches (about 50 ms: longer than 50 calls take to enqueue).
HOLD_CYCLES = 100_000_000
# Extra calls of the multi-query kernel at each S, Q and snapshot of phase 4
# that must repeat the S = 1 bits.
MQ_REPEATS = 10
GRAPH_NODES = 1 << 21
GRAPH_NNZ = 5_242_878          # the reference's synthetic_graph_csr("ring", 2**21, 0)
GRAPH_SEEDS = [5, 17, 4242]
# The "ba" eigen fixture.  At 4096 nodes (and 2048) its 2nd and 3rd
# eigenvalues lie so close that deflated power iteration does not reach
# tol = 1e-5 within 3000 steps; 1024 is the largest power of two that does.
EIGEN_NODES = 1024


def log(*args) -> None:
    print(*args, flush=True)


class Check:
    """Collects failures of a phase; the phase raises if any were seen."""

    def __init__(self, phase: str):
        self.phase = phase
        self.failures: list = []

    def expect(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)
            log(f"  FAIL [{self.phase}] {what}")

    def done(self) -> None:
        if self.failures:
            raise SystemExit(f"phase {self.phase} failed: {len(self.failures)} checks")
        log(f"phase {self.phase}: ok")


def compare(kernel, plain, bitwise: bool):
    """(ok, max_abs_err) of kernel vs plain (values, rows) tensors."""
    kv, kr = (t.cpu().numpy() for t in kernel)
    pv, prow = (t.cpu().numpy() for t in plain)
    err = float(np.abs(kv.astype(np.float64) - pv).max()) if kv.size else 0.0
    if bitwise:
        return bool(np.array_equal(kv.view(np.int32), pv.view(np.int32))
                    and np.array_equal(kr, prow)), err
    ok = bool(np.allclose(kv, pv, rtol=TOL, atol=TOL))
    va = kv.reshape(-1, kv.shape[-1])
    for i, j in zip(*np.nonzero(kr.reshape(va.shape) != prow.reshape(va.shape))):
        gaps = np.abs(va[i] - va[i, j])
        gaps[j] = np.inf
        ok = ok and bool(gaps.min() <= 2 * TOL)
    return ok, err


# ---------------------------------------------------------------------------
# Phase 2 fixtures (small; dyadic ones are exact in f32 in any summation order)
# ---------------------------------------------------------------------------

def dyadic_csr(bscsr, rng, n_rows, n_cols, max_len=12, empty_every=0, sign=0, lens=None):
    if lens is None:
        lens = rng.integers(1, max_len + 1, size=n_rows)
        if empty_every:
            lens[::empty_every] = 0
    lens = np.asarray(lens)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.concatenate([np.sort(rng.choice(n_cols, int(n), replace=False))
                          for n in lens if n]).astype(np.int32)
    data = rng.integers(-128, 128, size=int(lens.sum())) / 128.0
    if sign:
        data = sign * np.maximum(np.abs(data), 1 / 128)
    return bscsr.CSRMatrix(indptr, idx, data.astype(np.float32), (len(lens), n_cols))


def poison_padding(bscsr, words, block, fmt, rows_per_core):
    out = words.copy()
    for c in range(words.shape[0]):
        vals, cols, flags = bscsr.defuse_stream(words[c], block, fmt, np.int16)
        row_ids = np.cumsum(bscsr.unpack_bits(flags, block).reshape(-1)) - 1
        pad = (row_ids >= rows_per_core[c]).reshape(cols.shape)
        cols = cols.copy()
        cols[pad] = 30_000
        half = pad.copy()
        half[::2] = False
        cols[half] = -7
        out[c] = bscsr.fuse_words(vals, cols, flags)
    return out


def parity_phase(torch, K, ops, bscsr, errs):
    check = Check("parity")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    cases = []
    for fmt in FORMATS:
        for block, t, n_cols in ((32, 1, 64), (256, 2, 512), (64, 2, 40_000)):
            csr = dyadic_csr(bscsr, rng, 600, n_cols, empty_every=9)
            cases.append((f"dyadic {fmt} B={block} T={t} M={n_cols}", csr, fmt, block,
                          t, 5, True, "mixed", None))
        rand = bscsr.synthetic_embedding_csr(2000, 512, 20, "gamma", seed=1)
        cases.append((f"random {fmt} B=256 T=2", rand, fmt, 256, 2, 4, False, "mixed",
                      None))
    cases.append(("all-negative, padded budget", dyadic_csr(bscsr, rng, 60, 64, sign=-1),
                  "Q7", 32, 2, 2, True, "positive", "pad"))
    cases.append(("row over 5 packets, cores < k rows",
                  dyadic_csr(bscsr, rng, 7, 200, lens=[3, 150, 2, 0, 5, 1, 4]),
                  "Q15", 32, 1, 3, True, "mixed", None))
    cases.append(("poisoned padding ids", dyadic_csr(bscsr, rng, 30, 64), "BF16", 32, 2,
                  2, True, "mixed", "poison"))
    n_checks = 0
    for name, csr, fmt, block, t, cores, bitwise, xsign, edit in cases:
        packed = ops.pack_partitions(csr, cores, block, fmt, packets_multiple=t,
                                     stream_layout="fused")
        words, n_rows = packed.words, packed.max_slots
        if edit == "pad":
            words = np.concatenate([words, np.zeros((cores, 4, words.shape[2]),
                                                    np.int32)], 1)
            n_rows *= 4
        elif edit == "poison":
            words = poison_padding(bscsr, words, block, fmt, packed.candidate_slots)
        w = torch.from_numpy(words).to(dev)
        kw = dict(k=8, n_rows=n_rows, packets_per_step=t, fmt_name=fmt, block_size=block)
        for q in (1, 3, 64):
            if bitwise:
                lo = 1 if xsign == "positive" else -16
                xs = rng.integers(lo, 17, size=(q, csr.shape[1])) / 8.0
            else:
                xs = rng.standard_normal((q, csr.shape[1]))
            x = torch.from_numpy(xs.astype(np.float32)).to(dev)
            if q == 1:
                got = K.bscsr_topk_spmv(x[0], w, **kw)
                want = K.bscsr_topk_spmv_plain(x[0], w, **kw)
                torch.cuda.synchronize()
                ok, err = compare(got, want, bitwise)
                errs["bscsr_topk_spmv"] = max(errs["bscsr_topk_spmv"], err)
                check.expect(ok, f"{name} Q=1: single-query kernel != plain (max err "
                                 f"{err:.3g})")
                n_checks += 1
            # The multi-query kernel at the card's S, at one split and at 64:
            # each against plain, and every S against S = 1 bit for bit.
            want = K.bscsr_topk_spmv_multiquery_plain(x, w, **kw)
            one = K.bscsr_topk_spmv_multiquery(x, w, splits=1, **kw)
            for splits in (None, 1, 64):
                got = K.bscsr_topk_spmv_multiquery(x, w, splits=splits, **kw)
                torch.cuda.synchronize()
                ok, err = compare(got, want, bitwise)
                errs["bscsr_topk_spmv_multiquery"] = max(errs["bscsr_topk_spmv_multiquery"],
                                                         err)
                check.expect(ok, f"{name} Q={q} S={splits}: multi-query kernel != plain "
                                 f"(max err {err:.3g})")
                check.expect(compare(got, one, True)[0],
                             f"{name} Q={q} S={splits}: multi-query kernel != its S=1 bits")
                n_checks += 1
        # The accumulate kernel on the same words, first query of the case, at
        # the card's S, at one split and at 64 (past the flagged steps of
        # these fixtures): each against plain, and every S against S = 1 bit
        # for bit.
        akw = dict(n_rows=n_rows, packets_per_step=t, fmt_name=fmt, block_size=block)
        want = K.bscsr_spmv_plain(x[0], w, **akw).cpu().numpy()
        one = K.bscsr_spmv(x[0], w, splits=1, **akw).cpu().numpy()
        live = np.asarray(packed.candidate_slots)
        never = np.arange(n_rows)[None, :] >= live[:, None]
        for splits in (None, 1, 64):
            gv = K.bscsr_spmv(x[0], w, splits=splits, **akw).cpu().numpy()
            err = float(np.abs(gv.astype(np.float64) - want).max())
            errs["bscsr_spmv"] = max(errs["bscsr_spmv"], err)
            if bitwise:
                ok = np.array_equal(gv.view(np.int32), want.view(np.int32))
            else:
                ok = bool(np.allclose(gv, want, rtol=TOL, atol=TOL))
            check.expect(ok, f"{name} S={splits}: accumulate kernel != plain "
                             f"(max err {err:.3g})")
            check.expect(np.array_equal(gv.view(np.int32), one.view(np.int32)),
                         f"{name} S={splits}: accumulate kernel != its S=1 bits")
            check.expect(bool((gv.view(np.int32)[never] == 0).all()),
                         f"{name} S={splits}: a slot that never completes is not 0.0")
            n_checks += 1
    log(f"  {n_checks} kernel/plain comparisons")
    check.done()


# ---------------------------------------------------------------------------
# Timing helpers
# ---------------------------------------------------------------------------

def time_cuda(torch, fn, budget_s=2.0):
    """Mean device ms of ``fn`` over repeated launches, timed with CUDA events.

    A sleep kernel holds the stream while the launches are queued, so the
    events measure the device's time alone and not the host's time to
    enqueue each call (about 0.05 ms for a kernel wrapper: as long as the
    accumulate kernel itself).
    """
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    reps = int(min(50, max(3, budget_s * 1e3 / one)))
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms_per_call(torch, fn, reps=50):
    """Host milliseconds to enqueue one call of ``fn`` (no synchronize)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host


def time_once(torch, fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def kernel_registers(report: str) -> dict:
    """{kernel: registers per thread} from nvcc's ``-Xptxas -v`` report."""
    regs, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = next((k for k in ("topk_spmv_mq_split_kernel", "topk_spmv_mq1_kernel",
                                     "topk_mq_merge_kernel",
                                     "topk_spmv_kernel", "spmv_accum_kernel",
                                     "spmv_fixup_kernel")
                         if k in m.group(1)), m.group(1))
            qc = re.search(r"ILi(\d+)E", m.group(1))      # the template's queries a block
            if qc:
                name += f"<{qc.group(1)}>"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
            name = None
    return regs


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", type=int, default=10_000_000,
                        help="collection rows (the deployment has 10M)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", choices=("accumulate",),
                        help="accumulate: phases 1 and 2 and the accumulate kernel's "
                             "timing on phase 6's streams (no solves), then stop "
                             "without the result line")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import bscsr
    from repro_torch.core.similarity import SparseEmbeddingIndex
    from repro_torch.core import topk_spmv as api
    from repro_torch.kernels import bscsr_topk_spmv as K
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # ---- phase 1: build ----
    t0 = time.time()
    lib = K.build_library(verbose=True)
    K._library()
    log(f"phase build: ok ({time.time() - t0:.1f} s, {lib.name})")
    log("REGISTERS " + json.dumps(kernel_registers(lib.with_suffix(".log").read_text())))

    # ---- phase 2: kernels vs plain versions on small fixtures ----
    errs = {"bscsr_topk_spmv": 0.0, "bscsr_topk_spmv_multiquery": 0.0, "bscsr_spmv": 0.0}
    parity_phase(torch, K, ops, bscsr, errs)
    if args.only == "accumulate":
        from repro_torch.core import graph
        from repro_torch.serve import GraphRankingService

        csr, _, fac, svc = graph_fixture(api, graph, SparseEmbeddingIndex,
                                         GraphRankingService, GRAPH_NODES, "cuda")
        pre = {"words": np.array(fac.index.packed.words),
               "n_rows": fac.index.packed.max_slots}
        update_node(svc, csr)
        entry = accumulate_timing(torch, K, bscsr, fac, pre, errs, {"bscsr_spmv": 0})
        log(json.dumps({"kernels": [entry]}))
        log(card_line())
        log(f"ONLY accumulate: done in {time.time() - t_start:.1f} s (no result line)")
        return 0

    # ---- phase 3: the main path at the deployment configuration ----
    check = Check("main path")
    if args.rows != 10_000_000:
        log(f"CUT: n_rows {args.rows} instead of 10000000 (depth only)")
    t0 = time.time()
    csr = bscsr.synthetic_embedding_csr(args.rows, 512, 20.0, "gamma", seed=args.seed)
    log(f"  collection: {csr.shape[0]} x {csr.shape[1]}, nnz {csr.nnz} "
        f"({time.time() - t0:.1f} s)")
    cfg = api.TopKSpMVConfig(big_k=100, k=8, block_size=256, value_format="BF16",
                             packets_per_step=2, stream_layout="fused", device="cuda")
    t0 = time.time()
    svc = SparseEmbeddingIndex(csr, cfg)          # the mutable index
    index = svc.index
    packed = index.packed
    log(f"  SparseEmbeddingIndex (mutable) build: {time.time() - t0:.1f} s, "
        f"c={packed.num_cores} P={packed.vals.shape[1]} "
        f"stream {packed.stream_bytes / 1e9:.3f} GB ({packed.bytes_per_nnz:.3f} B/nnz)")
    check.expect(packed.num_cores == 32, f"c = {packed.num_cores}, expected 32")
    rng = np.random.default_rng(args.seed + 1)
    xs64 = rng.standard_normal((64, 512)).astype(np.float32)
    executor = api.query_executor(cfg)
    svc.query(xs64[0])                            # pins the snapshot
    topk_spmv_warm = api.topk_spmv(index, torch.from_numpy(xs64[0]).cuda())
    torch.cuda.synchronize()
    copies_before = executor.h2d_copies

    K.reset_launch_counts()
    t0 = time.time()
    single = [svc.query(xs64[i]) for i in range(3)]
    batch8 = svc.query_batch(xs64[:8])
    batch64 = svc.query_batch(xs64)
    direct = api.topk_spmv(index, torch.from_numpy(xs64[0]).cuda())
    torch.cuda.synchronize()
    main_s = time.time() - t0
    log(f"  main path: {main_s * 1e3:.1f} ms host clock")
    check.expect(executor.h2d_copies == copies_before,
                 f"h2d_copies moved in steady state: {copies_before} -> "
                 f"{executor.h2d_copies}")
    check.expect(all(np.array_equal(a, b) for a, b in zip(
        (t.cpu().numpy() for t in topk_spmv_warm), (t.cpu().numpy() for t in direct))),
        "repeated topk_spmv answers differ")

    # Against the torch oracle (the reference path), one query at a time.
    def against_oracle(answers, deleted=frozenset()):
        worst = 0.0
        for x, (v, r) in answers:
            ov, orow = api.topk_spmv(svc.index, torch.from_numpy(x).cuda(),
                                     use_kernel=False)
            ok, err = compare((torch.from_numpy(np.asarray(v)),
                               torch.from_numpy(np.asarray(r))), (ov, orow), bitwise=False)
            worst = max(worst, err)
            check.expect(ok, f"main path answer differs from the oracle (max err {err:.3g})")
            check.expect(not deleted & set(np.asarray(r).tolist()),
                         "a deleted row id was returned")
        return worst

    def all_answers(single, batch8, batch64, direct=None):
        answers = [(xs64[i], single[i]) for i in range(len(single))]
        answers += [(xs64[i], (batch8[0][i], batch8[1][i])) for i in range(8)]
        answers += [(xs64[i], (batch64[0][i], batch64[1][i])) for i in range(64)]
        if direct is not None:
            answers += [(xs64[0], tuple(t.cpu().numpy() for t in direct))]
        return answers

    answers = all_answers(single, batch8, batch64, direct)
    worst = against_oracle(answers)
    log(f"  {len(answers)} answers vs the torch oracle: max abs err {worst:.3g}")

    expected = index.expected_precision
    precisions = []
    for i in range(3):
        _, exact_rows = api.topk_spmv_exact(csr, xs64[i], cfg.big_k)
        precisions.append(len(set(single[i][1].tolist()) & set(exact_rows.tolist()))
                          / cfg.big_k)
    mean_p = float(np.mean(precisions))
    log(f"  precision@{cfg.big_k} vs exact search: {precisions} (mean {mean_p:.3f}); "
        f"expected {expected:.4f}")
    check.expect(mean_p >= expected - 0.02, "precision below expected - 0.02")
    for v, r in single:
        check.expect(v.shape == (100,) and np.isfinite(v).all()
                     and (r >= 0).all() and (r < args.rows).all(),
                     "query() output is not 100 finite scores over valid rows")

    # End-to-end host-clock latency of the facade (after warm-up).
    def host_ms(fn, reps=5):
        fn()
        t = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            t.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(t))

    e2e = {"query_ms": host_ms(lambda: svc.query(xs64[0])),
           "query_batch_q8_ms": host_ms(lambda: svc.query_batch(xs64[:8])),
           "query_batch_q64_ms": host_ms(lambda: svc.query_batch(xs64))}
    log("END_TO_END " + json.dumps(e2e))

    # Serve while ingesting: 64 new rows, 64 deleted, then the same queries.
    # The old snapshot must die with the swap for its signature to count as
    # retraced, so this scope keeps a device copy of its words (phase 4
    # times the kernels on them, as before ingest) and lets go of it.
    words = torch.from_numpy(np.ascontiguousarray(packed.words)).cuda()
    main_slots, main_nnz, main_cores = packed.max_slots, packed.nnz, packed.num_cores
    del packed
    retraces_before = executor.retraces
    signature_before = index.packed.signature_info()
    new_rows = rng.standard_normal((64, 512)).astype(np.float32)
    deleted = frozenset(int(i) for i in rng.choice(args.rows, 64, replace=False))
    t0 = time.perf_counter()
    new_ids = svc.upsert(new_rows)
    upsert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc.delete(sorted(deleted))
    delete_s = time.perf_counter() - t0
    check.expect(list(new_ids) == list(range(args.rows, args.rows + 64)),
                 "upsert did not assign the next 64 ids")
    single = [svc.query(xs64[i]) for i in range(3)]
    batch8 = svc.query_batch(xs64[:8])
    batch64 = svc.query_batch(xs64)
    answers = all_answers(single, batch8, batch64)
    worst = against_oracle(answers, deleted)
    first_retraces = executor.retraces - retraces_before
    signature_after = index.packed.signature_info()
    for i in range(3):                            # further ingest: no retrace
        svc.upsert(rng.standard_normal((8, 512)).astype(np.float32))
        svc.query(xs64[i])
        svc.query_batch(xs64[:8])
        svc.query_batch(xs64)
        api.topk_spmv(svc.index, torch.from_numpy(xs64[i]).cuda(), use_kernel=False)
    later_retraces = executor.retraces - retraces_before - first_retraces
    stats = svc.stats()
    torch.cuda.synchronize()
    launches = {"bscsr_topk_spmv": K.bscsr_topk_spmv.launches,
                "bscsr_topk_spmv_multiquery": K.bscsr_topk_spmv_multiquery.launches}
    log(f"  ingest: upsert 64 rows {upsert_s:.2f} s, delete 64 rows {delete_s:.2f} s; "
        f"{len(answers)} answers after it vs the oracle: max abs err {worst:.3g}")
    log(f"  signature {signature_before} -> {signature_after}; retraces at the first "
        f"mutation {first_retraces}, over 3 more upserts {later_retraces}")
    log(f"  stats: version {stats.version}, delta_fraction {stats.delta_fraction:.2e}, "
        f"tombstones {stats.tombstone_count}, deleted {stats.deleted_rows}")
    log(f"  launches on the main path: {launches}")
    check.expect(1 <= first_retraces <= 4,
                 f"{first_retraces} retraces at the first mutation (one per dispatch key)")
    check.expect(later_retraces == 0, f"{later_retraces} retraces after the first mutation")
    check.expect(stats.deleted_rows == 64 and stats.n_rows == args.rows + 64 + 24 - 64,
                 f"stats after ingest: {stats}")
    for name, n in launches.items():
        check.expect(n > 0, f"{name} was not launched on the main path")
    check.done()

    # ---- phase 4: timings of the top-k kernels on the main path's streams ----
    # On the snapshot before ingest (the exact packet count, as in earlier
    # runs) and on the snapshot after it (the churn-stable packet bucket),
    # each kernel against its plain version.
    check = Check("timings")
    kw = dict(k=cfg.k, n_rows=main_slots, packets_per_step=cfg.packets_per_step,
              fmt_name="BF16", block_size=cfg.block_size)
    x1 = torch.from_numpy(xs64[0]).cuda()
    x64 = torch.from_numpy(xs64).cuda()
    packed = svc.index.packed
    snaps = (("before ingest", words, main_slots),
             ("after ingest", torch.from_numpy(np.ascontiguousarray(packed.words)).cuda(),
              packed.max_slots))
    ingest_packets = packed.vals.shape[1]
    del packed

    def bound(q):
        """(bound ms, bound_by) of a Q-query pass over the main path's stream."""
        nbytes = words.numel() * 4 + q * 512 * 4 + main_cores * q * cfg.k * 8
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = 2.0 * main_nnz * q / F32_FLOPS * 1e3
        return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"

    # The single-query kernel (topk_spmv) at Q = 1.
    name = "bscsr_topk_spmv"
    ms, ms_after = (time_cuda(torch, lambda: K.bscsr_topk_spmv(x1, w, **dict(kw, n_rows=n)))
                    for _, w, n in snaps)
    plain_ms, want = time_once(torch, lambda: K.bscsr_topk_spmv_plain(x1, words, **kw))
    ok, err = compare(K.bscsr_topk_spmv(x1, words, **kw), want, bitwise=False)
    check.expect(ok, f"{name} on the main path's streams differs from plain "
                     f"(max err {err:.3g})")
    errs[name] = max(errs[name], err)
    bound_ms, bound_by = bound(1)
    log(f"  {name} Q=1: {ms:.3f} ms, after ingest ({ingest_packets} packets per core) "
        f"{ms_after:.3f} ms, plain {plain_ms:.1f} ms, max abs err {err:.3g}, bound "
        f"{bound_ms:.3f} ms by {bound_by}")
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
        "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "q": 1, "ms_by_q": {1: ms}, "ms_after_ingest": ms_after,
        "packets_after_ingest": ingest_packets,
        "achieved_gb_per_s": words.numel() * 4 / (ms * 1e-3) / 1e9,
        "queries_per_s": 1 / (ms * 1e-3),
    }]
    kernels.append(multiquery_timing(torch, K, snaps, x64, kw, check, errs, launches, bound))
    kernels[-1]["packets_after_ingest"] = ingest_packets
    del snaps
    check.done()

    # Yardstick: the exact-search score pass (not the same function: it
    # scores every row; the partitioned top-k has no single PyTorch call).
    crow = torch.from_numpy(csr.indptr).cuda()
    col = torch.from_numpy(csr.indices.astype(np.int64)).cuda()
    val = torch.from_numpy(csr.data).cuda()
    mat = torch.sparse_csr_tensor(crow, col, val, size=csr.shape)
    yard = {}
    for q, x in ((1, x1[:, None]), (64, x64.T.contiguous())):
        yard[f"q{q}_ms"] = time_cuda(
            torch, lambda: torch.topk(torch.sparse.mm(mat, x), cfg.big_k, dim=0))
    del mat, crow, col, val, words, svc, index, csr
    gc.collect()
    torch.cuda.empty_cache()
    log("YARDSTICK exact-search score pass torch.sparse.mm(csr, x) + torch.topk: "
        + json.dumps(yard))

    # ---- phase 6: the graph path at full width ----
    from repro_torch.core import graph
    from repro_torch.serve import GraphRankingService

    gsvc, spmv_launches, pre = graph_phase(K, api, graph, SparseEmbeddingIndex,
                                           GraphRankingService)
    launches["bscsr_spmv"] = spmv_launches

    # ---- phase 4 (continued): the accumulate kernel on phase 6's streams ----
    kernels.append(accumulate_timing(torch, K, bscsr, gsvc, pre, errs, launches))
    log(f"total {time.time() - t_start:.1f} s")

    # ---- phase 5: summary ----
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def multiquery_timing(torch, K, snaps, x64, kw, check, errs, launches, bound) -> dict:
    """The multi-query kernel at every Q the main path gives it (1 for
    ``query``, 8 and 64 for ``query_batch``), on the snapshots before and
    after ingest, at the card's S (``topk_splits``) and at one split (the
    one-block walk, cut at e_c), timed in turns with the split tables built
    beforehand, as the executor holds them.  At each Q and snapshot the
    kernel is held against its plain version, and the card's S against the
    S = 1 bits; then ``MQ_REPEATS`` more calls at each S must give those
    bits again (a race between warps would show only now and then).
    """
    name = "bscsr_topk_spmv_multiquery"
    t, block = kw["packets_per_step"], kw["block_size"]
    entry = {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
             "launches": launches[name], "library_ms": None}
    by = {"ms_by_q": {}, "ms_one_split_by_q": {}, "ms_after_ingest_by_q": {},
          "ms_after_ingest_one_split_by_q": {}, "plain_ms_by_q": {},
          "plain_ms_after_ingest_by_q": {}, "splits_by_q": {}, "q_chunk_by_q": {},
          "bound_ms_by_q": {}}
    for label, words, n_rows in snaps:
        kwl = dict(kw, n_rows=n_rows)
        after = label == "after ingest"
        for q in (1, 8, 64):
            x = x64[:q].contiguous()
            q_chunk, n_chunks = K.query_chunks(q)
            splits = K.topk_splits(words.device, words.shape[0], n_chunks, packets_per_step=t,
                                   block_size=block, m=x.shape[1], q_chunk=q_chunk,
                                   k=kw["k"])
            build = lambda: K.spmv_split_table(words, packets_per_step=t,  # noqa: E731
                                               block_size=block, splits=splits)
            if q == 1:
                table_ms, table_host_ms = time_cuda(torch, build), host_ms_per_call(torch,
                                                                                     build)
                log(f"SPLIT_TABLE {label}: build {table_ms:.4f} ms on the device, "
                    f"{table_host_ms:.4f} ms of host enqueue (S = {splits}, once per "
                    f"snapshot)")
                entry["split_table_ms" + ("_after_ingest" if after else "")] = table_ms
            tabs = {s: K.spmv_split_table(words, packets_per_step=t, block_size=block,
                                          splits=s) for s in {splits, 1}}
            plain_ms, want = time_once(
                torch, lambda: K.bscsr_topk_spmv_multiquery_plain(x, words, **kwl))
            got = K.bscsr_topk_spmv_multiquery(x, words, table=tabs[splits], **kwl)
            one = K.bscsr_topk_spmv_multiquery(x, words, table=tabs[1], **kwl)
            torch.cuda.synchronize()
            check.expect(compare(got, one, True)[0],
                         f"{name} Q={q} {label}: S={splits} and S=1 differ")
            for s, out in ((splits, got), (1, one)):
                ok, err = compare(out, want, bitwise=False)
                errs[name] = max(errs[name], err)
                check.expect(ok, f"{name} Q={q} S={s} {label} differs from plain "
                                 f"(max err {err:.3g})")
            for s in (splits, 1):
                reps = [K.bscsr_topk_spmv_multiquery(x, words, table=tabs[s], **kwl)
                        for _ in range(MQ_REPEATS)]
                torch.cuda.synchronize()
                bad = sum(not (torch.equal(v.view(torch.int32), one[0].view(torch.int32))
                               and torch.equal(r, one[1])) for v, r in reps)
                check.expect(bad == 0, f"{name} Q={q} S={s} {label}: {bad} of {MQ_REPEATS} "
                                       f"repeated calls differ from the S=1 bits")
            # In turns: S, 1, 1, S.
            turns = [time_cuda(torch, lambda: K.bscsr_topk_spmv_multiquery(
                x, words, table=tabs[s], **kwl)) for s in (splits, 1, 1, splits)]
            ms, ms_one = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            suffix = "_after_ingest" if after else ""
            by["ms" + suffix + "_by_q"][q] = ms
            by["ms" + suffix + "_one_split_by_q"][q] = ms_one
            by["plain_ms" + suffix + "_by_q"][q] = plain_ms
            by["splits_by_q"][q] = splits
            by["q_chunk_by_q"][q] = q_chunk
            by["bound_ms_by_q"][q] = bound(q)[0]
            log(f"  {name} Q={q} {label}: S={splits} (q_chunk {q_chunk}, {n_chunks} chunks) "
                f"{turns[0]:.3f} / {turns[3]:.3f} ms, S=1 {turns[1]:.3f} / {turns[2]:.3f} "
                f"ms, plain {plain_ms:.1f} ms, max abs err {errs[name]:.3g}, bound "
                f"{bound(q)[0]:.3f} ms")
    q = 64
    ms = by["ms_by_q"][q]
    entry.update({
        "max_abs_err": errs[name], "ms": ms, "plain_ms": by["plain_ms_by_q"][q],
        "bound_ms": bound(q)[0], "bound_by": bound(q)[1], "q": q,
        "splits": by["splits_by_q"][q], "ms_after_ingest": by["ms_after_ingest_by_q"][q],
        "achieved_gb_per_s": snaps[0][1].numel() * 4 / (ms * 1e-3) / 1e9,
        "queries_per_s": q / (ms * 1e-3), **by,
    })
    return entry


def ulp_gap(a: np.ndarray, b: np.ndarray):
    """(entries that differ, largest distance in f32 ulps) of two score vectors."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return int(np.count_nonzero(ia != ib)), int(np.abs(ia - ib).max(initial=0))


def graph_fixture(api, graph, SparseEmbeddingIndex, GraphRankingService, n_nodes, device):
    """Phase 6's operator, config, facade and ranking service."""
    t0 = time.time()
    csr = graph.synthetic_graph_csr("ring", n_nodes, seed=0)
    log(f"  ring operator: {csr.shape[0]} nodes, nnz {csr.nnz} ({time.time() - t0:.1f} s)")
    cfg = api.TopKSpMVConfig(k=8, num_partitions=32, block_size=256, value_format="F32",
                             packets_per_step=2, stream_layout="fused", device=device)
    t0 = time.time()
    fac = SparseEmbeddingIndex(csr, cfg)
    log(f"  SparseEmbeddingIndex build: {time.time() - t0:.1f} s, "
        f"P={fac.index.packed.vals.shape[1]}, int32 ids: "
        f"{fac.index.packed.cols.dtype == np.int32}")
    # The service ranks over the facade's mutable index, so update_node is
    # replace_rows with the row's weights x 1.02, as the reference benchmark
    # mutates.  Over the facade itself update_node would go through upsert,
    # which re-sparsifies and L2-normalizes the row: the operator then stops
    # being an L1 contraction, which the canonical refinement's step count
    # assumes.
    return csr, cfg, fac, GraphRankingService(fac.index, tol=1e-5)


def update_node(svc, csr):
    """The first mutation: node 4243's weights x 1.02."""
    node = GRAPH_SEEDS[-1] + 1
    row = np.zeros(csr.shape[0], np.float32)
    lo, hi = csr.indptr[node], csr.indptr[node + 1]
    row[csr.indices[lo:hi]] = csr.data[lo:hi] * 1.02
    svc.update_node(node, row)


def graph_phase(K, api, graph, SparseEmbeddingIndex, GraphRankingService,
                n_nodes=GRAPH_NODES, device="cuda"):
    """Phase 6: PPR solves through the ranking service, then top-k eigen.

    Returns (the graph facade, the accumulate kernel's launches in this phase).
    """
    check = Check("graph")
    csr, cfg, fac, svc = graph_fixture(api, graph, SparseEmbeddingIndex,
                                       GraphRankingService, n_nodes, device)
    if n_nodes == GRAPH_NODES:
        check.expect(csr.nnz == GRAPH_NNZ, f"ring operator nnz {csr.nnz} != {GRAPH_NNZ}")
    ex = api.query_executor(cfg)

    def solve(label, fn):
        before = ex.h2d_copies
        t0 = time.perf_counter()
        out = fn()
        res = getattr(out, "result", out)
        log(f"  {label}: {res.iterations} iterations, {res.refine_iterations} refine "
            f"steps, residual {res.residual:.3g}, retraces {res.retraces}, "
            f"h2d {ex.h2d_copies - before}, {time.perf_counter() - t0:.2f} s")
        check.expect(res.converged and res.canonical and res.retraces == 0,
                     f"{label}: converged {res.converged}, canonical {res.canonical}, "
                     f"retraces {res.retraces}")
        return out, ex.h2d_copies - before

    K.reset_launch_counts()
    cold, _ = solve("cold rank", lambda: svc.rank(GRAPH_SEEDS, top_k=10))
    # The build's snapshot, kept for phase 4: the first mutation moves the
    # index to churn-stable buckets (padded packets, a doubled slot bucket).
    pre = {"words": np.array(fac.index.packed.words), "n_rows": fac.index.packed.max_slots}
    update_node(svc, csr)
    t0 = time.perf_counter()
    fac.index.live_csr()
    live_s = time.perf_counter() - t0
    warm, _ = solve("warm rank after update_node", lambda: svc.rank(GRAPH_SEEDS, top_k=10))
    svc.forget(GRAPH_SEEDS)
    cold2, copies = solve("forget + cold rank", lambda: svc.rank(GRAPH_SEEDS, top_k=10))
    spmv_launches = K.bscsr_spmv.launches
    check.expect(copies == 0, f"{copies} host-to-device copies during a pinned solve")
    check.expect(warm.warm_started and not cold2.warm_started, "warm/cold bookkeeping")
    check.expect(warm.result.iterations < cold2.result.iterations,
                 f"warm start saved nothing: {warm.result.iterations} vs "
                 f"{cold2.result.iterations}")
    check.expect(not np.array_equal(cold.result.scores, cold2.result.scores),
                 "update_node did not move the operator")
    # The same warm and cold solves through the torch oracle: the kernel
    # path must give their scores bit for bit.
    ref, _ = solve("use_kernel=False", lambda: fac.personalized_pagerank(
        GRAPH_SEEDS, tol=1e-5, use_kernel=False))
    ref_warm, _ = solve("use_kernel=False warm", lambda: fac.personalized_pagerank(
        GRAPH_SEEDS, tol=1e-5, use_kernel=False, warm_start=cold.result.scores))
    for label, a, b in (("cold", cold2.result.scores, ref.scores),
                        ("warm", warm.result.scores, ref_warm.scores)):
        n_diff, gap = ulp_gap(a, b)
        log(f"  {label}: kernel vs use_kernel=False: {n_diff} of {n_nodes} scores differ")
        check.expect(n_diff == 0, f"{label} kernel solve and use_kernel=False solve "
                                  f"differ in {n_diff} scores (up to {gap} ulp)")
    # Warm vs cold: the canonical refinement contracts two tol-converged
    # iterates to ~5e-17 apart in L1 and then rounds to f32, so a score whose
    # f32 ulp is below that spread can round either way.  At 2**21 nodes a
    # few do: the bit-identity the reference claims does not hold at this
    # size (tests/test_torch_graph.py::TestPersonalizedPageRank::
    # test_warm_and_cold_at_scale_match_the_reference shows the reference's
    # own solves differing so at 2**17 nodes, and the port matching them).
    # The oracle path must show the same entries, which places the gap in
    # the algorithm and not in the kernel; each is held to 1 ulp.
    n_diff, gap = ulp_gap(warm.result.scores, cold2.result.scores)
    same = np.array_equal(warm.result.scores != cold2.result.scores,
                          ref_warm.scores != ref.scores)
    log(f"  warm vs cold: {n_diff} of {n_nodes} scores differ, by at most {gap} ulp; "
        f"the same entries on the oracle path: {same}")
    check.expect(gap <= 1 and same, f"warm solve and cold solve {gap} ulp apart "
                                    f"(oracle path same entries: {same})")
    check.expect(spmv_launches >= cold.result.iterations + warm.result.iterations
                 + cold2.result.iterations, f"bscsr_spmv launched {spmv_launches} times")
    log(f"  top nodes {cold2.node_ids.tolist()}; service {svc.info()}")

    # Where a solve's time goes: device iterations, host f64 refinement,
    # live_csr() (its first call after a mutation; cached per version).
    t0 = time.perf_counter()
    dev = graph.personalized_pagerank(fac, GRAPH_SEEDS, tol=1e-5, canonicalize=False)
    device_s = time.perf_counter() - t0
    p = graph.seed_vector(GRAPH_SEEDS, n_nodes, device=device).cpu().numpy()
    t0 = time.perf_counter()
    _, steps = graph._canonical_refine(fac.index, dev.scores, p, 0.85, 1e-5)
    refine_s = time.perf_counter() - t0
    split = {"device_iterations": dev.iterations, "device_s": device_s,
             "device_ms_per_iteration": device_s * 1e3 / max(dev.iterations, 1),
             "spmv_splits": K.spmv_splits(device, cfg.num_partitions, packets_per_step=2,
                                          block_size=256, m=n_nodes),
             "refine_steps": steps, "refine_s": refine_s,
             "refine_s_per_step": refine_s / max(steps, 1), "live_csr_s": live_s}
    log("PPR_SPLIT " + json.dumps(split))

    scsr = graph.synthetic_graph_csr("ba", EIGEN_NODES, seed=1, symmetric=True)
    efac = SparseEmbeddingIndex(scsr, cfg)
    t0 = time.perf_counter()
    eig = efac.topk_eigen(3, tol=1e-5, max_iters=3000)
    eig_s = time.perf_counter() - t0
    dense = scsr.to_dense().astype(np.float64)
    resid = [float(np.linalg.norm(dense @ v - lam * v))
             for lam, v in zip(eig.values, eig.vectors.T)]
    log(f"  topk_eigen(3) on ba {EIGEN_NODES}: values {eig.values.tolist()}, iterations "
        f"{eig.iterations}, f64 residuals {resid}, retraces {eig.retraces}, {eig_s:.2f} s")
    check.expect(eig.converged and eig.retraces == 0, "eigen solve did not converge cleanly")
    check.expect(max(resid) <= 1e-4, f"eigen residuals {resid} above 1e-4")
    check.done()
    return fac, spmv_launches, pre


def accumulate_timing(torch, K, bscsr, fac, pre, errs, launches) -> dict:
    """The accumulate kernel on phase 6's snapshots.

    ``ms`` walks the snapshot the last solves ran (churn-stable buckets:
    padded packets, a doubled slot bucket); ``ms_pre_mutation`` the build's.
    Each is timed at the card's S (``spmv_splits``) and at one split, in
    turns, with the split tables built beforehand as the executor holds
    them.  The bound counts what y = A x itself moves: the live packets of
    the stream, x once and y once.
    """
    check = Check("timings (accumulate)")
    packed = fac.index.packed
    n = packed.n_cols
    step_nnz = 2 * packed.block_size
    kw = dict(n_rows=packed.max_slots, packets_per_step=2, fmt_name="F32",
              block_size=packed.block_size)
    rng = np.random.default_rng(3)
    words = torch.from_numpy(np.ascontiguousarray(packed.words)).cuda()
    pre_words = torch.from_numpy(pre["words"]).cuda()
    splits = K.spmv_splits(words.device, packed.num_cores, packets_per_step=2,
                           block_size=packed.block_size, m=n)

    def tables(w):
        return {s: K.spmv_split_table(w, packets_per_step=2, block_size=packed.block_size,
                                      splits=s) for s in (splits, 1)}

    build = lambda: K.spmv_split_table(words, packets_per_step=2,  # noqa: E731
                                       block_size=packed.block_size, splits=splits)
    table_ms, table_host_ms = time_cuda(torch, build), host_ms_per_call(torch, build)
    cur_tables, pre_tables = tables(words), tables(pre_words)
    log(f"  bscsr_spmv: S = {splits} splits per core "
        f"(card: {torch.cuda.get_device_properties(0).multi_processor_count} SMs, "
        f"{packed.num_cores} cores)")
    log(f"SPLIT_TABLE build {table_ms:.4f} ms on the device, {table_host_ms:.4f} ms of "
        f"host enqueue (S = {splits}, once per snapshot)")
    log(f"  split bounds of core 0 after the first mutation: "
        f"{cur_tables[splits][0][0].tolist()}; before: {pre_tables[splits][0][0].tolist()}")

    # Dyadic values (j / 16) and x (i * 2**-30, i < 256) on the graph's
    # streams: every prefix sum of a step stays below 2**21 units of 2**-34,
    # exact in f32 in any order, so kernel and plain must agree bit for bit.
    dvals = np.where(packed.vals != 0, rng.integers(1, 17, packed.vals.shape) / 16.0,
                     0.0).astype(np.float32)
    dwords = torch.from_numpy(bscsr.fuse_words(dvals, packed.cols, packed.flags)).cuda()
    dx = torch.from_numpy((rng.integers(0, 256, n) * 2.0 ** -30).astype(np.float32)).cuda()
    want = K.bscsr_spmv_plain(dx, dwords, **kw)
    for s in (splits, 1):
        got = K.bscsr_spmv(dx, dwords, splits=s, **kw)
        n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        check.expect(n_diff == 0 and bool(got.abs().max() > 0),
                     f"bscsr_spmv S={s} on dyadic graph streams: {n_diff} sums differ "
                     f"from plain")
        log(f"  bscsr_spmv S={s} on dyadic graph streams: {n_diff} of {got.numel()} sums "
            f"differ from plain")
    del dwords, dvals

    # Random x at the solves' scale.  A segment sum is the difference of two
    # prefix sums of a step, each within a few ulps of the step's total of
    # |a x|; atol is 16 ulps of the largest such total.  Against one split
    # the card's S must give the same bits.
    x = torch.from_numpy(rng.random(n).astype(np.float32) / n).cuda()
    csr, _ = fac.index.live_csr()
    atol = 16 * 2.0 ** -24 * step_nnz * float(csr.data.max()) * float(x.max())
    plain_ms, want = time_once(torch, lambda: K.bscsr_spmv_plain(x, words, **kw))
    timed = {}
    for label, w, n_rows, tabs, ref in (
            ("current", words, kw["n_rows"], cur_tables, want),
            ("pre-mutation", pre_words, pre["n_rows"], pre_tables, None)):
        kwl = dict(kw, n_rows=n_rows)
        if ref is None:
            ref = K.bscsr_spmv_plain(x, w, **kwl)
        got = K.bscsr_spmv(x, w, table=tabs[splits], **kwl)
        one = K.bscsr_spmv(x, w, table=tabs[1], **kwl)
        n_diff = int((got.view(torch.int32) != one.view(torch.int32)).sum())
        check.expect(n_diff == 0, f"bscsr_spmv on the {label} graph streams: S={splits} "
                                  f"and S=1 differ in {n_diff} sums")
        err = float((got.double() - ref.double()).abs().max())
        errs["bscsr_spmv"] = max(errs["bscsr_spmv"], err)
        check.expect(err <= atol and float(ref.abs().max()) > 100 * atol,
                     f"bscsr_spmv on the {label} graph streams differs from plain "
                     f"(max err {err:.3g}, atol {atol:.3g})")
        log(f"  bscsr_spmv on the {label} streams, random x: S={splits} vs S=1: {n_diff} "
            f"of {got.numel()} sums differ; vs plain max abs err {err:.3g} (atol "
            f"{atol:.3g}, largest sum {float(ref.abs().max()):.3g})")
        # In turns: S, 1, 1, S.
        turns = [time_cuda(torch, lambda: K.bscsr_spmv(x, w, table=tabs[s], **kwl))
                 for s in (splits, 1, 1, splits)]
        timed[label] = ((turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2)
        log(f"  bscsr_spmv on the {label} streams: S={splits} {turns[0]:.4f} / "
            f"{turns[3]:.4f} ms, S=1 {turns[1]:.4f} / {turns[2]:.4f} ms")
    host_ms = host_ms_per_call(torch, lambda: K.bscsr_spmv(x, words, table=cur_tables[splits],
                                                           **kw))
    log(f"  bscsr_spmv: host enqueue {host_ms:.4f} ms per call (wrapper and launch)")
    ms, ms_one = timed["current"]
    ms_pre, ms_pre_one = timed["pre-mutation"]
    mat = torch.sparse_csr_tensor(torch.from_numpy(csr.indptr).cuda(),
                                  torch.from_numpy(csr.indices.astype(np.int64)).cuda(),
                                  torch.from_numpy(csr.data).cuda(), size=csr.shape)
    library_ms = time_cuda(torch, lambda: torch.sparse.mm(mat, x[:, None]))
    live_packets = int(((packed.vals != 0).any(-1) | (packed.flags != 0).any(-1)).sum())
    live_bytes = live_packets * packed.words.shape[2] * 4
    nbytes = live_bytes + n * 4 + n * 4
    flops = 2.0 * packed.nnz
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / F32_FLOPS * 1e3
    packets, pre_packets = packed.vals.shape[1], pre["words"].shape[1]
    log(f"  bscsr_spmv: {ms:.4f} ms at S={splits} ({ms_one:.4f} ms at S=1) over {packets} "
        f"packets per core, {ms_pre:.4f} ms ({ms_pre_one:.4f} ms at S=1) over "
        f"{pre_packets} before the first mutation, plain {plain_ms:.1f} ms; bound "
        f"{max(bytes_ms, flops_ms):.4f} ms ({nbytes / 1e6:.1f} MB: {live_packets} live "
        f"packets, x, y), torch.sparse.mm {library_ms:.4f} ms")
    check.done()
    return {
        "name": "bscsr_spmv", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["bscsr_spmv"], "launches": launches["bscsr_spmv"],
        "max_abs_err": errs["bscsr_spmv"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": library_ms, "splits": splits, "ms_one_split": ms_one,
        "ms_pre_mutation": ms_pre, "ms_pre_mutation_one_split": ms_pre_one,
        "split_table_ms": table_ms, "host_ms_per_call": host_ms,
        "packets_per_core": packets, "packets_per_core_pre_mutation": pre_packets,
        "live_packets": live_packets, "bound_bytes": nbytes, "atol": atol,
        "achieved_gb_per_s": nbytes / (ms * 1e-3) / 1e9,
    }


if __name__ == "__main__":
    sys.exit(main())
