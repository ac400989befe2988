#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main query path on one card.

    python3 chip_smoke.py [--rows N] [--seed S]

Phases (any failure ends the run with a non-zero exit and no result line):

1. build     nvcc builds every kernel source of the path (sm_90a).
2. parity    each kernel against its plain PyTorch version on the card, on
             small fixtures: all four value formats, int16 and int32 column
             ids, Q in {1, 3, 64}, B in {32, 256}, T in {1, 2}, empty rows, a
             row spanning several packets, cores with fewer than k rows, all
             negative scores under a padded slot budget, poisoned padding ids.
             Dyadic fixtures must be bit-identical; random ones agree within
             rtol = atol = 1e-5 with equal row ids outside near-ties.
3. main path the deployment configuration of ``repro.configs.topk_spmv``
             (10M rows x 512 columns, gamma row lengths with mean 20, BF16,
             B=256, K=100, k=8, T=2, fused layout, c=32) through
             ``SparseEmbeddingIndex.query`` / ``query_batch`` and
             ``topk_spmv(build_index(...))``, checked against the torch
             oracle per query and against exact search for precision@K.
             Both kernels' launch counts must rise in this phase, and the
             executor's host-to-device copies must stay flat in steady state.
4. timings   each kernel at every Q the main path gives it (the single-query
             kernel at Q=1, the multi-query kernel at Q=1, 8 and 64) on the
             main path's streams (CUDA events), checked against its plain
             version on the same inputs, and its bound on an H100 SXM; the
             exact-search score pass (torch.sparse.mm + topk) as a yardstick.
5. summary   a ``kernels`` JSON line, the card's name and power limit, and
             the result line.

The script needs one CUDA device and imports only ``repro_torch`` (from
``src/`` beside it) and torch/numpy.
"""
from __future__ import annotations

import argparse
import json
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
}


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
                name_k = "bscsr_topk_spmv"
            else:
                got = K.bscsr_topk_spmv_multiquery(x, w, **kw)
                want = K.bscsr_topk_spmv_multiquery_plain(x, w, **kw)
                name_k = "bscsr_topk_spmv_multiquery"
            torch.cuda.synchronize()
            ok, err = compare(got, want, bitwise)
            errs[name_k] = max(errs[name_k], err)
            check.expect(ok, f"{name} Q={q}: kernel != plain (max err {err:.3g})")
    log(f"  {len(cases) * 3} kernel/plain comparisons")
    check.done()


# ---------------------------------------------------------------------------
# Timing helpers
# ---------------------------------------------------------------------------

def time_cuda(torch, fn, budget_s=2.0):
    """Mean ms of ``fn`` over repeated launches, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    reps = int(min(50, max(3, budget_s * 1e3 / one)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_once(torch, fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


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

    # ---- phase 2: kernels vs plain versions on small fixtures ----
    errs = {"bscsr_topk_spmv": 0.0, "bscsr_topk_spmv_multiquery": 0.0}
    parity_phase(torch, K, ops, bscsr, errs)

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
    svc = SparseEmbeddingIndex(csr, cfg)          # builds with api.build_index
    index = svc.index
    packed = index.packed
    log(f"  build_index: c={packed.num_cores} P={packed.vals.shape[1]} "
        f"stream {packed.stream_bytes / 1e9:.3f} GB "
        f"({packed.bytes_per_nnz:.3f} B/nnz), {time.time() - t0:.1f} s")
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
    launches = {"bscsr_topk_spmv": K.bscsr_topk_spmv.launches,
                "bscsr_topk_spmv_multiquery": K.bscsr_topk_spmv_multiquery.launches}
    log(f"  main path: {main_s * 1e3:.1f} ms host clock, launches {launches}")
    for name, n in launches.items():
        check.expect(n > 0, f"{name} was not launched on the main path")
    check.expect(executor.h2d_copies == copies_before,
                 f"h2d_copies moved in steady state: {copies_before} -> "
                 f"{executor.h2d_copies}")
    check.expect(all(np.array_equal(a, b) for a, b in zip(
        (t.cpu().numpy() for t in topk_spmv_warm), (t.cpu().numpy() for t in direct))),
        "repeated topk_spmv answers differ")

    # Against the torch oracle (the reference path), one query at a time.
    def oracle(x):
        return api.topk_spmv(index, torch.from_numpy(x).cuda(), use_kernel=False)

    answers = [(xs64[i], single[i]) for i in range(3)]
    answers += [(xs64[i], (batch8[0][i], batch8[1][i])) for i in range(8)]
    answers += [(xs64[i], (batch64[0][i], batch64[1][i])) for i in range(64)]
    answers += [(xs64[0], tuple(t.cpu().numpy() for t in direct))]
    worst = 0.0
    for x, (v, r) in answers:
        ov, orow = oracle(x)
        ok, err = compare((torch.from_numpy(np.asarray(v)), torch.from_numpy(np.asarray(r))),
                          (ov, orow), bitwise=False)
        worst = max(worst, err)
        check.expect(ok, f"main path answer differs from the oracle (max err {err:.3g})")
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
    check.done()

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

    # ---- phase 4: timings on the main path's streams ----
    check = Check("timings")
    words = torch.from_numpy(packed.words).cuda()
    kw = dict(k=cfg.k, n_rows=packed.max_slots, packets_per_step=cfg.packets_per_step,
              fmt_name="BF16", block_size=cfg.block_size)
    x1 = torch.from_numpy(xs64[0]).cuda()
    x64 = torch.from_numpy(xs64).cuda()
    stream_bytes = words.numel() * 4
    kernels = []
    # Every shape the main path gives a kernel: the single-query kernel at
    # Q=1 (topk_spmv); the multi-query kernel at Q=1 (query), 8 and 64
    # (query_batch).  The kernel line reports the last Q of each.
    shapes = (("bscsr_topk_spmv", (1,)), ("bscsr_topk_spmv_multiquery", (1, 8, 64)))
    for name, qs in shapes:
        wrapper = getattr(K, name)
        plain = getattr(K, name + "_plain")
        ms_by_q, plain_ms_by_q = {}, {}
        for q in qs:
            x = x1 if name == "bscsr_topk_spmv" else x64[:q].contiguous()
            ms_by_q[q] = time_cuda(torch, lambda: wrapper(x, words, **kw))
            plain_ms_by_q[q], want = time_once(torch, lambda: plain(x, words, **kw))
            ok, err = compare(wrapper(x, words, **kw), want, bitwise=False)
            torch.cuda.synchronize()
            check.expect(ok, f"{name} at Q={q} on the main path's streams differs "
                             f"from plain (max err {err:.3g})")
            errs[name] = max(errs[name], err)
            log(f"  {name} Q={q}: {ms_by_q[q]:.3f} ms, plain {plain_ms_by_q[q]:.1f} ms, "
                f"max abs err {err:.3g}")
        ms, plain_ms = ms_by_q[q], plain_ms_by_q[q]
        nbytes = stream_bytes + x.numel() * 4 + packed.num_cores * q * cfg.k * 8
        flops = 2.0 * csr.nnz * q
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / F32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None, "q": q, "ms_by_q": ms_by_q,
            "achieved_gb_per_s": stream_bytes / (ms * 1e-3) / 1e9,
            "queries_per_s": q / (ms * 1e-3),
        })
        log(f"  {name} Q={q}: bound {max(bytes_ms, flops_ms):.3f} ms by "
            f"{kernels[-1]['bound_by']}")
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
    del mat, crow, col, val
    log("YARDSTICK exact-search score pass torch.sparse.mm(csr, x) + torch.topk: "
        + json.dumps(yard))
    log(f"total {time.time() - t_start:.1f} s")

    # ---- phase 5: summary ----
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
