"""Device time of the port's top-k kernels on the paper's collection, by Q.

    python3 benchmarks/bench_torch_multiquery.py --src src --cache build/words.pt \
        --out build/multiquery_times.json

Times ``bscsr_topk_spmv_multiquery`` at each Q of ``--qs`` (at the card's S,
and at one split with ``--one-split``) and ``bscsr_topk_spmv`` at one query,
on the 10M x 512 BF16 collection of ``perfbench/gen.py`` (seed ``--seed``,
B = 256, T = 2, c = 32, k = 8), with CUDA events around repeated launches
while a sleep kernel holds the stream (device time, not enqueue time).
``--src`` names the ``src`` directory of the tree whose ``repro_torch`` is
timed, so two trees can be timed in turns by two processes; the packed words
are built once and kept in ``--cache`` (the packing is the same in both).
Prints one JSON line and writes it to ``--out``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import torch

HOLD_CYCLES = 100_000_000
F32_OPS = 67e12        # f32 operations a second outside the tensor cores (H100 SXM)
HBM_BYTES = 3.35e12    # bytes a second


def time_cuda(fn, budget_s: float = 2.0) -> float:
    """Mean device ms of ``fn`` over repeated launches."""
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


def packed_words(cache: Path, rows: int, seed: int, device):
    """(words on the device, slot budget, nnz), built once into ``cache``."""
    if cache.exists():
        blob = torch.load(cache)
    else:
        from repro_torch.core import bscsr
        from repro_torch.kernels import ops

        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
        from perfbench import gen

        host = gen.collection(rows, 512, 20.0, seed, device)
        csr = bscsr.CSRMatrix(host.indptr, host.indices, host.data, (host.n_rows, 512))
        packed = ops.pack_partitions(csr, 32, 256, "BF16", packets_multiple=2,
                                     stream_layout="fused")
        blob = {"words": torch.from_numpy(packed.words), "max_slots": packed.max_slots,
                "nnz": host.nnz}
        cache.parent.mkdir(parents=True, exist_ok=True)
        torch.save(blob, cache)
    return blob["words"].to(device), int(blob["max_slots"]), int(blob["nnz"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--cache", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--seed", type=int, default=2900)
    ap.add_argument("--qs", default="1,2,8,30,64")
    ap.add_argument("--one-split", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import bscsr_topk_spmv as K

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    words, n_rows, nnz = packed_words(Path(args.cache), args.rows, args.seed, dev)
    build_s = time.perf_counter() - t0
    kw = dict(k=8, n_rows=n_rows, packets_per_step=2, fmt_name="BF16", block_size=256)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    stream_bytes = words.numel() * 4
    out = {"src": args.src, "device": torch.cuda.get_device_name(0), "nnz": nnz,
           "stream_bytes": stream_bytes, "words_s": round(build_s, 3), "by_q": {}}
    # Each call walks a prebuilt split table, as the executor's cached
    # tables do (building one costs about as much as a pass at small Q).
    table = lambda s: K.spmv_split_table(words, packets_per_step=2, block_size=256, splits=s)
    x1 = torch.randn(512, generator=g, device=dev)
    s1 = K.single_splits(dev, 32, packets_per_step=2, block_size=256, m=512, k=8,
                         width=words.shape[2], fmt_name="BF16")
    t1 = table(s1)
    out["single_ms"] = time_cuda(lambda: K.bscsr_topk_spmv(x1, words, table=t1, **kw))
    out["single_splits"] = s1
    one = table(1)
    for q in (int(v) for v in args.qs.split(",")):
        x = torch.randn((q, 512), generator=g, device=dev)
        try:
            chunk, n_chunks = K.query_chunks(q, 512)
            splits = K.topk_splits(dev, 32, n_chunks, packets_per_step=2, block_size=256,
                                   m=512, q_chunk=chunk, k=8, width=words.shape[2],
                                   fmt_name="BF16")
        except TypeError:      # a tree whose query_chunks takes Q alone
            chunk, n_chunks = K.query_chunks(q)
            splits = K.topk_splits(dev, 32, n_chunks, packets_per_step=2, block_size=256,
                                   m=512, q_chunk=chunk, k=8)
        tq = table(splits)
        row = {"ms": time_cuda(lambda: K.bscsr_topk_spmv_multiquery(x, words, table=tq, **kw)),
               "splits": splits, "queries_a_block": chunk}
        if args.one_split:
            row["one_split_ms"] = time_cuda(
                lambda: K.bscsr_topk_spmv_multiquery(x, words, table=one, **kw))
        bound = max(2.0 * nnz * q / F32_OPS, stream_bytes / HBM_BYTES) * 1e3
        row["bound_ms"] = bound
        row["reached_pct"] = 100.0 * bound / row["ms"]
        out["by_q"][q] = row
    line = json.dumps(out)
    print(line)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
