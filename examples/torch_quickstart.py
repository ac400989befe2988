"""Quickstart on the port: approximate Top-K similarity search over sparse
embeddings.

    PYTHONPATH=src python examples/torch_quickstart.py [--rows N] [--device cpu]

On the card the query runs through the CUDA kernels; with ``--device cpu``
through their plain versions.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import bscsr
from repro_torch.core.similarity import SparseEmbeddingIndex
from repro_torch.core.topk_spmv import TopKSpMVConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=50_000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")

    # 1. A collection of sparse embeddings (Gamma nnz distribution, the
    #    paper's primary synthetic benchmark set), L2-normalized.
    csr = bscsr.synthetic_embedding_csr(
        n_rows=args.rows, n_cols=512, mean_nnz_per_row=20, distribution="gamma", seed=0)

    # 2. The partitioned BS-CSR index (paper §III): 16 cores, k=8 each, bf16
    #    values.  Expected precision comes from Eq. (1) closed form.
    cfg = TopKSpMVConfig(big_k=100, k=8, num_partitions=16, block_size=256,
                         value_format="BF16", device=args.device)
    index = SparseEmbeddingIndex(csr, cfg)
    st = index.stats()
    print(f"index: {st.n_rows} rows, {st.nnz} nnz, {st.num_partitions} cores")
    print(f"stream: {st.bytes_per_nnz:.2f} B/nnz "
          f"(naive COO: 12.0 -> {12.0 / st.bytes_per_nnz:.1f}x intensity)")
    print(f"Eq.(1) expected precision@{cfg.big_k}: {st.expected_precision:.4f}")

    # 3. Query and compare with exact search.
    x = np.random.default_rng(1).standard_normal(512).astype(np.float32)
    scores, ids = index.query(x)
    escore, eids = index.query_exact(x)
    overlap = len(set(ids.tolist()) & set(eids.tolist())) / cfg.big_k
    print(f"\ntop-5 approx: {ids[:5]} scores {np.round(scores[:5], 4)}")
    print(f"top-5 exact : {eids[:5]} scores {np.round(escore[:5], 4)}")
    print(f"measured precision@{cfg.big_k}: {overlap:.3f}")
    return overlap, st.expected_precision


if __name__ == "__main__":
    main()
