"""The paper's end application as a service, on the port: batched queries
through the multi-query kernel and serve-while-ingest on the mutable index
(delta packets, tombstones, compaction).

    PYTHONPATH=src python examples/torch_similarity_service.py [--rows N] [--device cpu]

It ends, as the reference's example does, with a query on a device mesh
(``distributed_topk_spmv_fn``): the index's cores split over a ("data",)
mesh of every visible card (or of the CPU with ``--device cpu``).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import bscsr
from repro_torch.core.similarity import SparseEmbeddingIndex
from repro_torch.core.topk_spmv import TopKSpMVConfig, distributed_topk_spmv_fn
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.serve import CompactionPolicy, StreamingSimilarityService


def precision_at_k(index, queries, results, big_k):
    hits = []
    for q in range(queries.shape[0]):
        _, er = index.query_exact(queries[q])
        hits.append(len(set(results[q].tolist()) & set(er.tolist())) / big_k)
    return float(np.mean(hits))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=20_000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")

    rng = np.random.default_rng(0)
    csr = bscsr.synthetic_embedding_csr(args.rows, 256, 16, "gamma", seed=2)
    cfg = TopKSpMVConfig(big_k=32, k=8, num_partitions=8, block_size=128,
                         value_format="BF16", device=args.device)
    index = SparseEmbeddingIndex(csr, cfg, nnz_per_row=16)
    queries = rng.standard_normal((8, 256)).astype(np.float32)

    # --- batched queries: 8 queries, ONE kernel pass over the stream ---
    t0 = time.perf_counter()
    vals, rows = index.query_batch(queries, use_kernel=True)
    dt = time.perf_counter() - t0
    packed = index.index.packed
    print(f"multi-query kernel: 8 queries in {dt:.2f}s (one stream pass; "
          f"effective {packed.bytes_per_nnz / 8:.2f} B/nnz/query vs "
          f"{packed.bytes_per_nnz:.2f} single-query)")
    precision = precision_at_k(index, queries, rows, cfg.big_k)
    print(f"  precision@{cfg.big_k} over the batch = {precision:.3f}")

    # --- serve-while-ingest: queries interleave with upserts/deletes ---
    print("\nserve-while-ingest (delta packets + tombstones + compaction):")
    svc = StreamingSimilarityService(index, CompactionPolicy(max_delta_fraction=0.04))
    for round_i in range(4):
        fresh = rng.standard_normal((300, 256)).astype(np.float32)
        new_ids = svc.ingest(fresh)                      # append under new ids
        svc.delete(new_ids[:50])                         # churn: drop some again
        svc.ingest(rng.standard_normal((20, 256)).astype(np.float32),
                   ids=new_ids[50:70])                   # replace in place
        _, r = svc.search(queries)                       # still answering
        st = svc.stats()
        print(f"  round {round_i}: rows={st.n_rows}  "
              f"delta={st.delta_fraction:.3f}  tombstoned_slots={st.tombstone_count}  "
              f"bytes/nnz={st.bytes_per_nnz:.2f}  v{st.version}  "
              f"compactions={svc.compactions}")
        if set(np.asarray(r).ravel().tolist()) & set(new_ids[:50].tolist()):
            raise SystemExit("a deleted row was returned")
    svc.index.compact()
    st = svc.stats()
    print(f"  final compact(): delta={st.delta_fraction:.3f}  "
          f"bytes/nnz={st.bytes_per_nnz:.2f} (base-only restored)")

    # --- mesh-distributed path: the cores split over every visible device ---
    devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
               if args.device == "cuda" else [torch.device("cpu")])
    mesh = DeviceMesh(np.array(devices, dtype=object), ("data",))
    fn, arrays = distributed_topk_spmv_fn(index.index, mesh)
    v, r = fn(torch.from_numpy(queries[0]), *arrays)
    print(f"\ndistributed query on mesh {mesh.shape}: top-3 rows {r[:3].cpu().numpy()}")
    return precision, svc


if __name__ == "__main__":
    main()
