"""The system under test: the port's public entries, built from a config file.

The one module of the benchmark that imports ``repro_torch``.  It builds
``SparseEmbeddingIndex`` (the mutable index behind the facade) from the
benchmark's host CSR, wraps it in ``StreamingSimilarityService`` for cells
that submit single queries, and reads the program's own counters.
"""
from __future__ import annotations

import time

import numpy as np


def build_kernels(device) -> float:
    """Seconds spent building the CUDA library (0 where it is built already)."""
    if str(device).startswith("cpu"):
        return 0.0
    from repro_torch.kernels import bscsr_topk_spmv as K

    t0 = time.perf_counter()
    K.build_library()
    K._library()
    return time.perf_counter() - t0


def build_index(config: dict, csr, device: str):
    """The facade over ``csr`` (a ``gen.HostCSR``) as the config states."""
    from repro_torch.core import topk_spmv as api
    from repro_torch.core.bscsr import CSRMatrix
    from repro_torch.core.similarity import SparseEmbeddingIndex

    cfg = api.TopKSpMVConfig(
        big_k=config["big_k"], k=config["k"], num_partitions=config["num_partitions"],
        block_size=config["block_size"], value_format=config["value_format"],
        packets_per_step=config["packets_per_step"], stream_layout=config["stream_layout"],
        device=device)
    host = CSRMatrix(indptr=csr.indptr, indices=csr.indices, data=csr.data,
                     shape=(csr.n_rows, csr.n_cols))
    return SparseEmbeddingIndex(host, cfg, recall_target=config.get("recall_target"))


def service(index):
    """The streaming service with the request frontend at its defaults."""
    from repro_torch.serve.frontend import FrontendConfig
    from repro_torch.serve.streaming import StreamingSimilarityService

    return StreamingSimilarityService(index, frontend=FrontendConfig())


def stats(index) -> dict:
    s = index.stats()
    return {"nnz": s.nnz, "bytes_per_nnz": s.bytes_per_nnz, "stream_bytes": s.stream_bytes,
            "value_format_histogram": s.value_format_histogram,
            "num_partitions": s.num_partitions, "predicted_recall": s.predicted_recall}


def counters(index) -> dict:
    """Executor cache counters and kernel launch counts: checks, not metrics."""
    from repro_torch.kernels import bscsr_topk_spmv as K

    info = index.dispatch_info()
    keep = ("h2d_copies", "fn_builds", "retraces", "dispatches")
    out = {k: info[k] for k in keep if k in info}
    out["launches"] = {"bscsr_topk_spmv": K.bscsr_topk_spmv.launches,
                       "bscsr_topk_spmv_multiquery": K.bscsr_topk_spmv_multiquery.launches}
    return out


def warm(index, pool: np.ndarray, qs) -> None:
    """One pass at each Q in ``qs`` (the first also pins the snapshot)."""
    for q in qs:
        index.query_batch(pool[:q])
