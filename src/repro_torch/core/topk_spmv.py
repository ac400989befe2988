"""High-level Top-K SpMV API: build an index, query it, exact ground truth.

``TopKSpMVConfig.device`` takes the place of the reference's ``interpret``
knob: queries run on ``"cuda"`` (the hand-written kernels) unless the caller
asks for ``"cpu"`` (the kernels' plain versions).  Asking for ``"cuda"`` on
a machine without a card raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bscsr as bscsr_lib
from repro_torch.core.precision_model import expected_precision, min_partitions_for_precision
from repro_torch.kernels import executor as executor_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as ref_lib


@dataclasses.dataclass(frozen=True)
class TopKSpMVConfig:
    """User-facing knobs; mirrors the paper's design space (Table II)."""

    big_k: int = 100               # K
    k: int = 8                     # per-core scratchpad size (paper: 8)
    num_partitions: Optional[int] = None   # c; None -> auto from precision target
    precision_target: float = 0.99
    block_size: int = 256          # B (nnz per tile-packet)
    value_format: str = "F32"      # F32 | BF16 | Q15 | Q7 (uniform)
    recall_target: Optional[float] = None  # per-partition mixed precision (not
                                   # ported yet: raises in build_index)
    packets_per_step: int = 2      # T
    gather_mode: str = "auto"      # take | onehot | auto: all served by one gather
    inner_loop: str = "linear"     # linear | legacy | linear-seg | linear-topk
    stream_layout: str = "fused"   # fused | split (the kernels read fused words)
    use_executor: bool = True      # device-resident snapshot plane
                                   # (False: per-call upload dispatch)
    device: str = "cuda"           # cuda (kernels) | cpu (plain versions)

    def resolve_partitions(self, n_rows: int) -> int:
        if self.num_partitions is not None:
            return self.num_partitions
        c = min_partitions_for_precision(
            n_rows, self.k, self.big_k, self.precision_target
        )
        return max(c, -(-self.big_k // self.k))

    def resolve_device(self) -> torch.device:
        """The query device; raises when a card is asked for and absent."""
        dev = torch.device(self.device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device {self.device!r} requested but no CUDA device is "
                    "available; pass device='cpu' to run the plain versions"
                )
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"device must be 'cuda' or 'cpu', got {self.device!r}")
        return dev


@dataclasses.dataclass(frozen=True)
class TopKSpMVIndex:
    """An immutable, queryable packed index over one embedding collection."""

    packed: kernel_ops.PackedPartitions
    config: TopKSpMVConfig

    @property
    def n_rows(self) -> int:
        return self.packed.plan.n_rows

    @property
    def expected_precision(self) -> float:
        return expected_precision(
            self.n_rows, self.packed.num_cores, self.config.k, self.config.big_k
        )


def build_index(csr: bscsr_lib.CSRMatrix, config: TopKSpMVConfig) -> TopKSpMVIndex:
    if config.recall_target is not None:
        raise NotImplementedError(
            "recall_target (per-partition mixed precision) is not ported yet: "
            "ROADMAP Queue 1 item 8"
        )
    packed = kernel_ops.pack_partitions(
        csr,
        num_partitions=config.resolve_partitions(csr.shape[0]),
        block_size=config.block_size,
        value_format=config.value_format,
        packets_multiple=config.packets_per_step,
        stream_layout=config.stream_layout,
    )
    return TopKSpMVIndex(packed=packed, config=config)


def query_executor(config: TopKSpMVConfig) -> executor_lib.QueryExecutor:
    """The process-wide device-resident executor serving this config."""
    return executor_lib.get_executor(
        big_k=config.big_k,
        k=config.k,
        packets_per_step=config.packets_per_step,
        gather_mode=config.gather_mode,
        inner_loop=config.inner_loop,
        device=config.resolve_device(),
    )


def topk_spmv(
    index: TopKSpMVIndex, x, use_kernel: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-query approximate Top-K -> (big_k,) values and global row ids."""
    cfg = index.config
    device = cfg.resolve_device()
    if cfg.use_executor:
        return query_executor(cfg).query(
            x, index.packed, path="kernel" if use_kernel else "reference"
        )
    if use_kernel:
        return kernel_ops.topk_spmv_blocked(
            x, index.packed, big_k=cfg.big_k, k=cfg.k,
            packets_per_step=cfg.packets_per_step, gather_mode=cfg.gather_mode,
            inner_loop=cfg.inner_loop, device=device,
        )
    return kernel_ops.topk_spmv_reference(x, index.packed, big_k=cfg.big_k, k=cfg.k,
                                          device=device)


def topk_spmv_batched(
    index: TopKSpMVIndex, xs, use_kernel: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched approximate Top-K: Q queries, one pass over the stream.

    ``xs`` is (Q, M); returns (Q, big_k) values and global row ids.  With
    ``use_kernel`` the multi-query kernel reads every packet once for all Q
    queries; otherwise the torch oracle evaluates the same approximation.
    """
    cfg = index.config
    device = cfg.resolve_device()
    if cfg.use_executor:
        return query_executor(cfg).query_batched(
            xs, index.packed, path="kernel" if use_kernel else "reference"
        )
    if use_kernel:
        return kernel_ops.topk_spmv_batched(
            xs, index.packed, big_k=cfg.big_k, k=cfg.k,
            packets_per_step=cfg.packets_per_step, inner_loop=cfg.inner_loop,
            device=device,
        )
    return kernel_ops.topk_spmv_reference_batched(xs, index.packed, big_k=cfg.big_k,
                                                  k=cfg.k, device=device)


def topk_spmv_exact(
    csr: bscsr_lib.CSRMatrix, x, big_k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact CSR Top-K on host — ground truth for accuracy studies."""
    return ref_lib.csr_topk_numpy(
        csr.indptr, csr.indices, csr.data, np.asarray(x, np.float32), big_k
    )
