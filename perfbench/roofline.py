"""The yardstick: the least time one H100 could take for a query pass.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet,
dense rates), as the port's dry run prices them:

  f32 products outside the tensor cores   67e12 FLOP/s
  HBM3                                    3.35e12 bytes/s

A pass of Q queries over a collection is counted from what the collection
needs, whatever implements it: 2 * nnz * Q f32 operations, and every
non-zero's value at the width of the stated format plus its column index, one bit per row, the queries read once and the K results
(f32 score, int32 id) written once.  The bound is the larger of the two
times.  A packing that moves fewer bytes cannot read over 100%.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS_F32 = 67e12
HBM_BW = 3.35e12

VALUE_BYTES = {"F32": 4, "BF16": 2, "Q15": 2, "Q7": 1}
RESULT_BYTES = 8


def col_index_bytes(n_cols: int) -> int:
    return 2 if n_cols <= 1 << 15 else 4


@dataclasses.dataclass(frozen=True)
class PassWork:
    flops: int
    bytes: int

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS_F32

    @property
    def memory_s(self) -> float:
        return self.bytes / HBM_BW

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s)

    @property
    def bound_by(self) -> str:
        return "operations" if self.compute_s >= self.memory_s else "bytes"


def pass_work(config: dict, nnz: int, q: int) -> PassWork:
    n_rows, n_cols, big_k = config["n_rows"], config["n_cols"], config["big_k"]
    stream = nnz * (VALUE_BYTES[config["value_format"]] + col_index_bytes(n_cols)) + -(-n_rows // 8)
    return PassWork(flops=2 * nnz * q,
                    bytes=stream + q * n_cols * 4 + q * big_k * RESULT_BYTES)
