"""The paper's own workload as a deployable service config (§V scale).

10M sparse embeddings, M=512, ~20 nnz/row (paper Table III mid row), K=100,
k=8 per partition; partitions = one per device x sub-streams.  Used by the
dry-run cell 'topk_spmv' and the examples.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class TopKServiceConfig:
    n_rows: int = 10_000_000
    n_cols: int = 512
    mean_nnz_per_row: float = 20.0
    big_k: int = 100
    k: int = 8
    cores_per_device: int = 1
    block_size: int = 256
    value_format: str = "BF16"
    distribution: str = "gamma"


CONFIG = TopKServiceConfig()

# Reduced config for CPU smoke tests / examples.
SMOKE = TopKServiceConfig(
    n_rows=20_000, n_cols=256, mean_nnz_per_row=16.0, big_k=32, k=8,
    block_size=128, value_format="F32",
)
