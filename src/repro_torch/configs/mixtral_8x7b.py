"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    subquadratic=True,        # SWA window bounds decode KV memory
    # 8 experts don't divide the 16-way model axis: shard expert FFNs on
    # their hidden dim (expert_mlp -> model via rule fallback) and the
    # dispatch capacity over data (see EXPERIMENTS.md Perf A1 + A3)
    sharding_overrides=(("expert_cap", ("pod", "data")),),
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    num_experts=4,
    experts_per_token=2,
    sliding_window=16,
    dtype="float32",
    vocab_pad_multiple=8,
)
