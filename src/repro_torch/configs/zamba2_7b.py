"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention block.
[arXiv:2411.15242; unverified]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    shared_attn_every=6,
    subquadratic=True,        # SSM state constant; shared-attn KV linear
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=16,
    shared_attn_every=2,
    dtype="float32",
    vocab_pad_multiple=8,
)
