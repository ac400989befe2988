"""qwen2.5-3b [dense]: GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    dtype="float32",
    vocab_pad_multiple=8,
)
