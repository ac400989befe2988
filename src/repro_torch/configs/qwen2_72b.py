"""qwen2-72b [dense]: the largest assigned cell; FSDP+TP required.
[arXiv:2407.10671; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
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
