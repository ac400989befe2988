"""internvl2-2b [vlm]: InternViT (stubbed patch embeddings) + InternLM2-2B.
[arXiv:2404.16821; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision_patches",
    frontend_tokens=256,
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    frontend_tokens=8,
    dtype="float32",
    vocab_pad_multiple=8,
)
