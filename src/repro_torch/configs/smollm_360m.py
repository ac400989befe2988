"""smollm-360m [dense]: llama-arch small; 15 heads / 5 KV heads exercises the
divisibility-fallback sharding rules. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=2,
    d_model=48,
    num_heads=3,
    num_kv_heads=1,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    dtype="float32",
    vocab_pad_multiple=8,
)
