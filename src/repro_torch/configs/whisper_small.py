"""whisper-small [audio]: enc-dec, conv frontend stubbed.
[arXiv:2212.04356; unverified]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,             # decoder layers
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    is_encoder_decoder=True,
    frontend="audio_frames",
    qkv_bias=True,
    rope_theta=0.0,            # absolute positions (sinusoid enc / learned dec)
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=2,
    encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    dtype="float32",
    vocab_pad_multiple=8,
)
