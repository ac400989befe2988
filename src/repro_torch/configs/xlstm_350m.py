"""xlstm-350m [ssm]: sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                    # xLSTM blocks carry their own up/down projs
    vocab_size=50304,
    ssm_expand=2,
    ssm_chunk=128,
    slstm_every=4,             # blocks: [sLSTM, mLSTM, mLSTM, mLSTM] x 6
    subquadratic=True,         # constant-size recurrent state
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    vocab_size=512,
    ssm_chunk=16,
    slstm_every=4,
    dtype="float32",
    vocab_pad_multiple=8,
)
