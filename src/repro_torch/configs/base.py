"""Model / shape / run configuration dataclasses shared by all architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Field values come from the assigned public configs."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (Mamba2-style)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # xLSTM
    slstm_every: int = 0           # every n-th block is an sLSTM block (0: none)

    # attention details
    sliding_window: int = 0        # 0 -> full causal
    qkv_bias: bool = False
    rope_theta: float = 10000.0

    # hybrid (zamba-style): shared attention block applied every n mamba blocks
    shared_attn_every: int = 0

    # encoder-decoder (whisper-style)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0

    # modality frontend stub: precomputed embeddings prepended to the sequence
    frontend: str = "none"         # none | audio_frames | vision_patches
    frontend_tokens: int = 0       # e.g. 256 vision patches

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"            # none | full | dots
    scan_layers: bool = True       # False: unroll (in-place cache decode)
    kv_quant: bool = False         # int8 KV cache (paper's fixed-point idea
                                   # applied to decode HBM traffic; §Perf B4)
    vocab_pad_multiple: int = 256  # 16 model shards x 128 lanes

    # long-context capability marker (sub-quadratic decode memory)
    subquadratic: bool = False

    # per-arch sharding-rule overrides, applied over DEFAULT_RULES by the
    # launchers (e.g. mixtral: shard MoE dispatch capacity over data because
    # its 8 experts cannot take the 16-way model axis — DESIGN.md §5)
    sharding_overrides: Tuple[Tuple[str, object], ...] = ()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, self.vocab_pad_multiple)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6*N*D model FLOPs)."""
        from repro_torch.models.model_zoo import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model_zoo import count_params_analytic

        return count_params_analytic(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: (kind, seq_len, global_batch)."""

    name: str
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k requires sub-quadratic attention (DESIGN.md §4 skip list)."""
    if shape.name == "long_500k" and not model.subquadratic:
        return False, "full quadratic attention; long_500k skipped per spec"
    return True, ""


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-run hyperparameters (launcher-level)."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    microbatches: int = 1          # grad-accumulation (overlaps reduce/backward)
    grad_dtype: str = "float32"    # float32 | bfloat16 (compressed reduction)
    steps: int = 100
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    step_timeout_s: float = 0.0    # >0: straggler watchdog
