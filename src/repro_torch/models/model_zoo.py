"""Unified model API: one dispatch point for all ten architectures.

The reference's ``repro/models/model_zoo.py``, ported.  ``get_model(cfg)``
returns a ``ModelAPI`` whose members close over the config.  The params are
the family's model, an ``nn.Module`` (``transformer.Transformer`` for dense,
moe and vlm, ``zamba.Zamba`` for hybrid, ``xlstm_lm.XLSTM`` for ssm,
``whisper.Whisper`` for audio) on the device of the generator that drew
them (or the one ``convert.params_from_reference`` was given).

Left out: the sharding members (``param_specs``, ``cache_specs``,
``batch_spec``, ``batch_logical``), which place arrays on a GSPMD mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer, whisper, xlstm_lm, zamba

# Each family's module: its model class and its cache functions.
_FAMILIES = {"dense": (transformer, transformer.Transformer),
             "moe": (transformer, transformer.Transformer),
             "vlm": (transformer, transformer.Transformer),
             "hybrid": (zamba, zamba.Zamba),
             "ssm": (xlstm_lm, xlstm_lm.XLSTM),
             "audio": (whisper, whisper.Whisper)}


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    build: Callable[..., Any]
    init_params: Callable[..., Any]
    loss_fn: Callable[[Any, Dict], torch.Tensor]
    prefill: Callable[[Any, Dict], torch.Tensor]
    decode_step: Callable[..., Any]
    cache_shape: Callable[[int, int], Dict]
    init_cache: Callable[..., Dict]


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    mod, cls = _FAMILIES[cfg.family]

    def build(device, max_seq: int = 4096):
        """The model with uninitialized weights on ``device``.  Only Whisper
        holds a position table (``max_seq`` rows of ``dec_pos``); the other
        families need none, so they ignore ``max_seq``, as in the reference."""
        if cfg.family == "audio":
            return cls(cfg, device, max_seq)
        return cls(cfg, device)

    def init_params(gen: torch.Generator, max_seq: int = 4096):
        """The model's weights drawn from ``gen``, on its device."""
        return build(gen.device, max_seq).init_params(gen)

    if cfg.family in ("dense", "moe", "vlm"):
        def prefill(params, batch):
            return params.prefill(batch["tokens"], batch.get("prefix_embeds"))
    elif cfg.family == "audio":
        def prefill(params, batch):
            return params.prefill(batch)
    else:
        def prefill(params, batch):
            return params.prefill(batch["tokens"])

    return ModelAPI(
        cfg=cfg,
        build=build,
        init_params=init_params,
        loss_fn=lambda params, batch: params.loss_fn(batch),
        prefill=prefill,
        decode_step=lambda params, cache, tokens, pos: params.decode_step(cache, tokens, pos),
        cache_shape=lambda batch, seq: mod.cache_shape(cfg, batch, seq),
        init_cache=lambda batch, seq, device="cuda": mod.init_cache(cfg, batch, seq, device),
    )


# ---------------------------------------------------------------------------
# Analytic parameter counts (for MODEL_FLOPS = 6*N*D in the roofline)
# ---------------------------------------------------------------------------

def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact count from the model built on the ``meta`` device (nothing is
    allocated; Whisper with 128 decoder positions, as the reference counts);
    the MoE active subset counts each token's ``experts_per_token`` of
    ``num_experts`` expert FFNs."""
    model = get_model(cfg).build("meta", 128)
    total = moe_expert = 0
    for name, p in model.named_parameters():
        total += p.numel()
        parts = name.split(".")
        if "moe" in parts and parts[-1].startswith("w_"):
            moe_expert += p.numel()
    if active_only and cfg.num_experts > 0:
        frac = cfg.experts_per_token / cfg.num_experts
        total = total - moe_expert + int(moe_expert * frac)
    return total
