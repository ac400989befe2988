"""Unified model API: one dispatch point for the ported architectures.

The reference's ``repro/models/model_zoo.py``, ported for the families the
transformer covers (``dense``, ``moe``, ``vlm``).  ``get_model(cfg)``
returns a ``ModelAPI`` whose members close over the config.  The params
are a ``transformer.Transformer`` module on the device of the generator
that drew them (or the one ``convert.params_from_reference`` was given).

Left out: the sharding members (``param_specs``, ``cache_specs``,
``batch_spec``, ``batch_logical``), which place arrays on a GSPMD mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

# The families still to port, with the ROADMAP item that ports them.
_NOT_PORTED = {
    "hybrid": "zamba.py + ssm.py (ROADMAP Queue 1, item 7: the other model families)",
    "ssm": "xlstm.py + xlstm_lm.py (ROADMAP Queue 1, item 7: the other model families)",
    "audio": "whisper.py (ROADMAP Queue 1, item 7: the other model families)",
}


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable[..., Any]
    loss_fn: Callable[[Any, Dict], torch.Tensor]
    prefill: Callable[[Any, Dict], torch.Tensor]
    decode_step: Callable[..., Any]
    cache_shape: Callable[[int, int], Dict]
    init_cache: Callable[..., Dict]


def get_model(cfg: ModelConfig) -> ModelAPI:
    fam = cfg.family
    if fam in _NOT_PORTED:
        raise NotImplementedError(f"family {fam!r} is not ported yet: {_NOT_PORTED[fam]}")
    if fam not in ("dense", "moe", "vlm"):
        raise ValueError(f"unknown family {fam!r}")

    def init_params(gen: torch.Generator, max_seq: int = 4096) -> transformer.Transformer:
        """The model's weights drawn from ``gen``, on its device (RoPE models
        need no position table, so ``max_seq`` is unused, as in the reference)."""
        del max_seq
        return transformer.Transformer(cfg, gen.device).init_params(gen)

    return ModelAPI(
        cfg=cfg,
        init_params=init_params,
        loss_fn=lambda params, batch: params.loss_fn(batch),
        prefill=lambda params, batch: params.prefill(batch["tokens"],
                                                     batch.get("prefix_embeds")),
        decode_step=lambda params, cache, tokens, pos: params.decode_step(cache, tokens, pos),
        cache_shape=lambda batch, seq: transformer.cache_shape(cfg, batch, seq),
        init_cache=lambda batch, seq, device="cuda": transformer.init_cache(
            cfg, batch, seq, device),
    )


# ---------------------------------------------------------------------------
# Analytic parameter counts (for MODEL_FLOPS = 6*N*D in the roofline)
# ---------------------------------------------------------------------------

def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact count from the model built on the ``meta`` device (nothing is
    allocated); the MoE active subset counts each token's
    ``experts_per_token`` of ``num_experts`` expert FFNs."""
    get_model(cfg)                                  # the family check
    model = transformer.Transformer(cfg, "meta")
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
