"""Unified model API: one dispatch point for all ten architectures.

The reference's ``repro/models/model_zoo.py``, ported.  ``get_model(cfg)``
returns a ``ModelAPI`` whose members close over the config.  The params are
the family's model, an ``nn.Module`` (``transformer.Transformer`` for dense,
moe and vlm, ``zamba.Zamba`` for hybrid, ``xlstm_lm.XLSTM`` for ssm,
``whisper.Whisper`` for audio) on the device of the generator that drew
them (or the one ``convert.params_from_reference`` was given).

The sharding members name logical axes as the reference's do:
``param_specs()`` keyed by the model's parameter names (the family's
reference-shaped tree unstacked by ``unstack_specs``), ``cache_specs()`` by
the cache's, ``batch_logical(shape)`` by the batch's; ``batch_spec(shape)``
gives the batch as ``meta`` tensors (the reference's ``ShapeDtypeStruct``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Mapping

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer, whisper, xlstm_lm, zamba
from repro_torch.sharding.rules import P

# Each family's module: its model class and its cache functions.
_FAMILIES = {"dense": (transformer, transformer.Transformer),
             "moe": (transformer, transformer.Transformer),
             "vlm": (transformer, transformer.Transformer),
             "hybrid": (zamba, zamba.Zamba),
             "ssm": (xlstm_lm, xlstm_lm.XLSTM),
             "audio": (whisper, whisper.Whisper)}


# The reference's layer-stacked subtrees and their stacked axes: each
# becomes an ``nn.ModuleList`` (of ``nn.ModuleList``s for two axes) whose
# parameters are named ``<subtree>.<i>[.<j>].<path>``.
STACKED = {"blocks": 1, "mamba": 2, "mamba_tail": 1, "mlstm": 2, "slstm": 1,
           "enc_blocks": 1, "dec_blocks": 1}


def unstack_specs(tree: Mapping, names: Iterable[str]) -> Dict[str, tuple]:
    """A reference-shaped tree of logical specs keyed by ``names`` (state-dict
    names), as ``convert.named_from_reference`` unstacks arrays: a leaf under
    a stacked subtree loses one leading entry per stacked axis and serves
    every ``<subtree>.<i>[.<j>].<path>``."""
    flat: Dict[tuple, tuple] = {}

    def walk(node: Mapping, path: tuple, axes: int) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,), axes if path else STACKED.get(key, 0))
            else:
                flat[path + (key,)] = P(*value[axes:])

    walk(tree, (), 0)
    out = {}
    for name in names:
        parts = name.split(".")
        axes = STACKED.get(parts[0], 0)
        out[name] = flat[(parts[0], *parts[1 + axes:])]
    return out


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    build: Callable[..., Any]
    init_params: Callable[..., Any]
    param_specs: Callable[[], Dict[str, tuple]]
    loss_fn: Callable[[Any, Dict], torch.Tensor]
    prefill: Callable[[Any, Dict], torch.Tensor]
    decode_step: Callable[..., Any]
    cache_shape: Callable[[int, int], Dict]
    cache_specs: Callable[[], Dict[str, tuple]]
    init_cache: Callable[..., Dict]
    batch_spec: Callable[[ShapeConfig], Dict]
    batch_logical: Callable[[ShapeConfig], Dict]


def _token_batch_spec(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """``meta`` tensors standing in for every model input (the dry run's
    input specs): the reference's shapes and dtypes."""
    b, s = shape.global_batch, shape.seq_len
    tok = lambda *sh: torch.empty(sh, dtype=torch.int32, device="meta")  # noqa: E731
    emb = lambda *sh: torch.empty(sh, dtype=getattr(torch, cfg.dtype),  # noqa: E731
                                  device="meta")
    if shape.kind == "decode":
        return {
            "cache": None,  # filled by caller via cache_shape
            "tokens": tok(b, 1),
            "pos": tok(),
        }
    if cfg.family == "audio":
        d = {"frame_embeds": emb(b, s, cfg.d_model), "tokens": tok(b, s)}
    elif cfg.family == "vlm":
        ft = cfg.frontend_tokens
        d = {"prefix_embeds": emb(b, ft, cfg.d_model), "tokens": tok(b, s - ft)}
    else:
        d = {"tokens": tok(b, s)}
    if shape.kind == "train":
        d["labels"] = tok(*d["tokens"].shape)
    return d


def _token_batch_logical(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    if shape.kind == "decode":
        return {"cache": None, "tokens": P("batch"), "pos": P()}
    out = {"tokens": P("batch", "seq")}
    if cfg.family == "audio":
        out["frame_embeds"] = P("batch", "seq", "embed")
    if cfg.family == "vlm":
        out["prefix_embeds"] = P("batch", "seq", "embed")
    if shape.kind == "train":
        out["labels"] = P("batch", "seq")
    return out


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

    def param_specs():
        names = (name for name, _ in build("meta", 1).named_parameters())
        return unstack_specs(mod.param_specs(cfg), names)

    def cache_specs():
        return unstack_specs(mod.cache_specs(cfg), mod.cache_shape(cfg, 1, 1))

    return ModelAPI(
        cfg=cfg,
        build=build,
        init_params=init_params,
        param_specs=param_specs,
        loss_fn=lambda params, batch: params.loss_fn(batch),
        prefill=prefill,
        decode_step=lambda params, cache, tokens, pos: params.decode_step(cache, tokens, pos),
        cache_shape=lambda batch, seq: mod.cache_shape(cfg, batch, seq),
        cache_specs=cache_specs,
        init_cache=lambda batch, seq, device="cuda": mod.init_cache(cfg, batch, seq, device),
        batch_spec=lambda shape: _token_batch_spec(cfg, shape),
        batch_logical=lambda shape: _token_batch_logical(cfg, shape),
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
