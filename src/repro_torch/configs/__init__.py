"""Architecture registry: one module per assigned config (+ the paper's own).

``get_config(name)`` returns the full published config; ``smoke_config(name)``
returns a reduced same-family config for CPU smoke tests.

The reference's ``repro/configs``, copied (they are data; a test pins every
config field-equal to the reference's).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (
    ALL_SHAPES,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    TrainConfig,
    shape_applicable,
)

ARCH_NAMES = (
    "zamba2_7b",
    "phi35_moe",
    "mixtral_8x7b",
    "whisper_small",
    "internvl2_2b",
    "qwen25_3b",
    "granite_8b",
    "smollm_360m",
    "qwen2_72b",
    "xlstm_350m",
)

# CLI aliases matching the assignment spelling.
ALIASES = {
    "zamba2-7b": "zamba2_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "mixtral-8x7b": "mixtral_8x7b",
    "whisper-small": "whisper_small",
    "internvl2-2b": "internvl2_2b",
    "qwen2.5-3b": "qwen25_3b",
    "granite-8b": "granite_8b",
    "smollm-360m": "smollm_360m",
    "qwen2-72b": "qwen2_72b",
    "xlstm-350m": "xlstm_350m",
}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE


def all_configs():
    return {n: get_config(n) for n in ARCH_NAMES}
