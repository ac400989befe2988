"""Deterministic synthetic token pipeline.

The reference's ``repro/train/data.py``, ported: the same recipe, drawn from
numpy's generator seeded with ``(seed, step)`` (the reference draws from
``jax.random``, whose bits no other generator repeats).  A batch is a pure
function of ``(seed, step)``, so a restarted job regenerates any step's
batch without coordination.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def batch_for_step(step: int, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                   microbatches: int = 1, device="cuda") -> Dict[str, torch.Tensor]:
    """Global batch for one step (next-token prediction), on ``device``.

    Tokens are arithmetic walks from a random start with a per-sequence
    stride of 1-4 (inferable from context) and 10% uniform noise: uniform
    tokens would pin the loss at ln(V) and hide optimizer regressions.
    ``labels`` are the tokens shifted by one.  The vlm family gets
    ``prefix_embeds`` (B, frontend_tokens, D) and ``S - frontend_tokens``
    text tokens, the audio family ``frame_embeds`` (B, S, D), both
    N(0, 0.02**2) in ``cfg.dtype``.  With ``microbatches > 1`` every leaf
    gains a leading microbatch axis.
    """
    rng = np.random.default_rng((seed, step))
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    out: Dict[str, torch.Tensor] = {}

    def synth_tokens(length: int) -> np.ndarray:
        start = rng.integers(0, cfg.vocab_size, (b, 1))
        stride = rng.integers(1, 5, (b, 1))
        toks = (start + stride * np.arange(length)[None, :]) % cfg.vocab_size
        noise = rng.random((b, length)) < 0.1
        rand = rng.integers(0, cfg.vocab_size, (b, length))
        return np.where(noise, rand, toks)

    def embeds(length: int) -> torch.Tensor:
        x = rng.standard_normal((b, length, cfg.d_model), dtype=np.float32) * 0.02
        return torch.from_numpy(x).to(device=device, dtype=dt)

    if cfg.family == "vlm":
        out["prefix_embeds"] = embeds(cfg.frontend_tokens)
        toks = synth_tokens(s - cfg.frontend_tokens + 1)
    elif cfg.family == "audio":
        out["frame_embeds"] = embeds(s)
        toks = synth_tokens(s + 1)
    else:
        toks = synth_tokens(s + 1)
    toks = torch.from_numpy(toks.astype(np.int32)).to(device)
    out["tokens"] = toks[:, :-1].contiguous()
    out["labels"] = toks[:, 1:].contiguous()
    if microbatches > 1:
        out = {k: t.reshape(microbatches, t.shape[0] // microbatches, *t.shape[1:])
               for k, t in out.items()}
    return out
