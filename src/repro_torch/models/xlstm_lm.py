"""xLSTM language model: groups of [1 sLSTM + (r-1) mLSTM] blocks.

The reference's ``repro/models/xlstm_lm.py``, ported.  ``XLSTM`` holds
``mlstm.<group>.<block>`` and ``slstm.<group>`` (the reference's stacked
params, unstacked), ``embed`` and ``ln_f``.  Its decode state is constant
in the context length; ``decode_step`` updates it in place.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import xlstm as X
from repro_torch.sharding.rules import P

_SLSTM_STATE = ("s_c", "s_n", "s_h", "s_m")
_MLSTM_STATE = ("m_c", "m_n", "m_m", "m_conv")


def grouping(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, mLSTM blocks a group)."""
    r = cfg.slstm_every
    if r <= 0:
        return 1, cfg.num_layers  # one group of all-mLSTM
    if cfg.num_layers % r:
        raise ValueError("num_layers must divide by slstm_every")
    return cfg.num_layers // r, r - 1


def param_specs(cfg: ModelConfig) -> dict:
    """Logical axis names of the reference's param tree (``mlstm`` stacked
    over (groups, blocks), ``slstm`` over its groups)."""
    s = {
        "embed": L.embedding_specs(cfg),
        "mlstm": X.mlstm_specs(("layers", None)),
        "ln_f": P("embed"),
    }
    if cfg.slstm_every > 0:
        s["slstm"] = X.slstm_specs(("layers",))
    return s


class XLSTM(L.LanguageModel):
    """The xLSTM model's weights and its forward, prefill and decode paths."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        """Allocates the weights uninitialized on ``device`` (``"meta"``
        allocates nothing); ``init_params`` or ``load_state_dict`` fills them."""
        super().__init__()
        self.cfg = cfg
        g, m_per = grouping(cfg)
        self.embed = L.ParamGroup(L.embedding_shapes(cfg), device)
        self.mlstm = nn.ModuleList(
            nn.ModuleList(L.ParamGroup(X.mlstm_shapes(cfg), device) for _ in range(m_per))
            for _ in range(g))
        self.ln_f = nn.Parameter(torch.empty(cfg.d_model, device=device), requires_grad=False)
        if cfg.slstm_every > 0:
            self.slstm = nn.ModuleList(L.ParamGroup(X.slstm_shapes(cfg), device)
                                       for _ in range(g))

    def _groups(self):
        """(sLSTM block or None, the group's mLSTM blocks) per group."""
        slstm = self.slstm if self.cfg.slstm_every > 0 else [None] * len(self.mlstm)
        return zip(slstm, self.mlstm)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> "XLSTM":
        """Draw every weight from ``gen`` (on the model's device), one layer at
        a time: float32 draws, held in their op's dtype (the ``tok`` draw is
        also kept as ``head_source``)."""
        self.init_embed(gen)
        for sblk, grp in self._groups():
            if sblk is not None:
                L.load_tree(sblk, X.init_slstm(gen, self.cfg))
            for mblk in grp:
                L.load_tree(mblk, X.init_mlstm(gen, self.cfg))
        self.ln_f.zero_()
        return self

    # -- forward (training / prefill) --------------------------------------

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> final hidden states (B, S, D); each block
        recomputed in the backward pass unless ``cfg.remat == "none"``."""
        cfg = self.cfg
        x = L.embed_tokens(self.embed, tokens, cfg)
        mblock = L.remat(functools.partial(X.mlstm_block, cfg=cfg), cfg)
        sblock = L.remat(functools.partial(X.slstm_block, cfg=cfg), cfg)
        for sblk, grp in self._groups():
            if sblk is not None:
                x = sblock(sblk, x)
            for mblk in grp:
                x = mblock(mblk, x)
        return L.rms_norm(x, self.ln_f, cfg.norm_eps)

    def loss_fn(self, batch: dict) -> torch.Tensor:
        """batch: tokens (B, S), labels (B, S), optional loss_mask.
        Differentiable when autograd is on."""
        logits = L.lm_logits(self.embed, self.forward(batch["tokens"]), self.cfg)
        return L.cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        """Forward over the prompt, returning last-position logits (B, V)."""
        return L.lm_logits(self.embed, self.forward(tokens)[:, -1:], self.cfg)[:, 0]

    # -- serving: constant-size recurrent state -------------------------------

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int):
        """One token per row: tokens (B, 1) -> (logits (B, V), the cache,
        updated in place).  ``pos`` is unused: the state needs no positions."""
        del pos
        cfg = self.cfg
        x = L.embed_tokens(self.embed, tokens, cfg)
        for i, (sblk, grp) in enumerate(self._groups()):
            if sblk is not None:
                x, _ = X.slstm_decode_block(sblk, x, tuple(cache[n][i] for n in _SLSTM_STATE),
                                            cfg)
            for j, mblk in enumerate(grp):
                x = X.mlstm_decode_block(mblk, x, *(cache[n][i, j] for n in _MLSTM_STATE),
                                         cfg)[0]
        x = L.rms_norm(x, self.ln_f, cfg.norm_eps)
        return L.lm_logits(self.embed, x, cfg)[:, 0], cache


def cache_shape(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """{name: (shape, dtype)}: every block's state, independent of ``seq``."""
    del seq
    g, m_per = grouping(cfg)
    di, h, dh = X.dims(cfg)
    f32 = torch.float32
    out = {"m_c": ((g, m_per, batch, h, dh, dh), f32),
           "m_n": ((g, m_per, batch, h, dh), f32),
           "m_m": ((g, m_per, batch, h), f32),
           "m_conv": ((g, m_per, batch, cfg.ssm_conv - 1, di), L.cdtype(cfg))}
    if cfg.slstm_every > 0:
        out.update({name: ((g, batch, di), f32) for name in _SLSTM_STATE})
    return out


def cache_specs(cfg: ModelConfig) -> dict:
    s = {
        "m_c": P("layers", None, "batch", "ssm_heads", None, None),
        "m_n": P("layers", None, "batch", "ssm_heads", None),
        "m_m": P("layers", None, "batch", "ssm_heads"),
        "m_conv": P("layers", None, "batch", None, "conv_dim"),
    }
    if cfg.slstm_every > 0:
        for name in _SLSTM_STATE:
            s[name] = P("layers", "batch", "conv_dim")
    return s


def init_cache(cfg: ModelConfig, batch: int, seq: int, device="cuda") -> dict:
    """Zeros, with the stabilisers ``m_m`` and ``s_m`` at ``MIN_LOG``."""
    cache = L.zero_cache(cache_shape(cfg, batch, seq), device)
    for name in ("m_m", "s_m"):
        if name in cache:
            cache[name].fill_(X.MIN_LOG)
    return cache
