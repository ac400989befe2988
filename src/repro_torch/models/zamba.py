"""Zamba2-style hybrid: a Mamba2 backbone and ONE weight-shared attention
block applied after every ``cfg.shared_attn_every`` Mamba2 blocks.

The reference's ``repro/models/zamba.py``, ported.  ``Zamba`` holds
``mamba.<group>.<block>`` (the reference's (g, e)-stacked params,
unstacked), ``mamba_tail.<block>``, ``shared`` (held once and applied after
every group, not copied per group), ``embed`` and ``ln_f``.  Decode keeps a
constant-size SSM state per Mamba2 block and one KV cache per application of
the shared block; ``decode_step`` updates ``ssm``, ``conv``, ``k`` and ``v``
in place.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.sharding.rules import P


def grouping(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(groups, Mamba2 blocks a group, tail blocks)."""
    e = cfg.shared_attn_every
    g = cfg.num_layers // e
    return g, e, cfg.num_layers - g * e


def shared_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln1": ((d,), torch.float32), "attn": L.attention_shapes(cfg),
            "ln2": ((d,), torch.float32), "mlp": L.mlp_shapes(d, cfg.d_ff, L.cdtype(cfg))}


def _shared_attn_block(shared, x, cfg: ModelConfig, positions):
    h = L.rms_norm(x, shared["ln1"], cfg.norm_eps)
    q, k, v = L.qkv_project(shared["attn"], h, cfg, positions)
    x = x + L.attention_out(shared["attn"], L.blockwise_attention(q, k, v, causal=True), cfg)
    h = L.rms_norm(x, shared["ln2"], cfg.norm_eps)
    return x + L.gated_mlp(shared["mlp"], h)


def param_specs(cfg: ModelConfig) -> dict:
    """Logical axis names of the reference's param tree (``mamba`` stacked
    over (groups, blocks), ``mamba_tail`` over its blocks)."""
    _, _, tail = grouping(cfg)
    mamba = ssm.mamba_specs(cfg, layers=True)
    grouped = {name: P("layers", None, *s[1:]) for name, s in mamba.items()}
    s = {
        "embed": L.embedding_specs(cfg),
        "mamba": grouped,
        "shared": {
            "ln1": P("embed"),
            "attn": L.attention_specs(cfg, layers=False),
            "ln2": P("embed"),
            "mlp": L.mlp_specs(layers=False),
        },
        "ln_f": P("embed"),
    }
    if tail:
        s["mamba_tail"] = mamba
    return s


class Zamba(L.LanguageModel):
    """The hybrid model's weights and its forward, prefill and decode paths."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        """Allocates the weights uninitialized on ``device`` (``"meta"``
        allocates nothing); ``init_params`` or ``load_state_dict`` fills them."""
        super().__init__()
        self.cfg = cfg
        g, e, tail = grouping(cfg)
        block = lambda: L.ParamGroup(ssm.mamba_shapes(cfg), device)  # noqa: E731
        self.embed = L.ParamGroup(L.embedding_shapes(cfg), device)
        self.mamba = nn.ModuleList(nn.ModuleList(block() for _ in range(e)) for _ in range(g))
        self.shared = L.ParamGroup(shared_shapes(cfg), device)
        self.ln_f = nn.Parameter(torch.empty(cfg.d_model, device=device), requires_grad=False)
        if tail:
            self.mamba_tail = nn.ModuleList(block() for _ in range(tail))

    def _blocks(self):
        """Every Mamba2 block in order, the tail's last."""
        tail = list(self.mamba_tail) if hasattr(self, "mamba_tail") else []
        return [blk for grp in self.mamba for blk in grp] + tail

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> "Zamba":
        """Draw every weight from ``gen`` (on the model's device), one layer at
        a time: float32 draws, held in their op's dtype (the ``tok`` draw is
        also kept as ``head_source``)."""
        cfg = self.cfg
        self.init_embed(gen)
        for blk in self._blocks():
            L.load_tree(blk, ssm.init_mamba(gen, cfg))
        d = cfg.d_model
        L.load_tree(self.shared, {"ln1": L.zeros_init(gen, (d,)),
                                  "attn": L.init_attention(gen, cfg),
                                  "ln2": L.zeros_init(gen, (d,)),
                                  "mlp": L.init_mlp(gen, d, cfg.d_ff)})
        self.ln_f.zero_()
        return self

    # -- forward (training / prefill) --------------------------------------

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> final hidden states (B, S, D); each Mamba2 block
        and each application of the shared block recomputed in the backward
        pass unless ``cfg.remat == "none"``."""
        cfg = self.cfg
        x = L.embed_tokens(self.embed, tokens, cfg)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        mblock = L.remat(functools.partial(ssm.mamba_block, cfg=cfg), cfg)
        ablock = L.remat(functools.partial(_shared_attn_block, cfg=cfg, positions=positions),
                         cfg)
        for grp in self.mamba:
            for blk in grp:
                x = mblock(blk, x)
            x = ablock(self.shared, x)
        for blk in getattr(self, "mamba_tail", ()):
            x = mblock(blk, x)
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

    # -- serving --------------------------------------------------------------

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int):
        """One token per row at absolute position ``pos``: tokens (B, 1) ->
        (logits (B, V), the cache, updated in place)."""
        cfg = self.cfg
        pos = int(pos)
        x = L.embed_tokens(self.embed, tokens, cfg)
        positions = torch.full((1, 1), pos, dtype=torch.float32, device=x.device)
        layer = 0
        for i, grp in enumerate(self.mamba):
            for blk in grp:
                x, _, _ = ssm.mamba_decode_block(blk, x, cache["ssm"][layer],
                                                 cache["conv"][layer], cfg)
                layer += 1
            # The shared block's application i, in its decode form.
            shared, kc, vc = self.shared, cache["k"][i], cache["v"][i]
            h = L.rms_norm(x, shared["ln1"], cfg.norm_eps)
            q, k, v = L.qkv_project(shared["attn"], h, cfg, positions)
            attn = L.decode_attention(q, L.cache_insert(kc, k, pos),
                                      L.cache_insert(vc, v, pos), pos + 1)
            x = x + L.attention_out(shared["attn"], attn, cfg)
            x = x + L.gated_mlp(shared["mlp"], L.rms_norm(x, shared["ln2"], cfg.norm_eps))
        for blk in getattr(self, "mamba_tail", ()):
            x, _, _ = ssm.mamba_decode_block(blk, x, cache["ssm"][layer], cache["conv"][layer],
                                             cfg)
            layer += 1
        x = L.rms_norm(x, self.ln_f, cfg.norm_eps)
        return L.lm_logits(self.embed, x, cfg)[:, 0], cache


def cache_shape(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """{name: (shape, dtype)}: the Mamba2 states of all blocks and the KV
    cache of each shared-block application."""
    g, e, tail = grouping(cfg)
    out = ssm.mamba_cache_shape(cfg, g * e + tail, batch)
    kv = ((g, batch, cfg.num_kv_heads, seq, cfg.resolved_head_dim), L.cdtype(cfg))
    return dict(out, k=kv, v=kv)


def cache_specs(cfg: ModelConfig) -> dict:
    m = ssm.mamba_cache_specs()
    kv = P("layers", "batch", "kv_heads", "cache_seq", None)
    return {"ssm": m["ssm"], "conv": m["conv"], "k": kv, "v": kv}


def init_cache(cfg: ModelConfig, batch: int, seq: int, device="cuda") -> dict:
    return L.zero_cache(cache_shape(cfg, batch, seq), device)
