"""Dense decoder-only transformer (llama/qwen/granite-style) + MoE variant.

The reference's ``repro/models/transformer.py``, ported.  Covers qwen2.5-3b,
granite-8b, smollm-360m, qwen2-72b (dense), mixtral-8x7b, phi3.5-moe
(``num_experts > 0``) and the internvl2 text backbone (``prefix_embeds``).

``Transformer`` is an ``nn.Module`` holding an ``nn.ModuleList`` of decoder
blocks: the reference's layer-stacked params, unstacked.  Its state dict
mirrors the reference's param tree (``embed.tok``, ``blocks.<l>.attn.wq``,
``blocks.<l>.mlp.w_gate``, ``ln_f``, ...), so ``convert.params_from_reference``
carries weights across by name.  Each weight is held once, in the dtype its
op reads (``layers`` says which).

The KV cache is a dict of preallocated ``(L, B, G, S, hd)`` tensors that
``decode_step`` updates in place: slot ``pos % window`` under a sliding
window, and the int8 planes with their per-vector scales under
``kv_quant``.

``forward`` and ``loss_fn`` record autograd when it is on (training); each
block is recomputed in the backward pass per ``cfg.remat`` (``layers.remat``:
``"full"``, ``"dots"`` or ``"none"``), as the reference's ``jax.checkpoint``.
``cfg.scan_layers`` is an XLA compile knob (scan over the stacked layers),
accepted and ignored: the blocks run in a Python loop.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.sharding.rules import P


def is_moe(cfg: ModelConfig) -> bool:
    return cfg.num_experts > 0


def block_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    s = {"ln1": ((d,), torch.float32), "attn": L.attention_shapes(cfg),
         "ln2": ((d,), torch.float32)}
    if is_moe(cfg):
        s["moe"] = moe_lib.moe_shapes(cfg)
    else:
        s["mlp"] = L.mlp_shapes(d, cfg.d_ff, L.cdtype(cfg))
    return s


def init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    p = {"ln1": L.zeros_init(gen, (d,)), "attn": L.init_attention(gen, cfg),
         "ln2": L.zeros_init(gen, (d,))}
    if is_moe(cfg):
        p["moe"] = moe_lib.init_moe(gen, cfg)
    else:
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff)
    return p


def param_specs(cfg: ModelConfig) -> dict:
    """Logical axis names of the reference's (layer-stacked) param tree."""
    blocks = {
        "ln1": P("layers", "embed"),
        "attn": L.attention_specs(cfg, layers=True),
        "ln2": P("layers", "embed"),
    }
    if is_moe(cfg):
        blocks["moe"] = moe_lib.moe_specs(cfg, layers=True)
    else:
        blocks["mlp"] = L.mlp_specs(layers=True)
    return {
        "embed": L.embedding_specs(cfg),
        "blocks": blocks,
        "ln_f": P("embed"),
    }


class Transformer(L.LanguageModel):
    """The model's weights and its forward, prefill and decode paths."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        """Allocates the weights uninitialized on ``device`` (``"meta"``
        allocates nothing); ``init_params`` or ``load_state_dict`` fills them."""
        super().__init__()
        self.cfg = cfg
        self.embed = L.ParamGroup(L.embedding_shapes(cfg), device)
        self.blocks = nn.ModuleList(L.ParamGroup(block_shapes(cfg), device)
                                    for _ in range(cfg.num_layers))
        self.ln_f = nn.Parameter(torch.empty(cfg.d_model, device=device),
                                 requires_grad=False)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> "Transformer":
        """Draw every weight from ``gen`` (on the model's device), one layer at
        a time: float32 draws, held in their op's dtype (the ``tok`` draw is
        also kept as ``head_source``)."""
        self.init_embed(gen)
        for blk in self.blocks:
            L.load_tree(blk, init_block(gen, self.cfg))
        self.ln_f.zero_()
        return self

    # -- forward (training / prefill) --------------------------------------

    def _block(self, x, blk, positions):
        cfg = self.cfg
        h = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
        q, k, v = L.qkv_project(blk["attn"], h, cfg, positions)
        attn = L.blockwise_attention(q, k, v, causal=True, sliding_window=cfg.sliding_window)
        x = x + L.attention_out(blk["attn"], attn, cfg)
        h = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
        if is_moe(cfg):
            y, aux = moe_lib.moe_mlp(blk["moe"], h, cfg)
        else:
            y, aux = L.gated_mlp(blk["mlp"], h), 0.0
        return x + y, aux

    def forward(self, tokens: torch.Tensor, prefix_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (final hidden states (B, S_total, D), MoE aux)."""
        cfg = self.cfg
        x = L.embed_tokens(self.embed, tokens, cfg)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        block = L.remat(self._block, cfg, dots=True)
        for blk in self.blocks:
            x, aux_i = block(x, blk, positions)
            aux = aux + aux_i
        return L.rms_norm(x, self.ln_f, cfg.norm_eps), aux

    def loss_fn(self, batch: dict) -> torch.Tensor:
        """batch: tokens (B,S), labels (B,S), optional prefix_embeds / loss_mask.
        Differentiable when autograd is on."""
        prefix = batch.get("prefix_embeds")
        x, aux = self.forward(batch["tokens"], prefix)
        if prefix is not None:
            x = x[:, prefix.shape[1]:]  # loss on text positions only
        logits = L.lm_logits(self.embed, x, self.cfg)
        loss = L.cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
        return loss + 0.01 * aux

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, prefix_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Forward over the prompt, returning last-position logits (B, V)."""
        x, _ = self.forward(tokens, prefix_embeds)
        return L.lm_logits(self.embed, x[:, -1:], self.cfg)[:, 0]

    # -- serving: single-token decode with a KV cache ------------------------

    def cache_shape(self, batch: int, seq: int) -> dict:
        return cache_shape(self.cfg, batch, seq)

    def init_cache(self, batch: int, seq: int) -> dict:
        return init_cache(self.cfg, batch, seq, self.device)

    def _decode_block(self, x, blk, bufs: dict, pos: int, positions: torch.Tensor):
        cfg = self.cfg
        kc, vc = bufs["k"], bufs["v"]
        window = kc.shape[2]
        slot = pos % window if cfg.sliding_window else pos
        h = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
        q, k, v = L.qkv_project(blk["attn"], h, cfg, positions)
        if cfg.kv_quant:
            L.cache_insert_quant(kc, bufs["k_scale"], k, slot)
            L.cache_insert_quant(vc, bufs["v_scale"], v, slot)
            k_at = L.cache_dequant(kc, bufs["k_scale"], x.dtype)
            v_at = L.cache_dequant(vc, bufs["v_scale"], x.dtype)
        else:
            k_at, v_at = L.cache_insert(kc, k, slot), L.cache_insert(vc, v, slot)
        attn = L.decode_attention(q, k_at, v_at, min(pos + 1, window))
        x = x + L.attention_out(blk["attn"], attn, cfg)
        h = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
        if is_moe(cfg):
            y, _ = moe_lib.moe_mlp(blk["moe"], h, cfg)
        else:
            y = L.gated_mlp(blk["mlp"], h)
        return x + y

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int,
                    return_hidden: bool = False) -> Tuple[torch.Tensor, dict]:
        """One token per row at absolute position ``pos``: tokens (B, 1) ->
        (logits (B, V), or final hidden states (B, D) with ``return_hidden``;
        the cache, updated in place)."""
        pos = int(pos)
        x = L.embed_tokens(self.embed, tokens, self.cfg)
        positions = torch.full((1, 1), pos, dtype=torch.float32, device=x.device)
        for layer, blk in enumerate(self.blocks):
            bufs = {name: buf[layer] for name, buf in cache.items()}
            x = self._decode_block(x, blk, bufs, pos, positions)
        x = L.rms_norm(x, self.ln_f, self.cfg.norm_eps)
        if return_hidden:
            # Serving with the ApproxTopKHead: the V x D logits product is
            # replaced by the paper's partitioned Top-K SpMV over the
            # sparsified embedding.
            return x[:, 0], cache
        return L.lm_logits(self.embed, x, self.cfg)[:, 0], cache


def cache_shape(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """{name: (shape, dtype)} of the KV cache."""
    window = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    kv = (cfg.num_layers, batch, cfg.num_kv_heads, window, cfg.resolved_head_dim)
    dt = torch.int8 if cfg.kv_quant else L.cdtype(cfg)
    out = {"k": (kv, dt), "v": (kv, dt)}
    if cfg.kv_quant:
        out["k_scale"] = (kv[:-1], torch.float32)
        out["v_scale"] = (kv[:-1], torch.float32)
    return out


def cache_specs(cfg: ModelConfig) -> dict:
    spec = P("layers", "batch", "kv_heads", "cache_seq", None)
    out = {"k": spec, "v": spec}
    if cfg.kv_quant:
        sc = P("layers", "batch", "kv_heads", "cache_seq")
        out["k_scale"] = sc
        out["v_scale"] = sc
    return out


def init_cache(cfg: ModelConfig, batch: int, seq: int, device="cuda") -> dict:
    return L.zero_cache(cache_shape(cfg, batch, seq), device)
