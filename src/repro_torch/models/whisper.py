"""Whisper-style encoder-decoder backbone (the conv front end stubbed).

The reference's ``repro/models/whisper.py``, ported.  The caller supplies
precomputed frame embeddings (B, S_enc, D).  Encoder: non-causal
self-attention, sinusoidal positions, GELU MLP, LayerNorm.  Decoder: causal
self-attention, cross-attention, learned positions (``dec_pos``, one row per
position up to the ``max_seq`` the model was built for).

``Whisper`` holds ``enc_blocks.<l>`` and ``dec_blocks.<l>`` (the reference's
layer-stacked params, unstacked), ``embed``, ``dec_pos`` and the
``{w, b}`` LayerNorms ``enc_ln_f`` / ``dec_ln_f`` (float32; the rest in
``cfg.dtype``).  The decode cache holds the self-attention KV, which
``decode_step`` updates in place, the cross-attention KV from
``build_cross_cache`` and ``cross_len``, its valid length (a 0-d int32
tensor: 0, an empty cross cache, until the caller fills it).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding.rules import P


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal position embedding for the encoder (float32)."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float32,
                                                  device=device))
    scaled = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def _ln_shapes(d: int) -> dict:
    return {"w": ((d,), torch.float32), "b": ((d,), torch.float32)}


def _ln_init(gen: torch.Generator, d: int) -> dict:
    return {"w": torch.ones(d, device=gen.device), "b": L.zeros_init(gen, (d,))}


def _ln_specs(lead):
    return {"w": P(*lead, "embed"), "b": P(*lead, "embed")}


def _ln(x, p, eps):
    return L.layer_norm(x, p["w"], p["b"], eps)


def enc_block_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln1": _ln_shapes(d), "attn": L.attention_shapes(cfg), "ln2": _ln_shapes(d),
            "mlp": L.mlp_shapes(d, cfg.d_ff, L.cdtype(cfg), gated=False)}


def dec_block_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln1": _ln_shapes(d), "self_attn": L.attention_shapes(cfg),
            "ln2": _ln_shapes(d), "cross_attn": L.attention_shapes(cfg),
            "ln3": _ln_shapes(d),
            "mlp": L.mlp_shapes(d, cfg.d_ff, L.cdtype(cfg), gated=False)}


def _cross_project(p, enc_out: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K and V (B, S_enc, G, hd) from the encoder output."""
    b, s_enc = enc_out.shape[:2]
    k, v = enc_out @ p["wk"], enc_out @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    shape = (b, s_enc, cfg.num_kv_heads, cfg.resolved_head_dim)
    return k.reshape(shape), v.reshape(shape)


def _cross_query(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    return q.reshape(*x.shape[:2], cfg.num_heads, cfg.resolved_head_dim)


def param_specs(cfg: ModelConfig) -> dict:
    """Logical axis names of the reference's (layer-stacked) param tree."""
    lead = ("layers",)
    enc = {
        "ln1": _ln_specs(lead),
        "attn": L.attention_specs(cfg, layers=True),
        "ln2": _ln_specs(lead),
        "mlp": L.mlp_specs(layers=True, gated=False),
    }
    dec = {
        "ln1": _ln_specs(lead),
        "self_attn": L.attention_specs(cfg, layers=True),
        "ln2": _ln_specs(lead),
        "cross_attn": L.attention_specs(cfg, layers=True),
        "ln3": _ln_specs(lead),
        "mlp": L.mlp_specs(layers=True, gated=False),
    }
    return {
        "embed": L.embedding_specs(cfg),
        "dec_pos": P("seq", "embed_fsdp"),
        "enc_blocks": enc,
        "enc_ln_f": _ln_specs(()),
        "dec_blocks": dec,
        "dec_ln_f": _ln_specs(()),
    }


class Whisper(L.LanguageModel):
    """The encoder-decoder's weights and its encode, teacher-forced decode,
    prefill and decode-step paths."""

    def __init__(self, cfg: ModelConfig, device="cuda", max_seq: int = 4096):
        """Allocates the weights uninitialized on ``device`` (``"meta"``
        allocates nothing), with ``max_seq`` decoder positions;
        ``init_params`` or ``load_state_dict`` fills them."""
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.embed = L.ParamGroup(L.embedding_shapes(cfg), device)
        self.dec_pos = nn.Parameter(torch.empty((max_seq, d), dtype=L.cdtype(cfg),
                                                device=device), requires_grad=False)
        self.enc_blocks = nn.ModuleList(L.ParamGroup(enc_block_shapes(cfg), device)
                                        for _ in range(cfg.encoder_layers))
        self.enc_ln_f = L.ParamGroup(_ln_shapes(d), device)
        self.dec_blocks = nn.ModuleList(L.ParamGroup(dec_block_shapes(cfg), device)
                                        for _ in range(cfg.num_layers))
        self.dec_ln_f = L.ParamGroup(_ln_shapes(d), device)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> "Whisper":
        """Draw every weight from ``gen`` (on the model's device), one layer at
        a time: float32 draws, held in their op's dtype (the ``tok`` draw is
        also kept as ``head_source``)."""
        cfg, d = self.cfg, self.cfg.d_model
        self.init_embed(gen)
        self.dec_pos.copy_(L.embed_init(gen, tuple(self.dec_pos.shape)))
        for blk in self.enc_blocks:
            L.load_tree(blk, {"ln1": _ln_init(gen, d), "attn": L.init_attention(gen, cfg),
                              "ln2": _ln_init(gen, d),
                              "mlp": L.init_mlp(gen, d, cfg.d_ff, gated=False)})
        for blk in self.dec_blocks:
            L.load_tree(blk, {"ln1": _ln_init(gen, d), "self_attn": L.init_attention(gen, cfg),
                              "ln2": _ln_init(gen, d), "cross_attn": L.init_attention(gen, cfg),
                              "ln3": _ln_init(gen, d),
                              "mlp": L.init_mlp(gen, d, cfg.d_ff, gated=False)})
        for ln in (self.enc_ln_f, self.dec_ln_f):
            L.load_tree(ln, _ln_init(gen, d))
        return self

    # -- encoder and teacher-forced decoder ---------------------------------

    def encode(self, frame_embeds: torch.Tensor) -> torch.Tensor:
        """frame_embeds (B, S_enc, D), precomputed (the front end's stub) ->
        the encoder output (B, S_enc, D); each block recomputed in the
        backward pass unless ``cfg.remat == "none"``."""
        cfg = self.cfg
        x = frame_embeds.to(L.cdtype(cfg))
        x = x + sinusoids(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
        positions = torch.arange(x.shape[1], device=x.device)[None, :]

        def block(x, blk):
            h = _ln(x, blk["ln1"], cfg.norm_eps)
            q, k, v = L.qkv_project(blk["attn"], h, cfg, positions)
            x = x + L.attention_out(blk["attn"], L.blockwise_attention(q, k, v, causal=False),
                                    cfg)
            return x + L.gelu_mlp(blk["mlp"], _ln(x, blk["ln2"], cfg.norm_eps))

        block = L.remat(block, cfg)
        for blk in self.enc_blocks:
            x = block(x, blk)
        return _ln(x, self.enc_ln_f, cfg.norm_eps)

    def decode_train(self, tokens: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder: tokens (B, S) against ``enc_out`` -> final
        hidden states (B, S, D); each block recomputed in the backward pass
        unless ``cfg.remat == "none"``."""
        cfg = self.cfg
        x = L.embed_tokens(self.embed, tokens, cfg)
        x = x + self.dec_pos[: x.shape[1]][None]
        positions = torch.arange(x.shape[1], device=x.device)[None, :]

        def block(x, blk, enc_out):
            h = _ln(x, blk["ln1"], cfg.norm_eps)
            q, k, v = L.qkv_project(blk["self_attn"], h, cfg, positions)
            x = x + L.attention_out(blk["self_attn"],
                                    L.blockwise_attention(q, k, v, causal=True), cfg)
            h = _ln(x, blk["ln2"], cfg.norm_eps)
            p = blk["cross_attn"]
            ck, cv = _cross_project(p, enc_out, cfg)
            attn = L.blockwise_attention(_cross_query(p, h, cfg), ck, cv, causal=False)
            x = x + L.attention_out(p, attn, cfg)
            return x + L.gelu_mlp(blk["mlp"], _ln(x, blk["ln3"], cfg.norm_eps))

        block = L.remat(block, cfg)
        for blk in self.dec_blocks:
            x = block(x, blk, enc_out)
        return _ln(x, self.dec_ln_f, cfg.norm_eps)

    def loss_fn(self, batch: dict) -> torch.Tensor:
        """batch: frame_embeds (B, S_enc, D), tokens and labels (B, S),
        optional loss_mask.  Differentiable when autograd is on."""
        x = self.decode_train(batch["tokens"], self.encode(batch["frame_embeds"]))
        logits = L.lm_logits(self.embed, x, self.cfg)
        return L.cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))

    @torch.no_grad()
    def prefill(self, batch: dict) -> torch.Tensor:
        """Encoder and the whole decoder pass; last-position logits (B, V)."""
        x = self.decode_train(batch["tokens"], self.encode(batch["frame_embeds"]))
        return L.lm_logits(self.embed, x[:, -1:], self.cfg)[:, 0]

    # -- serving: self-KV cache and precomputed cross KV --------------------

    @torch.no_grad()
    def build_cross_cache(self, enc_out: torch.Tensor, pad_to: int = 0):
        """Every decoder layer's cross-attention K and V from the encoder
        output, heads-major and zero-padded to ``pad_to`` positions: two
        (L, B, G, max(S_enc, pad_to), hd) tensors.  Serving runs this once a
        request, after ``encode``."""
        s_enc = enc_out.shape[1]
        pad = max(s_enc, pad_to) - s_enc
        ks, vs = [], []
        for blk in self.dec_blocks:
            k, v = _cross_project(blk["cross_attn"], enc_out, self.cfg)
            ks.append(torch.nn.functional.pad(k.transpose(1, 2), (0, 0, 0, pad)))
            vs.append(torch.nn.functional.pad(v.transpose(1, 2), (0, 0, 0, pad)))
        return torch.stack(ks), torch.stack(vs)

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int):
        """One token per row at decoder position ``pos``: tokens (B, 1) ->
        (logits (B, V), the cache; its self-attention KV updated in place)."""
        cfg = self.cfg
        pos = int(pos)
        x = L.embed_tokens(self.embed, tokens, cfg)
        x = x + self.dec_pos[pos][None, None]
        positions = torch.full((1, 1), pos, dtype=torch.float32, device=x.device)
        for layer, blk in enumerate(self.dec_blocks):
            kc, vc = cache["k"][layer], cache["v"][layer]
            h = _ln(x, blk["ln1"], cfg.norm_eps)
            q, k, v = L.qkv_project(blk["self_attn"], h, cfg, positions)
            attn = L.decode_attention(q, L.cache_insert(kc, k, pos), L.cache_insert(vc, v, pos),
                                      pos + 1)
            x = x + L.attention_out(blk["self_attn"], attn, cfg)
            # Cross-attention against the precomputed encoder KV.
            p = blk["cross_attn"]
            q2 = _cross_query(p, _ln(x, blk["ln2"], cfg.norm_eps), cfg)
            attn2 = L.decode_attention(q2, cache["cross_k"][layer], cache["cross_v"][layer],
                                       cache["cross_len"])
            x = x + L.attention_out(p, attn2, cfg)
            x = x + L.gelu_mlp(blk["mlp"], _ln(x, blk["ln3"], cfg.norm_eps))
        x = _ln(x, self.dec_ln_f, cfg.norm_eps)
        return L.lm_logits(self.embed, x, cfg)[:, 0], cache


def cache_shape(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """{name: (shape, dtype)}: self and cross KV per decoder layer, and the
    cross cache's valid length."""
    kv = ((cfg.num_layers, batch, cfg.num_kv_heads, seq, cfg.resolved_head_dim),
          L.cdtype(cfg))
    return {"k": kv, "v": kv, "cross_k": kv, "cross_v": kv, "cross_len": ((), torch.int32)}


def cache_specs(cfg: ModelConfig) -> dict:
    kv = P("layers", "batch", "kv_heads", "cache_seq", None)
    return {"k": kv, "v": kv, "cross_k": kv, "cross_v": kv, "cross_len": P()}


def init_cache(cfg: ModelConfig, batch: int, seq: int, device="cuda") -> dict:
    return L.zero_cache(cache_shape(cfg, batch, seq), device)
