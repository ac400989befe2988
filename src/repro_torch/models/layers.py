"""Shared neural-net layers: norms, RoPE, GQA attention, MLPs, embeddings.

The reference's ``repro/models/layers.py``, ported.

Conventions
-----------
* A layer's params are read as ``p["name"]``: a dict of tensors, or a
  ``ParamGroup`` (an ``nn.Module`` that reads the same way).  Each weight is
  held once, in the dtype the op reads it in: ``cfg.dtype`` for the
  projections, biases and embeddings, float32 for the norm weights.  The
  reference keeps float32 masters and casts them at every einsum; the
  numbers are the same.
* Norms, softmax and losses accumulate in float32; attention scores are
  float32 products of the compute-dtype operands (the reference's
  ``preferred_element_type=float32``).
* Masked scores are ``NEG_INF = -1e30``, not ``-inf``, as in the reference.
* The initializers draw from an explicit ``torch.Generator`` on its device.
* Gradients: the training paths (each family's ``forward`` / ``loss_fn``)
  record autograd whenever it is on; ``remat`` and the per-q-chunk
  checkpoint of ``blockwise_attention`` recompute in the backward pass
  what the reference's ``jax.checkpoint`` does.  Serving (``prefill``,
  ``decode_step``) runs under ``torch.no_grad``.
* The ``*_specs`` functions give each weight's logical axis names as the
  reference's do (``sharding.rules.P`` tuples, a leading ``"layers"`` on a
  stacked subtree); ``constrain`` checks an activation's logical dims where
  the reference places it.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.rules import P, constrain

NEG_INF = -1e30


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class ParamGroup(nn.Module):
    """Named tensors (and sub-groups) of one layer, read as ``p["name"]``
    like the reference's param dicts.  Built with ``requires_grad=False``,
    so serving records no autograd; a trainer turns gradients on
    (``repro_torch.train.optimizer``)."""

    def __init__(self, shapes: dict, device):
        """``shapes`` maps a name to ``(shape, dtype)`` or to a nested dict."""
        super().__init__()
        for name, spec in shapes.items():
            if isinstance(spec, dict):
                self.add_module(name, ParamGroup(spec, device))
            else:
                shape, dtype = spec
                self.register_parameter(name, nn.Parameter(
                    torch.empty(shape, dtype=dtype, device=device), requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


def load_tree(group: nn.Module, tree: dict) -> None:
    """Copy a nested dict of tensors into a group, each cast to its held dtype."""
    for name, value in tree.items():
        if isinstance(value, dict):
            load_tree(group[name], value)
        else:
            group[name].copy_(value)


class LanguageModel(nn.Module):
    """What every family's model shares: its device and the source of the
    approximate head.  Each family's model holds its own forward, prefill
    and decode paths.

    ``head_source`` is the float32 ``embed.tok[:vocab_size]`` on the host that
    an ``ApproxTopKHead`` is built from, as the reference builds its head from
    its float32 params.  The model holds ``tok`` in ``cfg.dtype``, so at
    bfloat16 the held values are already rounded, and rounding moves which
    entries ``sparsify_topm`` keeps.  ``init_params`` and
    ``convert.params_from_reference`` keep their float32 ``tok`` here; it is
    not part of the state dict.
    """

    head_source: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    def init_embed(self, gen: torch.Generator) -> None:
        """Draw ``embed`` from ``gen`` and keep the float32 ``tok`` draw."""
        emb = init_embedding(gen, self.cfg)
        self.keep_head_source(emb["tok"])
        load_tree(self.embed, emb)

    def keep_head_source(self, tok: torch.Tensor) -> None:
        """Keep the float32 rows of ``tok`` (a draw or the reference's) on the host."""
        self.head_source = tok[: self.cfg.vocab_size].detach().to("cpu", torch.float32)

    def head_embedding(self) -> np.ndarray:
        """(vocab_size, d_model) float32 rows for the approximate head: the
        kept ``head_source``.  A model filled by ``load_state_dict`` alone
        has none (its state dict holds ``tok`` in ``cfg.dtype``) and raises
        until ``keep_head_source`` is called."""
        if self.head_source is None:
            raise ValueError("no float32 embed.tok kept: build the model with init_params or "
                             "params_from_reference, or call keep_head_source")
        return self.head_source.numpy()


def _keep_dots():
    """Selective checkpoint that keeps the outputs of products without batch
    dimensions (``x @ W``: ``aten.mm``), the reference's
    ``checkpoint_dots_with_no_batch_dims``; the rest is recomputed."""
    return create_selective_checkpoint_contexts([torch.ops.aten.mm.default])


def remat(fn, cfg: ModelConfig, dots: bool = False):
    """``fn`` under the reference's ``cfg.remat``: ``"none"`` keeps every
    activation for the backward pass, ``"full"`` keeps only ``fn``'s inputs
    and recomputes the rest (``torch.utils.checkpoint``), ``"dots"`` keeps the
    ``x @ W`` products too where the family honours it (``dots=True``; the
    reference's other families treat it as ``"full"``).  With autograd off
    (serving) ``fn`` runs as it is.  Recomputation repeats the same ops, so
    gradients are the same bits under every mode."""
    if cfg.remat == "none":
        return fn
    kw = {"context_fn": _keep_dots} if dots and cfg.remat == "dots" else {}

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def zero_cache(shapes: dict, device) -> dict:
    """Zero tensors for a ``{name: (shape, dtype)}`` cache description."""
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in shapes.items()}


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_axis: int = 0) -> torch.Tensor:
    """LeCun-normal fp32 init (fan-in over ``in_axis``)."""
    fan_in = shape[in_axis]
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return x.div_(math.sqrt(max(fan_in, 1)))


def embed_init(gen: torch.Generator, shape) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return x.mul_(0.02)


def zeros_init(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=gen.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layer_norm(x, w, b, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: (..., S).  The two halves of
    each head rotate together (not interleaved), in float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                      # (d/2,)
    angles = positions[..., None].float() * freqs               # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1f, x2f = x[..., : d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, grouped products: KV is never materialized per q-head)
# ---------------------------------------------------------------------------

def attention_shapes(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, g, dt = cfg.num_heads, cfg.num_kv_heads, cdtype(cfg)
    s = {"wq": ((d, h * hd), dt), "wk": ((d, g * hd), dt), "wv": ((d, g * hd), dt),
         "wo": ((h * hd, d), dt)}
    if cfg.qkv_bias:
        s.update(bq=((h * hd,), dt), bk=((g * hd,), dt), bv=((g * hd,), dt))
    return s


def attention_specs(cfg: ModelConfig, layers: bool) -> dict:
    lead = ("layers",) if layers else ()
    s = {
        "wq": P(*lead, "embed_fsdp", "heads"),
        "wk": P(*lead, "embed_fsdp", "kv_heads"),
        "wv": P(*lead, "embed_fsdp", "kv_heads"),
        "wo": P(*lead, "heads", "embed_fsdp"),
    }
    if cfg.qkv_bias:
        s["bq"] = P(*lead, "heads")
        s["bk"] = P(*lead, "kv_heads")
        s["bv"] = P(*lead, "kv_heads")
    return s


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    shapes = attention_shapes(cfg)
    p = {name: dense_init(gen, shapes[name][0]) for name in ("wq", "wk", "wv", "wo")}
    if cfg.qkv_bias:
        p.update({name: zeros_init(gen, shapes[name][0]) for name in ("bq", "bk", "bv")})
    return p


def qkv_project(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """x: (B,S,D) -> q (B,S,H,hd), k/v (B,S,G,hd), RoPE applied."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, cfg.num_heads, hd)
    k = k.reshape(b, s, cfg.num_kv_heads, hd)
    v = v.reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.rope_theta > 0:  # rope_theta == 0: absolute-position models (whisper)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def blockwise_attention(
    q: torch.Tensor,            # (B, S, H, hd)
    k: torch.Tensor,            # (B, Sk, G, hd)
    v: torch.Tensor,            # (B, Sk, G, hd)
    *,
    causal: bool,
    q_offset: int = 0,
    sliding_window: int = 0,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Q-chunked masked attention; peak memory O(q_chunk * Sk) per (b, head).

    Returns (B, S, H, hd).  ``q_offset`` is the absolute position of q[0].
    Each row's softmax is whole, so the chunking does not change the numbers.
    """
    b, s, h, hd = q.shape
    sk, g = k.shape[1], k.shape[2]
    qg = h // g
    scale = 1.0 / math.sqrt(hd)
    q = q.reshape(b, s, g, qg, hd)
    q_chunk = min(q_chunk, s)
    if s % q_chunk != 0:  # fall back to one chunk for ragged sizes
        q_chunk = s
    kpos = torch.arange(sk, device=q.device)
    kf = k.float()

    def one_chunk(qc, kf, v, start: int):
        scores = torch.einsum("bsgqd,btgd->bgqst", qc.float(), kf) * scale
        qpos = q_offset + start + torch.arange(q_chunk, device=q.device)
        mask = torch.ones((q_chunk, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if sliding_window > 0:
            mask &= kpos[None, :] > qpos[:, None] - sliding_window
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bgqst,btgd->bsgqd", probs, v)         # (B,qc,G,Qg,hd)

    # Under autograd each chunk keeps only its inputs and recomputes its
    # scores and probs in the backward pass, as the reference's
    # ``jax.checkpoint`` does (O(S^2) memory otherwise).
    if torch.is_grad_enabled():
        chunk = functools.partial(checkpoint, one_chunk, use_reentrant=False)
    else:
        chunk = one_chunk
    outs = [chunk(q[:, start:start + q_chunk], kf, v, start) for start in range(0, s, q_chunk)]
    return torch.cat(outs, dim=1).reshape(b, s, h, hd)


def decode_attention(
    q: torch.Tensor,            # (B, 1, H, hd)
    k_cache: torch.Tensor,      # (B, G, S, hd): heads-major cache layout
    v_cache: torch.Tensor,
    valid_len: int,
) -> torch.Tensor:
    b, _, h, hd = q.shape
    g = k_cache.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, g, h // g, hd)
    scores = torch.einsum("bgqd,bgtd->bgqt", qg.float(), k_cache.float()) * scale
    mask = torch.arange(k_cache.shape[2], device=q.device) < valid_len
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bgqt,bgtd->bgqd", probs, v_cache)
    return out.reshape(b, 1, h, hd)


def cache_insert(cache: torch.Tensor, kv: torch.Tensor, slot: int) -> torch.Tensor:
    """Write (B, 1, G, hd) projections at ``slot`` of a (B, G, S, hd) cache, in place."""
    cache[:, :, slot] = kv[:, 0].to(cache.dtype)
    return cache


def cache_insert_quant(cache: torch.Tensor, scale: torch.Tensor, kv: torch.Tensor,
                       slot: int):
    """int8 KV-cache insert with one fp scale per (b, head, position) vector
    (the paper's Q-format fixed point, applied to decode HBM traffic), in place.

    cache (B,G,S,hd) int8, scale (B,G,S) f32, kv (B,1,G,hd).  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    kv = kv[:, 0].float()                              # (B, G, hd)
    amax = torch.amax(torch.abs(kv), dim=-1)           # (B, G)
    s = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(kv / s[..., None]), -127, 127).to(torch.int8)
    cache[:, :, slot] = q
    scale[:, :, slot] = s.to(scale.dtype)
    return cache, scale


def cache_dequant(cache: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """(B,G,S,hd) int8 x (B,G,S) scales -> dtype."""
    return (cache.float() * scale[..., None]).to(dtype)


def attention_out(p, attn: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s = attn.shape[:2]
    flat = attn.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim)
    return flat @ p["wo"]


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_shapes(d: int, ff: int, dtype, gated: bool = True) -> dict:
    if gated:
        return {"w_gate": ((d, ff), dtype), "w_up": ((d, ff), dtype),
                "w_down": ((ff, d), dtype)}
    return {"w1": ((d, ff), dtype), "b1": ((ff,), dtype), "w2": ((ff, d), dtype),
            "b2": ((d,), dtype)}


def mlp_specs(layers: bool, gated=True) -> dict:
    lead = ("layers",) if layers else ()
    if gated:
        return {
            "w_gate": P(*lead, "embed_fsdp", "mlp"),
            "w_up": P(*lead, "embed_fsdp", "mlp"),
            "w_down": P(*lead, "mlp", "embed_fsdp"),
        }
    return {
        "w1": P(*lead, "embed_fsdp", "mlp"),
        "b1": P(*lead, "mlp"),
        "w2": P(*lead, "mlp", "embed_fsdp"),
        "b2": P(*lead, "embed_fsdp"),
    }


def init_mlp(gen: torch.Generator, d: int, ff: int, gated: bool = True) -> dict:
    if gated:
        return {"w_gate": dense_init(gen, (d, ff)), "w_up": dense_init(gen, (d, ff)),
                "w_down": dense_init(gen, (ff, d))}
    return {"w1": dense_init(gen, (d, ff)), "b1": zeros_init(gen, (ff,)),
            "w2": dense_init(gen, (ff, d)), "b2": zeros_init(gen, (d,))}


def gated_mlp(p, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    act = (F.silu(gate.float()) * up.float()).to(dt)
    return act @ p["w_down"]


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["w1"] + p["b1"]
    h = F.gelu(h.float(), approximate="tanh").to(dt)   # jax.nn.gelu's default
    return h @ p["w2"] + p["b2"]


# ---------------------------------------------------------------------------
# Embedding / LM head / loss
# ---------------------------------------------------------------------------

def embedding_shapes(cfg: ModelConfig) -> dict:
    dt = cdtype(cfg)
    s = {"tok": ((cfg.padded_vocab, cfg.d_model), dt)}
    if not cfg.tie_embeddings:
        s["out"] = ((cfg.d_model, cfg.padded_vocab), dt)
    return s


def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> dict:
    p = {"tok": embed_init(gen, (cfg.padded_vocab, cfg.d_model))}
    if not cfg.tie_embeddings:
        p["out"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab))
    return p


def embedding_specs(cfg: ModelConfig) -> dict:
    s = {"tok": P("vocab", "embed_fsdp")}
    if not cfg.tie_embeddings:
        s["out"] = P("embed_fsdp", "vocab")
    return s


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = p["tok"][tokens.long()].to(cdtype(cfg))
    return constrain(x, ("batch", "seq", "embed"))


def lm_logits(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(..., D) hidden states -> (..., padded_vocab) logits, the padding ids
    masked to ``NEG_INF``."""
    if cfg.tie_embeddings:
        logits = x @ p["tok"].to(x.dtype).T
    else:
        logits = x @ p["out"].to(x.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, NEG_INF)
    return constrain(logits, ("batch", "seq", "vocab"))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
