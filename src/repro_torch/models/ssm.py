"""Mamba2 (SSD) blocks: the chunked state-space duality scan and its O(1)
decode step.

The reference's ``repro/models/ssm.py``, ported.  Within a chunk the
recurrence is decay-masked attention; between chunks a Python loop carries
the (B, H, P, N) float32 state (the reference's ``lax.scan``).  Decode is
the recurrent step, which updates the SSM and conv states in place.

Shapes: d_inner = expand * d_model, H = d_inner / head_dim (P = head_dim),
N = ssm_state.  One B/C group, broadcast over heads (Mamba2's n_groups=1).

Held dtypes: the projections, ``conv_w`` and ``conv_b`` in ``cfg.dtype``
(the ops read them there); ``ln``, ``norm``, ``a_log``, ``dt_bias`` and
``d_skip`` in float32 (``d_skip`` is read in ``cfg.dtype`` by the block and
in float32 by the decode step, as in the reference).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding.rules import P


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, heads, cfg.ssm_head_dim, cfg.ssm_state, conv_dim


def mamba_shapes(cfg: ModelConfig) -> dict:
    di, h, _, n, conv_dim = dims(cfg)
    dt, f32 = L.cdtype(cfg), torch.float32
    return {"ln": ((cfg.d_model,), f32),
            "in_proj": ((cfg.d_model, 2 * di + 2 * n + h), dt),   # z, x, B, C, dt
            "conv_w": ((conv_dim, cfg.ssm_conv), dt),
            "conv_b": ((conv_dim,), dt),
            "a_log": ((h,), f32),
            "d_skip": ((h,), f32),
            "dt_bias": ((h,), f32),
            "norm": ((di,), f32),
            "out_proj": ((di, cfg.d_model), dt)}


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One layer's float32 draws (the reference's ``init_mamba`` per layer)."""
    shapes = mamba_shapes(cfg)
    h = shapes["a_log"][0]
    dev = gen.device
    return {"ln": L.zeros_init(gen, shapes["ln"][0]),
            "in_proj": L.dense_init(gen, shapes["in_proj"][0]),
            "conv_w": L.dense_init(gen, shapes["conv_w"][0], in_axis=1),
            "conv_b": L.zeros_init(gen, shapes["conv_b"][0]),
            "a_log": L.zeros_init(gen, h),                       # A = -exp(a_log) = -1
            "d_skip": torch.ones(h, device=dev),
            "dt_bias": torch.full(h, -2.0, device=dev),          # softplus ~ 0.12
            "norm": L.zeros_init(gen, shapes["norm"][0]),
            "out_proj": L.dense_init(gen, shapes["out_proj"][0])}


def mamba_specs(cfg: ModelConfig, layers: bool = True) -> dict:
    lead = ("layers",) if layers else ()
    return {
        "ln": P(*lead, "embed"),
        "in_proj": P(*lead, "embed_fsdp", "conv_dim"),
        "conv_w": P(*lead, "conv_dim", None),
        "conv_b": P(*lead, "conv_dim"),
        "a_log": P(*lead, "ssm_heads"),
        "d_skip": P(*lead, "ssm_heads"),
        "dt_bias": P(*lead, "ssm_heads"),
        "norm": P(*lead, "conv_dim"),
        "out_proj": P(*lead, "conv_dim", "embed_fsdp"),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv; x (B, S, C), w (C, K): K shifted adds, in the
    reference's order."""
    k, s = w.shape[-1], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    y = 0
    for i in range(k):
        y = y + pad[:, i:i + s, :] * w[:, k - 1 - i]
    return y + b


def conv_step(conv_state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """The causal conv at one new position: [oldest ... current] (B, K, C)
    against the taps in lag order (``w[:, ::-1]`` in the reference: torch has
    no negative strides, so ``flip``).  Shifts ``conv_state`` (B, K-1, C) in
    place; returns (B, C)."""
    full = torch.cat([conv_state, x_t], dim=1)
    out = torch.einsum("bkc,ck->bc", full, w.flip(-1)) + b
    conv_state.copy_(full[:, 1:])
    return out


def split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, _, _, n, _ = dims(cfg)
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n:]


def gated_out(blk, y_flat: torch.Tensor, z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    y = L.rms_norm(y_flat * F.silu(z.float()).to(y_flat.dtype), blk["norm"], cfg.norm_eps)
    return y @ blk["out_proj"]


def chunk_len(cfg: ModelConfig, s: int) -> int:
    """The scan's chunk: ``ssm_chunk``, or the whole sequence when it does
    not divide it (the reference's fallback)."""
    q = min(cfg.ssm_chunk, s)
    return s if s % q else q


def mamba_block(blk, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 block (training / prefill).  x: (B, S, D)."""
    b, s, _ = x.shape
    di, h, p_dim, n, _ = dims(cfg)
    q_chunk = chunk_len(cfg, s)

    hidden = L.rms_norm(x, blk["ln"], cfg.norm_eps)
    z, xbc, dt_raw = split_proj(hidden @ blk["in_proj"], cfg)
    xbc = F.silu(causal_conv(xbc, blk["conv_w"], blk["conv_b"]).float()).to(x.dtype)
    xh = xbc[..., :di].reshape(b, s, h, p_dim)
    b_mat, c_mat = xbc[..., di:di + n].float(), xbc[..., di + n:].float()
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x itself above
    # 20, where the two differ by under 1e-8.
    dt = F.softplus(dt_raw.float() + blk["dt_bias"])                   # (B,S,H)
    da = dt * -torch.exp(blk["a_log"])                                  # (B,S,H)

    causal = torch.tril(torch.ones(q_chunk, q_chunk, dtype=torch.bool, device=x.device))
    causal = causal[None, :, :, None]
    state = torch.zeros((b, h, p_dim, n), dtype=torch.float32, device=x.device)
    ys = []
    for start in range(0, s, q_chunk):
        at = slice(start, start + q_chunk)
        xh_c, b_c, c_c, dt_c = xh[:, at], b_mat[:, at], c_mat[:, at], dt[:, at]
        cum = torch.cumsum(da[:, at], dim=1)                            # (B,Q,H)
        # Intra-chunk decay-masked attention in float32.  Above the diagonal
        # the decay overflows to inf; the mask after it selects 0 there.
        decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])     # (B,Q,T,H)
        cb = torch.einsum("bqn,btn->bqt", c_c, b_c)
        scores = torch.where(causal, cb[..., None] * decay * dt_c[:, None], 0.0)
        y_intra = torch.einsum("bqth,bthp->bqhp", scores.to(x.dtype), xh_c)
        # The carried state's contribution.
        y_inter = torch.einsum("bqn,bhpn->bqhp", c_c, state) * torch.exp(cum)[..., None]
        w_end = torch.exp(cum[:, -1:, :] - cum) * dt_c                  # (B,Q,H)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + torch.einsum(
            "btn,bthp->bhpn", b_c, xh_c.float() * w_end[..., None])
        ys.append((y_intra.float() + y_inter).to(x.dtype))
    y = torch.cat(ys, dim=1)
    y = y + blk["d_skip"].to(x.dtype)[None, None, :, None] * xh
    return x + gated_out(blk, y.reshape(b, s, di), z, cfg)


# ---------------------------------------------------------------------------
# O(1) decode step
# ---------------------------------------------------------------------------

def mamba_cache_shape(cfg: ModelConfig, layers: int, batch: int) -> dict:
    _, h, p_dim, n, conv_dim = dims(cfg)
    return {"ssm": ((layers, batch, h, p_dim, n), torch.float32),
            "conv": ((layers, batch, cfg.ssm_conv - 1, conv_dim), L.cdtype(cfg))}


def mamba_cache_specs() -> dict:
    return {
        "ssm": P("layers", "batch", "ssm_heads", None, None),
        "conv": P("layers", "batch", None, "conv_dim"),
    }


def mamba_decode_block(blk, x: torch.Tensor, ssm_state: torch.Tensor,
                       conv_state: torch.Tensor, cfg: ModelConfig):
    """One token.  x (B, 1, D); ``ssm_state`` (B, H, P, N) float32 and
    ``conv_state`` (B, K-1, conv_dim) are updated in place.  Returns
    (out, ssm_state, conv_state)."""
    b = x.shape[0]
    di, h, p_dim, n, _ = dims(cfg)
    hidden = L.rms_norm(x, blk["ln"], cfg.norm_eps)
    z, xbc, dt_raw = split_proj(hidden @ blk["in_proj"], cfg)
    conv = conv_step(conv_state, xbc, blk["conv_w"], blk["conv_b"])
    xbc_t = F.silu(conv.float()).to(x.dtype)
    xh = xbc_t[:, :di].reshape(b, h, p_dim).float()
    b_vec, c_vec = xbc_t[:, di:di + n].float(), xbc_t[:, di + n:].float()
    dt = F.softplus(dt_raw[:, 0].float() + blk["dt_bias"])              # (B,H)
    da = torch.exp(dt * -torch.exp(blk["a_log"]))
    ssm_state.mul_(da[:, :, None, None]).addcmul_(
        (xh * dt[..., None])[..., None], b_vec[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", c_vec, ssm_state)
    y = y + blk["d_skip"][None, :, None] * xh
    out = x + gated_out(blk, y.reshape(b, 1, di).to(x.dtype), z, cfg)
    return out, ssm_state, conv_state
