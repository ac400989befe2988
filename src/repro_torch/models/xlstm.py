"""xLSTM blocks: the chunkwise-parallel mLSTM (matrix memory, exponential
gating, max-stabilised) and the recurrent sLSTM (scalar memory).

The reference's ``repro/models/xlstm.py``, ported.  The mLSTM's chunked
scan is a Python loop over chunks carrying (C, n, m); the sLSTM is a Python
loop over time (the reference's ``lax.scan``).  The decode blocks update
their states in place.

Held dtypes: the projections (``up``, ``wq``/``wk``/``wv``, ``w_i``/``w_f``,
``w_in``, ``down``), ``conv_w``, ``conv_b`` and the sLSTM's ``b`` in
``cfg.dtype`` (the ops read them there); ``ln``, ``norm``, the mLSTM's gate
biases and the sLSTM's recurrent ``r`` (read against its float32 state) in
float32.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.ssm import causal_conv, chunk_len, conv_step
from repro_torch.sharding.rules import P

MIN_LOG = -30.0


def dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    di = cfg.ssm_expand * cfg.d_model
    h = cfg.num_heads
    return di, h, di // h


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, h, _ = dims(cfg)
    dt, f32 = L.cdtype(cfg), torch.float32
    return {"ln": ((d,), f32), "up": ((d, 2 * di), dt),
            "conv_w": ((di, cfg.ssm_conv), dt), "conv_b": ((di,), dt),
            "wq": ((di, di), dt), "wk": ((di, di), dt), "wv": ((di, di), dt),
            "w_i": ((di, h), dt), "b_i": ((h,), f32),
            "w_f": ((di, h), dt), "b_f": ((h,), f32),
            "norm": ((di,), f32), "down": ((di, d), dt)}


def init_mlstm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One layer's float32 draws (the reference's ``init_mlstm`` per layer)."""
    s = {name: shape for name, (shape, _) in mlstm_shapes(cfg).items()}
    dev = gen.device
    p = {name: L.dense_init(gen, s[name])
         for name in ("up", "wq", "wk", "wv", "w_i", "w_f", "down")}
    p["conv_w"] = L.dense_init(gen, s["conv_w"], in_axis=1)
    p.update(ln=L.zeros_init(gen, s["ln"]), conv_b=L.zeros_init(gen, s["conv_b"]),
             norm=L.zeros_init(gen, s["norm"]),
             b_i=torch.full(s["b_i"], -3.0, device=dev),
             b_f=torch.full(s["b_f"], 3.0, device=dev))      # open forget gate
    return p


def mlstm_specs(lead: Tuple[str, ...]) -> dict:
    return {
        "ln": P(*lead, "embed"),
        "up": P(*lead, "embed_fsdp", "conv_dim"),
        "conv_w": P(*lead, "conv_dim", None),
        "conv_b": P(*lead, "conv_dim"),
        "wq": P(*lead, "embed_fsdp", "conv_dim"),
        "wk": P(*lead, "embed_fsdp", "conv_dim"),
        "wv": P(*lead, "embed_fsdp", "conv_dim"),
        "w_i": P(*lead, "conv_dim", "ssm_heads"),
        "b_i": P(*lead, "ssm_heads"),
        "w_f": P(*lead, "conv_dim", "ssm_heads"),
        "b_f": P(*lead, "ssm_heads"),
        "norm": P(*lead, "conv_dim"),
        "down": P(*lead, "conv_dim", "embed_fsdp"),
    }


def _gates(blk, xm: torch.Tensor):
    """Input-gate log and log forget gate, float32 (B, S, H)."""
    i_log = (xm @ blk["w_i"]).float() + blk["b_i"]
    logf = F.logsigmoid((xm @ blk["w_f"]).float() + blk["b_f"])
    return i_log, logf


def _mlstm_inputs(blk, x: torch.Tensor, cfg: ModelConfig):
    """Shared projections: q, k, v (B, S, H, dh), gate logs (B, S, H), z."""
    b, s, _ = x.shape
    di, h, dh = dims(cfg)
    up = L.rms_norm(x, blk["ln"], cfg.norm_eps) @ blk["up"]
    xm, z = up[..., :di], up[..., di:]
    xc = F.silu(causal_conv(xm, blk["conv_w"], blk["conv_b"]).float()).to(x.dtype)
    q = (xc @ blk["wq"]).reshape(b, s, h, dh) / _sqrt(dh, x.dtype)
    k = (xc @ blk["wk"]).reshape(b, s, h, dh)
    v = (xm @ blk["wv"]).reshape(b, s, h, dh)
    return (q, k, v) + _gates(blk, xm) + (z,)


def _sqrt(n: int, dtype) -> torch.Tensor:
    """sqrt(n) rounded to ``dtype`` (the reference divides by it in that dtype)."""
    return torch.tensor(math.sqrt(n), dtype=torch.float32).to(dtype)


def _mlstm_out(blk, h_seq: torch.Tensor, z: torch.Tensor, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    b, s = x.shape[:2]
    flat = h_seq.reshape(b, s, -1).to(x.dtype)
    y = L.rms_norm(flat, blk["norm"], cfg.norm_eps)
    y = y * F.silu(z.float()).to(x.dtype)
    return x + y @ blk["down"]


def mlstm_block(blk, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence chunkwise mLSTM block.  x: (B, S, D)."""
    b, s, _ = x.shape
    _, h, dh = dims(cfg)
    q, k, v, i_log, logf, z = _mlstm_inputs(blk, x, cfg)
    q, k, v = q.float(), k.float(), v.float()
    q_chunk = chunk_len(cfg, s)
    causal = torch.tril(torch.ones(q_chunk, q_chunk, dtype=torch.bool, device=x.device))
    causal = causal[None, :, :, None]
    c_in = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
    n_in = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
    m_in = torch.full((b, h), MIN_LOG, dtype=torch.float32, device=x.device)
    outs = []
    for start in range(0, s, q_chunk):
        at = slice(start, start + q_chunk)
        qc, kc, vc, ic = q[:, at], k[:, at], v[:, at], i_log[:, at]
        fq = torch.cumsum(logf[:, at], dim=1)             # (B,Q,H) inclusive log-decay
        f_total = fq[:, -1]                               # (B,H)
        b_t = f_total[:, None] - fq + ic                  # keys' log-weights at chunk end
        a_q = fq + m_in[:, None]                          # the state's decay at queries
        # Intra-chunk pair decays d_qt = F_q - F_t + i_t (t <= q).
        d_qt = fq[:, :, None, :] - fq[:, None, :, :] + ic[:, None, :, :]
        d_qt = torch.where(causal, d_qt, MIN_LOG)
        m_q = torch.maximum(a_q, d_qt.amax(dim=2))        # (B,Q,H)
        w_qt = torch.exp(d_qt - m_q[:, :, None, :])       # (B,Q,T,H)
        kq = torch.einsum("bqhn,bthn->bqth", qc, kc)
        num = torch.einsum("bqth,bthp->bqhp", w_qt * kq, vc)
        den = torch.einsum("bqth,bqth->bqh", w_qt, kq)
        # The carried state's contribution.
        w_state = torch.exp(a_q - m_q)
        num = num + w_state[..., None] * torch.einsum("bhnp,bqhn->bqhp", c_in, qc)
        den = den + w_state * torch.einsum("bhn,bqhn->bqh", n_in, qc)
        outs.append(num / torch.maximum(den.abs(), torch.exp(-m_q))[..., None])
        # The carry, stabilised.
        m_next = torch.maximum(f_total + m_in, b_t.amax(dim=1))
        w_keys = torch.exp(b_t - m_next[:, None])         # (B,Q,H)
        scale = torch.exp(f_total + m_in - m_next)        # (B,H)
        c_in = scale[:, :, None, None] * c_in + torch.einsum(
            "bthn,bthp->bhnp", kc * w_keys[..., None], vc)
        n_in = scale[:, :, None] * n_in + torch.einsum("bthn,bth->bhn", kc, w_keys)
        m_in = m_next
    return _mlstm_out(blk, torch.cat(outs, dim=1), z, x, cfg)


def mlstm_decode_block(blk, x: torch.Tensor, c_in: torch.Tensor, n_in: torch.Tensor,
                       m_in: torch.Tensor, conv_state: torch.Tensor, cfg: ModelConfig):
    """One token.  x (B, 1, D); the states C (B, H, dh, dh), n (B, H, dh),
    m (B, H) and ``conv_state`` (B, K-1, di) are updated in place.  Returns
    (out, C, n, m, conv_state)."""
    b = x.shape[0]
    di, h, dh = dims(cfg)
    up = L.rms_norm(x, blk["ln"], cfg.norm_eps) @ blk["up"]
    xm, z = up[..., :di], up[..., di:]
    xc = conv_step(conv_state, xm, blk["conv_w"], blk["conv_b"])
    xc = F.silu(xc.float()).to(x.dtype)[:, None]
    q = ((xc @ blk["wq"]).reshape(b, h, dh) / _sqrt(dh, x.dtype)).float()
    k = (xc @ blk["wk"]).reshape(b, h, dh).float()
    v = (xm @ blk["wv"]).reshape(b, h, dh).float()
    i_log, logf = (g[:, 0] for g in _gates(blk, xm))
    m_next = torch.maximum(logf + m_in, i_log)
    f_w = torch.exp(logf + m_in - m_next)
    i_w = torch.exp(i_log - m_next)
    c_in.mul_(f_w[:, :, None, None]).addcmul_((i_w[..., None] * k)[..., None],
                                              v[:, :, None, :])
    n_in.mul_(f_w[:, :, None]).add_(i_w[:, :, None] * k)
    m_in.copy_(m_next)
    num = torch.einsum("bhnp,bhn->bhp", c_in, q)
    den = torch.einsum("bhn,bhn->bh", n_in, q)
    h_t = num / torch.maximum(den.abs(), torch.exp(-m_in))[..., None]
    return _mlstm_out(blk, h_t[:, None], z, x, cfg), c_in, n_in, m_in, conv_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, h, dh = dims(cfg)
    dt, f32 = L.cdtype(cfg), torch.float32
    return {"ln": ((d,), f32), "w_in": ((d, 4 * di), dt), "r": ((h, dh, 4 * dh), f32),
            "b": ((4 * di,), dt), "norm": ((di,), f32), "down": ((di, d), dt)}


def init_slstm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One layer's float32 draws (the reference's ``init_slstm`` per layer)."""
    s = {name: shape for name, (shape, _) in slstm_shapes(cfg).items()}
    di = s["norm"][0]
    dev = gen.device
    return {"ln": L.zeros_init(gen, s["ln"]),
            "w_in": L.dense_init(gen, s["w_in"]),
            "r": L.dense_init(gen, s["r"], in_axis=1).mul_(0.1),
            "b": torch.cat([torch.full((di,), -3.0, device=dev),     # i
                            torch.full((di,), 3.0, device=dev),      # f
                            torch.zeros(2 * di, device=dev)]),       # z, o
            "norm": L.zeros_init(gen, s["norm"]),
            "down": L.dense_init(gen, s["down"])}


def slstm_specs(lead: Tuple[str, ...]) -> dict:
    return {
        "ln": P(*lead, "embed"),
        "w_in": P(*lead, "embed_fsdp", "conv_dim"),
        "r": P(*lead, "ssm_heads", None, None),
        "b": P(*lead, "conv_dim"),
        "norm": P(*lead, "conv_dim"),
        "down": P(*lead, "conv_dim", "embed_fsdp"),
    }


def _slstm_cell(blk, wx_t: torch.Tensor, state, cfg: ModelConfig):
    """One recurrence step.  wx_t (B, 4*di); state (c, n, h, m), each (B, di)
    float32.  Returns the new state."""
    di, h, dh = dims(cfg)
    c, n, hid, m = state
    b_sz = wx_t.shape[0]
    rec = torch.einsum("bhd,hde->bhe", hid.reshape(b_sz, h, dh), blk["r"])
    raw = (wx_t + rec.reshape(b_sz, 4 * di) + blk["b"]).float()
    i_r, f_r, z_r, o_r = torch.split(raw, di, dim=-1)
    logf = F.logsigmoid(f_r)
    m_next = torch.maximum(logf + m, i_r)
    i_w = torch.exp(i_r - m_next)
    f_w = torch.exp(logf + m - m_next)
    c_next = f_w * c + i_w * torch.tanh(z_r)
    n_next = f_w * n + i_w
    h_next = torch.sigmoid(o_r) * c_next / torch.clamp(n_next, min=1e-6)
    return c_next, n_next, h_next, m_next


def slstm_state(cfg: ModelConfig, batch: int, device) -> tuple:
    """The zero state (c, n, h, m), m at ``MIN_LOG``."""
    di = dims(cfg)[0]
    zeros = [torch.zeros((batch, di), dtype=torch.float32, device=device) for _ in range(3)]
    return (*zeros, torch.full((batch, di), MIN_LOG, dtype=torch.float32, device=device))


def slstm_block(blk, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Recurrent sLSTM block over the full sequence (a loop over time)."""
    b, s, _ = x.shape
    wx = L.rms_norm(x, blk["ln"], cfg.norm_eps) @ blk["w_in"]
    state = slstm_state(cfg, b, x.device)
    hs = []
    for t in range(s):
        state = _slstm_cell(blk, wx[:, t], state, cfg)
        hs.append(state[2])
    y = L.rms_norm(torch.stack(hs, dim=1).to(x.dtype), blk["norm"], cfg.norm_eps)
    return x + y @ blk["down"]


def slstm_decode_block(blk, x: torch.Tensor, state, cfg: ModelConfig):
    """One token.  x (B, 1, D); ``state`` (c, n, h, m) is updated in place.
    Returns (out, state)."""
    wx = (L.rms_norm(x, blk["ln"], cfg.norm_eps) @ blk["w_in"])[:, 0]
    new = _slstm_cell(blk, wx, state, cfg)
    for buf, value in zip(state, new):
        buf.copy_(value)
    y = L.rms_norm(state[2][:, None].to(x.dtype), blk["norm"], cfg.norm_eps)
    return x + y @ blk["down"], state
