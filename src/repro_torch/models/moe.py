"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

The reference's ``repro/models/moe.py``, ported.
GShard/Switch-style: tokens are routed to their top-k experts, dispatched by
scatter into per-expert capacity buffers ``(E, cap, D)`` (so the products
cover the active experts only), run through batched expert FFNs, and
combined with the renormalized router weights.  The router's softmax runs
in float32; its top-k takes the lower expert id first on ties, as
``jax.lax.top_k`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding.rules import P, constrain


def moe_shapes(cfg: ModelConfig) -> dict:
    d, ff, e, dt = cfg.d_model, cfg.d_ff, cfg.num_experts, L.cdtype(cfg)
    return {"router": ((d, e), dt), "w_gate": ((e, d, ff), dt), "w_up": ((e, d, ff), dt),
            "w_down": ((e, ff, d), dt)}


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {name: L.dense_init(gen, shape, in_axis=0 if name == "router" else 1)
            for name, (shape, _) in moe_shapes(cfg).items()}


def moe_specs(cfg: ModelConfig, layers: bool) -> dict:
    lead = ("layers",) if layers else ()
    return {
        "router": P(*lead, "embed", None),
        "w_gate": P(*lead, "experts", "embed_fsdp", "expert_mlp"),
        "w_up": P(*lead, "experts", "embed_fsdp", "expert_mlp"),
        "w_down": P(*lead, "experts", "expert_mlp", "embed_fsdp"),
    }


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    if tokens <= 256:
        # decode / tiny batches: drop-free (worst case all tokens co-route)
        return tokens * cfg.experts_per_token
    cap = int(tokens * cfg.experts_per_token * cfg.moe_capacity_factor / cfg.num_experts)
    return max(cap, cfg.experts_per_token)


def moe_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    cap = _capacity(t, cfg)
    xt = x.reshape(t, d)

    # --- routing (top-k over experts; softmax over the selected gates) ---
    logits = (xt @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    expert_idx = order[:, :k]                                   # (T, k)
    gate_vals = torch.gather(probs, -1, expert_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # --- load-balancing auxiliary loss (Switch-style) ---
    me = probs.mean(dim=0)
    first = expert_idx[:, 0]
    counts = torch.zeros(e, dtype=torch.int64, device=x.device)
    ce = counts.scatter_add_(0, first, torch.ones_like(first)).float() / t   # bincount
    aux = e * torch.sum(me * ce)

    # --- capacity assignment: position of each (token, slot) in its expert ---
    flat_expert = expert_idx.reshape(-1)                        # (T*k,)
    # F.one_hot dispatches a scatter on the card and a compare on meta; this
    # compare dispatches the same ops on every device, as the dry run counts
    onehot = (flat_expert[:, None] == torch.arange(e, device=x.device)).long()  # (T*k, E)
    pos_in_expert = torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1,
                                 flat_expert[:, None])[:, 0]
    keep = pos_in_expert < cap                                  # overflow dropped

    # --- dispatch: scatter tokens into (E, C, D) buffers ---
    src = torch.repeat_interleave(xt, k, dim=0)                 # (T*k, D)
    safe_pos = torch.where(keep, pos_in_expert, cap - 1)
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((flat_expert, safe_pos), torch.where(keep[:, None], src, 0),
                   accumulate=True)
    buf = constrain(buf, ("experts", "expert_cap", "embed"))

    # --- expert FFNs (batched over E) ---
    gate = torch.bmm(buf, p["w_gate"])
    up = torch.bmm(buf, p["w_up"])
    act = (F.silu(gate.float()) * up.float()).to(x.dtype)
    out = torch.bmm(act, p["w_down"])
    out = constrain(out, ("experts", "expert_cap", "embed"))

    # --- combine: gather each (token, slot)'s result, weight, and sum ---
    gathered = torch.where(keep[:, None], out[flat_expert, safe_pos], 0)
    w = gate_vals.reshape(-1)[:, None].to(x.dtype)
    y = (gathered * w).reshape(t, k, d).sum(dim=1)
    return y.reshape(b, s, d), aux
