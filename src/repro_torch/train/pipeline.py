"""GPipe-style pipeline parallelism over a 'stage' mesh axis.

The reference's ``repro/train/pipeline.py``, ported.  Layer-stacked params
shard their layer dim across stages (one rule change: ``layers -> "stage"``);
activations flow stage to stage through M + S - 1 ticks for M microbatches
on S stages (the classic GPipe schedule with its bubble).  Stage ``s`` holds
blocks ``[s L/S, (s+1) L/S)`` and computes at the first position of its
slice of the mesh; the reference's ``ppermute`` to the next stage is a
``.to()`` onto that stage's device, through which autograd carries the
gradient back.  A (stage, tick) pair whose microbatch is out of range
computes nothing (the reference computes it and discards it with
``where``: the result is the same).

Embedding runs at the first stage's position, the final norm, the LM head
and the loss at the last stage's.  Dense + MoE-free archs only, as in the
reference.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import DeviceMesh, piece_slices
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.sharding.rules import DEFAULT_RULES, logical_to_spec

PIPELINE_RULES_OVERRIDE = {"layers": "stage"}


def pipeline_applicable(cfg: ModelConfig, num_stages: int) -> bool:
    return (
        cfg.family in ("dense", "vlm")
        and cfg.num_experts == 0
        and cfg.num_layers % num_stages == 0
    )


def pipeline_param_specs(cfg: ModelConfig) -> Dict:
    """Param specs with the layer dim staged (rules map layers -> stage)."""
    return transformer.param_specs(cfg)


def stages(cfg: ModelConfig, mesh: DeviceMesh) -> list:
    """``(device, layers)`` of each stage: the mesh position with that
    ``stage`` index and 0 on every other axis, and the layer dim's slice
    there under ``pipeline_param_specs`` and ``PIPELINE_RULES_OVERRIDE``
    (a ``range`` of blocks)."""
    rules = DEFAULT_RULES.replace(**PIPELINE_RULES_OVERRIDE)
    shape = (cfg.num_layers, cfg.d_model)
    spec = logical_to_spec(pipeline_param_specs(cfg)["blocks"]["ln1"], shape, mesh, rules)
    axis = mesh.axis_names.index("stage")
    out = []
    for s in range(mesh.shape["stage"]):
        pos = [0] * len(mesh.axis_names)
        pos[axis] = s
        layers = piece_slices(shape, spec, mesh, tuple(pos))[0]
        out.append((mesh.device(tuple(pos)), range(*layers.indices(cfg.num_layers))))
    return out


@torch.no_grad()
def place_stages(model: transformer.Transformer, mesh: DeviceMesh) -> None:
    """Move each stage's blocks to its device, the embedding to the first
    stage's and ``ln_f`` to the last stage's; a weight already there stays
    (so after the first call nothing moves)."""
    staged = stages(model.cfg, mesh)
    placed = [(p, dev) for dev, layers in staged for i in layers
              for p in model.blocks[i].parameters()]
    placed += [(p, staged[0][0]) for p in model.embed.parameters()]
    placed.append((model.ln_f, staged[-1][0]))
    for p, dev in placed:
        if p.device != dev:
            p.data = p.data.to(dev)


def pipelined_loss_fn(model: transformer.Transformer, cfg: ModelConfig, batch: Dict,
                      mesh: DeviceMesh, microbatches: int) -> torch.Tensor:
    """Cross-entropy loss with the block stack pipelined over 'stage'.

    Differentiable: the caller takes gradients of the returned loss with
    respect to the model's weights (``requires_grad`` on).  Like the
    reference, it reads ``tokens``, ``labels`` and ``loss_mask`` only.
    """
    s_stages = mesh.shape["stage"]
    assert pipeline_applicable(cfg, s_stages), "arch not pipeline-applicable"
    tokens, labels = batch["tokens"], batch["labels"]
    b, seq = tokens.shape
    m = microbatches
    assert b % m == 0, "global batch must divide into microbatches"
    mb = b // m

    place_stages(model, mesh)
    devices, layers = zip(*stages(cfg, mesh))
    x = L.embed_tokens(model.embed, tokens.to(devices[0]), cfg)     # (B, S, D)
    x_all = x.reshape(m, mb, seq, cfg.d_model)
    positions = [torch.arange(seq, device=dev)[None, :] for dev in devices]
    block = L.remat(model._block, cfg)

    def apply_local(s: int, xin: torch.Tensor) -> torch.Tensor:
        for i in layers[s]:
            xin, _aux = block(xin, model.blocks[i], positions[s])
        return xin

    state = [None] * s_stages       # each stage's output at the previous tick
    outputs = [None] * m            # the last stage's bank
    for t in range(m + s_stages - 1):
        prev = list(state)
        for s in range(s_stages):
            m_in = t - s                                     # this tick's microbatch
            if not 0 <= m_in < m:
                continue
            xin = x_all[m_in] if s == 0 else prev[s - 1].to(devices[s])
            state[s] = apply_local(s, xin)
            if s == s_stages - 1:
                outputs[m_in] = state[s]
    last = devices[-1]
    hidden = torch.stack(outputs).reshape(b, seq, cfg.d_model)
    hidden = L.rms_norm(hidden, model.ln_f, cfg.norm_eps)
    head = {name: p.to(last) for name, p in model.embed.named_parameters()}
    logits = L.lm_logits(head, hidden, cfg)
    mask = batch.get("loss_mask")
    return L.cross_entropy_loss(logits, labels.to(last),
                                None if mask is None else mask.to(last))
