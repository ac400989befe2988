"""AdamW with global-norm clipping, a warmup-cosine schedule, and optional
bf16 gradients against float32 master weights.

The reference's ``repro/train/optimizer.py``, ported.  Its functions take
trees; these take dicts of named float32 tensors (a model's
``named_parameters`` names), and ``adamw_update`` returns new tensors as the
reference returns new arrays.

``make_train_step`` differentiates the family's model (its working copy, in
``cfg.dtype``) and updates the float32 masters: gradients are read from the
model's parameters and cast to float32, and the parameters are refreshed
from the masters after each update.  At bfloat16 a tied ``tok`` gets its two
uses' gradients summed in bf16, where the reference sums them in float32.

On a mesh (``train.loop.make_sharded_step``) the masters and moments are
``MeshArray`` s: ``adamw_scalars`` runs once over the whole gradient and
``adamw_leaf`` on each piece, the same ops ``adamw_update`` runs on whole
tensors; ``opt_state_specs`` gives the state the masters' shardings.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import costs
from repro_torch.launch.mesh import MeshArray, unique_blocks

Named = Dict[str, torch.Tensor]


def init_opt_state(params: Named) -> dict:
    """Zero moments in float32 beside each master, and step 0."""
    zeros = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for name, p in params.items()}
    device = next(iter(params.values())).device
    return {"mu": zeros, "nu": {name: z.clone() for name, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_specs(param_shardings: Dict[str, tuple]) -> dict:
    """Optimizer state shards exactly like params (ZeRO-3 style); ``step`` is
    replicated over the masters' mesh."""
    shardings = list(param_shardings.values())
    step = (shardings[0][0], ()) if shardings else ()
    return {"mu": param_shardings, "nu": param_shardings, "step": step}


def lr_at(step: torch.Tensor, tc: TrainConfig) -> torch.Tensor:
    """Linear warmup over ``tc.warmup_steps``, then cosine decay to 10% at
    ``tc.steps`` (float32, as the reference computes it)."""
    step = step.float()
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    frac = torch.clamp(step / max(tc.steps, 1), max=1.0)
    decay = 0.5 * (1 + torch.cos(math.pi * frac))
    return tc.learning_rate * warm * (0.1 + 0.9 * decay)


def global_norm(tree: Named) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))


def adamw_scalars(grads: Named, step: torch.Tensor, tc: TrainConfig) -> dict:
    """What every leaf's update at ``step`` (the new step count) shares: the
    gradient norm before clipping, the clip scale, the learning rate and the
    two bias corrections (0-d float32 tensors on ``step``'s device)."""
    gnorm = global_norm(grads)
    t = step.float()
    return {"grad_norm": gnorm,
            "scale": torch.clamp(tc.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0),
            "lr": lr_at(step, tc),
            "c1": 1 - torch.pow(torch.tensor(tc.b1, dtype=torch.float32, device=t.device), t),
            "c2": 1 - torch.pow(torch.tensor(tc.b2, dtype=torch.float32, device=t.device), t)}


def adamw_leaf(p, g, mu, nu, s: dict, tc: TrainConfig):
    """One tensor's (or one piece's) update with the shared scalars ``s``:
    returns (p, mu, nu)."""
    b1, b2 = tc.b1, tc.b2
    g = g.float() * s["scale"]
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    mu_hat = mu / s["c1"]
    nu_hat = nu / s["c2"]
    p = p - s["lr"] * (mu_hat / (torch.sqrt(nu_hat) + 1e-8) + tc.weight_decay * p)
    return p, mu, nu


def adamw_update(params: Named, grads: Named, opt_state: dict, tc: TrainConfig
                 ) -> Tuple[Named, dict, dict]:
    """Returns (new_params, new_opt_state, metrics); ``metrics["grad_norm"]``
    is the norm before clipping."""
    step = opt_state["step"] + 1
    s = adamw_scalars(grads, step, tc)
    new_p, new_mu, new_nu = {}, {}, {}
    for name, p in params.items():
        new_p[name], new_mu[name], new_nu[name] = adamw_leaf(
            p, grads[name], opt_state["mu"][name], opt_state["nu"][name], s, tc)
    return (new_p, {"mu": new_mu, "nu": new_nu, "step": step},
            {"grad_norm": s["grad_norm"], "lr": s["lr"]})


@torch.no_grad()
def load_masters(model: torch.nn.Module, params: Named, round_bf16: bool = False) -> None:
    """Refresh the model's working copy from the masters, each cast to the
    dtype the model holds it in; ``round_bf16`` rounds every master to
    bfloat16 first (the float32-held norms too).  A master that is a
    ``MeshArray`` is gathered: each distinct block copied once into its
    slice of the parameter."""
    for name, p in model.named_parameters():
        src = params[name]
        if isinstance(src, MeshArray):
            blocks = [(pos, sl, src.pieces[pos]) for pos, sl in unique_blocks(src.shape,
                                                                               src.sharding)]
        else:
            blocks = [((), (), src)]
        for pos, sl, block in blocks:
            if round_bf16:
                with costs.elsewhere(any(pos)):      # rounded where the block lives
                    block = block.to(torch.bfloat16)
            p[sl].copy_(block)


def make_train_step(loss_fn: Callable, tc: TrainConfig) -> Callable:
    """Build the (micro-batched) train step.

    ``loss_fn(model, batch)`` is the family's loss (``ModelAPI.loss_fn``).
    The step is ``step_fn(model, params, opt_state, batch) -> (params,
    opt_state, metrics)``: ``params`` are the float32 masters under the
    model's parameter names, ``metrics`` holds ``loss``, ``grad_norm`` and
    ``lr`` as 0-d tensors.  The model holds the masters (each cast to its
    held dtype, as ``load_masters`` leaves it) on entry and on return.
    ``batch`` leaves carry a leading microbatch
    axis when ``tc.microbatches > 1``; gradients are accumulated in
    ``tc.grad_dtype``.  With ``grad_dtype="bfloat16"`` the gradient is taken
    at the masters rounded to bfloat16 and is itself rounded to bfloat16
    (the reference differentiates a bf16 copy of its float32 params).
    """
    grad_fn = make_grad_fn(loss_fn, tc)

    def step_fn(model, params: Named, opt_state: dict, batch: dict):
        if tc.grad_dtype == "bfloat16":
            load_masters(model, params, round_bf16=True)
        loss, grads = grad_fn(model, batch)
        params, opt_state, metrics = adamw_update(params, grads, opt_state, tc)
        metrics["loss"] = loss
        load_masters(model, params)
        return params, opt_state, metrics

    return step_fn


def make_grad_fn(loss_fn: Callable, tc: TrainConfig) -> Callable:
    """``grad_fn(model, batch) -> (loss, grads)``: the (micro-batched) loss
    at the model's working copy as a 0-d float32 tensor, and the gradient
    under the model's parameter names in ``tc.grad_dtype`` (the mean over
    the microbatches when ``tc.microbatches > 1``)."""
    gdt = getattr(torch, tc.grad_dtype)

    def single(model, weights, batch):
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, weights, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g for w, g in zip(weights, grads)]
        return loss.detach().float(), grads

    def grad_fn(model, batch: dict):
        names, weights = zip(*model.named_parameters())
        for w in weights:
            w.requires_grad_(True)
        try:
            if tc.microbatches <= 1:
                loss, grads = single(model, weights, batch)
                grads = [g.to(gdt) for g in grads]
            else:
                loss = torch.zeros((), dtype=torch.float32, device=weights[0].device)
                grads = [torch.zeros(w.shape, dtype=gdt, device=w.device) for w in weights]
                for i in range(tc.microbatches):
                    mb_loss, g = single(model, weights, {k: v[i] for k, v in batch.items()})
                    loss = loss + mb_loss
                    grads = [a + b.to(gdt) for a, b in zip(grads, g)]
                loss = loss / tc.microbatches
                grads = [g / tc.microbatches for g in grads]
        finally:
            for w in weights:
                w.requires_grad_(False)
        return loss, dict(zip(names, grads))

    return grad_fn
