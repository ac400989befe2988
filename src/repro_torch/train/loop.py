"""The training loop: train step + checkpoint/restart + watchdog.

The reference's ``repro/train/loop.py``, ported.  Precision as the
reference's: float32 masters and AdamW moments on the device (the
reference's float32 params), the model holding the working copy in
``cfg.dtype`` (``optimizer.make_train_step``).  A checkpoint holds
``{"params": masters, "opt": opt_state}``; a resume restores the latest and
runs only the remaining steps.

With ``mesh=`` the masters and moments are stored as per-position pieces
laid out by the model's logical specs (ZeRO-3 storage), while each step
computes at the mesh's first position, so every mesh gives the one-device
step's bits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.kernels import costs
from repro_torch.launch.mesh import DeviceMesh, MeshArray, distribute, gather, piece_slices
from repro_torch.models.model_zoo import get_model
from repro_torch.sharding.rules import (DEFAULT_RULES, active_rules, logical_to_spec,
                                        shard_params, use_rules)
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import StepTimer, StepWatchdog


def init_train_state(cfg: ModelConfig, tc: TrainConfig, max_seq: int, device):
    """(model, masters, opt_state): the init's float32 draws from
    ``tc.seed`` as the masters, the model holding them in ``cfg.dtype``."""
    api = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(tc.seed)
    f32 = get_model(dataclasses.replace(cfg, dtype="float32")).init_params(gen, max_seq)
    masters = {name: p.detach() for name, p in f32.named_parameters()}
    model = api.build(device, max_seq)
    opt_lib.load_masters(model, masters)
    return model, masters, opt_lib.init_opt_state(masters)


def compute_device(mesh: DeviceMesh) -> torch.device:
    """Where a sharded step computes: the mesh's first position."""
    return mesh.device((0,) * len(mesh.axis_names))


def build_sharded_train_state(api, mesh: DeviceMesh, tc: TrainConfig, max_seq: int):
    """(model, masters, opt_state, param_sh): ``init_train_state``'s draws at
    the mesh's first position, placed by ``shard_params(masters,
    api.param_specs(), mesh, active_rules())``: each master and moment a
    ``MeshArray``, ``step`` one 0-d piece at every position.  The model is
    the working copy at the first position."""
    model, masters, _ = init_train_state(api.cfg, tc, max_seq, compute_device(mesh))
    param_sh = shard_params(masters, api.param_specs(), mesh, active_rules())
    params, opt_state = shard_train_state(masters, param_sh)
    return model, params, opt_state, param_sh


def shard_train_state(masters: Dict[str, torch.Tensor], param_sh: Dict[str, tuple]):
    """(params, opt_state) on the shardings ``param_sh``: each master cut
    into its pieces, zero moments beside each piece, ``step`` 0 at every
    position."""
    params = {name: distribute(t, param_sh[name]) for name, t in masters.items()}

    def zeros(a: MeshArray) -> MeshArray:
        return MeshArray(a.shape, torch.float32,
                         {pos: torch.zeros_like(p, dtype=torch.float32)
                          for pos, p in a.pieces.items()}, a.sharding)

    step = distribute(torch.zeros((), dtype=torch.int32),
                      opt_lib.opt_state_specs(param_sh)["step"])
    return params, {"mu": {name: zeros(a) for name, a in params.items()},
                    "nu": {name: zeros(a) for name, a in params.items()}, "step": step}


def make_sharded_step(api, mesh: DeviceMesh, tc: TrainConfig, shape: ShapeConfig,
                      param_sh: Dict[str, tuple]):
    """The reference's ``make_jitted_step`` without a compiler to lay out the
    math: ``(step_fn, batch_sh)``.

    ``step_fn(model, params, opt_state, batch)`` takes ``MeshArray`` masters
    and moments (``build_sharded_train_state``'s) and returns the same kind.
    It gathers the masters into the model's working copy at the first
    position, runs ``optimizer.make_grad_fn``'s gradient there on the whole
    batch, takes the global norm over the whole gradient, and updates each
    piece at its own position with that gradient's block (a replicated block
    once per position).  ``batch_sh`` is the batch's sharding as the
    reference resolves it, reported only: the rows are not split, since
    MoE's capacity and aux term are not linear in them.  The work done for
    the other positions runs under ``kernels.costs.elsewhere()``, so a cost
    counter books it apart from the first position's.
    """
    grad_fn = opt_lib.make_grad_fn(api.loss_fn, tc)
    lead = (None,) if tc.microbatches > 1 else ()
    batch_sh = {}
    for key, spec in api.batch_logical(shape).items():
        if spec is not None:
            dims = lead + tuple(spec)
            # shapes are unknown here: the reference resolves with dims that
            # always divide (the global batch is a multiple of the dp axes)
            batch_sh[key] = (mesh, logical_to_spec(dims, (1 << 30,) * len(dims), mesh))
    first = (0,) * len(mesh.axis_names)

    def update(master: MeshArray, grad: torch.Tensor, mu: MeshArray, nu: MeshArray,
               shared: dict) -> tuple:
        """``adamw_leaf`` on every piece at its position: (p, mu, nu) MeshArrays."""
        _, spec = master.sharding
        out = ({}, {}, {})
        for pos, piece in master.pieces.items():
            with costs.elsewhere(pos != first):
                s = {k: v.to(piece.device) for k, v in shared.items()}
                g = grad[piece_slices(master.shape, spec, mesh, pos)].to(piece.device)
                for store, t in zip(out, opt_lib.adamw_leaf(piece, g, mu.pieces[pos],
                                                            nu.pieces[pos], s, tc)):
                    store[pos] = t
        return tuple(MeshArray(master.shape, master.dtype, pieces, master.sharding)
                     for pieces in out)

    def step_fn(model, params: Dict[str, MeshArray], opt_state: dict, batch: dict):
        if tc.grad_dtype == "bfloat16":
            opt_lib.load_masters(model, params, round_bf16=True)
        loss, grads = grad_fn(model, batch)
        step = opt_state["step"]
        steps = {}
        for pos, t in step.pieces.items():
            with costs.elsewhere(pos != first):
                steps[pos] = t + 1
        shared = opt_lib.adamw_scalars(grads, steps[first], tc)
        new_p, new_mu, new_nu = {}, {}, {}
        for name, master in params.items():
            new_p[name], new_mu[name], new_nu[name] = update(
                master, grads[name], opt_state["mu"][name], opt_state["nu"][name], shared)
        opt_lib.load_masters(model, new_p)
        opt_state = {"mu": new_mu, "nu": new_nu,
                     "step": MeshArray(step.shape, step.dtype, steps, step.sharding)}
        return new_p, opt_state, {"loss": loss, "grad_norm": shared["grad_norm"],
                                  "lr": shared["lr"]}

    return step_fn, batch_sh


def train(cfg: ModelConfig, shape: ShapeConfig, tc: TrainConfig, device=None,
          log_every: int = 10, resume: bool = True,
          mesh: Optional[DeviceMesh] = None) -> Dict[str, Any]:
    """Run ``tc.steps`` of training on ``device`` (``cuda`` unless the caller
    asks for ``cpu``), or with ``mesh`` on the mesh's first position with
    the state stored over the mesh (``build_sharded_train_state``; a
    ``device`` given beside it must be that position's).

    Returns ``history`` (each run step's loss), ``final_loss``, ``params``
    (the model, refreshed from the final masters), ``masters`` and
    ``opt_state`` (named tensors, or ``MeshArray`` s on a mesh) and
    ``step_ms`` (each run step's time: CUDA events on the card, the host
    clock on the CPU); on a mesh also ``param_shardings`` and
    ``batch_shardings``.
    """
    api = get_model(cfg)
    out: Dict[str, Any] = {}
    rules = DEFAULT_RULES
    if cfg.sharding_overrides:
        rules = rules.replace(**dict(cfg.sharding_overrides))
    with use_rules(rules):
        if mesh is None:
            device = torch.device(device or "cuda")
            if device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
            model, params, opt_state = init_train_state(cfg, tc, shape.seq_len, device)
            step_fn = opt_lib.make_train_step(api.loss_fn, tc)
            placement = {"device": device}
        else:
            first, asked = compute_device(mesh), torch.device(device or compute_device(mesh))
            if asked.type != first.type or asked.index not in (None, first.index):
                raise ValueError(f"device {device!r} is not the mesh's first position {first}")
            device = first
            model, params, opt_state, param_sh = build_sharded_train_state(
                api, mesh, tc, shape.seq_len)
            step_fn, batch_sh = make_sharded_step(api, mesh, tc, shape, param_sh)
            placement = {"shardings": {"params": param_sh,
                                       "opt": opt_lib.opt_state_specs(param_sh)}}
            out.update(param_shardings=param_sh, batch_shardings=batch_sh)
        ckpt = CheckpointManager(tc.checkpoint_dir, keep=tc.keep_checkpoints,
                                 async_save=tc.async_checkpoint)
        start = 0
        if resume and ckpt.latest_step() is not None:
            start, state = ckpt.restore({"params": params, "opt": opt_state}, **placement)
            params, opt_state = state["params"], state["opt"]
            opt_lib.load_masters(model, params)

        on_card = device.type == "cuda"
        timer = StepTimer()
        history, step_ms = [], []
        for step in range(start, tc.steps):
            batch = data_lib.batch_for_step(step, cfg, shape, tc.seed, tc.microbatches,
                                            device)
            t0 = time.perf_counter()
            if on_card:
                events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                events[0].record()
            with StepWatchdog(tc.step_timeout_s):
                params, opt_state, metrics = step_fn(model, params, opt_state, batch)
                if on_card:
                    events[1].record()
                loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            step_ms.append(events[0].elapsed_time(events[1]) if on_card else dt * 1e3)
            straggler = timer.record(dt)
            history.append(loss)
            if step % log_every == 0 or step == tc.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f} ms"
                      + (" [straggler]" if straggler else ""), flush=True)
            if tc.checkpoint_every and (step + 1) % tc.checkpoint_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
        if not (tc.checkpoint_every and tc.steps % tc.checkpoint_every == 0
                and start < tc.steps):
            ckpt.save(tc.steps, {"params": params, "opt": opt_state})  # not saved in the loop
        ckpt.wait()
    tok = params["embed.tok"]
    model.keep_head_source(gather(tok, "cpu") if isinstance(tok, MeshArray) else tok)
    out.update(history=history, final_loss=history[-1] if history else None, params=model,
               masters=params, opt_state=opt_state, step_ms=step_ms)
    return out
