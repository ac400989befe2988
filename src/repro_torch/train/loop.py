"""The training loop: train step + checkpoint/restart + watchdog.

The reference's ``repro/train/loop.py``, ported to one device.  Precision as
the reference's: float32 masters and AdamW moments on the device (the
reference's float32 params), the model holding the working copy in
``cfg.dtype`` (``optimizer.make_train_step``).  A checkpoint holds
``{"params": masters, "opt": opt_state}``; a resume restores the latest and
runs only the remaining steps.

Left out: the GSPMD placement of params, optimizer state and batches on a
mesh (``build_sharded_train_state``, ``make_jitted_step``'s shardings),
which waits for ROADMAP Queue 1 items 3 and 7.5.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.models.model_zoo import get_model
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


def train(cfg: ModelConfig, shape: ShapeConfig, tc: TrainConfig, device="cuda",
          log_every: int = 10, resume: bool = True) -> Dict[str, Any]:
    """Run ``tc.steps`` of training on ``device`` (``cuda`` unless the caller
    asks for ``cpu``).

    Returns ``history`` (each run step's loss), ``final_loss``, ``params``
    (the model, refreshed from the final masters), ``masters`` and
    ``step_ms`` (each run step's time: CUDA events on the card, the host
    clock on the CPU).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
    model, params, opt_state = init_train_state(cfg, tc, shape.seq_len, device)
    step_fn = opt_lib.make_train_step(get_model(cfg).loss_fn, tc)
    ckpt = CheckpointManager(tc.checkpoint_dir, keep=tc.keep_checkpoints,
                             async_save=tc.async_checkpoint)
    start = 0
    if resume and ckpt.latest_step() is not None:
        start, state = ckpt.restore({"params": params, "opt": opt_state}, device=device)
        params, opt_state = state["params"], state["opt"]
        opt_lib.load_masters(model, params)

    on_card = device.type == "cuda"
    timer = StepTimer()
    history, step_ms = [], []
    for step in range(start, tc.steps):
        batch = data_lib.batch_for_step(step, cfg, shape, tc.seed, tc.microbatches, device)
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
    if not (tc.checkpoint_every and tc.steps % tc.checkpoint_every == 0 and start < tc.steps):
        ckpt.save(tc.steps, {"params": params, "opt": opt_state})   # not saved in the loop
    ckpt.wait()
    model.keep_head_source(params["embed.tok"])
    return {"history": history, "final_loss": history[-1] if history else None,
            "params": model, "masters": params, "step_ms": step_ms}
