"""One train step on a device against the same step on the CPU.

``step_vs_cpu(device)`` runs one step of ``make_train_step`` on the smoke
SmolLM-360M config at float32 (2 microbatches of 4 x 64 tokens, lr
``STEP_LR``) from the same masters and batch, once on the CPU and once on
``device``, and returns the differences that ``STEP_TOL`` bounds.  Float32
products must stay float32 on the card (TF32 off), as they are on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.models.model_zoo import get_model
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt_lib

STEP_LR = 1e-3
# The float32 step tolerances that hold the port's step to the reference's:
# the loss (absolute), the masters (absolute, in units of lr: Adam magnifies
# gradients near its epsilon) and the moments (of each leaf's max |moment|).
STEP_TOL = {"loss": 1e-5, "masters_lr": 0.02, "moments_rel": 2e-5}


def step_vs_cpu(device, arch: str = "smollm_360m") -> dict:
    """The ``STEP_TOL`` differences of one step on ``device`` against the CPU's,
    and whether the device's masters stayed there (``masters_on_device``) and
    its model was refreshed from them (``model_refreshed``)."""
    cfg = smoke_config(arch)
    api = get_model(cfg)
    tc = TrainConfig(learning_rate=STEP_LR, warmup_steps=1, steps=4, microbatches=2)
    host = api.init_params(torch.Generator().manual_seed(0), 64)
    masters = {n: p.detach().clone() for n, p in host.named_parameters()}
    batch = data_lib.batch_for_step(0, cfg, ShapeConfig("t", "train", 64, 8), 0, 2, "cpu")
    step = opt_lib.make_train_step(api.loss_fn, tc)
    want = step(host, masters, opt_lib.init_opt_state(masters), batch)
    dev_masters = {n: p.to(device) for n, p in masters.items()}
    model = api.build(device, 64)
    opt_lib.load_masters(model, dev_masters)
    got = step(model, dev_masters, opt_lib.init_opt_state(dev_masters),
               {k: v.to(device) for k, v in batch.items()})
    masters_diff = max(float((got[0][n].cpu() - w).abs().max()) for n, w in want[0].items())
    moments = max(float((got[1][m][n].cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-12)
                  for m in ("mu", "nu") for n, w in want[1][m].items())
    on_device = torch.device(device)
    return {"loss": abs(float(got[2]["loss"]) - float(want[2]["loss"])),
            "masters_lr": masters_diff / STEP_LR, "moments_rel": moments,
            "masters_on_device": all(t.device.type == on_device.type for t in got[0].values()),
            "model_refreshed": all(torch.equal(p.cpu(), got[0][n].cpu())
                                   for n, p in model.named_parameters())}
