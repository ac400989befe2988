"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --smoke \\
      --steps 100 --batch 8 --seq 128

The reference's ``repro/launch/train.py``, ported, plus ``--device``
(``cuda`` by default; with no CUDA device it refuses to run there) and
``--seed``.  The full config trains through the same entry point on the
card, e.g. SmolLM-360M at ``--batch 32 --seq 2048 --microbatches 4``.
``--mesh host`` (the default) lays the state over the visible devices of
``--device`` (every CUDA device; one CPU position under ``--device cpu``)
with ``--model-parallel`` on the model axis; ``--mesh
production|production-multipod`` asks for the reference's 256 or 512
devices.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.train.loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "production", "production-multipod"])
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-axis size for --mesh host")
    ap.add_argument("--step-timeout", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.mesh == "host":
        devices = [torch.device("cpu")] if args.device == "cpu" else None
        mesh = make_host_mesh(model=args.model_parallel, devices=devices)
    else:
        mesh = make_production_mesh(multi_pod=args.mesh.endswith("multipod"))
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    tc = TrainConfig(
        learning_rate=args.lr,
        steps=args.steps,
        microbatches=args.microbatches,
        grad_dtype=args.grad_dtype,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        step_timeout_s=args.step_timeout,
    )
    out = train(cfg, shape, tc, mesh=mesh)
    print(f"final loss: {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
