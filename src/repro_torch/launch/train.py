"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --smoke \\
      --steps 100 --batch 8 --seq 128

The reference's ``repro/launch/train.py``, ported, plus ``--device``
(``cuda`` by default; with no CUDA device it refuses to run there) and
``--seed``.  The full config trains through the same entry point on the
card, e.g. SmolLM-360M at ``--batch 32 --seq 2048 --microbatches 4``.
``--mesh`` and ``--model-parallel`` wait for the sharding rules (ROADMAP
Queue 1 item 7.5): one device.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
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
    ap.add_argument("--step-timeout", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
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
    out = train(cfg, shape, tc, device=args.device)
    print(f"final loss: {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
