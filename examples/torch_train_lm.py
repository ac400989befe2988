"""End-to-end training on the port: train an LM with checkpointing,
resume, microbatching and straggler monitoring.

A small smollm-family model (300 steps by default; ``--device cpu`` runs it
on the CPU):

    PYTHONPATH=src python examples/torch_train_lm.py [--steps N] [--device cpu]

The full config runs through the launcher on the card:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 300 --batch 32 --seq 2048 --microbatches 4
"""
import argparse
import dataclasses
import os
import shutil
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.train.loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_torch_example_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)  # a fresh demo
    # The smollm-360m family cut for a quick run: the same q_per_kv ratio,
    # tied embeddings.
    cfg = dataclasses.replace(
        get_config("smollm_360m"),
        num_layers=4, d_model=192, num_heads=3, num_kv_heads=1, head_dim=64,
        d_ff=512, vocab_size=2048, vocab_pad_multiple=8, dtype="float32",
    )
    shape = ShapeConfig("example", "train", seq_len=128, global_batch=8)
    tc = TrainConfig(
        learning_rate=1e-3, warmup_steps=max(args.steps // 10, 1), steps=args.steps,
        microbatches=2, checkpoint_every=100, checkpoint_dir=ckpt_dir, keep_checkpoints=2,
    )
    out = train(cfg, shape, tc, device=args.device, log_every=25)
    first, last = out["history"][0], out["final_loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} over {tc.steps} steps "
          f"({(1 - last / first) * 100:.0f}% reduction)")
    if not last < first:
        raise SystemExit("training should reduce the loss")
    return out


if __name__ == "__main__":
    main()
