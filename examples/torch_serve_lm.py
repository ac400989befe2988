"""Serving scenario on the port: batched incremental decode and the paper's
approximate Top-K head in place of the dense logits product.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model_zoo import get_model
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.topk_head import TopKHeadConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")

    cfg = dataclasses.replace(
        get_config("qwen25_3b"),
        num_layers=4, d_model=128, num_heads=8, num_kv_heads=2, d_ff=256,
        vocab_size=4096, vocab_pad_multiple=8, dtype="float32",
    )
    params = get_model(cfg).init_params(torch.Generator(device=args.device).manual_seed(0),
                                        128)
    engine = ServingEngine(
        cfg, params, batch_size=4, max_seq=128, use_approx_head=True,
        head_cfg=TopKHeadConfig(big_k=64, k=8, num_partitions=16, nnz_per_row=64,
                                block_size=128, device=args.device),
        device=args.device,
    )
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    res = engine.generate(prompts, num_steps=12)
    print("generated token ids (4 requests x 12 steps):")
    print(res.tokens)

    # approximate Top-K head vs exact logits on a live hidden state
    hidden, _ = engine.decode_hidden(engine.new_cache(), prompts[:, :1], 0)
    print("\napprox-head greedy tokens:", engine.sample_approx(hidden))
    print("Eq.(1) partition-precision bound:", round(engine.head.partition_precision, 4))
    overlap = engine.head.overlap_at_k(hidden[0].float().cpu().numpy())
    print("overlap@64 vs exact logits:", overlap)
    return res, overlap


if __name__ == "__main__":
    main()
