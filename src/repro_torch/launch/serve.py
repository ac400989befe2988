"""Serving launcher: batched decode demo with optional approximate Top-K head.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --smoke \\
      --batch 4 --prompt-len 8 --gen 16 --approx-head

The reference's ``repro/launch/serve.py``, ported, plus ``--device``
(``cuda`` by default; with no CUDA device it refuses to run there).
``--arch`` takes all ten configs; ``--approx-head`` needs a family with a
hidden-state decode (dense, moe, vlm) and exits before any work otherwise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models.model_zoo import get_model
from repro_torch.serve.engine import HIDDEN_STATE_FAMILIES, ServingEngine
from repro_torch.serve.topk_head import TopKHeadConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--approx-head", action="store_true",
                    help="sample via the paper's partitioned Top-K SpMV head")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.approx_head and cfg.family not in HIDDEN_STATE_FAMILIES:
        raise SystemExit(f"--approx-head: {cfg.name} ({cfg.family}) has no hidden-state "
                         f"decode; the head serves dense/moe/vlm only")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    api = get_model(cfg)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = api.init_params(gen, args.max_seq)
    head_cfg = TopKHeadConfig(big_k=32, k=8, num_partitions=8, nnz_per_row=32,
                              block_size=128, device=args.device)
    eng = ServingEngine(
        cfg, params, batch_size=args.batch, max_seq=args.max_seq,
        use_approx_head=args.approx_head, head_cfg=head_cfg, device=args.device,
    )
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    t0 = time.perf_counter()
    res = eng.generate(prompt.astype(np.int32), args.gen)
    dt = time.perf_counter() - t0
    print(f"generated {res.tokens.shape} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print(res.tokens)
    if args.approx_head:
        h, _ = eng.decode_hidden(eng.new_cache(), prompt[:, :1], 0)
        print("approx-head samples:", eng.sample_approx(h))
        print("overlap@32 vs exact:", eng.head.overlap_at_k(h[0].float().cpu().numpy(), 32))


if __name__ == "__main__":
    main()
