"""Batched serving engine: prefill + incremental decode over a KV/state cache.

The reference's ``repro/serve/engine.py``, ported, with a ``device``
argument (``"cuda"`` unless the caller asks for ``"cpu"``; with no CUDA
device an engine on ``"cuda"`` refuses to start).  It serves every family's
model: ``generate`` and ``prefill_tokens`` run its decode step.  A Whisper
model is served as the reference serves it, with an empty cross cache
(``cross_len`` 0): the engine has no encoder path.

Requests are served in fixed batch slots; the decode step runs the whole
batch.  Optionally the sampling head is the paper's ``ApproxTopKHead``
(sparsified vocab embedding + partitioned Top-K SpMV) instead of the dense
argmax: ``sample_approx`` answers the whole batch with one pass of the
multi-query kernel over the device-pinned embedding stream.  Its hidden
states come from ``decode_hidden``, which only the transformer families
(dense, moe, vlm) have, as in the reference.

As in the reference, the head is built from the float32 input embedding
``embed.tok`` even for an untied model, where ``generate``'s dense argmax
reads ``embed.out``: the model's ``head_source`` (``LanguageModel``), not
the ``tok`` it holds in ``cfg.dtype``, whose bfloat16 rounding would change
which entries each row keeps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import LanguageModel
from repro_torch.models.model_zoo import get_model
from repro_torch.serve.topk_head import ApproxTopKHead, TopKHeadConfig

# The families whose decode step can return the final hidden states.
HIDDEN_STATE_FAMILIES = ("dense", "moe", "vlm")


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray              # (B, steps) token ids
    steps: int


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: LanguageModel,
        batch_size: int,
        max_seq: int,
        use_approx_head: bool = False,
        head_cfg: Optional[TopKHeadConfig] = None,
        device: str = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingEngine: no CUDA device; pass device='cpu' to serve "
                               "on the CPU")
        if params.device.type != self.device.type:
            raise ValueError(f"params live on {params.device}, the engine on {self.device}")
        self.cfg = cfg
        self.api = get_model(cfg)
        self.params = params
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.head: Optional[ApproxTopKHead] = None
        if use_approx_head:
            head_cfg = head_cfg or TopKHeadConfig(device=self.device.type)
            if torch.device(head_cfg.device).type != self.device.type:
                raise ValueError(f"head_cfg.device {head_cfg.device!r} differs from the "
                                 f"engine's {device!r}")
            self.head = ApproxTopKHead(params.head_embedding(), head_cfg)

    def new_cache(self) -> dict:
        return self.api.init_cache(self.batch_size, self.max_seq, self.params.device)

    def _tokens(self, tokens) -> torch.Tensor:
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens))
        return tokens.to(self.params.device, torch.int64)

    def prefill_tokens(self, tokens: np.ndarray):
        """Feed a prompt (B, S0) through decode steps to fill a new cache;
        returns (last logits, cache, S0)."""
        cache = self.new_cache()
        toks = self._tokens(tokens)
        logits = None
        for t in range(toks.shape[1]):
            logits, cache = self.params.decode_step(cache, toks[:, t:t + 1], t)
        return logits, cache, toks.shape[1]

    def decode_hidden(self, cache: dict, tokens, pos: int):
        """Decode one step returning the final hidden states (B, D) and the
        cache; sampling then goes through the ``ApproxTopKHead`` instead of
        the V x D logits product.  Dense, moe and vlm models only, as in
        the reference."""
        if self.cfg.family not in HIDDEN_STATE_FAMILIES:
            raise ValueError(f"decode_hidden: dense/moe/vlm only (as the reference's "
                             f"ServingEngine); {self.cfg.name} is {self.cfg.family!r}")
        return self.params.decode_step(cache, self._tokens(tokens), pos, return_hidden=True)

    def sample_approx(self, hidden) -> np.ndarray:
        """Greedy sample via the approximate head.  hidden: (B, D).

        The hidden states reach the head as float32 on the host, as in the
        reference; all B rows are answered by one multi-query kernel pass
        over the sparsified-embedding stream.
        """
        if self.head is None:
            raise RuntimeError("sample_approx needs an engine built with use_approx_head=True")
        if isinstance(hidden, torch.Tensor):
            hidden = hidden.float().cpu().numpy()
        _, rows = self.head.topk_logits_batch(np.asarray(hidden, np.float32))
        return rows[:, 0].astype(np.int64)

    def generate(self, prompt: np.ndarray, num_steps: int, greedy: bool = True
                 ) -> GenerationResult:
        """prompt: (B, S0) int; returns (B, num_steps) greedy tokens through
        the dense logits (argmax takes the first index on ties)."""
        del greedy  # greedy only, as in the reference
        logits, cache, pos = self.prefill_tokens(prompt)
        tok = torch.argmax(logits, dim=-1)[:, None]
        outs = []
        for i in range(num_steps):
            outs.append(tok)
            logits, cache = self.params.decode_step(cache, tok, pos + i)
            tok = torch.argmax(logits, dim=-1)[:, None]
        return GenerationResult(tokens=torch.cat(outs, dim=1).cpu().numpy(), steps=num_steps)
