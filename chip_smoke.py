#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main query path on one card.

    python3 chip_smoke.py [--rows N] [--seed S] [--only accumulate|lm|families|train]

Phases (any failure ends the run with a non-zero exit and no result line):

1. build     nvcc builds every kernel source of the paths (sm_90a) and
             prints each kernel's registers (``-Xptxas -v``).
2. parity    each kernel against its plain PyTorch version on the card, on
             small fixtures: all four value formats, int16 and int32 column
             ids, Q in {1, 3, 37, 64}, B in {32, 256}, T in {1, 2}, empty rows, a
             row spanning several packets, cores with fewer than k rows, all
             negative scores under a padded slot budget (whose phantom slots
             the accumulate kernel must leave at exactly 0.0), flag-free
             padding packets, poisoned padding ids.  Dyadic fixtures must be
             bit-identical; random ones agree within rtol = atol = 1e-5 with
             equal row ids outside near-ties.  All three kernels (the
             multi-query one at Q in {1, 3, 37, 64}: 37 is five chunks, the
             last one ragged, as the serving frontend coalesces) run at the card's S blocks
             per core, at one and at 64, and every S must give the bits of
             S = 1.  The same checks run on the tagged width classes
             of mixed-precision snapshots (TAG4, TAG2 with BF16 and Q15
             cores in one launch, TAG1; dyadic, random, all-negative under a
             padded budget, poisoned padding, ties at the k-th place), and
             each snapshot's grouped dispatch must give the bits of its f32
             twins streamed as one F32 stream.
3. main path the deployment configuration of ``repro_torch.configs.topk_spmv``
             (10M rows x 512 columns, gamma row lengths with mean 20, BF16,
             B=256, K=100, k=8, T=2, fused layout, c=32) through the mutable
             ``SparseEmbeddingIndex``: ``query`` / ``query_batch`` and
             ``topk_spmv(...)`` checked against the torch oracle per query
             and against exact search for precision@K; then ``upsert`` of 64
             rows and ``delete`` of 64, and the same queries at Q = 1, 8, 64
             on the new snapshot (deleted ids never returned), one retrace
             per dispatch key at the first mutation and none over further
             upserts.  Both top-k kernels' launch counts must rise here, and
             the executor's host-to-device copies stay flat in steady state.
             Before the mutations, ``distributed_topk_spmv_fn`` on the same
             index over a ("data",) mesh of four positions on this card: the
             single form bit for bit ``topk_spmv``'s answer, the batched form
             at Q = 64 ``query_batch``'s.
4. timings   each top-k kernel at every Q the main path gives it on the main
             path's streams before and after ingest, at the card's S and at
             one split, in turns (with S, the multi-query q_chunk and the
             split-table build time printed; at the card's S bit-identical
             to S = 1 over repeated calls; the single-query kernel
             bit-identical to the multi-query kernel at Q = 1), and the
             accumulate kernel on phase 6's
             streams before and after the first mutation (run after phase 6;
             bit-identical to plain on dyadic values, within a stated
             rounding bound on random x, and at the card's S bit-identical
             to S = 1 on random x; both S timed in turns with the split
             table built beforehand, and the table's build time printed),
             CUDA events (device time: the stream is held while the
             launches are queued), each checked against its plain version
             on the same inputs, with its bound on an H100 SXM and a library
             yardstick (torch.sparse.mm).
5. mixed     recall-targeted mixed precision on the first 3,000,000 rows of
             the query cell's 10M x 512 collection (seed 0; a cut in depth
             only: c = 32 as phase 3's, the same widths, row lengths, target
             and k), scaled hot/cold as the
             reference's mixed-precision sweep (the first c/4 partitions at
             full magnitude, the other rows x 0.25), recall_target = 0.99
             (16 calibration queries, seed 0), through the mutable facade:
             format histogram, predicted and measured recall@8 (big_k = k,
             through the kernel, at least the target - 0.02), bytes per nnz
             beside uniform BF16, each kernel's device time per width class
             and in sum at Q = 1, 8, 64 (and ``topk_spmv``, accumulate, each
             at the class's own S) with its bound, before and after an
             ingest of 64 cold rows and 64
             deletes; before and after, each class's words through each
             kernel and its plain version (phase 4's tolerances), the
             facade's ``query`` / ``query_batch`` answers, ``topk_spmv`` and
             the executor's y = A x against the plain results merged, and
             the grouped kernels bit for bit against the f32 twins as one
             F32 stream; every kernel launched exactly once per class and
             call of the facade's run; no retrace and no
             format change over three more cold upserts (2 rows each);
             h2d_copies flat.
6. graph     personalized PageRank and top-k eigen at full width: the "ring"
             operator at 2**21 nodes (5,242,878 nnz, the scale of SNAP's
             com-Youtube), F32, B=256, T=2, fused, c=32, through
             ``GraphRankingService`` over a ``SparseEmbeddingIndex``'s
             mutable index: cold, warm (after ``update_node``, weights
             x 1.02) and forget+cold solves, all converged, canonical and
             retrace-free, the cold and warm solves bit-identical to their
             ``use_kernel=False`` counterparts, warm with fewer iterations
             and within 1 ulp of cold (in the same entries on both paths),
             host-to-device copies flat across the iterations; then
             ``topk_eigen(3)`` on the "ba" operator at 1024 nodes with float64
             residuals at most 1e-4.  The accumulate kernel's launch count
             must rise here; ``PPR_SPLIT`` prints a device iteration's time.
7. serving   run after phase 4, on phase 3's facade after its ingest (10M
             rows, BF16, c = 32): ``StreamingSimilarityService`` with a
             ``DurableIndexStore`` under ``.chip_tmp/`` (its construction
             writes the anchoring checkpoint).  A burst of 37 ``submit``s and
             ``flush()`` through a fixed-target frontend is one pass of
             Q = 37, bit for bit equal to ``query_batch`` of the same
             queries and each held to the oracle; then open-loop traffic
             (four threads, 64 submits each, through the adaptive frontend)
             while the main thread ingests 64 rows and deletes 64 ids
             through the service (WAL-logged): every answer 100 finite
             scores over valid rows, no deleted id in a request submitted
             after the delete returned, 64 more submits held to the oracle,
             passes, Q histogram, flush reasons and host latency p50 / p99
             printed; then a third ingest under ``FaultPlan({"wal.append":
             0})`` (a torn record, not applied), and
             ``StreamingSimilarityService.recover`` from a fresh store on the
             same directory: 2 records replayed, ``export_state`` equal to
             the live index's array for array, ``query_batch`` of phase 3's
             64 queries bit for bit equal, the same signature, no retrace
             and ``h2d_copies`` up by the re-pin only.  The multi-query
             kernel's launches must rise here.
8. sharded   run after phase 7 and before phase 5 (phase 3's facade freed):
             phase 3's collection and config behind
             ``SparseEmbeddingIndex(csr, cfg, n_shards=4)`` (8 partitions a
             shard, cut: none); phase 3's mutations replayed (the ingest of
             64 rows, the 64 deletes, three upserts of 8): ``query`` and
             ``query_batch`` at Q = 1, 8, 64 and ``index.query`` (the
             single-query kernel) bit for bit equal to phase 3's answers
             before, between and after them, the same ids assigned,
             ``h2d_copies`` equal to the shard pins' tensors and flat in
             steady state, no retrace within the buckets.  Failover: one
             Q = 64 batch under ``FaultPlan({"dispatch.shard": 0})`` equals
             the full answers restricted to shards 1-3's rows, the health
             fields say so, and ``recover_shard(0)`` re-pins shard 0 alone
             (timed with the first query after it) and gives the full
             answers back.  Phase 6's graph cell on 4 shards: a cold
             ``rank(seeds=[5, 17, 4242], top_k=10)``, one accumulate launch
             per shard and iteration; phase 6 holds its single-device cold
             rank to it bit for bit, in as many iterations.  The approximate
             head at Qwen2.5-3B's vocabulary and width (from
             ``repro_torch.configs``; a random embedding from ``--seed``),
             ``TopKHeadConfig`` defaults, unsharded and on 4
             shards: ``topk_logits_batch`` of 64 hidden states bit for bit
             equal, ``topk_logits(use_kernel=True)`` within phase 4's
             tolerance of the plain answer, overlap@64 against
             ``exact_topk_logits`` beside ``partition_precision``.  Every
             kernel must launch here; then each kernel's device time per
             shard and in sum, beside phase 4's single-device time and the
             bound.
9. lm        run after phase 6 (the earlier facades freed): Qwen2.5-3B at full
             width (``repro_torch.configs.get_config("qwen25_3b")``: d_model
             2048, vocab 151,936, bf16; cut since phase 13 came to 12 of its
             36 layers, depth only, printed on a ``CUT:`` line; the port's own
             init on the card from ``--seed``) behind ``ServingEngine(...,
             batch_size=64, max_seq=128, use_approx_head=True,
             head_cfg=TopKHeadConfig())``: 64 prompts of 16 tokens through
             ``generate(prompt, 32)`` twice (equal tokens, all in
             ``[0, vocab)``); the incremental prefill's last logits against
             ``prefill`` within ``LM_TOL`` (argmax equal wherever the top-2
             gap exceeds it); ``decode_hidden`` then ``sample_approx`` (the
             multi-query kernel at Q = 64) against the head's plain walk
             (ids equal outside near-ties, values within 1e-5), the
             single-query kernel likewise, overlap@64 over 16 states beside
             ``partition_precision``.  Both top-k kernels must launch here.
             Timed: a decode step at B = 64 and 1 (CUDA events, and the
             profiler's kernel time) beside the weight-byte bound, the head's
             kernel at Q = 64 and the dense ``lm_logits`` + argmax it
             replaces, each beside its bound; host tokens/s, peak memory.
10. families run after phase 9 (its model freed): the hybrid, ssm and
             audio families at full width (cut since phase 13 came to a third
             of each model's depth, ``FAM_DEPTH``, printed on a ``CUT:``
             line; the counts below are the full models'), one model at a time,
             each the port's own init on the card from ``--seed``, its
             parameter count held to ``param_count()`` (Whisper's
             ``dec_pos`` adds 1500 - 128 rows) and the init's peak memory
             logged apart from serving's.  Zamba2-7B (81 Mamba2 blocks and
             one shared attention block applied 13 times) and xLSTM-350M
             (6 x [1 sLSTM + 3 mLSTM]) behind ``ServingEngine(...,
             batch_size=64, max_seq=128)`` with no head: 64 prompts of 16
             tokens through ``generate(prompt, 32)`` twice (equal tokens, in
             ``[0, vocab)``), the incremental prefill's last logits against
             ``prefill`` within ``FAM_TOL`` (argmax equal past a clear gap),
             and each recurrent kind's first block chunked against its decode
             block stepped 256 times (two chunks) at B = 2, in float32 and
             bf16 (``FAM_BLOCK_TOL_*``).  Whisper-small: frame embeddings
             (64, 1500, 768) through ``encode`` and ``build_cross_cache(
             pad_to=1500)``, 16 prompt tokens decoded step by step against
             ``decode_train`` + ``lm_logits`` (``FAM_WHISPER_TOL``), 32 greedy
             steps through ``decode_step``, and ``ServingEngine(...,
             max_seq=1500).generate(prompt, 32)`` twice (the reference's
             empty cross cache; equal tokens).  Timed: a decode step at
             B = 64 and 1 (CUDA events, the profiler's kernel time, idle share
             and launches) beside its byte bound from the held tensors,
             ``generate`` tokens/s (host clock), Whisper's ``encode`` beside its
             FLOP bound.  None of the three kernels lies on these paths: their
             launches here must be 0.
11. train    run after phase 10: SmolLM-360M at full width and depth
             (``repro_torch.configs.get_config("smollm_360m")``: 32 layers,
             d_model 960, vocab 49,152, tied, bf16, ``remat="full"``;
             361,821,120 parameters, cut: none; the port's own init from
             ``--seed``) through ``repro_torch.train.loop.train`` at B = 32 x
             S = 2048 in 4 microbatches, lr 1e-3 with 2 warm-up steps: 3 steps
             with a checkpoint at step 2, then, in a fresh directory holding
             only that checkpoint, a resume to step 3 (cut since phase 12
             came: the cell runs 8 and resumes 4), both under
             ``torch.use_deterministic_algorithms(True, warn_only=True)``.
             Checks: finite losses, step 2's below step 0's, the resumed
             losses equal to the uninterrupted run's bit for bit, no
             non-deterministic op warned (each is named), one smoke-size step
             on the card equal to the CPU's within the f32 step tolerances
             (``repro_torch.train.parity.STEP_TOL``).  Timed: the step
             (CUDA events, median of the last 5) and tokens/s beside the
             FLOP bound (6 N + 12 L S H hd a token at 989 TFLOP/s), one
             profiled step (kernel ms, idle share, launches, the costliest
             kernels), peak memory, the checkpoint's bytes and its save and
             restore seconds.  None of the three kernels lies on this path:
             their launches here must be 0.  Leaves its step-2 checkpoint
             and the resumed run's last one for phase 13.
12. mesh     run after phase 8 and before phase 5 (phase 8's indexes freed):
             phase 3's collection and config behind ``SparseEmbeddingIndex(
             csr, cfg, mesh=make_serving_mesh(4, 2, devices=[cuda:0] * 8))``
             (a 2 replica x 4 shard mesh whose positions all name this card:
             8 partitions a shard, every position pinning its own copy;
             cut: none); phase 3's mutations replayed: ``query`` and
             ``query_batch`` at Q = 1, 8, 37 (ragged; against phase 3's Q = 64
             rows) and 64 and ``index.query`` (the single-query kernel) bit
             for bit phase 3's answers before, between and after them, the
             same ids assigned; the bundle's uploads flat in steady state,
             each mutation's sync shipping fewer than a full re-ship's 32
             partitions unless a common bucket jumped (each sync timed, and
             the first pin), retraces at most one per dispatch key and bucket
             jump.  Phase 6's graph cell on the same mesh: a cold ``rank``
             bit for bit phase 8's (and so phase 6's), in as many iterations,
             one accumulate launch per shard and iteration.  The head at
             Qwen2.5-3B's widths with ``TopKHeadConfig(mesh=...)``:
             ``topk_logits_batch`` of phase 8's 64 hidden states bit for bit
             phase 8's unsharded head.  Every kernel must launch here; then
             each kernel's device time per position and in sum.  One card
             runs every position, so copies between cards are not exercised
             and the times say nothing of scaling over replicas.
13. train mesh  run after phase 11, at the same full width and depth:
             (a) phase 11's step-2 checkpoint (saved from one device)
             resumed by ``train(..., mesh=DeviceMesh([[cuda:0] * 2] * 2,
             ("data", "model")))`` to step 3 under deterministic
             algorithms: the losses bit for bit phase 11's, and the mesh
             run's last checkpoint restored onto one device bit for bit
             phase 11's last (masters, moments, step); printed: the step's
             ms, each position's piece bytes, the peak memory.  (b)
             ``train.pipeline.pipelined_loss_fn`` at 4 stages x 4
             microbatches on a (4, 2, 1) ("stage", "data", "model") mesh of
             ``cuda:0`` positions, B 8 x S 2048 at float32 (TF32 off),
             against the sequential ``loss_fn`` + backward: loss within
             rtol 1e-5, every gradient leaf within 1e-4 of max(|g|, 1);
             both times (CUDA events), 7 ticks, bubble 3/7.  One card runs
             every position, so the moves between positions and stages are
             no-ops.  The three kernels launch 0 times here.
14. dryrun   run after phase 13: ``repro_torch.launch.dryrun`` on ``meta``
             tensors at the card's own shapes: (a) phase 11's train step
             (SmolLM-360M, B 32 x S 2048 in 4 microbatches, a one-position
             mesh), phase 9's decode step (Qwen2.5-3B at its 12 layers, B 64
             against a 128-deep cache) and phase 4's Q = 64 multi-query pass
             on phase 3's word shape; (b) one real step of each counted on
             the card under the same ``op_costs.OpCounter``, each where its
             state lives and outside every timed window: the pass at the end
             of phase 4 on phase 3's snapshot (one launch of the kernel, no
             plain walk), the decode step at the end of phase 9 on its model
             (then timed), the train step here on a fresh state.  Checks:
             each counted FLOP total equal to its ``meta`` trace's, the
             train step's argument bytes equal to the bytes the card holds
             for it (masters and moments 4,341,853,440), the pass's bytes
             equal to its ``meta`` record's and to phase 4's bound bytes.
             (c) Printed: each cell's bound (compute with the f32 products
             at 67 TFLOP/s, or memory) and its share of the measured time,
             the predicted peak (arguments + temp) beside the measured.
   summary   ``LM``, ``FAMILIES``, ``TRAIN``, ``TRAIN_MESH``, ``DRYRUN``,
             ``SHARDED``, ``MESH`` and ``MIXED`` lines, ``PHASES`` (each
             phase's seconds), the ``kernels`` JSON line (each kernel's
             classes, its mixed-path, per-shard and per-position times;
             ``launches`` counts phases 3, 6, 7, 8, 9, 10, 11, 12, 13 and 14,
             with phase 7's, 8's, 9's, 10's, 11's, 12's, 13's and 14's also
             apart), the card's name and power limit, and the result line.

``--only accumulate`` runs phases 1 and 2 and the accumulate timing on the
graph's streams (built and mutated once, no solves), and stops without the
result line: a short check of a kernel change before the full run.
``--only lm`` runs phases 1 and 9, ``--only families`` phases 1 and 10,
``--only train`` phases 1, 11 and 13; each stops without the result line.

The script needs one CUDA device and imports only ``repro_torch`` (from
``src/`` beside it) and torch/numpy.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# The H100 SXM's peaks, from the one place the port keeps them (the module
# imports nothing, so torch is not imported before main() sets up cuBLAS).
from repro_torch.launch.analysis import (HBM_BW as HBM_BYTES_PER_S,  # noqa: E402
                                         PEAK_FLOPS_BF16 as H100_BF16_FLOPS,
                                         PEAK_FLOPS_F32 as F32_FLOPS)
TOL = 1e-5
FORMATS = ("F32", "BF16", "Q15", "Q7")
SOURCE = "src/repro_torch/csrc/bscsr_topk_spmv.cu"
REPLACES = {
    "bscsr_topk_spmv": "src/repro/kernels/bscsr_topk_spmv.py:419",
    "bscsr_topk_spmv_multiquery": "src/repro/kernels/bscsr_topk_spmv.py:790",
    "bscsr_spmv": "src/repro/kernels/bscsr_topk_spmv.py:603",
}
# Clock cycles of the sleep that holds the stream while time_cuda queues
# its launches (about 50 ms: longer than 50 calls take to enqueue).
HOLD_CYCLES = 100_000_000
# Phase 2's query counts: 37 is four full chunks and a ragged fifth, as the
# serving frontend coalesces.
PARITY_QS = (1, 3, 37, 64)
# Extra calls of the multi-query kernel at each S, Q and snapshot of phase 4
# that must repeat the S = 1 bits.
MQ_REPEATS = 10
# Phase 2's tagged fixtures: eight cores, every width class, and TAG2 with
# BF16 and Q15 cores in one launch.
MIXED8 = ("F32", "BF16", "Q15", "Q7", "Q15", "BF16", "Q7", "F32")
# The mixed phase: the reference's recall-targeted sweep (sweep 5 of
# benchmarks/bench_kernel_paths.py) on the query cell's collection.
MIXED_TARGET = 0.99
MIXED_COLD_SCALE = 0.25
MIXED_BUDGET_S = 0.5           # time_cuda budget per timing in the mixed phase
MIXED_WIDER_K = 8              # extra places of the plain walk that scores a k-th-place tie
# Its collection: the first 3,000,000 rows of phase 3's (a cut in depth only,
# to keep the whole script inside its time limit with phase 14; c stays 32).
MIXED_ROWS = 3_000_000
GRAPH_NODES = 1 << 21
GRAPH_NNZ = 5_242_878          # the reference's synthetic_graph_csr("ring", 2**21, 0)
GRAPH_SEEDS = [5, 17, 4242]
# The "ba" eigen fixture.  At 4096 nodes (and 2048) its 2nd and 3rd
# eigenvalues lie so close that deflated power iteration does not reach
# tol = 1e-5 within 3000 steps; 1024 is the largest power of two that does.
EIGEN_NODES = 1024
# Phase 8: the query cell, the graph cell and the head on four shards; the
# head at Qwen2.5-3B's vocabulary and width, from the port's config.
SHARDS = 4
HEAD_EXACT = 16               # hidden states held to exact_topk_logits for overlap@64
# Phase 12: the same cells on a 2 replica x 4 shard mesh of this card's
# positions; its batches at Q = 1, 8, 37 (ragged) and 64; a short timing
# budget a position (eight positions, three kernels).
MESH_SHARDS, MESH_REPLICAS = 4, 2
MESH_QS = (1, 8, 37, 64)
MESH_BUDGET_S = 0.1
# distributed_topk_spmv_fn in phase 3: the core dim over a ("data",) mesh of
# four positions on this card.
DIST_POSITIONS = 4
# Phase 9: Qwen2.5-3B at full width behind ServingEngine with the approximate
# head: 64 requests of 16 prompt tokens and 32 generated ones.
LM_ARCH = "qwen25_3b"
LM_BATCH, LM_PROMPT, LM_GEN, LM_MAX_SEQ = 64, 16, 32, 128
# Cut (to keep the script inside its time limit with phase 13): 12 of the
# model's 36 layers (depth only: widths, vocabulary and traffic kept).
LM_LAYERS = 12
LM_TIMED_STEPS = 5            # decode steps timed (CUDA events) after 2 of warm-up
# Decode vs prefill at bf16: both round every product to bf16 in other
# shapes (and so other summation orders), and the differences grow over
# 36 layers; 0.25 is 8-16 bf16 ulps at the top logits (|logit| in 2..8).
LM_TOL = 0.25
# Phase 10: Zamba2-7B and xLSTM-350M behind ServingEngine (no head) as phase 9
# serves Qwen2.5-3B, and Whisper-small over a 30-second window of frames.
FAMILY_ARCHS = ("zamba2_7b", "xlstm_350m", "whisper_small")
# Cut (to keep the script inside its time limit with phase 13): a third of
# each model's depth, its structure kept: Zamba2-7B 27 of 81 layers (4
# groups of 6 Mamba2 blocks and the tail of 3), xLSTM-350M 8 of 24 (2 x
# [1 sLSTM + 3 mLSTM]), Whisper-small 4 of 12 encoder and decoder layers.
FAM_DEPTH = {"zamba2_7b": {"num_layers": 27}, "xlstm_350m": {"num_layers": 8},
             "whisper_small": {"num_layers": 4, "encoder_layers": 4}}
FAM_BATCH, FAM_PROMPT, FAM_GEN, FAM_MAX_SEQ = 64, 16, 32, 128
FAM_WHISPER_SEQ = 1500        # encoder frames of 30 s, and the decoder's positions
FAM_BLOCK_SEQ = 256           # two chunks of 128: the inter-chunk carry is used
FAM_TIMED_STEPS = 5
# Incremental decode vs the full-sequence pass at bf16 (the last prompt
# position's logits, |logit| up to about 5).  In float32 the two agree to
# 4e-5; at bf16 the chunked scan rounds its scores and outputs to bf16 where
# the decode step keeps a float32 state, and the differences grow with depth.
# A CPU rehearsal at full depth (d_model cut to 256, 64 rows) measured up to
# 0.81 over Zamba2's 81 Mamba2 blocks and 0.42 over xLSTM's 24 blocks; each
# tolerance is about twice that.  Whisper's 12 decoder layers against
# teacher forcing: LM_TOL (0.02 in the rehearsal).
FAM_TOL = {"hybrid": 1.5, "ssm": 0.75}
FAM_WHISPER_TOL = LM_TOL
# The first block of each recurrent kind at full width, chunked vs stepped
# 256 times (B = 2, inputs N(0, 0.25), |out| up to about 5).  Measured on the
# CPU: float32 5.2e-6, bf16 0.0625 (mamba), 0.055 (mLSTM), 0 (sLSTM: the
# same cell either way).
FAM_BLOCK_TOL_F32 = 1e-4
FAM_BLOCK_TOL_BF16 = 0.25
# Phase 11: SmolLM-360M trained at full width and depth, the run that the
# reference's launch/train.py documents for real hardware (--batch 32 --seq
# 2048), in 4 microbatches, with a checkpoint and a resume from that
# checkpoint alone to the last step.
TRAIN_ARCH = "smollm_360m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 32, 2048, 4
# Cut (to keep the script inside its time limit with phase 12): 3 steps with a
# checkpoint at 2 and a resume of 1, where the cell has 8 and a resume of 4.
TRAIN_STEPS, TRAIN_CKPT_AT, TRAIN_TIMED = 3, 2, 2
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
# Phase 13: phase 11's run resumed on a 2 x 2 ("data", "model") mesh of this
# card's positions, and the pipeline at S = 4 stages and M = 4 microbatches
# on a (4, 2, 1) ("stage", "data", "model") mesh, B 8 x S 2048 at float32
# (TF32 off): loss within rtol 1e-5, each gradient leaf within 1e-4 of
# max(its max |g|, 1), the bounds of the reference's pipeline test.
TRAIN_MESH = (2, 2)
PIPE_MESH, PIPE_MICRO = (4, 2, 1), 4
PIPE_BATCH, PIPE_SEQ = 8, 2048
PIPE_LOSS_RTOL, PIPE_GRAD_TOL = 1e-5, 1e-4


def log(*args) -> None:
    print(*args, flush=True)


class Check:
    """Collects failures of a phase; the phase raises if any were seen."""

    def __init__(self, phase: str):
        self.phase = phase
        self.failures: list = []

    def expect(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)
            log(f"  FAIL [{self.phase}] {what}")

    def done(self) -> None:
        if self.failures:
            raise SystemExit(f"phase {self.phase} failed: {len(self.failures)} checks")
        log(f"phase {self.phase}: ok")


def compare(kernel, plain, bitwise: bool, wider=None):
    """(ok, max_abs_err) of kernel vs plain (values, rows) tensors.

    Off the bitwise path a row id may differ only at a near-tie (2 * TOL)
    with another entry of the kernel's own list (two rows swapped).  At a
    list's last place the two walks' summation orders can also rank two rows
    whose scores are an ulp apart either way: ``wider()``, where given,
    returns the plain walk's (values, rows) at a larger k, and the kernel's
    row there is accepted if the plain walk places it past its own k-th
    entry with a score within 2 * TOL of that entry's and of the kernel's
    (so the plain version itself scores the row), and the row is in neither
    the plain list nor elsewhere in the kernel's."""
    kv, kr = (t.cpu().numpy() for t in kernel)
    pv, prow = (t.cpu().numpy() for t in plain)
    err = float(np.abs(kv.astype(np.float64) - pv).max()) if kv.size else 0.0
    if bitwise:
        return bool(np.array_equal(kv.view(np.int32), pv.view(np.int32))
                    and np.array_equal(kr, prow)), err
    ok = bool(np.allclose(kv, pv, rtol=TOL, atol=TOL))
    k = kv.shape[-1]
    va, ra = kv.reshape(-1, k), kr.reshape(-1, k)
    pa, pr = pv.reshape(va.shape), prow.reshape(va.shape)
    wide = None
    for i, j in zip(*np.nonzero(ra != pr)):
        gaps = np.abs(va[i] - va[i, j])
        gaps[j] = np.inf
        tie = bool(gaps.min() <= 2 * TOL)
        if not tie and wider is not None and j == k - 1:
            if wide is None:
                wide = [t.cpu().numpy().reshape(va.shape[0], -1) for t in wider()]
            row = ra[i, j]
            at = np.nonzero(wide[1][i, k:] == row)[0]
            score = float(wide[0][i, k + at[0]]) if at.size else np.nan
            tie = bool(at.size and row not in pr[i] and np.count_nonzero(ra[i] == row) == 1
                       and abs(score - float(pa[i, j])) <= 2 * TOL
                       and abs(score - float(va[i, j])) <= 2 * TOL)
        ok = ok and tie
    return ok, err


# ---------------------------------------------------------------------------
# Phase 2 fixtures (small; dyadic ones are exact in f32 in any summation order)
# ---------------------------------------------------------------------------

def dyadic_csr(bscsr, rng, n_rows, n_cols, max_len=12, empty_every=0, sign=0, lens=None):
    if lens is None:
        lens = rng.integers(1, max_len + 1, size=n_rows)
        if empty_every:
            lens[::empty_every] = 0
    lens = np.asarray(lens)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.concatenate([np.sort(rng.choice(n_cols, int(n), replace=False))
                          for n in lens if n]).astype(np.int32)
    data = rng.integers(-128, 128, size=int(lens.sum())) / 128.0
    if sign:
        data = sign * np.maximum(np.abs(data), 1 / 128)
    return bscsr.CSRMatrix(indptr, idx, data.astype(np.float32), (len(lens), n_cols))


def poison_padding(bscsr, words, block, fmt, rows_per_core, tagged=False):
    """Padding col ids past each core's last row set to 30,000 and -7.

    In a tagged width-class stream the header word comes first and each
    core's format is its header's code (``fmt`` is then ignored).
    """
    from repro_torch.core.quantization import FORMAT_BY_CODE

    out = words.copy()
    for c in range(words.shape[0]):
        f = FORMAT_BY_CODE[int(words[c, 0, 0])] if tagged else fmt
        vals, cols, flags = bscsr.defuse_stream(words[c], block, f, np.int16, tagged=tagged)
        row_ids = np.cumsum(bscsr.unpack_bits(flags, block).reshape(-1)) - 1
        pad = (row_ids >= rows_per_core[c]).reshape(cols.shape)
        cols = cols.copy()
        cols[pad] = 30_000
        half = pad.copy()
        half[::2] = False
        cols[half] = -7
        out[c] = bscsr.fuse_words(vals, cols, flags, tag=f.code if tagged else None)
    return out


def ties_csr(bscsr, rng):
    """Every row scores 3/8, 1/2 or below 0 at x = 1, and more than k rows a
    core score 1/2: the scratchpad is a tie broken by the lower slot."""
    lens = np.full(400, 3)
    lens[::11] = rng.integers(40, 70, size=len(lens[::11]))
    lens[5::13] = 4
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.concatenate([np.sort(rng.choice(80, int(n), replace=False))
                          for n in lens]).astype(np.int32)
    data = np.full(int(lens.sum()), 1 / 8, np.float32)
    data[np.repeat(lens > 4, lens)] = -1 / 128
    return bscsr.CSRMatrix(indptr, idx, data, (len(lens), 80))


def fixture_queries(rng, q, n_cols, bitwise, xsign):
    if xsign == "ties":
        xs = np.ones((q, n_cols))
        xs[1::3, ::2] = 0.5
        xs[2::3] = 2.0
    elif bitwise:
        lo = 1 if xsign == "positive" else -16
        xs = rng.integers(lo, 17, size=(q, n_cols)) / 8.0
    else:
        xs = rng.standard_normal((q, n_cols))
    return xs.astype(np.float32)


def stream_checks(torch, K, check, errs, name, w, fmt, block, t, n_rows, live, n_cols,
                  bitwise, xsign, rng):
    """One fused stream through all three kernels against their plain
    versions: the single-query kernel at Q = 1 and the multi-query kernel at
    Q in {1, 3, 37, 64}, each at S in {card, 1, 64} (and every S against its
    S = 1 bits), the accumulate kernel at the same S (slots that never
    complete read exactly 0.0).  Returns the number of comparisons."""
    kw = dict(k=8, n_rows=n_rows, packets_per_step=t, fmt_name=fmt, block_size=block)
    n_checks = 0
    for q in PARITY_QS:
        x = torch.from_numpy(fixture_queries(rng, q, n_cols, bitwise, xsign)).to(w.device)
        if q == 1:
            # The single-query kernel at the card's S, at one split and at
            # 64: each against the plain single walk, and every S against
            # S = 1 bit for bit.
            want = K.bscsr_topk_spmv_plain(x[0], w, **kw)
            one = K.bscsr_topk_spmv(x[0], w, splits=1, **kw)
            for splits in (None, 1, 64):
                got = K.bscsr_topk_spmv(x[0], w, splits=splits, **kw)
                torch.cuda.synchronize()
                ok, err = compare(got, want, bitwise)
                errs["bscsr_topk_spmv"] = max(errs["bscsr_topk_spmv"], err)
                check.expect(ok, f"{name} Q=1 S={splits}: single-query kernel != plain "
                                 f"(max err {err:.3g})")
                check.expect(compare(got, one, True)[0],
                             f"{name} Q=1 S={splits}: single-query kernel != its S=1 bits")
                n_checks += 1
        # The multi-query kernel at the card's S, at one split and at 64:
        # each against plain, and every S against S = 1 bit for bit.
        want = K.bscsr_topk_spmv_multiquery_plain(x, w, **kw)
        one = K.bscsr_topk_spmv_multiquery(x, w, splits=1, **kw)
        for splits in (None, 1, 64):
            got = K.bscsr_topk_spmv_multiquery(x, w, splits=splits, **kw)
            torch.cuda.synchronize()
            ok, err = compare(got, want, bitwise)
            errs["bscsr_topk_spmv_multiquery"] = max(errs["bscsr_topk_spmv_multiquery"],
                                                     err)
            check.expect(ok, f"{name} Q={q} S={splits}: multi-query kernel != plain "
                             f"(max err {err:.3g})")
            check.expect(compare(got, one, True)[0],
                         f"{name} Q={q} S={splits}: multi-query kernel != its S=1 bits")
            n_checks += 1
    # The accumulate kernel on the same words, first query of the last batch,
    # at the card's S, at one split and at 64 (past the flagged steps of
    # these fixtures): each against plain, and every S against S = 1 bit for
    # bit.
    akw = dict(n_rows=n_rows, packets_per_step=t, fmt_name=fmt, block_size=block)
    want = K.bscsr_spmv_plain(x[0], w, **akw).cpu().numpy()
    one = K.bscsr_spmv(x[0], w, splits=1, **akw).cpu().numpy()
    never = np.arange(n_rows)[None, :] >= np.asarray(live)[:, None]
    for splits in (None, 1, 64):
        gv = K.bscsr_spmv(x[0], w, splits=splits, **akw).cpu().numpy()
        err = float(np.abs(gv.astype(np.float64) - want).max())
        errs["bscsr_spmv"] = max(errs["bscsr_spmv"], err)
        if bitwise:
            ok = np.array_equal(gv.view(np.int32), want.view(np.int32))
        else:
            ok = bool(np.allclose(gv, want, rtol=TOL, atol=TOL))
        check.expect(ok, f"{name} S={splits}: accumulate kernel != plain "
                         f"(max err {err:.3g})")
        check.expect(np.array_equal(gv.view(np.int32), one.view(np.int32)),
                     f"{name} S={splits}: accumulate kernel != its S=1 bits")
        check.expect(bool((gv.view(np.int32)[never] == 0).all()),
                     f"{name} S={splits}: a slot that never completes is not 0.0")
        n_checks += 1
    return n_checks


def parity_phase(torch, K, ops, bscsr, errs):
    check = Check("parity")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    cases = []
    for fmt in FORMATS:
        for block, t, n_cols in ((32, 1, 64), (256, 2, 512), (64, 2, 40_000)):
            csr = dyadic_csr(bscsr, rng, 600, n_cols, empty_every=9)
            cases.append((f"dyadic {fmt} B={block} T={t} M={n_cols}", csr, fmt, block,
                          t, 5, True, "mixed", None))
        rand = bscsr.synthetic_embedding_csr(2000, 512, 20, "gamma", seed=1)
        cases.append((f"random {fmt} B=256 T=2", rand, fmt, 256, 2, 4, False, "mixed",
                      None))
    cases.append(("all-negative, padded budget", dyadic_csr(bscsr, rng, 60, 64, sign=-1),
                  "Q7", 32, 2, 2, True, "positive", "pad"))
    cases.append(("row over 5 packets, cores < k rows",
                  dyadic_csr(bscsr, rng, 7, 200, lens=[3, 150, 2, 0, 5, 1, 4]),
                  "Q15", 32, 1, 3, True, "mixed", None))
    cases.append(("poisoned padding ids", dyadic_csr(bscsr, rng, 30, 64), "BF16", 32, 2,
                  2, True, "mixed", "poison"))
    n_checks = 0
    for name, csr, fmt, block, t, cores, bitwise, xsign, edit in cases:
        packed = ops.pack_partitions(csr, cores, block, fmt, packets_multiple=t,
                                     stream_layout="fused")
        words, n_rows = packed.words, packed.max_slots
        if edit == "pad":
            words = np.concatenate([words, np.zeros((cores, 4, words.shape[2]),
                                                    np.int32)], 1)
            n_rows *= 4
        elif edit == "poison":
            words = poison_padding(bscsr, words, block, fmt, packed.candidate_slots)
        n_checks += stream_checks(torch, K, check, errs, name, torch.from_numpy(words).to(dev),
                                  fmt, block, t, n_rows, packed.candidate_slots, csr.shape[1],
                                  bitwise, xsign, rng)
    n_tagged = tagged_parity(torch, K, ops, bscsr, errs, check, rng)
    log(f"  {n_checks} kernel/plain comparisons on uniform streams, {n_tagged} on tagged "
        f"width classes (TAG4, TAG2 with BF16 and Q15 cores, TAG1)")
    check.done()


def tagged_parity(torch, K, ops, bscsr, errs, check, rng) -> int:
    """Phase 2 on mixed-precision snapshots: every kernel on every width
    class against its plain version (dyadic bit for bit, random within TOL),
    with poisoned padding, all-negative scores under a padded budget and
    ties at the k-th place; then the grouped dispatch (one launch per class)
    against the same snapshot's f32 twins as one F32 stream, bit for bit."""
    dev = torch.device("cuda")
    cases = []
    for block, t, n_cols in ((32, 1, 64), (256, 2, 512), (64, 2, 40_000)):
        csr = dyadic_csr(bscsr, rng, 1200, n_cols, empty_every=9)
        cases.append((f"tagged dyadic B={block} T={t} M={n_cols}", csr, MIXED8, block, t,
                      True, "mixed", None))
    rand = bscsr.synthetic_embedding_csr(4000, 512, 20, "gamma", seed=2)
    cases.append(("tagged random B=256 T=2", rand, MIXED8, 256, 2, False, "mixed", None))
    cases.append(("tagged all-negative, padded budget",
                  dyadic_csr(bscsr, rng, 120, 64, sign=-1), MIXED8, 32, 2, True, "positive",
                  "pad"))
    cases.append(("tagged poisoned padding ids", dyadic_csr(bscsr, rng, 80, 64), MIXED8, 32,
                  2, True, "mixed", "poison"))
    cases.append(("tagged ties at the k-th place", ties_csr(bscsr, rng), ("BF16", "Q15"),
                  32, 1, True, "ties", None))
    n_checks = 0
    for name, csr, formats, block, t, bitwise, xsign, edit in cases:
        packed = ops.pack_partitions(csr, len(formats), block, packets_multiple=t,
                                     stream_layout="fused", value_formats=formats)
        live_all = np.asarray(packed.candidate_slots)
        for g in packed.groups:
            words, n_rows, live = g.words, packed.max_slots, live_all[list(g.cores)]
            if edit == "pad":
                words = np.concatenate([words, np.zeros((len(g.cores), 4, words.shape[2]),
                                                        np.int32)], 1)
                n_rows *= 4
            elif edit == "poison":
                words = poison_padding(bscsr, words, block, None, live, tagged=True)
            n_checks += stream_checks(
                torch, K, check, errs, f"{name} {g.class_name}",
                torch.from_numpy(words).to(dev), g.class_name, block, t, n_rows, live,
                csr.shape[1], bitwise, xsign, rng)
        if edit is not None:
            continue
        twins = dataclasses.replace(packed, stream_layout="split")
        xs = fixture_queries(rng, 8, csr.shape[1], bitwise, xsign)
        kw = dict(k=8, packets_per_step=t, device=dev)
        pairs = [("single", ops.topk_spmv_blocked(xs[0], packed, 16, **kw),
                  ops.topk_spmv_blocked(xs[0], twins, 16, **kw)),
                 ("batched", ops.topk_spmv_batched(xs, packed, 16, **kw),
                  ops.topk_spmv_batched(xs, twins, 16, **kw)),
                 ("accumulate",
                  (ops.bscsr_spmv_blocked(xs[0], packed, packets_per_step=t, device=dev),),
                  (ops.bscsr_spmv_blocked(xs[0], twins, packets_per_step=t, device=dev),))]
        torch.cuda.synchronize()
        for what, got, want in pairs:
            same = all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                                   b.view(torch.int32) if b.dtype == torch.float32 else b)
                       for a, b in zip(got, want))
            check.expect(same, f"{name}: grouped {what} dispatch != the f32 twins' bits")
            n_checks += 1
    return n_checks


# ---------------------------------------------------------------------------
# Timing helpers
# ---------------------------------------------------------------------------

def time_cuda(torch, fn, budget_s=2.0):
    """Mean device ms of ``fn`` over repeated launches, timed with CUDA events.

    A sleep kernel holds the stream while the launches are queued, so the
    events measure the device's time alone and not the host's time to
    enqueue each call (about 0.05 ms for a kernel wrapper: as long as the
    accumulate kernel itself).
    """
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    reps = int(min(50, max(3, budget_s * 1e3 / one)))
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms_per_call(torch, fn, reps=50):
    """Host milliseconds to enqueue one call of ``fn`` (no synchronize)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host


def median_ms(fn, reps=5) -> float:
    """Host-clock median ms of ``fn`` (which returns host arrays) after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def time_once(torch, fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def kernel_registers(report: str) -> dict:
    """{kernel: registers per thread} from nvcc's ``-Xptxas -v`` report."""
    regs, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = next((k for k in ("topk_spmv_mq_split_kernel", "topk_spmv_mq1_kernel",
                                     "topk_mq_merge_kernel",
                                     "topk_spmv_single_kernel", "spmv_accum_kernel",
                                     "spmv_fixup_kernel")
                         if k in m.group(1)), m.group(1))
            qc = re.search(r"ILi(\d+)E", m.group(1))      # the template's queries a block
            if qc:
                name += f"<{qc.group(1)}>"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
            name = None
    return regs


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", type=int, default=10_000_000,
                        help="collection rows (the deployment has 10M)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", choices=("accumulate", "lm", "families", "train"),
                        help="accumulate: phases 1 and 2 and the accumulate kernel's "
                             "timing on phase 6's streams (no solves); lm: phases 1 "
                             "and 9; families: phases 1 and 10; train: phases 1, 11 and 13; "
                             "then stop without the result line")
    args = parser.parse_args()

    # Phase 11 trains under torch.use_deterministic_algorithms, whose cuBLAS
    # calls need this workspace setting before the first one.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from repro_torch.core import bscsr
    from repro_torch.core.similarity import SparseEmbeddingIndex
    from repro_torch.core import topk_spmv as api
    from repro_torch.kernels import bscsr_topk_spmv as K
    from repro_torch.kernels import ops
    from repro_torch.configs.topk_spmv import CONFIG as deploy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # ---- phase 1: build ----
    t0 = time.time()
    lib = K.build_library(verbose=True)
    K._library()
    log(f"phase build: ok ({time.time() - t0:.1f} s, {lib.name})")
    log("REGISTERS " + json.dumps(kernel_registers(lib.with_suffix(".log").read_text())))

    if args.only == "lm":
        lm = lm_phase(torch, K, api, args.seed)
        log("LM " + json.dumps(dict(lm, card=card_line())))
        log(f"ONLY lm: done in {time.time() - t_start:.1f} s (no result line)")
        return 0
    if args.only == "families":
        families = families_phase(torch, K, args.seed)
        log("FAMILIES " + json.dumps(dict(families, card=card_line())))
        log(f"ONLY families: done in {time.time() - t_start:.1f} s (no result line)")
        return 0
    if args.only == "train":
        trained = train_phase(torch, K, args.seed, ROOT / ".chip_tmp" / "train")
        log("TRAIN " + json.dumps(dict(trained, card=card_line())))
        gc.collect()
        torch.cuda.empty_cache()
        meshed_train = train_mesh_phase(torch, K, args.seed, ROOT / ".chip_tmp" / "train",
                                        trained)
        log("TRAIN_MESH " + json.dumps(dict(meshed_train, card=card_line())))
        log(f"ONLY train: done in {time.time() - t_start:.1f} s (no result line)")
        return 0

    # ---- phase 2: kernels vs plain versions on small fixtures ----
    phase_s, clock = {"build": round(time.time() - t_start, 1)}, [time.time()]

    def lap(name: str) -> None:
        """Each phase's seconds, for the ``PHASES`` line."""
        now = time.time()
        phase_s[name] = round(now - clock[0], 1)
        clock[0] = now

    errs = {"bscsr_topk_spmv": 0.0, "bscsr_topk_spmv_multiquery": 0.0, "bscsr_spmv": 0.0}
    parity_phase(torch, K, ops, bscsr, errs)
    if args.only == "accumulate":
        from repro_torch.core import graph
        from repro_torch.serve import GraphRankingService

        csr, _, fac, svc = graph_fixture(api, graph, SparseEmbeddingIndex,
                                         GraphRankingService, GRAPH_NODES, "cuda")
        pre = {"words": np.array(fac.index.packed.words),
               "n_rows": fac.index.packed.max_slots}
        update_node(svc, csr)
        entry = accumulate_timing(torch, K, bscsr, fac, pre, errs, {"bscsr_spmv": 0})
        log(json.dumps({"kernels": [entry]}))
        log(card_line())
        log(f"ONLY accumulate: done in {time.time() - t_start:.1f} s (no result line)")
        return 0

    # ---- phase 3: the main path at the deployment configuration ----
    lap("parity")
    check = Check("main path")
    if args.rows != 10_000_000:
        log(f"CUT: n_rows {args.rows} instead of 10000000 (depth only)")
    t0 = time.time()
    csr = bscsr.synthetic_embedding_csr(args.rows, deploy.n_cols, deploy.mean_nnz_per_row,
                                        deploy.distribution, seed=args.seed)
    log(f"  collection: {csr.shape[0]} x {csr.shape[1]}, nnz {csr.nnz} "
        f"({time.time() - t0:.1f} s)")
    cfg = api.TopKSpMVConfig(big_k=deploy.big_k, k=deploy.k, block_size=deploy.block_size,
                             value_format=deploy.value_format, packets_per_step=2,
                             stream_layout="fused", device="cuda")
    t0 = time.time()
    svc = SparseEmbeddingIndex(csr, cfg)          # the mutable index
    index = svc.index
    packed = index.packed
    log(f"  SparseEmbeddingIndex (mutable) build: {time.time() - t0:.1f} s, "
        f"c={packed.num_cores} P={packed.vals.shape[1]} "
        f"stream {packed.stream_bytes / 1e9:.3f} GB ({packed.bytes_per_nnz:.3f} B/nnz)")
    check.expect(packed.num_cores == 32, f"c = {packed.num_cores}, expected 32")
    rng = np.random.default_rng(args.seed + 1)
    xs64 = rng.standard_normal((64, 512)).astype(np.float32)
    executor = api.query_executor(cfg)
    svc.query(xs64[0])                            # pins the snapshot
    topk_spmv_warm = api.topk_spmv(index, torch.from_numpy(xs64[0]).cuda())

    # distributed_topk_spmv_fn on this index (no extra build), before the
    # main path's counts open: the core dim over a ("data",) mesh of four
    # positions on this card.  Its launches are its own entry point's.
    from repro_torch.launch.mesh import DeviceMesh

    dmesh = DeviceMesh(np.array([torch.device("cuda", 0)] * DIST_POSITIONS, dtype=object),
                       ("data",))
    K.reset_launch_counts()
    fn, arrays = api.distributed_topk_spmv_fn(index, dmesh)
    dist_one = fn(torch.from_numpy(xs64[0]).cuda(), *arrays)
    fn, arrays = api.distributed_topk_spmv_fn(index, dmesh, batched=True)
    dist_64 = fn(torch.from_numpy(xs64).cuda(), *arrays)
    del fn, arrays
    torch.cuda.synchronize()
    dist_launches = launch_counts(K)
    copies_before = executor.h2d_copies

    K.reset_launch_counts()
    t0 = time.time()
    single = [svc.query(xs64[i]) for i in range(3)]
    batch8 = svc.query_batch(xs64[:8])
    batch64 = svc.query_batch(xs64)
    direct = api.topk_spmv(index, torch.from_numpy(xs64[0]).cuda())
    torch.cuda.synchronize()
    main_s = time.time() - t0
    log(f"  main path: {main_s * 1e3:.1f} ms host clock")
    check.expect(executor.h2d_copies == copies_before,
                 f"h2d_copies moved in steady state: {copies_before} -> "
                 f"{executor.h2d_copies}")
    check.expect(all(np.array_equal(a, b) for a, b in zip(
        (t.cpu().numpy() for t in topk_spmv_warm), (t.cpu().numpy() for t in direct))),
        "repeated topk_spmv answers differ")

    # Against the torch oracle (the reference path), one query at a time.
    def against_oracle(answers, deleted=frozenset()):
        worst = 0.0
        for x, (v, r) in answers:
            ov, orow = api.topk_spmv(svc.index, torch.from_numpy(x).cuda(),
                                     use_kernel=False)
            ok, err = compare((torch.from_numpy(np.asarray(v)),
                               torch.from_numpy(np.asarray(r))), (ov, orow), bitwise=False)
            worst = max(worst, err)
            check.expect(ok, f"main path answer differs from the oracle (max err {err:.3g})")
            check.expect(not deleted & set(np.asarray(r).tolist()),
                         "a deleted row id was returned")
        return worst

    def all_answers(single, batch8, batch64, direct=None):
        answers = [(xs64[i], single[i]) for i in range(len(single))]
        answers += [(xs64[i], (batch8[0][i], batch8[1][i])) for i in range(8)]
        answers += [(xs64[i], (batch64[0][i], batch64[1][i])) for i in range(64)]
        if direct is not None:
            answers += [(xs64[0], tuple(t.cpu().numpy() for t in direct))]
        return answers

    dist_ok = same_bits(dist_one, direct), same_bits(dist_64, batch64)
    log(f"  distributed_topk_spmv_fn over {dmesh.shape} on this card: single == topk_spmv "
        f"{dist_ok[0]}, batched Q = 64 == topk_spmv_batched {dist_ok[1]} (launches "
        f"{dist_launches})")
    check.expect(all(dist_ok), "distributed_topk_spmv_fn differs from the executor's answers")
    for name in ("bscsr_topk_spmv", "bscsr_topk_spmv_multiquery"):
        check.expect(dist_launches[name] > 0,
                     f"{name} was not launched by distributed_topk_spmv_fn")

    # Phases 8 and 12 replay this path sharded and hold their answers to these.
    kept = {"before": (single[0], batch8, batch64, tuple(t.cpu().numpy() for t in direct))}
    answers = all_answers(single, batch8, batch64, direct)
    worst = against_oracle(answers)
    log(f"  {len(answers)} answers vs the torch oracle: max abs err {worst:.3g}")

    expected = index.expected_precision
    precisions = []
    for i in range(3):
        _, exact_rows = api.topk_spmv_exact(csr, xs64[i], cfg.big_k)
        precisions.append(len(set(single[i][1].tolist()) & set(exact_rows.tolist()))
                          / cfg.big_k)
    mean_p = float(np.mean(precisions))
    log(f"  precision@{cfg.big_k} vs exact search: {precisions} (mean {mean_p:.3f}); "
        f"expected {expected:.4f}")
    check.expect(mean_p >= expected - 0.02, "precision below expected - 0.02")
    for v, r in single:
        check.expect(v.shape == (100,) and np.isfinite(v).all()
                     and (r >= 0).all() and (r < args.rows).all(),
                     "query() output is not 100 finite scores over valid rows")

    # End-to-end host-clock latency of the facade (after warm-up).
    e2e = {"query_ms": median_ms(lambda: svc.query(xs64[0])),
           "query_batch_q8_ms": median_ms(lambda: svc.query_batch(xs64[:8])),
           "query_batch_q64_ms": median_ms(lambda: svc.query_batch(xs64))}
    log("END_TO_END " + json.dumps(e2e))

    # Serve while ingesting: 64 new rows, 64 deleted, then the same queries.
    # The old snapshot must die with the swap for its signature to count as
    # retraced, so this scope keeps a device copy of its words (phase 4
    # times the kernels on them, as before ingest) and lets go of it.
    words = torch.from_numpy(np.ascontiguousarray(packed.words)).cuda()
    main_slots, main_nnz, main_cores = packed.max_slots, packed.nnz, packed.num_cores
    del packed
    retraces_before = executor.retraces
    signature_before = index.packed.signature_info()
    new_rows = rng.standard_normal((64, 512)).astype(np.float32)
    deleted = frozenset(int(i) for i in rng.choice(args.rows, 64, replace=False))
    t0 = time.perf_counter()
    new_ids = svc.upsert(new_rows)
    upsert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc.delete(sorted(deleted))
    delete_s = time.perf_counter() - t0
    check.expect(list(new_ids) == list(range(args.rows, args.rows + 64)),
                 "upsert did not assign the next 64 ids")
    single = [svc.query(xs64[i]) for i in range(3)]
    batch8 = svc.query_batch(xs64[:8])
    batch64 = svc.query_batch(xs64)
    kept["after_ingest"] = (single[0], batch8, batch64)
    answers = all_answers(single, batch8, batch64)
    worst = against_oracle(answers, deleted)
    first_retraces = executor.retraces - retraces_before
    signature_after = index.packed.signature_info()
    kept["mutations"] = {"new_rows": new_rows, "deleted": sorted(deleted), "upserts": []}
    for i in range(3):                            # further ingest: no retrace
        rows8 = rng.standard_normal((8, 512)).astype(np.float32)
        kept["mutations"]["upserts"].append(rows8)
        svc.upsert(rows8)
        last = (svc.query(xs64[i]), svc.query_batch(xs64[:8]), svc.query_batch(xs64))
        api.topk_spmv(svc.index, torch.from_numpy(xs64[i]).cuda(), use_kernel=False)
    kept["after_upserts"] = last
    later_retraces = executor.retraces - retraces_before - first_retraces
    stats = svc.stats()
    torch.cuda.synchronize()
    launches = {"bscsr_topk_spmv": K.bscsr_topk_spmv.launches,
                "bscsr_topk_spmv_multiquery": K.bscsr_topk_spmv_multiquery.launches}
    log(f"  ingest: upsert 64 rows {upsert_s:.2f} s, delete 64 rows {delete_s:.2f} s; "
        f"{len(answers)} answers after it vs the oracle: max abs err {worst:.3g}")
    log(f"  signature {signature_before} -> {signature_after}; retraces at the first "
        f"mutation {first_retraces}, over 3 more upserts {later_retraces}")
    log(f"  stats: version {stats.version}, delta_fraction {stats.delta_fraction:.2e}, "
        f"tombstones {stats.tombstone_count}, deleted {stats.deleted_rows}")
    log(f"  launches on the main path: {launches}")
    check.expect(1 <= first_retraces <= 4,
                 f"{first_retraces} retraces at the first mutation (one per dispatch key)")
    check.expect(later_retraces == 0, f"{later_retraces} retraces after the first mutation")
    check.expect(stats.deleted_rows == 64 and stats.n_rows == args.rows + 64 + 24 - 64,
                 f"stats after ingest: {stats}")
    for name, n in launches.items():
        check.expect(n > 0, f"{name} was not launched on the main path")
    check.done()

    # ---- phase 4: timings of the top-k kernels on the main path's streams ----
    lap("main path")
    # On the snapshot before ingest (the exact packet count, as in earlier
    # runs) and on the snapshot after it (the churn-stable packet bucket),
    # each kernel against its plain version.
    check = Check("timings")
    kw = dict(k=cfg.k, n_rows=main_slots, packets_per_step=cfg.packets_per_step,
              fmt_name="BF16", block_size=cfg.block_size)
    x1 = torch.from_numpy(xs64[0]).cuda()
    x64 = torch.from_numpy(xs64).cuda()
    packed = svc.index.packed
    snaps = (("before ingest", words, main_slots),
             ("after ingest", torch.from_numpy(np.ascontiguousarray(packed.words)).cuda(),
              packed.max_slots))
    ingest_packets = packed.vals.shape[1]
    del packed

    def bound(q):
        """(bound ms, bound_by) of a Q-query pass over the main path's stream."""
        nbytes = words.numel() * 4 + q * 512 * 4 + main_cores * q * cfg.k * 8
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = 2.0 * main_nnz * q / F32_FLOPS * 1e3
        return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"

    kernels = [single_timing(torch, K, snaps, x1, kw, check, errs, launches, bound),
               multiquery_timing(torch, K, snaps, x64, kw, check, errs, launches, bound)]
    for entry in kernels:
        entry["packets_after_ingest"] = ingest_packets
    mq1 = kernels[1]["ms_by_q"][1], kernels[1]["ms_after_ingest_by_q"][1]
    log(f"  bscsr_topk_spmv against the multi-query kernel at Q=1: {kernels[0]['ms']:.3f} / "
        f"{mq1[0]:.3f} ms before ingest, {kernels[0]['ms_after_ingest']:.3f} / {mq1[1]:.3f} "
        f"ms after")
    del snaps
    check.done()

    # Yardstick: the exact-search score pass (not the same function: it
    # scores every row; the partitioned top-k has no single PyTorch call).
    crow = torch.from_numpy(csr.indptr).cuda()
    col = torch.from_numpy(csr.indices.astype(np.int64)).cuda()
    val = torch.from_numpy(csr.data).cuda()
    mat = torch.sparse_csr_tensor(crow, col, val, size=csr.shape)
    yard = {}
    for q, x in ((1, x1[:, None]), (64, x64.T.contiguous())):
        yard[f"q{q}_ms"] = time_cuda(
            torch, lambda: torch.topk(torch.sparse.mm(mat, x), cfg.big_k, dim=0))
    del mat, crow, col, val
    query_count = dryrun_query_count(torch, K, words, x64, kw, main_cores)
    del words
    gc.collect()
    torch.cuda.empty_cache()
    log("YARDSTICK exact-search score pass torch.sparse.mm(csr, x) + torch.topk: "
        + json.dumps(yard))

    # ---- phase 7: the serving plane on phase 3's facade ----
    lap("timings")
    t0 = time.time()
    serving = serving_phase(torch, K, api, svc, xs64, deleted, np.random.default_rng(args.seed + 7),
                            ROOT / ".chip_tmp" / "serving_store")
    log(f"  serving phase {time.time() - t0:.1f} s")
    kernels[1]["launches_serving_path"] = serving["launches"]
    kernels[1]["launches"] += serving["launches"]
    del svc, index
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 8: the query cell, the graph cell and the head on 4 shards ----
    lap("serving")
    from repro_torch.core import graph
    from repro_torch.serve import GraphRankingService

    gcsr = graph_operator(graph, GRAPH_NODES)
    phase4 = {"mq_ms_by_q": kernels[1]["ms_after_ingest_by_q"],
              "single_ms": kernels[0]["ms_after_ingest"]}
    t0 = time.time()
    sharded = sharded_phase(torch, K, api, graph, SparseEmbeddingIndex, GraphRankingService,
                            csr, cfg, xs64, kept, phase4, gcsr, args.seed)
    log(f"  sharded phase {time.time() - t0:.1f} s")
    for entry in kernels:
        entry["launches_sharded_path"] = sharded["launches"][entry["name"]]
        entry["launches"] += sharded["launches"][entry["name"]]
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 12: the mesh dispatch (2 replicas x 4 shards on this card) ----
    lap("sharded")
    t0 = time.time()
    meshed = mesh_phase(torch, K, api, SparseEmbeddingIndex, GraphRankingService, csr, cfg,
                        xs64, kept, sharded, gcsr)
    meshed["phase_s"] = time.time() - t0
    log(f"  mesh phase {meshed['phase_s']:.1f} s")
    for entry in kernels:
        entry["launches_mesh_path"] = meshed["launches"][entry["name"]]
        entry["launches"] += meshed["launches"][entry["name"]]
    del sharded["head_inputs"], sharded["head_answers"]
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 5: mixed precision on the first MIXED_ROWS rows of the query cell ----
    lap("mesh")
    if args.rows < MIXED_ROWS or args.seed != 0:
        csr = bscsr.synthetic_embedding_csr(10_000_000, 512, 20.0, "gamma", seed=0)
    csr = bscsr.CSRMatrix(csr.indptr[:MIXED_ROWS + 1].copy(),
                          csr.indices[:csr.indptr[MIXED_ROWS]].copy(),
                          csr.data[:csr.indptr[MIXED_ROWS]].copy(), (MIXED_ROWS, csr.shape[1]))
    log(f"CUT: the mixed phase runs on the first {MIXED_ROWS} rows of phase 3's collection "
        f"(depth only; widths, row lengths, hot/cold scaling, recall target and k kept)")
    t0 = time.time()
    mixed = mixed_phase(torch, csr, cfg, K, ops, bscsr, api, SparseEmbeddingIndex, errs)
    log(f"  mixed phase {time.time() - t0:.1f} s")
    del csr
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 6: the graph path at full width ----
    lap("mixed")
    gsvc, spmv_launches, pre = graph_phase(K, api, graph, SparseEmbeddingIndex,
                                           GraphRankingService, csr=gcsr,
                                           sharded_cold=(
                                               (f"phase 8's on {SHARDS} shards", sharded["ppr"]),
                                               ("phase 12's on the 2 x 4 mesh", meshed["ppr"])))
    launches["bscsr_spmv"] = spmv_launches

    # ---- phase 4 (continued): the accumulate kernel on phase 6's streams ----
    kernels.append(accumulate_timing(torch, K, bscsr, gsvc, pre, errs, launches))
    for path, res in (("sharded", sharded), ("mesh", meshed)):
        kernels[2][f"launches_{path}_path"] = res["launches"]["bscsr_spmv"]
        kernels[2]["launches"] += res["launches"]["bscsr_spmv"]
    del gsvc
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 9: the LM serving path at Qwen2.5-3B's full width ----
    lap("graph")
    t0 = time.time()
    lm = lm_phase(torch, K, api, args.seed)
    log(f"  lm phase {time.time() - t0:.1f} s")
    for entry in kernels:
        entry["launches_lm_path"] = lm["launches"][entry["name"]]
        entry["launches"] += lm["launches"][entry["name"]]
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 10: Zamba2-7B, xLSTM-350M and Whisper-small at full width ----
    lap("lm")
    t0 = time.time()
    families = families_phase(torch, K, args.seed)
    log(f"  families phase {time.time() - t0:.1f} s")
    for entry in kernels:
        entry["launches_families_path"] = families["launches"][entry["name"]]
        entry["launches"] += families["launches"][entry["name"]]
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 11: SmolLM-360M trained at full width and depth ----
    lap("families")
    t0 = time.time()
    trained = train_phase(torch, K, args.seed, ROOT / ".chip_tmp" / "train")
    log(f"  train phase {time.time() - t0:.1f} s")
    for entry in kernels:
        entry["launches_train_path"] = trained["launches"][entry["name"]]
        entry["launches"] += trained["launches"][entry["name"]]
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 13: the training mesh at SmolLM-360M's full width and depth ----
    lap("train")
    t0 = time.time()
    meshed_train = train_mesh_phase(torch, K, args.seed, ROOT / ".chip_tmp" / "train", trained)
    log(f"  train mesh phase {time.time() - t0:.1f} s")
    for entry in kernels:
        entry["launches_train_mesh_path"] = meshed_train["launches"][entry["name"]]
        entry["launches"] += meshed_train["launches"][entry["name"]]
    for entry in kernels:
        entry["launches_distributed_path"] = dist_launches[entry["name"]]
        entry["launches"] += dist_launches[entry["name"]]
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 14: the dry run against the card's own counts ----
    lap("train mesh")
    t0 = time.time()
    dry = dryrun_phase(torch, K, args.seed, query_count, lm.pop("dryrun_count"),
                       {"query_ms": kernels[1]["ms_by_q"][64], "trained": trained,
                        "lm": lm})
    dry["phase_s"] = time.time() - t0
    log(f"  dryrun phase {dry['phase_s']:.1f} s")
    lap("dryrun")
    for entry in kernels:
        entry["launches_dryrun_path"] = dry["launches"][entry["name"]]
        entry["launches"] += dry["launches"][entry["name"]]
    log(f"total {time.time() - t_start:.1f} s")
    log("PHASES " + json.dumps(dict(phase_s, total=round(time.time() - t_start, 1))))

    # ---- summary ----
    classes = list(FORMATS) + ["TAG4", "TAG2", "TAG1"]
    for entry in kernels:
        name = entry["name"]
        entry["classes"] = classes
        entry["launches_mixed_path"] = mixed["launches"][name]
        entry["mixed"] = {}
        for label in ("before", "after"):
            m = mixed[label]
            key = {"bscsr_topk_spmv": "single_ms", "bscsr_spmv": "accumulate_ms"}.get(name)
            if key is None:
                by_class = {c: e["ms_by_q"] for c, e in m["classes"].items()}
                total, bound = m["sum_ms_by_q"], m["bound_ms_by_q"]
            else:
                by_class = {c: e[key] for c, e in m["classes"].items()}
                total = m["sum_" + key]
                bound = m["bound_ms_by_q"][1] if key == "single_ms" else m["accumulate_bound_ms"]
            plain = "plain_accumulate_ms" if name == "bscsr_spmv" else "plain_ms_q64"
            entry["mixed"][label + "_ingest"] = {
                "ms_by_class": by_class, "ms_sum": total, "bound_ms": bound,
                "plain_ms_by_class": {c: e[plain] for c, e in m["classes"].items()}}
            if name == "bscsr_topk_spmv":
                entry["mixed"][label + "_ingest"]["splits_by_class"] = {
                    c: e["single_splits"] for c, e in m["classes"].items()}
    timing = sharded["timing"]
    kernels[0]["sharded"] = timing["single"]
    kernels[1]["sharded"] = {k: timing[k] for k in (
        "splits_by_q", "ms_by_shard_by_q", "ms_sum_by_q", "bound_ms_by_q")}
    kernels[2]["sharded"] = timing["accumulate"]
    mtiming = meshed["timing"]
    kernels[0]["mesh"] = mtiming["single"]
    kernels[1]["mesh"] = {k: mtiming[k] for k in (
        "splits_by_q", "ms_by_position_by_q", "ms_sum_by_q", "bound_ms_by_q")}
    kernels[2]["mesh"] = mtiming["accumulate"]
    log("MESH " + json.dumps({
        "mesh": meshed["mesh"], "positions_on": meshed["positions_on"],
        "phase_s": meshed["phase_s"], "build_s": meshed["build_s"],
        "first_pin_s": meshed["first_pin_s"], "first_pin": meshed["first_pin"],
        "ships": meshed["ships"], "bucket_jumps": meshed["bucket_jumps"],
        "retraces": meshed["retraces"], "bundle": meshed["bundle"],
        "launches": meshed["launches"], "end_to_end": meshed["end_to_end"],
        "end_to_end_per_shard": sharded["end_to_end"],
        "distributed_launches": dist_launches, "head_build_s": meshed["head_build_s"],
        "ppr": {k: v for k, v in meshed["ppr"].items() if k != "scores"},
        "timing": mtiming, "card": card_line()}))
    log("SHARDED " + json.dumps({
        "shards": sharded["shards"], "build_s": sharded["build_s"],
        "recover_ms": sharded["recover_ms"], "launches": sharded["launches"],
        "end_to_end": sharded["end_to_end"],
        "ppr": {k: v for k, v in sharded["ppr"].items() if k != "scores"},
        "head": sharded["head"], "timing": timing}))
    log("LM " + json.dumps(dict(lm, card=card_line())))
    log("FAMILIES " + json.dumps(dict(families, card=card_line())))
    log("TRAIN " + json.dumps(dict(trained, card=card_line())))
    log("TRAIN_MESH " + json.dumps(dict(meshed_train, card=card_line())))
    log("DRYRUN " + json.dumps(dict(dry, card=card_line())))
    log("MIXED " + json.dumps({k: mixed[k] for k in (
        "recall", "predicted_recall", "formats", "bytes_per_nnz", "value_bytes_per_nnz",
        "bf16_bytes_per_nnz", "bf16_value_bytes_per_nnz", "end_to_end")}))
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def single_timing(torch, K, snaps, x1, kw, check, errs, launches, bound) -> dict:
    """The single-query kernel (``topk_spmv``) on the snapshots before and
    after ingest, at the card's S (``single_splits``) and at one split,
    timed in turns with the split tables built beforehand, as the executor
    holds them.  At each snapshot the card's S must give the S = 1 bits and
    the multi-query kernel's at Q = 1 (the same tree and fold), and
    ``MQ_REPEATS`` more calls at each S the S = 1 bits again; before ingest
    both are held to the plain single walk (the one full-size plain call).
    """
    name = "bscsr_topk_spmv"
    t, block = kw["packets_per_step"], kw["block_size"]
    by = {}
    for label, words, n_rows in snaps:
        kwl = dict(kw, n_rows=n_rows)
        suffix = "_after_ingest" if label == "after ingest" else ""
        splits = K.single_splits(words.device, words.shape[0], packets_per_step=t,
                                 block_size=block, m=x1.shape[0], k=kw["k"],
                                 width=words.shape[2], fmt_name=kw["fmt_name"])
        mq_splits = K.topk_splits(words.device, words.shape[0], 1, packets_per_step=t,
                                  block_size=block, m=x1.shape[0], q_chunk=1, k=kw["k"])
        tabs = {s: K.spmv_split_table(words, packets_per_step=t, block_size=block,
                                      splits=s) for s in {splits, mq_splits, 1}}
        got = K.bscsr_topk_spmv(x1, words, table=tabs[splits], **kwl)
        one = K.bscsr_topk_spmv(x1, words, table=tabs[1], **kwl)
        mv, mr = K.bscsr_topk_spmv_multiquery(x1[None], words, table=tabs[mq_splits], **kwl)
        torch.cuda.synchronize()
        check.expect(compare(got, one, True)[0], f"{name} {label}: S={splits} and S=1 differ")
        check.expect(compare(got, (mv[:, 0], mr[:, 0]), True)[0],
                     f"{name} {label}: differs from the multi-query kernel at Q=1")
        if not suffix:
            by["plain_ms"], want = time_once(
                torch, lambda: K.bscsr_topk_spmv_plain(x1, words, **kwl))
            for s, out in ((splits, got), (1, one)):
                ok, err = compare(out, want, bitwise=False)
                errs[name] = max(errs[name], err)
                check.expect(ok, f"{name} S={s} {label} differs from plain (max err "
                                 f"{err:.3g})")
        for s in (splits, 1):
            reps = [K.bscsr_topk_spmv(x1, words, table=tabs[s], **kwl)
                    for _ in range(MQ_REPEATS)]
            torch.cuda.synchronize()
            bad = sum(not compare(r, one, True)[0] for r in reps)
            check.expect(bad == 0, f"{name} S={s} {label}: {bad} of {MQ_REPEATS} repeated "
                                   f"calls differ from the S=1 bits")
        # In turns: S, 1, 1, S.
        turns = [time_cuda(torch, lambda: K.bscsr_topk_spmv(x1, words, table=tabs[s], **kwl))
                 for s in (splits, 1, 1, splits)]
        by["ms" + suffix] = (turns[0] + turns[3]) / 2
        by["ms" + suffix + "_one_split"] = (turns[1] + turns[2]) / 2
        by["splits" + suffix] = splits
        log(f"  {name} Q=1 {label}: S={splits} {turns[0]:.3f} / {turns[3]:.3f} ms, S=1 "
            f"{turns[1]:.3f} / {turns[2]:.3f} ms ({words.shape[1]} packets per core), "
            f"ring of {K.SINGLE_RING_DEPTH} steps, max abs err {errs[name]:.3g}, bound "
            f"{bound(1)[0]:.3f} ms")
    ms = by["ms"]
    bound_ms, bound_by = bound(1)
    return {
        "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
        "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
        "plain_ms": by.pop("plain_ms"), "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "q": 1, "ms_by_q": {1: ms}, "ring_depth": K.SINGLE_RING_DEPTH,
        **by, "achieved_gb_per_s": snaps[0][1].numel() * 4 / (ms * 1e-3) / 1e9,
        "queries_per_s": 1 / (ms * 1e-3),
    }


def multiquery_timing(torch, K, snaps, x64, kw, check, errs, launches, bound) -> dict:
    """The multi-query kernel at every Q the main path gives it (1 for
    ``query``, 8 and 64 for ``query_batch``), on the snapshots before and
    after ingest, at the card's S (``topk_splits``) and at one split (the
    one-block walk, cut at e_c), timed in turns with the split tables built
    beforehand, as the executor holds them.  At each Q and snapshot the
    kernel is held against its plain version (one plain walk of the 64
    queries per snapshot), and the card's S against the
    S = 1 bits; then ``MQ_REPEATS`` more calls at each S must give those
    bits again (a race between warps would show only now and then).
    """
    name = "bscsr_topk_spmv_multiquery"
    t, block = kw["packets_per_step"], kw["block_size"]
    entry = {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
             "launches": launches[name], "library_ms": None}
    by = {"ms_by_q": {}, "ms_one_split_by_q": {}, "ms_after_ingest_by_q": {},
          "ms_after_ingest_one_split_by_q": {}, "plain_ms_by_q": {},
          "plain_ms_after_ingest_by_q": {}, "splits_by_q": {}, "q_chunk_by_q": {},
          "bound_ms_by_q": {}}
    for label, words, n_rows in snaps:
        kwl = dict(kw, n_rows=n_rows)
        after = label == "after ingest"
        # One plain walk of the 64 queries is the plain answer at every Q:
        # each query's walk is its own.
        plain_ms, want64 = time_once(
            torch, lambda: K.bscsr_topk_spmv_multiquery_plain(x64, words, **kwl))
        for q in (1, 8, 64):
            x = x64[:q].contiguous()
            q_chunk, n_chunks = K.query_chunks(q)
            splits = K.topk_splits(words.device, words.shape[0], n_chunks, packets_per_step=t,
                                   block_size=block, m=x.shape[1], q_chunk=q_chunk,
                                   k=kw["k"])
            build = lambda: K.spmv_split_table(words, packets_per_step=t,  # noqa: E731
                                               block_size=block, splits=splits)
            if q == 1:
                table_ms, table_host_ms = time_cuda(torch, build), host_ms_per_call(torch,
                                                                                     build)
                log(f"SPLIT_TABLE {label}: build {table_ms:.4f} ms on the device, "
                    f"{table_host_ms:.4f} ms of host enqueue (S = {splits}, once per "
                    f"snapshot)")
                entry["split_table_ms" + ("_after_ingest" if after else "")] = table_ms
            tabs = {s: K.spmv_split_table(words, packets_per_step=t, block_size=block,
                                          splits=s) for s in {splits, 1}}
            want = (want64[0][:, :q], want64[1][:, :q])
            got = K.bscsr_topk_spmv_multiquery(x, words, table=tabs[splits], **kwl)
            one = K.bscsr_topk_spmv_multiquery(x, words, table=tabs[1], **kwl)
            torch.cuda.synchronize()
            check.expect(compare(got, one, True)[0],
                         f"{name} Q={q} {label}: S={splits} and S=1 differ")
            for s, out in ((splits, got), (1, one)):
                ok, err = compare(out, want, bitwise=False)
                errs[name] = max(errs[name], err)
                check.expect(ok, f"{name} Q={q} S={s} {label} differs from plain "
                                 f"(max err {err:.3g})")
            for s in (splits, 1):
                reps = [K.bscsr_topk_spmv_multiquery(x, words, table=tabs[s], **kwl)
                        for _ in range(MQ_REPEATS)]
                torch.cuda.synchronize()
                bad = sum(not (torch.equal(v.view(torch.int32), one[0].view(torch.int32))
                               and torch.equal(r, one[1])) for v, r in reps)
                check.expect(bad == 0, f"{name} Q={q} S={s} {label}: {bad} of {MQ_REPEATS} "
                                       f"repeated calls differ from the S=1 bits")
            # In turns: S, 1, 1, S.
            turns = [time_cuda(torch, lambda: K.bscsr_topk_spmv_multiquery(
                x, words, table=tabs[s], **kwl)) for s in (splits, 1, 1, splits)]
            ms, ms_one = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            suffix = "_after_ingest" if after else ""
            by["ms" + suffix + "_by_q"][q] = ms
            by["ms" + suffix + "_one_split_by_q"][q] = ms_one
            by["splits_by_q"][q] = splits
            by["q_chunk_by_q"][q] = q_chunk
            by["bound_ms_by_q"][q] = bound(q)[0]
            log(f"  {name} Q={q} {label}: S={splits} (q_chunk {q_chunk}, {n_chunks} chunks) "
                f"{turns[0]:.3f} / {turns[3]:.3f} ms, S=1 {turns[1]:.3f} / {turns[2]:.3f} "
                f"ms, max abs err {errs[name]:.3g}, bound {bound(q)[0]:.3f} ms")
        by["plain_ms" + ("_after_ingest" if after else "") + "_by_q"][64] = plain_ms
        log(f"  {name} {label}: plain walk of the 64 queries {plain_ms:.1f} ms")
    q = 64
    ms = by["ms_by_q"][q]
    entry.update({
        "max_abs_err": errs[name], "ms": ms, "plain_ms": by["plain_ms_by_q"][q],
        "bound_ms": bound(q)[0], "bound_by": bound(q)[1], "q": q,
        "splits": by["splits_by_q"][q], "ms_after_ingest": by["ms_after_ingest_by_q"][q],
        "achieved_gb_per_s": snaps[0][1].numel() * 4 / (ms * 1e-3) / 1e9,
        "queries_per_s": q / (ms * 1e-3), **by,
    })
    return entry


def mixed_phase(torch, csr, cfg, K, ops, bscsr, api, SparseEmbeddingIndex, errs) -> dict:
    """Phase 5: recall-targeted mixed precision on ``csr`` (the query cell's
    first ``MIXED_ROWS`` rows).

    The collection scaled hot/cold as the reference's mixed-precision sweep
    does (the first c/4 partitions at full magnitude, the rest x 0.25), one
    format per partition for recall@8 >= 0.99 (16 calibration queries, seed
    0), served through the mutable facade: each width class streams its
    tagged words through its own launch of each kernel.  Checks, before and
    after ingest: each class through each kernel against its plain version,
    the facade's answers against the plain results merged, the grouped
    kernels against the f32 twins' bits; then recall@8 at big_k = k through
    the kernel, exact launch counts, retraces, formats and h2d_copies.
    Returns the per-kernel numbers for the ``kernels`` line.
    """
    from repro_torch.core import adaptive, partition
    from repro_torch.kernels import executor as executor_lib

    check = Check("mixed precision")
    dev = cfg.resolve_device()
    n_rows, n_cols = csr.shape
    c = cfg.resolve_partitions(n_rows)
    log(f"  {n_rows} rows, nnz {csr.nnz}: c = {c} (phase 3's c is 32)")
    check.expect(c == 32, f"c = {c} at {n_rows} rows, not phase 3's 32")
    hot_end = int(partition.PartitionPlan.build(n_rows, c).row_starts[c // 4])
    scales = np.ones(n_rows, np.float32)
    scales[hot_end:] = MIXED_COLD_SCALE
    t0 = time.time()
    mcsr = bscsr.scale_rows(csr, scales)
    svc = SparseEmbeddingIndex(mcsr, cfg, recall_target=MIXED_TARGET)
    build_s = time.time() - t0
    index = svc.index
    packed = index.packed
    bpn, vbpn = packed.bytes_per_nnz, packed.value_bytes_per_nnz
    nnz0, hist0 = packed.nnz, packed.format_histogram()
    # The uniform BF16 snapshot of the same partitions: every core padded to
    # the longest, B/32 flag, B/2 col and B/2 value words a packet.
    p_max, block = packed.vals.shape[1], packed.block_size
    bf16_bytes = c * p_max * (block // 32 + block) * 4
    bf16_value_bytes = c * p_max * block * 2
    log(f"  mixed facade build (calibration, three planes, groups): {build_s:.1f} s; "
        f"formats {packed.format_histogram()}, predicted recall@8 "
        f"{index.predicted_recall:.4f} (target {MIXED_TARGET})")
    log(f"  bytes per nnz {bpn:.4f} (value bytes {vbpn:.4f}) against uniform BF16 "
        f"{bf16_bytes / packed.nnz:.4f} (value bytes {bf16_value_bytes / packed.nnz:.4f})")
    check.expect(packed.is_heterogeneous and tuple(g.cores for g in packed.groups)
                 and sorted(sum((g.cores for g in packed.groups), ())) == list(range(c)),
                 "the mixed snapshot's width classes do not cover every core once")
    check.expect(bpn < bf16_bytes / packed.nnz, "mixed precision streams no fewer bytes "
                                                 "than uniform BF16")

    rng = np.random.default_rng(7)
    xs64 = rng.standard_normal((64, n_cols)).astype(np.float32)
    x64 = torch.from_numpy(xs64).to(dev)
    executor = api.query_executor(cfg)

    def drive():
        out = (svc.query(xs64[0]), svc.query_batch(xs64[:8]), svc.query_batch(xs64),
               api.topk_spmv(index, x64[0]))
        ex_sums = executor.spmv(x64[0], index.packed, alpha=1.0, beta=0.0,
                                y=torch.zeros(index.packed.n_rows_logical, device=dev))
        torch.cuda.synchronize()
        return out, ex_sums

    drive()                                      # pins the snapshot
    copies = executor.h2d_copies
    K.reset_launch_counts()
    drive()
    launches = {"bscsr_topk_spmv": K.bscsr_topk_spmv.launches,
                "bscsr_topk_spmv_multiquery": K.bscsr_topk_spmv_multiquery.launches,
                "bscsr_spmv": K.bscsr_spmv.launches}
    n_groups = len(packed.groups)
    log(f"  launches on the mixed path ({n_groups} width classes): {launches}")
    # One launch per class and call: query and two query_batch calls run
    # the multi-query kernel, topk_spmv the single-query one, spmv the
    # accumulate kernel.
    calls = {"bscsr_topk_spmv": 1, "bscsr_topk_spmv_multiquery": 3, "bscsr_spmv": 1}
    for name, n in launches.items():
        check.expect(n == calls[name] * n_groups,
                     f"{name}: {n} launches on the mixed path, not {calls[name]} calls x "
                     f"{n_groups} classes")
    check.expect(executor.h2d_copies == copies,
                 f"h2d_copies moved in steady state: {copies} -> {executor.h2d_copies}")

    # recall@8 through the kernel at big_k = k on the calibration queries
    # (the partition term of Eq. 1 is then zero), against exact search.
    xq = adaptive.sample_calibration_queries(mcsr, cfg.calibration_queries,
                                             cfg.calibration_seed)
    ex8 = executor_lib.get_executor(big_k=cfg.k, k=cfg.k,
                                    packets_per_step=cfg.packets_per_step, device=dev)
    _, rows = ex8.query_batched(torch.from_numpy(xq).to(dev), packed)
    mat = torch.sparse_csr_tensor(torch.from_numpy(mcsr.indptr).to(dev),
                                  torch.from_numpy(mcsr.indices.astype(np.int64)).to(dev),
                                  torch.from_numpy(mcsr.data).to(dev), size=mcsr.shape)
    exact = torch.topk(torch.sparse.mm(mat, torch.from_numpy(xq).to(dev).T), cfg.k,
                       dim=0).indices.T.cpu().numpy()
    del mat
    recall = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / cfg.k
                            for a, b in zip(rows.cpu().numpy(), exact)]))
    log(f"  recall@{cfg.k} through the kernel on the {len(xq)} calibration queries: "
        f"measured {recall:.4f}, predicted {index.predicted_recall:.4f}")
    check.expect(recall >= MIXED_TARGET - 0.02,
                 f"recall@8 {recall:.4f} below {MIXED_TARGET} - 0.02")

    e2e = {"query_ms": median_ms(lambda: svc.query(xs64[0])),
           "query_batch_q8_ms": median_ms(lambda: svc.query_batch(xs64[:8])),
           "query_batch_q64_ms": median_ms(lambda: svc.query_batch(xs64))}
    log("MIXED_END_TO_END " + json.dumps(e2e))

    def kernels_on(label, p):
        """Each kernel per class and in sum on snapshot ``p``, the facade's
        snapshot.  Every class's words go through the three plain versions
        on the same card tensors (phase 4's tolerances), the facade's
        answers and the executor's y = A x are held to those plain results
        merged, the grouped dispatch to the f32 twins' bits, and each
        kernel is timed per class."""
        snap = executor_lib.device_snapshot(p, "fused", executor.device)
        fin = ops.finalize_tensors(p, dev)
        t, n_slots, nc = cfg.packets_per_step, p.max_slots, p.num_cores
        kw = dict(packets_per_step=t, block_size=block, inner_loop="linear")
        x0 = x64[0]
        # Phase 6's bound on a slot sum's rounding: 16 ulps of a step's
        # largest total of |a x|.
        atol = 16 * 2.0 ** -24 * t * block * float(np.abs(p.vals).max()) \
            * float(x0.abs().max())
        out = {"classes": {}, "atol": atol}
        plain_mq = (torch.full((nc, 64, cfg.k), K.NEG_INF, device=dev),
                    torch.full((nc, 64, cfg.k), n_slots, dtype=torch.int32, device=dev))
        plain_sums = torch.zeros((nc, n_slots), device=dev)
        for cname, cores, words in snap.groups:
            cg = words.shape[0]
            kwc = dict(kw, n_rows=n_slots, fmt_name=cname)
            entry = {"cores": cores.tolist(), "packets": int(words.shape[1]),
                     "stream_bytes": words.numel() * 4, "ms_by_q": {}, "splits_by_q": {}}
            # Each kernel against its plain version on this class's words.
            # One plain walk of the 64 queries is the plain answer of both
            # top-k kernels: each query's walk is its own, and
            # bscsr_topk_spmv_plain is this walk on a batch of one.  The
            # plain walks run at one split, which ends each core's walk at
            # its last flagged step (the single walk's bits).
            name = "bscsr_topk_spmv_multiquery"
            entry["plain_ms_q64"], want = time_once(
                torch, lambda: K.bscsr_topk_spmv_multiquery_plain(x64, words, k=cfg.k,
                                                                  splits=1, **kwc))
            # The same plain walk at k + MIXED_WIDER_K, run only if a list's
            # last place differs, scores the kernel's row there.
            wide = functools.lru_cache(maxsize=None)(
                lambda: K.bscsr_topk_spmv_multiquery_plain(x64, words, k=cfg.k + MIXED_WIDER_K,
                                                           splits=1, **kwc))
            for q in (1, 8, 64):
                got = K.bscsr_topk_spmv_multiquery(x64[:q].contiguous(), words, k=cfg.k, **kwc)
                ok, err = compare(got, (want[0][:, :q], want[1][:, :q]), bitwise=False,
                                  wider=lambda: tuple(t[:, :q] for t in wide()))
                errs[name] = max(errs[name], err)
                check.expect(ok, f"{label} {cname}: {name} Q={q} differs from plain "
                                 f"(max err {err:.3g})")
            plain_mq[0][cores], plain_mq[1][cores] = want
            name = "bscsr_topk_spmv"
            ok, err = compare(K.bscsr_topk_spmv(x0, words, k=cfg.k, **kwc),
                              (want[0][:, 0], want[1][:, 0]), False,
                              wider=lambda: tuple(t[:, 0] for t in wide()))
            errs[name] = max(errs[name], err)
            check.expect(ok, f"{label} {cname}: {name} differs from plain (max err {err:.3g})")
            name = "bscsr_spmv"
            entry["plain_accumulate_ms"], want = time_once(
                torch, lambda: K.bscsr_spmv_plain(x0, words, splits=1, **kwc))
            err = float((K.bscsr_spmv(x0, words, **kwc).double() - want.double()).abs().max())
            errs[name] = max(errs[name], err)
            check.expect(err <= atol, f"{label} {cname}: {name} differs from plain (max err "
                                      f"{err:.3g}, atol {atol:.3g})")
            plain_sums[cores] = want
            log(f"  {label} {cname}: kernels vs plain: multi-query Q=1/8/64, single-query "
                f"and accumulate within tolerance (plain top-k walk of Q=64 "
                f"{entry['plain_ms_q64']:.0f} ms, accumulate {entry['plain_accumulate_ms']:.0f} "
                f"ms)")
            # Timed, in turns of the classes.
            for q in (1, 8, 64):
                x = x64[:q].contiguous()
                q_chunk, n_chunks = K.query_chunks(q)
                splits = K.topk_splits(dev, cg, n_chunks, packets_per_step=t, block_size=block,
                                       m=n_cols, q_chunk=q_chunk, k=cfg.k)
                table = K.spmv_split_table(words, packets_per_step=t, block_size=block,
                                           splits=splits, header=1)
                entry["ms_by_q"][q] = time_cuda(torch, lambda: K.bscsr_topk_spmv_multiquery(
                    x, words, k=cfg.k, table=table, **kwc), MIXED_BUDGET_S)
                entry["splits_by_q"][q] = splits
            ssplits = K.single_splits(dev, cg, packets_per_step=t, block_size=block, m=n_cols,
                                      k=cfg.k, width=words.shape[2], fmt_name=cname)
            stable = K.spmv_split_table(words, packets_per_step=t, block_size=block,
                                        splits=ssplits, header=1)
            entry["single_ms"] = time_cuda(torch, lambda: K.bscsr_topk_spmv(
                x0, words, k=cfg.k, table=stable, **kwc), MIXED_BUDGET_S)
            entry["single_splits"] = ssplits
            asplits = K.spmv_splits(dev, cg, packets_per_step=t, block_size=block, m=n_cols)
            atable = K.spmv_split_table(words, packets_per_step=t, block_size=block,
                                        splits=asplits, header=1)
            entry["accumulate_ms"] = time_cuda(torch, lambda: K.bscsr_spmv(
                x0, words, table=atable, **kwc), MIXED_BUDGET_S)
            entry["accumulate_splits"] = asplits
            out["classes"][cname] = entry
            log(f"  {label} {cname}: cores {entry['cores']}, {entry['packets']} packets, "
                f"{entry['stream_bytes'] / 1e9:.4f} GB, S {entry['splits_by_q']} (accumulate "
                f"{asplits}, single-query {ssplits}); multi-query Q=1/8/64 "
                + " / ".join(f"{entry['ms_by_q'][q]:.3f}" for q in (1, 8, 64))
                + f" ms, single-query {entry['single_ms']:.3f} ms, accumulate "
                f"{entry['accumulate_ms']:.4f} ms")

        # The facade and the executor on this snapshot against the plain
        # per-class results merged as the executor merges its candidates.
        want = ops.finalize_candidates_batched(*plain_mq, big_k=cfg.big_k, **fin)
        for q, got in ((1, tuple(a[None] for a in svc.query(xs64[0]))),
                       (8, svc.query_batch(xs64[:8])), (64, svc.query_batch(xs64))):
            ok, err = compare(tuple(torch.from_numpy(np.asarray(a)) for a in got),
                              (want[0][:q], want[1][:q]), bitwise=False)
            check.expect(ok, f"{label}: the facade's Q={q} answers differ from the plain "
                             f"candidates merged (max err {err:.3g})")
        ok, err = compare(api.topk_spmv(index, x0), ops.finalize_candidates(
            plain_mq[0][:, 0], plain_mq[1][:, 0], big_k=cfg.big_k, **fin), bitwise=False)
        check.expect(ok, f"{label}: topk_spmv differs from the plain candidates merged "
                         f"(max err {err:.3g})")
        y0 = torch.zeros(p.n_rows_logical, device=dev)
        want = ops.accumulate_epilogue(plain_sums, fin, p.n_rows_logical, 1.0, 0.0, y=y0)
        err = float((executor.spmv(x0, p, alpha=1.0, beta=0.0, y=y0).double()
                     - want.double()).abs().max())
        check.expect(err <= atol, f"{label}: the executor's y = A x differs from the plain "
                                  f"slot sums scattered (max err {err:.3g}, atol {atol:.3g})")
        log(f"  {label}: query, query_batch Q=8/64, topk_spmv and the executor's y = A x "
            f"held to the plain results merged (y max err {err:.3g}, atol {atol:.3g})")

        # Grouped vs the f32 twins as one F32 stream, bit for bit.
        twins = torch.from_numpy(bscsr.fuse_words(p.vals, p.cols, p.flags)).to(dev)
        for q in (1, 8, 64):
            x = x64[:q].contiguous()
            got = ops.grouped_local_topk(x, snap.groups, n_cores=nc, k=cfg.k, n_rows=n_slots,
                                         batched=True, **kw)
            want = K.bscsr_topk_spmv_multiquery(x, twins, k=cfg.k, n_rows=n_slots,
                                                fmt_name="F32", **kw)
            check.expect(compare(got, want, True)[0],
                         f"{label}: grouped multi-query Q={q} != the f32 twins' bits")
        got = ops.grouped_local_topk(x0, snap.groups, n_cores=nc, k=cfg.k,
                                     n_rows=n_slots, batched=False, **kw)
        want = K.bscsr_topk_spmv(x0, twins, k=cfg.k, n_rows=n_slots, fmt_name="F32", **kw)
        check.expect(compare(got, want, True)[0],
                     f"{label}: grouped single-query != the f32 twins' bits")
        got = ops.grouped_slot_sums(x0, snap.groups, n_cores=nc, n_rows=n_slots, **kw)
        want = K.bscsr_spmv(x0, twins, n_rows=n_slots, fmt_name="F32", **kw)
        torch.cuda.synchronize()
        n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        check.expect(n_diff == 0, f"{label}: grouped accumulate differs from the f32 "
                                  f"twins in {n_diff} sums")
        log(f"  {label}: grouped kernels vs the f32 twins ({twins.numel() * 4 / 1e9:.3f} "
            f"GB as one F32 stream): multi-query Q=1/8/64, single-query and accumulate "
            f"({n_diff} of {got.numel()} sums differ)")
        del twins
        cls = out["classes"].values()
        out["sum_ms_by_q"] = {q: sum(e["ms_by_q"][q] for e in cls) for q in (1, 8, 64)}
        out["sum_single_ms"] = sum(e["single_ms"] for e in cls)
        out["sum_accumulate_ms"] = sum(e["accumulate_ms"] for e in cls)
        stream = sum(e["stream_bytes"] for e in cls)
        out["stream_bytes"] = stream
        out["bound_ms_by_q"] = {}
        for q in (1, 8, 64):
            bytes_ms = (stream + q * n_cols * 4 + nc * q * cfg.k * 8) / HBM_BYTES_PER_S * 1e3
            flops_ms = 2.0 * p.nnz * q / F32_FLOPS * 1e3
            out["bound_ms_by_q"][q] = max(bytes_ms, flops_ms)
        out["accumulate_bound_ms"] = (stream + n_cols * 4 + nc * n_slots * 4) \
            / HBM_BYTES_PER_S * 1e3
        log(f"  {label} in sum over the classes: multi-query Q=1/8/64 "
            + " / ".join(f"{out['sum_ms_by_q'][q]:.3f}" for q in (1, 8, 64))
            + " ms (bounds " + " / ".join(f"{out['bound_ms_by_q'][q]:.3f}" for q in (1, 8, 64))
            + f" ms), single-query {out['sum_single_ms']:.3f} ms (bound "
            f"{out['bound_ms_by_q'][1]:.3f}), accumulate {out['sum_accumulate_ms']:.4f} ms "
            f"(bound {out['accumulate_bound_ms']:.4f} ms; {stream / 1e9:.4f} GB of group "
            f"words)")
        return out

    before = kernels_on("before ingest", packed)
    del packed
    # Ingest: 64 cold rows (the cold partitions' magnitude) and 64 deletes,
    # then three more cold upserts of 2 rows, each followed by queries.  Each
    # refresh re-scores every partition that took a row (64 rows mutate all
    # 32, about 3 s each on the host), so the later upserts stay small.
    retraces0, fmts0 = executor.retraces, index.partition_formats

    def cold_rows(n):
        dense = rng.standard_normal((n, n_cols)).astype(np.float32)
        sp = bscsr.sparsify_topm(dense, 20)
        return [(sp.indices[sp.indptr[i]:sp.indptr[i + 1]],
                 MIXED_COLD_SCALE * sp.data[sp.indptr[i]:sp.indptr[i + 1]]) for i in range(n)]

    t0 = time.perf_counter()
    index.add_rows(cold_rows(64))
    upsert_s = time.perf_counter() - t0
    deleted = sorted(int(i) for i in rng.choice(n_rows, 64, replace=False))
    t0 = time.perf_counter()
    svc.delete(deleted)
    delete_s = time.perf_counter() - t0
    drive()
    first = executor.retraces - retraces0
    retraces1, fmts1 = executor.retraces, index.partition_formats
    for _ in range(3):
        index.add_rows(cold_rows(2))
        drive()
    later = executor.retraces - retraces1
    check.expect(index.partition_formats == fmts1 == fmts0,
                 f"partition formats moved under cold ingest: {fmts0} -> "
                 f"{index.partition_formats}")
    check.expect(later == 0, f"{later} retraces after the first mutation")
    copies = executor.h2d_copies
    drive()
    check.expect(executor.h2d_copies == copies, "h2d_copies moved in steady state")
    _, r64 = svc.query_batch(xs64)
    check.expect(not set(deleted) & set(r64.reshape(-1).tolist()),
                 "a deleted row id was returned")
    log(f"  ingest: 64 cold rows {upsert_s:.2f} s, 64 deletes {delete_s:.2f} s; retraces "
        f"at the first mutation {first}, over 3 more upserts {later}; promoted "
        f"{index.last_refresh_promoted}; group copies {index.last_refresh_group_copied}")
    after = kernels_on("after ingest", index.packed)
    check.done()
    return {"launches": launches, "before": before, "after": after, "recall": recall,
            "predicted_recall": index.predicted_recall, "formats": hist0,
            "bytes_per_nnz": bpn, "value_bytes_per_nnz": vbpn,
            "bf16_bytes_per_nnz": bf16_bytes / nnz0,
            "bf16_value_bytes_per_nnz": bf16_value_bytes / nnz0, "end_to_end": e2e}


def held_to_oracle(torch, api, index, check, answers, deleted, what) -> float:
    """Each (x, (values, rows)) answer against the torch oracle (phase 3's
    tolerances): 100 finite scores over valid rows, no deleted id.  Returns
    the largest absolute error."""
    worst = 0.0
    for x, (v, r) in answers:
        v, r = np.asarray(v), np.asarray(r)
        check.expect(v.shape == (index.config.big_k,) and bool(np.isfinite(v).all())
                     and bool((r >= 0).all()) and bool((r < index.n_rows_total).all()),
                     f"{what}: an answer is not {index.config.big_k} finite scores over "
                     f"valid rows")
        want = api.topk_spmv(index, torch.from_numpy(x), use_kernel=False)
        ok, err = compare((torch.from_numpy(v), torch.from_numpy(r)), want, bitwise=False)
        worst = max(worst, err)
        check.expect(ok, f"{what}: an answer differs from the oracle (max err {err:.3g})")
        check.expect(not deleted & set(r.tolist()), f"{what}: a deleted row id was returned")
    return worst


def serving_phase(torch, K, api, svc, xs64, deleted, rng, root, device="cuda") -> dict:
    """Phase 7: the serving plane over phase 3's facade (after its ingest).

    A ``StreamingSimilarityService`` with a ``DurableIndexStore`` under
    ``root`` (its construction writes the anchoring checkpoint): a burst of
    37 through a fixed-target frontend, open-loop traffic from four threads
    while the main thread ingests and deletes through the service, then a
    torn WAL record and recovery from a fresh store on the same directory.
    ``device="cpu"`` rehearses every check but the kernel launch count on
    the plain versions.  Returns the multi-query kernel's launches in this
    phase and the numbers of the ``SERVING`` line.
    """
    from repro_torch.core.faults import FaultInjected, FaultPlan
    from repro_torch.core.persistence import DurableIndexStore
    from repro_torch.kernels import executor as executor_lib
    from repro_torch.serve import FrontendConfig, StreamingSimilarityService

    check = Check("serving")
    on_card = torch.device(device).type == "cuda"
    index, executor = svc.index, api.query_executor(svc.config)
    n_cols = svc.n_cols
    deleted = set(deleted)
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = {}
    try:
        K.reset_launch_counts()
        # 1. A fixed burst: 37 submits and flush() make one pass of Q = 37.
        # Only flush() may end the pass: the default 10 ms flush deadline
        # split it once when the host stalled between submits (12 + 25).
        fixed = StreamingSimilarityService(
            svc, store=DurableIndexStore(root, device=device),
            frontend=FrontendConfig(adaptive=False, target_batch=64, max_batch=64,
                                    flush_deadline_s=60.0))
        store = fixed.store
        out["checkpoint"] = dict(store.last_checkpoint)
        log(f"  anchoring checkpoint: {out['checkpoint']['bytes']} bytes, export_state "
            f"{out['checkpoint']['export_s']:.2f} s, write {out['checkpoint']['write_s']:.2f} s")
        burst = rng.standard_normal((37, n_cols)).astype(np.float32)
        futs = [fixed.submit(x) for x in burst]
        fixed.flush()
        got = [f.result(timeout=600) for f in futs]
        info = fixed.frontend.info()
        fixed.close()
        check.expect(info["batch_histogram"] == {37: 1} and info["flushes"] == 1,
                     f"the burst of 37 ran as passes {info['batch_histogram']}")
        want = svc.query_batch(burst)
        check.expect(all(np.array_equal(v.view(np.int32), want[0][i].view(np.int32))
                         and np.array_equal(r, want[1][i]) for i, (v, r) in enumerate(got)),
                     "the Q = 37 pass differs from query_batch of the same queries")
        worst = held_to_oracle(torch, api, index, check, list(zip(burst, got)), deleted,
                               "burst")
        log(f"  burst: one pass of Q = 37 ({info['flush_reasons']}), bit for bit equal to "
            f"query_batch; vs the oracle max abs err {worst:.3g}")

        # 2. Open-loop traffic while ingesting: each thread's first 32
        # submits arrive about 20 ms apart while the main thread ingests and
        # deletes, its last 32 about 2 ms apart once the delete returned.
        live = StreamingSimilarityService(
            svc, store=store, frontend=FrontendConfig(flush_deadline_s=0.005, max_batch=64))
        queries = rng.standard_normal((4, 64, n_cols)).astype(np.float32)
        gaps = rng.exponential(1.0, (4, 64)) * np.where(np.arange(64) < 32, 0.02, 0.002)
        records = [[None] * 64 for _ in range(4)]
        done_at = {}
        delete_done = threading.Event()
        launches0 = K.bscsr_topk_spmv_multiquery.launches

        def client(i):
            for j in range(64):
                if j == 32:
                    delete_done.wait(timeout=600)
                after = delete_done.is_set()
                t = time.perf_counter()
                fut = live.submit(queries[i, j])
                fut.add_done_callback(
                    lambda f, key=(i, j): done_at.__setitem__(key, time.perf_counter()))
                records[i][j] = (fut, after, t)
                time.sleep(gaps[i, j])

        threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(4)]
        for t in threads:
            t.start()
        n_total = index.n_rows_total
        t0 = time.perf_counter()
        new_ids = live.ingest(rng.standard_normal((64, n_cols)).astype(np.float32))
        ingest_s = time.perf_counter() - t0
        victims = [int(g) for g in rng.choice(n_total, 96, replace=False)
                   if int(g) not in deleted][:64]
        t0 = time.perf_counter()
        live.delete(victims)
        delete_s = time.perf_counter() - t0
        delete_done.set()
        deleted |= set(victims)
        for t in threads:
            t.join(timeout=600)
        check.expect(not any(t.is_alive() for t in threads), "a client thread did not finish")
        check.expect(list(new_ids) == list(range(n_total, n_total + 64)),
                     "ingest did not assign the next 64 ids")
        n_after, lat = 0, {False: [], True: []}
        for i in range(4):
            for j in range(64):
                fut, after, t = records[i][j]
                v, r = fut.result(timeout=600)
                lat[after].append((done_at[(i, j)] - t) * 1e3)
                check.expect(v.shape == (svc.config.big_k,) and bool(np.isfinite(v).all())
                             and bool((r >= 0).all()) and bool((r < index.n_rows_total).all()),
                             "traffic: an answer is not 100 finite scores over valid rows")
                bad = (deleted if after else deleted - set(victims)) & set(r.tolist())
                check.expect(not bad, f"traffic: deleted ids {sorted(bad)[:4]} returned "
                                      f"(submitted {'after' if after else 'before'} the "
                                      f"delete returned)")
                n_after += after
        check.expect(n_after >= 128, f"only {n_after} requests submitted after the delete")
        tail = [live.submit(x) for x in xs64]
        tail = [f.result(timeout=600) for f in tail]
        worst = held_to_oracle(torch, api, index, check, list(zip(xs64, tail)), deleted,
                               "after the traffic")
        traffic_launches = K.bscsr_topk_spmv_multiquery.launches - launches0
        info = live.dispatch_info()
        fe = info["frontend"]
        both = lat[False] + lat[True]
        out["traffic"] = {
            "requests": 256 + 64, "submitted_after_delete": n_after,
            "passes": fe["flushes"], "batch_histogram": fe["batch_histogram"],
            "flush_reasons": fe["flush_reasons"],
            "latency_ms_p50": float(np.percentile(both, 50)),
            "latency_ms_p99": float(np.percentile(both, 99)),
            "latency_ms_max": float(np.max(both)),
            # Requests submitted while the ingest and delete ran, and after.
            "latency_ms_p50_p99_during_ingest": [float(np.percentile(lat[False], q))
                                                 for q in (50, 99)],
            "latency_ms_p50_p99_after_delete": [float(np.percentile(lat[True], q))
                                                for q in (50, 99)],
            "ingest_s": ingest_s, "delete_s": delete_s, "launches": traffic_launches}
        log(f"  traffic: 4 threads x 64 submits while ingest of 64 rows ({ingest_s:.2f} s) "
            f"and delete of 64 ({delete_s:.2f} s); {n_after} submitted after the delete; "
            f"{fe['flushes']} passes, Q histogram {fe['batch_histogram']}, flush reasons "
            f"{fe['flush_reasons']}; host latency enqueue to result p50 "
            f"{out['traffic']['latency_ms_p50']:.2f} ms, p99 "
            f"{out['traffic']['latency_ms_p99']:.2f} ms (submitted during the ingest and "
            f"delete: {out['traffic']['latency_ms_p50_p99_during_ingest']}, after: "
            f"{out['traffic']['latency_ms_p50_p99_after_delete']}); 64 more submits vs the "
            f"oracle max "
            f"abs err {worst:.3g}; multi-query launches {traffic_launches}")
        check.expect(not on_card or traffic_launches == fe["flushes"] > 0,
                     f"{traffic_launches} multi-query launches for {fe['flushes']} passes")

        # 3. Crash and recover: a torn third ingest, then a fresh store.
        version, n_total = index.version, index.n_rows_total
        with FaultPlan({"wal.append": 0}) as plan:
            try:
                live.ingest(rng.standard_normal((64, n_cols)).astype(np.float32))
            except FaultInjected:
                pass
        check.expect(plan.fired == [("wal.append", 0)] and index.version == version
                     and index.n_rows_total == n_total,
                     "the torn third ingest was applied or did not tear")
        live.close()
        log("SERVICE " + json.dumps(info["service"]))
        log("FRONTEND " + json.dumps(fe))
        del live, fixed, store
        t0 = time.perf_counter()
        live_meta, live_arrays = index.export_state()
        export_s = time.perf_counter() - t0
        live_answers = svc.query_batch(xs64)
        copies, retraces = executor.h2d_copies, executor.retraces
        t0 = time.perf_counter()
        rec = StreamingSimilarityService.recover(DurableIndexStore(root, device=device))
        recover_s = time.perf_counter() - t0
        timings = dict(rec.store.last_recovery)
        rec_meta, rec_arrays = rec.index.index.export_state()
        check.expect(rec.replayed_records == 2, f"{rec.replayed_records} records replayed, "
                                                f"not 2")
        check.expect(rec_meta == live_meta, "the recovered meta differs from the live index's")
        same = sorted(rec_arrays) == sorted(live_arrays) and all(
            rec_arrays[k].dtype == live_arrays[k].dtype
            and np.array_equal(rec_arrays[k], live_arrays[k]) for k in live_arrays)
        check.expect(same, "the recovered export_state differs from the live index's")
        del live_arrays, rec_arrays
        # The first query on the recovered snapshot pins it (uploads its
        # words and finalize tensors, builds its split table), as the first
        # pass after every mutation does; the second is a steady one.
        t0 = time.perf_counter()
        rec_answers = rec.index.query_batch(xs64)
        first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rec.index.query_batch(xs64)
        steady_ms = (time.perf_counter() - t0) * 1e3
        check.expect(np.array_equal(rec_answers[0].view(np.int32),
                                    live_answers[0].view(np.int32))
                     and np.array_equal(rec_answers[1], live_answers[1]),
                     "the recovered answers differ from the live service's")
        check.expect(rec.index.index.packed.signature_info() == index.packed.signature_info(),
                     "the recovered signature differs")
        pin = executor_lib.device_snapshot(rec.index.index.packed, "fused", executor.device)
        check.expect(executor.retraces == retraces,
                     f"{executor.retraces - retraces} retraces on resume")
        check.expect(executor.h2d_copies - copies == pin.uploads,
                     f"h2d_copies rose by {executor.h2d_copies - copies}, the re-pin is "
                     f"{pin.uploads}")
        out["recovery"] = dict(timings, recover_s=recover_s, live_export_s=export_s,
                               replayed=rec.replayed_records,
                               h2d_copies=executor.h2d_copies - copies,
                               first_query_batch_q64_ms=first_ms,
                               steady_query_batch_q64_ms=steady_ms)
        log(f"  recovery: {rec.replayed_records} records replayed; read "
            f"{timings['read_s']:.2f} s, from_state {timings['from_state_s']:.2f} s, replay "
            f"{timings['replay_s']:.2f} s, recover() {recover_s:.2f} s in all; the live "
            f"index's export_state {export_s:.2f} s; export_state, answers and signature "
            f"equal; retraces +0, h2d_copies +{executor.h2d_copies - copies} (the re-pin); "
            f"query_batch Q=64 {first_ms:.1f} ms with the pin, {steady_ms:.1f} ms after")
        log("RECOVERED_SERVICE " + json.dumps(rec.dispatch_info()["service"]))
        del rec, pin
        out["launches"] = K.bscsr_topk_spmv_multiquery.launches
        log(f"  multi-query kernel launches in the serving phase: {out['launches']}")
        check.expect(not on_card or out["launches"] > 0,
                     "bscsr_topk_spmv_multiquery was not launched in the serving phase")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("SERVING " + json.dumps(out))
    check.done()
    return out


def qwen25_3b_widths() -> tuple:
    """(vocab, d_model) of Qwen2.5-3B from the port's config."""
    from repro_torch.configs import get_config

    cfg = get_config(LM_ARCH)
    return cfg.vocab_size, cfg.d_model


def same_bits(a, b) -> bool:
    """Two (values, rows) answers equal bit for bit (numpy or tensors)."""
    (av, ar), (bv, br) = ((t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)
                           for t in pair) for pair in (a, b))
    return (np.array_equal(np.ascontiguousarray(av, np.float32).view(np.int32),
                           np.ascontiguousarray(bv, np.float32).view(np.int32))
            and np.array_equal(ar.astype(np.int64), br.astype(np.int64)))


def sharded_phase(torch, K, api, graph, SparseEmbeddingIndex, GraphRankingService, csr, cfg,
                  xs64, kept, phase4, gcsr, seed, device="cuda") -> dict:
    """Phase 8: the query cell, the graph cell and the approximate head on
    ``SHARDS`` shards, held bit for bit to the single-device answers.

    ``kept`` holds phase 3's answers and mutation inputs, ``phase4`` its
    after-ingest kernel times (ms by Q, the single-query ms) and bounds.
    Returns the launches of the phase's drive (counted from 0), the
    per-shard kernel times and the sharded cold PPR (phase 6 holds its
    single-device cold rank to it).  ``device="cpu"`` rehearses every check
    but the launch counts and the timings.
    """
    from repro_torch.core.faults import FaultPlan
    from repro_torch.serve import ApproxTopKHead, TopKHeadConfig

    check = Check("sharded")
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n_rows, n_cols = csr.shape
    ex = api.query_executor(cfg)
    out = {"shards": SHARDS}

    t0 = time.time()
    fac = SparseEmbeddingIndex(csr, cfg, n_shards=SHARDS)
    index = fac.index
    out["build_s"] = time.time() - t0
    log(f"  sharded build: {out['build_s']:.1f} s, {SHARDS} shards x {index._cps} "
        f"partitions (c = {index.num_cores}), rows {[sh.n_rows for sh in index.shards]}")
    check.expect(index.num_cores % SHARDS == 0 and all(
        sh.packed.num_cores == index._cps for sh in index.shards), "shard partitions")

    def pins():
        """Each shard's pinned snapshot (already pinned: no upload)."""
        return [ex.prepare(sh.packed, 64, "kernel", row_map=index._row_map(s),
                           row_map_key=("l2g", index._generation))[1]
                for s, sh in enumerate(index.shards)]

    def hold(label, want, qi=0):
        """Q = 1, 8 and 64 through the facade against phase 3's answers."""
        got = (fac.query(xs64[qi]), fac.query_batch(xs64[:8]), fac.query_batch(xs64))
        for q, g, w in zip((1, 8, 64), got, want):
            check.expect(same_bits(g, w), f"{label}: Q={q} sharded answers differ from "
                                          f"phase 3's single-device answers")
        log(f"  {label}: Q = 1, 8, 64 sharded == single-device bit for bit: "
            f"{all(same_bits(g, w) for g, w in zip(got, want))}")
        return got

    K.reset_launch_counts()
    copies = ex.h2d_copies
    hold("before mutations", kept["before"])
    x0 = torch.from_numpy(xs64[0]).to(device)
    direct = index.query(x0)                      # the single-query kernel per shard
    check.expect(same_bits(direct, kept["before"][3]),
                 "sharded index.query differs from phase 3's topk_spmv")
    pinned = ex.h2d_copies - copies
    uploads = sum(p.uploads for p in pins())
    steady = ex.h2d_copies
    fac.query_batch(xs64)
    log(f"  h2d_copies: {pinned} at the first queries ({uploads} in the {SHARDS} shard pins: "
        f"words, finalize tensors, row maps), {ex.h2d_copies - steady} in steady state")
    check.expect(pinned == uploads and ex.h2d_copies == steady,
                 f"h2d_copies {pinned} for {uploads} pinned tensors, steady "
                 f"{ex.h2d_copies - steady}")

    muts = kept["mutations"]
    t0 = time.perf_counter()
    new_ids = fac.upsert(muts["new_rows"])
    upsert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fac.delete(muts["deleted"])
    delete_s = time.perf_counter() - t0
    check.expect(list(new_ids) == list(range(n_rows, n_rows + 64)),
                 "sharded upsert did not assign phase 3's ids")
    retraces = ex.retraces
    hold("after the ingest of 64 and 64 deletes", kept["after_ingest"])
    first = ex.retraces - retraces
    for i, rows8 in enumerate(muts["upserts"]):
        ids = fac.upsert(rows8)
        check.expect(list(ids) == list(range(n_rows + 64 + 8 * i, n_rows + 72 + 8 * i)),
                     "sharded upsert of 8 did not assign phase 3's ids")
        fac.query(xs64[i])
        fac.query_batch(xs64[:8])
        fac.query_batch(xs64)
    later = ex.retraces - retraces - first
    full = hold("after three upserts of 8", kept["after_upserts"], qi=2)[2]
    out["end_to_end"] = {name: median_ms(fn) for name, fn in (
        ("query_ms", lambda: fac.query(xs64[0])),
        ("query_batch_q8_ms", lambda: fac.query_batch(xs64[:8])),
        ("query_batch_q64_ms", lambda: fac.query_batch(xs64)))}
    log("SHARDED_END_TO_END " + json.dumps(out["end_to_end"]))
    log(f"  ingest on {SHARDS} shards: upsert 64 rows {upsert_s:.2f} s, delete 64 "
        f"{delete_s:.2f} s; retraces at the first mutation {first}, over 3 more upserts "
        f"{later}; row-map buckets {[int(index._row_map(s).shape[0]) for s in range(SHARDS)]}")
    check.expect(later == 0, f"{later} retraces within the buckets")
    check.expect(index.deleted_rows == 64 and index.n_rows == n_rows + 64 + 24 - 64,
                 f"sharded counts: {index.n_rows} live, {index.deleted_rows} deleted")

    # Failover: shard 0's dispatch fails; the answer is the full one
    # restricted to shards 1-3's rows, until recover_shard re-pins it.
    with FaultPlan({"dispatch.shard": 0}) as plan:
        deg = fac.query_batch(xs64)
    health = fac.dispatch_info()["health"]
    owner = index._live
    restricted = True
    for i in range(64):
        keep = [j for j, g in enumerate(full[1][i]) if owner[int(g)][0] != 0]
        n = len(keep)
        restricted &= n > 0 and same_bits((deg[0][i][:n], deg[1][i][:n]),
                                          (full[0][i][keep], full[1][i][keep]))
    log(f"  failover: plan fired {plan.fired}, health {health}; degraded answers == the "
        f"full ones restricted to shards 1-3: {restricted}")
    check.expect(plan.fired == [("dispatch.shard", 0)] and restricted, "degraded answers")
    check.expect(health == {"dead_shards": [0], "live_shard_fraction": 0.75, "failovers": 1,
                            "last_query_degraded": True}, f"health {health}")
    copies = ex.h2d_copies
    t0 = time.perf_counter()
    index.recover_shard(0)
    rec = fac.query_batch(xs64)
    sync()
    out["recover_ms"] = (time.perf_counter() - t0) * 1e3
    repin = ex.h2d_copies - copies
    health = fac.dispatch_info()["health"]
    log(f"  recover_shard(0) + the first Q = 64 query (its re-pin, {repin} tensors): "
        f"{out['recover_ms']:.1f} ms; health {health}")
    check.expect(same_bits(rec, full), "answers after recover_shard differ from the full ones")
    check.expect(repin == pins()[0].uploads and not health["dead_shards"]
                 and not health["last_query_degraded"], f"recovery: re-pin {repin}, {health}")

    # The sharded accumulate: phase 6's graph cell on the same shard count.
    gcfg = graph_config(api, device)
    t0 = time.time()
    gfac = SparseEmbeddingIndex(gcsr, gcfg, n_shards=SHARDS)
    gsvc = GraphRankingService(gfac.index, tol=1e-5)
    gbuild_s = time.time() - t0
    spmv0 = K.bscsr_spmv.launches
    t0 = time.perf_counter()
    cold = gsvc.rank(GRAPH_SEEDS, top_k=10)
    cold_s = time.perf_counter() - t0
    res = cold.result
    spmv_launches = K.bscsr_spmv.launches - spmv0
    log(f"  sharded graph cell: build {gbuild_s:.1f} s; cold rank {res.iterations} "
        f"iterations, {res.refine_iterations} refine steps, residual {res.residual:.3g}, "
        f"retraces {res.retraces}, {cold_s:.2f} s; accumulate launches {spmv_launches}; top "
        f"nodes {cold.node_ids.tolist()}")
    check.expect(res.converged and res.canonical and res.retraces == 0,
                 "sharded cold rank did not converge cleanly")
    if on_card:
        check.expect(spmv_launches == SHARDS * res.iterations,
                     f"{spmv_launches} accumulate launches for {res.iterations} iterations")
    out["ppr"] = {"scores": res.scores, "iterations": res.iterations, "seconds": cold_s,
                  "launches": spmv_launches}

    # The approximate head at Qwen2.5-3B's vocabulary, unsharded and sharded.
    vocab, d_model = qwen25_3b_widths()
    rng = np.random.default_rng(seed)
    t0 = time.time()
    emb = rng.standard_normal((vocab, d_model), dtype=np.float32)
    hidden = rng.standard_normal((64, d_model), dtype=np.float32)
    head = ApproxTopKHead(emb, TopKHeadConfig(device=device))
    head4 = ApproxTopKHead(emb, TopKHeadConfig(device=device, n_shards=SHARDS))
    head_build_s = time.time() - t0
    a, b = head.topk_logits_batch(hidden), head4.topk_logits_batch(hidden)
    one_k = head.topk_logits(hidden[0], use_kernel=True)
    one_p = head.topk_logits(hidden[0], use_kernel=False)
    ok, err = compare(tuple(torch.from_numpy(t) for t in one_k),
                      tuple(torch.from_numpy(t) for t in one_p), bitwise=False)
    exact = [head.exact_topk_logits(h)[1] for h in hidden[:HEAD_EXACT]]
    big_k = head.cfg.big_k
    overlap = float(np.mean([len(set(a[1][i].tolist()) & set(e.tolist())) / big_k
                             for i, e in enumerate(exact)]))
    out["head"] = {"vocab": vocab, "d_model": d_model, "nnz": int(head.index.packed.nnz),
                   "build_s": head_build_s, "overlap_at_64": overlap,
                   "partition_precision": head.partition_precision,
                   "kernel_vs_plain_max_abs_err": err}
    log(f"  head (Qwen2.5-3B widths {vocab} x {d_model}, {head.index.packed.nnz} nnz, "
        f"built twice in {head_build_s:.1f} s): Q = 64 sharded == unsharded bit for bit: "
        f"{same_bits(a, b)}; topk_logits kernel vs plain max abs err {err:.3g}; "
        f"overlap@{big_k} {overlap:.4f} over {HEAD_EXACT} hidden states (partition "
        f"precision {head.partition_precision:.4f})")
    check.expect(same_bits(a, b), "sharded head answers differ from the unsharded head's")
    out["head_inputs"], out["head_answers"] = (emb, hidden), a     # phase 12's reference
    check.expect(ok, f"head topk_logits kernel vs plain (max err {err:.3g})")
    check.expect(0.0 < overlap <= 1.0 and np.isfinite(a[0]).all(), "head answers")

    out["launches"] = {"bscsr_topk_spmv": K.bscsr_topk_spmv.launches,
                       "bscsr_topk_spmv_multiquery": K.bscsr_topk_spmv_multiquery.launches,
                       "bscsr_spmv": K.bscsr_spmv.launches}
    log(f"  launches in the sharded phase: {out['launches']}")
    if on_card:
        for name, count in out["launches"].items():
            check.expect(count > 0, f"{name} was not launched in the sharded phase")
        out["timing"] = sharded_timing(torch, K, api, ex, index, gfac.index, xs64, phase4,
                                       cfg)
    check.done()
    return out


def sharded_timing(torch, K, api, ex, index, gindex, xs64, phase4, cfg, device="cuda"
                   ) -> dict:
    """Each kernel's device time on each shard's pinned snapshot (after the
    mutations) at the S the card picks for its cores, and the sum over the
    shards, beside phase 4's single-device time and the bound."""
    t, block, k = cfg.packets_per_step, cfg.block_size, cfg.k
    x64 = torch.from_numpy(xs64).to(device)
    out = {"splits_by_q": {}, "ms_by_shard_by_q": {}, "ms_sum_by_q": {}, "bound_ms_by_q": {}}
    snaps = [ex.prepare(sh.packed, 64, "kernel", row_map=index._row_map(s),
                        row_map_key=("l2g", index._generation))[1]
             for s, sh in enumerate(index.shards)]

    def bound(words, nnz, q):
        """Phase 4's bound of a Q-query pass, over one shard's words."""
        nbytes = words.numel() * 4 + q * xs64.shape[1] * 4 + words.shape[0] * q * k * 8
        return max(nbytes / HBM_BYTES_PER_S, 2.0 * nnz * q / F32_FLOPS) * 1e3

    for q in (1, 8, 64):
        x = x64[:q].contiguous()
        q_chunk, n_chunks = K.query_chunks(q)
        per, splits, bounds = [], [], []
        for sh, snap in zip(index.shards, snaps):
            words = snap.streams[0]
            s = K.topk_splits(words.device, words.shape[0], n_chunks, packets_per_step=t,
                              block_size=block, m=x.shape[1], q_chunk=q_chunk, k=k)
            tab = snap.split_table(t, s)
            per.append(time_cuda(torch, lambda: K.bscsr_topk_spmv_multiquery(
                x, words, table=tab, k=k, n_rows=snap.max_slots, packets_per_step=t,
                fmt_name=snap.fmt_name, block_size=block), MIXED_BUDGET_S))
            splits.append(s)
            bounds.append(bound(words, sh.packed.nnz, q))
        out["splits_by_q"][q] = splits
        out["ms_by_shard_by_q"][q] = per
        out["ms_sum_by_q"][q] = sum(per)
        out["bound_ms_by_q"][q] = sum(bounds)
        log(f"  multi-query kernel Q={q} per shard (S = {splits}): "
            f"{' / '.join(f'{m:.3f}' for m in per)} ms, sum {sum(per):.3f} ms; single device "
            f"{phase4['mq_ms_by_q'][q]:.3f} ms; bound {sum(bounds):.3f} ms")
    x1 = x64[0].contiguous()
    per, splits = [], []
    for snap in snaps:
        words = snap.streams[0]
        s = K.single_splits(words.device, words.shape[0], packets_per_step=t, block_size=block,
                            m=x1.shape[0], k=k, width=words.shape[2], fmt_name=snap.fmt_name)
        tab = snap.split_table(t, s)
        per.append(time_cuda(torch, lambda: K.bscsr_topk_spmv(
            x1, words, table=tab, k=k, n_rows=snap.max_slots, packets_per_step=t,
            fmt_name=snap.fmt_name, block_size=block), MIXED_BUDGET_S))
        splits.append(s)
    out["single"] = {"splits": splits, "ms_by_shard": per, "ms_sum": sum(per)}
    log(f"  single-query kernel per shard (S = {splits}): "
        f"{' / '.join(f'{m:.3f}' for m in per)} ms, sum {sum(per):.3f} ms; single device "
        f"{phase4['single_ms']:.3f} ms; bound {out['bound_ms_by_q'][1]:.3f} ms")
    gex = api.query_executor(gindex.config)
    n = gindex.n_rows_total
    xg = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    per, splits = [], []
    for s, sh in enumerate(gindex.shards):
        snap = gex.prepare(sh.packed, ("spmv", n), "accumulate", row_map=gindex._row_map(s),
                           row_map_key=("l2g", gindex._generation))[1]
        words = snap.streams[0]
        sp = K.spmv_splits(words.device, words.shape[0], packets_per_step=t, block_size=block,
                           m=n)
        tab = snap.split_table(t, sp)
        per.append(time_cuda(torch, lambda: K.bscsr_spmv(
            xg, words, n_rows=snap.max_slots, packets_per_step=t, fmt_name=snap.fmt_name,
            block_size=block, table=tab), MIXED_BUDGET_S))
        splits.append(sp)
    out["accumulate"] = {"splits": splits, "ms_by_shard": per, "ms_sum": sum(per)}
    log(f"  accumulate kernel per shard of the graph cell (S = {splits}): "
        f"{' / '.join(f'{m:.4f}' for m in per)} ms, sum {sum(per):.4f} ms")
    return out


def mesh_phase(torch, K, api, SparseEmbeddingIndex, GraphRankingService, csr, cfg, xs64,
               kept, sharded, gcsr) -> dict:
    """Phase 12: the mesh dispatch on a 2 replica x 4 shard mesh whose eight
    positions all name this card (``make_serving_mesh(4, 2, devices=
    [cuda:0] * 8)``): phase 3's cell, phase 8's graph cell and head, held
    bit for bit to their single-device answers.

    ``kept`` holds phase 3's answers and mutation inputs; ``sharded`` phase
    8's result (its end-to-end latency, cold rank and head).  Returns the
    launches of the phase's drive (counted from 0), the bundle's counters
    and ship times, the facade's latency, the mesh's cold rank (phase 6
    holds its own to it) and each kernel's device time per position.
    """
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serve import ApproxTopKHead, TopKHeadConfig

    check = Check("mesh")
    sync = torch.cuda.synchronize
    dev = torch.device("cuda", 0)
    mesh = make_serving_mesh(MESH_SHARDS, MESH_REPLICAS,
                             devices=[dev] * (MESH_SHARDS * MESH_REPLICAS))
    n_rows = csr.shape[0]
    out = {"mesh": dict(mesh.shape), "positions_on": sorted({str(d) for d in mesh.devices.flat})}

    t0 = time.time()
    fac = SparseEmbeddingIndex(csr, cfg, mesh=mesh)
    index = fac.index
    disp = index._spmd
    bundle = disp.bundle
    out["build_s"] = time.time() - t0
    info = fac.dispatch_info()
    log(f"  mesh build: {out['build_s']:.1f} s; {mesh.shape} on {out['positions_on']}: "
        f"{MESH_SHARDS} shards x {index._cps} partitions, rows "
        f"{[sh.n_rows for sh in index.shards]}; path {info['path']}")
    check.expect(info["path"] == "spmd" and index._cps == 8 and fac.replica_factor == 2,
                 f"mesh index: path {info['path']}, {index._cps} partitions a shard, "
                 f"replica factor {fac.replica_factor}")

    K.reset_launch_counts()
    t0 = time.perf_counter()
    disp._sync()                                  # the first pin: every position
    sync()
    out["first_pin_s"] = time.perf_counter() - t0
    out["first_pin"] = bundle.counters()
    log(f"  first pin: {out['first_pin_s']:.3f} s, {bundle.uploads} uploads, "
        f"{bundle.host_bytes_shipped / 1e9:.3f} GB to {mesh.size} positions")

    def hold(label, want, qi=0):
        """Q = 1, 8, 37, 64 and index.query against phase 3's answers."""
        one, b8, b64 = want[:3]
        got = {1: fac.query(xs64[qi]), 8: fac.query_batch(xs64[:8]),
               37: fac.query_batch(xs64[:37]), 64: fac.query_batch(xs64)}
        expect = {1: one, 8: b8, 37: (b64[0][:37], b64[1][:37]), 64: b64}
        direct = index.query(torch.from_numpy(xs64[qi]).to(dev))
        oks = [same_bits(got[q], expect[q]) for q in MESH_QS]
        oks.append(same_bits(direct, want[3] if len(want) > 3 else one))
        for q, ok in zip(MESH_QS + ("index.query",), oks):
            check.expect(ok, f"{label}: {q} on the mesh differs from phase 3's answers")
        log(f"  {label}: Q = 1, 8, 37, 64 and index.query on the mesh == phase 3 bit for "
            f"bit: {all(oks)}")
        return got

    def steady(label):
        uploads = bundle.uploads
        fac.query(xs64[0])
        fac.query_batch(xs64[:8])
        fac.query_batch(xs64)
        check.expect(bundle.uploads == uploads, f"{label}: {bundle.uploads - uploads} uploads "
                                                f"in steady state")

    hold("before mutations", kept["before"])
    steady("before mutations")

    # Phase 3's mutations replayed; after each, one sync ships what moved.
    muts = kept["mutations"]
    ships, jumps = [], 0

    def ship(label, sig):
        """The sync after a mutation (``sig``: the signature before it)."""
        nonlocal jumps
        before = bundle.counters()
        t0 = time.perf_counter()
        new_sig = disp._sync()[1]
        sync()
        secs = time.perf_counter() - t0
        jumped = new_sig != sig
        jumps += jumped
        rec = {"label": label, "s": secs, "bucket_jump": jumped,
               "uploads": bundle.uploads - before["uploads"],
               "bytes": bundle.host_bytes_shipped - before["host_bytes_shipped"],
               "partitions": bundle.partitions_shipped - before["partitions_shipped"]}
        ships.append(rec)
        log(f"  ship after {label}: " + json.dumps(rec))
        full = MESH_SHARDS * index._cps
        check.expect(jumped or rec["partitions"] < full,
                     f"{label}: {rec['partitions']} partitions shipped within the buckets "
                     f"(a full re-ship is {full})")
        return rec

    sig = disp._sync()[1]
    new_ids = fac.upsert(muts["new_rows"])
    fac.delete(muts["deleted"])
    check.expect(list(new_ids) == list(range(n_rows, n_rows + 64)),
                 "mesh upsert did not assign phase 3's ids")
    ship("the ingest of 64 and 64 deletes", sig)
    hold("after the ingest of 64 and 64 deletes", kept["after_ingest"])
    for i, rows8 in enumerate(muts["upserts"]):
        sig = disp._sync()[1]
        ids = fac.upsert(rows8)
        check.expect(list(ids) == list(range(n_rows + 64 + 8 * i, n_rows + 72 + 8 * i)),
                     "mesh upsert of 8 did not assign phase 3's ids")
        rec = ship(f"upsert of 8 #{i}", sig)
        check.expect(rec["bucket_jump"] or rec["partitions"] > 0,
                     f"upsert of 8 #{i} shipped no partition")
        fac.query(xs64[i])
        fac.query_batch(xs64[:8])
        fac.query_batch(xs64)
    hold("after three upserts of 8", kept["after_upserts"], qi=2)
    steady("after the mutations")
    keys = len(disp._last_sig)
    log(f"  retraces {disp.retraces} over {jumps} bucket jumps and {keys} dispatch keys")
    check.expect(disp.retraces <= jumps * keys,
                 f"{disp.retraces} retraces for {jumps} bucket jumps x {keys} keys")
    check.expect(index.deleted_rows == 64 and index.n_rows == n_rows + 64 + 24 - 64,
                 f"mesh counts: {index.n_rows} live, {index.deleted_rows} deleted")
    out["ships"], out["bucket_jumps"], out["retraces"] = ships, jumps, disp.retraces
    out["end_to_end"] = {name: median_ms(fn) for name, fn in (
        ("query_ms", lambda: fac.query(xs64[0])),
        ("query_batch_q8_ms", lambda: fac.query_batch(xs64[:8])),
        ("query_batch_q64_ms", lambda: fac.query_batch(xs64)))}
    log("MESH_END_TO_END " + json.dumps(out["end_to_end"]) + " per-shard (phase 8) "
        + json.dumps(sharded["end_to_end"]))

    # The graph cell's cold rank on the same mesh shape.
    t0 = time.time()
    gfac = SparseEmbeddingIndex(gcsr, graph_config(api, "cuda"), mesh=mesh)
    gsvc = GraphRankingService(gfac.index, tol=1e-5)
    gbuild_s = time.time() - t0
    spmv0 = K.bscsr_spmv.launches
    t0 = time.perf_counter()
    res = gsvc.rank(GRAPH_SEEDS, top_k=10).result
    cold_s = time.perf_counter() - t0
    spmv_launches = K.bscsr_spmv.launches - spmv0
    n_diff, gap = ulp_gap(res.scores, sharded["ppr"]["scores"])
    log(f"  graph cell on the mesh: build {gbuild_s:.1f} s; cold rank {res.iterations} "
        f"iterations, {res.refine_iterations} refine steps, {cold_s:.2f} s, accumulate "
        f"launches {spmv_launches}; vs phase 8's: {n_diff} scores differ")
    check.expect(res.converged and res.canonical and res.retraces == 0,
                 "mesh cold rank did not converge cleanly")
    check.expect(n_diff == 0 and res.iterations == sharded["ppr"]["iterations"],
                 f"mesh cold rank differs from phase 8's in {n_diff} scores (up to {gap} ulp)")
    check.expect(spmv_launches == MESH_SHARDS * res.iterations,
                 f"{spmv_launches} accumulate launches for {res.iterations} iterations")
    out["ppr"] = {"scores": res.scores, "iterations": res.iterations, "seconds": cold_s,
                  "launches": spmv_launches}

    # The head at Qwen2.5-3B's widths on the mesh against phase 8's unsharded head.
    emb, hidden = sharded["head_inputs"]
    t0 = time.time()
    head = ApproxTopKHead(emb, TopKHeadConfig(device="cuda", mesh=mesh))
    head_build_s = time.time() - t0
    got = head.topk_logits_batch(hidden)
    ok = same_bits(got, sharded["head_answers"])
    log(f"  head on the mesh (built in {head_build_s:.1f} s): Q = 64 == phase 8's unsharded "
        f"head bit for bit: {ok}")
    check.expect(ok, "the head on the mesh differs from the unsharded head")
    out["head_build_s"] = head_build_s

    out["launches"] = launch_counts(K)
    out["bundle"] = bundle.counters()
    log(f"  launches in the mesh phase: {out['launches']}; bundle {out['bundle']['uploads']} "
        f"uploads, {out['bundle']['host_bytes_shipped'] / 1e9:.3f} GB, "
        f"{out['bundle']['partitions_shipped']} partitions")
    for name, count in out["launches"].items():
        check.expect(count > 0, f"{name} was not launched in the mesh phase")
    out["timing"] = mesh_timing(torch, K, index, gfac.index, xs64, cfg)
    check.done()
    return out


def mesh_timing(torch, K, index, gindex, xs64, cfg) -> dict:
    """Each kernel's device time at each mesh position it runs on, on that
    position's pinned words, and the sum over the positions, with the
    bound of each position's pass summed likewise (the bytes of the steps
    its split table walks, to each core's last flagged step, not the
    bucket's padding; x; the outputs).  A batch of Q gives each replica row
    Q / 2 (padded) queries; the single query and the accumulate step run on
    replica row 0."""
    t, block, k = cfg.packets_per_step, cfg.block_size, cfg.k
    x64 = torch.from_numpy(xs64).cuda()
    disp = index._spmd
    args, _ = disp._sync()
    n_slots = int(args[1].shape[2])
    nnz = [sh.packed.nnz for sh in index.shards]
    rows = disp._rows
    shard_of = {pos: s for row in rows for s, pos in enumerate(row)}
    out = {"splits_by_q": {}, "ms_by_position_by_q": {}, "ms_sum_by_q": {}, "bound_ms_by_q": {}}

    def bound(words, tab, s, q, out_bytes=None, m=xs64.shape[1]):
        walked = int(tab[0][:, -1].sum()) * t * words.shape[2] * 4
        out_bytes = words.shape[0] * q * k * 8 if out_bytes is None else out_bytes
        nbytes = walked + q * m * 4 + out_bytes
        return max(nbytes / HBM_BYTES_PER_S, 2.0 * nnz[s] * q / F32_FLOPS) * 1e3

    for q in (1, 8, 64):
        per_row = 1 << max(-(-q // MESH_REPLICAS) - 1, 0).bit_length()   # padded
        x = x64[:per_row].contiguous()
        q_chunk, n_chunks = K.query_chunks(per_row)
        per, splits, bounds = {}, {}, 0.0
        for pos, s in shard_of.items():
            words = args[0].pieces[pos]
            sp = K.topk_splits(words.device, words.shape[0], n_chunks, packets_per_step=t,
                               block_size=block, m=x.shape[1], q_chunk=q_chunk, k=k)
            tab = disp._table(pos, words, sp)
            per[str(pos)] = time_cuda(torch, lambda: K.bscsr_topk_spmv_multiquery(
                x, words, table=tab, k=k, n_rows=n_slots, packets_per_step=t,
                fmt_name=cfg.value_format, block_size=block), MESH_BUDGET_S)
            splits[str(pos)] = sp
            bounds += bound(words, tab, s, per_row)
        out["splits_by_q"][q] = splits
        out["ms_by_position_by_q"][q] = per
        out["ms_sum_by_q"][q] = sum(per.values())
        out["bound_ms_by_q"][q] = bounds
        log(f"  multi-query kernel, Q = {q} ({per_row} a replica row), per position: "
            f"{' / '.join(f'{m:.3f}' for m in per.values())} ms, sum "
            f"{out['ms_sum_by_q'][q]:.3f} ms; bound {bounds:.3f} ms")
    x1 = x64[0].contiguous()
    per, splits, bounds = {}, {}, 0.0
    for s, pos in enumerate(rows[0]):
        words = args[0].pieces[pos]
        sp = K.single_splits(words.device, words.shape[0], packets_per_step=t, block_size=block,
                             m=x1.shape[0], k=k, width=words.shape[2],
                             fmt_name=cfg.value_format)
        tab = disp._table(pos, words, sp)
        per[str(pos)] = time_cuda(torch, lambda: K.bscsr_topk_spmv(
            x1, words, table=tab, k=k, n_rows=n_slots, packets_per_step=t,
            fmt_name=cfg.value_format, block_size=block), MESH_BUDGET_S)
        splits[str(pos)] = sp
        bounds += bound(words, tab, s, 1)
    out["single"] = {"splits": splits, "ms_by_position": per, "ms_sum": sum(per.values()),
                     "bound_ms": bounds}
    log(f"  single-query kernel per position of row 0: "
        f"{' / '.join(f'{m:.3f}' for m in per.values())} ms, sum {sum(per.values()):.3f} ms; "
        f"bound {bounds:.3f} ms")
    gdisp = gindex._spmd
    gargs, _ = gdisp._sync()
    n = gindex.n_rows_total
    xg = torch.full((n,), 1.0 / n, dtype=torch.float32, device="cuda")
    g_slots = int(gargs[1].shape[2])
    nnz = [sh.packed.nnz for sh in gindex.shards]
    per, splits, bounds = {}, {}, 0.0
    for s, pos in enumerate(gdisp._rows[0]):
        words = gargs[0].pieces[pos]
        sp = K.spmv_splits(words.device, words.shape[0], packets_per_step=t, block_size=block,
                           m=n)
        tab = gdisp._table(pos, words, sp)
        per[str(pos)] = time_cuda(torch, lambda: K.bscsr_spmv(
            xg, words, n_rows=g_slots, packets_per_step=t, fmt_name="F32",
            block_size=block, table=tab), MESH_BUDGET_S)
        splits[str(pos)] = sp
        bounds += bound(words, tab, s, 1, out_bytes=words.shape[0] * g_slots * 4, m=n)
    out["accumulate"] = {"splits": splits, "ms_by_position": per, "ms_sum": sum(per.values()),
                         "bound_ms": bounds}
    log(f"  accumulate kernel per position of row 0 (graph cell): "
        f"{' / '.join(f'{m:.4f}' for m in per.values())} ms, sum {sum(per.values()):.4f} ms; "
        f"bound {bounds:.4f} ms")
    return out


def lm_phase(torch, K, api, seed, cfg=None, device="cuda") -> dict:
    """Phase 9: Qwen2.5-3B at full width and ``LM_LAYERS`` of its layers
    (``cfg`` replaces it for a CPU rehearsal) behind ``ServingEngine`` with
    the approximate head.

    The model is the port's own init on the device from ``seed`` (no
    weights are in the repo).  Drive: the engine and its head, 64 prompts
    of 16 tokens through ``generate(prompt, 32)`` twice, the incremental
    prefill, ``decode_hidden`` for the first generated token, ``sample_approx``
    (the multi-query kernel at Q = 64) and ``overlap_at_k`` over
    ``HEAD_EXACT`` states (the single-query kernel).  Then the checks against
    ``api.prefill`` and the plain walks, and on the card the timings.
    Returns the drive's launches (counted from 0) and the ``LM`` line.
    """
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve import ServingEngine, TopKHeadConfig

    check = Check("lm")
    on_card = device == "cuda"
    if cfg is None:
        cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=LM_LAYERS)
        cut = (f"{LM_LAYERS} of {get_config(LM_ARCH).num_layers} layers (depth only: "
               f"widths, vocabulary and traffic kept)")
        log(f"CUT: phase 9 serves {LM_ARCH} at {cut}, to keep the script inside its time "
            f"limit")
    else:
        cut = "widths cut for a CPU rehearsal"
    model_api = get_model(cfg)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = model_api.init_params(torch.Generator(device=device).manual_seed(seed), LM_MAX_SEQ)
    sync()
    init_s = time.time() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size} (padded {cfg.padded_vocab}), {cfg.dtype}: {n_params} parameters, "
        f"{weight_bytes / 1e9:.3f} GB of weights on {device} (init {init_s:.1f} s)")
    check.expect(n_params == cfg.param_count(), "parameters differ from param_count()")
    if on_card:
        init_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        log(f"  peak device memory of the init {init_peak / 1e9:.3f} GB (f32 draws "
            f"beside the held weights)")

    rng = np.random.default_rng(seed + 9)
    prompt = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    K.reset_launch_counts()
    t0 = time.time()
    engine = ServingEngine(cfg, model, batch_size=LM_BATCH, max_seq=LM_MAX_SEQ,
                           use_approx_head=True, head_cfg=TopKHeadConfig(device=device),
                           device=device)
    head_build_s = time.time() - t0
    head = engine.head
    gen_s = []
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(engine.generate(prompt, num_steps=LM_GEN).tokens)
        gen_s.append(time.perf_counter() - t0)
    dec_logits, cache, pos = engine.prefill_tokens(prompt)
    next_tok = torch.argmax(dec_logits, dim=-1)[:, None]
    hidden, _ = engine.decode_hidden(cache, next_tok, pos)
    ids = engine.sample_approx(hidden)
    h32 = hidden.float().cpu().numpy()
    overlaps = [head.overlap_at_k(h32[i]) for i in range(HEAD_EXACT)]
    sync()
    launches = {"bscsr_topk_spmv": K.bscsr_topk_spmv.launches,
                "bscsr_topk_spmv_multiquery": K.bscsr_topk_spmv_multiquery.launches,
                "bscsr_spmv": K.bscsr_spmv.launches}
    log(f"  launches in the lm phase: {launches}")
    if on_card:
        for name in ("bscsr_topk_spmv", "bscsr_topk_spmv_multiquery"):
            check.expect(launches[name] > 0, f"{name} was not launched in the lm phase")

    # Requests: the same tokens twice, every one a real vocabulary id.
    a, b = runs
    check.expect(a.shape == (LM_BATCH, LM_GEN) and np.array_equal(a, b),
                 "generate gave other tokens the second time")
    check.expect(bool(((a >= 0) & (a < cfg.padded_vocab)).all()),
                 "a generated token lies outside [0, padded_vocab)")
    check.expect(bool((a < cfg.vocab_size).all()), "a padding id was generated")
    tokens_per_s = LM_BATCH * LM_GEN / gen_s[1]
    log(f"  generate: {LM_BATCH} requests x ({LM_PROMPT} + {LM_GEN}) tokens in "
        f"{gen_s[0]:.2f} / {gen_s[1]:.2f} s ({tokens_per_s:.1f} tokens/s host clock); "
        f"equal twice: {np.array_equal(a, b)}; {len(np.unique(a))} distinct ids")

    # Decode matches prefill: the incremental prefill's last logits against
    # the full-sequence forward on the same tokens.
    pre_logits = model_api.prefill(model, {"tokens": torch.from_numpy(prompt).to(device)})
    agreement = decode_vs_prefill(dec_logits, pre_logits, cfg, LM_TOL, check)
    check.expect(bool(np.isfinite(h32).all()) and h32.shape == (LM_BATCH, cfg.d_model),
                 "decode_hidden is not (B, d_model) finite")

    # The head on real hidden states: the kernels against their plain walks.
    kernel = head.topk_logits_batch(h32)
    plain = head.topk_logits_batch(h32, use_kernel=False)
    mq_ok, mq_err = compare(tuple(torch.from_numpy(t) for t in kernel),
                            tuple(torch.from_numpy(t) for t in plain), bitwise=False)
    check.expect(mq_ok, f"sample_approx's kernel vs plain walk (max err {mq_err:.3g})")
    check.expect(np.array_equal(ids, kernel[1][:, 0].astype(np.int64)),
                 "sample_approx ids differ from the kernel's top-1")
    one_ok, one_err = compare(
        tuple(torch.from_numpy(t) for t in head.topk_logits(h32[0])),
        tuple(torch.from_numpy(t) for t in head.topk_logits(h32[0], use_kernel=False)),
        bitwise=False)
    check.expect(one_ok, f"topk_logits kernel vs plain walk (max err {one_err:.3g})")
    overlap = float(np.mean(overlaps))
    check.expect(0.0 < overlap <= 1.0, f"overlap@{head.cfg.big_k} {overlap}")
    log(f"  head ({cfg.vocab_size} x {cfg.d_model}, {head.index.packed.nnz} nnz, built in "
        f"{head_build_s:.1f} s): sample_approx at Q = {LM_BATCH} vs plain max abs err "
        f"{mq_err:.3g} (ids equal outside near-ties: {mq_ok}); topk_logits vs plain "
        f"{one_err:.3g}; overlap@{head.cfg.big_k} {overlap:.4f} over {HEAD_EXACT} hidden "
        f"states (partition precision {head.partition_precision:.4f}); sampled == dense "
        f"argmax of tok in {int((ids == np.argmax(h32 @ head.embedding.T, -1)).sum())} of "
        f"{LM_BATCH} rows")

    out = {"model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "dtype": cfg.dtype, "cut": cut,
           "parameters": n_params, "weight_bytes": weight_bytes, "init_s": init_s,
           "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
           "head_build_s": head_build_s, "head_nnz": int(head.index.packed.nnz),
           "generate_s": gen_s, "tokens_per_s": tokens_per_s, **agreement,
           "sample_approx_vs_plain_max_abs": mq_err, "topk_logits_vs_plain_max_abs": one_err,
           "overlap_at_64": overlap, "partition_precision": head.partition_precision,
           "launches": launches}
    if on_card:
        out.update(lm_timing(torch, K, api, L, model, engine, hidden, cfg))
        out["init_max_memory_allocated"] = init_peak
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out["dryrun_count"] = dryrun_decode_count(torch, model_api, model)
        log(f"  peak device memory while serving {out['max_memory_allocated'] / 1e9:.3f} GB")
    check.done()
    return out


def lm_timing(torch, K, api, L, model, engine, hidden, cfg) -> dict:
    """Device times of phase 9: a decode step at B = 64 and 1 (CUDA events
    around each step, and the profiler's kernel time), ``sample_approx``'s
    kernel at Q = 64 and the dense logits + argmax it replaces, each beside
    its bound."""
    out = {}
    kv_heads, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    layer_bytes = sum(p.numel() * p.element_size() for p in model.blocks.parameters())
    layer_params = sum(p.numel() for p in model.blocks.parameters())
    for batch in (LM_BATCH, 1):
        cache = model.init_cache(batch, LM_MAX_SEQ)
        tok = torch.zeros((batch, 1), dtype=torch.int64, device="cuda")
        step = lambda: model.decode_step(cache, tok, LM_PROMPT, return_hidden=True)  # noqa: E731
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        times = [time_once(torch, step)[0] for _ in range(LM_TIMED_STEPS)]
        busy, top = profiled_kernels(torch, step)
        # Bytes a step must move: every layer's weights once, the valid
        # (pos + 1) cache rows read and one written per layer, k and v.
        kv = cfg.num_layers * 2 * batch * kv_heads * hd * 2
        nbytes = layer_bytes + kv * (LM_PROMPT + 1) + kv + batch * cfg.d_model * 2 * 2
        flops = 2.0 * batch * layer_params
        bound = max(nbytes / HBM_BYTES_PER_S, flops / H100_BF16_FLOPS) * 1e3
        ms = float(np.mean(times))
        out[f"decode_step_ms_b{batch}"] = ms
        out[f"decode_step_ms_each_b{batch}"] = times
        out[f"decode_step_kernel_ms_b{batch}"] = busy
        out[f"decode_step_kernels_b{batch}"] = top
        out[f"decode_step_bound_ms_b{batch}"] = bound
        out[f"decode_step_idle_share_b{batch}"] = None if busy is None else 1 - busy / ms
        log(f"  decode step B = {batch} (hidden only, pos {LM_PROMPT}): {ms:.3f} ms "
            f"(CUDA events, mean of {LM_TIMED_STEPS}: "
            f"{' / '.join(f'{t:.3f}' for t in times)}); kernels "
            f"{'not measured' if busy is None else f'{busy:.3f} ms'}; bound {bound:.3f} ms "
            f"({nbytes / 1e9:.3f} GB at 3.35 TB/s)")
        log(f"  decode step B = {batch} kernels per step (GEMMs' ms, launches, the "
            f"costliest): " + json.dumps(top))
        del cache

    head = engine.head
    index = head.index
    icfg = index.config
    ex = api.query_executor(icfg)
    snap = ex.prepare(index.packed, LM_BATCH, "kernel")[1]
    words = snap.streams[0]
    x = torch.from_numpy(hidden.float().cpu().numpy()).cuda()
    q_chunk, n_chunks = K.query_chunks(LM_BATCH)
    t, block = icfg.packets_per_step, icfg.block_size
    splits = K.topk_splits(words.device, words.shape[0], n_chunks, packets_per_step=t,
                           block_size=block, m=x.shape[1], q_chunk=q_chunk, k=icfg.k)
    tab = snap.split_table(t, splits)
    head_ms = time_cuda(torch, lambda: K.bscsr_topk_spmv_multiquery(
        x, words, table=tab, k=icfg.k, n_rows=snap.max_slots, packets_per_step=t,
        fmt_name=snap.fmt_name, block_size=block), MIXED_BUDGET_S)
    nbytes = words.numel() * 4 + LM_BATCH * x.shape[1] * 4 + words.shape[0] * LM_BATCH * icfg.k * 8
    head_bound = max(nbytes / HBM_BYTES_PER_S,
                     2.0 * index.packed.nnz * LM_BATCH / F32_FLOPS) * 1e3
    sample_ms = median_ms(lambda: engine.sample_approx(hidden))
    xb = hidden[:, None]
    dense_ms = time_cuda(torch, lambda: torch.argmax(L.lm_logits(model.embed, xb, cfg), -1))
    dense_bytes = cfg.d_model * cfg.padded_vocab * 2 + LM_BATCH * cfg.d_model * 2
    dense_bound = max(dense_bytes / HBM_BYTES_PER_S,
                      2.0 * LM_BATCH * cfg.d_model * cfg.padded_vocab / H100_BF16_FLOPS) * 1e3
    out.update({"head_kernel_ms": head_ms, "head_kernel_bound_ms": head_bound,
                "head_splits": splits, "sample_approx_host_ms": sample_ms,
                "dense_logits_argmax_ms": dense_ms, "dense_logits_bound_ms": dense_bound})
    log(f"  sample_approx at Q = {LM_BATCH}: the multi-query kernel {head_ms:.3f} ms (S = "
        f"{splits}, bound {head_bound:.4f} ms over {nbytes / 1e6:.1f} MB), the whole call "
        f"{sample_ms:.3f} ms host clock; the dense lm_logits + argmax it replaces "
        f"{dense_ms:.3f} ms (bound {dense_bound:.4f} ms, {dense_bytes / 1e9:.3f} GB)")
    return out


def families_phase(torch, K, seed, cfgs=None, device="cuda") -> dict:
    """Phase 10: Zamba2-7B, xLSTM-350M and Whisper-small at full width and
    ``FAM_DEPTH``'s depth (``cfgs`` replaces them for a CPU rehearsal), each
    the port's own init on the device from ``seed``, one at a time.

    Returns the phase's launches of the three kernels (counted from 0 before
    each model's drive; none lies on this path) and the ``FAMILIES`` line.
    """
    from repro_torch.configs import get_config

    on_card = device == "cuda"
    if cfgs is None:
        cfgs = {arch: dataclasses.replace(get_config(arch), **FAM_DEPTH[arch])
                for arch in FAMILY_ARCHS}
        cuts = {arch: ", ".join(f"{v} of {getattr(get_config(arch), k)} {k}"
                                for k, v in FAM_DEPTH[arch].items())
                for arch in FAMILY_ARCHS}
        log(f"CUT: phase 10 serves {cuts} (depth only: widths, vocabularies, block "
            f"structure and traffic kept), to keep the script inside its time limit")
    else:
        cuts = {arch: "widths cut for a CPU rehearsal" for arch in cfgs}
    out = {"launches": {name: 0 for name in REPLACES}}
    for arch, cfg in cfgs.items():
        t0 = time.time()
        drive = whisper_drive if cfg.family == "audio" else recurrent_drive
        res = drive(torch, K, cfg, seed, device)
        for name, n in res.pop("launches").items():
            out["launches"][name] += n
        res["cut"] = cuts[arch]
        res["phase_s"] = time.time() - t0
        out[arch] = res
        log(f"  {cfg.name}: {res['phase_s']:.1f} s")
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    log(f"  launches in the families phase: {out['launches']} (none of the three "
        f"kernels lies on these families' paths)")
    return out


def family_model(torch, cfg, seed, device, max_seq):
    """(model, whether its parameter count equals ``cfg.param_count()``
    (Whisper's ``dec_pos`` adds ``max_seq - 128`` rows), the init's numbers):
    the port's init on ``device``."""
    from repro_torch.models.model_zoo import get_model

    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = get_model(cfg).init_params(torch.Generator(device=device).manual_seed(seed),
                                       max_seq)
    if on_card:
        torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(p.numel() for p in model.parameters())
    want = cfg.param_count() + ((max_seq - 128) * cfg.d_model if cfg.family == "audio" else 0)
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    peak = None
    if on_card:
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    log(f"  {cfg.name} ({cfg.family}): {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.dtype}: {n_params} parameters (want {want}), {weight_bytes / 1e9:.3f} GB on "
        f"{device}; init {init_s:.1f} s" + ("" if peak is None else
                                           f", peak device memory {peak / 1e9:.3f} GB"))
    return model, n_params == want, {"parameters": n_params, "weight_bytes": weight_bytes,
                                     "init_s": init_s, "init_max_memory_allocated": peak}


def family_generate(engine, prompt, check, vocab):
    """``generate(prompt, FAM_GEN)`` twice: (tokens, host seconds of each)."""
    gen_s, runs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(engine.generate(prompt, num_steps=FAM_GEN).tokens)
        gen_s.append(time.perf_counter() - t0)
    a, b = runs
    check.expect(a.shape == (prompt.shape[0], FAM_GEN) and np.array_equal(a, b),
                 "generate gave other tokens the second time")
    check.expect(bool(((a >= 0) & (a < vocab)).all()), "a generated token lies outside [0, vocab)")
    return a, gen_s


def recurrent_drive(torch, K, cfg, seed, device) -> dict:
    """Zamba2-7B or xLSTM-350M: ``ServingEngine(batch_size=64, max_seq=128)``
    with no head, 64 prompts of 16 tokens through ``generate(prompt, 32)``
    twice; the incremental prefill against ``api.prefill``; each recurrent
    kind's first block chunked against its decode block stepped
    ``FAM_BLOCK_SEQ`` times at B = 2, in float32 and bfloat16; on the card
    the decode step's timings."""
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve import ServingEngine

    check = Check(f"families / {cfg.name}")
    api = get_model(cfg)
    model, count_ok, out = family_model(torch, cfg, seed, device, FAM_MAX_SEQ)
    check.expect(count_ok, "parameters differ from param_count()")
    rng = np.random.default_rng(seed + 10)
    prompt = rng.integers(0, cfg.vocab_size, (FAM_BATCH, FAM_PROMPT)).astype(np.int32)
    K.reset_launch_counts()
    engine = ServingEngine(cfg, model, batch_size=FAM_BATCH, max_seq=FAM_MAX_SEQ, device=device)
    tokens, gen_s = family_generate(engine, prompt, check, cfg.vocab_size)
    dec_logits, _, _ = engine.prefill_tokens(prompt)
    launches = launch_counts(K)

    pre = api.prefill(model, {"tokens": torch.from_numpy(prompt).to(device)})
    out.update(decode_vs_prefill(dec_logits, pre, cfg, FAM_TOL[cfg.family], check))
    out.update({"batch": FAM_BATCH, "prompt": FAM_PROMPT, "gen": FAM_GEN,
                "generate_s": gen_s, "tokens_per_s": FAM_BATCH * FAM_GEN / gen_s[1],
                "distinct_ids": int(len(np.unique(tokens))), "launches": launches})
    log(f"  generate: {FAM_BATCH} requests x ({FAM_PROMPT} + {FAM_GEN}) tokens in "
        f"{gen_s[0]:.2f} / {gen_s[1]:.2f} s ({out['tokens_per_s']:.1f} tokens/s host clock), "
        f"equal twice, {out['distinct_ids']} distinct ids")
    out["blocks"] = block_checks(torch, model, cfg, seed, device, check)
    if device == "cuda":
        out.update(family_timing(torch, model, cfg, FAM_MAX_SEQ, FAM_PROMPT))
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"  peak device memory while serving {out['max_memory_allocated'] / 1e9:.3f} GB")
    check.done()
    return out


def launch_counts(K) -> dict:
    return {name: getattr(K, name).launches for name in REPLACES}


def decode_vs_prefill(dec_logits, ref_logits, cfg, tol, check, what="prefill") -> dict:
    """The incremental decode's last logits against ``what``'s, within
    ``tol``; argmax equal wherever the top-2 gap exceeds it."""
    dl = dec_logits.float().cpu().numpy()[:, :cfg.vocab_size]
    pl = ref_logits.float().cpu().numpy()[:, :cfg.vocab_size]
    diff = float(np.abs(dl - pl).max())
    top2 = np.sort(pl, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > tol
    agree = dl.argmax(-1) == pl.argmax(-1)
    log(f"  decode vs {what} at the last position: max abs diff {diff:.4g} (tolerance {tol}, "
        f"|logit| up to {float(np.abs(pl).max()):.3g}); argmax agrees in {int(agree.sum())} "
        f"of {len(agree)} rows, in {int(agree[clear].sum())} of the {int(clear.sum())} whose "
        f"top-2 gap exceeds the tolerance")
    check.expect(bool(np.isfinite(dl).all()), f"decode logits vs {what}: not finite")
    check.expect(diff <= tol, f"decode vs {what} differ by {diff:.4g} > {tol}")
    check.expect(bool(agree[clear].all()), f"decode and {what} argmax differ past a clear gap")
    return {f"decode_vs_{what}_max_abs": diff, "tolerance": tol}


def block_state(torch, kind, cfg, dt, device, batch=2) -> tuple:
    """A recurrent kind's zero decode state (its conv state in ``dt``)."""
    from repro_torch.models import ssm, xlstm

    if kind == "slstm":
        return xlstm.slstm_state(cfg, batch, device)
    zeros = lambda *shape, dtype=torch.float32: torch.zeros(  # noqa: E731
        shape, dtype=dtype, device=device)
    if kind == "mamba":
        _, h, pd, n, conv_dim = ssm.dims(cfg)
        return zeros(batch, h, pd, n), zeros(batch, cfg.ssm_conv - 1, conv_dim, dtype=dt)
    di, h, dh = xlstm.dims(cfg)
    return (zeros(batch, h, dh, dh), zeros(batch, h, dh),
            torch.full((batch, h), xlstm.MIN_LOG, device=device),
            zeros(batch, cfg.ssm_conv - 1, di, dtype=dt))


def block_checks(torch, model, cfg, seed, device, check) -> dict:
    """Each recurrent kind's first block at full width: the chunked (or, for
    the sLSTM, whole-sequence) block against its decode block stepped
    ``FAM_BLOCK_SEQ`` times (two chunks of 128), at B = 2, in float32 (the
    block's weights cast up) and in bfloat16 (as held)."""
    from repro_torch.models import ssm, xlstm

    full_fn = {"mamba": ssm.mamba_block, "mlstm": xlstm.mlstm_block,
               "slstm": xlstm.slstm_block}
    step_fn = {"mamba": lambda p, xt, s: ssm.mamba_decode_block(p, xt, *s, cfg),
               "mlstm": lambda p, xt, s: xlstm.mlstm_decode_block(p, xt, *s, cfg),
               "slstm": lambda p, xt, s: xlstm.slstm_decode_block(p, xt, s, cfg)}
    if cfg.family == "hybrid":
        kinds = {"mamba": model.mamba[0][0]}
    else:
        kinds = {"slstm": model.slstm[0], "mlstm": model.mlstm[0][0]}
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    x32 = torch.randn((2, FAM_BLOCK_SEQ, cfg.d_model), generator=gen, device=device) * 0.5
    out = {}
    for kind, blk in kinds.items():
        for dt, tol in ((torch.float32, FAM_BLOCK_TOL_F32), (torch.bfloat16, FAM_BLOCK_TOL_BF16)):
            p = {k: v.to(dt) if dt == torch.float32 else v for k, v in blk.named_parameters()}
            x = x32.to(dt)
            full = full_fn[kind](p, x, cfg).float()
            state = block_state(torch, kind, cfg, dt, device)
            outs = []
            for t in range(FAM_BLOCK_SEQ):
                o, *rest = step_fn[kind](p, x[:, t:t + 1], state)
                state = rest[0] if kind == "slstm" else tuple(rest)
                outs.append(o)
            diff = float((full - torch.cat(outs, 1).float()).abs().max())
            scale = float(full.abs().max())
            out[f"{kind}_{str(dt).split('.')[1]}"] = {"max_abs": diff, "max_out": scale,
                                                       "tolerance": tol}
            log(f"  {kind} block 0 at full width, S = {FAM_BLOCK_SEQ} (chunk "
                f"{ssm.chunk_len(cfg, FAM_BLOCK_SEQ)}), B = 2, {dt}: chunked vs stepped max abs "
                f"diff {diff:.4g} (|out| up to {scale:.3g}; tolerance {tol})")
            check.expect(diff <= tol, f"{kind} {dt} chunked vs stepped differ by {diff:.4g} "
                                      f"> {tol}")
    return out


def whisper_drive(torch, K, cfg, seed, device) -> dict:
    """Whisper-small with ``FAM_WHISPER_SEQ`` decoder positions: frame
    embeddings (64, 1500, d) from ``seed`` through ``encode`` and
    ``build_cross_cache(pad_to=1500)`` (``cross_len`` 1500); 16 prompt
    tokens decoded step by step against ``decode_train`` + ``lm_logits``;
    32 greedy steps through ``api.decode_step``; ``ServingEngine(...,
    max_seq=1500).generate(prompt, 32)`` twice (the reference's path, with an
    empty cross cache); on the card the timings."""
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import get_model
    from repro_torch.serve import ServingEngine

    check = Check(f"families / {cfg.name}")
    api = get_model(cfg)
    s_enc = FAM_WHISPER_SEQ
    model, count_ok, out = family_model(torch, cfg, seed, device, s_enc)
    check.expect(count_ok, "parameters differ from param_count() + the dec_pos rows")
    gen = torch.Generator(device=device).manual_seed(seed + 12)
    frames = torch.randn((FAM_BATCH, s_enc, cfg.d_model), generator=gen, device=device)
    rng = np.random.default_rng(seed + 12)
    prompt = rng.integers(0, cfg.vocab_size, (FAM_BATCH, FAM_PROMPT)).astype(np.int32)
    toks = torch.from_numpy(prompt).to(device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    K.reset_launch_counts()
    t0 = time.time()
    enc = model.encode(frames)
    sync()
    encode_s = time.time() - t0
    cache = api.init_cache(FAM_BATCH, s_enc, device)
    cache["cross_k"], cache["cross_v"] = model.build_cross_cache(enc, pad_to=s_enc)
    cache["cross_len"].fill_(s_enc)
    for t in range(FAM_PROMPT):
        logits, cache = api.decode_step(model, cache, toks[:, t:t + 1], t)
    t0 = time.time()
    tok = torch.argmax(logits, dim=-1)[:, None]
    greedy = []
    for i in range(FAM_GEN):
        greedy.append(tok)
        step_logits, cache = api.decode_step(model, cache, tok, FAM_PROMPT + i)
        tok = torch.argmax(step_logits, dim=-1)[:, None]
    greedy = torch.cat(greedy, 1).cpu().numpy()
    greedy_s = time.time() - t0
    del cache
    engine = ServingEngine(cfg, model, batch_size=FAM_BATCH, max_seq=s_enc, device=device)
    tokens, gen_s = family_generate(engine, prompt, check, cfg.vocab_size)
    launches = launch_counts(K)

    tf = L.lm_logits(model.embed, model.decode_train(toks, enc)[:, -1:], cfg)[:, 0]
    out.update(decode_vs_prefill(logits, tf, cfg, FAM_WHISPER_TOL, check, "teacher_forcing"))
    check.expect(bool(((greedy >= 0) & (greedy < cfg.vocab_size)).all()),
                 "a greedy token over the cross cache lies outside [0, vocab)")
    out.update({"batch": FAM_BATCH, "s_enc": s_enc, "prompt": FAM_PROMPT, "gen": FAM_GEN,
                "encode_s_host": encode_s, "greedy_s": greedy_s, "generate_s": gen_s,
                "tokens_per_s": FAM_BATCH * FAM_GEN / gen_s[1],
                "greedy_tokens_per_s": FAM_BATCH * FAM_GEN / greedy_s,
                "distinct_ids": int(len(np.unique(tokens))),
                "greedy_distinct_ids": int(len(np.unique(greedy))), "launches": launches})
    log(f"  encode ({FAM_BATCH} x {s_enc} frames) {encode_s:.2f} s host clock; "
        f"{FAM_GEN} greedy steps over the cross cache in {greedy_s:.2f} s; generate (empty "
        f"cross cache) {gen_s[0]:.2f} / {gen_s[1]:.2f} s ({out['tokens_per_s']:.1f} tokens/s), "
        f"equal twice")
    if device == "cuda":
        out.update(family_timing(torch, model, cfg, s_enc, FAM_PROMPT, enc=enc))
        out.update(encode_timing(torch, model, cfg, frames))
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"  peak device memory while serving {out['max_memory_allocated'] / 1e9:.3f} GB")
    check.done()
    return out


def decode_bytes(model, cfg, cache, batch) -> tuple:
    """(bytes a decode step must move, weights its products multiply) from
    the tensors held: every decoder-side weight once (no encoder weight; of
    an untied ``embed.tok`` the ``batch`` rows looked up, of ``dec_pos`` one
    row), each cache tensor read whole (``decode_attention`` masks the KV, it
    does not slice it), the recurrent states written back, the logits
    written."""
    nbytes = params = 0
    for name, p in model.named_parameters():
        if name.startswith("enc_"):
            continue
        if name == "dec_pos" or (name == "embed.tok" and not cfg.tie_embeddings):
            nbytes += (1 if name == "dec_pos" else batch) * p.shape[1] * p.element_size()
            continue
        nbytes += p.numel() * p.element_size()
        params += p.numel()
    for name, t in cache.items():
        written = name in ("ssm", "conv") or name.startswith(("m_", "s_"))
        nbytes += t.numel() * t.element_size() * (2 if written else 1)
    return nbytes + batch * cfg.padded_vocab * 2, params


def family_timing(torch, model, cfg, max_seq, pos, enc=None) -> dict:
    """A decode step at B = 64 and 1 (CUDA events around each step, and the
    profiler's kernel time and launches) beside its bound; Whisper's steps
    read a full cross cache built from ``enc``."""
    from repro_torch.models.model_zoo import get_model

    api = get_model(cfg)
    out = {}
    for batch in (FAM_BATCH, 1):
        cache = api.init_cache(batch, max_seq, "cuda")
        if enc is not None:
            cache["cross_k"], cache["cross_v"] = model.build_cross_cache(enc[:batch],
                                                                         pad_to=max_seq)
            cache["cross_len"].fill_(enc.shape[1])
        tok = torch.zeros((batch, 1), dtype=torch.int64, device="cuda")
        step = lambda: api.decode_step(model, cache, tok, pos)  # noqa: E731
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        times = [time_once(torch, step)[0] for _ in range(FAM_TIMED_STEPS)]
        busy, top = profiled_kernels(torch, step)
        nbytes, params = decode_bytes(model, cfg, cache, batch)
        bound = max(nbytes / HBM_BYTES_PER_S, 2.0 * batch * params / H100_BF16_FLOPS) * 1e3
        ms = float(np.mean(times))
        out.update({f"decode_step_ms_b{batch}": ms, f"decode_step_ms_each_b{batch}": times,
                    f"decode_step_kernel_ms_b{batch}": busy,
                    f"decode_step_kernels_b{batch}": top,
                    f"decode_step_bytes_b{batch}": nbytes,
                    f"decode_step_bound_ms_b{batch}": bound,
                    f"decode_step_idle_share_b{batch}": None if busy is None else 1 - busy / ms})
        log(f"  decode step B = {batch} (pos {pos}): {ms:.3f} ms (CUDA events, mean of "
            f"{FAM_TIMED_STEPS}: {' / '.join(f'{t:.3f}' for t in times)}); kernels "
            f"{'not measured' if busy is None else f'{busy:.3f} ms'}; bound {bound:.3f} ms "
            f"({nbytes / 1e9:.3f} GB at 3.35 TB/s)")
        log(f"  decode step B = {batch} kernels per step: " + json.dumps(top))
        del cache
    return out


def encode_timing(torch, model, cfg, frames) -> dict:
    """Whisper's ``encode`` at B = 64 x 1500 (CUDA events) beside its FLOP
    bound: the projections' 2 * tokens * encoder weights and the attention's
    4 * B * S^2 * d products, at the bf16 tensor-core peak."""
    ms = float(np.mean([time_once(torch, lambda: model.encode(frames))[0] for _ in range(3)]))
    b, s, d = frames.shape
    enc_params = sum(p.numel() for n, p in model.named_parameters()
                     if n.startswith("enc_blocks") and p.dim() == 2)
    flops = 2.0 * b * s * enc_params + 4.0 * b * s * s * d * cfg.encoder_layers
    bound = flops / H100_BF16_FLOPS * 1e3
    log(f"  encode B = {b} x {s}: {ms:.3f} ms (CUDA events, mean of 3); bound {bound:.3f} ms "
        f"({flops / 1e12:.2f} TFLOP at 989 TFLOP/s bf16)")
    return {"encode_ms": ms, "encode_bound_ms": bound, "encode_flops": flops}


def train_phase(torch, K, seed, root) -> dict:
    """Phase 11: SmolLM-360M trained at full width and depth on the card
    through ``repro_torch.train.loop.train``.

    The port's own init from ``seed``; B = 32 x S = 2048 in 4 microbatches,
    lr 1e-3 with 2 warm-up steps.  ``TRAIN_STEPS`` steps uninterrupted
    (checkpoint at step ``TRAIN_CKPT_AT``, under ``root/full``); that
    checkpoint restored (timed) and saved (timed) into ``root/part``, which
    then holds it alone; a second ``train`` there resumes to the last step.  Both runs under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, so that an op
    without a deterministic version warns and is named.  Checks: finite
    losses, the last step's below step 0's, the resumed steps' losses equal to the
    uninterrupted run's bit for bit, no non-deterministic op warned, the
    three kernels launched 0 times, and one smoke-size step on the card equal
    to the same step on the CPU (``repro_torch.train.parity``).  Returns the
    drive's launches and the ``TRAIN`` line.
    """
    import warnings

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import parity
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.loop import train

    check = Check("train")
    cut = (f"{TRAIN_STEPS} steps (checkpoint at {TRAIN_CKPT_AT}) and a resume of "
           f"{TRAIN_STEPS - TRAIN_CKPT_AT}, where the cell has 8 and a resume of 4")
    log(f"CUT: phase 11 trains {cut} (the run's length only: widths, depth, batch, "
        f"sequence and microbatches kept), to keep the script inside its time limit")
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig("train_cell", "train", TRAIN_SEQ, TRAIN_BATCH)
    shutil.rmtree(root, ignore_errors=True)
    full, part = root / "full", root / "part"
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, steps=TRAIN_STEPS,
                     microbatches=TRAIN_MICRO, seed=seed, checkpoint_every=TRAIN_CKPT_AT,
                     checkpoint_dir=str(full))
    n_params = cfg.param_count()
    log(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} / "
        f"{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}: {n_params} parameters; "
        f"B {TRAIN_BATCH} x S {TRAIN_SEQ} in {TRAIN_MICRO} microbatches")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.time()
            out = train(cfg, shape, tc, device="cuda", log_every=1)
            run_s = time.time() - t0
            peak = torch.cuda.max_memory_allocated()
            history, step_ms = out["history"], out["step_ms"]
            like = {"params": out["masters"], "opt": opt_lib.init_opt_state(out["masters"])}
            del out
            ckpt_bytes = sum(f.stat().st_size for f in full.glob(f"ckpt_{TRAIN_CKPT_AT:08d}.*"))
            t0 = time.time()
            _, state = CheckpointManager(str(full)).restore(like, step=TRAIN_CKPT_AT,
                                                            device="cuda")
            restore_s = time.time() - t0
            del like
            t0 = time.time()
            CheckpointManager(str(part), async_save=False).save(TRAIN_CKPT_AT, state)
            save_s = time.time() - t0
            del state
            gc.collect()
            t0 = time.time()
            again = train(cfg, shape, dataclasses.replace(tc, checkpoint_dir=str(part)),
                          device="cuda", log_every=1)
            resume_s = time.time() - t0
        nondeterministic = sorted({str(w.message).split("\n")[0][:160] for w in caught
                                   if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
    launches = launch_counts(K)

    check.expect(len(history) == TRAIN_STEPS and bool(np.isfinite(history).all()),
                 f"losses {history}")
    check.expect(history[-1] < history[0], f"step {TRAIN_STEPS - 1}'s loss {history[-1]} is "
                                           f"not below step 0's {history[0]}")
    resumed = again["history"]
    check.expect(len(resumed) == TRAIN_STEPS - TRAIN_CKPT_AT,
                 f"the resume ran {len(resumed)} steps, not {TRAIN_STEPS - TRAIN_CKPT_AT}")
    resume_diff = float(np.abs(np.subtract(resumed, history[TRAIN_CKPT_AT:])).max())
    check.expect(resume_diff == 0.0, f"the resumed losses differ by {resume_diff:.3g} "
                                     f"(non-deterministic ops warned: {nondeterministic})")
    check.expect(not nondeterministic, f"non-deterministic ops on the training path: "
                                       f"{nondeterministic}")
    log(f"  losses {history}; resumed from step {TRAIN_CKPT_AT}: {resumed} (max difference "
        f"{resume_diff:.3g}; non-deterministic ops warned: {nondeterministic or 'none'})")
    log(f"  launches in the train phase: {launches} (none of the three kernels lies on the "
        f"training path)")
    for name, n in launches.items():
        check.expect(n == 0, f"{name} launched {n} times on the training path")

    smoke = dict(parity.step_vs_cpu("cuda"), tolerance=parity.STEP_TOL)
    log("  smoke step on the card vs the CPU: " + json.dumps(smoke))
    for key, tol in parity.STEP_TOL.items():
        check.expect(smoke[key] <= tol, f"smoke step {key} differs by {smoke[key]:.3g} "
                                        f"(tolerance {tol})")
    check.expect(smoke["masters_on_device"] and smoke["model_refreshed"],
                 "smoke step: the masters left the card or the model was not refreshed")
    del again
    gc.collect()

    tokens = TRAIN_BATCH * TRAIN_SEQ
    timed = step_ms[-TRAIN_TIMED:]
    ms = float(np.median(timed))
    hd, heads = cfg.resolved_head_dim, cfg.num_heads
    flops_per_token = 6.0 * n_params + 12.0 * cfg.num_layers * TRAIN_SEQ * heads * hd
    bound_ms = flops_per_token * tokens / H100_BF16_FLOPS * 1e3
    res = {"arch": cfg.name, "cut": cut, "params": n_params, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO, "steps": TRAIN_STEPS,
           "losses": history, "resumed_losses": resumed, "resume_max_diff": resume_diff,
           "nondeterministic_ops": nondeterministic, "step_ms_each": step_ms,
           "step_ms": ms, "tokens_per_step": tokens, "tokens_per_s": tokens / ms * 1e3,
           "flops_per_token": flops_per_token, "bound_ms": bound_ms,
           "bound_share": bound_ms / ms, "run_s": run_s, "resume_s": resume_s,
           "checkpoint_bytes": ckpt_bytes, "checkpoint_save_s": save_s,
           "checkpoint_restore_s": restore_s, "smoke_step": smoke,
           "peak_memory_gb": peak / 1e9, "launches": launches}
    res.update(profiled_train_step(torch, cfg, shape, tc, seed, ms))
    check.expect(res["peak_memory_gb"] < 80.0, "peak memory above the card's 80 GB")
    log(f"  train step {ms:.1f} ms (CUDA events, median of the last {len(timed)}: "
        f"{' / '.join(f'{t:.1f}' for t in timed)}), {res['tokens_per_s']:.0f} tokens/s; "
        f"bound {bound_ms:.1f} ms ({flops_per_token * tokens / 1e12:.1f} TFLOP at 989 TFLOP/s "
        f"bf16): {100 * bound_ms / ms:.1f}% reached")
    log(f"  checkpoint {ckpt_bytes / 1e9:.3f} GB: save {save_s:.2f} s, restore {restore_s:.2f} s")
    # Four checkpoints of 4.3 GB: phase 13 resumes from the first and checks
    # against the resumed run's last; the other two go now.
    (full / f"ckpt_{TRAIN_STEPS:08d}.npz").unlink()
    (part / f"ckpt_{TRAIN_CKPT_AT:08d}.npz").unlink()
    check.done()
    return res


def train_mesh_phase(torch, K, seed, root, trained) -> dict:
    """Phase 13: the training mesh at SmolLM-360M's full width and depth.

    (a) Phase 11's step-``TRAIN_CKPT_AT`` checkpoint (saved from one device)
    restored onto a ``TRAIN_MESH`` ("data", "model") mesh of this card's
    positions by ``train(..., mesh=...)`` with phase 11's ``TrainConfig``,
    run to ``TRAIN_STEPS`` under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: its losses must be phase 11's bit for bit, and its
    final checkpoint, restored onto one device, must hold phase 11's final
    masters and moments bit for bit.  Printed: the step's ms, each
    position's piece bytes (masters and moments), the peak memory.

    (b) ``pipelined_loss_fn`` with ``PIPE_MESH``'s 4 stages and
    ``PIPE_MICRO`` microbatches at B ``PIPE_BATCH`` x S ``PIPE_SEQ`` on
    float32 working weights (TF32 off), against the sequential ``loss_fn``
    on the same weights and batch: loss and every gradient leaf within
    ``PIPE_LOSS_RTOL`` / ``PIPE_GRAD_TOL``.  Every position is this card, so
    the moves between stages are no-ops: the times say what the schedule
    costs on one device, not what copies between cards cost.

    ``trained`` is phase 11's result; phase 11 leaves its two checkpoints
    under ``root``, which this phase removes.  None of the three kernels
    lies on these paths: their launches here must be 0.
    """
    import warnings

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import data as data_lib
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.loop import train
    from repro_torch.train.pipeline import pipelined_loss_fn

    check = Check("train mesh")
    t_phase = time.time()
    card = torch.device("cuda", 0)
    cfg = get_config(TRAIN_ARCH)

    def fresh_memory() -> None:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def peak_gb() -> float:
        return torch.cuda.max_memory_allocated() / 1e9

    shape = ShapeConfig("train_cell", "train", TRAIN_SEQ, TRAIN_BATCH)
    mesh_dir = root / "mesh"
    shutil.rmtree(mesh_dir, ignore_errors=True)
    mesh_dir.mkdir(parents=True)
    shutil.copy(root / "full" / f"ckpt_{TRAIN_CKPT_AT:08d}.npz", mesh_dir)
    mesh = DeviceMesh(np.full(TRAIN_MESH, card, dtype=object), ("data", "model"))
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, steps=TRAIN_STEPS,
                     microbatches=TRAIN_MICRO, seed=seed, checkpoint_every=TRAIN_CKPT_AT,
                     checkpoint_dir=str(mesh_dir))
    log(f"  (a) phase 11's step-{TRAIN_CKPT_AT} checkpoint (one device) resumed on a "
        f"{TRAIN_MESH[0]} x {TRAIN_MESH[1]} (data, model) mesh of {card} positions to step "
        f"{TRAIN_STEPS}: {cfg.name} at full width and depth, B {TRAIN_BATCH} x S {TRAIN_SEQ} "
        f"in {TRAIN_MICRO} microbatches")
    fresh_memory()
    K.reset_launch_counts()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.time()
            out = train(cfg, shape, tc, mesh=mesh, log_every=1)
            resume_s = time.time() - t0
        nondeterministic = sorted({str(w.message).split("\n")[0][:160] for w in caught
                                   if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
    peak = peak_gb()
    want = trained["losses"][TRAIN_CKPT_AT:]
    losses_equal = out["history"] == want
    check.expect(losses_equal, f"mesh resume losses {out['history']} != phase 11's "
                                         f"{want}")
    check.expect(not nondeterministic, f"non-deterministic ops: {nondeterministic}")
    piece_bytes = {}
    for arrs in (out["masters"], out["opt_state"]["mu"], out["opt_state"]["nu"]):
        for arr in arrs.values():
            for pos, t in arr.pieces.items():
                key = "x".join(map(str, pos))
                piece_bytes[key] = piece_bytes.get(key, 0) + t.numel() * t.element_size()
    step_ms = out["step_ms"]
    log(f"  losses {out['history']} == phase 11's {want}: {losses_equal}; step "
        f"{' / '.join(f'{t:.1f}' for t in step_ms)} ms (CUDA events; phase 11's "
        f"{trained['step_ms']:.1f}); piece bytes by position {piece_bytes} (unsharded "
        f"{3 * 4 * cfg.param_count()}); peak {peak:.2f} GB; resume {resume_s:.1f} s")
    del out
    fresh_memory()

    # The mesh run's final checkpoint onto one device against phase 11's final one.
    shapes = {n: tuple(p.shape) for n, p in get_model(cfg).build("meta", 1).named_parameters()}
    meta = {n: torch.empty(sh, device="meta") for n, sh in shapes.items()}
    like = {"params": meta, "opt": {"mu": meta, "nu": meta, "step": torch.zeros(())}}
    t0 = time.time()
    _, mine = CheckpointManager(str(mesh_dir)).restore(like, step=TRAIN_STEPS, device=card)
    restore_s = time.time() - t0
    _, theirs = CheckpointManager(str(root / "part")).restore(like, step=TRAIN_STEPS,
                                                              device=card)
    def trees(state):
        return {"masters": state["params"], "mu": state["opt"]["mu"], "nu": state["opt"]["nu"]}

    differ = {part: sorted(n for n, t in tree.items() if not torch.equal(t, trees(theirs)[part][n]))
              for part, tree in trees(mine).items()}
    same_step = int(mine["opt"]["step"]) == int(theirs["opt"]["step"]) == TRAIN_STEPS
    check.expect(not any(differ.values()) and same_step,
                 f"the mesh run's final state restored onto one device differs from phase "
                 f"11's: {({k: v[:4] for k, v in differ.items() if v})}, step {same_step}")
    log(f"  the mesh run's step-{TRAIN_STEPS} checkpoint restored onto one device "
        f"({restore_s:.1f} s): masters, mu, nu and step == phase 11's final bit for bit: "
        f"{not any(differ.values()) and same_step}")
    del mine, theirs
    shutil.rmtree(root, ignore_errors=True)
    fresh_memory()

    # (b) the pipeline at full width, float32 working weights, TF32 off.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    pshape = ShapeConfig("pipeline", "train", PIPE_SEQ, PIPE_BATCH)
    pmesh = DeviceMesh(np.full(PIPE_MESH, card, dtype=object), ("stage", "data", "model"))
    stages = PIPE_MESH[0]
    ticks = PIPE_MICRO + stages - 1
    model = get_model(cfg32).init_params(torch.Generator(device=card).manual_seed(seed),
                                         PIPE_SEQ)
    batch = data_lib.batch_for_step(0, cfg32, pshape, seed, 1, card)
    names, weights = zip(*model.named_parameters())
    for w in weights:
        w.requires_grad_(True)

    def timed(fn):
        """(loss, gradients, ms of CUDA events)."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        loss = fn()
        grads = torch.autograd.grad(loss, weights)
        ev[1].record()
        torch.cuda.synchronize()
        return float(loss.detach()), grads, ev[0].elapsed_time(ev[1])

    seq_loss, seq_grads, seq_ms = timed(lambda: model.loss_fn(batch))
    pipe_loss, pipe_grads, pipe_ms = timed(
        lambda: pipelined_loss_fn(model, cfg32, batch, pmesh, PIPE_MICRO))
    pipe_peak = peak_gb()
    for w in weights:
        w.requires_grad_(False)
    loss_rel = abs(pipe_loss - seq_loss) / abs(seq_loss)
    worst, worst_leaf = 0.0, None
    for name, a, b in zip(names, pipe_grads, seq_grads):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)
        if err > worst:
            worst, worst_leaf = err, name
    check.expect(loss_rel <= PIPE_LOSS_RTOL, f"pipelined loss {pipe_loss} vs sequential "
                                             f"{seq_loss}: {loss_rel:.3g} relative")
    check.expect(worst <= PIPE_GRAD_TOL, f"pipelined gradient {worst_leaf} off by {worst:.3g} "
                                         f"of max(|g|, 1)")
    log(f"  (b) pipeline: {stages} stages x {PIPE_MICRO} microbatches on a {PIPE_MESH} "
        f"(stage, data, model) mesh of {card} positions, {ticks} ticks (bubble "
        f"{stages - 1}/{ticks}), B {PIPE_BATCH} x S {PIPE_SEQ} at float32: loss {pipe_loss} vs "
        f"sequential {seq_loss} ({loss_rel:.3g} relative); worst gradient {worst_leaf} "
        f"{worst:.3g} of max(|g|, 1); loss + backward {pipe_ms:.1f} ms pipelined, "
        f"{seq_ms:.1f} ms sequential (CUDA events); peak {pipe_peak:.2f} GB")
    del model, seq_grads, pipe_grads, batch
    fresh_memory()

    launches = launch_counts(K)
    for name, n in launches.items():
        check.expect(n == 0, f"{name} launched {n} times on the training mesh's paths")
    phase_s = time.time() - t_phase
    res = {"mesh": dict(zip(("data", "model"), TRAIN_MESH)), "losses": want,
           "mesh_losses_equal": losses_equal, "step_ms_each": step_ms,
           "phase11_step_ms": trained["step_ms"], "piece_bytes_by_position": piece_bytes,
           "unsharded_bytes": 3 * 4 * cfg.param_count(), "peak_memory_gb": peak,
           "resume_s": resume_s, "restore_one_device_s": restore_s,
           "restored_differ": differ, "nondeterministic_ops": nondeterministic,
           "pipeline": {"mesh": dict(zip(("stage", "data", "model"), PIPE_MESH)),
                        "microbatches": PIPE_MICRO, "batch": PIPE_BATCH, "seq": PIPE_SEQ,
                        "ticks": ticks, "bubble_share": (stages - 1) / ticks,
                        "loss": pipe_loss, "sequential_loss": seq_loss,
                        "loss_rel_err": loss_rel, "grad_err": worst, "grad_err_leaf": worst_leaf,
                        "ms": pipe_ms, "sequential_ms": seq_ms, "peak_memory_gb": pipe_peak,
                        "tolerance": {"loss_rtol": PIPE_LOSS_RTOL, "grad": PIPE_GRAD_TOL}},
           "launches": launches, "phase_s": phase_s}
    log(f"  train mesh phase's own {phase_s:.1f} s")
    check.done()
    return res


def profiled_train_step(torch, cfg, shape, tc, seed, step_ms) -> dict:
    """One train step at the cell's shapes under ``torch.profiler``: kernel ms,
    the idle share against the timed step, launches and the costliest
    kernels (from a fresh init: the cost does not depend on the values)."""
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import data as data_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.loop import init_train_state

    model, masters, opt = init_train_state(cfg, tc, shape.seq_len, "cuda")
    batch = data_lib.batch_for_step(0, cfg, shape, seed, tc.microbatches, "cuda")
    step = opt_lib.make_train_step(get_model(cfg).loss_fn, tc)
    busy, top = profiled_kernels(torch, lambda: step(model, masters, opt, batch), steps=1)
    log(f"  a profiled train step: kernels {'not measured' if busy is None else f'{busy:.1f} ms'}"
        f" of {step_ms:.1f} ms; " + json.dumps(top))
    return {"kernel_ms": busy, "idle_share": None if busy is None else 1 - busy / step_ms,
            "kernels": top}


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dryrun_query_count(torch, K, words, x64, kw, main_cores) -> dict:
    """Phase 14 (b), at the end of phase 4: one Q = 64 pass of the
    multi-query kernel over phase 3's snapshot (before ingest), at the
    card's S with its split table built beforehand, under an
    ``op_costs.OpCounter``.  Returns the counted costs, the launches it
    made (one of the kernel, none of a plain walk) and the bytes that
    phase 4's Q = 64 bound counts."""
    from repro_torch.launch import op_costs

    q = x64.shape[0]
    q_chunk, n_chunks = K.query_chunks(q)
    t, block = kw["packets_per_step"], kw["block_size"]
    splits = K.topk_splits(words.device, words.shape[0], n_chunks, packets_per_step=t,
                           block_size=block, m=x64.shape[1], q_chunk=q_chunk, k=kw["k"])
    tab = K.spmv_split_table(words, packets_per_step=t, block_size=block, splits=splits)
    torch.cuda.synchronize()
    before = launch_counts(K)
    with op_costs.OpCounter() as counter:
        K.bscsr_topk_spmv_multiquery(x64, words, table=tab, **kw)
    torch.cuda.synchronize()
    after = launch_counts(K)
    return {"costs": counter.costs(), "shape": list(words.shape), "q": q,
            "n_cols": x64.shape[1], "kw": dict(kw),
            "launches": {name: after[name] - before[name] for name in after},
            "bound_bytes": words.numel() * 4 + q * x64.shape[1] * 4 + main_cores * q * kw["k"] * 8}


def dryrun_decode_count(torch, model_api, model) -> dict:
    """Phase 14 (b), at the end of phase 9: ``api.decode_step`` at B =
    ``LM_BATCH`` against an ``LM_MAX_SEQ``-deep cache at its last position
    (the dry run's decode cell) on phase 9's model, once under an
    ``op_costs.OpCounter`` (after one warm-up), then ``LM_TIMED_STEPS``
    times with CUDA events.  Returns the counted costs, the step's ms, the
    bytes it holds (weights, cache, tokens) and its peak memory."""
    from repro_torch.launch import op_costs

    cache = model_api.init_cache(LM_BATCH, LM_MAX_SEQ, device="cuda")
    tokens = torch.zeros((LM_BATCH, 1), dtype=torch.int32, device="cuda")

    def step():
        return model_api.decode_step(model, cache, tokens, LM_MAX_SEQ - 1)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with op_costs.OpCounter() as counter:
        step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    times = [time_once(torch, step)[0] for _ in range(LM_TIMED_STEPS)]
    held = _tensor_bytes(list(model.parameters()) + list(model.buffers())
                         + list(cache.values()) + [tokens])
    return {"costs": counter.costs(), "step_ms": float(np.mean(times)), "step_ms_each": times,
            "held_bytes": held, "max_memory_allocated": peak}


def dryrun_train_count(torch, seed) -> dict:
    """Phase 14 (b): phase 11's step (SmolLM-360M, B 32 x S 2048 in 4
    microbatches) on a fresh state on a one-position mesh of this card
    (``loop.build_sharded_train_state`` + ``make_sharded_step``, the code
    the dry run traces), once under an ``op_costs.OpCounter``.  Returns the
    counted costs, the bytes the card holds for the step's arguments (its
    pieces, working copy and batch) and its peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import op_costs
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models.model_zoo import get_model
    from repro_torch.train import data as data_lib
    from repro_torch.train import loop

    cfg = get_config(TRAIN_ARCH)
    api = get_model(cfg)
    shape = ShapeConfig("train_cell", "train", TRAIN_SEQ, TRAIN_BATCH)
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, steps=TRAIN_STEPS,
                     microbatches=TRAIN_MICRO, seed=seed)
    dev = torch.device("cuda", 0)
    mesh = DeviceMesh(np.full((1, 1), dev, dtype=object), ("data", "model"))
    model, params, opt_state, param_sh = loop.build_sharded_train_state(api, mesh, tc, TRAIN_SEQ)
    step_fn, _ = loop.make_sharded_step(api, mesh, tc, shape, param_sh)
    batch = data_lib.batch_for_step(0, cfg, shape, seed, TRAIN_MICRO, dev)
    pieces = [p for tree in (params, opt_state["mu"], opt_state["nu"])
              for arr in tree.values() for p in arr.pieces.values()]
    held = {"masters_and_moments": _tensor_bytes(pieces),
            "step": _tensor_bytes(opt_state["step"].pieces.values()),
            "working_copy": _tensor_bytes(list(model.parameters()) + list(model.buffers())),
            "batch": _tensor_bytes(batch.values())}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with op_costs.OpCounter() as counter:
        new = step_fn(model, params, opt_state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    loss = float(new[2]["loss"])
    del new, params, opt_state, model
    return {"costs": counter.costs(), "held": held, "max_memory_allocated": peak,
            "loss": loss}


def dryrun_phase(torch, K, seed, query_count, decode_count, measured) -> dict:
    """Phase 14: ``repro_torch.launch.dryrun`` at the card's own shapes on
    ``meta`` tensors, held to one real step of each cell counted on the card.

    (a) The dry run's three cells: phase 11's train step on a one-position
    mesh, phase 9's decode step, phase 4's Q = 64 pass on phase 3's word
    shape.  (b) ``query_count`` (phase 4's end) and ``decode_count``
    (phase 9's end) and the train step counted here on a fresh state: each
    counted FLOP total must equal its trace's, the train step's arguments
    the bytes the card holds for them, the pass's bytes its trace's and
    phase 4's bound bytes.  (c) Each cell's bound beside its measured time
    (``measured``: phase 4's Q = 64 pass ms, phase 11's result, phase 9's
    result) and the predicted peak beside the measured.  Returns the
    ``DRYRUN`` line and the phase's launches.
    """
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import DeviceMesh

    check = Check("dryrun")
    one = DeviceMesh(np.full((1, 1), torch.device("meta"), dtype=object), ("data", "model"))
    out = {"cells": {}}
    card = card_line()

    def record(name, r, counted, measured_ms, what) -> None:
        rf, mem = r["roofline"], r["memory"]
        bound_ms = rf["bound_s"] * 1e3
        cell = {"trace_s": r["trace_s"], "roofline": rf, "memory": mem,
                "counted_flops": counted["flops"], "counted_hbm_bytes": counted["hbm_bytes"],
                "counted_flops_f32": counted["flops_f32"], "measured_ms": measured_ms,
                "measured": what, "bound_ms": bound_ms,
                "share": bound_ms / measured_ms if measured_ms else None,
                "compute_ms": rf["compute_s"] * 1e3,
                "compute_share": rf["compute_s"] * 1e3 / measured_ms if measured_ms else None}
        out["cells"][name] = cell
        # The memory term prices the bytes that today's ops move, so it is a
        # bound of this implementation; the compute term is the function's.
        log(f"  {name}: meta {rf['flops']:.6e} FLOPs ({rf['flops_f32']:.6e} f32), "
            f"{rf['hbm_bytes']:.6e} bytes; counted on the card {counted['flops']:.6e} FLOPs, "
            f"{counted['hbm_bytes']:.6e} bytes; compute floor {cell['compute_ms']:.3f} ms "
            f"({100 * cell['compute_share']:.2f}%), the counted ops' bytes "
            f"{rf['memory_s'] * 1e3:.3f} ms: the larger {bound_ms:.3f} ms "
            f"({rf['bottleneck']}), {100 * cell['share']:.2f}% of {what} "
            f"{measured_ms:.3f} ms ({card})")
        log(f"  {name} roofline " + json.dumps(rf))
        log(f"  {name} memory " + json.dumps(mem))
        check.expect(counted["flops"] == rf["flops"],
                     f"{name}: counted FLOPs {counted['flops']} != the meta trace's {rf['flops']}")

    # The query pass.
    qc = query_count
    c, p, w = qc["shape"]
    q = dryrun.trace_query_pass(c, p, w, qc["q"], qc["n_cols"], **qc["kw"])
    record("query_q64", q, qc["costs"], measured["query_ms"],
           "phase 4's Q = 64 pass (before ingest, the card's S)")
    check.expect(qc["launches"] == {"bscsr_topk_spmv": 0, "bscsr_topk_spmv_multiquery": 1,
                                    "bscsr_spmv": 0},
                 f"the counted pass launched {qc['launches']}, not the kernel once")
    check.expect(list(qc["costs"]["kernels"]) == ["bscsr_topk_spmv_multiquery"]
                 and qc["costs"]["kernels"]["bscsr_topk_spmv_multiquery"]["calls"] == 1,
                 f"the counted pass recorded {qc['costs']['kernels']}")
    check.expect(qc["costs"]["hbm_bytes"] == q["roofline"]["hbm_bytes"] == qc["bound_bytes"],
                 f"query pass bytes: counted {qc['costs']['hbm_bytes']}, meta "
                 f"{q['roofline']['hbm_bytes']}, phase 4's bound {qc['bound_bytes']}")
    log(f"  query pass bytes: counted {qc['costs']['hbm_bytes']:.0f} == meta == phase 4's "
        f"bound bytes {qc['bound_bytes']} (the stream's {c * p * w * 4 / 1e9:.3f} GB, x, "
        f"the outputs)")

    # The decode step.
    lm = measured["lm"]
    lm_cfg = dc.replace(get_config(LM_ARCH), num_layers=LM_LAYERS)
    dec = dryrun.trace_cell(lm_cfg, ShapeConfig("lm_decode", "decode", LM_MAX_SEQ, LM_BATCH),
                            one)
    record("decode_b64", dec, decode_count["costs"], decode_count["step_ms"],
           "the counted decode step (logits, CUDA events)")
    out["cells"]["decode_b64"]["hidden_only_ms"] = lm.get(f"decode_step_ms_b{LM_BATCH}")
    pred = dec["memory"]["argument_size_in_bytes"] + dec["memory"]["temp_size_in_bytes"]
    check.expect(decode_count["held_bytes"] == dec["memory"]["argument_size_in_bytes"],
                 f"decode arguments: held {decode_count['held_bytes']}, meta "
                 f"{dec['memory']['argument_size_in_bytes']}")
    log(f"  decode peak: predicted {pred / 1e9:.3f} GB (arguments + temp); the counted step's "
        f"max_memory_allocated {decode_count['max_memory_allocated'] / 1e9:.3f} GB (the head "
        f"and engine live beside it), phase 9's {lm.get('max_memory_allocated', 0) / 1e9:.3f} "
        f"GB ({card})")
    out["cells"]["decode_b64"].update(
        predicted_peak_bytes=pred, max_memory_allocated=decode_count["max_memory_allocated"],
        phase9_max_memory_allocated=lm.get("max_memory_allocated"))

    # The train step: the meta trace, then the same step counted on the card.
    trained = measured["trained"]
    t0 = time.time()
    tr = dryrun.trace_cell(get_config(TRAIN_ARCH),
                           ShapeConfig("train_cell", "train", TRAIN_SEQ, TRAIN_BATCH), one,
                           microbatches=TRAIN_MICRO)
    log(f"  train cell traced on meta in {time.time() - t0:.1f} s "
        f"({tr['costs']['ops']} ops)")
    K.reset_launch_counts()
    t0 = time.time()
    tcount = dryrun_train_count(torch, seed)
    log(f"  train step counted on the card in {time.time() - t0:.1f} s (loss "
        f"{tcount['loss']:.4f})")
    out["launches"] = launch_counts(K)
    record("train_step", tr, tcount["costs"], trained["step_ms"],
           "phase 11's step (median, CUDA events)")
    held = tcount["held"]
    n_params = get_config(TRAIN_ARCH).param_count()
    check.expect(held["masters_and_moments"] == 12 * n_params,
                 f"masters and moments hold {held['masters_and_moments']}, not 12 x {n_params}")
    check.expect(sum(held.values()) == tr["memory"]["argument_size_in_bytes"],
                 f"train arguments: the card holds {held}, the meta trace counts "
                 f"{tr['memory']['argument_size_in_bytes']}")
    pred = tr["memory"]["argument_size_in_bytes"] + tr["memory"]["temp_size_in_bytes"]
    log(f"  train arguments {sum(held.values())} bytes held == meta: {held}")
    log(f"  train peak: predicted {pred / 1e9:.3f} GB (arguments + temp); the counted step's "
        f"max_memory_allocated {tcount['max_memory_allocated'] / 1e9:.3f} GB, phase 11's "
        f"{trained['peak_memory_gb']:.3f} GB ({card})")
    out["cells"]["train_step"].update(
        held=held, predicted_peak_bytes=pred, max_memory_allocated=tcount["max_memory_allocated"],
        phase11_peak_memory_gb=trained["peak_memory_gb"],
        compute_s_bf16_only=tr["roofline"]["flops"] / H100_BF16_FLOPS)
    log(f"  launches in the dryrun phase (the train step's; phase 4's pass is counted "
        f"there): {out['launches']}")
    for name, n in out["launches"].items():
        check.expect(n == 0, f"{name} launched {n} times in the train step")
    out["launches"] = {name: n + qc["launches"][name] for name, n in out["launches"].items()}
    check.done()
    return out


def profiled_kernels(torch, step, steps=3):
    """(kernel ms per ``step``, {"gemm_ms", "launches", "top"}) from
    ``torch.profiler``: the GEMMs' share (cuBLAS kernels), kernel launches
    per step and the five costliest kernels as (name, ms per step); (None,
    {}) if the profiler records no device time on this machine."""
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    except Exception as exc:  # a measurement only: the run goes on without it
        log(f"  profiler unavailable: {type(exc).__name__}: {exc}")
        return None, {}
    if not events:
        return None, {}
    per = {e.key: e.self_device_time_total / 1e3 / steps for e in events}
    gemm = sum(ms for name, ms in per.items() if "nvjet" in name or "gemm" in name.lower())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    return sum(per.values()), {"gemm_ms": gemm,
                               "launches": sum(e.count for e in events) / steps,
                               "top": [(name[:80], ms) for name, ms in top]}


def ulp_gap(a: np.ndarray, b: np.ndarray):
    """(entries that differ, largest distance in f32 ulps) of two score vectors."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return int(np.count_nonzero(ia != ib)), int(np.abs(ia - ib).max(initial=0))


def graph_operator(graph, n_nodes):
    """Phase 6's "ring" operator (phase 8 shards the same one)."""
    t0 = time.time()
    csr = graph.synthetic_graph_csr("ring", n_nodes, seed=0)
    log(f"  ring operator: {csr.shape[0]} nodes, nnz {csr.nnz} ({time.time() - t0:.1f} s)")
    return csr


def graph_config(api, device):
    return api.TopKSpMVConfig(k=8, num_partitions=32, block_size=256, value_format="F32",
                              packets_per_step=2, stream_layout="fused", device=device)


def graph_fixture(api, graph, SparseEmbeddingIndex, GraphRankingService, n_nodes, device,
                  csr=None):
    """Phase 6's operator, config, facade and ranking service."""
    if csr is None:
        csr = graph_operator(graph, n_nodes)
    cfg = graph_config(api, device)
    t0 = time.time()
    fac = SparseEmbeddingIndex(csr, cfg)
    log(f"  SparseEmbeddingIndex build: {time.time() - t0:.1f} s, "
        f"P={fac.index.packed.vals.shape[1]}, int32 ids: "
        f"{fac.index.packed.cols.dtype == np.int32}")
    # The service ranks over the facade's mutable index, so update_node is
    # replace_rows with the row's weights x 1.02, as the reference benchmark
    # mutates.  Over the facade itself update_node would go through upsert,
    # which re-sparsifies and L2-normalizes the row: the operator then stops
    # being an L1 contraction, which the canonical refinement's step count
    # assumes.
    return csr, cfg, fac, GraphRankingService(fac.index, tol=1e-5)


def update_node(svc, csr):
    """The first mutation: node 4243's weights x 1.02."""
    node = GRAPH_SEEDS[-1] + 1
    row = np.zeros(csr.shape[0], np.float32)
    lo, hi = csr.indptr[node], csr.indptr[node + 1]
    row[csr.indices[lo:hi]] = csr.data[lo:hi] * 1.02
    svc.update_node(node, row)


def graph_phase(K, api, graph, SparseEmbeddingIndex, GraphRankingService,
                n_nodes=GRAPH_NODES, device="cuda", csr=None, sharded_cold=()):
    """Phase 6: PPR solves through the ranking service, then top-k eigen.

    ``sharded_cold`` holds (label, cold rank) pairs: phase 8's on the
    sharded operator and phase 12's on the mesh, which the first cold rank
    here must each equal bit for bit, in as many iterations.
    Returns (the graph facade, the accumulate kernel's launches in this phase).
    """
    check = Check("graph")
    csr, cfg, fac, svc = graph_fixture(api, graph, SparseEmbeddingIndex,
                                       GraphRankingService, n_nodes, device, csr=csr)
    if n_nodes == GRAPH_NODES:
        check.expect(csr.nnz == GRAPH_NNZ, f"ring operator nnz {csr.nnz} != {GRAPH_NNZ}")
    ex = api.query_executor(cfg)

    def solve(label, fn):
        before = ex.h2d_copies
        t0 = time.perf_counter()
        out = fn()
        res = getattr(out, "result", out)
        log(f"  {label}: {res.iterations} iterations, {res.refine_iterations} refine "
            f"steps, residual {res.residual:.3g}, retraces {res.retraces}, "
            f"h2d {ex.h2d_copies - before}, {time.perf_counter() - t0:.2f} s")
        check.expect(res.converged and res.canonical and res.retraces == 0,
                     f"{label}: converged {res.converged}, canonical {res.canonical}, "
                     f"retraces {res.retraces}")
        return out, ex.h2d_copies - before

    K.reset_launch_counts()
    cold, _ = solve("cold rank", lambda: svc.rank(GRAPH_SEEDS, top_k=10))
    for label, other in sharded_cold:
        n_diff, gap = ulp_gap(cold.result.scores, other["scores"])
        log(f"  cold rank vs {label}: {n_diff} of {n_nodes} scores "
            f"differ, iterations {cold.result.iterations} / {other['iterations']}")
        check.expect(n_diff == 0 and cold.result.iterations == other["iterations"],
                     f"cold rank differs from {label} in {n_diff} scores (up to {gap} ulp), "
                     f"iterations {other['iterations']} vs {cold.result.iterations}")
    # The build's snapshot, kept for phase 4: the first mutation moves the
    # index to churn-stable buckets (padded packets, a doubled slot bucket).
    pre = {"words": np.array(fac.index.packed.words), "n_rows": fac.index.packed.max_slots}
    update_node(svc, csr)
    t0 = time.perf_counter()
    fac.index.live_csr()
    live_s = time.perf_counter() - t0
    warm, _ = solve("warm rank after update_node", lambda: svc.rank(GRAPH_SEEDS, top_k=10))
    svc.forget(GRAPH_SEEDS)
    cold2, copies = solve("forget + cold rank", lambda: svc.rank(GRAPH_SEEDS, top_k=10))
    spmv_launches = K.bscsr_spmv.launches
    check.expect(copies == 0, f"{copies} host-to-device copies during a pinned solve")
    check.expect(warm.warm_started and not cold2.warm_started, "warm/cold bookkeeping")
    check.expect(warm.result.iterations < cold2.result.iterations,
                 f"warm start saved nothing: {warm.result.iterations} vs "
                 f"{cold2.result.iterations}")
    check.expect(not np.array_equal(cold.result.scores, cold2.result.scores),
                 "update_node did not move the operator")
    # The same warm and cold solves through the torch oracle: the kernel
    # path must give their scores bit for bit.
    ref, _ = solve("use_kernel=False", lambda: fac.personalized_pagerank(
        GRAPH_SEEDS, tol=1e-5, use_kernel=False))
    ref_warm, _ = solve("use_kernel=False warm", lambda: fac.personalized_pagerank(
        GRAPH_SEEDS, tol=1e-5, use_kernel=False, warm_start=cold.result.scores))
    for label, a, b in (("cold", cold2.result.scores, ref.scores),
                        ("warm", warm.result.scores, ref_warm.scores)):
        n_diff, gap = ulp_gap(a, b)
        log(f"  {label}: kernel vs use_kernel=False: {n_diff} of {n_nodes} scores differ")
        check.expect(n_diff == 0, f"{label} kernel solve and use_kernel=False solve "
                                  f"differ in {n_diff} scores (up to {gap} ulp)")
    # Warm vs cold: the canonical refinement contracts two tol-converged
    # iterates to ~5e-17 apart in L1 and then rounds to f32, so a score whose
    # f32 ulp is below that spread can round either way.  At 2**21 nodes a
    # few do: the bit-identity the reference claims does not hold at this
    # size (tests/test_torch_graph.py::TestPersonalizedPageRank::
    # test_warm_and_cold_at_scale_match_the_reference shows the reference's
    # own solves differing so at 2**17 nodes, and the port matching them).
    # The oracle path must show the same entries, which places the gap in
    # the algorithm and not in the kernel; each is held to 1 ulp.
    n_diff, gap = ulp_gap(warm.result.scores, cold2.result.scores)
    same = np.array_equal(warm.result.scores != cold2.result.scores,
                          ref_warm.scores != ref.scores)
    log(f"  warm vs cold: {n_diff} of {n_nodes} scores differ, by at most {gap} ulp; "
        f"the same entries on the oracle path: {same}")
    check.expect(gap <= 1 and same, f"warm solve and cold solve {gap} ulp apart "
                                    f"(oracle path same entries: {same})")
    check.expect(spmv_launches >= cold.result.iterations + warm.result.iterations
                 + cold2.result.iterations, f"bscsr_spmv launched {spmv_launches} times")
    log(f"  top nodes {cold2.node_ids.tolist()}; service {svc.info()}")

    # Where a solve's time goes: device iterations, host f64 refinement,
    # live_csr() (its first call after a mutation; cached per version).
    t0 = time.perf_counter()
    dev = graph.personalized_pagerank(fac, GRAPH_SEEDS, tol=1e-5, canonicalize=False)
    device_s = time.perf_counter() - t0
    p = graph.seed_vector(GRAPH_SEEDS, n_nodes, device=device).cpu().numpy()
    t0 = time.perf_counter()
    _, steps = graph._canonical_refine(fac.index, dev.scores, p, 0.85, 1e-5)
    refine_s = time.perf_counter() - t0
    split = {"device_iterations": dev.iterations, "device_s": device_s,
             "device_ms_per_iteration": device_s * 1e3 / max(dev.iterations, 1),
             "spmv_splits": K.spmv_splits(device, cfg.num_partitions, packets_per_step=2,
                                          block_size=256, m=n_nodes),
             "refine_steps": steps, "refine_s": refine_s,
             "refine_s_per_step": refine_s / max(steps, 1), "live_csr_s": live_s}
    log("PPR_SPLIT " + json.dumps(split))

    scsr = graph.synthetic_graph_csr("ba", EIGEN_NODES, seed=1, symmetric=True)
    efac = SparseEmbeddingIndex(scsr, cfg)
    t0 = time.perf_counter()
    eig = efac.topk_eigen(3, tol=1e-5, max_iters=3000)
    eig_s = time.perf_counter() - t0
    dense = scsr.to_dense().astype(np.float64)
    resid = [float(np.linalg.norm(dense @ v - lam * v))
             for lam, v in zip(eig.values, eig.vectors.T)]
    log(f"  topk_eigen(3) on ba {EIGEN_NODES}: values {eig.values.tolist()}, iterations "
        f"{eig.iterations}, f64 residuals {resid}, retraces {eig.retraces}, {eig_s:.2f} s")
    check.expect(eig.converged and eig.retraces == 0, "eigen solve did not converge cleanly")
    check.expect(max(resid) <= 1e-4, f"eigen residuals {resid} above 1e-4")
    check.done()
    return fac, spmv_launches, pre


def accumulate_timing(torch, K, bscsr, fac, pre, errs, launches) -> dict:
    """The accumulate kernel on phase 6's snapshots.

    ``ms`` walks the snapshot the last solves ran (churn-stable buckets:
    padded packets, a doubled slot bucket); ``ms_pre_mutation`` the build's.
    Each is timed at the card's S (``spmv_splits``) and at one split, in
    turns, with the split tables built beforehand as the executor holds
    them.  The bound counts what y = A x itself moves: the live packets of
    the stream, x once and y once.
    """
    check = Check("timings (accumulate)")
    packed = fac.index.packed
    n = packed.n_cols
    step_nnz = 2 * packed.block_size
    kw = dict(n_rows=packed.max_slots, packets_per_step=2, fmt_name="F32",
              block_size=packed.block_size)
    rng = np.random.default_rng(3)
    words = torch.from_numpy(np.ascontiguousarray(packed.words)).cuda()
    pre_words = torch.from_numpy(pre["words"]).cuda()
    splits = K.spmv_splits(words.device, packed.num_cores, packets_per_step=2,
                           block_size=packed.block_size, m=n)

    def tables(w):
        return {s: K.spmv_split_table(w, packets_per_step=2, block_size=packed.block_size,
                                      splits=s) for s in (splits, 1)}

    build = lambda: K.spmv_split_table(words, packets_per_step=2,  # noqa: E731
                                       block_size=packed.block_size, splits=splits)
    table_ms, table_host_ms = time_cuda(torch, build), host_ms_per_call(torch, build)
    cur_tables, pre_tables = tables(words), tables(pre_words)
    log(f"  bscsr_spmv: S = {splits} splits per core "
        f"(card: {torch.cuda.get_device_properties(0).multi_processor_count} SMs, "
        f"{packed.num_cores} cores)")
    log(f"SPLIT_TABLE build {table_ms:.4f} ms on the device, {table_host_ms:.4f} ms of "
        f"host enqueue (S = {splits}, once per snapshot)")
    log(f"  split bounds of core 0 after the first mutation: "
        f"{cur_tables[splits][0][0].tolist()}; before: {pre_tables[splits][0][0].tolist()}")

    # Dyadic values (j / 16) and x (i * 2**-30, i < 256) on the graph's
    # streams: every prefix sum of a step stays below 2**21 units of 2**-34,
    # exact in f32 in any order, so kernel and plain must agree bit for bit.
    dvals = np.where(packed.vals != 0, rng.integers(1, 17, packed.vals.shape) / 16.0,
                     0.0).astype(np.float32)
    dwords = torch.from_numpy(bscsr.fuse_words(dvals, packed.cols, packed.flags)).cuda()
    dx = torch.from_numpy((rng.integers(0, 256, n) * 2.0 ** -30).astype(np.float32)).cuda()
    want = K.bscsr_spmv_plain(dx, dwords, **kw)
    for s in (splits, 1):
        got = K.bscsr_spmv(dx, dwords, splits=s, **kw)
        n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        check.expect(n_diff == 0 and bool(got.abs().max() > 0),
                     f"bscsr_spmv S={s} on dyadic graph streams: {n_diff} sums differ "
                     f"from plain")
        log(f"  bscsr_spmv S={s} on dyadic graph streams: {n_diff} of {got.numel()} sums "
            f"differ from plain")
    del dwords, dvals

    # Random x at the solves' scale.  A segment sum is the difference of two
    # prefix sums of a step, each within a few ulps of the step's total of
    # |a x|; atol is 16 ulps of the largest such total.  Against one split
    # the card's S must give the same bits.
    x = torch.from_numpy(rng.random(n).astype(np.float32) / n).cuda()
    csr, _ = fac.index.live_csr()
    atol = 16 * 2.0 ** -24 * step_nnz * float(csr.data.max()) * float(x.max())
    plain_ms, want = time_once(torch, lambda: K.bscsr_spmv_plain(x, words, **kw))
    timed = {}
    for label, w, n_rows, tabs, ref in (
            ("current", words, kw["n_rows"], cur_tables, want),
            ("pre-mutation", pre_words, pre["n_rows"], pre_tables, None)):
        kwl = dict(kw, n_rows=n_rows)
        if ref is None:
            ref = K.bscsr_spmv_plain(x, w, **kwl)
        got = K.bscsr_spmv(x, w, table=tabs[splits], **kwl)
        one = K.bscsr_spmv(x, w, table=tabs[1], **kwl)
        n_diff = int((got.view(torch.int32) != one.view(torch.int32)).sum())
        check.expect(n_diff == 0, f"bscsr_spmv on the {label} graph streams: S={splits} "
                                  f"and S=1 differ in {n_diff} sums")
        err = float((got.double() - ref.double()).abs().max())
        errs["bscsr_spmv"] = max(errs["bscsr_spmv"], err)
        check.expect(err <= atol and float(ref.abs().max()) > 100 * atol,
                     f"bscsr_spmv on the {label} graph streams differs from plain "
                     f"(max err {err:.3g}, atol {atol:.3g})")
        log(f"  bscsr_spmv on the {label} streams, random x: S={splits} vs S=1: {n_diff} "
            f"of {got.numel()} sums differ; vs plain max abs err {err:.3g} (atol "
            f"{atol:.3g}, largest sum {float(ref.abs().max()):.3g})")
        # In turns: S, 1, 1, S.
        turns = [time_cuda(torch, lambda: K.bscsr_spmv(x, w, table=tabs[s], **kwl))
                 for s in (splits, 1, 1, splits)]
        timed[label] = ((turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2)
        log(f"  bscsr_spmv on the {label} streams: S={splits} {turns[0]:.4f} / "
            f"{turns[3]:.4f} ms, S=1 {turns[1]:.4f} / {turns[2]:.4f} ms")
    host_ms = host_ms_per_call(torch, lambda: K.bscsr_spmv(x, words, table=cur_tables[splits],
                                                           **kw))
    log(f"  bscsr_spmv: host enqueue {host_ms:.4f} ms per call (wrapper and launch)")
    ms, ms_one = timed["current"]
    ms_pre, ms_pre_one = timed["pre-mutation"]
    mat = torch.sparse_csr_tensor(torch.from_numpy(csr.indptr).cuda(),
                                  torch.from_numpy(csr.indices.astype(np.int64)).cuda(),
                                  torch.from_numpy(csr.data).cuda(), size=csr.shape)
    library_ms = time_cuda(torch, lambda: torch.sparse.mm(mat, x[:, None]))
    live_packets = int(((packed.vals != 0).any(-1) | (packed.flags != 0).any(-1)).sum())
    live_bytes = live_packets * packed.words.shape[2] * 4
    nbytes = live_bytes + n * 4 + n * 4
    flops = 2.0 * packed.nnz
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / F32_FLOPS * 1e3
    packets, pre_packets = packed.vals.shape[1], pre["words"].shape[1]
    log(f"  bscsr_spmv: {ms:.4f} ms at S={splits} ({ms_one:.4f} ms at S=1) over {packets} "
        f"packets per core, {ms_pre:.4f} ms ({ms_pre_one:.4f} ms at S=1) over "
        f"{pre_packets} before the first mutation, plain {plain_ms:.1f} ms; bound "
        f"{max(bytes_ms, flops_ms):.4f} ms ({nbytes / 1e6:.1f} MB: {live_packets} live "
        f"packets, x, y), torch.sparse.mm {library_ms:.4f} ms")
    check.done()
    return {
        "name": "bscsr_spmv", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["bscsr_spmv"], "launches": launches["bscsr_spmv"],
        "max_abs_err": errs["bscsr_spmv"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": library_ms, "splits": splits, "ms_one_split": ms_one,
        "ms_pre_mutation": ms_pre, "ms_pre_mutation_one_split": ms_pre_one,
        "split_table_ms": table_ms, "host_ms_per_call": host_ms,
        "packets_per_core": packets, "packets_per_core_pre_mutation": pre_packets,
        "live_packets": live_packets, "bound_bytes": nbytes, "atol": atol,
        "achieved_gb_per_s": nbytes / (ms * 1e-3) / 1e9,
    }


if __name__ == "__main__":
    sys.exit(main())
