"""Multi-position dry run: every (architecture x shape x mesh) cell traced
on ``meta`` tensors and priced on an H100 roofline.

The reference's ``repro/launch/dryrun.py``, ported.  The reference lowers
and compiles each cell against its production mesh (512 forced host
devices) and reads the compiled HLO.  The port has no compiler: each cell
runs the port's own step once on the production mesh whose positions are
``meta`` placeholders (``make_production_mesh(devices=[meta] * 256)``),
under ``op_costs.OpCounter``.  Every master, moment, batch, cache and
activation is a ``meta`` tensor, so nothing is allocated, and the kernel
wrappers take their ``meta`` branch and record their own cost.  The step
is the one that runs on the card: ``train.loop.make_sharded_step`` for
train, ``ModelAPI.prefill`` and ``ModelAPI.decode_step`` for serving.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --out experiments/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch topk_spmv

**Per-device terms are position 0's.**  The port's mesh places storage
only: masters and moments are per-position pieces, and every train step
gathers the working copy and computes at the mesh's first position
(``train/loop.py``); serving holds the whole model there.  So position 0
does all of a step's FLOPs and is the bottleneck position: ``roofline``,
``memory`` and ``collectives`` are its own.  The one process also
dispatches the other positions' work (each piece's AdamW update and bf16
rounding, each top-k runner's local pass), which the port's code marks
``kernels.costs.elsewhere()``: the counter keeps it out of position 0's
costs and peak live bytes and records it under ``costs_all_positions``.
``roofline.useful_ratio`` is the model FLOPs over the FLOPs executed at
every position.

**Memory** (position 0, the reference's ``memory_analysis`` keys):
``argument_size_in_bytes`` is its pieces (masters, moments, step), the
working copy of the model and the whole batch (the port does not split
the batch: ``loop.make_sharded_step``), and for decode the whole cache;
``output_size_in_bytes`` what the step returns in new storage,
``alias_size_in_bytes`` what it returns in an argument's (the decode
cache, updated in place); ``temp_size_in_bytes`` the peak of live bytes
that the ops traced for position 0 created (its ``peak_temp_bytes``).

**Collectives** (position 0, booked under the reference's keys from the
port's placement; the ops themselves are ``.to()`` copies):

  all-gather          the gather of the working copy into position 0: each
                      distinct master block held at another position
                      (``mesh.unique_blocks``), in f32, once a step (and
                      once more in bf16 when gradients are bf16); the
                      top-k cell's c * k candidates from the other runners
  reduce-scatter      each other position's block of the gradient, sent
                      for its ``adamw_leaf`` update (factor 1)
  collective-permute  the pipeline's stage moves at position 0: its
                      microbatches' activations out and their gradients
                      back, the embedding to the last stage and its
                      gradient back, the labels to the last stage

The five 0-d scalars each piece update takes are left out.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ALIASES, ARCH_NAMES, get_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, TrainConfig, shape_applicable
from repro_torch.launch import analysis, op_costs
from repro_torch.launch.mesh import DeviceMesh, MeshArray, make_production_mesh, unique_blocks
from repro_torch.models.model_zoo import count_params_analytic, get_model
from repro_torch.sharding.rules import DEFAULT_RULES, ShardingRules, shard_params, use_rules
from repro_torch.train import loop

META = torch.device("meta")


def placeholder_mesh(multi_pod: bool = False) -> DeviceMesh:
    """The production mesh over ``meta`` positions: 16 x 16, or 2 x 16 x 16."""
    return make_production_mesh(multi_pod=multi_pod, devices=[META] * (512 if multi_pod else 256))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _first(mesh: DeviceMesh) -> tuple:
    return (0,) * len(mesh.axis_names)


def _at_first(tree, first: tuple) -> list:
    """The tensors of ``tree`` that position ``first`` holds: its piece of
    every ``MeshArray``, and every plain tensor and module's parameters and
    buffers (the port computes there)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, MeshArray):
        return [tree.pieces[first]]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _at_first(v, first)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _at_first(v, first)]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    return []


def _batch(api, shape: ShapeConfig, device) -> dict:
    """``api.batch_spec(shape)`` on ``device``: the spec's ``meta`` tensors,
    or zeros of their shapes and dtypes on a real device."""
    spec = api.batch_spec(shape)
    if torch.device(device).type == "meta":
        return spec
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device) for k, v in spec.items()}


def _train_batch(api, shape: ShapeConfig, microbatches: int, device=META) -> dict:
    batch = _batch(api, shape, device)
    if microbatches > 1:
        batch = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])
                 for k, v in batch.items()}
    return batch


def _meta_train_state(api, mesh: DeviceMesh, rules: ShardingRules, max_seq: int):
    """``loop.build_sharded_train_state`` without its draws: the working
    copy built at the mesh's first position, float32 masters beside it,
    placed by ``shard_params`` (every piece a ``meta`` tensor on a
    placeholder mesh)."""
    model = api.build(loop.compute_device(mesh), max_seq)
    masters = {name: torch.empty(p.shape, dtype=torch.float32, device=p.device)
               for name, p in model.named_parameters()}
    param_sh = shard_params(masters, api.param_specs(), mesh, rules)
    params, opt_state = loop.shard_train_state(masters, param_sh)
    return model, params, opt_state, param_sh


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: DeviceMesh,
               rules: ShardingRules = DEFAULT_RULES, microbatches: int = 1,
               grad_dtype: str = "float32", serve_dtype: str = "", loss_fn=None):
    """Returns ``(fn, args)`` for one dry-run cell: ``fn(*args)`` is the
    port's step on the state that ``mesh`` places.

    ``grad_dtype``: accumulation dtype for train cells.  ``serve_dtype``: if
    set, prefill/decode cells hold the model's float32 parameters in this
    dtype.  ``loss_fn`` replaces the family's loss in a train cell (the
    pipeline cell's).  On a placeholder mesh every tensor is ``meta``.
    """
    api = get_model(cfg)
    if shape.kind == "train":
        if loss_fn is not None:
            api = dataclasses.replace(api, loss_fn=loss_fn)
        model, params, opt_state, param_sh = _meta_train_state(api, mesh, rules, shape.seq_len)
        tc = TrainConfig(microbatches=microbatches, grad_dtype=grad_dtype)
        step, _ = loop.make_sharded_step(api, mesh, tc, shape, param_sh)
        return step, (model, params, opt_state,
                      _train_batch(api, shape, microbatches, loop.compute_device(mesh)))

    dev = loop.compute_device(mesh)
    model = api.build(dev, shape.seq_len)
    if serve_dtype:
        sd = getattr(torch, serve_dtype)
        for p in model.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(sd)
    if shape.kind == "prefill":
        return api.prefill, (model, _batch(api, shape, dev))
    # decode: one new token at the cache's last position (the step reads the
    # whole cache, masked, whatever the position)
    cache = api.init_cache(shape.global_batch, shape.seq_len, device=dev)
    tokens = torch.zeros((shape.global_batch, 1), dtype=torch.int32, device=dev)
    return api.decode_step, (model, cache, tokens, shape.seq_len - 1)


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS convention: 6*N*D train, 2*N*D prefill, 2*N*B decode
    (N = active params; D = global tokens in the step)."""
    n = count_params_analytic(cfg, active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def auto_microbatches(shape: ShapeConfig, mesh: DeviceMesh,
                      max_tokens_per_device: int = 16384) -> int:
    """Largest divisor of the per-device batch keeping live activations sane
    (the reference's arithmetic over ``mesh.shape``)."""
    if shape.kind != "train":
        return 1
    dp = 1
    for ax in ("pod", "data"):
        dp *= mesh.shape.get(ax, 1)
    b_local = max(shape.global_batch // dp, 1)
    tokens_local = b_local * shape.seq_len
    want = max(1, tokens_local // max_tokens_per_device)
    mb = min(b_local, want)
    while b_local % mb:  # must divide the local batch
        mb -= 1
    return max(mb, 1)


def _coll_add(coll: dict, kind: str, nbytes: float, count: int = 1) -> None:
    coll[kind]["count"] += count
    coll[kind]["bytes"] += float(nbytes)


def _train_collectives(params: dict, grad_dtype: str, mesh: DeviceMesh) -> dict:
    """Position 0's moves in one sharded step (module docstring)."""
    first = _first(mesh)
    coll = op_costs.zero_costs()["coll_breakdown"]
    gbytes = torch.empty((), dtype=getattr(torch, grad_dtype)).element_size()
    loads = (4,) + ((2,) if grad_dtype == "bfloat16" else ())
    for arr in params.values():
        for pos, sl in unique_blocks(arr.shape, arr.sharding):
            if pos != first:
                n = arr.pieces[pos].numel()
                for size in loads:
                    _coll_add(coll, "all-gather", n * size)
        for pos, piece in arr.pieces.items():
            if pos != first:
                _coll_add(coll, "reduce-scatter", piece.numel() * gbytes)
    return coll


def _memory(args, result, first: tuple, temp: int) -> dict:
    """Position ``first``'s byte sizes (module docstring)."""
    held = _at_first(args, first)
    arg_storages = {t.untyped_storage()._cdata for t in held}
    out = alias = 0
    seen = set()
    for t in _at_first(result, first):
        key = t.untyped_storage()._cdata
        if key in seen:
            continue
        seen.add(key)
        if key in arg_storages:
            alias += _nbytes(t)
        else:
            out += _nbytes(t)
    return {"argument_size_in_bytes": sum(_nbytes(t) for t in held),
            "output_size_in_bytes": out, "alias_size_in_bytes": alias,
            "temp_size_in_bytes": int(temp)}


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: DeviceMesh,
               rules: ShardingRules = DEFAULT_RULES, microbatches: int = 1,
               grad_dtype: str = "float32", serve_dtype: str = "", loss_fn=None,
               coll=None) -> dict:
    """One cell's step traced under a counter: ``trace_s``, ``costs`` (position
    0's), ``costs_all_positions``, ``memory``, ``collectives`` and
    ``roofline``.  ``coll`` gives the collective breakdown for a train cell
    whose moves are not the sharded step's (the pipeline's)."""
    with use_rules(rules):
        fn, args = build_cell(cfg, shape, mesh, rules, microbatches=microbatches,
                              grad_dtype=grad_dtype, serve_dtype=serve_dtype, loss_fn=loss_fn)
        t0 = time.perf_counter()
        with op_costs.OpCounter() as counter:
            result = fn(*args)
        trace_s = time.perf_counter() - t0
    everything = counter.costs_all_positions()
    costs = counter.costs()
    if shape.kind == "train":
        breakdown = coll if coll is not None else _train_collectives(args[1], grad_dtype, mesh)
    else:
        breakdown = op_costs.zero_costs()["coll_breakdown"]
    costs["coll_breakdown"] = breakdown
    costs["coll_bytes"] = sum(v["bytes"] for v in breakdown.values())
    memory = _memory(args, result, _first(mesh), costs["peak_temp_bytes"])
    out = analysis.analyze_counted(costs, memory, chips=mesh.size,
                                   model_flops=model_flops_for(cfg, shape),
                                   executed_flops=everything["flops"])
    return {"trace_s": trace_s, "costs": costs, "costs_all_positions": everything, **out}


def _failed(base: dict, e: Exception) -> dict:
    return {**base, "status": "fail", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:]}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rules: ShardingRules = DEFAULT_RULES,
             rules_label: str = "default",
             microbatches: Optional[int] = None,
             grad_dtype: str = "float32",
             serve_dtype: str = "") -> dict:
    """One cell's record: ``status`` ok / skip / fail and, when ok, the
    reference's keys with ``trace_s`` for ``lower_s`` / ``compile_s``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    base = {"arch": cfg.name, "shape": shape.name, "mesh": "multi" if multi_pod else "single",
            "rules": rules_label, "grad_dtype": grad_dtype, "serve_dtype": serve_dtype or None}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {**base, "status": "skip", "reason": why}
    if cfg.sharding_overrides:
        rules = rules.replace(**dict(cfg.sharding_overrides))
    try:
        mesh = placeholder_mesh(multi_pod)
        mb = microbatches or auto_microbatches(shape, mesh)
        base["microbatches"] = mb
        result = trace_cell(cfg, shape, mesh, rules, microbatches=mb, grad_dtype=grad_dtype,
                            serve_dtype=serve_dtype)
        return {**base, "status": "ok", "chips": mesh.size,
                "params": count_params_analytic(cfg),
                "active_params": count_params_analytic(cfg, active_only=True), **result}
    except Exception as e:  # noqa: BLE001 - record and continue the sweep
        return _failed(base, e)


def topk_service_index(n_parts: int):
    """The reference's reduced stream for the top-k cell: ``n_parts * 64``
    rows at ``CONFIG``'s widths, F32, built on the CPU."""
    from repro_torch.configs.topk_spmv import CONFIG
    from repro_torch.core import bscsr
    from repro_torch.core import topk_spmv as core

    csr = bscsr.synthetic_embedding_csr(n_rows=n_parts * 64, n_cols=CONFIG.n_cols,
                                        mean_nnz_per_row=CONFIG.mean_nnz_per_row, seed=0)
    return core.build_index(csr, core.TopKSpMVConfig(
        big_k=CONFIG.big_k, k=CONFIG.k, num_partitions=n_parts,
        block_size=CONFIG.block_size, value_format="F32", device="cpu"))


def run_topk_service_cell(multi_pod: bool) -> dict:
    """The paper's own workload on the production mesh: the query through
    ``distributed_topk_spmv_fn`` over ("data",) or ("pod", "data"), the
    words and x on ``meta``, so the counted cost of each local pass is the
    kernel wrapper's record.  Position 0 runs one local pass and the
    finalize; the other runners' passes are in ``costs_all_positions``."""
    from repro_torch.configs.topk_spmv import CONFIG
    from repro_torch.core.topk_spmv import distributed_topk_spmv_fn

    mesh_label = "multi" if multi_pod else "single"
    base = {"arch": "topk_spmv_service", "shape": "query", "mesh": mesh_label,
            "rules": "default"}
    try:
        mesh = placeholder_mesh(multi_pod)
        axes = ("pod", "data") if multi_pod else ("data",)
        n_parts = mesh.size // mesh.shape["model"]
        idx = topk_service_index(n_parts)
        fn, arrays = distributed_topk_spmv_fn(idx, mesh, axes)
        first = _first(mesh)
        dev = mesh.device(first)
        x = torch.empty(CONFIG.n_cols, dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        with op_costs.OpCounter() as counter:
            vals, rows = fn(x, *arrays)
        trace_s = time.perf_counter() - t0
        everything = counter.costs_all_positions()
        costs = counter.costs()
        n_runners = everything["kernels"]["bscsr_topk_spmv"]["calls"]
        coll = op_costs.zero_costs()["coll_breakdown"]
        # (C/n, k) f32 values + int32 rows from each other runner
        cand = arrays[0].pieces[first].shape[0] * idx.config.k * (4 + 4)
        _coll_add(coll, "all-gather", cand * (n_runners - 1), n_runners - 1)
        costs["coll_breakdown"] = coll
        costs["coll_bytes"] = sum(v["bytes"] for v in coll.values())
        memory = _memory((x, arrays), (vals, rows), first, costs["peak_temp_bytes"])
        result = analysis.analyze_counted(costs, memory, chips=mesh.size,
                                          executed_flops=everything["flops"])
        return {**base, "status": "ok", "trace_s": trace_s, "chips": mesh.size,
                "runners": n_runners, "costs": costs, "costs_all_positions": everything,
                **result}
    except Exception as e:  # noqa: BLE001
        return _failed(base, e)


def trace_query_pass(n_cores: int, n_packets: int, width: int, nq: int, n_cols: int,
                     **kernel_kw) -> dict:
    """One multi-query pass of ``nq`` queries over a ``(n_cores, n_packets,
    width)`` word stream, traced on ``meta`` on one card: the kernel
    wrapper's record is the whole cost."""
    from repro_torch.kernels.bscsr_topk_spmv import bscsr_topk_spmv_multiquery

    words = torch.empty((n_cores, n_packets, width), dtype=torch.int32, device=META)
    x = torch.empty((nq, n_cols), dtype=torch.float32, device=META)
    t0 = time.perf_counter()
    with op_costs.OpCounter() as counter:
        out = bscsr_topk_spmv_multiquery(x, words, **kernel_kw)
    trace_s = time.perf_counter() - t0
    costs = counter.costs()
    memory = _memory((x, words), out, (), costs["peak_temp_bytes"])
    return {"trace_s": trace_s, "costs": costs,
            **analysis.analyze_counted(costs, memory, chips=1)}


def run_pipeline_cell(arch: str, stages: int = 4, multi_pod: bool = False,
                      pp_microbatches: int = 0) -> dict:
    """PP extension cell: train_4k with the block stack pipelined over a
    'stage' mesh axis, (stage, data, model) = (S, 16, 256/(16*S)) placeholder
    positions; PP microbatching happens inside the loss (GPipe ticks).  The
    FLOPs and bytes are the whole step's, summed over the stage positions
    (each computes its blocks; position 0 also the embedding)."""
    from repro_torch.train.pipeline import (PIPELINE_RULES_OVERRIDE, pipeline_applicable,
                                            pipelined_loss_fn)

    cfg = get_config(arch)
    shape = SHAPES["train_4k"]
    base = {"arch": cfg.name, "shape": f"{shape.name}_pp{stages}",
            "mesh": "multi" if multi_pod else "single", "rules": "pipeline"}
    if not pipeline_applicable(cfg, stages):
        return {**base, "status": "skip", "reason": "not pipeline-applicable"}
    try:
        model_par = (512 if multi_pod else 256) // (16 * stages)
        axes = ("stage", "data", "model")
        mesh_shape = (stages, 16, model_par)
        if multi_pod:
            axes = ("pod",) + axes
            mesh_shape = (2,) + mesh_shape
        mesh = DeviceMesh(np.full(mesh_shape, META, dtype=object), axes)
        rules = DEFAULT_RULES.replace(**PIPELINE_RULES_OVERRIDE)
        m = pp_microbatches or 4 * stages   # bubble = (S-1)/(M+S-1) ~ 15%

        def loss(model, batch):
            return pipelined_loss_fn(model, cfg, batch, mesh, m)

        dt = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
        act = shape.global_batch // m * shape.seq_len * cfg.d_model * dt
        embed = sum(_nbytes(p) for p in get_model(cfg).build(META, 1).embed.parameters())
        coll = op_costs.zero_costs()["coll_breakdown"]
        if stages > 1:
            _coll_add(coll, "collective-permute", 2 * m * act, 2 * m)
            _coll_add(coll, "collective-permute", 2 * embed, 2)
            _coll_add(coll, "collective-permute", shape.global_batch * shape.seq_len * 4)
        result = trace_cell(cfg, shape, mesh, rules, microbatches=1, loss_fn=loss, coll=coll)
        return {**base, "status": "ok", "chips": mesh.size, "pp_microbatches": m, **result}
    except Exception as e:  # noqa: BLE001
        return _failed(base, e)


def _print_record(r: dict) -> None:
    tag = f"{r['arch']}/{r['shape']}/{r['mesh']}"
    if r["status"] == "ok":
        rf = r["roofline"]
        m = r.get("memory", {})
        print(f"     memory (position 0): args="
              f"{m.get('argument_size_in_bytes', 0) / 1e9:.2f}GB "
              f"temp={m.get('temp_size_in_bytes', 0) / 1e9:.2f}GB "
              f"out={m.get('output_size_in_bytes', 0) / 1e9:.2f}GB "
              f"| flops/position-0={rf['flops']:.3e} (f32 {rf['flops_f32']:.3e})")
        print(f"OK   {tag:46s} trace={r.get('trace_s', 0):6.1f}s "
              f"bottleneck={rf['bottleneck']:10s} "
              f"mem={rf['memory_s'] * 1e3:8.2f}ms "
              f"comp={rf['compute_s'] * 1e3:8.2f}ms "
              f"coll={rf['collective_s'] * 1e3:8.2f}ms", flush=True)
    elif r["status"] == "skip":
        print(f"SKIP {tag:46s} {r['reason']}", flush=True)
    else:
        print(f"FAIL {tag:46s} {r['error'][:120]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id, comma list, 'all', or 'topk_spmv'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="grad-accumulation microbatches for train cells "
                         "(0 = auto: bound tokens/device/microbatch)")
    args = ap.parse_args(argv)

    archs = list(ARCH_NAMES) if args.arch == "all" else [
        ALIASES.get(a, a) for a in args.arch.split(",")
    ]
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    results = []
    t_start = time.perf_counter()
    for arch in archs:
        for shape in (["query"] if arch == "topk_spmv" else shapes):
            for multi in meshes:
                if arch == "topk_spmv":
                    r = run_topk_service_cell(multi)
                else:
                    r = run_cell(arch, shape, multi, microbatches=args.microbatches or None)
                results.append(r)
                _print_record(r)
                fname = f"{r['arch'].replace('/', '_')}_{r['shape']}_{r['mesh']}.json"
                with open(os.path.join(args.out, fname), "w") as f:
                    json.dump(r, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"\n{n_ok} ok / {n_skip} skip / {n_fail} fail in "
          f"{time.perf_counter() - t_start:.1f} s")
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
