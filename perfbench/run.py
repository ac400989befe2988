"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the kernels' build, the collection and queries drawn from the seed
on the card, the port's index build, one pass at each Q the traffic uses)
is timed from the process's start to the window's start.  The window drives
the cell's traffic for ``--seconds``; with ``--trace 1`` under
``torch.profiler``.  After it the program's state is freed and the plain
reference judges a sample of the window's answers.  The last line of
standard output is one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.
Exit codes: 0 a result was printed, 2 no card (or too few), 3 a module of
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import numpy as np  # noqa: E402

from perfbench import check, gen, harness, roofline, system, tracing  # noqa: E402

def log(*args) -> None:
    print(*args, flush=True)


def set_up(cell: dict, seed: int, device: str, t_start: float,
           program_override: Optional[dict] = None, bench_dir: Path = harness.BENCH_DIR) -> dict:
    """Inputs from the seed, the program built, the cell's loop started.
    ``program_override`` changes the settings the program is built with (a
    control), never the configuration the reference reads."""
    import torch

    config, params = cell["config"], cell["params"]
    loop = harness.load_loop(params["loop"], bench_dir)
    build_s = system.build_kernels(device)
    t0 = time.perf_counter()
    csr = gen.collection(config["n_rows"], config["n_cols"], config["mean_nnz_per_row"],
                         seed, device)
    pool = gen.queries(int(params["pool"]), config["n_cols"], seed, device)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = system.build_index({**config, **(program_override or {})}, csr, device)
    index_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    target = loop.start(index, pool, params, seed)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # The first full collection after the build walks every object the
    # index made (seconds at 10M rows): taken here, not in the window.
    t0 = time.perf_counter()
    gc.collect()
    gc_s = time.perf_counter() - t0
    return {"csr": csr, "pool": pool, "index": index, "loop": loop, "target": target,
            "setup_s": time.perf_counter() - t_start,
            "parts": {"kernel_build_s": build_s, "generate_s": gen_s,
                      "index_build_s": index_s, "warm_s": warm_s, "gc_s": gc_s}}


def window(cell: dict, state: dict, seed: int, seconds: float, trace: bool) -> tuple:
    """(the loop's output, spans, profiler or None)."""
    import torch

    spans = tracing.Spans(profiled=trace)
    rng = np.random.default_rng(gen.sub_seed(seed, "traffic"))
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        with spans.span("window"):
            out = state["loop"].run(state["target"], state["pool"], cell["params"], seconds,
                                    rng, spans)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    return out, spans, prof


def per_layer(benchmark: dict, name: str, bench_dir: Path, prof, spans, out: dict,
              stats: dict, bound_s: float, device_info: dict, info: dict) -> tuple:
    """(the cell's per-layer metrics, the breakdown) from the traced window;
    ``device_info`` gains ``busy_s`` and ``window_s``."""
    dev, host = tracing.profiler_intervals(prof, ("window", "dispatch", "generator"))
    win = [(a, b) for n, a, b in host if n == "window"]
    lo, hi = win[0] if win else (min(a for _, a, _ in host), max(b for _, _, b in host))
    summary = tracing.summarize(dev, host, lo, hi)
    d_s, d_n = spans.total("dispatch")
    ctx = {"frontend": None, "passes": out["passes"], "dispatch_s": d_s, "dispatch_n": d_n,
           "busy_s": summary["busy_s"], "window_s": hi - lo, "stats": stats,
           "bound_s": bound_s, **out["ctx"]}
    layer = {}
    for m in harness.cell_metrics(benchmark, name, "per_layer"):
        value = harness.load_reader(m["name"], bench_dir)(ctx)
        if value is not None:
            layer[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info["busy_s"] = summary["busy_s"]
    device_info["window_s"] = hi - lo
    info["device_events"] = len(dev)
    return layer, {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             bench_dir: Path = harness.BENCH_DIR, t_start: float = T_START,
             program_override: Optional[dict] = None) -> dict:
    """One run: {"result": the last line's object, "info": lines before it}."""
    import torch

    benchmark = harness.load_json(bench_dir.parent / "BENCHMARK.json")
    cell = harness.load_cell(name, bench_dir)
    harness.check_entry(benchmark, cell)
    config = cell["config"]
    on_card = device.startswith("cuda")
    state = set_up(cell, seed, device, t_start, program_override, bench_dir)
    index = state["index"]
    before = system.counters(index)
    out, spans, prof = window(cell, state, seed, seconds, trace)
    after = system.counters(index)
    stats = system.stats(index)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    info = {"setup": state["parts"], "counters_before": before, "counters_after": after,
            "stats": stats, "memory_peak_bytes": peak, **out["info"]}
    e2e = {"setup_s": state["setup_s"], **out["end_to_end"]}
    if "queries_per_s" in e2e:
        info["gnnz_per_s"] = e2e["queries_per_s"] * stats["nnz"] / 1e9
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}

    layer, breakdown = {}, None
    if trace:
        bound_s = sum(roofline.pass_work(config, stats["nnz"], q).bound_s
                      for q in out["passes"])
        layer, breakdown = per_layer(benchmark, name, bench_dir, prof, spans, out, stats,
                                     bound_s, device_info, info)
        del prof

    state["loop"].stop(state["target"])
    del index, state["index"], state["target"]
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    verdict = check.judge(config, state["csr"], state["pool"], out, seed, device)
    info["reference_s"] = time.perf_counter() - t0
    info["judged"] = verdict["judged"]
    e2e["recall_at_8"] = verdict["recall_at_8"]
    limits = config["limits"]
    checks = {"score_gap": {"value": verdict["score_gap"], "limit": limits["score_gap"]},
              "missing": {"value": verdict["missing"], "limit": limits["missing"]}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = layer
    if not trace:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in harness.cell_metrics(benchmark, name, "end_to_end")
                   if m["name"] in e2e}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    info["end_to_end"] = e2e
    return {"result": result, "info": info}


def jsonable(x):
    """``x`` with numpy scalars made plain and non-finite floats as strings
    (JSON has no infinity)."""
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return float(x) if np.isfinite(x) else str(float(x))
    return x


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True, choices=harness.list_cells())
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    benchmark = harness.load_json(ROOT / "BENCHMARK.json")
    chips = next(w["chips"] for w in benchmark["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    done = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = harness.forbidden_modules(list(sys.modules))
    if bad:
        print(f"run: modules of JAX or the JAX package were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    result = jsonable(done["result"])
    for key, value in done["info"].items():
        log(f"{key.upper()} " + json.dumps(jsonable(value)))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
