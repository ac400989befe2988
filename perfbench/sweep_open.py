"""Find the knee of an open-loop cell once: one process, one set-up, the
offered rates in turn.

    python3 perfbench/sweep_open.py --workload emb10m-bf16.serve-open \
        --rates 600:1800:100 --seconds 10 --seed 7

At each rate the generator runs the cell's Poisson traffic for ``--seconds``.
The knee is the highest rate at which every request is answered, the p95
latency from due time is at most 100 ms (two Q = 64 passes of 44-45 ms, the
wait of a request that just misses one) and the frontend's queue at
the window's close holds no more than one full pass (``max_q``).  The sweep
stops after two rates in a row miss.  It prints one row a rate and the rate
for the cell, four fifths of the knee rounded down to ``--step``; with
``--write`` it writes that rate and the knee into the cell's file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import numpy as np  # noqa: E402

from perfbench import gen, harness, run, tracing  # noqa: E402

P95_LIMIT_MS = 100.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", default="emb10m-bf16.serve-open")
    parser.add_argument("--rates", default="600:1800:100", help="first:last:step")
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--write", action="store_true")
    args = parser.parse_args(argv)
    first, last, step = (int(v) for v in args.rates.split(":"))

    cell = harness.load_cell(args.workload)
    params = cell["params"]
    state = run.set_up(cell, args.seed, "cuda", time.perf_counter())
    loop = state["loop"]
    print("SETUP " + json.dumps(run.jsonable(state["parts"])), flush=True)
    rows, knee, misses = [], None, 0
    for rate in range(first, last + 1, step):
        rng = np.random.default_rng(gen.sub_seed(args.seed, f"sweep{rate}"))
        out = loop.drive(state["target"], state["pool"], dict(params, rate_per_s=rate),
                         args.seconds, rng, tracing.Spans())
        lat = out["latency_s"][np.isfinite(out["latency_s"])] * 1e3
        p95 = float(np.percentile(lat, 95)) if len(lat) else float("inf")
        ok = (out["failed"] == 0 and p95 <= P95_LIMIT_MS
              and out["queue_at_close"] <= int(params["max_q"]))
        rows.append({"rate_per_s": rate, "requests": out["attempted"], "failed": out["failed"],
                     "p50_ms": float(np.percentile(lat, 50)) if len(lat) else None,
                     "p95_ms": p95, "p99_ms": float(np.percentile(lat, 99)) if len(lat) else None,
                     "queue_at_close": out["queue_at_close"],
                     "late_p99_ms": float(np.percentile(out["lateness_s"], 99)) * 1e3, "ok": ok})
        print("RATE " + json.dumps(run.jsonable(rows[-1])), flush=True)
        if ok:
            knee, misses = rate, 0
        else:
            misses += 1
            if misses == 2:
                break
    loop.stop(state["target"])
    print("| offered /s | requests | failed | p50 ms | p95 ms | p99 ms | queue at close | ok |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    for r in rows:
        print(f"| {r['rate_per_s']} | {r['requests']} | {r['failed']} | {r['p50_ms']:.2f} | "
              f"{r['p95_ms']:.2f} | {r['p99_ms']:.2f} | {r['queue_at_close']} | {r['ok']} |")
    if knee is None:
        print("no rate met the limits")
        return 1
    fixed = int(0.8 * knee) // step * step
    print(f"KNEE {knee} RATE {fixed}")
    if args.write:
        path = harness.BENCH_DIR / "workloads" / f"{args.workload}.json"
        spec = json.loads(path.read_text())
        spec["params"].update(rate_per_s=fixed, knee_per_s=knee)
        path.write_text(json.dumps(spec, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
