"""The control of a cell: the program in the precision below the stated one.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 --seconds 5

Runs the cell as ``run.py`` does, with the program built with its config's
``control`` settings (its own lower-precision path) while the reference
still judges by the stated configuration, once per seed, and prints each
compared number beside its limit.  The benchmark's own runs never run it.
A control that is told apart reads ``correct: false``.
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

from perfbench import harness, run  # noqa: E402


def control_settings(config: dict) -> dict:
    return {k: v for k, v in config["control"].items() if k != "why"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    override = control_settings(harness.load_cell(args.workload)["config"])
    told_apart = True
    for seed in (int(s) for s in args.seeds.split(",")):
        done = run.run_cell(args.workload, seed, args.seconds, False, "cuda",
                            t_start=time.perf_counter(), program_override=override)
        res = run.jsonable(done["result"])
        told_apart &= not res["correct"]
        print("CONTROL " + json.dumps({"workload": args.workload, "seed": seed,
                                       "override": override, "correct": res["correct"],
                                       "checks": res["checks"],
                                       "end_to_end": run.jsonable(done["info"]["end_to_end"])}),
              flush=True)
        torch.cuda.empty_cache()
    print(f"control {args.workload}: told apart on every seed: {told_apart}")
    return 0 if told_apart else 1


if __name__ == "__main__":
    sys.exit(main())
