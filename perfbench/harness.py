"""Finds a cell's parts by name and checks a run's modules.

A cell ``<cell>`` is ``workloads/<cell>.json``: its ``config``, its
``traffic`` and the mix's ``params``.  The configuration is
``configs/<config>.json``; the mix ``traffic/<traffic>.json``, its
parameters (the cell's ``params`` override them), whose ``loop`` names the
module ``loops/<loop>.py`` that drives it; a per-layer metric's reader
``metrics/<metric>.py`` with ``read(ctx) -> float | None``.  Which metrics a
cell reports is ``BENCHMARK.json``'s to say.

A loop module has three functions:

* ``start(index, pool, params, seed) -> target``: its part of set-up (warm
  passes, a service around the index); counted in ``setup_s``;
* ``run(target, pool, params, seconds, rng, spans) -> dict``: the window.
  It returns the answers (``qidx``, the pool index of each answered query,
  with its ``vals`` and ``rows``), ``attempted`` and ``failed``, ``passes``
  (the Q of each kernel pass), ``end_to_end`` (the mix's end-to-end
  numbers), ``info`` (lines before the last) and ``ctx`` (what it adds for
  the metric readers);
* ``stop(target)``.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Iterable, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Top-level module names that no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The forbidden top-level names among ``names``, compared whole."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def list_cells(bench_dir: Path = BENCH_DIR) -> List[str]:
    return sorted(p.stem for p in (bench_dir / "workloads").glob("*.json"))


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """{"name", "config" (the config file's dict), "traffic", "params"}."""
    spec = load_json(bench_dir / "workloads" / f"{name}.json")
    config = load_json(bench_dir / "configs" / f"{spec['config']}.json")
    params = dict(load_json(bench_dir / "traffic" / f"{spec['traffic']}.json"))
    params.update(spec.get("params", {}))
    return {"name": name, "config": config, "config_name": spec["config"],
            "traffic": spec["traffic"], "params": params}


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    return load_module(bench_dir / "metrics" / f"{metric}.py",
                       f"perfbench_metric_{metric}").read


def list_loops(bench_dir: Path = BENCH_DIR) -> List[str]:
    return sorted(p.stem for p in (bench_dir / "loops").glob("*.py"))


def load_loop(loop: str, bench_dir: Path = BENCH_DIR):
    """The module ``loops/<loop>.py``."""
    return load_module(bench_dir / "loops" / f"{loop}.py", f"perfbench_loop_{loop}")


def cell_metrics(benchmark: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports.

    An end-to-end metric without ``workloads`` belongs to every cell; a
    per-layer one without it to every cell that reports what it moves.
    """
    e2e = [m for m in benchmark["end_to_end"] if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in benchmark["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in moved]


def check_entry(benchmark: dict, cell: dict) -> None:
    """The cell's file and ``BENCHMARK.json`` name the same config and mix."""
    for w in benchmark["workloads"]:
        if w["name"] == cell["name"]:
            if (w["config"], w["traffic"]) != (cell["config_name"], cell["traffic"]):
                raise ValueError(f"{cell['name']}: BENCHMARK.json names "
                                 f"({w['config']}, {w['traffic']}), the cell's file "
                                 f"({cell['config_name']}, {cell['traffic']})")
            return
    raise KeyError(f"{cell['name']} is not a workload of BENCHMARK.json")
