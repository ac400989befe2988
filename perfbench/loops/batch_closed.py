"""Loop ``batch_closed``: one caller sends ``query_batch`` of ``batch``
queries back to back and waits for each answer.

The window runs from the first call until the answer of the call that
crosses ``seconds``; ``queries_per_s`` is every query answered in it over
its length.  Queries come from the pool in an order drawn from the seed.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np

from perfbench import system


def start(index, pool: np.ndarray, params: dict, seed: int):
    """Set-up: the first pass pins the snapshot, the second runs warm."""
    system.warm(index, pool, [int(params["batch"])] * 2)
    return index


def run(index, pool: np.ndarray, params: dict, seconds: float,
        rng: np.random.Generator, spans) -> Dict:
    q = int(params["batch"])
    order = rng.permutation(pool.shape[0])
    starts = np.arange(0, pool.shape[0] - q + 1, q)
    qidx, vals, rows = [], [], []
    t0 = time.perf_counter()
    end = t0
    while end - t0 < seconds:
        lo = starts[len(qidx) % len(starts)]
        sel = order[lo:lo + q]
        with spans.span("dispatch"):
            v, r = index.query_batch(pool[sel])
        end = time.perf_counter()
        qidx.append(sel)
        vals.append(v)
        rows.append(r)
    n = len(qidx) * q
    return {"qidx": np.concatenate(qidx), "vals": np.concatenate(vals),
            "rows": np.concatenate(rows), "attempted": n, "failed": 0,
            "passes": [q] * len(qidx),
            "end_to_end": {"queries_per_s": n / (end - t0)},
            "info": {"window_s": end - t0}, "ctx": {}}


def stop(index) -> None:
    pass
