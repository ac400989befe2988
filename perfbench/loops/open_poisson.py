"""Loop ``open_poisson``: independent users send single queries at
``rate_per_s`` on a Poisson schedule fixed by the seed, through
``StreamingSimilarityService.submit`` with the frontend at its defaults.

Each request is timed from when it was due until its future resolved; the
requests due inside ``seconds`` make the window, and the run waits up to
``LATE_WAIT_S`` past its close for their answers.  ``within_100ms_share`` is
the percentage of all of them answered within ``LIMIT_S`` of their due time;
the 95th percentile over all of them is the per-layer
``latency_p95_ms.serve``.  A request never answered counts as the whole
wait.  How late the generator ran goes on a line before the last.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict

import numpy as np

from perfbench import gen, system, tracing

# Seconds past the window's close that a run waits for answers.
LATE_WAIT_S = 60.0
# Seconds of traffic at the cell's rate in set-up, so the frontend's arrival
# and service estimates have settled when the window opens.
WARM_S = 2.0
# The latency a request is held to: a request that arrives just after a full
# Q = 64 pass (44-45 ms) has started waits through it and rides the next.
LIMIT_S = 0.100


def arrivals(rate: float, seconds: float, rng: np.random.Generator) -> np.ndarray:
    """Due times (seconds from the window's start) of a Poisson stream."""
    n = int(rate * seconds * 1.5) + 64
    t = np.cumsum(rng.exponential(1.0 / rate, size=n))
    while t[-1] < seconds:
        t = np.concatenate([t, t[-1] + np.cumsum(rng.exponential(1.0 / rate, size=n))])
    return t[t < seconds]


def percentile(values: np.ndarray, p: float) -> float:
    return float(np.percentile(values, p)) if len(values) else float("nan")


def drive(svc, pool: np.ndarray, params: dict, seconds: float,
          rng: np.random.Generator, spans: tracing.Spans) -> Dict:
    """Submit on schedule from this thread; the frontend's thread answers."""
    due = arrivals(float(params["rate_per_s"]), seconds, rng)
    qsel = rng.integers(0, pool.shape[0], size=len(due))
    n = len(due)
    done_at = np.full(n, np.nan)
    results: list = [None] * n
    lateness = np.zeros(n)
    left = [n]
    all_done = threading.Event()
    lock = threading.Lock()

    def on_done(i: int) -> Callable[[Future], None]:
        def cb(fut: Future) -> None:
            t = time.perf_counter()
            with lock:
                done_at[i] = t
                results[i] = None if fut.cancelled() or fut.exception() else fut.result()
                left[0] -= 1
                if left[0] == 0:
                    all_done.set()
        return cb

    t0 = time.perf_counter()
    with spans.span("generator"):
        for i in range(n):
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            lateness[i] = time.perf_counter() - (t0 + due[i])
            svc.submit(pool[qsel[i]]).add_done_callback(on_done(i))
        time.sleep(max(t0 + seconds - time.perf_counter(), 0.0))
    queue_at_close = svc.frontend.queue_depth
    if n:
        all_done.wait(timeout=LATE_WAIT_S)
    with lock:
        ok = np.array([r is not None for r in results], bool)
        latency = done_at - (t0 + due)
        latency[~ok] = np.inf
        got = [i for i in range(n) if ok[i]]
        vals = np.stack([results[i][0] for i in got]) if got else np.zeros((0, 0))
        rows = np.stack([results[i][1] for i in got]) if got else np.zeros((0, 0))
    return {"latency_s": latency, "lateness_s": lateness, "qidx": qsel[ok],
            "vals": vals, "rows": rows, "failed": int((~ok).sum()), "attempted": n,
            "queue_at_close": queue_at_close}


def start(index, pool: np.ndarray, params: dict, seed: int):
    """Set-up: one pass at each Q the frontend may form, the service, and
    ``WARM_S`` of the cell's traffic."""
    system.warm(index, pool, range(1, int(params["max_q"]) + 1))
    svc = system.service(index)
    drive(svc, pool, params, WARM_S, np.random.default_rng(gen.sub_seed(seed, "warm")),
          tracing.Spans())
    return svc


def frontend_delta(before: dict, after: dict) -> dict:
    hist = {int(q): n - before["batch_histogram"].get(q, 0)
            for q, n in after["batch_histogram"].items()}
    hist = {q: n for q, n in hist.items() if n}
    return {"passes": sum(hist.values()), "queries": sum(q * n for q, n in hist.items()),
            "histogram": hist, "queue_depth_end": after["queue_depth"],
            "flush_reasons": {k: v - before["flush_reasons"].get(k, 0)
                              for k, v in after["flush_reasons"].items()}}


def run(svc, pool: np.ndarray, params: dict, seconds: float,
        rng: np.random.Generator, spans: tracing.Spans) -> Dict:
    fe = svc.frontend
    before = fe.info()
    dispatch = fe.dispatch
    if spans.profiled:   # the traced run's spans around each pass
        def timed(xs, enq):
            with spans.span("dispatch"):
                return dispatch(xs, enq)
        fe.dispatch = timed
    try:
        out = drive(svc, pool, params, seconds, rng, spans)
    finally:
        fe.dispatch = dispatch
    delta = frontend_delta(before, fe.info())
    lat = out.pop("latency_s")
    lat[~np.isfinite(lat)] = LATE_WAIT_S + seconds
    late = out.pop("lateness_s")
    out["passes"] = [q for q, n in delta["histogram"].items() for _ in range(n)]
    p95_ms = percentile(lat, 95) * 1e3
    within = 100.0 * float(np.mean(lat <= LIMIT_S)) if len(lat) else float("nan")
    out["end_to_end"] = {"within_100ms_share": within}
    out["info"] = {
        "latency_ms": {"p50": percentile(lat, 50) * 1e3, "p95": p95_ms,
                       "p99": percentile(lat, 99) * 1e3, "requests": int(len(lat))},
        "generator_late_ms": {"p50": percentile(late, 50) * 1e3,
                              "p99": percentile(late, 99) * 1e3,
                              "max": float(np.max(late, initial=0)) * 1e3},
        "queue_at_close": out.pop("queue_at_close"),
        "frontend": delta,
        "frontend_model_at_start": {"target_q": before["target_q"], **before["intensity"]}}
    out["ctx"] = {"frontend": delta, "latency_p95_ms": p95_ms}
    return out


def stop(svc) -> None:
    svc.close()
