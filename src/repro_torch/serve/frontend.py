"""Continuous micro-batching request frontend: adaptive-Q coalescing.

The paper's HBM efficiency comes from never letting the memory pipeline
idle — packets stream back-to-back at full burst width.  The kernel plane
has the same property (fused streams, zero-copy dispatch, zero-retrace
churn) but a serving layer that answers whatever batch the caller hands it
runs the kernel at Q=1 under real traffic, leaving the batched fast path
(one stream pass amortized over Q queries, memory-bound up to Q ~ 500 per
the roofline model) unused.  This module closes that gap: arriving single
queries are *coalesced* into multi-query kernel passes.

Three cooperating pieces:

* :class:`IntensityModel` — an online arrival/service model.  Arrival rate
  λ is an EWMA over inter-arrival gaps; per-Q-bucket service time s(B) is
  an EWMA per power-of-two batch bucket (optionally seeded through
  ``FrontendConfig.service_time_seed``).  The adaptive
  target batch is the smallest bucket B with ``B >= λ * s(B)`` — the batch
  the queue refills during one kernel pass, i.e. the operating point where
  the pipeline neither idles nor grows an unbounded backlog.
* :class:`RequestFrontend` — admission control (bounded queue, per-tenant
  tags), a scheduler thread that picks the flush moment from (a) the
  adaptive target, (b) a latency deadline so p99 stays bounded at low
  traffic (Q degrades gracefully to 1 when idle), and (c) the replica-
  multiplied capacity cap; per-tenant round-robin assembly bounds
  starvation to one flush.  Bursts larger than one pass split into
  multiple passes.
* :class:`FrontendConfig` — the knobs.

This is a copy of the reference's ``repro/serve/frontend.py``: the policy is
pure Python and numpy.  In this package the executor keeps the power-of-two
Q bucket as a cache key only and hands the kernel the batch unpadded
(``kernels/executor.py``; the multi-query kernel takes any Q), so a
*drifting* batch size is retrace-free and launches exactly the coalesced
Q: ``cache_info()``'s ``q_bucket_hits``/``q_exact_hits`` counters let tests
assert that.  ``StreamingSimilarityService(frontend=...)`` wires this
frontend over the guardrailed dispatch path (deadlines measured from
*enqueue* so queue wait counts against them).  The reference's seeding of
service times from ``BENCH_topk_spmv.json`` is not ported.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


class QueueFullError(RuntimeError):
    """Admission control: the request queue is at capacity (shed, don't wait)."""


def q_bucket(q: int) -> int:
    """Next power-of-two batch bucket (the executor's cache key)."""
    return 1 << max(q - 1, 0).bit_length()


@dataclasses.dataclass
class FrontendConfig:
    """Scheduler policy knobs.

    ``flush_deadline_s`` bounds how long any request waits in the queue
    before a pass is forced — the p99 bound at low traffic.  When the
    service's :class:`~repro_torch.serve.streaming.ServiceGuardrails` also set a
    ``deadline_s``, keep ``flush_deadline_s`` below it (minus one service
    time): with the frontend active the guardrail deadline is measured
    from *enqueue*, and the flush timer must fire first.

    ``max_batch`` caps one kernel pass's Q per replica group; the
    effective per-pass capacity is ``max_batch * replica_factor`` (a
    sharded index fans a coalesced batch out over the replica axis, so
    the frontend targets replica-multiplied buckets).  ``max_queue``
    (0 = unbounded) sheds arrivals with :class:`QueueFullError` once that
    many requests wait.  ``adaptive`` enables the intensity model; off,
    ``target_batch`` is the fixed flush threshold.  ``ewma_alpha`` sets
    both EWMAs' smoothing; ``service_time_seed`` pre-loads per-bucket
    service times (seconds) so the first flushes already batch sensibly.
    """

    flush_deadline_s: float = 0.01
    max_batch: int = 64
    max_queue: int = 0
    target_batch: int = 1
    adaptive: bool = True
    ewma_alpha: float = 0.2
    service_time_seed: Optional[Dict[int, float]] = None


class IntensityModel:
    """Online λ / s(B) estimates -> adaptive target batch size.

    ``observe_arrival`` feeds inter-arrival gaps (arrival rate λ as an
    EWMA of gaps, inverted); ``observe_service`` feeds one kernel pass's
    (batch, seconds).  ``target_q(capacity)`` returns the smallest
    power-of-two bucket B <= capacity with ``B >= λ * s(B)``: at that
    operating point one pass's worth of arrivals fits the next pass, so
    the stream stays full without the queue growing.  Idle traffic (λ→0)
    yields B=1 — single requests flush immediately.
    """

    def __init__(
        self,
        alpha: float = 0.2,
        service_time_seed: Optional[Dict[int, float]] = None,
    ):
        self.alpha = alpha
        self._gap_s: Optional[float] = None       # EWMA inter-arrival gap
        self._last_arrival: Optional[float] = None
        self._service_s: Dict[int, float] = {
            int(b): float(s) for b, s in (service_time_seed or {}).items()
        }
        self.arrivals = 0
        self.passes = 0

    def _ewma(self, prev: Optional[float], sample: float) -> float:
        if prev is None:
            return sample
        return (1.0 - self.alpha) * prev + self.alpha * sample

    def observe_arrival(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if self._last_arrival is not None:
            gap = max(now - self._last_arrival, 1e-9)
            self._gap_s = self._ewma(self._gap_s, gap)
        self._last_arrival = now
        self.arrivals += 1

    def observe_service(self, batch: int, seconds: float) -> None:
        b = q_bucket(max(int(batch), 1))
        self._service_s[b] = self._ewma(self._service_s.get(b), float(seconds))
        self.passes += 1

    @property
    def arrival_rate(self) -> float:
        """Requests/second (0.0 until two arrivals have been seen)."""
        if self._gap_s is None:
            return 0.0
        return 1.0 / self._gap_s

    def service_time(self, batch: int) -> Optional[float]:
        """s(bucket(batch)), falling back to the nearest measured bucket."""
        if not self._service_s:
            return None
        b = q_bucket(max(int(batch), 1))
        if b in self._service_s:
            return self._service_s[b]
        # nearest bucket by log-distance: buckets are sparse early on
        near = min(self._service_s, key=lambda x: abs(math.log2(x / b)))
        return self._service_s[near]

    def target_q(self, capacity: int) -> int:
        """Smallest bucket B <= capacity with B >= λ * s(B) (else capacity)."""
        lam = self.arrival_rate
        if lam <= 0.0 or not self._service_s:
            return 1
        b = 1
        while b < capacity:
            s = self.service_time(b)
            if s is None or b >= lam * s:
                break
            b <<= 1
        return min(b, max(capacity, 1))

    def snapshot(self) -> dict:
        return {
            "arrival_rate": self.arrival_rate,
            "service_time_s": dict(sorted(self._service_s.items())),
            "arrivals": self.arrivals,
            "passes": self.passes,
        }


@dataclasses.dataclass
class _Request:
    x: np.ndarray
    future: Future
    tenant: str
    enqueue_t: float


class RequestFrontend:
    """Coalesces single-query submissions into multi-query kernel passes.

    ``dispatch(xs, enqueue_ts)`` is the backend: a (Q, M) float32 batch
    plus each row's enqueue timestamp, returning per-request
    ``(values_row, rows_row)`` pairs — or raising, in which case every
    request in the pass receives the exception.  The scheduler thread
    owns the flush decision; ``submit`` never blocks on the kernel.

    Flush reasons (the ``flush_reasons`` histogram):

    * ``"target"``   — queue reached the adaptive (or fixed) target batch,
    * ``"deadline"`` — the oldest request's wait hit ``flush_deadline_s``,
    * ``"capacity"`` — queue reached the replica-multiplied per-pass cap
      (a burst larger than the max Q bucket splits into multiple passes),
    * ``"drain"``    — shutdown flushing the residual queue.
    """

    def __init__(
        self,
        dispatch: Callable,
        config: Optional[FrontendConfig] = None,
        replica_factor: int = 1,
    ):
        self.dispatch = dispatch
        self.config = config or FrontendConfig()
        if self.config.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.replica_factor = max(int(replica_factor), 1)
        self.capacity = self.config.max_batch * self.replica_factor
        self.model = IntensityModel(
            alpha=self.config.ewma_alpha,
            service_time_seed=self.config.service_time_seed,
        )
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._tenants: Dict[str, List[_Request]] = {}   # insertion-ordered
        self._rr: List[str] = []                        # round-robin cursor
        self._depth = 0
        self._closed = False
        self._draining = False
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.flushes = 0
        self.flush_reasons: Dict[str, int] = {
            "target": 0, "deadline": 0, "capacity": 0, "drain": 0,
        }
        self.batch_histogram: Dict[int, int] = {}
        self._idle = threading.Condition(self._lock)    # drain/join signal
        self._thread = threading.Thread(
            target=self._run, name="request-frontend", daemon=True
        )
        self._thread.start()

    # -- admission -----------------------------------------------------------

    def submit(
        self, x: np.ndarray, tenant: Optional[str] = None
    ) -> Future:
        """Enqueue one (M,) query; the future resolves to (values, rows).

        Raises :class:`QueueFullError` at the door once ``max_queue``
        requests wait, and ``RuntimeError`` after :meth:`close`.
        """
        x = np.asarray(x, np.float32)
        if x.ndim != 1:
            raise ValueError(
                f"submit takes one (M,) query vector, got shape {x.shape}"
            )
        fut: Future = Future()
        req = _Request(x, fut, tenant or "", time.monotonic())
        with self._lock:
            if self._closed:
                raise RuntimeError("frontend is closed")
            if self.config.max_queue and self._depth >= self.config.max_queue:
                self.rejected += 1
                raise QueueFullError(
                    f"{self._depth} requests queued "
                    f"(max_queue={self.config.max_queue})"
                )
            q = self._tenants.get(req.tenant)
            if q is None:
                self._tenants[req.tenant] = q = []
                self._rr.append(req.tenant)
            q.append(req)
            self._depth += 1
            self.submitted += 1
            self.model.observe_arrival(req.enqueue_t)
            self._work.notify()
        return fut

    # -- scheduler -----------------------------------------------------------

    def _oldest_wait(self, now: float) -> float:
        oldest = min(
            (q[0].enqueue_t for q in self._tenants.values() if q),
            default=now,
        )
        return now - oldest

    def _flush_decision(self, now: float) -> Tuple[Optional[str], float]:
        """(reason or None, seconds to sleep) — called under the lock."""
        if self._depth == 0:
            return None, 0.0            # sleep unbounded until work arrives
        if self._draining:
            return "drain", 0.0
        if self._depth >= self.capacity:
            return "capacity", 0.0
        target = (
            self.model.target_q(self.capacity)
            if self.config.adaptive else max(self.config.target_batch, 1)
        )
        if self._depth >= target:
            return "target", 0.0
        wait = self._oldest_wait(now)
        if wait >= self.config.flush_deadline_s:
            return "deadline", 0.0
        return None, max(self.config.flush_deadline_s - wait, 1e-4)

    def _take_batch(self) -> List[_Request]:
        """Up to ``capacity`` requests, round-robin across tenant queues.

        One request per tenant per round bounds starvation: a tenant's
        head-of-line request rides no later than the pass after every
        other tenant got one slot — a flood from one tenant cannot push
        another's request back more than one flush.
        """
        batch: List[_Request] = []
        while len(batch) < self.capacity and self._depth > 0:
            progressed = False
            for name in list(self._rr):
                if len(batch) >= self.capacity:
                    break
                q = self._tenants.get(name)
                if q:
                    batch.append(q.pop(0))
                    self._depth -= 1
                    progressed = True
            if not progressed:
                break
        # rotate the cursor so the next pass starts at a different tenant,
        # and drop drained tenant queues (a high-cardinality tenant space
        # must not grow the round-robin ring forever)
        if self._rr:
            self._rr.append(self._rr.pop(0))
        for name in [n for n, q in self._tenants.items() if not q]:
            del self._tenants[name]
            self._rr.remove(name)
        return batch

    def _run(self) -> None:
        while True:
            with self._lock:
                while True:
                    if self._closed and self._depth == 0:
                        self._idle.notify_all()
                        return
                    now = time.monotonic()
                    reason, sleep_s = self._flush_decision(now)
                    if reason is not None:
                        batch = self._take_batch()
                        break
                    if self._depth == 0:
                        self._idle.notify_all()
                        self._work.wait()       # empty queue: timer-free idle
                    else:
                        self._work.wait(timeout=sleep_s)
            self._dispatch_batch(batch, reason)

    def _dispatch_batch(self, batch: List[_Request], reason: str) -> None:
        if not batch:
            return
        self.flushes += 1
        self.flush_reasons[reason] = self.flush_reasons.get(reason, 0) + 1
        q = len(batch)
        self.batch_histogram[q] = self.batch_histogram.get(q, 0) + 1
        xs = np.stack([r.x for r in batch]).astype(np.float32)
        enq = [r.enqueue_t for r in batch]
        t0 = time.monotonic()
        try:
            results = self.dispatch(xs, enq)
        except Exception as e:
            for r in batch:
                if not r.future.cancelled():
                    r.future.set_exception(e)
            return
        finally:
            self.model.observe_service(q, time.monotonic() - t0)
            self.completed += q
        for r, res in zip(batch, results):
            if r.future.cancelled():
                continue
            if isinstance(res, BaseException):
                r.future.set_exception(res)
            else:
                r.future.set_result(res)

    # -- lifecycle & introspection -------------------------------------------

    def flush(self, timeout: Optional[float] = 30.0) -> None:
        """Block until every queued request has been dispatched (drain)."""
        with self._lock:
            if self._depth == 0:
                return
            self._draining = True
            self._work.notify()
            deadline = None if timeout is None else time.monotonic() + timeout
            while self._depth > 0:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    break
                self._idle.wait(timeout=left)
            self._draining = False

    def close(self, drain: bool = True, timeout: Optional[float] = 30.0) -> None:
        """Stop the scheduler.  ``drain`` (default) serves the residual
        queue first; otherwise queued futures are cancelled."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if drain:
                self._draining = True
            else:
                for q in self._tenants.values():
                    for r in q:
                        r.future.cancel()
                    q.clear()
                self._depth = 0
            self._work.notify_all()
        self._thread.join(timeout=timeout)

    @property
    def queue_depth(self) -> int:
        return self._depth

    def info(self) -> dict:
        """The ``dispatch_info()["frontend"]`` block."""
        with self._lock:
            return {
                "queue_depth": self._depth,
                "capacity": self.capacity,
                "replica_factor": self.replica_factor,
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "flushes": self.flushes,
                "flush_reasons": dict(self.flush_reasons),
                "batch_histogram": dict(sorted(self.batch_histogram.items())),
                "tenants": sum(1 for q in self._tenants.values() if q),
                "target_q": (
                    self.model.target_q(self.capacity)
                    if self.config.adaptive
                    else max(self.config.target_batch, 1)
                ),
                "intensity": self.model.snapshot(),
            }
