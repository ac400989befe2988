"""Serve-while-ingest similarity service over a mutable BS-CSR index.

Queries and live updates interleave against the same ``SparseEmbeddingIndex``:
updates land as delta tile-packets (no re-encode of the served stream), each
update batch swaps in a fresh immutable snapshot (copy-on-write stacked
buffers: only mutated partitions are rewritten), and a background-style
compaction policy re-encodes the live rows — partitions in parallel —
whenever churn has inflated the stream past the configured thresholds.
Queries dispatch through the device-resident executor: each snapshot
version's streams are pinned on device once, and a version bump (update or
compaction) invalidates exactly that pin.  This is the ROADMAP "streaming
index updates" item: the paper's static benchmark index, made a living
service.

This is the reference's ``repro/serve/streaming.py``, ported.  Answers come
from the multi-query kernel by default (``use_kernel=True``; the reference
defaults to its oracle only because its kernel runs interpreted off the
TPU); ``use_kernel=False`` selects the plain torch path.  The backing index
is single-device: the sharded plane is not ported (ROADMAP Queue 1 item 3).

**Crash safety + guardrails**:
attaching a :class:`~repro_torch.core.persistence.DurableIndexStore` makes every
mutation write-ahead logged and every compaction followed by an atomic
checkpoint (bounding the replay tail); :meth:`StreamingSimilarityService.
recover` rebuilds a bit-identical service from disk.  A
:class:`ServiceGuardrails` adds per-call deadlines, bounded
retry-with-backoff and admission control so one stuck or failing dispatch
cannot take the whole plane down with it.

**Continuous micro-batching**:
constructing the service with ``frontend=FrontendConfig(...)`` attaches a
:class:`~repro_torch.serve.frontend.RequestFrontend` — arriving single queries
(:meth:`StreamingSimilarityService.submit`, returning futures) coalesce
into multi-query kernel passes, with the flush moment picked from an
online arrival/service intensity model and a latency deadline.  Guardrail
deadlines then measure from enqueue, so queue wait counts against them.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import bscsr as bscsr_lib
from repro_torch.core.persistence import DurableIndexStore
from repro_torch.core.similarity import SimilaritySearchStats, SparseEmbeddingIndex
from repro_torch.serve.frontend import FrontendConfig, RequestFrontend
from repro_torch.utils.watchdog import DeadlineExceeded, Watchdog


class AdmissionError(RuntimeError):
    """Rejected at the door: the in-flight cap is full (shed, don't queue)."""


@dataclasses.dataclass
class CompactionPolicy:
    """When to pay a re-encode to reclaim delta packets and tombstones.

    ``max_delta_fraction`` bounds the live nnz served from delta segments
    (delta packets are step-padded per update batch, so they carry more
    padding than a fresh base encode); ``max_tombstone_fraction`` bounds
    retired candidate slots relative to live rows (tombstoned slots still
    flow through the kernel's per-core top-k scratchpad until compaction).
    ``max_wal_records`` (0 disables) additionally bounds the write-ahead
    log's replay tail when a ``DurableIndexStore`` is attached — compaction
    checkpoints, which rotates the WAL, so recovery time stays bounded even
    under churn that never trips the fraction thresholds.
    """

    max_delta_fraction: float = 0.25
    max_tombstone_fraction: float = 0.10
    max_wal_records: int = 0

    def should_compact(
        self, stats: SimilaritySearchStats, wal_records: int = 0
    ) -> bool:
        if stats.delta_fraction > self.max_delta_fraction:
            return True
        if self.max_wal_records and wal_records >= self.max_wal_records:
            return True
        return stats.tombstone_count > self.max_tombstone_fraction * max(
            stats.n_rows, 1
        )


@dataclasses.dataclass
class ServiceGuardrails:
    """Request-plane protection knobs (all disabled by default).

    ``deadline_s`` bounds one ``search`` call's wall clock — a Python
    thread cannot interrupt an in-flight CUDA launch, so an overdue call
    raises :class:`~repro_torch.utils.watchdog.DeadlineExceeded` as soon as the
    dispatch returns instead of handing back a stale answer.  With the
    micro-batching frontend active the deadline is measured from *enqueue*
    (the moment :meth:`StreamingSimilarityService.submit` accepted the
    request), so queue wait counts against it instead of being added on
    top — the frontend's flush timer can then preempt the deadline.
    ``max_retries``/``backoff_s`` retry transient dispatch failures
    (exponential backoff: ``backoff_s * 2**attempt``); deadline overruns
    and invalid inputs are never retried.  ``max_in_flight`` sheds load at
    the door with :class:`AdmissionError` once that many ``search`` calls
    are already executing.
    """

    deadline_s: float = 0.0
    max_retries: int = 0
    backoff_s: float = 0.0
    max_in_flight: int = 0


class StreamingSimilarityService:
    """Facade pairing batched queries with live ingest + auto-compaction.

    With ``store=`` (a :class:`~repro_torch.core.persistence.DurableIndexStore`)
    the service becomes crash-safe: mutations are write-ahead logged before
    they apply, compactions checkpoint (rotating the WAL), and
    :meth:`recover` rebuilds the service bit-identically from the last
    checkpoint + WAL tail.  ``use_kernel`` (default True) answers through
    the multi-query kernel; False selects the plain torch path.
    """

    def __init__(
        self,
        index: SparseEmbeddingIndex,
        policy: Optional[CompactionPolicy] = None,
        guardrails: Optional[ServiceGuardrails] = None,
        store: Optional[DurableIndexStore] = None,
        frontend: Optional[FrontendConfig] = None,
        use_kernel: bool = True,
    ):
        self.index = index
        self.policy = policy or CompactionPolicy()
        self.guardrails = guardrails or ServiceGuardrails()
        self.store = store
        self.use_kernel = use_kernel
        self.compactions = 0
        self.checkpoints = 0
        self.queries_served = 0
        self.rows_ingested = 0
        self.rows_deleted = 0
        self.retries = 0
        self.failures = 0
        self.deadline_exceeded = 0
        self.admission_rejected = 0
        self.degraded_queries = 0
        self.replayed_records = 0
        self.last_search_degraded = False
        self._in_flight = 0
        self._flight_lock = threading.Lock()
        self._compacting = False
        # Continuous micro-batching frontend (serve/frontend.py): arriving
        # single queries coalesce into multi-query kernel passes; the
        # scheduler is pure policy on top of the guardrailed dispatch.
        self.frontend: Optional[RequestFrontend] = None
        if frontend is not None:
            self.frontend = RequestFrontend(
                self._frontend_dispatch,
                config=frontend,
                replica_factor=index.replica_factor,
            )
        if store is not None and not store.has_checkpoint:
            self.checkpoint()  # anchor the WAL: logging needs a base state

    @classmethod
    def recover(
        cls,
        store: DurableIndexStore,
        policy: Optional[CompactionPolicy] = None,
        guardrails: Optional[ServiceGuardrails] = None,
    ) -> "StreamingSimilarityService":
        """Rebuild the service from disk: last checkpoint + WAL-tail replay.

        The recovered index answers bit-identically to the crashed
        process's (same streams, same executor signature — resuming costs
        device re-pins but zero retraces) and keeps logging to the same
        WAL, so recovery is itself crash-safe.  It serves on the store's
        ``device``.
        """
        index, replayed = store.recover()
        svc = cls(
            SparseEmbeddingIndex.from_index(index),
            policy=policy, guardrails=guardrails, store=store,
        )
        svc.replayed_records = replayed
        return svc

    def checkpoint(self) -> None:
        """Atomically persist the full index state; rotates the WAL."""
        if self.store is None:
            raise ValueError("no DurableIndexStore attached")
        self.store.checkpoint(self.index.index)
        self.checkpoints += 1

    def search(
        self, xs: np.ndarray, use_kernel: Optional[bool] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Answer a (Q, M) query batch from the current snapshot.

        ``use_kernel=None`` means the service's ``use_kernel``.

        Guardrails (when enabled): sheds load once ``max_in_flight`` calls
        are executing, retries transient dispatch failures with exponential
        backoff, and raises :class:`DeadlineExceeded` instead of returning
        an answer that outlived ``deadline_s``.
        """
        g = self.guardrails
        with self._flight_lock:
            if g.max_in_flight and self._in_flight >= g.max_in_flight:
                self.admission_rejected += 1
                raise AdmissionError(
                    f"{self._in_flight} searches already in flight "
                    f"(max_in_flight={g.max_in_flight})"
                )
            self._in_flight += 1
        if use_kernel is None:
            use_kernel = self.use_kernel
        try:
            xs = np.atleast_2d(np.asarray(xs, np.float32))
            with Watchdog(g.deadline_s, raise_on_timeout=True) as wd:
                out = self._dispatch_with_retry(xs, use_kernel, wd)
            self.queries_served += xs.shape[0]
            self._note_degraded()
            return out
        except DeadlineExceeded:
            self.deadline_exceeded += 1
            raise
        finally:
            with self._flight_lock:
                self._in_flight -= 1

    def _dispatch_with_retry(self, xs, use_kernel, wd: Watchdog):
        attempt = 0
        while True:
            try:
                return self.index.query_batch(xs, use_kernel=use_kernel)
            except (ValueError, DeadlineExceeded):
                raise               # invalid input / overdue: never retried
            except Exception:
                self.failures += 1
                if attempt >= self.guardrails.max_retries:
                    raise
                wd.check()          # don't sleep past an expired deadline
                if self.guardrails.backoff_s:
                    time.sleep(self.guardrails.backoff_s * (2 ** attempt))
                attempt += 1
                self.retries += 1

    # -- micro-batching frontend (serve/frontend.py) -------------------------

    def submit(self, x: np.ndarray, tenant: Optional[str] = None) -> Future:
        """Enqueue one (M,) query for coalesced dispatch; returns a future.

        Requires ``frontend=FrontendConfig(...)`` at construction.  The
        future resolves to this request's ``(values, rows)`` pair — or to
        :class:`DeadlineExceeded` if the request outlived
        ``guardrails.deadline_s`` measured from *this* call (queue wait
        included).  Invalid inputs raise here, in the caller's thread,
        before anything is enqueued.
        """
        if self.frontend is None:
            raise ValueError(
                "no frontend configured — pass frontend=FrontendConfig() "
                "to StreamingSimilarityService"
            )
        x = np.asarray(x, np.float32)
        self.index._validate_query(x, batched=False)
        return self.frontend.submit(x, tenant=tenant)

    def flush(self, timeout: Optional[float] = 30.0) -> None:
        """Block until every queued frontend request has been dispatched."""
        if self.frontend is not None:
            self.frontend.flush(timeout=timeout)

    def close(self, drain: bool = True) -> None:
        """Stop the frontend scheduler (draining the queue by default)."""
        if self.frontend is not None:
            self.frontend.close(drain=drain)

    def __enter__(self) -> "StreamingSimilarityService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _frontend_dispatch(self, xs: np.ndarray, enqueue_ts) -> list:
        """One coalesced kernel pass over a (Q, M) batch of queued requests.

        Guardrails compose with queue wait instead of double-counting it:
        the retry watchdog is armed with the *youngest* request's residual
        budget (so backoff sleeps never outlive every live deadline), and
        afterwards each request is individually checked against
        ``deadline_s`` measured from its own enqueue time.  Returns one
        ``(values, rows)`` pair — or a :class:`DeadlineExceeded` — per
        request, positionally.
        """
        g = self.guardrails
        q = xs.shape[0]
        with self._flight_lock:
            if g.max_in_flight and self._in_flight >= g.max_in_flight:
                self.admission_rejected += 1
                raise AdmissionError(
                    f"{self._in_flight} passes already in flight "
                    f"(max_in_flight={g.max_in_flight})"
                )
            self._in_flight += 1
        try:
            budget = 0.0
            if g.deadline_s:
                budget = g.deadline_s - (time.monotonic() - max(enqueue_ts))
                if budget <= 0:   # every request is already overdue: no pass
                    self.deadline_exceeded += q
                    return [
                        DeadlineExceeded(
                            f"queued past the {g.deadline_s}s deadline"
                        )
                        for _ in range(q)
                    ]
            try:
                with Watchdog(budget) as wd:
                    vals, rows = self._dispatch_with_retry(
                        xs, self.use_kernel, wd
                    )
            except DeadlineExceeded as e:
                self.deadline_exceeded += q
                return [e for _ in range(q)]
            done = time.monotonic()
            out: list = []
            for i, enq in enumerate(enqueue_ts):
                if g.deadline_s and done - enq > g.deadline_s:
                    self.deadline_exceeded += 1
                    out.append(DeadlineExceeded(
                        f"answer outlived the {g.deadline_s}s deadline "
                        f"(measured from enqueue)"
                    ))
                else:
                    self.queries_served += 1
                    out.append((vals[i], rows[i]))
            self._note_degraded()
            return out
        finally:
            with self._flight_lock:
                self._in_flight -= 1

    def _note_degraded(self) -> None:
        backing = self.index.index
        self.last_search_degraded = bool(
            getattr(backing, "last_query_degraded", False)
        )
        if self.last_search_degraded:
            self.degraded_queries += 1

    def ingest(
        self, embeddings: np.ndarray, ids: Optional[Sequence[int]] = None
    ) -> np.ndarray:
        """Upsert dense rows (append or replace); may trigger compaction.

        With a store attached the batch is write-ahead logged (as the
        sparsified rows the index will actually encode) BEFORE it applies,
        so a crash between log and apply replays to the identical state.
        """
        if self.store is not None:
            rows = self._sparse_rows(embeddings)
            if ids is None:
                self.store.log_add(rows)
            else:
                self.store.log_replace(list(ids), rows)
        out = self.index.upsert(embeddings, ids=ids)
        self.rows_ingested += len(out)
        self._maybe_compact()
        return out

    def _sparse_rows(self, embeddings: np.ndarray) -> list:
        """The exact sparse rows ``upsert`` will encode (same top-m path)."""
        embeddings = np.atleast_2d(np.asarray(embeddings, np.float32))
        m_keep = min(self.index.nnz_per_row, embeddings.shape[1])
        sparse = bscsr_lib.sparsify_topm(embeddings, m_keep)
        return [
            (
                sparse.indices[sparse.indptr[i]: sparse.indptr[i + 1]],
                sparse.data[sparse.indptr[i]: sparse.indptr[i + 1]],
            )
            for i in range(sparse.shape[0])
        ]

    def delete(self, ids: Sequence[int]) -> None:
        ids = list(ids)  # a one-shot iterable must not be consumed twice
        if self.store is not None:
            self.store.log_delete(ids)
        self.index.delete(ids)
        self.rows_deleted += len(ids)
        self._maybe_compact()

    def _maybe_compact(self) -> None:
        # Re-entrancy guard: a compaction that failed mid-flight (fault
        # injection, device loss) must not be re-triggered from inside the
        # retry/ingest path while the first attempt is still unwinding.
        if self._compacting:
            return
        wal = self.store.wal_records if self.store is not None else 0
        if not self.policy.should_compact(self.index.stats(), wal_records=wal):
            return
        self._compacting = True
        try:
            if self.store is not None:
                # Write-ahead: a crash between the record and the compact
                # replays the compact — deterministic from the live rows,
                # so replay converges on the same state either way.
                self.store.log_compact()
            self.index.compact()
            self.compactions += 1
            if self.store is not None:
                self.checkpoint()  # rotate the WAL: bounded replay tail
        finally:
            self._compacting = False

    def stats(self) -> SimilaritySearchStats:
        return self.index.stats()

    def dispatch_info(self) -> dict:
        """Executor cache + signature-bucket stats for the served snapshot.

        The ``retraces`` counter is the serve-while-ingest health signal:
        with ``churn_stable`` snapshots it stays flat across ingest (each
        refresh re-pins arrays but reuses the query fn) and only moves when
        a signature bucket doubles or ``compact()`` reshapes the partition
        plan.

        ``service`` adds the request-plane counters (retries, failures,
        deadline overruns, admission rejects, degraded answers) and the
        durability state (checkpoints written, WAL replay-tail length).
        """
        info = self.index.dispatch_info()
        info["service"] = {
            "queries_served": self.queries_served,
            "in_flight": self._in_flight,
            "retries": self.retries,
            "failures": self.failures,
            "deadline_exceeded": self.deadline_exceeded,
            "admission_rejected": self.admission_rejected,
            "degraded_queries": self.degraded_queries,
            "last_search_degraded": self.last_search_degraded,
            "compactions": self.compactions,
            "checkpoints": self.checkpoints,
            "wal_records": (
                self.store.wal_records if self.store is not None else 0
            ),
            "replayed_records": self.replayed_records,
        }
        if self.frontend is not None:
            info["frontend"] = self.frontend.info()
        return info
