"""The port's span recorder (``repro_torch.utils.tracing``) on the CPU.

Off, a span site returns the shared no-op and nothing is stored.  Traced
(``recording()`` or a ``torch.profiler`` session on the calling thread), a
query yields the span tree of the query path, the serving frontend stores
one ``frontend.queue`` span per request under the pass it rode, the
decision travels with each request into the frontend's thread, the
scheduler's spans cover its traced time, and a span's start on the
profiler's clock meets its ``record_function`` twin's.
"""
import threading
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import bscsr
from repro_torch.core import topk_spmv as api
from repro_torch.core.similarity import SparseEmbeddingIndex
from repro_torch.serve.frontend import FrontendConfig, RequestFrontend
from repro_torch.utils import tracing

N_COLS = 64
QUERY_TREE = {"index.validate": "index.query_batch", "index.upload": "index.query_batch",
              "executor.prepare": "index.query_batch", "executor.pin": "executor.prepare",
              "executor.build": "executor.prepare", "executor.launch": "index.query_batch",
              "executor.finalize": "index.query_batch", "index.wait": "index.query_batch",
              "index.d2h": "index.query_batch", "index.query_batch": None}


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def small_index(seed=0):
    csr = bscsr.synthetic_embedding_csr(600, N_COLS, 8, "gamma", seed=seed)
    return SparseEmbeddingIndex(csr, api.TopKSpMVConfig(
        big_k=16, k=4, num_partitions=4, block_size=32, value_format="BF16", device="cpu"))


def queries(n, seed=1):
    return np.random.default_rng(seed).standard_normal((n, N_COLS)).astype(np.float32)


class Answer:
    """A frontend backend: zeros for each row, after ``delay_s``."""

    def __init__(self, delay_s=0.0):
        self.delay_s = delay_s

    def __call__(self, xs, enqueue_ts):
        if self.delay_s:
            time.sleep(self.delay_s)
        z = np.zeros(4, np.float32)
        return [(z, z) for _ in range(xs.shape[0])]


def by_name(records, name):
    return [r for r in records if r.name == name]


def self_time_ns(r, records):
    return (r.end_ns - r.start_ns) - sum(c.end_ns - c.start_ns for c in records
                                         if c.parent_id == r.span_id)


def test_off_nothing_is_recorded_and_spans_are_the_shared_noop():
    index = small_index()
    index.query_batch(queries(3))
    index.query(queries(1)[0])
    assert tracing.records() == [] and tracing.dropped() == 0
    assert not tracing.wanted() and not tracing.enabled()
    assert tracing.span("x") is tracing.NOOP
    assert tracing.open_span("x", 0) is tracing.NOOP
    assert tracing.entry("x") is tracing.NOOP
    assert tracing.current() is None


def test_query_batch_yields_the_span_tree():
    index = small_index()
    with tracing.recording():
        index.query_batch(queries(5))
        index.query_batch(queries(5))
    recs = tracing.records()
    first, second = by_name(recs, "index.query_batch")
    assert first.parent_id is None and first.pass_id != second.pass_id
    ids = {r.span_id: r for r in recs}
    for root, names in ((first, set(QUERY_TREE)),
                        (second, set(QUERY_TREE) - {"executor.pin", "executor.build"})):
        tree = [r for r in recs if r.pass_id == root.pass_id]
        assert {r.name for r in tree} == names and len(tree) == len(names)
        for r in tree:
            parent = QUERY_TREE[r.name]
            assert (ids[r.parent_id].name if r.parent_id else None) == parent
            assert r.start_ns <= r.end_ns and self_time_ns(r, recs) >= 0
            if r.parent_id:
                p = ids[r.parent_id]
                assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert tracing.current() is None and not tracing.enabled()


def test_frontend_queue_spans_ride_their_passes():
    n = 22
    fe = RequestFrontend(Answer(), FrontendConfig(
        flush_deadline_s=0.02, max_batch=8, adaptive=False, target_batch=4))
    try:
        with tracing.recording():
            futs = [fe.submit(x) for x in queries(n)]
            for f in futs:
                f.result(timeout=30)
    finally:
        fe.close()
    recs = tracing.records()
    waits = by_name(recs, "frontend.queue")
    passes = {r.pass_id: r for r in by_name(recs, "frontend.pass")}
    assert len(waits) == n and len({r.request_id for r in waits}) == n
    assert sum(p.attrs["q"] for p in passes.values()) == n
    for pid, p in passes.items():
        rode = [w for w in waits if w.pass_id == pid]
        assert len(rode) == p.attrs["q"] and p.attrs["reason"] in fe.flush_reasons
        assert all(w.end_ns == p.start_ns for w in rode)
        kids = sorted((r for r in recs if r.parent_id == p.span_id), key=lambda r: r.start_ns)
        assert [k.name for k in kids] == ["frontend.stack", "service.dispatch",
                                         "frontend.respond"]
        assert kids[0].start_ns == p.start_ns and kids[-1].end_ns == p.end_ns


def test_profiled_submitter_carries_tracing_into_the_frontend_thread():
    index = small_index()
    fe = RequestFrontend(lambda xs, enq: list(zip(*index.query_batch(xs))), FrontendConfig(
        flush_deadline_s=0.005, max_batch=16, adaptive=False, target_batch=3))
    xs = queries(9)
    try:
        for f in [fe.submit(x) for x in xs]:      # untraced: set-up traffic
            f.result(timeout=30)
        time.sleep(0.02)
        with profile(activities=[ProfilerActivity.CPU]):
            for f in [fe.submit(x) for x in xs]:
                f.result(timeout=30)
        for f in [fe.submit(x) for x in xs]:      # untraced again
            f.result(timeout=30)
    finally:
        fe.close()
    recs = tracing.records()
    waits = by_name(recs, "frontend.queue")
    assert len(waits) == len(xs)
    first = min(w.start_ns for w in waits)
    assert all(r.start_ns >= first for r in recs)
    passes = by_name(recs, "frontend.pass")
    assert sum(p.attrs["q"] for p in passes) == len(xs)
    assert {r.thread for r in passes} == {fe._thread.ident}
    inner = by_name(recs, "index.query_batch")
    assert len(inner) == len(passes) and all(r.parent_id is not None for r in inner)


def test_scheduler_spans_cover_its_traced_interval():
    fe = RequestFrontend(Answer(delay_s=0.004), FrontendConfig(
        flush_deadline_s=0.01, max_batch=8, adaptive=False, target_batch=4))
    rng = np.random.default_rng(5)
    futs = []
    try:
        with tracing.recording():
            for x in queries(120):
                futs.append(fe.submit(x))
                time.sleep(float(rng.exponential(0.006)))
            for f in futs:
                f.result(timeout=30)
    finally:
        fe.close()
    recs = tracing.records()
    sched = sorted((r for r in recs if r.thread == fe._thread.ident and r.parent_id is None
                    and r.name in ("frontend.idle", "frontend.hold", "frontend.pass")),
                   key=lambda r: r.start_ns)
    assert {r.name for r in sched} == {"frontend.idle", "frontend.hold", "frontend.pass"}
    for a, b in zip(sched, sched[1:]):
        assert a.end_ns <= b.start_ns
    interval = sched[-1].end_ns - sched[0].start_ns
    covered = sum(r.end_ns - r.start_ns for r in sched)
    assert covered >= 0.98 * interval, (covered, interval)


def test_span_start_meets_its_record_function_twin():
    index = small_index()
    xs = queries(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        index.query_batch(xs)       # the first record_function of a session is slow
        index.query_batch(xs)
    ours = by_name(tracing.records(), "index.query_batch")[1]
    twins = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                   if e.name() == "index.query_batch")
    assert len(twins) == 2
    assert abs(twins[1] - ours.start_ns) < 1_000_000


def test_store_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 5)
    for i in range(8):
        tracing.add("x", i, i + 1)
    assert len(tracing.records()) == 5 and tracing.dropped() == 3
    tracing.reset()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_traced_work_in_one_thread_leaves_another_untraced():
    index = small_index()
    xs = queries(2)
    seen = {}
    started, release = threading.Event(), threading.Event()

    def other():
        started.set()
        assert release.wait(timeout=30)
        seen["span"] = tracing.span("other")
        index.query_batch(xs)

    t = threading.Thread(target=other)
    t.start()
    assert started.wait(timeout=30)
    with tracing.traced():
        with tracing.span("mine"):
            release.set()
            t.join(timeout=30)
    assert not t.is_alive()
    assert seen["span"] is tracing.NOOP
    assert [r.name for r in tracing.records()] == ["mine"]
