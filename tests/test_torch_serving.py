"""The port's serving plane against the reference's, on the CPU.

Durable state, persistence, fault injection and the micro-batching
frontend: the same seeded inputs go through ``repro`` and ``repro_torch``
(``device="cpu"``, the kernels' plain versions).

- State: ``export_state`` arrays equal byte for byte (bf16 as ``uint16``
  bits), ``meta`` equal but for ``interpret`` / ``device``; ``from_state``
  round-trips bit for bit with the same signature and no retrace.
- Persistence and faults mirror ``tests/test_persistence.py`` and
  ``tests/test_fault_injection.py`` on the port; a store the reference
  writes recovers in the port with an equal ``export_state``.
- Frontend: the scheduler-policy and ``IntensityModel`` cases of
  ``tests/test_frontend.py`` run over both packages' classes; the service
  cases run on the port's service.

Comparisons within the port (recovered against live, retried against a
never-faulted control) are bit for bit.  Answers of the port against the
reference's are within rtol = atol = 1e-5 (the two oracles sum in other
orders), with equal row ids outside near-ties.
"""
import importlib
import sys
import threading
import time
from concurrent.futures import CancelledError

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bscsr as jbscsr
from repro.core import faults as jfaults
from repro.core.persistence import DurableIndexStore as JStore
from repro.core.persistence import WriteAheadLog as JWal
from repro.core.similarity import SparseEmbeddingIndex as JIndex
from repro.serve import frontend as jfrontend
from repro.serve import CompactionPolicy as JPolicy
from repro.serve import StreamingSimilarityService as JService
from repro_torch.convert import state_from_reference
from repro_torch.core import bscsr as tbscsr
from repro_torch.core import topk_spmv as ttopk
from repro_torch.core.faults import INJECTION_POINTS, FaultInjected, FaultPlan, fault_point
from repro_torch.core.persistence import DurableIndexStore, WriteAheadLog
from repro_torch.core.similarity import SparseEmbeddingIndex
from repro_torch.serve import frontend as tfrontend
from repro_torch.serve import (
    CompactionPolicy,
    FrontendConfig,
    ServiceGuardrails,
    StreamingSimilarityService,
)
from repro_torch.utils.watchdog import DeadlineExceeded

jtopk = importlib.import_module("repro.core.topk_spmv")

N_COLS = 64
TOL = 1e-5
# The points with a caller in the port; dispatch.shard and bundle.scatter
# wait for the sharded plane.
PORTED_POINTS = ("refresh.cow_rewrite", "refresh.swap", "compact.swap", "wal.append",
                 "checkpoint.write", "checkpoint.rename")


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

def random_rows(rng, n, nnz=6):
    out = []
    for _ in range(n):
        cols = np.sort(rng.choice(N_COLS, size=nnz, replace=False))
        vals = rng.standard_normal(nnz).astype(np.float32)
        vals[vals == 0.0] = 0.5
        out.append((cols.astype(np.int32), vals))
    return out


def index_config(**kw):
    return dict(big_k=8, k=32, num_partitions=4, block_size=32, **kw)


def port_index(recall_target=None, value_format="F32", churn_stable=True):
    csr = jbscsr.synthetic_embedding_csr(240, N_COLS, 8, "gamma", seed=5)
    cfg = ttopk.TopKSpMVConfig(device="cpu", **index_config(
        churn_stable=churn_stable, recall_target=recall_target, value_format=value_format))
    return ttopk.MutableTopKSpMVIndex(
        tbscsr.CSRMatrix(csr.indptr, csr.indices, csr.data, csr.shape), cfg)


def reference_index(recall_target=None, value_format="F32"):
    csr = jbscsr.synthetic_embedding_csr(240, N_COLS, 8, "gamma", seed=5)
    cfg = jtopk.TopKSpMVConfig(**index_config(recall_target=recall_target,
                                              value_format=value_format))
    return jtopk.MutableTopKSpMVIndex(csr, cfg)


def churn(index, rng, store=None, compact=False):
    """add, delete, replace (and compact, add): mirrored into the store's WAL."""
    b1 = random_rows(rng, 7)
    if store:
        store.log_add(b1)
    ids = index.add_rows(b1)
    if store:
        store.log_delete(ids[:2])
    index.delete_rows(ids[:2])
    b2 = random_rows(rng, 3)
    if store:
        store.log_replace(ids[2:5], b2)
    index.replace_rows(ids[2:5], b2)
    if compact:
        if store:
            store.log_compact()
        index.compact()
        b3 = random_rows(rng, 4)
        if store:
            store.log_add(b3)
        index.add_rows(b3)
    return ids


def answer(index, x, use_kernel=False):
    v, r = ttopk.topk_spmv(index, torch.from_numpy(x), use_kernel=use_kernel)
    return v.numpy(), r.numpy()


def reference_answer(index, x):
    v, r = jtopk.topk_spmv(index, jnp.asarray(x), use_kernel=False)
    return np.asarray(v), np.asarray(r)


def assert_bit_identical(a, b, x, use_kernel=False):
    for got, want in zip(answer(a, x, use_kernel), answer(b, x, use_kernel)):
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def assert_close_rows(want, got, tol=TOL):
    """Values within tol; row ids equal except inside a near-tie of scores."""
    (wv, wr), (gv, gr) = want, got
    np.testing.assert_allclose(gv, wv, rtol=tol, atol=tol)
    for j in np.nonzero(wr != gr)[0]:
        gaps = np.abs(wv - wv[j])
        gaps[j] = np.inf
        assert gaps.min() <= 2 * tol, f"row ids differ outside a tie at {j}"


def bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_same_arrays(want: dict, got: dict):
    assert set(want) == set(got)
    for name in want:
        w, g = bits(want[name]), bits(got[name])
        assert (w.dtype, w.shape) == (g.dtype, g.shape), name
        assert w.tobytes() == g.tobytes(), name


def assert_same_meta(ref_meta: dict, port_meta: dict, device="cpu"):
    ref_cfg, port_cfg = dict(ref_meta["config"]), dict(port_meta["config"])
    ref_cfg.pop("interpret")
    assert port_cfg.pop("device") == device
    assert ref_cfg == port_cfg
    drop = lambda m: {k: v for k, v in m.items() if k != "config"}  # noqa: E731
    assert drop(ref_meta) == drop(port_meta)


def assert_same_snapshot(a, b):
    pa, pb = a.packed, b.packed
    assert pa.signature_info() == pb.signature_info()
    for name in ("vals", "cols", "flags", "words", "slot_to_row", "num_slots", "tombstones"):
        x, y = getattr(pa, name), getattr(pb, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert np.ascontiguousarray(x).tobytes() == np.ascontiguousarray(y).tobytes(), name
    for ga, gb in zip(pa.groups or (), pb.groups or ()):
        assert (ga.class_name, ga.cores) == (gb.class_name, gb.cores)
        assert np.asarray(ga.words).tobytes() == np.asarray(gb.words).tobytes()


# ---------------------------------------------------------------------------
# State: export_state / from_state
# ---------------------------------------------------------------------------

class TestState:
    @pytest.mark.parametrize("recall_target", [None, 0.95])
    def test_export_state_matches_the_reference(self, recall_target):
        j = reference_index(recall_target, "BF16")
        t = port_index(recall_target, "BF16")
        churn(j, np.random.default_rng(21), compact=True)
        churn(t, np.random.default_rng(21), compact=True)
        (jm, ja), (tm, ta) = j.export_state(), t.export_state()
        assert_same_meta(jm, tm)
        assert_same_arrays(ja, ta)
        if recall_target is None:
            assert any(a.dtype.name == "bfloat16" for a in ja.values())

    @pytest.mark.parametrize("recall_target", [None, 0.95])
    def test_from_state_round_trips_bit_identically(self, rng, recall_target):
        index = port_index(recall_target, "BF16")
        churn(index, rng, compact=True)
        churn(index, rng)
        xs = rng.standard_normal((3, N_COLS)).astype(np.float32)
        ex = ttopk.query_executor(index.config)
        for path in ("kernel", "reference"):
            ex.query(xs[0], index.packed, path=path)
            ex.query_batched(xs, index.packed, path=path)
        before = ex.cache_info()
        meta, arrays = index.export_state()
        back = ttopk.MutableTopKSpMVIndex.from_state(meta, arrays, device="cpu")
        assert_same_snapshot(index, back)
        for use_kernel in (True, False):
            assert_bit_identical(index, back, xs[0], use_kernel)
            for path in ("kernel", "reference"):
                got = ex.query_batched(xs, back.packed, path=path)
                want = ex.query_batched(xs, index.packed, path=path)
                for g, w in zip(got, want):
                    assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                                       w.view(torch.int32) if w.is_floating_point() else w)
        after = ex.cache_info()
        assert after["fn_builds"] == before["fn_builds"]
        assert after["retraces"] == before["retraces"]
        m2, a2 = back.export_state()
        assert m2 == meta
        assert_same_arrays(arrays, a2)
        assert (back.n_rows, back.n_rows_total, back.version) == \
            (index.n_rows, index.n_rows_total, index.version)

    def test_restored_signature_holds_across_identical_churn(self, rng):
        index = port_index()
        churn(index, rng)
        back = ttopk.MutableTopKSpMVIndex.from_state(*index.export_state(), device="cpu")
        assert index.packed.signature_info() == back.packed.signature_info()
        extra = random_rows(rng, 4)
        index.add_rows(extra)
        back.add_rows(extra)
        assert_same_snapshot(index, back)

    def test_exports_are_deterministic(self, rng):
        index = port_index(0.95)
        churn(index, rng)
        (m1, a1), (m2, a2) = index.export_state(), index.export_state()
        assert m1 == m2
        assert_same_arrays(a1, a2)

    @pytest.mark.parametrize("recall_target", [None, 0.95])
    def test_reference_state_converts_and_restores(self, recall_target):
        j = reference_index(recall_target, "BF16")
        t = port_index(recall_target, "BF16")
        churn(j, np.random.default_rng(22))
        churn(t, np.random.default_rng(22))
        jm, ja = j.export_state()
        with pytest.raises(ValueError, match="state_from_reference"):
            ttopk.MutableTopKSpMVIndex.from_state(jm, ja, device="cpu")
        back = ttopk.MutableTopKSpMVIndex.from_state(
            *state_from_reference(jm, ja, device="cpu"), device="cpu")
        assert_same_snapshot(t, back)
        tm, ta = t.export_state()
        bm, ba = back.export_state()
        assert bm == tm
        assert_same_arrays(ta, ba)
        x = np.random.default_rng(23).standard_normal(N_COLS).astype(np.float32)
        assert_close_rows(reference_answer(j, x), answer(back, x))


# ---------------------------------------------------------------------------
# Persistence: the WAL and the store
# ---------------------------------------------------------------------------

class TestWriteAheadLog:
    def test_append_and_iterate(self, tmp_path):
        wal = WriteAheadLog(tmp_path / "w.log")
        wal.append("add", {"x": np.arange(5, dtype=np.int32)})
        wal.append("compact")
        wal.append("delete", {"ids": np.asarray([3, 1], np.int64)})
        assert len(wal) == 3
        recs = list(wal.records())
        assert [k for k, _ in recs] == ["add", "compact", "delete"]
        np.testing.assert_array_equal(recs[0][1]["x"], np.arange(5))
        np.testing.assert_array_equal(recs[2][1]["ids"], [3, 1])

    def test_reopen_sees_all_records(self, tmp_path):
        path = tmp_path / "w.log"
        WriteAheadLog(path).append("add", {"x": np.ones(3, np.float32)})
        assert len(WriteAheadLog(path)) == 1

    def test_torn_tail_detected_and_truncated(self, tmp_path):
        path = tmp_path / "w.log"
        wal = WriteAheadLog(path)
        wal.append("add", {"x": np.arange(4, dtype=np.int32)})
        wal.append("delete", {"ids": np.asarray([0], np.int64)})
        path.write_bytes(path.read_bytes()[:-7])   # a crash mid-append
        wal2 = WriteAheadLog(path)
        assert len(wal2) == 1
        wal2.append("compact")
        assert [k for k, _ in WriteAheadLog(path).records()] == ["add", "compact"]

    def test_garbage_prefix_yields_empty_log(self, tmp_path):
        path = tmp_path / "w.log"
        path.write_bytes(b"not a wal at all" * 4)
        assert len(WriteAheadLog(path)) == 0

    def test_both_packages_log_equal_records(self, tmp_path):
        """The same mutations logged by each package decode to equal records
        in either package's reader (the bytes may differ: zip timestamps)."""
        jstore, tstore = JStore(tmp_path / "ref"), DurableIndexStore(tmp_path / "port",
                                                                     device="cpu")
        jstore.checkpoint(reference_index())
        tstore.checkpoint(port_index())
        churn(reference_index(), np.random.default_rng(3), jstore, compact=True)
        churn(port_index(), np.random.default_rng(3), tstore, compact=True)
        paths = (jstore._wal_path(0), tstore._wal_path(0))
        decoded = [list(reader(p).records()) for p in paths for reader in (JWal, WriteAheadLog)]
        assert [k for k, _ in decoded[0]] == ["add", "delete", "replace", "compact", "add"]
        for recs in decoded[1:]:
            assert [k for k, _ in recs] == [k for k, _ in decoded[0]]
            for (_, a), (_, b) in zip(decoded[0], recs):
                assert_same_arrays(a, b)


class TestDurableIndexStore:
    @pytest.mark.parametrize("recall_target", [None, 0.95])
    def test_recover_is_bit_identical(self, rng, tmp_path, recall_target):
        index = port_index(recall_target)
        store = DurableIndexStore(tmp_path, device="cpu")
        store.checkpoint(index)
        churn(index, rng, store)
        back, replayed = store.recover()
        assert replayed == 3
        assert set(store.last_checkpoint) == {"bytes", "export_s", "write_s"}
        assert store.last_checkpoint["bytes"] == sum(
            f.stat().st_size for f in (tmp_path / "ckpt-00000000").iterdir())
        assert store.last_recovery["records"] == 3
        assert min(store.last_recovery[k] for k in ("read_s", "from_state_s", "replay_s")) > 0
        x = rng.standard_normal(N_COLS).astype(np.float32)
        for use_kernel in (True, False):
            assert_bit_identical(index, back, x, use_kernel)
        assert_same_snapshot(index, back)

    def test_replayed_compact_converges(self, rng, tmp_path):
        index = port_index()
        store = DurableIndexStore(tmp_path, device="cpu")
        store.checkpoint(index)
        churn(index, rng, store, compact=True)
        back, replayed = store.recover()
        assert replayed == 5
        assert_bit_identical(index, back, rng.standard_normal(N_COLS).astype(np.float32))

    def test_checkpoint_rotates_wal(self, rng, tmp_path):
        index = port_index()
        store = DurableIndexStore(tmp_path, device="cpu")
        store.checkpoint(index)
        churn(index, rng, store)
        assert store.wal_records == 3
        store.checkpoint(index)
        assert store.wal_records == 0
        back, replayed = store.recover()
        assert replayed == 0
        assert_bit_identical(index, back, rng.standard_normal(N_COLS).astype(np.float32))

    def test_old_checkpoints_garbage_collected(self, tmp_path):
        index = port_index()
        store = DurableIndexStore(tmp_path, device="cpu")
        for _ in range(3):
            store.checkpoint(index)
        assert sorted(p.name for p in tmp_path.glob("ckpt-*")) == ["ckpt-00000002"]
        assert sorted(p.name for p in tmp_path.glob("wal-*.log")) == ["wal-00000002.log"]

    def test_torn_current_pointer_falls_back_to_scan(self, rng, tmp_path):
        index = port_index()
        DurableIndexStore(tmp_path, device="cpu").checkpoint(index)
        (tmp_path / "CURRENT").write_text("ckpt-garbage")
        store2 = DurableIndexStore(tmp_path, device="cpu")
        assert store2.has_checkpoint
        back, _ = store2.recover()
        assert_bit_identical(index, back, rng.standard_normal(N_COLS).astype(np.float32))

    def test_corrupt_arrays_rejected_by_crc(self, tmp_path):
        ckpt = DurableIndexStore(tmp_path, device="cpu").checkpoint(port_index())
        blob = bytearray((ckpt / "arrays.npz").read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        (ckpt / "arrays.npz").write_bytes(bytes(blob))
        with pytest.raises(ValueError, match="CRC"):
            DurableIndexStore(tmp_path, device="cpu").load_checkpoint()

    def test_log_before_checkpoint_refused(self, tmp_path):
        with pytest.raises(RuntimeError, match="no checkpoint"):
            DurableIndexStore(tmp_path, device="cpu").log_delete([1])

    @pytest.mark.parametrize("recall_target", [None, 0.95])
    def test_reference_store_recovers_in_the_port(self, tmp_path, recall_target):
        """A checkpoint (bf16 streams tagged "bfloat16") plus a WAL that the
        reference wrote: the port recovers the state the reference does."""
        j = reference_index(recall_target, "BF16")
        store = JStore(tmp_path)
        store.checkpoint(j)
        churn(j, np.random.default_rng(24), store, compact=True)
        jback, jreplayed = JStore(tmp_path).recover()
        tback, treplayed = DurableIndexStore(tmp_path, device="cpu").recover()
        assert treplayed == jreplayed == 5
        jm, ja = jback.export_state()
        tm, ta = tback.export_state()
        assert_same_meta(jm, tm)
        assert_same_arrays(ja, ta)
        x = np.random.default_rng(25).standard_normal(N_COLS).astype(np.float32)
        assert_close_rows(reference_answer(jback, x), answer(tback, x, use_kernel=True))


# ---------------------------------------------------------------------------
# Faults
# ---------------------------------------------------------------------------

class TestEveryInjectionPointFires:
    def test_points_are_the_references(self):
        assert INJECTION_POINTS == jfaults.INJECTION_POINTS
        assert set(PORTED_POINTS) < set(INJECTION_POINTS)
        with pytest.raises(ValueError, match="unregistered"):
            with FaultPlan({}):
                fault_point("no.such.point")

    @pytest.mark.parametrize("point", PORTED_POINTS)
    def test_point_fires(self, point, tmp_path):
        rng = np.random.default_rng(11)
        index = port_index()
        store = DurableIndexStore(tmp_path, device="cpu")
        store.checkpoint(index)
        with pytest.raises(FaultInjected) as e:
            with FaultPlan({point: 0}):
                if point in ("refresh.cow_rewrite", "refresh.swap"):
                    index.add_rows(random_rows(rng, 3))
                elif point == "compact.swap":
                    index.delete_rows([0, 1])
                    index.compact()
                elif point == "wal.append":
                    store.log_add(random_rows(rng, 2))
                else:
                    store.checkpoint(index)
        assert e.value.point == point


class TestSnapshotNeverTorn:
    @pytest.mark.parametrize("point", ["refresh.cow_rewrite", "refresh.swap", "compact.swap"])
    @pytest.mark.parametrize("recall_target", [None, 0.95])
    def test_kill_then_retry_converges(self, point, recall_target, rng):
        """The pre-fault snapshot answers bit for bit; the retry converges
        to a never-faulted control, whose answers equal the reference's
        after the same sequence."""
        index, control = port_index(recall_target), port_index(recall_target)
        ref = reference_index(recall_target)
        x = rng.standard_normal(N_COLS).astype(np.float32)
        batch = random_rows(rng, 4)
        for i in (index, control, ref):
            i.delete_rows([3, 4])
        baseline, snapshot = answer(index, x), index.packed
        with FaultPlan({point: 0}):
            with pytest.raises(FaultInjected):
                if point == "compact.swap":
                    index.compact()
                else:
                    index.add_rows(batch)
        assert index.packed is snapshot
        for got, want in zip(answer(index, x), baseline):
            np.testing.assert_array_equal(got, want)
        if point == "compact.swap":
            index.compact()
            control.compact()
            ref.compact()
        else:
            index.refresh()
            control.add_rows(batch)
            ref.add_rows(batch)
        assert_same_snapshot(control, index)
        assert_bit_identical(control, index, x, use_kernel=True)
        assert_close_rows(reference_answer(ref, x), answer(index, x))

    def test_interrupted_refresh_sweep_deterministic(self):
        """Kill at every observed hit of every refresh point: no leaked
        lease, the old snapshot serves, the retry converges."""
        x = np.random.default_rng(3).standard_normal(N_COLS).astype(np.float32)
        probe = port_index()
        with FaultPlan({}) as plan:
            probe.add_rows(random_rows(np.random.default_rng(4), 4))
        hits = {p: plan.hits.get(p, 0) for p in ("refresh.cow_rewrite", "refresh.swap")}
        assert all(h > 0 for h in hits.values())
        for point, n in hits.items():
            for hit in range(n):
                index = port_index()
                baseline = answer(index, x)
                buffers0 = index.snapshot_buffers
                batch = random_rows(np.random.default_rng(4), 4)
                with FaultPlan({point: hit}):
                    with pytest.raises(FaultInjected):
                        index.add_rows(batch)
                for got, want in zip(answer(index, x), baseline):
                    np.testing.assert_array_equal(got, want)
                index.refresh()
                control = port_index()
                control.add_rows(batch)
                assert_bit_identical(control, index, x)
                assert index.snapshot_buffers <= buffers0 + 2


class TestDurableStateRecoversFromEveryKill:
    @pytest.mark.parametrize("point", ["wal.append", "checkpoint.write", "checkpoint.rename"])
    def test_kill_then_recover(self, point, rng, tmp_path):
        index = port_index()
        store = DurableIndexStore(tmp_path, device="cpu")
        store.checkpoint(index)
        b1 = random_rows(rng, 3)
        store.log_add(b1)
        index.add_rows(b1)
        x = rng.standard_normal(N_COLS).astype(np.float32)
        truth = answer(index, x)                 # checkpoint + 1 WAL record
        b2 = random_rows(rng, 2)
        with FaultPlan({point: 0}):
            with pytest.raises(FaultInjected):
                if point == "wal.append":
                    store.log_add(b2)
                else:
                    store.checkpoint(index)
        store2 = DurableIndexStore(tmp_path, device="cpu")
        back, replayed = store2.recover()
        assert replayed == 1
        for got, want in zip(answer(back, x), truth):
            np.testing.assert_array_equal(got, want)
        store2.log_add(b2)
        back.add_rows(b2)
        back2, _ = DurableIndexStore(tmp_path, device="cpu").recover()
        assert_bit_identical(back, back2, x)

    def test_service_checkpoint_crash_then_recover(self, rng, tmp_path):
        """The compaction's checkpoint dies mid-write; the service restarts
        from disk bit for bit, and the reference's service after the same
        sequence answers alike."""
        emb = rng.standard_normal((200, N_COLS)).astype(np.float32)
        adds = [rng.standard_normal((4, N_COLS)).astype(np.float32) for _ in range(2)]
        q = rng.standard_normal((2, N_COLS)).astype(np.float32)
        kw = dict(big_k=8, k=32, num_partitions=4, block_size=32)
        svc = StreamingSimilarityService(
            SparseEmbeddingIndex.from_dense(
                emb, nnz_per_row=12, config=ttopk.TopKSpMVConfig(device="cpu", **kw)),
            policy=CompactionPolicy(max_wal_records=2),
            store=DurableIndexStore(tmp_path / "port", device="cpu"))
        ref = JService(JIndex.from_dense(emb, nnz_per_row=12, config=jtopk.TopKSpMVConfig(**kw)),
                       policy=JPolicy(max_wal_records=2), store=JStore(tmp_path / "ref"))
        for s in (svc, ref):
            s.ingest(adds[0])
        with FaultPlan({"checkpoint.write": 0}):
            with pytest.raises(FaultInjected):
                svc.ingest(adds[1])
        with jfaults.FaultPlan({"checkpoint.write": 0}):
            with pytest.raises(jfaults.FaultInjected):
                ref.ingest(adds[1])
        expect = svc.search(q)
        svc2 = StreamingSimilarityService.recover(
            DurableIndexStore(tmp_path / "port", device="cpu"),
            policy=CompactionPolicy(max_wal_records=2))
        got = svc2.search(q)
        np.testing.assert_array_equal(got[0], expect[0])
        np.testing.assert_array_equal(got[1], expect[1])
        assert svc2.replayed_records == 3
        want = ref.search(q)
        for i in range(len(q)):
            assert_close_rows((want[0][i], want[1][i]), (got[0][i], got[1][i]))


class TestFaultPlanMechanics:
    def test_unknown_point_rejected(self):
        with pytest.raises(ValueError, match="unknown fault point"):
            FaultPlan({"no.such.point": 0})

    def test_no_plan_is_noop(self, rng):
        port_index().add_rows(random_rows(rng, 2))

    def test_nested_plans_rejected(self):
        with FaultPlan({}):
            with pytest.raises(RuntimeError, match="already armed"):
                with FaultPlan({}):
                    pass

    def test_hit_counting(self, rng):
        index = port_index()
        with FaultPlan({"refresh.swap": 1}) as plan:
            index.add_rows(random_rows(rng, 2))
            with pytest.raises(FaultInjected):
                index.add_rows(random_rows(rng, 2))
        assert plan.fired == [("refresh.swap", 1)]
        index.refresh()


# ---------------------------------------------------------------------------
# Frontend: scheduler policy over both packages' classes
# ---------------------------------------------------------------------------

PACKAGES = {"reference": jfrontend, "port": tfrontend}


@pytest.fixture(params=sorted(PACKAGES))
def fe_pkg(request):
    return PACKAGES[request.param]


class RecordingDispatch:
    """Fake backend: records each pass's tags, optional gate and delay."""

    def __init__(self, delay_s=0.0, gate: threading.Event = None):
        self.batches = []
        self.delay_s = delay_s
        self.gate = gate

    def __call__(self, xs, enqueue_ts):
        if self.gate is not None:
            assert self.gate.wait(timeout=30)
        if self.delay_s:
            time.sleep(self.delay_s)
        self.batches.append(np.asarray(xs[:, 0]).astype(int).tolist())
        z = np.zeros(4, np.float32)
        return [(z, z) for _ in range(xs.shape[0])]


def tagged(code):
    x = np.zeros(N_COLS, np.float32)
    x[0] = code
    return x


class TestSchedulerPolicy:
    def test_target_batch_coalesces_one_pass(self, fe_pkg):
        d = RecordingDispatch()
        fe = fe_pkg.RequestFrontend(d, fe_pkg.FrontendConfig(
            flush_deadline_s=30.0, max_batch=16, adaptive=False, target_batch=8))
        try:
            for f in [fe.submit(tagged(i)) for i in range(8)]:
                f.result(timeout=30)
            assert [len(b) for b in d.batches] == [8]
            assert fe.flush_reasons["target"] == 1
            assert fe.batch_histogram == {8: 1}
        finally:
            fe.close()

    def test_idle_degrades_to_q1(self, fe_pkg):
        d = RecordingDispatch()
        fe = fe_pkg.RequestFrontend(d, fe_pkg.FrontendConfig(
            flush_deadline_s=30.0, max_batch=16, adaptive=False, target_batch=1))
        try:
            for i in range(3):
                fe.submit(tagged(i)).result(timeout=30)
            assert [len(b) for b in d.batches] == [1, 1, 1]
        finally:
            fe.close()

    def test_deadline_flush_bounds_wait(self, fe_pkg):
        d = RecordingDispatch()
        fe = fe_pkg.RequestFrontend(d, fe_pkg.FrontendConfig(
            flush_deadline_s=0.05, max_batch=64, adaptive=False, target_batch=64))
        try:
            t0 = time.monotonic()
            for f in [fe.submit(tagged(i)) for i in range(3)]:
                f.result(timeout=30)
            assert [len(b) for b in d.batches] == [3]
            assert fe.flush_reasons["deadline"] == 1
            assert time.monotonic() - t0 >= 0.04
        finally:
            fe.close()

    def test_burst_larger_than_capacity_splits(self, fe_pkg):
        gate = threading.Event()
        d = RecordingDispatch(gate=gate)
        fe = fe_pkg.RequestFrontend(d, fe_pkg.FrontendConfig(
            flush_deadline_s=0.05, max_batch=4, adaptive=False, target_batch=100))
        try:
            futs = [fe.submit(tagged(i)) for i in range(10)]
            gate.set()
            for f in futs:
                f.result(timeout=30)
            sizes = [len(b) for b in d.batches]
            assert sum(sizes) == 10 and max(sizes) <= 4
            assert fe.flush_reasons["capacity"] >= 2
            assert sorted(s for b in d.batches for s in b) == list(range(10))
        finally:
            fe.close()

    def test_replica_factor_multiplies_capacity(self, fe_pkg):
        gate = threading.Event()
        d = RecordingDispatch(gate=gate)
        fe = fe_pkg.RequestFrontend(d, fe_pkg.FrontendConfig(
            flush_deadline_s=0.05, max_batch=4, adaptive=False, target_batch=100),
            replica_factor=2)
        try:
            assert fe.capacity == 8
            futs = [fe.submit(tagged(i)) for i in range(8)]
            gate.set()
            for f in futs:
                f.result(timeout=30)
            assert [len(b) for b in d.batches] == [8]
        finally:
            fe.close()

    def test_tenant_fairness_starvation_bound(self, fe_pkg):
        gate = threading.Event()
        d = RecordingDispatch(gate=gate)
        fe = fe_pkg.RequestFrontend(d, fe_pkg.FrontendConfig(
            flush_deadline_s=30.0, max_batch=4, adaptive=False, target_batch=1))
        try:
            first = fe.submit(tagged(100), tenant="a")
            time.sleep(0.05)
            flood = [fe.submit(tagged(i), tenant="a") for i in range(5)]
            other = fe.submit(tagged(999), tenant="b")
            gate.set()
            for f in [other, first] + flood:
                f.result(timeout=30)
            assert d.batches[0] == [100]
            assert 999 in d.batches[1]
        finally:
            fe.close()

    def test_shutdown_drains_queue(self, fe_pkg):
        gate = threading.Event()
        d = RecordingDispatch(gate=gate)
        fe = fe_pkg.RequestFrontend(d, fe_pkg.FrontendConfig(
            flush_deadline_s=30.0, max_batch=8, adaptive=False, target_batch=100))
        futs = [fe.submit(tagged(i)) for i in range(6)]
        gate.set()
        fe.close(drain=True)
        assert all(f.done() and not f.cancelled() for f in futs)
        assert fe.queue_depth == 0
        assert fe.flush_reasons["drain"] >= 1
        with pytest.raises(RuntimeError, match="closed"):
            fe.submit(tagged(0))

    def test_close_without_drain_cancels(self, fe_pkg):
        gate = threading.Event()
        d = RecordingDispatch(gate=gate)
        fe = fe_pkg.RequestFrontend(d, fe_pkg.FrontendConfig(
            flush_deadline_s=30.0, max_batch=8, adaptive=False, target_batch=100))
        futs = [fe.submit(tagged(i)) for i in range(3)]
        fe.close(drain=False)
        gate.set()
        for f in futs:
            with pytest.raises(CancelledError):
                f.result(timeout=5)

    def test_queue_full_sheds_at_the_door(self, fe_pkg):
        gate = threading.Event()
        d = RecordingDispatch(gate=gate)
        fe = fe_pkg.RequestFrontend(d, fe_pkg.FrontendConfig(
            flush_deadline_s=30.0, max_batch=8, max_queue=2, adaptive=False,
            target_batch=100))
        try:
            fe.submit(tagged(0))
            fe.submit(tagged(1))
            with pytest.raises(fe_pkg.QueueFullError, match="max_queue"):
                fe.submit(tagged(2))
            assert fe.rejected == 1
        finally:
            gate.set()
            fe.close()

    def test_empty_queue_timer_wakeup(self, fe_pkg):
        d = RecordingDispatch()
        fe = fe_pkg.RequestFrontend(d, fe_pkg.FrontendConfig(
            flush_deadline_s=0.01, max_batch=8, adaptive=False, target_batch=4))
        try:
            fe.submit(tagged(0)).result(timeout=30)
            idle_start = fe.flushes
            time.sleep(0.2)
            assert fe.flushes == idle_start
            t0 = time.monotonic()
            fe.submit(tagged(1)).result(timeout=30)
            assert time.monotonic() - t0 < 5.0
            assert fe.flushes == idle_start + 1
        finally:
            fe.close()

    def test_dispatch_error_fails_the_pass(self, fe_pkg):
        def boom(xs, enqueue_ts):
            raise RuntimeError("backend down")

        fe = fe_pkg.RequestFrontend(boom, fe_pkg.FrontendConfig(
            flush_deadline_s=30.0, max_batch=8, adaptive=False, target_batch=2))
        try:
            for f in [fe.submit(tagged(i)) for i in range(2)]:
                with pytest.raises(RuntimeError, match="backend down"):
                    f.result(timeout=30)
        finally:
            fe.close()


class TestIntensityModel:
    def test_target_tracks_arrival_rate(self, fe_pkg):
        m = fe_pkg.IntensityModel(service_time_seed={1: 0.01, 2: 0.012, 4: 0.015})
        t = 0.0
        for _ in range(50):                 # λ = 300/s
            m.observe_arrival(t)
            t += 1.0 / 300.0
        assert abs(m.arrival_rate - 300.0) < 1.0
        assert m.target_q(capacity=64) == 8
        assert m.target_q(capacity=4) == 4

    def test_idle_rate_targets_q1(self, fe_pkg):
        m = fe_pkg.IntensityModel(service_time_seed={1: 0.01})
        t = 0.0
        for _ in range(5):
            m.observe_arrival(t)
            t += 0.1
        assert m.target_q(capacity=64) == 1

    def test_no_observations_targets_q1(self, fe_pkg):
        assert fe_pkg.IntensityModel().target_q(capacity=64) == 1

    def test_service_time_learned_online(self, fe_pkg):
        m = fe_pkg.IntensityModel()
        m.observe_service(3, 0.02)
        assert m.service_time(4) == pytest.approx(0.02)
        m.observe_service(4, 0.04)
        assert 0.02 < m.service_time(4) < 0.04

    def test_both_models_take_equal_decisions(self):
        """One seeded trace of arrivals and passes: equal λ, s(B), target_q
        at every capacity and equal buckets, step by step."""
        rng = np.random.default_rng(12)
        models = [pkg.IntensityModel(alpha=0.3) for pkg in (jfrontend, tfrontend)]
        t = 0.0
        for step in range(200):
            t += float(rng.exponential(1 / 2000.0))
            for m in models:
                m.observe_arrival(t)
            if step % 7 == 0:
                q, s = int(rng.integers(1, 65)), float(rng.uniform(1e-3, 5e-2))
                for m in models:
                    m.observe_service(q, s)
            a, b = models
            assert a.snapshot() == b.snapshot()
            for cap in (1, 3, 8, 64, 128):
                assert a.target_q(cap) == b.target_q(cap)
        for q in range(1, 130):
            assert jfrontend.q_bucket(q) == tfrontend.q_bucket(q)


# ---------------------------------------------------------------------------
# The port's service on the CPU
# ---------------------------------------------------------------------------

def make_service(frontend=None, guardrails=None, n_rows=200, seed=0, big_k=13,
                 use_kernel=True):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n_rows, N_COLS)).astype(np.float32)
    cfg = ttopk.TopKSpMVConfig(big_k=big_k, k=8, num_partitions=2, block_size=32,
                               device="cpu")
    index = SparseEmbeddingIndex.from_dense(dense, nnz_per_row=8, config=cfg)
    return StreamingSimilarityService(index, guardrails=guardrails, frontend=frontend,
                                      use_kernel=use_kernel)


class TestServiceIntegration:
    def test_submit_futures_answer_like_query(self):
        svc = make_service(frontend=FrontendConfig(flush_deadline_s=0.02, max_batch=8))
        try:
            xs = np.random.default_rng(3).standard_normal((6, N_COLS)).astype(np.float32)
            got = [f.result(timeout=60) for f in [svc.submit(x) for x in xs]]
            want_v, want_r = svc.index.query_batch(xs)
            for i, (v, r) in enumerate(got):
                np.testing.assert_array_equal(r, want_r[i])
                np.testing.assert_allclose(v, want_v[i], rtol=TOL)
            info = svc.dispatch_info()["frontend"]
            assert info["completed"] == 6
            assert sum(q * n for q, n in info["batch_histogram"].items()) == 6
        finally:
            svc.close()

    def test_submit_requires_frontend(self):
        with pytest.raises(ValueError, match="no frontend"):
            make_service().submit(np.zeros(N_COLS, np.float32))

    def test_submit_validates_in_caller_thread(self):
        svc = make_service(frontend=FrontendConfig(flush_deadline_s=0.02))
        try:
            bad = np.zeros(N_COLS, np.float32)
            bad[0] = np.nan
            with pytest.raises(ValueError, match="non-finite"):
                svc.submit(bad)
            with pytest.raises(ValueError, match="1-D"):
                svc.submit(np.zeros((2, N_COLS), np.float32))
        finally:
            svc.close()

    def test_deadline_shorter_than_service_time(self):
        """Every pass outlives the budget; the service stays up.  It runs the
        plain path (about 1 ms a pass here, as the reference's default): on
        the CPU the kernel's plain version takes over 0.1 s a pass, longer
        than the 0.02 s budget the recovered pass must meet."""
        svc = make_service(frontend=FrontendConfig(flush_deadline_s=0.005, max_batch=8),
                           guardrails=ServiceGuardrails(deadline_s=0.02), use_kernel=False)
        try:
            orig = svc.index.query_batch

            def slow(xs, use_kernel=None):
                out = orig(xs, use_kernel=use_kernel)
                time.sleep(0.05)
                return out

            svc.index.query_batch = slow
            with pytest.raises(DeadlineExceeded):
                svc.submit(np.ones(N_COLS, np.float32)).result(timeout=60)
            assert svc.dispatch_info()["service"]["deadline_exceeded"] >= 1
            svc.index.query_batch = orig
            assert svc.submit(np.ones(N_COLS, np.float32)).result(timeout=60)[0].shape == (13,)
        finally:
            svc.close()

    def test_guardrail_deadline_measured_from_enqueue(self):
        svc = make_service(
            frontend=FrontendConfig(flush_deadline_s=0.2, max_batch=8, adaptive=False,
                                    target_batch=100),
            guardrails=ServiceGuardrails(deadline_s=0.05))
        try:
            with pytest.raises(DeadlineExceeded, match="deadline"):
                svc.submit(np.ones(N_COLS, np.float32)).result(timeout=60)
            assert svc.dispatch_info()["service"]["deadline_exceeded"] == 1
        finally:
            svc.close()

    def test_drifting_batch_sizes_stay_retrace_free(self):
        """Pass sizes drifting across flushes reuse the functions of two
        warmed Q buckets: no build and no retrace, every pass a bucket hit,
        and the kernel sees each pass unpadded."""
        svc = make_service(frontend=FrontendConfig(
            flush_deadline_s=30.0, max_batch=16, adaptive=False, target_batch=100),
            big_k=11)
        try:
            rng = np.random.default_rng(5)
            start = svc.dispatch_info()

            def burst(n):
                futs = [svc.submit(rng.standard_normal(N_COLS).astype(np.float32))
                        for _ in range(n)]
                svc.flush()
                return [f.result(timeout=60) for f in futs]

            burst(3)
            burst(7)
            warm = svc.dispatch_info()
            for n in (4, 3, 5, 6, 8, 7):
                burst(n)
            info = svc.dispatch_info()
            assert info["retraces"] == warm["retraces"] == start["retraces"]
            assert info["fn_builds"] == warm["fn_builds"]
            hits = (info["q_bucket_hits"] + info["q_exact_hits"]
                    - warm["q_bucket_hits"] - warm["q_exact_hits"])
            assert hits == 6
            assert info["q_bucket_hits"] > warm["q_bucket_hits"]
            assert info["frontend"]["batch_histogram"] == {3: 2, 4: 1, 5: 1, 6: 1, 7: 2,
                                                           8: 1}
        finally:
            svc.close()

    def test_single_query_and_batch_share_dispatch_counters(self):
        svc = make_service(seed=7)
        x = np.ones(N_COLS, np.float32)
        before = svc.index.dispatch_info()
        svc.index.query(x, use_kernel=True)
        mid = svc.index.dispatch_info()
        assert mid["dispatches"] == before["dispatches"] + 1
        svc.index.query_batch(x[None], use_kernel=True)
        after = svc.index.dispatch_info()
        assert after["fn_builds"] == mid["fn_builds"]
        assert after["q_exact_hits"] == mid["q_exact_hits"] + 1

    def test_serve_while_ingest_through_frontend(self):
        svc = make_service(frontend=FrontendConfig(flush_deadline_s=0.01, max_batch=8))
        try:
            rng = np.random.default_rng(9)
            q = rng.standard_normal(N_COLS).astype(np.float32)
            svc.submit(q).result(timeout=60)
            svc.ingest(q[None])
            svc.submit(q).result(timeout=60)
            base = svc.dispatch_info()
            for _ in range(3):
                svc.ingest(rng.standard_normal((1, N_COLS)).astype(np.float32))
                svc.submit(q).result(timeout=60)
            v, r = svc.submit(q).result(timeout=60)
            assert svc.dispatch_info()["retraces"] == base["retraces"]
            assert svc.stats().n_rows == 204
            want_v, want_r = svc.index.query_batch(q[None])
            np.testing.assert_array_equal(r, want_r[0])
            np.testing.assert_allclose(v, want_v[0], rtol=TOL)
        finally:
            svc.close()

    def test_kernel_path_is_the_default(self):
        """``search`` builds the kernel path's function (which
        ``query_batch(use_kernel=True)`` then reuses) unless asked for the
        plain path, which builds its own; on the CPU both agree within
        tolerance."""
        svc = make_service(seed=8, big_k=7)
        xs = np.random.default_rng(8).standard_normal((3, N_COLS)).astype(np.float32)
        ex = ttopk.query_executor(svc.index.config)
        builds = ex.cache_info()["fn_builds"]
        got = svc.search(xs)
        assert ex.cache_info()["fn_builds"] == builds + 1
        want = svc.index.query_batch(xs, use_kernel=True)
        assert ex.cache_info()["fn_builds"] == builds + 1
        np.testing.assert_array_equal(got[1], want[1])
        plain = StreamingSimilarityService(svc.index, use_kernel=False).search(xs)
        assert ex.cache_info()["fn_builds"] == builds + 2
        np.testing.assert_array_equal(plain[1], svc.search(xs, use_kernel=False)[1])
        for i in range(3):
            assert_close_rows((plain[0][i], plain[1][i]), (got[0][i], got[1][i]))


class TestConcurrentDispatch:
    def test_threads_share_one_executor_without_lost_updates(self):
        """Eight threads query one index at drifting Q under a short switch
        interval: every dispatch is counted, and each answer equals the
        serial one.  The plain path keeps it short; both paths share the
        executor's caches and counters."""
        svc = make_service(seed=10, big_k=9)
        rng = np.random.default_rng(10)
        xs = rng.standard_normal((16, N_COLS)).astype(np.float32)
        want = {q: svc.index.query_batch(xs[:q], use_kernel=False) for q in range(1, 9)}
        ex = ttopk.query_executor(svc.index.config)
        before = ex.cache_info()["dispatches"]
        errors, per_thread = [], 25

        def work(seed):
            r = np.random.default_rng(seed)
            try:
                for _ in range(per_thread):
                    q = int(r.integers(1, 9))
                    v, rows = svc.index.query_batch(xs[:q], use_kernel=False)
                    np.testing.assert_array_equal(rows, want[q][1])
                    np.testing.assert_array_equal(v, want[q][0])
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work, args=(s,)) for s in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[0]
        assert ex.cache_info()["dispatches"] - before == 8 * per_thread

    def test_threads_pin_a_fresh_snapshot_once(self, monkeypatch):
        """Eight threads released together on each new snapshot, whose pin
        is slowed to 20 ms: it is pinned once, so h2d_copies rises by one
        pin's uploads."""
        from repro_torch.kernels import executor as executor_lib

        pin_init = executor_lib.DeviceSnapshot.__init__

        def slow_pin(self, *args, **kwargs):
            time.sleep(0.02)
            pin_init(self, *args, **kwargs)

        monkeypatch.setattr(executor_lib.DeviceSnapshot, "__init__", slow_pin)
        svc = make_service(seed=11, big_k=10)
        rng = np.random.default_rng(11)
        xs = rng.standard_normal((4, N_COLS)).astype(np.float32)
        ex = ttopk.query_executor(svc.index.config)
        errors = []
        for _ in range(4):
            svc.ingest(rng.standard_normal((2, N_COLS)).astype(np.float32))
            before = ex.cache_info()["h2d_copies"]
            gate = threading.Barrier(8)

            def work():
                try:
                    gate.wait(timeout=60)
                    svc.search(xs, use_kernel=False)
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(e)

            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            assert not errors, errors[0]
            pin = executor_lib.device_snapshot(svc.index.index.packed, "split", ex.device)
            assert ex.cache_info()["h2d_copies"] - before == pin.uploads
