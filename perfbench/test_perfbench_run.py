"""Whole runs on the CPU at a tiny size: sound runs come out correct; a run
with its timed path broken, and the control, come out not correct.

Each run skips the harness's look for a card and drives the rest: set-up,
the window, the reference's judgement.  The tiny cells keep every cell's
config and mix and cut only the sizes.
"""
import json
import shutil
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import control, harness, run, tracing

BENCH = Path(__file__).resolve().parent
BATCH, SERVE = "emb10m-bf16.batch64", "emb10m-bf16.serve-open"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the benchmark with every config cut to 3,000 x 64 rows."""
    root = tmp_path_factory.mktemp("tiny")
    pb = root / "perfbench"
    for d in ("metrics", "traffic", "loops", "configs", "workloads"):
        shutil.copytree(BENCH / d, pb / d)
    for p in (pb / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg.update(n_rows=3_000, n_cols=64, mean_nnz_per_row=8.0, num_partitions=8,
                   block_size=32, big_k=16, k=8)
        p.write_text(json.dumps(cfg))
    for p in (pb / "workloads").glob("*.json"):
        spec = json.loads(p.read_text())
        spec["params"].update({k: v for k, v in (("batch", 16), ("rate_per_s", 150))
                               if k in spec["params"]})
        p.write_text(json.dumps(spec))
    for p in (pb / "traffic").glob("*.json"):
        mix = json.loads(p.read_text())
        mix["pool"] = 128
        if "max_q" in mix:
            mix["max_q"] = 16
        p.write_text(json.dumps(mix))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    return pb


def cell_run(tiny, cell, seed=2**31 + 99, trace=False, override=None):
    return run.run_cell(cell, seed, 1.0, trace, "cpu", tiny, program_override=override)


@pytest.mark.parametrize("cell", [BATCH, SERVE])
def test_sound_run_is_correct(tiny, cell):
    done = cell_run(tiny, cell)
    res = run.jsonable(done["result"])
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) >= {"setup_s", "recall_at_8"}
    assert res["metrics"]["recall_at_8"]["value"] > 0.5
    json.dumps(res)


def test_traced_run_reports_per_layer_metrics(tiny):
    res = run.jsonable(cell_run(tiny, BATCH, trace=True)["result"])
    assert res["correct"]
    assert "stream_bytes_per_nnz.batch" in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def alter_answer(v, r):
    """The first answer of each pass gets another row's id at rank 3."""
    r = r.clone()
    r[0, 3] = (r[0, 3] + 1) % 3_000
    return v, r


def half_batch(v, r):
    """The pass computes half its queries; the other half repeats them."""
    h = (v.shape[0] + 1) // 2
    v, r = v.clone(), r.clone()
    v[h:], r[h:] = v[:v.shape[0] - h], r[:r.shape[0] - h]
    return v, r


@pytest.mark.parametrize("fault", [alter_answer, half_batch], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", [BATCH, SERVE])
def test_a_broken_timed_path_is_not_correct(tiny, cell, fault, monkeypatch):
    from repro_torch.core import topk_spmv

    sound = topk_spmv.topk_spmv_batched

    def broken(index, xs, use_kernel=True):
        v, r = sound(index, xs, use_kernel=use_kernel)
        return fault(v, r) if xs.shape[0] > 1 else (v, r)

    monkeypatch.setattr(topk_spmv, "topk_spmv_batched", broken)
    res = run.jsonable(cell_run(tiny, cell)["result"])
    assert not res["correct"]
    assert res["checks"]["score_gap"]["value"] in ("inf",) or \
        res["checks"]["score_gap"]["value"] > res["checks"]["score_gap"]["limit"]


@pytest.mark.parametrize("cell", [BATCH, SERVE])
def test_the_control_is_told_apart(tiny, cell):
    cfg = json.loads((tiny / "configs" / f"{cell.split('.')[0]}.json").read_text())
    res = run.jsonable(cell_run(tiny, cell, override=control.control_settings(cfg))["result"])
    assert not res["correct"]
    gap = res["checks"]["score_gap"]
    assert gap["value"] > 3 * gap["limit"]


def test_control_settings_are_the_programs_lower_precision():
    cfg = json.loads((BENCH / "configs" / "emb10m-bf16.json").read_text())
    assert cfg["value_format"] == "BF16"
    assert control.control_settings(cfg) == {"value_format": "Q7", "recall_target": None}


PAIRS_LOOP = '''"""A loop added by files alone: pairs of queries back to back."""
import time

import numpy as np


def start(index, pool, params, seed):
    index.query_batch(pool[:2])
    return index


def run(index, pool, params, seconds, rng, spans):
    qidx, vals, rows = [], [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        sel = rng.choice(pool.shape[0], size=2, replace=False)
        with spans.span("dispatch"):
            v, r = index.query_batch(pool[sel])
        qidx.append(sel)
        vals.append(v)
        rows.append(r)
    return {"qidx": np.concatenate(qidx), "vals": np.concatenate(vals),
            "rows": np.concatenate(rows), "attempted": 2 * len(qidx), "failed": 0,
            "passes": [2] * len(qidx), "end_to_end": {}, "info": {"pairs": len(qidx)},
            "ctx": {}}


def stop(index):
    pass
'''


def test_a_new_mix_and_its_loop_are_found_and_run(tiny, tmp_path):
    """A mix file, its loop module, a cell file and a BENCHMARK.json entry
    are enough: no file of the harness changes."""
    root = tmp_path / "copy"
    shutil.copytree(tiny.parent, root)
    pb = root / "perfbench"
    (pb / "loops" / "batch_pairs.py").write_text(PAIRS_LOOP)
    (pb / "traffic" / "batch_pairs.json").write_text(json.dumps(
        {"loop": "batch_pairs", "pool": 128}))
    (pb / "workloads" / "emb10m-bf16.pairs.json").write_text(json.dumps(
        {"config": "emb10m-bf16", "traffic": "batch_pairs", "params": {}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "emb10m-bf16.pairs", "config": "emb10m-bf16",
                               "traffic": "batch_pairs", "chips": 1, "why": "pairs"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert "batch_pairs" in harness.list_loops(pb)
    assert "emb10m-bf16.pairs" in harness.list_cells(pb)
    done = run.run_cell("emb10m-bf16.pairs", 7, 0.5, False, "cpu", pb)
    res = run.jsonable(done["result"])
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s", "recall_at_8"}
    assert done["info"]["pairs"] * 2 == res["attempted"] > 0


class FakeFrontend:
    """Answers each submit at once through ``dispatch``, as the frontend's
    thread would."""

    queue_depth = 0

    def __init__(self):
        self.passes = 0
        self.dispatch = self._dispatch

    def _dispatch(self, xs, enq):
        self.passes += 1
        return np.zeros((len(xs), 4), np.float32), np.zeros((len(xs), 4), np.int32)

    def info(self):
        return {"batch_histogram": {1: self.passes}, "flush_reasons": {}, "queue_depth": 0,
                "target_q": 1, "intensity": {}}


class FakeService:
    def __init__(self):
        self.frontend = FakeFrontend()

    def submit(self, x):
        v, r = self.frontend.dispatch(x[None], None)
        fut = Future()
        fut.set_result((v[0], r[0]))
        return fut


@pytest.mark.parametrize("traced", [False, True])
def test_dispatch_spans_only_in_the_traced_run(traced):
    loop = harness.load_loop("open_poisson")
    svc = FakeService()
    sound = svc.frontend.dispatch
    spans = tracing.Spans(profiled=traced)
    out = loop.run(svc, np.ones((8, 4), np.float32), {"rate_per_s": 200}, 0.2,
                   np.random.default_rng(3), spans)
    assert svc.frontend.dispatch == sound
    assert out["attempted"] > 0 and out["failed"] == 0
    assert spans.total("dispatch")[1] == (out["attempted"] if traced else 0)
    assert spans.total("generator")[1] == 1
    assert out["end_to_end"] == {"within_100ms_share": 100.0}
    assert out["ctx"]["latency_p95_ms"] == out["info"]["latency_ms"]["p95"] < 100.0
    assert harness.load_reader("latency_p95_ms.serve")(out["ctx"]) == out["ctx"]["latency_p95_ms"]


def test_jsonable_turns_infinities_into_strings():
    out = run.jsonable({"a": np.float32(np.inf), "b": [np.int64(3), 1.5], "c": np.bool_(True)})
    assert out == {"a": "inf", "b": [3, 1.5], "c": True}
    assert torch.tensor(1.0).item() == 1.0
