"""The harness finds its parts by name; the yardstick's figures; trace reading."""
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import harness, roofline, tracing

BENCH = Path(__file__).resolve().parent
BENCHMARK = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_roofline_of_the_papers_cell_at_q64():
    cfg = json.loads((BENCH / "configs" / "emb10m-bf16.json").read_text())
    w = roofline.pass_work(cfg, 200_016_790, 64)
    assert w.flops == 25_602_149_120
    assert w.compute_s * 1e3 == pytest.approx(0.3821, abs=5e-5)
    assert w.bound_by == "operations" and w.bound_s == w.compute_s
    assert w.bytes == 200_016_790 * 4 + 1_250_000 + 64 * 512 * 4 + 64 * 100 * 8
    assert w.memory_s * 1e3 == pytest.approx(0.2393, abs=5e-5)


@pytest.mark.parametrize("names,bad", [
    (["repro", "numpy"], ["repro"]),
    (["repro.core.bscsr"], ["repro"]),
    (["repro_torch", "repro_torch.core", "reprox"], []),
    (["jax.numpy", "jaxlib.xla_client", "flax"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "perfbench.run"], []),
])
def test_forbidden_modules_compare_top_level_names_whole(names, bad):
    assert harness.forbidden_modules(names) == bad


def test_a_new_cell_file_and_metric_reader_are_found(tmp_path):
    bench = tmp_path / "perfbench"
    for d in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(BENCH / d, bench / d)
    assert harness.list_cells(bench) == sorted(w["name"] for w in BENCHMARK["workloads"])
    (bench / "workloads" / "emb10m-bf16.batch8.json").write_text(json.dumps(
        {"config": "emb10m-bf16", "traffic": "batch_closed", "params": {"batch": 8}}))
    (bench / "metrics" / "passes.batch.py").write_text(
        "def read(ctx):\n    return len(ctx['passes']) or None\n")
    assert "emb10m-bf16.batch8" in harness.list_cells(bench)
    cell = harness.load_cell("emb10m-bf16.batch8", bench)
    assert cell["params"]["batch"] == 8 and cell["params"]["loop"] == "batch_closed"
    assert cell["config"]["n_rows"] == 10_000_000
    assert harness.load_reader("passes.batch", bench)({"passes": [8, 8]}) == 2
    bigger = dict(BENCHMARK, workloads=BENCHMARK["workloads"] + [
        {"name": "emb10m-bf16.batch8", "config": "emb10m-bf16", "traffic": "batch_closed8",
         "chips": 1, "why": "x"}])
    with pytest.raises(ValueError):
        harness.check_entry(bigger, cell)


def test_every_cell_file_agrees_with_benchmark_json():
    for w in BENCHMARK["workloads"]:
        cell = harness.load_cell(w["name"])
        harness.check_entry(BENCHMARK, cell)
        assert cell["params"]["loop"] in harness.list_loops()


@pytest.mark.parametrize("loop", harness.list_loops())
def test_every_loop_module_has_the_three_functions(loop):
    module = harness.load_loop(loop)
    assert all(callable(getattr(module, f, None)) for f in ("start", "run", "stop"))
    assert any(json.loads(p.read_text())["loop"] == loop
               for p in (BENCH / "traffic").glob("*.json"))


def test_benchmark_json_keeps_the_contract():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert NAME.match(c["name"]) and (BENCH.parent / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(json.loads((BENCH.parent / c["file"]).read_text())["reduced"]) == \
            set(c["reduced"])
    used = {w["config"] for w in b["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] in (1, 4)
        reported = {m["name"] for m in harness.cell_metrics(b, w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(b, w["name"], "per_layer")
    for m in b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e and NAME.match(m["name"])
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in harness.cell_metrics(b, cell, "end_to_end")}
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for m in b["end_to_end"] + b["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in (
            "lower", "higher")
    assert len(json.dumps(b)) < 64 * 1024


def test_union_gaps_and_summary():
    assert tracing.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert tracing.idle_gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 1), (4, 1)]
    device = [("k1", 1.0, 2.0), ("copy", 1.5, 2.5), ("k1", 4.0, 4.5), ("k2", 9.0, 12.0)]
    host = [("window", 0.0, 10.0), ("dispatch", 0.5, 3.0), ("aten::to", 2.5, 3.5)]
    s = tracing.summarize(device, host, 0.0, 10.0)
    assert s["busy_s"] == pytest.approx(3.0)
    assert s["device_ops"][0] == ["k1", 1.5]
    assert s["idle_gaps"][0] == ["window", pytest.approx(4.5)]
    assert ["aten::to", pytest.approx(1.5)] in s["idle_gaps"]
    assert ["window", pytest.approx(1.0)] in s["idle_gaps"]


def test_short_names_of_kernels():
    assert tracing.short_name("void (anonymous namespace)::topk_spmv_mq_split_kernel<8>("
                              "(anonymous namespace)::Params, int)") == \
        "anon::topk_spmv_mq_split_kernel"
    assert tracing.short_name("void at::native::radixSortKVInPlace<2, -1>(x)") == \
        "at::native::radixSortKVInPlace"
    assert tracing.short_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"


def test_spans_total_by_name():
    spans = tracing.Spans()
    for _ in range(3):
        with spans.span("dispatch"):
            pass
    with spans.span("window"):
        pass
    seconds, count = spans.total("dispatch")
    assert count == 3 and seconds >= 0
    assert spans.total("generator") == (0, 0)
