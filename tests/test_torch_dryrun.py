"""The port's dry run (``repro_torch.launch.dryrun``, ``op_costs``,
``analysis``) against the reference's, on the CPU.

- ``op_costs`` on the unit programs of ``tests/test_hlo_costs.py``, each
  held to ``hlo_costs.analyze`` of the same jitted program: one dot, a
  Python loop of 10 dots (the reference's scan: the port has no trip counts
  to read, its loop dispatches each dot), the nested 3 x 2 loop, the
  batched einsum; ``a + 1.0``'s bytes; the two refinements, dtype casts,
  the peak of live bytes; ``RooflineTerms`` at the H100's peaks.
- The kernel wrappers on ``meta``: outputs' shapes, no launch, one cost
  record each however many counters are active.
- ``model_flops_for`` and ``auto_microbatches`` against the reference's for
  all ten configs x four shapes x both production meshes.
- Per-cell FLOPs of the ten smoke configs x {train, prefill, decode} on an
  Auto-axis 4 x 2 mesh (the reference in a subprocess with 8 forced host
  devices): the port's total against the reference's per-device HLO FLOPs
  x 8, and against the dots of the reference's own jaxpr (its program
  before XLA).  Masters and moments bytes per position against the
  reference's ``argument_size_in_bytes`` minus its batch piece.
- ``run_topk_service_cell``, ``run_pipeline_cell`` and the CLI.
"""
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import hlo_costs
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.kernels import bscsr_topk_spmv as K
from repro_torch.kernels import costs as hook
from repro_torch.launch import analysis, dryrun, op_costs
from repro_torch.launch.mesh import DeviceMesh, make_production_mesh
from repro_torch.models.model_zoo import get_model

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
META = torch.device("meta")
KINDS = ("train", "prefill", "decode")


def _hlo(f, *args):
    return hlo_costs.analyze(jax.jit(f).lower(*args).compile().as_text())


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def meta_mesh(*shape, axes=("data", "model")):
    return DeviceMesh(np.full(shape, META, dtype=object), axes)


def smoke_cell(arch, kind, mesh):
    """``trace_cell`` of the smoke config's cell at B 8 x S 32 (train in 2
    microbatches), with the config's sharding overrides as ``run_cell``
    applies them."""
    cfg = smoke_config(arch)
    rules = dryrun.DEFAULT_RULES.replace(**dict(cfg.sharding_overrides))
    return dryrun.trace_cell(cfg, ShapeConfig("t", kind, 32, 8), mesh, rules,
                             microbatches=2 if kind == "train" else 1)


@pytest.fixture
def smoke_sizes(monkeypatch):
    """``run_cell`` and the CLI on smoke twins: the named config's smoke
    config, each named shape cut to B 8 x S 32 (a full-size cell takes
    minutes on meta)."""
    monkeypatch.setattr(dryrun, "get_config", smoke_config)
    for name, shape in list(dryrun.SHAPES.items()):
        monkeypatch.setitem(dryrun.SHAPES, name, ShapeConfig(name, shape.kind, 32, 8))


# ---------------------------------------------------------------------------
# op_costs on the reference's unit programs
# ---------------------------------------------------------------------------

class TestUnitPrograms:
    def test_single_dot_flops(self):
        want = _hlo(lambda a, b: a @ b, jax.ShapeDtypeStruct((128, 64), jnp.float32),
                    jax.ShapeDtypeStruct((64, 32), jnp.float32))["flops"]
        _, got = op_costs.count(lambda a, b: a @ b, meta(128, 64), meta(64, 32))
        assert got["flops"] == want == 2 * 128 * 64 * 32
        assert got["flops_f32"] == got["flops"]

    def test_loop_of_ten_dots_counts_each(self):
        """The reference multiplies a scan body by its trip count; the
        port's loop dispatches the dot 10 times."""
        def ref(x, ws):
            y, _ = jax.lax.scan(lambda c, w: (jnp.dot(c, w), None), x, ws)
            return y

        def port(x, ws):
            for w in ws:
                x = x @ w
            return x

        want = _hlo(ref, jax.ShapeDtypeStruct((64, 64), jnp.float32),
                    jax.ShapeDtypeStruct((10, 64, 64), jnp.float32))["flops"]
        _, got = op_costs.count(port, meta(64, 64), meta(10, 64, 64))
        assert got["flops"] == want == 10 * 2 * 64 ** 3

    def test_nested_loops(self):
        def ref(x, ws):
            def outer(c, wp):
                y, _ = jax.lax.scan(lambda c2, w: (jnp.dot(c2, w), None), c, wp)
                return y, None
            y, _ = jax.lax.scan(outer, x, ws.reshape(3, 2, 32, 32))
            return y

        def port(x, ws):
            for wp in ws.reshape(3, 2, 32, 32):
                for w in wp:
                    x = x @ w
            return x

        want = _hlo(ref, jax.ShapeDtypeStruct((32, 32), jnp.float32),
                    jax.ShapeDtypeStruct((6, 32, 32), jnp.float32))["flops"]
        _, got = op_costs.count(port, meta(32, 32), meta(6, 32, 32))
        assert got["flops"] == want == 6 * 2 * 32 ** 3

    def test_einsum_batched_dot(self):
        want = _hlo(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                    jax.ShapeDtypeStruct((4, 128, 64), jnp.float32),
                    jax.ShapeDtypeStruct((4, 64, 32), jnp.float32))["flops"]
        _, got = op_costs.count(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                                meta(4, 128, 64), meta(4, 64, 32))
        assert got["flops"] == want == 4 * 2 * 128 * 64 * 32

    def test_memory_counts_operands_and_results(self):
        ref = _hlo(lambda a: a + 1.0, jax.ShapeDtypeStruct((1024, 1024), jnp.float32))
        _, got = op_costs.count(lambda a: a + 1.0, meta(1024, 1024))
        assert 0.8e7 <= ref["hbm_bytes"] <= 1.3e7
        assert 0.8e7 <= got["hbm_bytes"] <= 1.3e7
        assert got["hbm_bytes"] == 2 * 4 * 1024 * 1024

    def test_flops_on_cpu_tensors_match_meta(self):
        a, b = torch.ones(8, 4, dtype=torch.bfloat16), torch.ones(4, 3, dtype=torch.bfloat16)
        _, cpu = op_costs.count(torch.matmul, a, b)
        _, on_meta = op_costs.count(torch.matmul, a.to(META), b.to(META))
        assert cpu["flops"] == on_meta["flops"] == 2 * 8 * 4 * 3
        assert cpu["flops_f32"] == 0 and cpu["hbm_bytes"] == on_meta["hbm_bytes"]

    def test_views_are_free_and_broadcasts_count_once(self):
        x = meta(64, 32)
        _, views = op_costs.count(
            lambda t: t.view(32, 64)[1:3].unsqueeze(0).expand(4, 2, 64).select(0, 1).t(), x)
        assert views["hbm_bytes"] == 0 and views["flops"] == 0 and views["ops"] > 0
        bias = meta(32)
        _, add = op_costs.count(lambda t, b: t + b.expand(64, 32), x, bias)
        assert add["hbm_bytes"] == (64 * 32 + 32 + 64 * 32) * 4

    def test_gather_and_update_refinements(self):
        """Gathers read about their result; an update into a larger buffer
        (the KV-cache insert) costs twice the update, not the buffer."""
        cache, kv = meta(8, 2, 128, 16), meta(8, 2, 16)
        _, ins = op_costs.count(lambda c, u: c[:, :, 5].copy_(u), cache, kv)
        assert ins["hbm_bytes"] == 2 * kv.numel() * 4
        table, idx = meta(1000, 64), torch.empty(32, dtype=torch.int64, device=META)
        _, gat = op_costs.count(torch.index_select, table, 0, idx)
        assert gat["hbm_bytes"] == 2 * 32 * 64 * 4
        buf = meta(4, 16, 8)
        _, put = op_costs.count(lambda b, i, j, v: b.index_put_((i, j), v, accumulate=True),
                                buf, idx[:10], idx[:10], meta(10, 8))
        assert put["hbm_bytes"] == 2 * (10 * 8 * 4 + 2 * 10 * 8)

    def test_log_sigmoid_workspace_counts_as_on_the_card(self):
        """``log_sigmoid_forward`` returns a workspace the size of its input
        on the CPU and ``meta`` and an empty one on the card; the counts
        follow the card: no bytes for it, out or back in."""
        aten = torch.ops.aten
        x = meta(1000)
        (out, buf), fwd = op_costs.count(aten.log_sigmoid_forward, x)
        assert buf.numel() == 1000 and fwd["hbm_bytes"] == 2 * 4000
        _, bwd = op_costs.count(aten.log_sigmoid_backward, meta(1000), x, buf)
        assert bwd["hbm_bytes"] == 3 * 4000

    def test_convert_bytes_and_peak_temp(self):
        x = meta(256, 256)

        def prog(t):
            a = t.to(torch.bfloat16)                   # 128 KiB live
            b = a * 2                                  # 256 KiB live
            del a
            c = b + 1                                  # b and c: 256 KiB
            return c

        _, got = op_costs.count(prog, x)
        n = 256 * 256
        assert got["convert_bytes"] == n * 4 + n * 2
        assert got["hbm_bytes"] == got["convert_bytes"] + 2 * (2 * n * 2)
        assert got["peak_temp_bytes"] == 2 * n * 2

    def test_work_marked_elsewhere_counts_in_all_positions_only(self):
        a, b = meta(64, 32), meta(32, 16)
        with op_costs.OpCounter() as c:
            here = a @ b                               # 4 KiB live
            with hook.elsewhere():
                there = a @ b                          # another 4 KiB, elsewhere
                hook.record_kernel("k", flops=10.0, hbm_bytes=20.0)
            with hook.elsewhere(False):
                also_here = a + 1                      # 8 KiB, here
        del here, there, also_here
        own, every = c.costs(), c.costs_all_positions()
        dot = 2.0 * 64 * 16 * 32
        assert own["flops"] == dot and every["flops"] == 2 * dot + 10.0
        assert own["kernels"] == {} and every["kernels"]["k"]["calls"] == 1
        assert every["hbm_bytes"] - own["hbm_bytes"] == (64 * 32 + 32 * 16 + 64 * 16) * 4 + 20.0
        assert own["peak_temp_bytes"] == 64 * 16 * 4 + 64 * 32 * 4
        assert every["peak_temp_bytes"] == 2 * 64 * 16 * 4 + 64 * 32 * 4
        assert own["ops"] == 2 and every["ops"] == 3

    def test_the_hook_is_per_thread(self):
        """A counter sees only its own thread: another thread's wrapper
        records nothing into it, and that thread's ``opaque`` region does
        not pause it."""
        entered, done, seen = threading.Event(), threading.Event(), []

        def other():
            with hook.opaque():
                entered.set()
                done.wait(10)
            seen.append(hook.counting())
            hook.record_kernel("theirs", flops=1.0, hbm_bytes=1.0)

        worker = threading.Thread(target=other)
        with op_costs.OpCounter() as c:
            worker.start()
            entered.wait(10)
            _ = meta(100) + 1
            hook.record_kernel("mine", flops=2.0, hbm_bytes=3.0)
            done.set()
            worker.join()
        got = c.costs()
        assert seen == [False]
        assert set(got["kernels"]) == {"mine"} and got["hbm_bytes"] == 800 + 3.0


class TestRooflineTerms:
    def test_bottlenecks_at_the_cards_peaks(self):
        t = analysis.RooflineTerms.build(flops=989e12, hbm_bytes=1e9, coll_bytes=0, chips=1)
        assert t.bottleneck == "compute" and t.compute_s == pytest.approx(1.0)
        t2 = analysis.RooflineTerms.build(flops=1e12, hbm_bytes=3.35e12, coll_bytes=0, chips=1)
        assert t2.bottleneck == "memory" and t2.memory_s == pytest.approx(1.0)
        t3 = analysis.RooflineTerms.build(flops=67e12, hbm_bytes=1e9, coll_bytes=0, chips=1,
                                          flops_f32=67e12)
        assert t3.bottleneck == "compute" and t3.compute_s == pytest.approx(1.0)
        t4 = analysis.RooflineTerms.build(flops=1e9, hbm_bytes=1e9, coll_bytes=450e9, chips=8)
        assert t4.bottleneck == "collective" and t4.collective_s == pytest.approx(1.0)

    def test_analyze_counted_keys(self):
        costs = dict(op_costs.zero_costs(), flops=2e12, flops_f32=1e12, hbm_bytes=6.7e12,
                     convert_bytes=3.35e12)
        r = analysis.analyze_counted(costs, {"argument_size_in_bytes": 5}, chips=2,
                                     model_flops=2e12)
        assert set(r) == {"memory", "collectives", "roofline"}
        rf = r["roofline"]
        assert rf["memory_s"] == pytest.approx(2.0)
        assert rf["memory_s_excl_converts"] == pytest.approx(1.0)
        assert rf["compute_s"] == pytest.approx(1e12 / 989e12 + 1e12 / 67e12)
        assert rf["bound_s"] == pytest.approx(2.0) and rf["useful_ratio"] == pytest.approx(0.5)
        assert r["memory"] == {"argument_size_in_bytes": 5}
        # The port's mesh step: one position executes every FLOP.
        one = analysis.analyze_counted(costs, {}, chips=2, model_flops=2e12,
                                       executed_flops=2e12)
        assert one["roofline"]["useful_ratio"] == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# The kernel wrappers' meta branch and cost record
# ---------------------------------------------------------------------------

class TestKernelCosts:
    C, P, W, B = 4, 6, 8 + 128 + 256, 256       # F32, int16 ids: W = B/32 + B/2 + B

    def words(self, device=META):
        return torch.empty((self.C, self.P, self.W), dtype=torch.int32, device=device)

    @pytest.mark.parametrize("nq", [0, 1, 3, 37])
    def test_topk_wrappers_on_meta(self, nq):
        K.reset_launch_counts()
        words = self.words()
        kw = dict(k=8, n_rows=100, packets_per_step=2, fmt_name="F32", block_size=self.B)
        with op_costs.OpCounter() as outer, op_costs.OpCounter() as inner:
            if nq == 0:
                x = meta(512)
                v, r = K.bscsr_topk_spmv(x, words, **kw)
                name, shape = "bscsr_topk_spmv", (self.C, 8)
            else:
                x = meta(nq, 512)
                v, r = K.bscsr_topk_spmv_multiquery(x, words, **kw)
                name, shape = "bscsr_topk_spmv_multiquery", (self.C, nq, 8)
        assert v.shape == r.shape == shape and v.device.type == r.device.type == "meta"
        assert v.dtype == torch.float32 and r.dtype == torch.int32
        assert K.bscsr_topk_spmv.launches == K.bscsr_topk_spmv_multiquery.launches == 0
        q = max(nq, 1)
        want_bytes = words.numel() * 4 + q * 512 * 4 + self.C * q * 8 * 8
        for c in (outer.costs(), inner.costs()):
            assert c["kernels"] == {name: {"calls": 1, "flops": 2.0 * self.C * self.P * self.B * q,
                                           "hbm_bytes": want_bytes}}
            assert c["hbm_bytes"] == want_bytes and c["flops"] == c["flops_f32"]

    def test_accumulate_wrapper_on_meta(self):
        K.reset_launch_counts()
        words = self.words()
        x = meta(512)
        with op_costs.OpCounter() as c:
            y = K.bscsr_spmv(x, words, n_rows=96, packets_per_step=2, fmt_name="F32",
                             block_size=self.B)
        assert y.shape == (self.C, 96) and y.device.type == "meta"
        assert K.bscsr_spmv.launches == 0
        rec = c.costs()["kernels"]["bscsr_spmv"]
        assert rec["hbm_bytes"] == words.numel() * 4 + 512 * 4 + self.C * 96 * 4
        assert rec["flops"] == 2.0 * self.C * self.P * self.B

    def test_cpu_runs_the_plain_version_uncounted_as_a_kernel(self):
        words = torch.zeros((self.C, self.P, self.W), dtype=torch.int32)
        x = torch.ones((2, 512))
        with op_costs.OpCounter() as c:
            K.bscsr_topk_spmv_multiquery(x, words, k=8, n_rows=100, packets_per_step=2,
                                         fmt_name="F32", block_size=self.B)
        assert c.costs()["kernels"] == {} and c.costs()["ops"] > 0

    def test_a_meta_mesh_takes_placeholders_only(self):
        mesh = make_production_mesh(devices=[META] * 256)
        assert mesh.shape == {"data": 16, "model": 16} and mesh.device_type == "meta"
        multi = dryrun.placeholder_mesh(True)
        assert multi.shape == {"pod": 2, "data": 16, "model": 16}
        with pytest.raises(ValueError, match="needs 256 devices"):
            make_production_mesh(devices=[META] * 255)


# ---------------------------------------------------------------------------
# Against the reference: a subprocess with 8 forced host devices
# ---------------------------------------------------------------------------

REFERENCE = r"""
import math, os, sys, json
import repro.launch.dryrun as jdry          # sets XLA_FLAGS; reset before jax starts
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.extend import core as jcore
from jax.sharding import AbstractMesh, AxisType
from repro.configs import ARCH_NAMES, get_config, smoke_config
from repro.configs.base import SHAPES, ShapeConfig
from repro.launch.analysis import analyze_compiled
from repro.sharding.rules import DEFAULT_RULES, use_rules

def jaxpr_flops(jaxpr, mult=1):
    # dot_general FLOPs of a jaxpr, scans multiplied by their length; a
    # contraction of size 1 is a product XLA rewrites as a multiply
    tot = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            contract = math.prod(lhs[i] for i in lc)
            if contract > 1:
                tot += 2 * math.prod(eqn.outvars[0].aval.shape) * contract * mult
        sub = mult * (eqn.params["length"] if eqn.primitive.name == "scan" else 1)
        for p in eqn.params.values():
            for j in (p if isinstance(p, (list, tuple)) else [p]):
                if isinstance(j, jcore.ClosedJaxpr):
                    tot += jaxpr_flops(j.jaxpr, sub)
                elif isinstance(j, jcore.Jaxpr):
                    tot += jaxpr_flops(j, sub)
    return tot

out = {"cells": {}, "model_flops": {}, "microbatches": {}}
mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
for arch in ARCH_NAMES:
    cfg = smoke_config(arch)
    rules = DEFAULT_RULES
    if cfg.sharding_overrides:
        rules = rules.replace(**dict(cfg.sharding_overrides))
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("t", kind, 32, 8)
        with mesh, use_rules(rules):
            fn, args = jdry.build_cell(cfg, shape, mesh, rules,
                                       microbatches=2 if kind == "train" else 1)
            r = analyze_compiled(fn.lower(*args).compile(), chips=mesh.size)
            jx = jax.make_jaxpr(fn)(*args)
        batch = sum(math.prod(v.shape) * v.dtype.itemsize for k, v in args[-1].items()
                    if v is not None) if kind == "train" else 0
        out["cells"][f"{arch}/{kind}"] = {
            "flops_x8": r["roofline"]["flops"] * mesh.size, "jaxpr_flops": jaxpr_flops(jx.jaxpr),
            "argument_bytes": r["memory"]["argument_size_in_bytes"], "batch_bytes": batch}
    for name, shape in SHAPES.items():
        out["model_flops"][f"{arch}/{name}"] = jdry.model_flops_for(get_config(arch), shape)
for multi in (False, True):
    am = AbstractMesh((2, 16, 16) if multi else (16, 16),
                      ("pod", "data", "model") if multi else ("data", "model"))
    for name, shape in SHAPES.items():
        out["microbatches"][f"{name}/{multi}"] = jdry.auto_microbatches(shape, am)
json.dump(out, open(sys.argv[1], "w"))
print("DRYRUN_REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "reference.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], env=env,
                          capture_output=True, text=True, timeout=500)
    assert "DRYRUN_REFERENCE_OK" in proc.stdout, proc.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def port_cells():
    """The port's 30 smoke cells on a 4 x 2 mesh of meta positions."""
    mesh = meta_mesh(4, 2)
    return {f"{arch}/{kind}": smoke_cell(arch, kind, mesh) for arch in ARCH_NAMES
            for kind in KINDS}


@pytest.mark.parametrize("multi", [False, True])
def test_model_flops_and_microbatches_match_the_reference(reference, multi):
    mesh = dryrun.placeholder_mesh(multi)
    for name, shape in SHAPES.items():
        assert dryrun.auto_microbatches(shape, mesh) == reference["microbatches"][f"{name}/{multi}"]
        for arch in ARCH_NAMES:
            assert dryrun.model_flops_for(get_config(arch), shape) == \
                reference["model_flops"][f"{arch}/{name}"], (arch, name)


# Equal to the reference's per-device HLO FLOPs x 8 to the FLOP: prefill and
# decode of the eight configs without experts, and four train cells.
EXACT_X8 = ([f"{a}/{k}" for a in ARCH_NAMES if a not in ("phi35_moe", "mixtral_8x7b")
             for k in ("prefill", "decode")]
            + [f"{a}/train" for a in ("qwen25_3b", "qwen2_72b", "granite_8b", "smollm_360m")])

# (reference x 8 - port) / (reference x 8), each within its stated bound.
GAPS_X8 = {
    # XLA's partitioned step recomputes attention products the program holds
    # once: 10,485,760 more on the score and value einsums and 37,748,736 in
    # dots it emits without source metadata.  The reference's own jaxpr
    # counts 425,721,856, the port's total to the FLOP.
    "whisper_small/train": (0.100, 0.104),
    # XLA's CSE merges the block remat's recompute of Q K^T with the
    # per-chunk checkpoint's recompute of it (one 524,288-FLOP product per
    # layer and microbatch): the port computes both, as the program does
    # (its jaxpr: 199,229,440, the port's total).
    "internvl2_2b/train": (-0.0107, -0.0106),
    # The SSD chunk scan: the port's eager backward skips the products whose
    # cotangents are known zeros (the first chunk's state, which starts at
    # zeros, and the last chunk's state update, whose carry is dropped):
    # 30 products of 262,144 FLOPs, where lax.scan transposes every chunk
    # alike; the reference's three-operand state-update einsum contracts p
    # in its backward as 20 products of 16,384 FLOPs where the port
    # multiplies and sums; XLA removes 3,080,192 of the jaxpr's.
    "zamba2_7b/train": (0.011, 0.0112),
    # The mLSTM chunk scan's first and last chunks as above (18 products of
    # 524,288 FLOPs, 2 of 131,072, 6 of 16,384 in the normalizer), less the
    # port's 24 size-1 contractions that torch runs as bmm (8,192 each).
    "xlstm_350m/train": (0.0017, 0.0019),
    # MoE: XLA's partitioned step replicates work that the one position
    # does once.  mixtral: the router product (its weight is not sharded on
    # "model"), computed by both model-axis devices; phi35 (no expert_cap
    # override): the expert FFNs on each of the four data-axis devices'
    # full capacity buffers, and the router as in mixtral.
    "mixtral_8x7b/train": (0.0011, 0.0012),
    "mixtral_8x7b/prefill": (0.0012, 0.0013),
    "mixtral_8x7b/decode": (0.0011, 0.0012),
    "phi35_moe/train": (0.59, 0.60),
    "phi35_moe/prefill": (0.73, 0.74),
    "phi35_moe/decode": (0.45, 0.46),
}

# (reference jaxpr - port) / reference jaxpr where the two programs differ:
# the chunk scans' first and last chunks and the three-operand einsum, as
# above (zamba2: 8,192,000; xlstm: 9,601,024).
GAPS_JAXPR = {"zamba2_7b/train": (0.0148, 0.0149), "xlstm_350m/train": (0.0139, 0.0140)}


@pytest.mark.parametrize("cell", [f"{a}/{k}" for a in ARCH_NAMES for k in KINDS])
def test_cell_flops_against_the_reference(reference, port_cells, cell):
    ref = reference["cells"][cell]
    got = port_cells[cell]["roofline"]["flops"]
    assert port_cells[cell]["costs_all_positions"]["flops"] == got   # position 0 does all
    if cell in EXACT_X8:
        assert got == ref["flops_x8"]
    else:
        lo, hi = GAPS_X8[cell]
        gap = (ref["flops_x8"] - got) / ref["flops_x8"]
        assert lo <= gap <= hi, (cell, gap)
    if cell in GAPS_JAXPR:
        lo, hi = GAPS_JAXPR[cell]
        gap = (ref["jaxpr_flops"] - got) / ref["jaxpr_flops"]
        assert lo <= gap <= hi, (cell, gap)
    else:
        assert got == ref["jaxpr_flops"]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_pieces_are_the_reference_arguments_less_the_batch(reference, port_cells, arch):
    """Position 0's masters, moments and step against the reference's
    per-device arguments without its batch piece.  That piece is the whole
    batch: the reference resolves the microbatched (2, 4, 32) leaves with
    the logical ("batch", "seq") from their first dim, whose 2 does not
    split 4 ways, so the batch is replicated, as the port holds it whole."""
    ref = reference["cells"][f"{arch}/train"]
    cfg = smoke_config(arch)
    model_bytes = sum(p.numel() * p.element_size()
                      for p in get_model(cfg).build(META, 32).parameters())
    batch = dryrun._train_batch(get_model(cfg), ShapeConfig("t", "train", 32, 8), 2)
    batch_bytes = sum(t.numel() * t.element_size() for t in batch.values())
    assert batch_bytes == ref["batch_bytes"]
    got = port_cells[f"{arch}/train"]["memory"]["argument_size_in_bytes"]
    pieces = got - model_bytes - batch_bytes
    assert pieces == ref["argument_bytes"] - ref["batch_bytes"]


def test_decode_memory_holds_the_cache_in_place(port_cells):
    r = port_cells["qwen25_3b/decode"]
    cfg = smoke_config("qwen25_3b")
    cache = get_model(cfg).cache_shape(8, 32)
    cache_bytes = sum(int(np.prod(s)) * torch.empty((), dtype=d).element_size()
                      for s, d in cache.values())
    assert r["memory"]["alias_size_in_bytes"] == cache_bytes
    assert r["memory"]["output_size_in_bytes"] == 8 * cfg.padded_vocab * 4
    assert r["collectives"]["all-gather"]["bytes"] == 0


def test_train_collectives_follow_the_placement(port_cells):
    """Position 0 gathers every distinct block held elsewhere (f32) and
    sends each other position its block of the gradient."""
    cfg = smoke_config("granite_8b")
    mesh = meta_mesh(4, 2)
    model, params, _, _ = dryrun._meta_train_state(get_model(cfg), mesh,
                                                   dryrun.DEFAULT_RULES, 32)
    n_total = sum(p.numel() for p in model.parameters())
    held0 = sum(a.pieces[(0, 0)].numel() for a in params.values())
    all_pieces = sum(p.numel() for a in params.values() for p in a.pieces.values())
    coll = port_cells["granite_8b/train"]["collectives"]
    assert coll["all-gather"]["bytes"] == 4 * (n_total - held0)
    assert coll["reduce-scatter"]["bytes"] == 4 * (all_pieces - held0)
    rf = port_cells["granite_8b/train"]["roofline"]
    assert rf["coll_bytes"] == coll["all-gather"]["bytes"] + coll["reduce-scatter"]["bytes"]
    allpos = port_cells["granite_8b/train"]["costs_all_positions"]
    assert allpos["hbm_bytes"] > rf["hbm_bytes"]        # the other positions' updates


def test_other_positions_pieces_stay_out_of_position_0s_memory():
    """granite's smoke step at B 1 x S 4 on a (2, 2) mesh, where both peaks
    come at the step's end with every new piece live: position 0's
    ``temp_size_in_bytes`` leaves out exactly the other three positions'
    new masters, moments and steps, which the all-positions peak holds."""
    cfg = smoke_config("granite_8b")
    shape = ShapeConfig("t", "train", 4, 1)
    fn, args = dryrun.build_cell(cfg, shape, meta_mesh(2, 2))
    with op_costs.OpCounter() as c:
        new_p, new_opt, _ = fn(*args)
    pieces = [a.pieces for tree in (new_p, new_opt["mu"], new_opt["nu"]) for a in tree.values()]
    pieces.append(new_opt["step"].pieces)
    others = sum(p.numel() * p.element_size()
                 for by_pos in pieces for pos, p in by_pos.items() if pos != (0, 0))
    assert c._live_all - c._live_here == others           # still live, all elsewhere
    r = dryrun.trace_cell(cfg, shape, meta_mesh(2, 2))
    temp = r["memory"]["temp_size_in_bytes"]
    assert temp == r["costs"]["peak_temp_bytes"] == c.costs()["peak_temp_bytes"]
    assert r["costs_all_positions"]["peak_temp_bytes"] - temp == others
    assert r["roofline"]["useful_ratio"] == pytest.approx(
        dryrun.model_flops_for(cfg, shape) / r["costs_all_positions"]["flops"])


@pytest.mark.parametrize("arch,kind", [("smollm_360m", "train"), ("mixtral_8x7b", "train"),
                                       ("whisper_small", "train"), ("xlstm_350m", "prefill")])
def test_a_cpu_step_counts_what_its_meta_trace_counts(arch, kind):
    """The same cell built on a one-position mesh of the CPU (zero batch,
    uninitialized weights) runs for real and counts the FLOPs, bytes, dtype
    casts and argument bytes of its ``meta`` trace exactly: no op the port
    dispatches depends on the device (``moe.py`` builds its one-hot by a
    compare for that: ``F.one_hot`` scatters on real devices)."""
    cfg = smoke_config(arch)
    shape = ShapeConfig("t", kind, 32, 8)
    mb = 2 if kind == "train" else 1
    r = dryrun.trace_cell(cfg, shape, meta_mesh(1, 1), microbatches=mb)
    assert r["costs"]["hbm_bytes"] == r["costs_all_positions"]["hbm_bytes"]
    cpu_mesh = DeviceMesh(np.full((1, 1), torch.device("cpu"), dtype=object), ("data", "model"))
    fn, args = dryrun.build_cell(cfg, shape, cpu_mesh, microbatches=mb)
    held = sum(t.numel() * t.element_size() for t in dryrun._at_first(args, (0, 0)))
    out, cpu = op_costs.count(fn, *args)
    assert {t.device.type for t in op_costs._tensors(out)} == {"cpu"}
    assert held == r["memory"]["argument_size_in_bytes"]
    for key in ("flops", "flops_f32", "hbm_bytes", "convert_bytes"):
        assert cpu[key] == r["roofline"][key], key


def test_topk_service_cell_counts_the_kernel_records():
    r = dryrun.run_topk_service_cell(False)
    assert r["status"] == "ok", r.get("traceback")
    idx = dryrun.topk_service_index(16)
    c, p, w = idx.packed.fused_words().shape
    per = c // 16
    k, block = idx.config.k, idx.packed.block_size
    kernels = r["costs_all_positions"]["kernels"]["bscsr_topk_spmv"]
    assert kernels["calls"] == 16
    one = per * p * w * 4 + 512 * 4 + per * k * 8
    assert kernels["hbm_bytes"] == 16 * one
    assert kernels["flops"] == 16 * 2.0 * per * p * block
    # position 0 runs one pass and gathers the other 15 runners' candidates
    assert r["costs"]["kernels"]["bscsr_topk_spmv"] == {"calls": 1, "flops": kernels["flops"] / 16,
                                                        "hbm_bytes": one}
    assert r["roofline"]["flops"] == 2.0 * per * p * block
    assert r["collectives"]["all-gather"]["bytes"] == 15 * per * k * 8


def test_pipeline_cell_flops_equal_the_sequential_cell(smoke_sizes):
    """The smoke qwen2.5-3b on 2 stages of the (2, 16, 8) placeholder mesh,
    8 microbatches: the sequential step's FLOPs; position 0's moves are its
    8 activations out and their 8 gradients back, the embedding and its
    gradient, the labels."""
    cfg = smoke_config("qwen25_3b")
    pipe = dryrun.run_pipeline_cell("qwen25_3b", stages=2)
    assert pipe["status"] == "ok", pipe.get("traceback")
    assert pipe["chips"] == 256 and pipe["pp_microbatches"] == 8
    seq = dryrun.trace_cell(cfg, ShapeConfig("t", "train", 32, 8), meta_mesh(2, 1))
    assert pipe["roofline"]["flops"] == seq["roofline"]["flops"]
    act = (8 // 8) * 32 * cfg.d_model * 4
    embed = 2 * cfg.padded_vocab * cfg.d_model * 4        # untied: ``tok`` and ``out``
    assert pipe["collectives"]["collective-permute"]["bytes"] == \
        2 * 8 * act + 2 * embed + 8 * 32 * 4
    assert dryrun.run_pipeline_cell("mixtral_8x7b", stages=2)["status"] == "skip"


def test_a_failing_cell_is_recorded_and_not_ok(smoke_sizes, monkeypatch):
    monkeypatch.setitem(dryrun.SHAPES, "t", ShapeConfig("t", "train", 32, 6))
    r = dryrun.run_cell("qwen25_3b", "t", False, microbatches=4)
    assert r["status"] == "fail" and "error" in r and r["microbatches"] == 4
    assert dryrun.run_cell("qwen25_3b", "long_500k", False)["status"] == "skip"


@pytest.mark.parametrize("argv", [
    ["--arch", "smollm_360m", "--shape", "train_4k", "--mesh", "single"],
    ["--arch", "topk_spmv", "--mesh", "single"],
])
def test_cli_writes_its_records(tmp_path, smoke_sizes, argv):
    """The CLI at smoke size (``smoke_sizes``)."""
    assert dryrun.main(argv + ["--out", str(tmp_path)]) == 0
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert [r["status"] for r in summary] == ["ok"]
    name = ("smollm-360m_train_4k_single.json" if argv[1] == "smollm_360m"
            else "topk_spmv_service_query_single.json")
    record = json.loads((tmp_path / name).read_text())
    assert record["status"] == "ok" and record["roofline"]["flops"] > 0
    assert record["roofline"]["hbm_bytes"] > 0 and "trace_s" in record


def test_meta_layout_cache_changes_no_count():
    """A cell traced with the meta-layout cache empty and again with it
    warm counts the same: the cache only skips PyTorch's Python meta
    kernels."""
    op_costs._META_LAYOUTS.clear()
    cold = smoke_cell("zamba2_7b", "train", meta_mesh(2, 2))
    assert op_costs._META_LAYOUTS
    warm = smoke_cell("zamba2_7b", "train", meta_mesh(2, 2))
    for key in ("costs", "costs_all_positions", "memory", "collectives"):
        assert cold[key] == warm[key], key
