"""The port's mesh dispatch on the CPU: meshes of repeated CPU devices.

The same seeded inputs go through ``repro`` and ``repro_torch``
(``device="cpu"``, the kernels' plain versions):

- ``launch.mesh``: ``make_serving_mesh``'s grid order, axis names, shape,
  error texts, repeated devices and normalisation; the host and
  production meshes' shapes and errors.
- ``sharding.rules``: ``DEFAULT_RULES`` entry for entry, and
  ``logical_to_spec`` against the reference's (built on
  ``jax.sharding.AbstractMesh``) over a grid of logical dims x shapes x
  meshes (2 x 4 serving, 16 x 16, 2 x 16 x 16, meshes lacking axes).
- The SPMD dispatcher (``ShardedTopKSpMVIndex(..., mesh=)``) at S x R =
  1x1, 2x1, 3x1 (the reference's all-gather fallback,
  ``num_partitions=9``), 4x2 and 8x1, fused and split: ``query``,
  ``query_batched`` at Q = 1, 3, 6, 37, 64 and ``spmv`` bit for bit the port's single-device index through
  churn and ``compact()``; a steady state with no upload and no retrace;
  dirty-partition shipping.  On a 1x1 mesh against the reference's
  ``_SpmdDispatcher`` in process, and at 4x2 and 3x1 against the
  reference's run on 8 forced host devices in a subprocess: the same
  answers (dyadic fixtures: bit for bit) and the same bundle counters.
- Mixed precision on a mesh, ``bundle.scatter``, the replica factor of
  the facade and the frontend, the head on a mesh, and
  ``distributed_topk_spmv_fn``.
"""
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro.core import bscsr as jbscsr
from repro.core.sharded import ShardedTopKSpMVIndex as JSharded
from repro.serve.topk_head import ApproxTopKHead as JHead
from repro.serve.topk_head import TopKHeadConfig as JHeadConfig
from repro.sharding import rules as jrules
from repro_torch.core import bscsr as tbscsr
from repro_torch.core import topk_spmv as ttopk
from repro_torch.core.faults import FaultInjected, FaultPlan
from repro_torch.core.sharded import ShardedTopKSpMVIndex
from repro_torch.core.similarity import SparseEmbeddingIndex
from repro_torch.kernels import bscsr_topk_spmv as tkernels
from repro_torch.kernels import executor as texec
from repro_torch.kernels import ops as tops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import DeviceMesh, make_serving_mesh
from repro_torch.serve import (
    ApproxTopKHead,
    FrontendConfig,
    StreamingSimilarityService,
    TopKHeadConfig,
)
from repro_torch.sharding import rules as trules

jtopk = importlib.import_module("repro.core.topk_spmv")
jmesh = importlib.import_module("repro.launch.mesh")

N_COLS = 96
TOL = 1e-5
CPU = torch.device("cpu")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These cases run many small tensor ops on the CPU; one intra-op thread
    keeps them from contending with the other test workers' threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cpu_mesh(n_shards, n_replicas=1):
    return make_serving_mesh(n_shards, n_replicas, devices=[CPU] * (n_shards * n_replicas))


def port_csr(csr) -> tbscsr.CSRMatrix:
    return tbscsr.CSRMatrix(csr.indptr, csr.indices, csr.data, csr.shape)


def tcfg(**kw) -> ttopk.TopKSpMVConfig:
    return ttopk.TopKSpMVConfig(device="cpu", **kw)


def dyadic_csr(n_rows=320, seed=0):
    """About 10 nnz a row on a 2**-7 grid (exact in F32 in any order)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 20, size=n_rows)
    lens[::11] = 0
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.concatenate([np.sort(rng.choice(N_COLS, int(n), replace=False))
                          for n in lens if n]).astype(np.int32)
    data = (rng.integers(-128, 128, int(lens.sum())) / 128.0).astype(np.float32)
    return tbscsr.CSRMatrix(indptr, idx, data, (n_rows, N_COLS))


def dyadic_queries(rng, q):
    return (rng.integers(-16, 17, (q, N_COLS)) / 8.0).astype(np.float32)


def dyadic_rows(rng, n, nnz=10):
    return [(np.sort(rng.choice(N_COLS, size=nnz, replace=False)).astype(np.int32),
             (rng.integers(-128, 128, nnz) / 128.0).astype(np.float32)) for _ in range(n)]


def to_np(pair):
    return tuple(t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
                 for t in pair)


def assert_bits(a, b, msg=""):
    (av, ar), (bv, br) = to_np(a), to_np(b)
    np.testing.assert_array_equal(np.ascontiguousarray(av, np.float32).view(np.int32),
                                  np.ascontiguousarray(bv, np.float32).view(np.int32),
                                  err_msg=msg)
    np.testing.assert_array_equal(ar.astype(np.int64), br.astype(np.int64), err_msg=msg)


def assert_close_rows(want, got, tol=TOL):
    """Values within tol; row ids equal except inside a near-tie of scores."""
    (wv, wr), (gv, gr) = to_np(want), to_np(got)
    np.testing.assert_allclose(gv, wv, rtol=tol, atol=tol)
    va = wv.reshape(-1, wv.shape[-1])
    for i, j in zip(*np.nonzero(wr.reshape(va.shape) != gr.reshape(va.shape))):
        gaps = np.abs(va[i] - va[i, j])
        gaps[j] = np.inf
        assert gaps.min() <= 2 * tol, f"row ids differ outside a tie at {(i, j)}"


def counters(info) -> dict:
    """The dispatcher's counters and its bundle's, as both packages name them."""
    keys = ("fn_builds", "retraces", "dispatches", "q_bucket_hits", "q_exact_hits")
    return dict({k: info[k] for k in keys}, bundle=info["bundle"])


# ---------------------------------------------------------------------------
# launch.mesh
# ---------------------------------------------------------------------------

class TestMeshes:
    def test_serving_mesh_grid_order_axes_and_shape(self):
        devs = [torch.device("cpu", i) for i in range(8)]
        mesh = make_serving_mesh(n_shards=4, n_replicas=2, devices=devs)
        assert mesh.axis_names == ("replica", "shard")
        assert mesh.shape == {"replica": 2, "shard": 4}
        assert list(mesh.shape) == ["replica", "shard"]
        assert mesh.devices.shape == (2, 4) and mesh.size == 8 and not mesh.empty
        for i, d in enumerate(devs):
            assert mesh.devices[i // 4, i % 4] == d   # the reference's grid order
        assert mesh.positions() == tuple(np.ndindex(2, 4))
        # Extra devices are ignored, as the reference ignores them.
        assert make_serving_mesh(2, 1, devices=devs).devices.tolist() == [devs[:2]]

    def test_repeated_devices(self):
        mesh = cpu_mesh(4, 2)
        assert mesh.shape == {"replica": 2, "shard": 4}
        assert all(d == CPU for d in mesh.devices.flat) and mesh.device_type == "cpu"

    def test_error_texts_match_the_reference(self):
        with pytest.raises(ValueError) as want:
            jmesh.make_serving_mesh(n_shards=4, n_replicas=2, devices=jax.devices()[:1])
        with pytest.raises(ValueError) as got:
            make_serving_mesh(n_shards=4, n_replicas=2, devices=[CPU])
        assert str(got.value) == str(want.value) == (
            "serving mesh needs 8 devices (2 replicas x 4 shards), have 1")

    def test_no_card_never_falls_back_to_the_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(ValueError, match="have 0"):
            make_serving_mesh(1, 1)
        with pytest.raises(ValueError, match="have 0"):
            tmesh.make_host_mesh()
        with pytest.raises(ValueError, match="needs 256 devices, have 0"):
            tmesh.make_production_mesh()
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            DeviceMesh(np.array([torch.device("cuda")], dtype=object), ("shard",))

    def test_normalisation_and_mixed_kinds(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        mesh = make_serving_mesh(2, 1, devices=[torch.device("cuda"), "cuda:0"])
        assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:0"]
        assert [str(d) for d in make_serving_mesh(2, 1).devices.flat] == ["cuda:0", "cuda:1"]
        with pytest.raises(ValueError, match="may not mix CPU and CUDA"):
            make_serving_mesh(2, 1, devices=[CPU, torch.device("cuda", 0)])
        with pytest.raises(ValueError, match="cuda, cpu or meta"):
            make_serving_mesh(1, 1, devices=["mps"])
        with pytest.raises(ValueError, match="may not mix meta placeholders and real"):
            make_serving_mesh(2, 1, devices=["meta", CPU])
        assert make_serving_mesh(2, 1, devices=["meta"] * 2).device_type == "meta"

    @pytest.mark.parametrize("multi_pod", [False, True])
    def test_production_and_host_meshes(self, multi_pod, monkeypatch):
        """Their shapes and axis names are the reference's, over the devices
        the host shows (stood in here by repeated CPU devices: a torch
        device index stops at 127), and too few devices raise."""
        n = 512 if multi_pod else 256
        count = [n]
        monkeypatch.setattr(tmesh, "_visible_devices", lambda devices: [CPU] * count[0])
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
        want = jmesh.make_production_mesh.__code__.co_consts
        assert ("pod", "data", "model") in want and ("data", "model") in want
        assert mesh.shape == ({"pod": 2, "data": 16, "model": 16} if multi_pod
                              else {"data": 16, "model": 16})
        count[0] = 8
        assert tmesh.make_host_mesh(model=2).shape == {"data": 4, "model": 2}
        count[0] = n - 1
        with pytest.raises(ValueError, match=f"needs {n} devices, have {n - 1}"):
            tmesh.make_production_mesh(multi_pod=multi_pod)
        count[0] = 6
        with pytest.raises(ValueError, match="have 6"):
            tmesh.make_host_mesh(model=4)


# ---------------------------------------------------------------------------
# sharding.rules
# ---------------------------------------------------------------------------

MESHES = {
    "serving_2x4": ((2, 4), ("replica", "shard")),
    "pod_16x16": ((16, 16), ("data", "model")),
    "multipod_2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "data_only_4": ((4,), ("data",)),
    "model_only_8": ((8,), ("model",)),
    "no_model_2x4": ((2, 4), ("pod", "data")),
}


class TestRules:
    def test_default_rules_equal_the_reference(self):
        assert trules.DEFAULT_RULES.rules == jrules.DEFAULT_RULES.rules
        over = dict(expert_cap=("pod", "data"), heads=None)
        assert (trules.DEFAULT_RULES.replace(**over).rules
                == jrules.DEFAULT_RULES.replace(**over).rules)
        for name, _ in jrules.DEFAULT_RULES.rules:
            assert trules.DEFAULT_RULES.lookup(name) == jrules.DEFAULT_RULES.lookup(name)
        assert trules.DEFAULT_RULES.lookup(None) is None
        assert trules.DEFAULT_RULES.lookup("no_such_axis") is None

    @pytest.mark.parametrize("name", sorted(MESHES))
    def test_logical_to_spec_matches_the_reference(self, name):
        sizes, axes = MESHES[name]
        amesh = AbstractMesh(sizes, axes)
        tm = DeviceMesh(np.full(sizes, CPU, dtype=object), axes)
        logical = [n for n, _ in jrules.DEFAULT_RULES.rules] + [None, "unknown"]
        dims = (1, 2, 3, 4, 6, 8, 15, 16, 32, 48, 256)
        rng = np.random.default_rng(len(name))
        cases = 0
        for rank in (1, 2, 3, 4):
            for _ in range(120):
                ld = tuple(logical[i] for i in rng.integers(0, len(logical), rank))
                shape = tuple(int(dims[i]) for i in rng.integers(0, len(dims), rank))
                want = jrules.logical_to_spec(ld, shape, amesh)
                got = trules.logical_to_spec(ld, shape, tm)
                assert got == tuple(want), (ld, shape, got, want)
                cases += 1
        # The three rules the grid must have met: the divisibility fallback,
        # one mesh axis on one dim only, trailing Nones dropped / 1-tuples
        # unwrapped.
        if "model" in axes:
            n = tm.shape["model"]
            assert trules.logical_to_spec(("heads",), (n + 1,), tm) == ()
            assert trules.logical_to_spec(("heads", "mlp"), (n, n), tm) == ("model",)
        if "data" in axes and "pod" not in axes:
            assert trules.logical_to_spec(("batch", None), (64, 3), tm) == ("data",)
        assert cases == 480

    def test_sharding_tree_rules_scope_and_constrain(self):
        tm = DeviceMesh(np.full((2, 4), CPU, dtype=object), ("data", "model"))
        params = {"w": torch.zeros(8, 12), "layers": [torch.zeros(3, 8)]}
        specs = {"w": ("embed_fsdp", "mlp"), "layers": [("layers", "embed_fsdp")]}
        got = trules.shard_params(params, specs, tm)
        assert got["w"] == (tm, ("data", "model"))
        assert got["layers"][0] == (tm, (None, "data"))
        assert trules.logical_sharding(("vocab",), (6,), tm) == (tm, ())
        custom = trules.DEFAULT_RULES.replace(mlp=None)
        assert trules.active_rules() is trules.DEFAULT_RULES
        with trules.use_rules(custom) as active:
            assert active is custom and trules.active_rules() is custom
        assert trules.active_rules() is trules.DEFAULT_RULES
        x = torch.zeros(4, 8)
        assert trules.constrain(x, ("batch", "embed"), tm) is x
        with pytest.raises(ValueError, match="rank 2"):
            trules.constrain(x, ("batch",), tm)


# ---------------------------------------------------------------------------
# The SPMD dispatcher against the port's single-device index
# ---------------------------------------------------------------------------

SHAPES = [(1, 1, 8), (2, 1, 8), (3, 1, 9), (4, 2, 8), (8, 1, 8)]
QS = (1, 3, 6, 37, 64)


def single_spmv(index, x, y):
    return ttopk.query_executor(index.config).spmv(x, index.packed, alpha=0.5, beta=2.0, y=y)


class TestDispatcher:
    @pytest.mark.parametrize("layout", ["fused", "split"])
    @pytest.mark.parametrize("s,r,c", SHAPES)
    def test_equals_the_single_device_index(self, s, r, c, layout):
        """Every call bit for bit the single-device index's, through churn
        and compact; the steady state uploads nothing and retraces
        nothing; a same-bucket mutation ships only dirty partitions."""
        rng = np.random.default_rng(100 + 10 * s + r)
        csr = port_csr(jbscsr.synthetic_embedding_csr(320, N_COLS, 10, "gamma", s))
        cfg = tcfg(big_k=16, k=8, num_partitions=c, block_size=64, stream_layout=layout)
        single = ttopk.MutableTopKSpMVIndex(csr, cfg)
        sharded = ShardedTopKSpMVIndex(csr, cfg, mesh=cpu_mesh(s, r))
        info = sharded.dispatch_info()
        assert info["path"] == "spmd"
        assert info["topology"] == {"n_shards": s, "n_replicas": r,
                                    "partitions_per_shard": c // s,
                                    "mesh_axes": {"replica": r, "shard": s}}
        xs = rng.standard_normal((64, N_COLS)).astype(np.float32)

        def hold(what):
            assert_bits(sharded.query(xs[0]), ttopk.topk_spmv(single, xs[0]), what)
            for q in QS:
                assert_bits(sharded.query_batched(xs[:q]),
                            ttopk.topk_spmv_batched(single, xs[:q]), f"{what} Q={q}")
            x = torch.from_numpy(xs[1])
            y = torch.from_numpy(rng.standard_normal(single.n_rows_total).astype(np.float32))
            want = single_spmv(single, x, y)
            np.testing.assert_array_equal(sharded.spmv(x, 0.5, 2.0, y).numpy().view(np.int32),
                                          want.numpy().view(np.int32), err_msg=what)

        hold("base")
        for cycle in range(3):
            batch = dyadic_rows(rng, 3)
            assert single.add_rows(batch) == sharded.add_rows(batch)
            again = dyadic_rows(rng, 1)
            single.replace_rows([cycle * 5 + 2], again)
            sharded.replace_rows([cycle * 5 + 2], again)
            single.delete_rows([cycle * 7 + 1])
            sharded.delete_rows([cycle * 7 + 1])
            hold(f"cycle {cycle}")
        # Steady state: no upload, no build, no retrace.
        before = counters(sharded.dispatch_info())
        hold("steady")
        after = counters(sharded.dispatch_info())
        assert after["bundle"] == before["bundle"]
        assert (after["fn_builds"], after["retraces"]) == (before["fn_builds"],
                                                          before["retraces"])
        # A one-row mutation in the same buckets ships its dirty partitions
        # only (the word family's stamps), and rebuilds nothing.
        row = dyadic_rows(rng, 1)
        assert single.add_rows(row) == sharded.add_rows(row)
        hold("one more row")
        info = counters(sharded.dispatch_info())
        moved = info["bundle"]["partitions_shipped"] - before["bundle"]["partitions_shipped"]
        assert 0 < moved < c, f"shipped {moved} of {c} partitions"
        assert info["retraces"] == before["retraces"]
        single.compact()
        sharded.compact()
        hold("compact")


    @pytest.mark.parametrize("q,bucket", [(1, 4), (2, 8), (3, 8), (9, 16)])
    def test_a_replica_row_walks_two_queries_when_the_pass_does(self, q, bucket):
        """The card's multi-query walk follows Q (one query, or two and
        more), so a pass of Q >= 2 gives every replica row at least two
        queries: on R = 4 the rows walk ``bucket / 4`` queries each, and the
        answers stay the single device's."""
        csr = port_csr(jbscsr.synthetic_embedding_csr(320, N_COLS, 10, "gamma", 7))
        cfg = tcfg(big_k=16, k=8, num_partitions=8, block_size=64)
        single = ttopk.MutableTopKSpMVIndex(csr, cfg)
        sharded = ShardedTopKSpMVIndex(csr, cfg, mesh=cpu_mesh(2, 4))
        disp = sharded._spmd
        seen = []
        build = disp._fn
        disp._fn = lambda key, *rest: (seen.append(key), build(key, *rest))[1]
        xs = np.random.default_rng(8).standard_normal((q, N_COLS)).astype(np.float32)
        assert_bits(sharded.query_batched(xs), ttopk.topk_spmv_batched(single, xs), f"Q={q}")
        assert seen == [bucket]


# ---------------------------------------------------------------------------
# Against the reference's mesh dispatch
# ---------------------------------------------------------------------------

def drive(index, xs, rows_by_cycle, replace_rows, to_query, batched_q=(1, 3, 6)):
    """The scenario both packages run: answers at every step, in order."""
    out = []

    def answers():
        out.append(to_np(index.query(to_query(xs[0]))))
        for q in batched_q:
            out.append(to_np(index.query_batched(to_query(xs[:q]))))

    answers()
    for cycle, rows in enumerate(rows_by_cycle):
        index.add_rows(rows)
        index.replace_rows([cycle * 5 + 2], replace_rows[cycle:cycle + 1])
        index.delete_rows([cycle * 7 + 1])
        answers()
    return out


class TestAgainstTheReference:
    def test_one_by_one_mesh_in_process(self):
        """The reference's ``_SpmdDispatcher`` on its one CPU device and the
        port's on a 1 x 1 mesh: the same answers (dyadic: bit for bit) and
        the same counters, bundle bytes included."""
        rng = np.random.default_rng(20)
        csr = dyadic_csr(240, seed=20)
        jcsr = jbscsr.CSRMatrix(csr.indptr, csr.indices, csr.data, csr.shape)
        kw = dict(big_k=16, k=8, num_partitions=8, block_size=64)
        ref = JSharded(jcsr, jtopk.TopKSpMVConfig(**kw), mesh=jmesh.make_serving_mesh(1, 1))
        port = ShardedTopKSpMVIndex(csr, tcfg(**kw), mesh=cpu_mesh(1))
        xs = dyadic_queries(rng, 6)
        cycles = [dyadic_rows(rng, 2) for _ in range(2)]
        again = dyadic_rows(rng, 2)
        want = drive(ref, xs, cycles, again, jnp.asarray)
        got = drive(port, xs, cycles, again, torch.from_numpy)
        for i, (w, g) in enumerate(zip(want, got)):
            assert_bits(w, g, f"answer {i}")
        jinfo, tinfo = ref.dispatch_info(), port.dispatch_info()
        assert tinfo["path"] == jinfo["path"] == "spmd"
        assert counters(tinfo) == counters(jinfo)
        assert tinfo["topology"] == jinfo["topology"]

    CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np, jax.numpy as jnp
from repro.core.bscsr import CSRMatrix
from repro.core.sharded import ShardedTopKSpMVIndex
from repro.core.topk_spmv import TopKSpMVConfig
from repro.launch.mesh import make_serving_mesh
assert jax.device_count() == 8
rng = np.random.default_rng(7)
n_rows, n_cols = 320, 96
lens = rng.integers(1, 20, size=n_rows)
lens[::11] = 0
indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
idx = np.concatenate([np.sort(rng.choice(n_cols, int(n), replace=False))
                      for n in lens if n]).astype(np.int32)
data = (rng.integers(-128, 128, int(lens.sum())) / 128.0).astype(np.float32)
csr = CSRMatrix(indptr, idx, data, (n_rows, n_cols))
xs = (rng.integers(-16, 17, (6, n_cols)) / 8.0).astype(np.float32)
cols = np.stack([np.sort(rng.choice(n_cols, 10, replace=False)) for _ in range(9)]
                ).astype(np.int32)
vals = (rng.integers(-128, 128, (9, 10)) / 128.0).astype(np.float32)
out = dict(indptr=indptr, indices=idx, data=data, xs=xs, cols=cols, vals=vals)
for name, layout, s, r, c in (("f42", "fused", 4, 2, 8), ("s42", "split", 4, 2, 8),
                              ("f31", "fused", 3, 1, 9)):
    cfg = TopKSpMVConfig(big_k=16, k=8, num_partitions=c, block_size=64,
                         stream_layout=layout)
    sh = ShardedTopKSpMVIndex(csr, cfg, mesh=make_serving_mesh(
        s, r, devices=jax.devices()[:s * r]))
    res = []
    def answers():
        res.append(sh.query(jnp.asarray(xs[0])))
        for q in (1, 3, 6):
            res.append(sh.query_batched(jnp.asarray(xs[:q])))
    answers()
    for cycle in range(2):
        sh.add_rows([(cols[3 * cycle + i], vals[3 * cycle + i]) for i in range(2)])
        sh.replace_rows([cycle * 5 + 2], [(cols[3 * cycle + 2], vals[3 * cycle + 2])])
        sh.delete_rows([cycle * 7 + 1])
        answers()
    y = sh.spmv(jnp.asarray(xs[1]), 0.5, 2.0, jnp.ones(sh.n_rows_total, jnp.float32))
    out[name + "_spmv"] = np.asarray(y)
    for i, (v, rr) in enumerate(res):
        out[f"{name}_v{i}"] = np.asarray(v)
        out[f"{name}_r{i}"] = np.asarray(rr)
    info = sh.dispatch_info()
    b = info["bundle"]
    out[name + "_counters"] = np.array(
        [info[k] for k in ("fn_builds", "retraces", "dispatches", "q_bucket_hits",
                           "q_exact_hits")]
        + [b["uploads"], b["host_bytes_shipped"], b["partitions_shipped"]]
        + [x for p in b["per_shard"] for x in (p["uploads"], p["bytes_shipped"])])
    out[name + "_axes"] = np.array(list(info["topology"]["mesh_axes"].items()))
np.savez(sys.argv[1], **out)
print("MESH_REFERENCE_OK")
"""

    def test_eight_device_subprocess(self, tmp_path):
        """The reference's 4 x 2 (fused, split) and 3 x 1 meshes on 8
        forced host devices, against the port's on 8 and 3 CPU positions:
        the same answers bit for bit (dyadic fixtures), the same ``spmv``,
        and, on the fused layout, the same counters with the bundle's bytes.
        The split layout ships one fused word family where the reference
        ships three split ones, so there only the answers are held."""
        path = tmp_path / "reference.npz"
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
        proc = subprocess.run([sys.executable, "-c", self.CODE, str(path)], env=env,
                              capture_output=True, text=True, timeout=600)
        assert "MESH_REFERENCE_OK" in proc.stdout, proc.stderr[-3000:]
        ref = np.load(path)
        csr = tbscsr.CSRMatrix(ref["indptr"], ref["indices"], ref["data"], (320, N_COLS))
        xs, cols, vals = ref["xs"], ref["cols"], ref["vals"]
        for name, layout, s, r, c in (("f42", "fused", 4, 2, 8), ("s42", "split", 4, 2, 8),
                                      ("f31", "fused", 3, 1, 9)):
            sh = ShardedTopKSpMVIndex(csr, tcfg(big_k=16, k=8, num_partitions=c,
                                                block_size=64, stream_layout=layout),
                                      mesh=cpu_mesh(s, r))
            got = drive(sh, xs, [[(cols[3 * i + j], vals[3 * i + j]) for j in range(2)]
                                 for i in range(2)],
                        [(cols[3 * i + 2], vals[3 * i + 2]) for i in range(2)],
                        torch.from_numpy)
            for i, g in enumerate(got):
                assert_bits((ref[f"{name}_v{i}"], ref[f"{name}_r{i}"]), g, f"{name} {i}")
            y = sh.spmv(torch.from_numpy(xs[1]), 0.5, 2.0, torch.ones(sh.n_rows_total))
            np.testing.assert_array_equal(y.numpy().view(np.int32),
                                          ref[name + "_spmv"].view(np.int32))
            info = sh.dispatch_info()
            assert dict(info["topology"]["mesh_axes"]) == {
                k: int(v) for k, v in ref[name + "_axes"]}
            b = info["bundle"]
            mine = np.array(
                [info[k] for k in ("fn_builds", "retraces", "dispatches", "q_bucket_hits",
                                   "q_exact_hits")]
                + [b["uploads"], b["host_bytes_shipped"], b["partitions_shipped"]]
                + [x for p in b["per_shard"] for x in (p["uploads"], p["bytes_shipped"])])
            if layout == "fused":
                np.testing.assert_array_equal(mine, ref[name + "_counters"], err_msg=name)
            else:
                np.testing.assert_array_equal(mine[:5], ref[name + "_counters"][:5])


# ---------------------------------------------------------------------------
# Mixed precision, bundle.scatter, replica factor, the head
# ---------------------------------------------------------------------------

class TestMixedPrecision:
    def test_native_groups_on_columns_equal_the_twins_through_the_dispatcher(self):
        rng = np.random.default_rng(30)
        csr = port_csr(jbscsr.synthetic_embedding_csr(320, N_COLS, 10, "gamma", 12))
        cfg = tcfg(big_k=16, k=8, num_partitions=8, block_size=64, recall_target=0.95)
        mesh = cpu_mesh(4, 2)
        native = ShardedTopKSpMVIndex(csr, cfg, mesh=mesh)
        twins = ShardedTopKSpMVIndex(csr, cfg, mesh=mesh, native_groups=False)
        per_shard = ShardedTopKSpMVIndex(csr, cfg, n_shards=4)
        assert native.dispatch_info()["path"] == "per_shard"
        assert twins.dispatch_info()["path"] == "spmd"
        assert all(sh.packed.groups is not None for sh in native.shards)
        xs = rng.standard_normal((6, N_COLS)).astype(np.float32)
        for step in range(2):
            for q in (1, 6):
                want = per_shard.query_batched(xs[:q])
                assert_bits(want, native.query_batched(xs[:q]), f"native {step} Q={q}")
                assert_bits(want, twins.query_batched(xs[:q]), f"twins {step} Q={q}")
            assert_bits(per_shard.query(xs[0]), native.query(xs[0]))
            assert_bits(per_shard.query(xs[0]), twins.query(xs[0]))
            x = torch.from_numpy(xs[1])
            y = torch.ones(per_shard.n_rows_total)
            want = per_shard.spmv(x, 1.0, 0.5, y).numpy().view(np.int32)
            for idx in (native, twins):
                np.testing.assert_array_equal(idx.spmv(x, 1.0, 0.5, y).numpy().view(np.int32),
                                              want)
            rows = [(np.sort(rng.choice(N_COLS, 12, replace=False)).astype(np.int32),
                     (0.25 * rng.standard_normal(12)).astype(np.float32)) for _ in range(3)]
            for idx in (native, twins, per_shard):
                idx.add_rows(rows)
                idx.delete_rows([5])


class TestBundleScatter:
    def test_fault_reship_and_old_bytes(self):
        """``bundle.scatter`` fires before any byte moves; the next sync
        re-ships the shard; a query holding the old pieces reads the old
        bytes, after a full ship and after a dirty-partition scatter."""
        rng = np.random.default_rng(40)
        csr = dyadic_csr(320, seed=40)
        cfg = tcfg(big_k=16, k=8, num_partitions=8, block_size=64)
        single = ttopk.MutableTopKSpMVIndex(csr, cfg)
        sharded = ShardedTopKSpMVIndex(csr, cfg, mesh=cpu_mesh(2, 2))
        disp = sharded._spmd
        xs = dyadic_queries(rng, 4)
        held = []                        # (args, words copies, answer) before each ship

        def hold():
            args, _ = disp._sync()
            held.append((args, {p: t.clone() for p, t in args[0].pieces.items()},
                         to_np(ttopk.topk_spmv_batched(single, xs))))

        for _ in range(2):               # the first bucket jump ships in full
            hold()
            rows = dyadic_rows(rng, 2)
            single.add_rows(rows)
            sharded.add_rows(rows)
            assert_bits(sharded.query_batched(xs), ttopk.topk_spmv_batched(single, xs))
        hold()
        rows = dyadic_rows(rng, 1)
        single.add_rows(rows)
        sharded.add_rows(rows)
        uploads, shipped = disp.bundle.uploads, disp.bundle.partitions_shipped
        with pytest.raises(FaultInjected):
            with FaultPlan({"bundle.scatter": 0}) as plan:
                sharded.query(xs[0])
        assert plan.fired == [("bundle.scatter", 0)]
        assert disp.bundle.uploads == uploads          # nothing moved
        assert_bits(sharded.query_batched(xs), ttopk.topk_spmv_batched(single, xs))
        assert disp.bundle.uploads > uploads           # the next sync re-shipped
        assert disp.bundle.partitions_shipped > shipped   # a dirty-partition scatter
        now = disp._sync()[0][0].pieces
        for args, words, answer in held:
            assert all(torch.equal(t, words[pos]) for pos, t in args[0].pieces.items())
            assert any(t is not now[pos] for pos, t in args[0].pieces.items())
            assert_bits(disp._build(4, args)(torch.from_numpy(xs), args), answer)


class TestReplicaFactor:
    def test_facade_and_frontend(self):
        emb = np.random.default_rng(50).standard_normal((64, N_COLS)).astype(np.float32)
        cfg = tcfg(big_k=8, k=8, num_partitions=8, block_size=64)
        fac = SparseEmbeddingIndex.from_dense(emb, nnz_per_row=8, config=cfg,
                                              mesh=cpu_mesh(2, 4))
        jfac_cls = importlib.import_module("repro.core.similarity").SparseEmbeddingIndex
        jfac = jfac_cls.from_dense(emb, nnz_per_row=8,
                                   config=jtopk.TopKSpMVConfig(big_k=8, k=8, num_partitions=8,
                                                               block_size=64),
                                   mesh=jmesh.make_serving_mesh(1, 1))
        assert fac.replica_factor == 4 and jfac.replica_factor == 1
        assert SparseEmbeddingIndex.from_dense(emb, config=cfg, n_shards=2).replica_factor == 1
        svc = StreamingSimilarityService(fac, frontend=FrontendConfig(max_batch=8))
        try:
            assert svc.frontend.replica_factor == 4
            assert svc.frontend.capacity == 8 * 4
            q = np.random.default_rng(51).standard_normal((5, N_COLS)).astype(np.float32)
            futs = [svc.submit(x) for x in q]
            svc.frontend.flush()
            plain = SparseEmbeddingIndex.from_dense(emb, nnz_per_row=8, config=cfg)
            for x, f in zip(q, futs):
                assert_bits(f.result(timeout=60), plain.query(x))
        finally:
            svc.close()


class TestHead:
    @pytest.mark.parametrize("s,r", [(2, 1), (4, 2)])
    def test_head_on_a_mesh_equals_the_unsharded_head(self, s, r):
        rng = np.random.default_rng(60 + s)
        emb = rng.standard_normal((96, 40)).astype(np.float32)
        kw = dict(big_k=16, k=4, num_partitions=8, nnz_per_row=8)
        plain = ApproxTopKHead(emb, TopKHeadConfig(device="cpu", **kw))
        meshed = ApproxTopKHead(emb, TopKHeadConfig(device="cpu", mesh=cpu_mesh(s, r), **kw))
        ref = JHead(emb, JHeadConfig(**kw))
        hs = rng.standard_normal((7, 40)).astype(np.float32)
        assert_bits(plain.topk_logits_batch(hs), meshed.topk_logits_batch(hs))
        assert_bits(plain.topk_logits(hs[1]), meshed.topk_logits(hs[1]))
        assert_close_rows(ref.topk_logits_batch(hs, use_kernel=False),
                          meshed.topk_logits_batch(hs))
        assert meshed.dispatch_info()["topology"]["mesh_axes"] == {"replica": r, "shard": s}
        with pytest.raises(ValueError, match="config.device is 'cuda'"):
            ApproxTopKHead(emb, TopKHeadConfig(mesh=cpu_mesh(s, r), **kw))


# ---------------------------------------------------------------------------
# distributed_topk_spmv_fn
# ---------------------------------------------------------------------------

def auto_mesh(axes):
    devs = np.array(jax.devices()[:1]).reshape((1,) * len(axes))
    return jax.sharding.Mesh(devs, axes, axis_types=(AxisType.Auto,) * len(axes))


class TestDistributed:
    @pytest.mark.parametrize("dyadic", [True, False])
    @pytest.mark.parametrize("batched", [False, True])
    @pytest.mark.parametrize("axis", ["data", ("pod", "data")])
    def test_against_topk_spmv_and_the_reference(self, axis, batched, dyadic):
        rng = np.random.default_rng(70)
        csr = dyadic_csr(320, 70) if dyadic else port_csr(
            jbscsr.synthetic_embedding_csr(320, N_COLS, 10, "gamma", 70))
        jcsr = jbscsr.CSRMatrix(csr.indptr, csr.indices, csr.data, csr.shape)
        kw = dict(big_k=16, k=8, num_partitions=8, block_size=64, value_format="BF16")
        index = ttopk.build_index(csr, tcfg(**kw))
        if isinstance(axis, str):
            mesh = DeviceMesh(np.full((4,), CPU, dtype=object), ("data",))
        else:
            mesh = DeviceMesh(np.full((2, 2, 2), CPU, dtype=object), ("pod", "data", "model"))
        fn, arrays = ttopk.distributed_topk_spmv_fn(index, mesh, shard_axis=axis,
                                                    batched=batched)
        assert len(arrays) == 1 and len(arrays[0].pieces) == mesh.size
        xs = (dyadic_queries(rng, 5) if dyadic
              else rng.standard_normal((5, N_COLS)).astype(np.float32))
        x = xs if batched else xs[0]
        want = (ttopk.topk_spmv_batched if batched else ttopk.topk_spmv)(index, x)
        got = fn(torch.from_numpy(x), *arrays)
        assert_bits(want, got)
        jindex = jtopk.build_index(jcsr, jtopk.TopKSpMVConfig(**kw))
        jfn, jarrays = jtopk.distributed_topk_spmv_fn(
            jindex, auto_mesh(axis if isinstance(axis, tuple) else (axis,)),
            shard_axis=axis, batched=batched)
        ref = jfn(jnp.asarray(x), *jarrays)
        if dyadic:
            assert_bits(ref, got)
        else:
            assert_close_rows(ref, got)

    def test_split_tables_follow_the_words_at_a_position(self):
        """The dispatcher and ``distributed_topk_spmv_fn`` share one table
        cache, keyed by (position, words tensor): other words at a cached
        position get their own table, never the stale one."""
        kw = dict(big_k=16, k=8, num_partitions=4, block_size=64, value_format="BF16")
        words = [tops.host_tensor(tops.kernel_words(ttopk.build_index(
            dyadic_csr(n, seed), tcfg(**kw)).packed), CPU) for n, seed in ((320, 72), (640, 73))]
        geo = dict(packets_per_step=2, block_size=64)
        cache: dict = {}
        for w in words + words[:1]:
            got = texec.position_split_table(cache, (0,), w, 3, **geo)
            want = tkernels.spmv_split_table(w, splits=3, **geo)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert texec.position_split_table(cache, (0,), w, 3, **geo) is got
        assert not torch.equal(texec.position_split_table(cache, (0,), words[0], 3, **geo)[0],
                               texec.position_split_table({}, (0,), words[1], 3, **geo)[0])

    def test_mutable_and_mixed_indexes_and_the_divisibility_error(self):
        rng = np.random.default_rng(71)
        emb = rng.standard_normal((320, N_COLS)).astype(np.float32)
        emb[:80] *= 4.0
        csr = tbscsr.sparsify_topm(emb, 12)
        mesh = DeviceMesh(np.full((4,), CPU, dtype=object), ("data",))
        xs = rng.standard_normal((3, N_COLS)).astype(np.float32)
        for cfg in (tcfg(big_k=16, k=8, num_partitions=8, block_size=64),
                    tcfg(big_k=16, k=8, num_partitions=8, block_size=64, recall_target=0.9)):
            index = ttopk.MutableTopKSpMVIndex(csr, cfg)
            index.add_rows([(np.arange(12, dtype=np.int32), np.ones(12, np.float32))])
            index.delete_rows([4, 9])
            fn, arrays = ttopk.distributed_topk_spmv_fn(index, mesh, batched=True)
            assert_bits(ttopk.topk_spmv_batched(index, xs), fn(xs, *arrays))
        jindex = jtopk.build_index(jbscsr.CSRMatrix(csr.indptr, csr.indices, csr.data,
                                                    csr.shape),
                                   jtopk.TopKSpMVConfig(num_partitions=6))
        index = ttopk.build_index(csr, tcfg(num_partitions=6))
        with pytest.raises(ValueError) as want:
            jtopk.distributed_topk_spmv_fn(jindex, jax.sharding.Mesh(
                np.array(jax.devices()[:1] * 4), ("data",)))
        with pytest.raises(ValueError) as got:
            ttopk.distributed_topk_spmv_fn(index, mesh)
        assert str(got.value) == str(want.value)
