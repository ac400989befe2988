"""The port's training mesh against the reference's, on the CPU.

- Specs: for all ten smoke configs, ``ModelAPI.param_specs()`` names every
  parameter with a spec of its rank and equals the reference's
  ``param_specs()`` unstacked (one leading entry dropped per stacked axis);
  ``shard_params`` resolves each to the reference's resolved spec minus its
  layer entries over Auto-axis ``AbstractMesh`` es (2, 2), (4, 2), (16, 16)
  and (2, 16, 16), with ``mixtral_8x7b``'s override; ``cache_specs``,
  ``batch_spec`` (shapes and dtypes), ``batch_logical`` and
  ``opt_state_specs`` likewise.
- Train: ``make_sharded_step`` on meshes (1, 1), (2, 2), (4, 2) and (2, 4)
  of CPU positions gives the one-device step's losses, masters and moments
  bit for bit after every step, on every config; ``train(mesh=)`` equals
  ``train(mesh=None)`` on the six families at microbatches 1 and 2 and f32
  and bf16 gradients; replicated pieces stay equal.  The reference's
  ``train`` on Auto-axis (1, 1), (2, 2) and (4, 2) meshes (a subprocess
  with forced host devices) and the port's sharded step on its params and
  batches give the same losses within 1e-5 relative.
- Elastic restore: a run saved on (2, 2) resumes on (4, 1), (1, 1) and no
  mesh bit for bit; a mesh save holds the bytes of a one-device save;
  restored pieces have the reference's ``NamedSharding.shard_shape``.
- Pipeline: ``pipeline_applicable`` over the reference test's cases;
  ``pipelined_loss_fn`` against the port's sequential loss at S in
  {1, 2, 4}, M in {1, 4, 8}, remat none and full, and against the
  reference's pipelined loss and gradients on an Auto-axis (4, 2, 2) mesh
  (the setup of ``tests/test_pipeline.py``) within its bounds; the two
  assertion texts.
- Launcher: ``--mesh host --device cpu`` trains and prints the final loss;
  ``--model-parallel 2`` and ``--mesh production`` raise.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.models import model_zoo as jzoo
from repro.sharding import rules as jrules
from repro.train import data as jdata
from repro.train import pipeline as jpipeline
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.convert import named_from_reference, params_from_reference, tree_to_reference
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import DeviceMesh, MeshArray, gather, piece_slices, unique_blocks
from repro_torch.models import model_zoo as tzoo
from repro_torch.models.model_zoo import STACKED
from repro_torch.sharding import rules as trules
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train import pipeline as tpipeline
from repro_torch.train.checkpoint import CheckpointManager

ARCHS = ["qwen25_3b", "granite_8b", "smollm_360m", "qwen2_72b", "internvl2_2b",
         "mixtral_8x7b", "phi35_moe", "zamba2_7b", "xlstm_350m", "whisper_small"]
FAMILIES = {"dense": "smollm_360m", "moe": "mixtral_8x7b", "vlm": "internvl2_2b",
            "hybrid": "zamba2_7b", "ssm": "xlstm_350m", "audio": "whisper_small"}
ABSTRACT_MESHES = {"2x2": ((2, 2), ("data", "model")), "4x2": ((4, 2), ("data", "model")),
                   "16x16": ((16, 16), ("data", "model")),
                   "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TRAIN_MESHES = [(1, 1), (2, 2), (4, 2), (2, 4)]
CPU = torch.device("cpu")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# The reference's pipeline test's bounds.
PIPE_LOSS_RTOL, PIPE_GRAD_ATOL = 1e-5, 1e-4
# The port's sharded step against the reference's train on its params and
# batches, over three steps.
REF_LOSS_RTOL = 1e-5
REF_SHAPE = (8, 32)            # B x S of the reference run
REF_TC = dict(steps=3, warmup_steps=2, learning_rate=1e-3, microbatches=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size models: one intra-op thread keeps these cases from
    contending with the other test workers' threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cpu_mesh(shape, axes=("data", "model")) -> DeviceMesh:
    return DeviceMesh(np.full(shape, CPU, dtype=object), axes)


def strip(spec) -> tuple:
    return trules.P(*tuple(spec))


def stacked_axes(name: str) -> int:
    return STACKED.get(name.split(".")[0], 0)


def reference_named(tree, names, is_leaf=None) -> dict:
    """The reference tree's leaf for each port name (stacked axes unstacked by
    path: every layer of a stacked leaf maps to the same leaf)."""
    flat = {tuple(getattr(k, "key", k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)}
    out = {}
    for name in names:
        parts = name.split(".")
        out[name] = flat[(parts[0], *parts[1 + stacked_axes(name):])]
    return out


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)


def tbatch(batch) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def assert_same_state(a_params, a_opt, b_params, b_opt):
    """One-device (named tensors) vs mesh (MeshArrays): bit for bit."""
    for name, t in a_params.items():
        assert torch.equal(t, gather(b_params[name], "cpu")), name
        for m in ("mu", "nu"):
            assert torch.equal(a_opt[m][name], gather(b_opt[m][name], "cpu")), (m, name)
    assert all(int(p) == int(a_opt["step"]) for p in b_opt["step"].pieces.values())


def assert_replicas_equal(arr: MeshArray):
    """Every position holding the same block holds the same bits."""
    mesh, spec = arr.sharding
    for pos, sl in unique_blocks(arr.shape, arr.sharding):
        for other in mesh.positions():
            if piece_slices(arr.shape, spec, mesh, other) == sl:
                assert torch.equal(arr.pieces[other], arr.pieces[pos])


# ---------------------------------------------------------------------------
# The reference's runs on forced host devices, once per module
# ---------------------------------------------------------------------------

REFERENCE_CODE = r"""
import os, sys, tempfile
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import dataclasses, jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import smoke_config
from repro.configs.base import ShapeConfig, TrainConfig
from repro.models.model_zoo import get_model
from repro.train import loop
from repro.train.pipeline import pipelined_loss_fn, pipeline_applicable
assert jax.device_count() == 16
B, S = int(sys.argv[2]), int(sys.argv[3])
STEPS, WARMUP, LR, MICRO = int(sys.argv[4]), int(sys.argv[5]), float(sys.argv[6]), int(sys.argv[7])

def auto(shape, axes):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes),
                         devices=jax.devices()[:n])

def flat(tree, prefix):
    return {prefix + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}

out = {}
cfg = smoke_config("smollm_360m")
out.update(flat(get_model(cfg).init_params(jax.random.key(0), S), "train_init:"))
for d, m in ((1, 1), (2, 2), (4, 2)):
    with tempfile.TemporaryDirectory() as ck:
        tc = TrainConfig(steps=STEPS, warmup_steps=WARMUP, learning_rate=LR,
                         microbatches=MICRO, checkpoint_dir=ck, checkpoint_every=0)
        res = loop.train(cfg, ShapeConfig("t", "train", S, B), tc,
                         mesh=auto((d, m), ("data", "model")), log_every=100)
    out[f"train_losses_{d}x{m}"] = np.array(res["history"], np.float64)

# tests/test_pipeline.py's case on an Auto-axis mesh
cfg = dataclasses.replace(smoke_config('granite_8b'), num_layers=4)
assert pipeline_applicable(cfg, 4)
api = get_model(cfg)
params = api.init_params(jax.random.key(0), 32)
rng = np.random.default_rng(0)
batch = {'tokens': jnp.asarray(rng.integers(0, cfg.vocab_size, (8, 16)), jnp.int32),
         'labels': jnp.asarray(rng.integers(0, cfg.vocab_size, (8, 16)), jnp.int32)}
mesh = auto((4, 2, 2), ('stage', 'data', 'model'))
with mesh:
    pp_loss = jax.jit(lambda p, b: pipelined_loss_fn(p, cfg, b, mesh, 4))(params, batch)
    g_pp = jax.jit(jax.grad(lambda p: pipelined_loss_fn(p, cfg, batch, mesh, 4)))(params)
out.update(flat(params, "pipe_init:"))
out.update(flat(g_pp, "pipe_grad:"))
out["pipe_loss"] = np.asarray(pp_loss, np.float64)
out["pipe_tokens"] = np.asarray(batch["tokens"])
out["pipe_labels"] = np.asarray(batch["labels"])
np.savez(sys.argv[1], **out)
print("TRAIN_MESH_REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's train on three Auto-axis meshes and its pipeline on a
    (4, 2, 2) one, in one subprocess with 16 forced host devices."""
    path = tmp_path_factory.mktemp("reference") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    args = [str(path), *map(str, REF_SHAPE), *(str(REF_TC[k]) for k in
                                               ("steps", "warmup_steps", "learning_rate",
                                                "microbatches"))]
    proc = subprocess.run([sys.executable, "-c", REFERENCE_CODE, *args], env=env,
                          capture_output=True, text=True, timeout=600)
    assert "TRAIN_MESH_REFERENCE_OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def nested(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

class TestSpecs:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_param_specs_are_the_references_unstacked(self, arch):
        tapi = tzoo.get_model(tconfigs.smoke_config(arch))
        japi = jzoo.get_model(jconfigs.smoke_config(arch))
        specs = tapi.param_specs()
        shapes = {n: tuple(p.shape) for n, p in tapi.build("meta", 8).named_parameters()}
        assert set(specs) == set(shapes)
        want = reference_named(japi.param_specs(), specs, is_leaf=is_spec)
        for name, spec in specs.items():
            ax = stacked_axes(name)
            assert len(tuple(want[name])) - ax == len(shapes[name]), name   # rank
            assert len(spec) <= len(shapes[name]), name
            assert spec == strip(tuple(want[name])[ax:]), name

    @pytest.mark.parametrize("mesh_name", sorted(ABSTRACT_MESHES))
    @pytest.mark.parametrize("arch", ARCHS)
    def test_shard_params_resolves_as_the_reference(self, arch, mesh_name):
        sizes, axes = ABSTRACT_MESHES[mesh_name]
        tcfg, jcfg = tconfigs.smoke_config(arch), jconfigs.smoke_config(arch)
        tapi, japi = tzoo.get_model(tcfg), jzoo.get_model(jcfg)
        trs, jrs = trules.DEFAULT_RULES, jrules.DEFAULT_RULES
        if tcfg.sharding_overrides:
            trs = trs.replace(**dict(tcfg.sharding_overrides))
            jrs = jrs.replace(**dict(jcfg.sharding_overrides))
        assert trs.rules == jrs.rules
        model = tapi.build("meta", 8)
        got = trules.shard_params(dict(model.named_parameters()), tapi.param_specs(),
                                  cpu_mesh(sizes, axes), trs)
        abstract = jax.eval_shape(lambda: japi.init_params(jax.random.key(0), 8))
        amesh = AbstractMesh(sizes, axes)
        want = reference_named(jrules.shard_params(abstract, japi.param_specs(), amesh, jrs),
                               got, is_leaf=is_sharding)
        for name, (mesh, spec) in got.items():
            ax = stacked_axes(name)
            assert spec == strip(tuple(want[name].spec)[ax:]), name
        if arch == "mixtral_8x7b":      # the override reaches the rules constrain reads
            assert trs.lookup("expert_cap") == ("pod", "data")

    @pytest.mark.parametrize("arch", ARCHS)
    def test_cache_and_batch_specs(self, arch):
        tcfg, jcfg = tconfigs.smoke_config(arch), jconfigs.smoke_config(arch)
        tapi, japi = tzoo.get_model(tcfg), jzoo.get_model(jcfg)
        assert tapi.cache_specs() == {k: strip(v) for k, v in japi.cache_specs().items()}
        assert set(tapi.cache_specs()) == set(tapi.cache_shape(2, 8))
        for kind, seq in (("train", 32), ("prefill", 32), ("decode", 64)):
            shape = ShapeConfig("s", kind, seq, 4)
            jshape = jbase.ShapeConfig("s", kind, seq, 4)
            got, want = tapi.batch_spec(shape), japi.batch_spec(jshape)
            assert set(got) == set(want)
            for key, w in want.items():
                if w is None:
                    assert got[key] is None
                    continue
                assert got[key].device.type == "meta"
                assert tuple(got[key].shape) == tuple(w.shape), key
                assert str(got[key].dtype).removeprefix("torch.") == str(w.dtype), key
            got_l, want_l = tapi.batch_logical(shape), japi.batch_logical(jshape)
            assert got_l == {k: None if v is None else strip(v) for k, v in want_l.items()}

    def test_opt_state_specs(self):
        mesh = cpu_mesh((2, 2))
        ps = {"a": (mesh, ("data",)), "b": (mesh, ())}
        assert topt.opt_state_specs(ps) == {"mu": ps, "nu": ps, "step": (mesh, ())}
        assert topt.opt_state_specs({})["step"] == ()

    def test_constrain_checks_the_rank(self):
        x = torch.zeros(2, 3, 4)
        assert trules.constrain(x, ("batch", "seq", "embed")) is x
        with pytest.raises(ValueError, match="3 logical dims for a tensor of rank 2"):
            trules.constrain(torch.zeros(2, 3), ("batch", "seq", "embed"))


# ---------------------------------------------------------------------------
# Train on a mesh == one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_is_the_one_device_step_on_every_mesh(arch):
    """The one-device step and the sharded step on each mesh side by side
    from the same init; every step's state bit for bit."""
    shape = ShapeConfig("t", "train", 16, 4)
    tc = TrainConfig(warmup_steps=1, learning_rate=1e-3, steps=4)
    cfg = tconfigs.smoke_config(arch)
    api = tzoo.get_model(cfg)
    model, params, opt = tloop.init_train_state(cfg, tc, shape.seq_len, "cpu")
    one = topt.make_train_step(api.loss_fn, tc)
    runs = []
    with trules.use_rules(trules.DEFAULT_RULES.replace(**dict(cfg.sharding_overrides))):
        for mesh_shape in TRAIN_MESHES:
            mesh = cpu_mesh(mesh_shape)
            mmodel, mparams, mopt, param_sh = tloop.build_sharded_train_state(
                api, mesh, tc, shape.seq_len)
            step_fn, batch_sh = tloop.make_sharded_step(api, mesh, tc, shape, param_sh)
            assert set(batch_sh) == set(api.batch_logical(shape))
            assert_same_state(params, opt, mparams, mopt)
            runs.append([step_fn, mmodel, mparams, mopt])
    for step in range(2):
        batch = tloop.data_lib.batch_for_step(step, cfg, shape, tc.seed, tc.microbatches, "cpu")
        params, opt, m1 = one(model, params, opt, batch)
        for run in runs:
            step_fn, mmodel, mparams, mopt = run
            mparams, mopt, m2 = step_fn(mmodel, mparams, mopt, batch)
            run[2:] = [mparams, mopt]
            assert float(m1["loss"]) == float(m2["loss"])
            assert float(m1["grad_norm"]) == float(m2["grad_norm"])
            assert_same_state(params, opt, mparams, mopt)
            for name in mparams:
                for arr in (mparams[name], mopt["mu"][name], mopt["nu"][name]):
                    assert_replicas_equal(arr)
            for (name, p), (_, q) in zip(model.named_parameters(),
                                         mmodel.named_parameters()):
                assert torch.equal(p, q), name


@pytest.mark.parametrize("microbatches,grad_dtype", [(1, "float32"), (1, "bfloat16"),
                                                     (2, "float32"), (2, "bfloat16")])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_on_a_mesh_is_train_without(tmp_path, family, microbatches, grad_dtype):
    cfg = tconfigs.smoke_config(FAMILIES[family])
    shape = ShapeConfig("t", "train", 16, 4)
    tc = TrainConfig(steps=3, warmup_steps=1, learning_rate=1e-3, microbatches=microbatches,
                     grad_dtype=grad_dtype, checkpoint_every=0)
    outs = []
    for i, mesh in enumerate((None, cpu_mesh((2, 2)))):
        run = dataclasses.replace(tc, checkpoint_dir=str(tmp_path / str(i)))
        outs.append(tloop.train(cfg, shape, run, device="cpu" if mesh is None else None,
                                mesh=mesh, log_every=100))
    plain, meshed = outs
    assert plain["history"] == meshed["history"]
    for name, t in plain["masters"].items():
        assert torch.equal(t, gather(meshed["masters"][name], "cpu")), name
        assert_replicas_equal(meshed["masters"][name])
    for (name, p), (_, q) in zip(plain["params"].named_parameters(),
                                 meshed["params"].named_parameters()):
        assert torch.equal(p, q), name
    assert torch.equal(plain["params"].head_source, meshed["params"].head_source)
    assert set(meshed["batch_shardings"]) == set(tzoo.get_model(cfg).batch_logical(shape))
    # one save each: the archives' members hold the same bytes
    assert members(tmp_path / "0" / "ckpt_00000003.npz") == \
        members(tmp_path / "1" / "ckpt_00000003.npz")


def members(path) -> dict:
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


def test_train_on_a_mesh_refuses_another_device(tmp_path):
    tc = TrainConfig(steps=1, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="not the mesh's first position"):
        tloop.train(tconfigs.smoke_config("smollm_360m"), ShapeConfig("t", "train", 8, 2), tc,
                    device="cuda", mesh=cpu_mesh((1, 1)))


def test_sharded_step_matches_the_references_train_on_auto_axis_meshes(reference):
    """The reference's ``train`` on (1, 1), (2, 2) and (4, 2) meshes agree
    with each other within an ulp; the port's sharded step, started from the
    reference's init on its batches, gives those losses within 1e-5."""
    cfg, jcfg = tconfigs.smoke_config("smollm_360m"), jconfigs.smoke_config("smollm_360m")
    b, s = REF_SHAPE
    shape = ShapeConfig("t", "train", s, b)
    tc = TrainConfig(**REF_TC)
    want = {k: reference[f"train_losses_{k}"] for k in ("1x1", "2x2", "4x2")}
    for losses in want.values():
        np.testing.assert_allclose(losses, want["1x1"], rtol=1e-6)
    api = tzoo.get_model(cfg)
    masters = named_from_reference(nested(reference, "train_init:"))
    for mesh_shape in ((2, 2), (4, 2)):
        mesh = cpu_mesh(mesh_shape)
        param_sh = trules.shard_params(masters, api.param_specs(), mesh)
        params, opt = tloop.shard_train_state(masters, param_sh)
        model = api.build("cpu", s)
        topt.load_masters(model, params)
        step_fn, _ = tloop.make_sharded_step(api, mesh, tc, shape, param_sh)
        got = []
        for step in range(tc.steps):
            jb = jdata.batch_for_step(step, jcfg, jbase.ShapeConfig("t", "train", s, b), 0,
                                      tc.microbatches)
            params, opt, m = step_fn(model, params, opt, tbatch(jb))
            got.append(float(m["loss"]))
        np.testing.assert_allclose(got, want["1x1"], rtol=REF_LOSS_RTOL)


# ---------------------------------------------------------------------------
# Elastic restore
# ---------------------------------------------------------------------------

def test_a_checkpoint_saved_on_one_mesh_resumes_on_any_other(tmp_path):
    cfg = tconfigs.smoke_config("smollm_360m")
    shape = ShapeConfig("t", "train", 16, 4)
    tc = TrainConfig(steps=4, warmup_steps=1, learning_rate=1e-3, checkpoint_every=2,
                     checkpoint_dir=str(tmp_path / "full"))
    full = tloop.train(cfg, shape, tc, mesh=cpu_mesh((2, 2)), log_every=100)
    assert CheckpointManager(tc.checkpoint_dir).all_steps() == [2, 4]
    for i, target in enumerate(((4, 1), (1, 1), None)):
        part = tmp_path / f"part{i}"
        part.mkdir()
        shutil.copy(tmp_path / "full" / "ckpt_00000002.npz", part)
        again = tloop.train(cfg, shape, dataclasses.replace(tc, checkpoint_dir=str(part)),
                            device="cpu" if target is None else None,
                            mesh=None if target is None else cpu_mesh(target), log_every=100)
        assert again["history"] == full["history"][2:], target
        for name, arr in full["masters"].items():
            got = again["masters"][name]
            got = got if target is None else gather(got, "cpu")
            assert torch.equal(got, gather(arr, "cpu")), (target, name)
        # the final saves hold the same bytes whatever the mesh
        assert members(part / "ckpt_00000004.npz") == \
            members(tmp_path / "full" / "ckpt_00000004.npz")


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2), (1, 4)])
def test_restored_pieces_have_the_references_shard_shape(tmp_path, mesh_shape):
    cfg, jcfg = tconfigs.smoke_config("whisper_small"), jconfigs.smoke_config("whisper_small")
    api, japi = tzoo.get_model(cfg), jzoo.get_model(jcfg)
    tc = TrainConfig()
    model, masters, opt = tloop.init_train_state(cfg, tc, 8, "cpu")
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"params": masters, "opt": opt})
    mesh = cpu_mesh(mesh_shape)
    param_sh = trules.shard_params(masters, api.param_specs(), mesh)
    like = {"params": masters, "opt": opt}
    _, state = mgr.restore(like, shardings={"params": param_sh,
                                            "opt": topt.opt_state_specs(param_sh)})
    amesh = AbstractMesh(mesh_shape, ("data", "model"))
    abstract = jax.eval_shape(lambda: japi.init_params(jax.random.key(0), 8))
    want = reference_named(jrules.shard_params(abstract, japi.param_specs(), amesh),
                           masters, is_leaf=is_sharding)
    for name, arr in state["params"].items():
        ax = stacked_axes(name)
        spec = PartitionSpec(*tuple(want[name].spec)[ax:])
        ref_shape = NamedSharding(amesh, spec).shard_shape(tuple(masters[name].shape))
        for piece in arr.pieces.values():
            assert tuple(piece.shape) == ref_shape, name
        for m in ("mu", "nu"):
            assert torch.equal(gather(state["opt"][m][name], "cpu"), opt[m][name])
        assert torch.equal(gather(arr, "cpu"), masters[name])
        assert len({p.data_ptr() for p in arr.pieces.values()}) == mesh.size   # no aliases
    assert {int(p) for p in state["opt"]["step"].pieces.values()} == {0}


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

def test_pipeline_applicability_rules():
    get = tconfigs.get_config
    assert tpipeline.pipeline_applicable(get("granite_8b"), 4)       # 36 % 4 == 0
    assert tpipeline.pipeline_applicable(get("qwen2_72b"), 4)        # 80 % 4 == 0
    assert not tpipeline.pipeline_applicable(get("mixtral_8x7b"), 4)   # MoE
    assert not tpipeline.pipeline_applicable(get("granite_8b"), 7)   # 36 % 7 != 0
    for arch in ARCHS:
        for s in (1, 2, 3, 4, 7, 8):
            assert (tpipeline.pipeline_applicable(get(arch), s)
                    == jpipeline.pipeline_applicable(jconfigs.get_config(arch), s))
    assert tpipeline.PIPELINE_RULES_OVERRIDE == jpipeline.PIPELINE_RULES_OVERRIDE
    cfg = tconfigs.smoke_config("granite_8b")
    want = jpipeline.pipeline_param_specs(jconfigs.smoke_config("granite_8b"))
    flat = {jax.tree_util.keystr(p): strip(v)
            for p, v in jax.tree_util.tree_leaves_with_path(want, is_leaf=is_spec)}
    got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(
        tpipeline.pipeline_param_specs(cfg), is_leaf=lambda x: isinstance(x, tuple))}
    assert got == flat


def pipe_cfg(remat="full"):
    return dataclasses.replace(tconfigs.smoke_config("granite_8b"), num_layers=4, remat=remat)


def pipe_batch(cfg):
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32))
            for k in ("tokens", "labels")}


def grads_of(model, loss_fn):
    names, weights = zip(*model.named_parameters())
    for w in weights:
        w.requires_grad_(True)
    try:
        loss = loss_fn()
        return float(loss), dict(zip(names, torch.autograd.grad(loss, weights)))
    finally:
        for w in weights:
            w.requires_grad_(False)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("microbatches", [1, 4, 8])
@pytest.mark.parametrize("stages", [1, 2, 4])
def test_pipelined_loss_equals_the_sequential_loss(stages, microbatches, remat):
    cfg = pipe_cfg(remat)
    model = tzoo.get_model(cfg).init_params(torch.Generator().manual_seed(0), 32)
    batch = pipe_batch(cfg)
    mesh = cpu_mesh((stages, 2, 1), ("stage", "data", "model"))
    want_loss, want = grads_of(model, lambda: model.loss_fn(batch))
    got_loss, got = grads_of(model, lambda: tpipeline.pipelined_loss_fn(
        model, cfg, batch, mesh, microbatches))
    assert got_loss == pytest.approx(want_loss, rel=PIPE_LOSS_RTOL)
    for name, g in want.items():
        assert float((got[name] - g).abs().max()) < PIPE_GRAD_ATOL, name
    assert [list(r) for _, r in tpipeline.stages(cfg, mesh)] == \
        [list(range(s * 4 // stages, (s + 1) * 4 // stages)) for s in range(stages)]


def test_pipelined_loss_matches_the_references_on_an_auto_axis_mesh(reference):
    cfg = pipe_cfg()
    model = params_from_reference(nested(reference, "pipe_init:"), cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(reference["pipe_tokens"]),
             "labels": torch.from_numpy(reference["pipe_labels"])}
    mesh = cpu_mesh((4, 2, 2), ("stage", "data", "model"))
    loss, grads = grads_of(model, lambda: tpipeline.pipelined_loss_fn(model, cfg, batch,
                                                                      mesh, 4))
    assert loss == pytest.approx(float(reference["pipe_loss"]), rel=PIPE_LOSS_RTOL)
    got = tree_to_reference(grads)
    want = nested(reference, "pipe_grad:")
    flat_got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(got)}
    flat_want = {jax.tree_util.keystr(p): v
                 for p, v in jax.tree_util.tree_leaves_with_path(want)}
    assert set(flat_got) == set(flat_want)
    worst = max(float(np.abs(flat_got[k] - flat_want[k]).max()) for k in flat_want)
    assert worst < PIPE_GRAD_ATOL, worst


def test_pipeline_assertion_texts():
    cfg = pipe_cfg()
    model = tzoo.get_model(cfg).init_params(torch.Generator().manual_seed(0), 32)
    batch = pipe_batch(cfg)
    with pytest.raises(AssertionError, match="arch not pipeline-applicable"):
        tpipeline.pipelined_loss_fn(model, cfg, batch,
                                    cpu_mesh((3, 1, 1), ("stage", "data", "model")), 1)
    with pytest.raises(AssertionError, match="global batch must divide into microbatches"):
        tpipeline.pipelined_loss_fn(model, cfg, batch,
                                    cpu_mesh((2, 1, 1), ("stage", "data", "model")), 3)


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

def test_launch_train_on_a_host_mesh(tmp_path, capsys):
    out = launch_train.main(["--arch", "smollm-360m", "--smoke", "--steps", "3", "--batch",
                             "2", "--seq", "16", "--device", "cpu", "--mesh", "host",
                             "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"])
    assert np.isfinite(out["history"]).all() and len(out["history"]) == 3
    mesh, _ = next(iter(out["param_shardings"].values()))
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device_type == "cpu"
    assert f"final loss: {out['final_loss']:.4f}" in capsys.readouterr().out


@pytest.mark.parametrize("flags,match", [
    (["--model-parallel", "2"], "needs a positive multiple of model=2 devices, have 1"),
    (["--mesh", "production"], "the production mesh needs 256 devices"),
    (["--mesh", "production-multipod"], "the production mesh needs 512 devices"),
])
def test_launch_train_refuses_a_mesh_it_cannot_build(tmp_path, flags, match):
    with pytest.raises(ValueError, match=match):
        launch_train.main(["--arch", "smollm-360m", "--smoke", "--steps", "1", "--device",
                           "cpu", "--checkpoint-dir", str(tmp_path), *flags])
