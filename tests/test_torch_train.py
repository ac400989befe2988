"""The port's training path against the reference, on the CPU.

The same seeded inputs go through ``repro`` and ``repro_torch``
(``device="cpu"``): reference params from ``jax.random.key(0)`` carried
across with ``convert.params_from_reference`` (the model) and
``named_from_reference`` (the float32 masters); gradients, masters and
moments come back with ``tree_to_reference``.

- Optimizer: the cases of ``test_train_substrate.py`` on the port
  (quadratic convergence, the norm reported before clipping, K microbatches
  == one batch), and ``lr_at`` / ``adamw_update`` against the reference's
  on random trees.
- Gradients: all ten smoke configs' loss and gradients against
  ``jax.value_and_grad(api.loss_fn)`` at float32 (loss within 1e-5; each
  leaf within ``GRAD_TOL`` of max(its max |g|, 1e-3): Whisper's key biases
  have a gradient that is zero in exact arithmetic, so both packages return
  noise there), and at bfloat16 for dense and vlm (loss ``BF16_LOSS_TOL``,
  gradients ``BF16_GRAD_TOL`` of the leaf's max; a bf16 ulp can flip a MoE
  router choice, as in ``test_torch_models.py``).  ``remat`` "full" and
  "dots" give the gradients of "none" bit for bit.
- Train steps: four steps of ``make_train_step`` (microbatches 1 and 2,
  ``grad_dtype`` float32 and bfloat16) against the reference's on its
  batches, with a checkpoint round trip after step 2: loss, gradient norm,
  masters (absolute tolerance a multiple of ``lr``: Adam magnifies
  gradient differences near its 1e-8) and moments.
- ``batch_for_step``, ``CheckpointManager``, the watchdog and timer.
- ``train`` at smoke size: the loss falls, a resume runs only the remaining
  steps and its history equals the uninterrupted run's; beside it the
  reference's ``train`` through an Auto-axis mesh doing the same.
- ``launch/train.py --device cpu --smoke`` and the four ``examples/torch_*.py``
  at their smallest.
"""
import dataclasses
import importlib.util
import os
import shutil
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.models import model_zoo as jzoo
from repro.train import data as jdata
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.convert import (named_from_reference, opt_state_from_reference,
                                 params_from_reference, tree_to_reference)
from repro_torch.launch import train as launch_train
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttransformer
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import parity
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import StepTimer, StepWatchdog
from repro_torch.train.loop import train

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["qwen25_3b", "granite_8b", "smollm_360m", "qwen2_72b", "internvl2_2b",
         "mixtral_8x7b", "phi35_moe", "zamba2_7b", "xlstm_350m", "whisper_small"]
B, SEQ = 2, 32
# f32 gradients: each leaf within GRAD_TOL of max(its max |g|, GRAD_FLOOR)
# (measured: 1.5e-6 to 7.1e-6 over the ten configs).
GRAD_TOL, GRAD_FLOOR = 1e-5, 1e-3
LOSS_TOL = 1e-5
# bf16 (dense, vlm): loss and gradients (measured: 1.6e-3 and 0.017-0.025).
BF16_LOSS_TOL, BF16_GRAD_TOL = 1e-2, 0.1


def t2n(x):
    return x.detach().float().cpu().numpy()


def jcfg_of(arch, **over):
    return dataclasses.replace(jconfigs.smoke_config(arch), **over)


def tcfg_of(arch, **over):
    return dataclasses.replace(tconfigs.smoke_config(arch), **over)


def batch_for(cfg, seed=0):
    """Tokens and labels (B, SEQ), with prefix embeddings for the vlm family
    and frame embeddings (B, 12, D) for the audio family."""
    rng = np.random.default_rng(seed)
    text = SEQ - cfg.frontend_tokens if cfg.family == "vlm" else SEQ
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, text)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, text)).astype(np.int32)}
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frame_embeds"] = rng.standard_normal((B, 12, cfg.d_model)).astype(np.float32)
    return out


def jbatch(batch, cfg):
    return {k: (jnp.asarray(v, jnp.dtype(cfg.dtype)) if v.dtype == np.float32
                else jnp.asarray(v)) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def port_grads(model, loss_fn, batch):
    """(loss, {name: gradient}) of the port's loss on ``model``."""
    names, weights = zip(*model.named_parameters())
    for w in weights:
        w.requires_grad_(True)
    loss = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, weights)
    for w in weights:
        w.requires_grad_(False)
    return loss.detach(), dict(zip(names, grads))


def leaves(tree):
    """{path: float32 array} of a nested tree (the reference's or
    ``tree_to_reference``'s)."""
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def worst_leaf_error(got, want, floor=GRAD_FLOOR):
    """max over leaves of max|got - want| / max(max|want|, floor), and its leaf."""
    got, want = leaves(got), leaves(want)
    assert got.keys() == want.keys()
    errs = {k: float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), floor)
            for k, w in want.items()}
    name = max(errs, key=errs.get)
    return errs[name], name


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

class TestOptimizer:
    def test_adamw_converges_quadratic(self):
        tc = TrainConfig(learning_rate=0.1, warmup_steps=1, steps=100, weight_decay=0.0,
                         grad_clip=10.0)
        params = {"w": torch.tensor([5.0, -3.0])}
        opt = topt.init_opt_state(params)
        for _ in range(100):
            params, opt, _ = topt.adamw_update(params, {"w": 2 * params["w"]}, opt, tc)
        assert float(params["w"].abs().max()) < 0.5

    def test_grad_clip_reports_the_norm_before_clipping(self):
        tc = TrainConfig(grad_clip=1.0)
        params = {"w": torch.zeros(3)}
        _, _, m = topt.adamw_update(params, {"w": torch.full((3,), 100.0)},
                                    topt.init_opt_state(params), tc)
        assert float(m["grad_norm"]) == pytest.approx(100.0 * 3 ** 0.5, rel=1e-6)

    def test_microbatch_equivalence(self):
        """K microbatches of B/K == one batch of B (fp32 accumulation), on the
        port's own init and batch; the reference's tolerances."""
        cfg = tconfigs.smoke_config("smollm_360m")
        api = tzoo.get_model(cfg)
        shape = ShapeConfig("t", "train", 16, 4)
        batch = tdata.batch_for_step(0, cfg, shape, seed=0, device="cpu")
        out = []
        for mb in (1, 2):
            model = api.init_params(torch.Generator().manual_seed(0), 16)
            masters = {n: p.detach().clone() for n, p in model.named_parameters()}
            step = topt.make_train_step(api.loss_fn, TrainConfig(microbatches=mb))
            b = batch if mb == 1 else {k: v.reshape(2, 2, *v.shape[1:])
                                       for k, v in batch.items()}
            out.append(step(model, masters, topt.init_opt_state(masters), b))
        (p1, _, m1), (p2, _, m2) = out
        assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
        for name in p1:
            np.testing.assert_allclose(t2n(p1[name]), t2n(p2[name]), rtol=1e-4, atol=1e-6)

    def test_lr_at_matches_the_reference(self):
        for tc in (TrainConfig(), TrainConfig(learning_rate=1e-3, warmup_steps=7, steps=50),
                   TrainConfig(warmup_steps=0, steps=1)):
            jtc = jbase.TrainConfig(**dataclasses.asdict(tc))
            for step in range(0, 130, 3):
                want = float(jopt.lr_at(jnp.int32(step), jtc))
                got = float(topt.lr_at(torch.tensor(step, dtype=torch.int32), tc))
                assert got == pytest.approx(want, rel=1e-6, abs=1e-12)

    def test_adamw_update_matches_the_reference(self):
        """Three updates on a random tree (clipping on in two: the gradients'
        norm is above ``grad_clip``): params within 1e-6 + 1e-5 relative,
        moments within 1e-8 + 1e-5 relative (a few f32 ulps), the norm within
        1e-6 relative."""
        rng = np.random.default_rng(3)
        shapes = {"a": (5, 7), "b": (11,), "c": (2, 3, 4)}
        tc = TrainConfig(learning_rate=3e-3, warmup_steps=2, steps=10, grad_clip=4.0)
        jtc = jbase.TrainConfig(**dataclasses.asdict(tc))
        np_params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jp, tp = {k: jnp.asarray(v) for k, v in np_params.items()}, {
            k: torch.from_numpy(v.copy()) for k, v in np_params.items()}
        jo, to = jopt.init_opt_state(jp), topt.init_opt_state(tp)
        for scale in (2.0, 0.1, 1.0):
            g = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
            jp, jo, jm = jopt.adamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()}, jo, jtc)
            tp, to, tm = topt.adamw_update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                                           to, tc)
            assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
            assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
            assert int(to["step"]) == int(jo["step"])
            for k in shapes:
                np.testing.assert_allclose(t2n(tp[k]), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)
                for m in ("mu", "nu"):
                    np.testing.assert_allclose(t2n(to[m][k]), np.asarray(jo[m][k]),
                                               rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# Gradients through the ten configs
# ---------------------------------------------------------------------------

def grad_pair(arch, dtype):
    """(reference loss, reference grads, port loss, port grads as a tree)."""
    jcfg, tcfg = jcfg_of(arch, dtype=dtype), tcfg_of(arch, dtype=dtype)
    api = jzoo.get_model(jcfg)
    params = api.init_params(jax.random.key(0), SEQ)
    batch = batch_for(jcfg)
    jl, jg = jax.jit(jax.value_and_grad(api.loss_fn))(params, jbatch(batch, jcfg))
    model = params_from_reference(params, tcfg, device="cpu")
    loss, grads = port_grads(model, tzoo.get_model(tcfg).loss_fn, tbatch(batch))
    return float(jl), jg, float(loss), tree_to_reference(grads)


class TestGradients:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_f32_loss_and_gradients_match_the_reference(self, arch):
        jl, jg, tl, tg = grad_pair(arch, "float32")
        assert tl == pytest.approx(jl, abs=LOSS_TOL)
        err, leaf = worst_leaf_error(tg, jg)
        assert err <= GRAD_TOL, f"{arch}: {leaf} off by {err:.3g} of its scale"

    @pytest.mark.parametrize("arch", ["qwen25_3b", "smollm_360m", "internvl2_2b"])
    def test_bf16_loss_and_gradients_match_the_reference(self, arch):
        jl, jg, tl, tg = grad_pair(arch, "bfloat16")
        assert tl == pytest.approx(jl, abs=BF16_LOSS_TOL)
        err, leaf = worst_leaf_error(tg, jg)
        assert err <= BF16_GRAD_TOL, f"{arch}: {leaf} off by {err:.3g} of its scale"

    @pytest.mark.parametrize("arch", ["smollm_360m", "mixtral_8x7b", "internvl2_2b",
                                      "zamba2_7b", "xlstm_350m", "whisper_small"])
    def test_remat_gives_the_gradients_of_none_bitwise(self, arch):
        batch = tbatch(batch_for(tcfg_of(arch)))
        params = jzoo.get_model(jcfg_of(arch)).init_params(jax.random.key(0), SEQ)
        out = {}
        for mode in ("none", "full", "dots"):
            cfg = tcfg_of(arch, remat=mode)
            model = params_from_reference(params, cfg, device="cpu")
            out[mode] = port_grads(model, tzoo.get_model(cfg).loss_fn, batch)
        for mode in ("full", "dots"):
            assert torch.equal(out[mode][0], out["none"][0])
            for name, g in out["none"][1].items():
                assert torch.equal(out[mode][1][name], g), f"{mode}: {name}"

    def test_full_remat_recomputes_each_block(self, monkeypatch):
        """Under "full" the backward pass runs every block's forward again
        (and only then: serving runs each block once)."""
        calls = []
        block = ttransformer.Transformer._block
        monkeypatch.setattr(ttransformer.Transformer, "_block",
                            lambda self, *a: calls.append(1) or block(self, *a))
        cfg = tcfg_of("smollm_360m")
        params = jzoo.get_model(jcfg_of("smollm_360m")).init_params(jax.random.key(0), SEQ)
        model = params_from_reference(params, cfg, device="cpu")
        batch = tbatch(batch_for(cfg))
        port_grads(model, tzoo.get_model(cfg).loss_fn, batch)
        assert len(calls) == 2 * cfg.num_layers
        calls.clear()
        with torch.no_grad():
            model.loss_fn(batch)
        assert len(calls) == cfg.num_layers


# ---------------------------------------------------------------------------
# Train steps against the reference's
# ---------------------------------------------------------------------------

# Four steps at lr 1e-3 (smollm smoke, 4 x 16 tokens).  Measured: f32
# gradients: loss 1e-6, the norm 2e-7 relative, masters 0.0034 lr, moments
# 3e-6 of the leaf's max; bf16 gradients (both packages round each gradient
# to bf16, from differently rounded products, so a near-zero element's step
# can flip sign and move it by up to 2 lr): loss 3.2e-5, the norm 5.5e-4,
# masters 1.07 lr, moments 0.017.
STEP_LR = parity.STEP_LR
STEP_TOL = {"float32": {"loss": parity.STEP_TOL["loss"], "norm": 1e-5,
                        "masters": parity.STEP_TOL["masters_lr"] * STEP_LR,
                        "moments": parity.STEP_TOL["moments_rel"]},
            "bfloat16": {"loss": 2e-4, "norm": 2e-3, "masters": 2.0 * STEP_LR,
                         "moments": 0.05}}


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_the_reference(tmp_path, microbatches, grad_dtype):
    arch = "smollm_360m"
    jcfg, tcfg = jcfg_of(arch), tcfg_of(arch)
    shape = ShapeConfig("t", "train", 16, 4)
    tc = TrainConfig(learning_rate=STEP_LR, warmup_steps=2, steps=4,
                     microbatches=microbatches, grad_dtype=grad_dtype)
    tol = STEP_TOL[grad_dtype]
    japi = jzoo.get_model(jcfg)
    params = japi.init_params(jax.random.key(0), 16)
    jo = jopt.init_opt_state(params)
    jstep = jax.jit(jopt.make_train_step(japi.loss_fn, jbase.TrainConfig(
        **dataclasses.asdict(tc))))
    model = params_from_reference(params, tcfg, device="cpu")
    masters, opt = named_from_reference(params), opt_state_from_reference(jo)
    step_fn = topt.make_train_step(tzoo.get_model(tcfg).loss_fn, tc)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    for step in range(4):
        jb = jdata.batch_for_step(step, jcfg, shape, 0, microbatches)
        params, jo, jm = jstep(params, jo, jb)
        masters, opt, tm = step_fn(model, masters, opt, tbatch(jb))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), abs=tol["loss"])
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=tol["norm"])
        assert int(opt["step"]) == int(jo["step"]) == step + 1
        got, want = leaves(tree_to_reference(masters)), leaves(params)
        worst = max(float(np.abs(got[k] - want[k]).max()) for k in want)
        assert worst <= tol["masters"], f"step {step}: masters off by {worst / STEP_LR:.3g} lr"
        for m in ("mu", "nu"):
            err, leaf = worst_leaf_error(tree_to_reference(opt[m]), jo[m], floor=1e-12)
            assert err <= tol["moments"], f"step {step}: {m} {leaf} off by {err:.3g}"
        if step == 1:       # a checkpoint round trip between steps 2 and 3
            mgr.save(2, {"params": masters, "opt": opt})
            _, state = mgr.restore({"params": masters, "opt": opt})
            for name, t in state["params"].items():
                assert torch.equal(t, masters[name])
            masters, opt = state["params"], state["opt"]
            topt.load_masters(model, masters)



def test_step_parity_on_the_cpu_is_exact():
    """``parity.step_vs_cpu`` (the card-vs-CPU step check of the card tests
    and ``chip_smoke.py``) reports no difference for the CPU against itself."""
    diffs = parity.step_vs_cpu("cpu")
    assert {k: diffs[k] for k in parity.STEP_TOL} == {k: 0.0 for k in parity.STEP_TOL}
    assert diffs["masters_on_device"] and diffs["model_refreshed"]

# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

class TestData:
    shape = ShapeConfig("t", "train", 16, 4)

    def test_deterministic_across_calls(self):
        cfg = tconfigs.smoke_config("granite_8b")
        b1 = tdata.batch_for_step(7, cfg, self.shape, seed=3, device="cpu")
        b2 = tdata.batch_for_step(7, cfg, self.shape, seed=3, device="cpu")
        assert torch.equal(b1["tokens"], b2["tokens"]) and torch.equal(b1["labels"],
                                                                       b2["labels"])

    def test_distinct_steps_and_seeds(self):
        cfg = tconfigs.smoke_config("granite_8b")
        b1 = tdata.batch_for_step(1, cfg, self.shape, device="cpu")
        b2 = tdata.batch_for_step(2, cfg, self.shape, device="cpu")
        b3 = tdata.batch_for_step(1, cfg, self.shape, seed=1, device="cpu")
        assert not torch.equal(b1["tokens"], b2["tokens"])
        assert not torch.equal(b1["tokens"], b3["tokens"])

    def test_labels_are_shifted_tokens(self):
        cfg = tconfigs.smoke_config("granite_8b")
        b = tdata.batch_for_step(0, cfg, self.shape, device="cpu")
        assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    @pytest.mark.parametrize("arch", ["granite_8b", "internvl2_2b", "whisper_small"])
    @pytest.mark.parametrize("microbatches", [1, 2])
    def test_shapes_and_dtypes_match_the_reference(self, arch, microbatches):
        for dtype in ("float32", "bfloat16"):
            jcfg, tcfg = jcfg_of(arch, dtype=dtype), tcfg_of(arch, dtype=dtype)
            shape = ShapeConfig("t", "train", 24, 4)
            want = jdata.batch_for_step(0, jcfg, shape, 0, microbatches)
            got = tdata.batch_for_step(0, tcfg, shape, 0, microbatches, device="cpu")
            assert got.keys() == want.keys()
            for k, t in got.items():
                assert tuple(t.shape) == want[k].shape, k
                assert str(t.dtype).removeprefix("torch.") == want[k].dtype.name, k
            for k in ("prefix_embeds", "frame_embeds"):
                if k in got:
                    assert float(got[k].float().std()) == pytest.approx(0.02, rel=0.1)

    def test_walks_hold_their_stride_with_ten_percent_noise(self):
        """A consecutive pair keeps the sequence's stride when neither token
        is noise: about 0.9**2 = 81% of pairs."""
        cfg = tconfigs.smoke_config("granite_8b")
        toks = tdata.batch_for_step(0, cfg, ShapeConfig("t", "train", 512, 64),
                                    device="cpu")["tokens"].numpy().astype(np.int64)
        diffs = (toks[:, 1:] - toks[:, :-1]) % cfg.vocab_size
        stride = np.array([np.bincount(d).argmax() for d in diffs])
        assert set(stride.tolist()) <= {1, 2, 3, 4}
        frac = float(np.mean(diffs == stride[:, None]))
        assert 0.78 <= frac <= 0.84
        assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

class TestCheckpoint:
    def state(self):
        return {"a": torch.arange(5.0), "b": {"c": torch.ones((2, 3), dtype=torch.bfloat16),
                                              "d": torch.tensor(7, dtype=torch.int32)}}

    def test_roundtrip_keeps_bf16_bits(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
        state = self.state()
        state["b"]["c"] = torch.randn(2, 3).to(torch.bfloat16)
        mgr.save(3, state)
        step, back = mgr.restore(state)
        assert step == 3
        assert torch.equal(back["a"], state["a"]) and torch.equal(back["b"]["d"], state["b"]["d"])
        assert back["b"]["d"].shape == () and back["b"]["d"].dtype == torch.int32
        assert back["b"]["c"].dtype == torch.bfloat16
        assert torch.equal(back["b"]["c"].view(torch.int16), state["b"]["c"].view(torch.int16))

    def test_host_copy_is_taken_before_the_hand_off(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        state = {"x": torch.zeros(1000)}
        mgr.save(1, state)
        state["x"].fill_(5.0)                   # the caller updates in place
        mgr.wait()
        assert float(mgr.restore(state)[1]["x"].abs().max()) == 0.0

    def test_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
        for s in (1, 2, 3, 4):
            mgr.save(s, {"x": torch.tensor([s])})
        assert mgr.all_steps() == [3, 4]
        assert int(mgr.restore({"x": torch.tensor([0])}, step=3)[1]["x"]) == 3

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
        mgr.save(1, {"x": torch.ones(1000)})
        mgr.wait()
        assert mgr.latest_step() == 1

    def test_structure_mismatch_rejected(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(1, {"x": torch.ones(3)})
        with pytest.raises(ValueError, match="leaves"):
            mgr.restore({"x": torch.ones(3), "y": torch.ones(2)})
        with pytest.raises(ValueError, match="shape"):
            mgr.restore({"x": torch.ones(4)})

    def test_stray_tmp_is_ignored(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(1, {"x": torch.ones(3)})
        (tmp_path / "ckpt_00000002.npz.tmp").write_bytes(b"torn")
        assert mgr.all_steps() == [1] and mgr.latest_step() == 1
        assert mgr.restore({"x": torch.ones(3)})[0] == 1

    def test_no_checkpoint_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            CheckpointManager(str(tmp_path)).restore({"x": torch.ones(1)})


# ---------------------------------------------------------------------------
# Fault tolerance
# ---------------------------------------------------------------------------

class TestFaultTolerance:
    def test_watchdog_fires(self):
        wd = StepWatchdog(0.05)
        with wd:
            time.sleep(0.15)
        assert wd.fired

    def test_watchdog_no_false_positive(self):
        wd = StepWatchdog(5.0)
        with wd:
            pass
        assert not wd.fired

    def test_step_timer_outliers(self):
        t = StepTimer(outlier_factor=2.0)
        for _ in range(10):
            t.record(1.0)
        assert t.record(5.0) is True
        assert t.outliers == 1


# ---------------------------------------------------------------------------
# The loop, the launcher and the examples
# ---------------------------------------------------------------------------

def test_train_loss_falls_and_a_resume_runs_the_remaining_steps(tmp_path):
    """8 steps uninterrupted (checkpoint at 4); a fresh directory holding only
    step 4's checkpoint resumes and runs steps 4-7 with the same losses,
    bit for bit (the CPU is deterministic)."""
    cfg, shape = tconfigs.smoke_config("smollm_360m"), ShapeConfig("t", "train", 32, 4)
    full, part = tmp_path / "full", tmp_path / "part"
    tc = TrainConfig(steps=8, warmup_steps=2, learning_rate=1e-3, checkpoint_every=4,
                     checkpoint_dir=str(full))
    out = train(cfg, shape, tc, device="cpu", log_every=100)
    assert len(out["history"]) == 8 and np.isfinite(out["history"]).all()
    assert out["final_loss"] < out["history"][0]
    assert CheckpointManager(str(full)).all_steps() == [4, 8]
    part.mkdir()
    shutil.copy(full / "ckpt_00000004.npz", part)
    again = train(cfg, shape, dataclasses.replace(tc, checkpoint_dir=str(part)),
                  device="cpu", log_every=100)
    assert again["history"] == out["history"][4:]
    for name, p in again["masters"].items():
        assert torch.equal(p, out["masters"][name])
    # The model holds the final masters in its dtype, and its head source.
    for name, p in again["params"].named_parameters():
        assert torch.equal(p, out["masters"][name])
    assert torch.equal(again["params"].head_source,
                       out["masters"]["embed.tok"][:cfg.vocab_size])


def test_reference_trains_and_resumes_through_an_auto_axis_mesh(tmp_path):
    """The reference's own end-to-end case, through a mesh with Auto axes
    (its default mesh has Explicit axes, on which jax 0.9.0 fails in
    ``jnp.take``): the port's test above does the same on the port."""
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    shape = jbase.ShapeConfig("t", "train", 32, 4)
    tc = jbase.TrainConfig(steps=6, warmup_steps=2, learning_rate=1e-3, checkpoint_every=3,
                           checkpoint_dir=str(tmp_path))
    out1 = jloop.train(jconfigs.smoke_config("smollm_360m"), shape, tc, mesh=mesh,
                       log_every=100)
    assert out1["final_loss"] < out1["history"][0]
    tc2 = dataclasses.replace(tc, steps=8, checkpoint_every=100)
    out2 = jloop.train(jconfigs.smoke_config("smollm_360m"), shape, tc2, mesh=mesh,
                       log_every=100)
    assert len(out2["history"]) == 2


def test_launch_train_on_the_cpu(tmp_path, capsys):
    out = launch_train.main(["--arch", "smollm-360m", "--smoke", "--steps", "3", "--batch",
                             "2", "--seq", "16", "--device", "cpu", "--microbatches", "2",
                             "--grad-dtype", "bfloat16", "--checkpoint-dir", str(tmp_path),
                             "--checkpoint-every", "2"])
    assert np.isfinite(out["history"]).all() and len(out["history"]) == 3
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]
    assert "final loss:" in capsys.readouterr().out


def test_entry_points_refuse_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        launch_train.main(["--arch", "smollm-360m", "--smoke", "--checkpoint-dir",
                           str(tmp_path)])
    tc = TrainConfig(steps=1, checkpoint_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(tconfigs.smoke_config("smollm_360m"), ShapeConfig("t", "train", 8, 2), tc)
    for name in ("torch_quickstart", "torch_similarity_service", "torch_serve_lm",
                 "torch_train_lm"):
        with pytest.raises(SystemExit):
            load_example(name).main([])


def load_example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_quickstart():
    overlap, expected = load_example("torch_quickstart").main(["--rows", "5000", "--device",
                                                                "cpu"])
    assert overlap >= expected - 0.05


def test_example_similarity_service():
    precision, svc = load_example("torch_similarity_service").main(
        ["--rows", "4000", "--device", "cpu"])
    assert precision >= 0.9 and svc.stats().delta_fraction == 0.0


def test_example_serve_lm():
    res, overlap = load_example("torch_serve_lm").main(["--device", "cpu"])
    assert res.tokens.shape == (4, 12) and 0.0 <= overlap <= 1.0


def test_example_train_lm(monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    out = load_example("torch_train_lm").main(["--steps", "20", "--device", "cpu"])
    assert out["final_loss"] < out["history"][0]
    assert os.listdir(tmp_path / "repro_torch_example_ckpt") == ["ckpt_00000020.npz"]
