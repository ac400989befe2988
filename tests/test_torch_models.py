"""The port's configs and transformer family against the reference, on the CPU.

The same seeded inputs go through ``repro`` and ``repro_torch``
(``device="cpu"``).  Each reference model is built with
``jax.random.key(0)`` and carried across with
``convert.params_from_reference``; token ids and prefix embeddings come
from numpy seeds.

- Configs: every ``ARCH_NAMES`` config (full and ``SMOKE``), ``SHAPES``,
  the registry and ``TopKServiceConfig`` field-equal to the reference's.
- Models (the smoke configs of qwen2.5-3b, granite-8b, smollm-360m (tied),
  qwen2-72b, internvl2-2b (with prefix embeddings), mixtral-8x7b (sliding
  window, wrapped past it), phi3.5-moe, and zamba2-7b, xlstm-350m and
  whisper-small (with frame embeddings), which ``test_torch_families.py``
  covers further): ``decode_step`` logits and cache at every step (and, for
  the transformer, hidden states), ``prefill``, ``loss_fn`` and
  ``count_params_analytic`` (also at full width), within
  rtol = atol = 1e-4 at float32.  ``get_model`` builds all ten configs.  At bfloat16 (smoke widths,
  ``dtype="bfloat16"``, the dense and vlm families) decode logits, prefill
  and loss within rtol = atol = ``BF16_TOL`` (0.1, on logits up to about
  3): both packages round every product to bf16, but XLA fuses elementwise
  chains without the intermediate roundings torch makes, so single bf16
  ulps (2**-8 relative) differ and grow to about 0.04 over two layers.
  The MoE family has no bf16 case: one such ulp can flip a near-tied
  router choice and send a token to another expert.
- Invariants within the port that the reference holds within itself:
  decode matches prefill, int8 KV close to unquantized, the sliding window
  masks far tokens, and the MoE aux value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.configs import topk_spmv as jtopk_cfg
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.configs import topk_spmv as ttopk_cfg
from repro_torch.convert import params_from_reference
from repro_torch.models import layers as L
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import Transformer

TOL = 1e-4
BF16_TOL = 0.1
TRANSFORMER_ARCHS = ["qwen25_3b", "granite_8b", "smollm_360m", "qwen2_72b", "internvl2_2b",
                     "mixtral_8x7b", "phi35_moe"]
ARCHS = TRANSFORMER_ARCHS + ["zamba2_7b", "xlstm_350m", "whisper_small"]
B, SEQ, STEPS = 2, 32, 20      # mixtral's smoke window is 16: 20 steps wrap it


def t2n(x):
    return x.detach().float().cpu().numpy()


def close(got, want, tol=TOL):
    np.testing.assert_allclose(t2n(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


def cfg_of(arch, **over):
    return dataclasses.replace(jconfigs.smoke_config(arch), **over)


def tcfg_of(arch, **over):
    return dataclasses.replace(tconfigs.smoke_config(arch), **over)


def pair(arch, **over):
    """(reference cfg, reference params, port cfg, port model) from key(0)."""
    jcfg, tcfg = cfg_of(arch, **over), tcfg_of(arch, **over)
    params = jzoo.get_model(jcfg).init_params(jax.random.key(0), SEQ)
    return jcfg, params, tcfg, params_from_reference(params, tcfg, device="cpu")


def batch_for(cfg, seed=0, seq=SEQ):
    """Tokens and labels (B, S), with prefix embeddings for the vlm family
    and frame embeddings (B, 12, D) for the audio family."""
    rng = np.random.default_rng(seed)
    text = seq - cfg.frontend_tokens if cfg.family == "vlm" else seq
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
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

class TestConfigs:
    @pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
    def test_full_and_smoke_configs_equal(self, arch):
        assert (dataclasses.asdict(tconfigs.get_config(arch))
                == dataclasses.asdict(jconfigs.get_config(arch)))
        assert (dataclasses.asdict(tconfigs.smoke_config(arch))
                == dataclasses.asdict(jconfigs.smoke_config(arch)))
        cfg = tconfigs.get_config(arch)
        ref = jconfigs.get_config(arch)
        assert (cfg.resolved_head_dim, cfg.padded_vocab, cfg.q_per_kv) == (
            ref.resolved_head_dim, ref.padded_vocab, ref.q_per_kv)

    def test_registry_equal(self):
        assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
        assert tconfigs.ALIASES == jconfigs.ALIASES
        for alias, name in tconfigs.ALIASES.items():
            assert tconfigs.get_config(alias) == tconfigs.get_config(name)
        assert set(tconfigs.all_configs()) == set(jconfigs.all_configs())

    def test_shapes_and_train_config_equal(self):
        assert ({k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()}
                == {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()})
        assert dataclasses.asdict(tbase.TrainConfig()) == dataclasses.asdict(jbase.TrainConfig())
        for arch in tconfigs.ARCH_NAMES:
            for shape in tbase.ALL_SHAPES:
                jshape = jbase.SHAPES[shape.name]
                assert (tbase.shape_applicable(tconfigs.get_config(arch), shape)
                        == jbase.shape_applicable(jconfigs.get_config(arch), jshape))
        assert tbase.pad_to_multiple(151936, 256) == jbase.pad_to_multiple(151936, 256)

    def test_topk_service_config_equal(self):
        assert dataclasses.asdict(ttopk_cfg.CONFIG) == dataclasses.asdict(jtopk_cfg.CONFIG)
        assert dataclasses.asdict(ttopk_cfg.SMOKE) == dataclasses.asdict(jtopk_cfg.SMOKE)


# ---------------------------------------------------------------------------
# Models against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
class TestModelParity:
    def test_decode_step_logits_hidden_and_cache(self, arch):
        jcfg, params, tcfg, model = pair(arch)
        rng = np.random.default_rng(1)
        toks = rng.integers(0, jcfg.vocab_size, (B, STEPS)).astype(np.int32)
        jdecode = jax.jit(jzoo.get_model(jcfg).decode_step)
        jcache = jzoo.get_model(jcfg).init_cache(B, SEQ)
        tcache = tzoo.get_model(tcfg).init_cache(B, SEQ, "cpu")
        assert {k: (tuple(v.shape), v.dtype) for k, v in tcache.items()} == {
            k: (tuple(v.shape), getattr(torch, str(v.dtype))) for k, v in jcache.items()}
        for t in range(STEPS):
            jl, jcache = jdecode(params, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
            tl, tcache = model.decode_step(tcache, torch.from_numpy(toks[:, t:t + 1]), t)
            close(tl, jl)
        for name in jcache:
            close(tcache[name], jcache[name])
        if arch not in TRANSFORMER_ARCHS:      # the hidden-state decode is the transformer's
            return
        nxt = jnp.asarray(toks[:, :1])
        jh, _ = jtransformer.decode_step(params, jcfg, jcache, nxt, jnp.int32(STEPS),
                                         return_hidden=True)
        th, _ = model.decode_step(tcache, torch.from_numpy(toks[:, :1]), STEPS,
                                  return_hidden=True)
        assert th.shape == (B, tcfg.d_model)
        close(th, jh)

    def test_prefill(self, arch):
        jcfg, params, tcfg, model = pair(arch)
        batch = batch_for(jcfg)
        want = jzoo.get_model(jcfg).prefill(params, jbatch(batch, jcfg))
        got = tzoo.get_model(tcfg).prefill(model, tbatch(batch))
        assert got.shape == (B, tcfg.padded_vocab)
        close(got, want)

    def test_loss_fn(self, arch):
        jcfg, params, tcfg, model = pair(arch)
        batch = batch_for(jcfg, seed=2)
        want = jzoo.get_model(jcfg).loss_fn(params, jbatch(batch, jcfg))
        got = tzoo.get_model(tcfg).loss_fn(model, tbatch(batch))
        close(got, want)

    def test_count_params_analytic(self, arch):
        for cfg, tcfg in ((jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)),
                          (jconfigs.get_config(arch), tconfigs.get_config(arch))):
            for active in (False, True):
                assert (tzoo.count_params_analytic(tcfg, active)
                        == jzoo.count_params_analytic(cfg, active))
        cfg = tconfigs.smoke_config(arch)
        extra = (SEQ - 128) * cfg.d_model if cfg.family == "audio" else 0   # dec_pos rows
        assert cfg.param_count() + extra == sum(p.numel() for p in pair(arch)[3].parameters())


@pytest.mark.parametrize("arch", ["qwen25_3b", "granite_8b", "internvl2_2b"])
def test_bfloat16_matches_the_reference(arch):
    """Smoke widths at ``dtype="bfloat16"``: weights held in bf16 (norms in
    f32), decode logits, prefill and loss within ``BF16_TOL``."""
    jcfg, params, tcfg, model = pair(arch, dtype="bfloat16")
    assert model.blocks[0]["attn"]["wq"].dtype == torch.bfloat16
    assert model.blocks[0]["ln1"].dtype == torch.float32
    assert model.embed["tok"].dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (B, 8)).astype(np.int32)
    japi = jzoo.get_model(jcfg)
    jcache, tcache = japi.init_cache(B, SEQ), model.init_cache(B, SEQ)
    assert tcache["k"].dtype == torch.bfloat16
    for t in range(toks.shape[1]):
        jl, jcache = japi.decode_step(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                                      jnp.int32(t))
        tl, tcache = model.decode_step(tcache, torch.from_numpy(toks[:, t:t + 1]), t)
        assert tl.dtype == torch.bfloat16
        close(tl, jl, BF16_TOL)
    batch = batch_for(jcfg, seed=4)
    close(tzoo.get_model(tcfg).prefill(model, tbatch(batch)),
          japi.prefill(params, jbatch(batch, jcfg)), BF16_TOL)
    close(tzoo.get_model(tcfg).loss_fn(model, tbatch(batch)),
          japi.loss_fn(params, jbatch(batch, jcfg)), BF16_TOL)


class TestLayers:
    def test_rms_norm_and_rope(self):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
        w = rng.standard_normal(16).astype(np.float32)
        close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
              jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
        pos = np.arange(5)[None, :] + 3
        close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0),
              jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
        b = rng.standard_normal(16).astype(np.float32)
        close(L.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                           1e-5),
              jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))

    @pytest.mark.parametrize("s,q_chunk,window", [(12, 4, 0), (12, 5, 0), (12, 4, 5)])
    def test_blockwise_attention(self, s, q_chunk, window):
        """Chunked (and the ragged one-chunk fallback) equals the reference."""
        rng = np.random.default_rng(s + q_chunk + window)
        q = rng.standard_normal((2, s, 4, 8)).astype(np.float32)
        k, v = (rng.standard_normal((2, s, 2, 8)).astype(np.float32) for _ in range(2))
        got = L.blockwise_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                                    sliding_window=window, q_chunk=q_chunk)
        want = jlayers.blockwise_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                           sliding_window=window, q_chunk=q_chunk)
        close(got, want)

    def test_cache_insert_quant_rounds_like_the_reference(self):
        """One scale per (b, head, position); halves round to even."""
        rng = np.random.default_rng(6)
        kv = (rng.integers(-254, 255, (2, 1, 3, 8)) / 2.0).astype(np.float32)
        kv[..., 0] = 127.0                       # amax 127: scale 1, kv/s exact halves
        cache = np.zeros((2, 3, 4, 8), np.int8)
        scale = np.zeros((2, 3, 4), np.float32)
        jc, js = jlayers.cache_insert_quant(jnp.asarray(cache), jnp.asarray(scale),
                                            jnp.asarray(kv), 2)
        tc, ts = L.cache_insert_quant(torch.from_numpy(cache.copy()),
                                      torch.from_numpy(scale.copy()), torch.from_numpy(kv), 2)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        close(L.cache_dequant(tc, ts, torch.float32),
              jlayers.cache_dequant(jc, js, jnp.float32))

    def test_lm_logits_masks_padding_and_cross_entropy(self):
        cfg = tconfigs.smoke_config("qwen25_3b")
        jcfg = jconfigs.smoke_config("qwen25_3b")
        cfg = dataclasses.replace(cfg, vocab_size=500)
        jcfg = dataclasses.replace(jcfg, vocab_size=500)
        rng = np.random.default_rng(7)
        p = {"tok": rng.standard_normal((cfg.padded_vocab, 64)).astype(np.float32),
             "out": rng.standard_normal((64, cfg.padded_vocab)).astype(np.float32)}
        x = rng.standard_normal((2, 3, 64)).astype(np.float32)
        got = L.lm_logits({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), cfg)
        want = jlayers.lm_logits({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                 jcfg)
        close(got, want)
        assert (got[..., 500:] == L.NEG_INF).all()
        labels = rng.integers(0, 500, (2, 3))
        mask = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
        close(L.cross_entropy_loss(got, torch.from_numpy(labels), torch.from_numpy(mask)),
              jlayers.cross_entropy_loss(want, jnp.asarray(labels), jnp.asarray(mask)))

    def test_gelu_mlp(self):
        rng = np.random.default_rng(8)
        p = {"w1": rng.standard_normal((16, 32)), "b1": rng.standard_normal(32),
             "w2": rng.standard_normal((32, 16)), "b2": rng.standard_normal(16)}
        p = {k: v.astype(np.float32) for k, v in p.items()}
        x = rng.standard_normal((2, 3, 16)).astype(np.float32)
        close(L.gelu_mlp({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x)),
              jlayers.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))

    @pytest.mark.parametrize("tokens", [4, 300])
    def test_moe_mlp_and_aux(self, tokens):
        """Drop-free (decode-sized) and capacity-limited (over 256 tokens)
        routing, with its aux value, against the reference."""
        jcfg = cfg_of("mixtral_8x7b")
        tcfg = tcfg_of("mixtral_8x7b")
        params = jmoe.init_moe(jax.random.key(1), jcfg, layers=1)
        p = {k: torch.from_numpy(np.array(v[0])) for k, v in params.items()}
        x = np.random.default_rng(tokens).standard_normal((1, tokens, 64)).astype(np.float32)
        jy, jaux = jmoe.moe_mlp({k: v[0] for k, v in params.items()}, jnp.asarray(x), jcfg)
        ty, taux = tmoe.moe_mlp(p, torch.from_numpy(x), tcfg)
        close(ty, jy)
        close(taux, jaux)


# ---------------------------------------------------------------------------
# Invariants within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen25_3b", "granite_8b", "mixtral_8x7b"])
def test_decode_matches_prefill(arch):
    """Greedy next token from step-by-step decode == from full prefill
    (MoE drop-free, as in the reference's test; mixtral's 20 steps wrap its
    16-slot window)."""
    cfg = tcfg_of(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.num_experts))
    model = Transformer(cfg, "cpu").init_params(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, STEPS)))
    pre = model.prefill(toks)
    cache = model.init_cache(B, SEQ)
    if cfg.sliding_window:
        assert cache["k"].shape[3] == cfg.sliding_window < STEPS
    for t in range(STEPS):
        dec, cache = model.decode_step(cache, toks[:, t:t + 1], t)
    np.testing.assert_allclose(t2n(dec), t2n(pre), rtol=2e-3, atol=2e-3)
    assert torch.equal(dec.argmax(-1), pre.argmax(-1))


def test_int8_kv_cache_close_to_unquantized():
    cfg = tcfg_of("granite_8b")
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    model = Transformer(cfg, "cpu").init_params(torch.Generator().manual_seed(0))
    qmodel = Transformer(qcfg, "cpu")
    qmodel.load_state_dict(model.state_dict())
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 8)))
    cache, qcache = model.init_cache(B, SEQ), qmodel.init_cache(B, SEQ)
    assert qcache["k"].dtype == torch.int8 and qcache["k_scale"].dtype == torch.float32
    for t in range(toks.shape[1]):
        lo, cache = model.decode_step(cache, toks[:, t:t + 1], t)
        lq, qcache = qmodel.decode_step(qcache, toks[:, t:t + 1], t)
    np.testing.assert_allclose(t2n(lq), t2n(lo), rtol=0.05, atol=0.05)
    assert torch.equal(lo.argmax(-1), lq.argmax(-1))


def test_kv_quant_matches_the_reference():
    jcfg, params, tcfg, model = pair("granite_8b", kv_quant=True)
    japi = jzoo.get_model(jcfg)
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size, (B, 6)).astype(np.int32)
    jcache, tcache = japi.init_cache(B, SEQ), model.init_cache(B, SEQ)
    for t in range(toks.shape[1]):
        jl, jcache = japi.decode_step(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                                      jnp.int32(t))
        tl, tcache = model.decode_step(tcache, torch.from_numpy(toks[:, t:t + 1]), t)
        close(tl, jl)
    close(tcache["k_scale"], jcache["k_scale"])
    # int8 planes: equal but where a value sits on a rounding boundary
    assert (tcache["k"].numpy().astype(int) - np.asarray(jcache["k"]).astype(int)).max() <= 1


def test_sliding_window_masks_far_tokens():
    """A key more than ``window`` positions back changes nothing; one inside does."""
    rng = np.random.default_rng(10)
    s, w = 12, 4
    q = torch.from_numpy(rng.standard_normal((1, s, 2, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, s, 1, 8)).astype(np.float32))
            for _ in range(2))
    base = L.blockwise_attention(q, k, v, causal=True, sliding_window=w)
    k2, v2 = k.clone(), v.clone()
    k2[:, 0] += 10.0
    v2[:, 0] += 10.0
    moved = L.blockwise_attention(q, k2, v2, causal=True, sliding_window=w)
    assert torch.equal(moved[:, w:], base[:, w:])
    assert not torch.allclose(moved[:, :w], base[:, :w])


def test_moe_aux_is_one_under_a_uniform_router():
    """Switch aux = E * sum(mean prob * top-1 share) = 1 when every router
    probability is 1/E, whatever the routing."""
    cfg = tcfg_of("phi35_moe")
    p = {k: torch.from_numpy(np.array(v[0])) for k, v in jmoe.init_moe(
        jax.random.key(2), cfg_of("phi35_moe"), layers=1).items()}
    p["router"] = torch.zeros_like(p["router"])
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((2, 7, 64)).astype(
        np.float32))
    y, aux = tmoe.moe_mlp(p, x, cfg)
    assert y.shape == x.shape
    assert abs(float(aux) - 1.0) < 1e-6


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_get_model_accepts_every_config(arch):
    """All ten configs build, on ``meta`` at full width, as the family's model."""
    cfg = tconfigs.get_config(arch)
    api = tzoo.get_model(cfg)
    model = api.build("meta", 128)
    assert isinstance(model, L.LanguageModel) and model.cfg is cfg
    assert set(api.cache_shape(2, 16)) == set(jzoo.get_model(jconfigs.get_config(arch))
                                               .cache_shape(2, 16))


def test_qwen25_3b_full_width_parameter_count():
    """3.40 B parameters: two 311.4 M embeddings and 36 layers of 77.07 M."""
    cfg = tconfigs.get_config("qwen25_3b")
    layer = sum(p.numel() for p in Transformer(cfg, "meta").blocks[0].parameters())
    assert layer == 77_076_992
    assert cfg.padded_vocab * cfg.d_model == 311_427_072
    assert cfg.param_count() == 2 * 311_427_072 + 36 * layer + cfg.d_model
