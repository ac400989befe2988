"""The hybrid (Zamba2), ssm (xLSTM) and audio (Whisper) families of the port
against the reference, on the CPU.

The same seeded inputs go through ``repro`` and ``repro_torch``
(``device="cpu"``).  Each reference model is drawn with
``jax.random.key(0)`` and carried across with
``convert.params_from_reference``; blocks get the reference's own layer
draws; token ids, frame embeddings and hidden inputs come from numpy seeds.
Each reference function is compiled once per module fixture.

- Blocks (the reference's ``test_recurrence_equivalence`` config: d_model
  32, chunk 8): ``mamba_block``, ``mlstm_block`` and ``slstm_block`` at
  seq 8, 17 (ragged: one chunk), 24 and 32 (three and four chunks), and
  their decode blocks stepped with every state, within rtol = atol =
  ``TOL`` (1e-4) at float32.  Within the port, the chunked scans equal
  their recurrences at the same lengths (the reference's tolerance, rtol
  2e-4, atol 2e-5).
- Models (the smoke configs): ``prefill``, ``decode_step`` logits and every
  cache entry over ``STEPS`` steps, ``loss_fn``; Whisper's ``encode``,
  ``build_cross_cache`` and a decode over a filled cross cache; within
  ``TOL``.  At bfloat16 each block and decode block within
  ``BLOCK_BF16_TOL`` of the reference run op by op, each model within
  ``BF16_TOL`` (both stated beside them).
- Within the port, as the reference's ``test_models.py`` holds itself:
  decode == prefill for zamba2 and xlstm (2e-3, argmax equal), Whisper's
  step-by-step decode == teacher forcing (2e-3).
- ``count_params_analytic`` equals the reference's at the smoke and full
  configs (built on ``meta``).
- ``ServingEngine.generate`` gives the reference's tokens (every step's
  top-2 gap above ``GAP``); ``decode_hidden`` and ``launch.serve
  --approx-head`` refuse these families; the launcher serves each on
  ``--device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import model_zoo as jzoo
from repro.models import ssm as jssm
from repro.models import whisper as jwhisper
from repro.models import xlstm as jxlstm
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import ssm, xlstm
from repro_torch.serve import ServingEngine

TOL = 1e-4
# bfloat16: each block alone equals the eager reference within BLOCK_BF16_TOL
# (half a bf16 ulp at 1; measured equal).  The whole model's logits within
# BF16_TOL: XLA fuses the elementwise chains inside the reference's scans
# without torch's intermediate bf16 roundings, and over 4-5 recurrent layers
# single-ulp differences grow to 0.13 at |logit| near 1 (16 ulps).
BLOCK_BF16_TOL = 2.0 ** -8
BF16_TOL = 0.25
GAP = 1e-2
ARCHS = ["zamba2_7b", "xlstm_350m", "whisper_small"]
B, SEQ, STEPS = 2, 32, 12
SEQS = [8, 17, 24, 32]
KINDS = ["mamba", "mlstm", "slstm"]

# The reference's test_recurrence_equivalence config.
BLOCK_CFG = dict(name="t", family="ssm", num_layers=1, d_model=32, num_heads=4,
                 num_kv_heads=4, d_ff=0, vocab_size=64, ssm_state=16, ssm_expand=2,
                 ssm_head_dim=8, ssm_chunk=8, dtype="float32")
JCFG, TCFG = JModelConfig(**BLOCK_CFG), ModelConfig(**BLOCK_CFG)


def t2n(x):
    return x.detach().float().cpu().numpy()


def close(got, want, tol=TOL):
    np.testing.assert_allclose(t2n(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


def to_torch(tree):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def ref_block(kind):
    """The reference's layer draw for ``kind`` (as its recurrence tests draw it)."""
    if kind == "mamba":
        blk = jax.tree.map(lambda x: x[0], jssm.init_mamba(jax.random.key(0), JCFG, 1))
        blk["a_log"] = jax.random.normal(jax.random.key(5), blk["a_log"].shape) * 0.5
        return blk
    if kind == "mlstm":
        return jxlstm.init_mlstm(jax.random.key(0), JCFG, lead=())
    return jxlstm.init_slstm(jax.random.key(2), JCFG, lead=())


def block_input(seq, seed=1):
    return (np.random.default_rng(seed).standard_normal((B, seq, 32)) * 0.5).astype(np.float32)


def port_state(kind, batch=B):
    """The port's zero decode state for ``kind``, as a tuple."""
    if kind == "mamba":
        _, h, p, n, conv_dim = ssm.dims(TCFG)
        return (torch.zeros(batch, h, p, n), torch.zeros(batch, TCFG.ssm_conv - 1, conv_dim))
    if kind == "mlstm":
        di, h, dh = xlstm.dims(TCFG)
        return (torch.zeros(batch, h, dh, dh), torch.zeros(batch, h, dh),
                torch.full((batch, h), xlstm.MIN_LOG), torch.zeros(batch, TCFG.ssm_conv - 1, di))
    return xlstm.slstm_state(TCFG, batch, "cpu")


def port_step(kind, blk, x_t, state, cfg=TCFG):
    """One port decode step: (out, state), the state updated in place."""
    if kind == "mamba":
        out, *state = ssm.mamba_decode_block(blk, x_t, *state, cfg)
    elif kind == "mlstm":
        out, *state = xlstm.mlstm_decode_block(blk, x_t, *state, cfg)
    else:
        out, state = xlstm.slstm_decode_block(blk, x_t, state, cfg)
    return out, tuple(state)


PORT_BLOCK = {"mamba": ssm.mamba_block, "mlstm": xlstm.mlstm_block, "slstm": xlstm.slstm_block}
REF_BLOCK = {"mamba": jssm.mamba_block, "mlstm": jxlstm.mlstm_block,
             "slstm": jxlstm.slstm_block}


@pytest.fixture(scope="module")
def ref_blocks():
    """Each kind's reference draw and its jitted full-sequence block."""
    return {kind: (ref_block(kind), jax.jit(REF_BLOCK[kind], static_argnums=2))
            for kind in KINDS}


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("kind", KINDS)
def test_block_matches_the_reference(ref_blocks, kind, seq):
    blk, fn = ref_blocks[kind]
    x = block_input(seq)
    close(PORT_BLOCK[kind](to_torch(blk), torch.from_numpy(x), TCFG), fn(blk, jnp.asarray(x), JCFG))


def ref_step(kind, blk, x_t, state, cfg=JCFG):
    if kind == "mamba":
        out, *state = jssm.mamba_decode_block(blk, x_t, *state, cfg)
    elif kind == "mlstm":
        out, *state = jxlstm.mlstm_decode_block(blk, x_t, *state, cfg)
    else:
        out, state = jxlstm.slstm_decode_block(blk, x_t, state, cfg)
    return out, tuple(state)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_block_matches_the_reference(ref_blocks, kind):
    """The decode blocks stepped 10 times: every output and every state."""
    blk = ref_blocks[kind][0]
    step = jax.jit(lambda b, x, s: ref_step(kind, b, x, s))
    x = block_input(10, seed=2)
    tstate = port_state(kind)
    jstate = tuple(jnp.array(t2n(s)) for s in tstate)   # copies: the port's update in place
    tblk = to_torch(blk)
    for t in range(10):
        jout, jstate = step(blk, jnp.asarray(x[:, t:t + 1]), jstate)
        tout, tstate = port_step(kind, tblk, torch.from_numpy(x[:, t:t + 1]), tstate)
        close(tout, jout)
        for got, want in zip(tstate, jstate):
            close(got, want)


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("kind", KINDS)
def test_chunked_equals_recurrent(ref_blocks, kind, seq):
    """Within the port: the chunked (or, for the sLSTM, whole-sequence)
    block equals its decode block stepped over the sequence; 32 is four
    chunks, so the inter-chunk carry is used."""
    blk = to_torch(ref_blocks[kind][0])
    x = torch.from_numpy(block_input(seq))
    full = PORT_BLOCK[kind](blk, x, TCFG)
    state = port_state(kind)
    outs = []
    for t in range(seq):
        out, state = port_step(kind, blk, x[:, t:t + 1], state)
        outs.append(out)
    np.testing.assert_allclose(t2n(full), t2n(torch.cat(outs, 1)), rtol=2e-4, atol=2e-5)


BLOCK_SHAPES = {"mamba": ssm.mamba_shapes, "mlstm": xlstm.mlstm_shapes,
                "slstm": xlstm.slstm_shapes}


@pytest.mark.parametrize("kind", KINDS)
def test_bfloat16_block_matches_the_reference(ref_blocks, kind):
    """At bfloat16, weights held as the port's model holds them: the block
    (seq 4) and its decode block over 4 steps against the reference run op by
    op, outputs and states within ``BLOCK_BF16_TOL``."""
    jcfg = dataclasses.replace(JCFG, dtype="bfloat16")
    tcfg = dataclasses.replace(TCFG, dtype="bfloat16")
    blk = ref_blocks[kind][0]
    held = BLOCK_SHAPES[kind](tcfg)
    tblk = {k: torch.from_numpy(np.array(v, np.float32)).to(held[k][1]) for k, v in blk.items()}
    x = block_input(4, seed=3)
    close(PORT_BLOCK[kind](tblk, torch.from_numpy(x).bfloat16(), tcfg),
          REF_BLOCK[kind](blk, jnp.asarray(x, jnp.bfloat16), jcfg), BLOCK_BF16_TOL)
    tstate = port_state(kind)
    if kind != "slstm":                       # the conv state is held in cfg.dtype
        tstate = tstate[:-1] + (tstate[-1].bfloat16(),)
    jstate = tuple(jnp.array(t2n(s), jnp.bfloat16 if s.dtype == torch.bfloat16 else jnp.float32)
                   for s in tstate)
    for t in range(4):
        xt = x[:, t:t + 1]
        jout, jstate = ref_step(kind, blk, jnp.asarray(xt, jnp.bfloat16), jstate, jcfg)
        tout, tstate = port_step(kind, tblk, torch.from_numpy(xt).bfloat16(), tstate, tcfg)
        close(tout, jout, BLOCK_BF16_TOL)
        for got, want in zip(tstate, jstate):
            assert got.dtype == getattr(torch, str(want.dtype))
            close(got, want, BLOCK_BF16_TOL)


def test_mamba_block_single_chunk_fallback():
    """A length the chunk does not divide runs as one chunk, as in the reference."""
    assert ssm.chunk_len(TCFG, 17) == 17 and ssm.chunk_len(TCFG, 24) == 8
    assert ssm.chunk_len(TCFG, 5) == 5


def test_mlstm_long_range_stability():
    """Saturated input gates over 128 steps stay finite (the max-stabiliser)."""
    blk = to_torch(jxlstm.init_mlstm(jax.random.key(0), JCFG, lead=()))
    blk["b_i"].fill_(8.0)
    blk["b_f"].fill_(10.0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 128, 32)).astype(
        np.float32))
    assert torch.isfinite(xlstm.mlstm_block(blk, x, TCFG)).all()


# ---------------------------------------------------------------------------
# Models against the reference
# ---------------------------------------------------------------------------

class Pair:
    """A reference model and its port, with the reference's jitted functions."""

    def __init__(self, arch, **over):
        self.jcfg = dataclasses.replace(jconfigs.smoke_config(arch), **over)
        self.tcfg = dataclasses.replace(tconfigs.smoke_config(arch), **over)
        self.japi = jzoo.get_model(self.jcfg)
        self.tapi = tzoo.get_model(self.tcfg)
        self.params = self.japi.init_params(jax.random.key(0), SEQ)
        self.model = params_from_reference(self.params, self.tcfg, device="cpu")
        self.decode = jax.jit(self.japi.decode_step)
        self.prefill = jax.jit(self.japi.prefill)
        self.loss = jax.jit(self.japi.loss_fn)


@pytest.fixture(scope="module")
def pairs():
    return {arch: Pair(arch) for arch in ARCHS}


def batch_for(cfg, seed=0, seq=SEQ, enc=12):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)}
    if cfg.family == "audio":
        out["frame_embeds"] = rng.standard_normal((B, enc, cfg.d_model)).astype(np.float32)
    return out


def jbatch(batch, cfg):
    return {k: (jnp.asarray(v, jnp.dtype(cfg.dtype)) if v.dtype == np.float32
                else jnp.asarray(v)) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def assert_cache_equal(tcache, jcache, tol=TOL):
    assert set(tcache) == set(jcache)
    for name in jcache:
        assert tuple(tcache[name].shape) == tuple(jcache[name].shape), name
        assert tcache[name].dtype == getattr(torch, str(jcache[name].dtype)), name
        close(tcache[name], jcache[name], tol)


def decode_both(p, toks, jcache, tcache, tol=TOL):
    """Steps both packages over ``toks``; every step's logits within ``tol``."""
    for t in range(toks.shape[1]):
        jl, jcache = p.decode(p.params, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, tcache = p.model.decode_step(tcache, torch.from_numpy(toks[:, t:t + 1]), t)
        assert tl.shape == (B, p.tcfg.padded_vocab)
        close(tl, jl, tol)
    return jcache, tcache


@pytest.mark.parametrize("arch", ARCHS)
class TestFamilyParity:
    def test_prefill(self, pairs, arch):
        p = pairs[arch]
        batch = batch_for(p.jcfg)
        got = p.tapi.prefill(p.model, tbatch(batch))
        assert got.shape == (B, p.tcfg.padded_vocab)
        close(got, p.prefill(p.params, jbatch(batch, p.jcfg)))

    def test_decode_step_logits_and_cache(self, pairs, arch):
        p = pairs[arch]
        toks = np.random.default_rng(1).integers(0, p.jcfg.vocab_size, (B, STEPS)).astype(
            np.int32)
        jcache = p.japi.init_cache(B, SEQ)
        tcache = p.tapi.init_cache(B, SEQ, "cpu")
        assert_cache_equal(tcache, jcache)
        jcache, tcache = decode_both(p, toks, jcache, tcache)
        assert_cache_equal(tcache, jcache)

    def test_loss_fn(self, pairs, arch):
        p = pairs[arch]
        batch = batch_for(p.jcfg, seed=2)
        close(p.tapi.loss_fn(p.model, tbatch(batch)), p.loss(p.params, jbatch(batch, p.jcfg)))

    def test_count_params_analytic(self, pairs, arch):
        for jcfg, tcfg in ((jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)),
                           (jconfigs.get_config(arch), tconfigs.get_config(arch))):
            assert tzoo.count_params_analytic(tcfg) == jzoo.count_params_analytic(jcfg)
        p = pairs[arch]
        extra = (SEQ - 128) * p.tcfg.d_model if p.tcfg.family == "audio" else 0
        assert sum(t.numel() for t in p.model.parameters()) == p.tcfg.param_count() + extra


def test_full_width_parameter_counts():
    """The three deployments at full width (Whisper with 128 decoder positions)."""
    counts = {arch: tconfigs.get_config(arch).param_count() for arch in ARCHS}
    assert counts == {"zamba2_7b": 6_751_130_832, "xlstm_350m": 531_707_024,
                      "whisper_small": 278_372_352}


def test_state_dict_mirrors_the_reference_tree(pairs):
    """Stacked axes unstacked: one name per layer slice of the reference's tree."""
    names = {arch: set(pairs[arch].model.state_dict()) for arch in ARCHS}
    assert {"mamba.0.1.in_proj", "mamba_tail.0.conv_w", "shared.attn.wq",
            "shared.mlp.w_gate", "ln_f"} <= names["zamba2_7b"]
    assert {"mlstm.0.2.wq", "slstm.0.r", "embed.out"} <= names["xlstm_350m"]
    assert {"enc_blocks.1.ln1.w", "dec_blocks.0.cross_attn.bv", "dec_pos",
            "enc_ln_f.b"} <= names["whisper_small"]
    zamba = pairs["zamba2_7b"].model
    assert len(zamba.mamba) == 2 and len(zamba.mamba[0]) == 2 and len(zamba.mamba_tail) == 1


@pytest.fixture(scope="module")
def whisper_io(pairs):
    """Encoder outputs of both packages on the same frames, and their cross caches."""
    p = pairs["whisper_small"]
    frames = np.random.default_rng(3).standard_normal((B, 12, p.jcfg.d_model)).astype(
        np.float32)
    j_enc = jax.jit(lambda prm, f: jwhisper.encode(prm, p.jcfg, f))(p.params, frames)
    t_enc = p.model.encode(torch.from_numpy(frames))
    j_cross = jwhisper.build_cross_cache(p.params, p.jcfg, j_enc, pad_to=SEQ)
    t_cross = p.model.build_cross_cache(t_enc, pad_to=SEQ)
    return p, (j_enc, t_enc), (j_cross, t_cross)


def test_whisper_encode_and_cross_cache(whisper_io):
    _, (j_enc, t_enc), (j_cross, t_cross) = whisper_io
    close(t_enc, j_enc)
    for got, want in zip(t_cross, j_cross):
        assert tuple(got.shape) == tuple(want.shape) == (2, B, 4, SEQ, 16)
        close(got, want)
    assert not t_cross[0][:, :, :, 12:].any()                # padded past S_enc


def test_whisper_decode_over_a_filled_cross_cache(whisper_io):
    """decode_step with the encoder's cross KV: logits and every cache entry."""
    p, (j_enc, _), (j_cross, t_cross) = whisper_io
    jcache, tcache = p.japi.init_cache(B, SEQ), p.tapi.init_cache(B, SEQ, "cpu")
    jcache["cross_k"], jcache["cross_v"] = j_cross
    jcache["cross_len"] = jnp.int32(j_enc.shape[1])
    tcache["cross_k"], tcache["cross_v"] = t_cross
    tcache["cross_len"].fill_(j_enc.shape[1])
    toks = np.random.default_rng(4).integers(0, p.jcfg.vocab_size, (B, 7)).astype(np.int32)
    jcache, tcache = decode_both(p, toks, jcache, tcache)
    assert_cache_equal(tcache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_matches_the_reference(arch):
    """Smoke widths at ``dtype="bfloat16"``: decode logits and every cache
    entry over 6 steps, prefill and loss within ``BF16_TOL``."""
    p = Pair(arch, dtype="bfloat16")
    assert p.model.embed["tok"].dtype == torch.bfloat16
    toks = np.random.default_rng(5).integers(0, p.jcfg.vocab_size, (B, 6)).astype(np.int32)
    jcache, tcache = decode_both(p, toks, p.japi.init_cache(B, SEQ),
                                 p.tapi.init_cache(B, SEQ, "cpu"), BF16_TOL)
    assert_cache_equal(tcache, jcache, BF16_TOL)
    batch = batch_for(p.jcfg, seed=6, seq=8)
    close(p.tapi.prefill(p.model, tbatch(batch)), p.prefill(p.params, jbatch(batch, p.jcfg)),
          BF16_TOL)
    close(p.tapi.loss_fn(p.model, tbatch(batch)), p.loss(p.params, jbatch(batch, p.jcfg)),
          BF16_TOL)


# ---------------------------------------------------------------------------
# Invariants within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2_7b", "xlstm_350m"])
def test_decode_matches_prefill(arch):
    """Greedy next token from step-by-step decode == from full prefill (the
    port's own init; 24 tokens: xlstm's chunk is 16, so the prefill carries
    across chunks)."""
    cfg = tconfigs.smoke_config(arch)
    api = tzoo.get_model(cfg)
    model = api.init_params(torch.Generator().manual_seed(0), SEQ)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 24)))
    pre = api.prefill(model, {"tokens": toks})
    cache = api.init_cache(B, SEQ, "cpu")
    for t in range(toks.shape[1]):
        dec, cache = api.decode_step(model, cache, toks[:, t:t + 1], t)
    np.testing.assert_allclose(t2n(dec), t2n(pre), rtol=2e-3, atol=2e-3)
    assert torch.equal(dec.argmax(-1), pre.argmax(-1))


def test_whisper_decode_matches_teacher_forcing():
    """Step-by-step decode (self KV cache, precomputed cross KV) equals the
    teacher-forced decoder on the same prefix (the port's own init)."""
    cfg = tconfigs.smoke_config("whisper_small")
    api = tzoo.get_model(cfg)
    model = api.init_params(torch.Generator().manual_seed(0), SEQ)
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.standard_normal((B, 12, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 7)))
    enc = model.encode(frames)
    want = L.lm_logits(model.embed, model.decode_train(toks, enc)[:, -1:], cfg)[:, 0]
    cache = api.init_cache(B, SEQ, "cpu")
    cache["cross_k"], cache["cross_v"] = model.build_cross_cache(enc, pad_to=SEQ)
    cache["cross_len"].fill_(enc.shape[1])
    for t in range(toks.shape[1]):
        got, cache = api.decode_step(model, cache, toks[:, t:t + 1], t)
    np.testing.assert_allclose(t2n(got), t2n(want), rtol=2e-3, atol=2e-3)


def test_init_draws_on_the_generator_and_keeps_the_f32_tok():
    """The port's init: the generator's device, the same draws for the same
    seed, each weight held in its op's dtype, the float32 ``tok`` kept."""
    cfg = dataclasses.replace(tconfigs.smoke_config("zamba2_7b"), dtype="bfloat16")
    api = tzoo.get_model(cfg)
    a = api.init_params(torch.Generator().manual_seed(7))
    b = api.init_params(torch.Generator().manual_seed(7))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    assert a.mamba[0][0]["in_proj"].dtype == torch.bfloat16
    assert a.mamba[0][0]["a_log"].dtype == torch.float32
    assert a.head_source.dtype == torch.float32
    assert a.head_source.shape == (cfg.vocab_size, cfg.d_model)
    assert torch.equal(a.head_source.to(torch.bfloat16), a.embed["tok"][:cfg.vocab_size])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def top2_gap(scores: np.ndarray) -> np.ndarray:
    top = np.sort(scores, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generate_equals_the_reference(pairs, arch):
    """Greedy tokens equal (Whisper with the reference's empty cross cache),
    every greedy choice made by a clear margin."""
    p = pairs[arch]
    prompt = np.random.default_rng(7).integers(0, p.jcfg.vocab_size, (B, 5)).astype(np.int32)
    ref = JEngine(p.jcfg, p.params, batch_size=B, max_seq=SEQ)
    port = ServingEngine(p.tcfg, p.model, batch_size=B, max_seq=SEQ, device="cpu")
    want = ref.generate(prompt, num_steps=6).tokens
    got = port.generate(prompt, num_steps=6).tokens
    logits, cache, pos = port.prefill_tokens(prompt)
    gaps = [top2_gap(logits.numpy())]
    for i in range(5):
        logits, cache = p.model.decode_step(cache, torch.from_numpy(got[:, i:i + 1]), pos + i)
        gaps.append(top2_gap(logits.numpy()))
    assert np.min(gaps) > GAP, np.min(gaps)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_hidden_refuses_these_families(pairs, arch):
    p = pairs[arch]
    eng = ServingEngine(p.tcfg, p.model, batch_size=B, max_seq=SEQ, device="cpu")
    _, cache, pos = eng.prefill_tokens(np.zeros((B, 2), np.int32))
    with pytest.raises(ValueError, match="dense/moe/vlm only"):
        eng.decode_hidden(cache, np.zeros((B, 1), np.int32), pos)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_refuses_the_approx_head(arch, capsys):
    with pytest.raises(SystemExit, match="dense/moe/vlm only"):
        launch_serve.main(["--arch", arch, "--smoke", "--approx-head", "--device", "cpu"])
    assert capsys.readouterr().out == ""                       # before any work


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-350m", "whisper-small"])
def test_launcher_serves_on_the_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "3",
                       "--gen", "4", "--device", "cpu"])
    assert "generated (2, 4) tokens" in capsys.readouterr().out
