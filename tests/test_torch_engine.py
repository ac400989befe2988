"""The port's LM serving engine against the reference's, on the CPU.

Both engines serve the smoke config of qwen2.5-3b (untied, QKV bias,
float32) from the same params: the reference's drawn with
``jax.random.key(0)`` and carried across with ``params_from_reference``.
Prompts come from numpy seeds; the port runs on ``device="cpu"``, where its
head walks the kernels' plain versions and the reference's head runs its
Pallas kernel interpreted, as the reference's own tests run it.

- ``generate``: greedy tokens equal to the reference's.  The fixture holds
  every step's top-2 logit gap above ``GAP`` (100x the float32 tolerance
  ``TOL`` of the logits), so equal tokens are a real check.
- ``prefill_tokens`` logits and ``decode_hidden`` states within
  rtol = atol = ``TOL`` (1e-4).
- ``sample_approx``: ids equal to the reference's ``sample_approx``
  outside near-ties (top-1 and top-2 approximate scores more than ``GAP``
  apart).
- The head ranks by the input embedding ``embed.tok`` even for an untied
  model, as the reference's does; exact when the rows are not sparsified.
- At bfloat16 the head is built from the float32 ``tok`` (the model's
  ``head_source``), as the reference's is: its embedding and packed
  streams equal the reference's, and ``sample_approx`` ids and the plain
  walks' top-``big_k`` sets equal outside near-ties over 64 states.  Built
  from the bf16-rounded ``tok`` the model holds, 7 of those 64 sets differ.
- The engine refuses ``cuda`` with no CUDA device, and a head on another
  device than the engine; the launcher runs on ``--device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models.model_zoo import get_model as jget_model
from repro.serve.engine import ServingEngine as JEngine
from repro.serve.topk_head import TopKHeadConfig as JHeadConfig
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import GenerationResult, ServingEngine, TopKHeadConfig

TOL = 1e-4
GAP = 1e-2
NEAR_TIE = 1e-5
HEAD = dict(big_k=16, k=8, num_partitions=4, nnz_per_row=32, block_size=64)
BATCH, MAX_SEQ = 2, 64


@pytest.fixture(scope="module")
def engines():
    jcfg, cfg = jsmoke("qwen25_3b"), smoke_config("qwen25_3b")
    params = jget_model(jcfg).init_params(jax.random.key(0), MAX_SEQ)
    model = params_from_reference(params, cfg, device="cpu")
    ref = JEngine(jcfg, params, batch_size=BATCH, max_seq=MAX_SEQ, use_approx_head=True,
                  head_cfg=JHeadConfig(**HEAD))
    port = ServingEngine(cfg, model, batch_size=BATCH, max_seq=MAX_SEQ,
                         use_approx_head=True, head_cfg=TopKHeadConfig(device="cpu", **HEAD),
                         device="cpu")
    return ref, port


def prompt(seed, length):
    rng = np.random.default_rng(seed)
    return rng.integers(0, smoke_config("qwen25_3b").vocab_size, (BATCH, length)).astype(
        np.int32)


def top2_gap(scores: np.ndarray) -> np.ndarray:
    top = np.sort(scores, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def test_generate_equals_the_reference(engines):
    ref, port = engines
    p = prompt(0, 5)
    want = ref.generate(p, num_steps=6)
    got = port.generate(p, num_steps=6)
    assert isinstance(got, GenerationResult) and got.steps == 6
    assert got.tokens.shape == (BATCH, 6)
    # Every greedy choice along the way was made by a clear margin.
    logits, cache, pos = port.prefill_tokens(p)
    gaps = [top2_gap(logits.numpy())]
    for i in range(5):
        logits, cache = port.params.decode_step(
            cache, torch.from_numpy(got.tokens[:, i:i + 1]), pos + i)
        gaps.append(top2_gap(logits.numpy()))
    assert np.min(gaps) > GAP, np.min(gaps)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def test_generate_batched_and_deterministic(engines):
    _, port = engines
    p = prompt(1, 4)
    a = port.generate(p, 4).tokens
    b = port.generate(p, 4).tokens
    np.testing.assert_array_equal(a, b)
    assert (a >= 0).all() and (a < port.cfg.padded_vocab).all()


def test_prefill_tokens_and_decode_hidden(engines):
    ref, port = engines
    p = prompt(2, 7)
    jl, jcache, jpos = ref.prefill_tokens(p)
    tl, tcache, tpos = port.prefill_tokens(p)
    assert tpos == jpos == 7
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    for name in jcache:
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=TOL, atol=TOL)
    jh, _ = ref.decode_hidden(jcache, jnp.asarray(p[:, :1]), jnp.int32(7))
    th, _ = port.decode_hidden(tcache, p[:, :1], 7)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [3, 4])
def test_sample_approx_equals_the_reference(engines, seed):
    ref, port = engines
    p = prompt(seed, 3)
    _, jcache, pos = ref.prefill_tokens(p)
    jh, _ = ref.decode_hidden(jcache, jnp.asarray(p[:, -1:]), jnp.int32(pos))
    _, tcache, _ = port.prefill_tokens(p)
    th, _ = port.decode_hidden(tcache, p[:, -1:], pos)
    vals, _ = port.head.topk_logits_batch(th.numpy(), use_kernel=False)
    assert top2_gap(vals[:, :2]).min() > GAP
    want = ref.sample_approx(np.asarray(jh))
    got = port.sample_approx(th)
    assert got.dtype == np.int64 and got.shape == (BATCH,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.sample_approx(th.numpy()), got)


def test_head_ranks_by_tok_and_is_exact_when_not_sparsified(engines):
    """The untied model's head holds ``embed.tok`` (the reference's choice);
    with every entry of a row kept and F32 values it is exact."""
    ref, port = engines
    cfg = port.cfg
    tok = port.params.embed["tok"].numpy()[: cfg.vocab_size]
    np.testing.assert_array_equal(port.head.embedding, tok)
    np.testing.assert_array_equal(ref.head.embedding, tok)
    exact = ServingEngine(cfg, port.params, batch_size=BATCH, max_seq=MAX_SEQ,
                          use_approx_head=True, device="cpu",
                          head_cfg=TopKHeadConfig(big_k=8, k=8, num_partitions=4,
                                                  nnz_per_row=cfg.d_model, block_size=64,
                                                  value_format="F32", device="cpu"))
    h = np.random.default_rng(5).standard_normal((BATCH, cfg.d_model)).astype(np.float32)
    np.testing.assert_array_equal(exact.sample_approx(h), np.argmax(h @ tok.T, axis=-1))
    assert exact.head.overlap_at_k(h[0], 8) == 1.0


def test_bf16_head_is_built_from_the_f32_tok():
    jcfg = dataclasses.replace(jsmoke("qwen25_3b"), dtype="bfloat16")
    cfg = dataclasses.replace(smoke_config("qwen25_3b"), dtype="bfloat16")
    params = jget_model(jcfg).init_params(jax.random.key(0), MAX_SEQ)
    model = params_from_reference(params, cfg, device="cpu")
    assert model.embed["tok"].dtype == torch.bfloat16
    ref = JEngine(jcfg, params, batch_size=BATCH, max_seq=MAX_SEQ, use_approx_head=True,
                  head_cfg=JHeadConfig(**HEAD))
    port = ServingEngine(cfg, model, batch_size=BATCH, max_seq=MAX_SEQ, use_approx_head=True,
                         head_cfg=TopKHeadConfig(device="cpu", **HEAD), device="cpu")
    np.testing.assert_array_equal(port.head.embedding, ref.head.embedding)
    jp, tp = ref.head.index.packed, port.head.index.packed
    assert tp.nnz == jp.nnz
    for name in ("vals", "cols", "flags", "words"):
        assert np.asarray(getattr(tp, name)).tobytes() == np.asarray(getattr(jp, name)).tobytes()
    h = np.random.default_rng(6).standard_normal((64, cfg.d_model)).astype(np.float32)
    pv, pr = port.head.topk_logits_batch(h, use_kernel=False)
    _, jr = ref.head.topk_logits_batch(h, use_kernel=False)
    # Rows with no near-tie in their top big_k (the two walks sum in other orders).
    clear = (pv[:, :-1] - pv[:, 1:]).min(axis=1) > NEAR_TIE
    assert clear.sum() >= 48
    np.testing.assert_array_equal(pr[clear], np.asarray(jr)[clear])
    ids = port.sample_approx(h)
    np.testing.assert_array_equal(ids[clear], np.asarray(ref.sample_approx(h))[clear])


def test_engine_refuses_cuda_without_a_card(engines):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for machines without one")
    _, port = engines
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(port.cfg, port.params, batch_size=BATCH, max_seq=MAX_SEQ)
    with pytest.raises(SystemExit, match="no CUDA device"):
        launch_serve.main(["--arch", "qwen2.5-3b", "--smoke"])


def test_engine_refuses_a_head_on_another_device(engines):
    _, port = engines
    with pytest.raises(ValueError, match="differs"):
        ServingEngine(port.cfg, port.params, batch_size=BATCH, max_seq=MAX_SEQ,
                      use_approx_head=True, head_cfg=TopKHeadConfig(**HEAD), device="cpu")
    plain = ServingEngine(port.cfg, port.params, batch_size=BATCH, max_seq=MAX_SEQ,
                          device="cpu")
    with pytest.raises(RuntimeError, match="use_approx_head"):
        plain.sample_approx(np.zeros((BATCH, port.cfg.d_model), np.float32))


def test_launcher_on_the_cpu(capsys):
    launch_serve.main(["--arch", "qwen2.5-3b", "--smoke", "--batch", "2", "--prompt-len",
                       "3", "--gen", "4", "--approx-head", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 4) tokens" in out
    assert "approx-head samples:" in out and "overlap@32 vs exact:" in out
