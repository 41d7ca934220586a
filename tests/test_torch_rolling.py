"""Rolling-window KV caches: the port against the JAX package.

A model with ``attention_window`` decodes from a rolling buffer of
``min(window, max_len)`` slots (JAX ``ops/attention.py`` ``init_cache``,
the rolling write at slot ``index % buf_len`` and the chunked rolling
prefill under ``make_rolling_prefill_mask``). Same numpy-seeded inputs and
weights converted from the JAX init, fp32:

- ``init_cache`` with a window (buffer length, the ``rolling`` key, int8);
- ``make_rolling_prefill_mask`` and the windowed ``make_cache_prefix_mask``
  equal to JAX's, at int and per-row indices;
- decoder prefill then decode steps at window 4 (fp32 and int8): chunks
  below, equal to and above the window (``decoder_prefill`` caps the
  chunk at the buffer), prompts of 1×, 1.5× and 3× the window; logits and
  cache buffers within 1e-5 of JAX's;
- a per-row (tensor) index equals the same rows at int indices (the slot
  pool's batched step);
- ``lm_generate`` and ``translate`` of windowed models: JAX's tokens;
- the refusals carry JAX's messages: a rolling prefill chunk wider than
  the buffer, block slice / insert / rollback of a rolling cache, and the
  scheduler's speculative, prefix-cache, paged-layout and per-request
  ``cache_prefix`` refusals, ``speculative_generate``'s and the model
  drafter's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu.models import transformer_init
from transformer_tpu.models.decoder import init_decoder_caches as j_init_caches
from transformer_tpu.models.transformer import transformer_decode_step as j_step
from transformer_tpu.models.transformer import transformer_prefill as j_prefill
from transformer_tpu.ops import attention as jattn
from transformer_tpu.ops import masks as jmasks
from transformer_tpu.serve import ContinuousScheduler as JScheduler
from transformer_tpu.serve import PrefixCache as JPrefixCache
from transformer_tpu.serve import speculative as jspec
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu.train.decode import lm_generate as j_lm_generate
from transformer_tpu.train.decode import translate as j_translate
from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
from transformer_tpu_torch.models.decoder import init_decoder_caches
from transformer_tpu_torch.models.transformer import transformer_decode_step, transformer_prefill
from transformer_tpu_torch.ops import attention as tattn
from transformer_tpu_torch.ops import masks as tmasks
from transformer_tpu_torch.serve import speculative as tspec
from transformer_tpu_torch.serve.prefix_cache import PrefixCache
from transformer_tpu_torch.serve.scheduler import ContinuousScheduler
from transformer_tpu_torch.train.decode import lm_generate, translate

VOCAB = 50
LM = dict(num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=VOCAB,
          target_vocab_size=VOCAB, max_position=64, decoder_only=True, dtype="float32",
          dropout_rate=0.0, attention_window=4)


def _both(kw, seed=0):
    jparams = transformer_init(jax.random.PRNGKey(seed), JConfig(**kw))
    return jparams, params_from_numpy(_flatten(jparams), ModelConfig(**kw), device="cpu")


def _prompts(b, n, seed=0):
    ids = np.random.default_rng(seed).integers(3, VOCAB, (b, n))
    ids[:, 0] = 1
    return ids


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("window,max_len", [(4, 16), (16, 10), (0, 12)])
def test_init_cache_with_window(window, max_len, quantize):
    want = jattn.init_cache(2, max_len, 3, 8, jnp.float32, quantize=quantize, window=window)
    got = tattn.init_cache(2, max_len, 3, 8, torch.float32, quantize=quantize, window=window)
    assert sorted(got) == sorted(want)
    for key in tattn.kv_buffer_keys(got):
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
    assert got["index"] == 0
    if window:
        assert got["rolling"] == int(want["rolling"])


@pytest.mark.parametrize("index,s_q,buf_len", [(0, 4, 4), (3, 2, 4), (6, 4, 4), (9, 3, 5),
                                               (2, 1, 8)])
def test_rolling_prefill_mask_matches_jax(index, s_q, buf_len):
    want = np.asarray(jmasks.make_rolling_prefill_mask(jnp.int32(index), s_q, buf_len))
    assert np.array_equal(tmasks.make_rolling_prefill_mask(index, s_q, buf_len).numpy(), want)
    per_row = tmasks.make_rolling_prefill_mask(torch.tensor([index, index + 5]), s_q, buf_len)
    other = np.asarray(jmasks.make_rolling_prefill_mask(jnp.int32(index + 5), s_q, buf_len))
    assert np.array_equal(per_row.numpy(), np.concatenate([want, other]))
    banded = np.asarray(jmasks.make_cache_prefix_mask(jnp.int32(index), s_q, 12, window=3))
    assert np.array_equal(tmasks.make_cache_prefix_mask(index, s_q, 12, window=3).numpy(), banded)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("chunk", [3, 4, 6], ids=["below", "equal", "above"])
@pytest.mark.parametrize("prompt_len", [4, 6, 12], ids=["1x", "1.5x", "3x"])
def test_decoder_prefill_and_steps_match_jax(prompt_len, chunk, int8):
    kw = dict(LM, kv_cache_int8=int8)
    jparams, params = _both(kw)
    jcfg, cfg = JConfig(**kw), ModelConfig(**kw)
    prompt = _prompts(2, prompt_len + 5)
    total = prompt_len + 6
    jc = j_init_caches(jcfg, 2, total)
    tc = init_decoder_caches(cfg, 2, total)
    assert tc[0]["k"].shape[1] == 4 and "rolling" in tc[0]
    jl, jc = j_prefill(jparams, jnp.asarray(prompt[:, :prompt_len]), None, None, jc, 0, jcfg,
                       chunk=chunk)
    tl, tc = transformer_prefill(params, torch.as_tensor(prompt[:, :prompt_len]), tc, 0, cfg,
                                 chunk=chunk)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    for t in range(prompt_len, prompt_len + 5):
        tok = prompt[:, t : t + 1]
        jl, jc = j_step(jparams, jnp.asarray(tok), None, None, jc, jnp.int32(t), jcfg)
        tl, tc = transformer_decode_step(params, torch.as_tensor(tok), tc, t, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    for j, t in zip(jc, tc):
        assert int(t["index"]) == int(j["index"]) == prompt_len + 5
        for key in tattn.kv_buffer_keys(t):
            np.testing.assert_allclose(t[key].numpy().astype(np.float32),
                                       np.asarray(j[key]).astype(np.float32), atol=1e-5,
                                       rtol=1e-5)


def test_per_row_index_equals_int_rows():
    """A (B,) tensor index (the slot pool's step, each row at its own
    position, rolling writes wrapping at different slots) gives each row
    what the same row alone at its int index gives."""
    cfg = ModelConfig(**LM)
    _, params = _both(LM)
    start = [2, 7, 0]
    history = _prompts(3, 12)
    rows = []
    for b, s in enumerate(start):
        caches = init_decoder_caches(cfg, 1, 16)
        if s:
            _, caches = transformer_prefill(params, torch.as_tensor(history[b : b + 1, :s]),
                                            caches, 0, cfg, chunk=4)
        rows.append(caches)
    batched = [
        {**{k: torch.cat([r[i][k] for r in rows]) for k in tattn.kv_buffer_keys(rows[0][i])},
         "index": torch.tensor(start), "rolling": rows[0][i]["rolling"]}
        for i in range(cfg.num_layers)
    ]
    toks = torch.as_tensor(np.stack([history[b, s] for b, s in enumerate(start)]))[:, None]
    logits, _ = transformer_decode_step(params, toks, batched, torch.tensor(start), cfg)
    for b, s in enumerate(start):
        want, _ = transformer_decode_step(params, toks[b : b + 1], rows[b], s, cfg)
        torch.testing.assert_close(logits[b : b + 1], want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_lm_generate_windowed_matches_jax(int8):
    kw = dict(LM, kv_cache_int8=int8)
    jparams, params = _both(kw, seed=1)
    prompts = _prompts(3, 11, seed=2)
    for prefill_len, chunk in ((0, 0), (8, 3), (8, 0)):
        want = np.asarray(j_lm_generate(jparams, jnp.asarray(prompts), JConfig(**kw), 14, eos_id=2,
                                        prefill_len=prefill_len, prefill_chunk=chunk))
        got = lm_generate(params, torch.as_tensor(prompts), ModelConfig(**kw), 14, eos_id=2,
                          prefill_len=prefill_len, prefill_chunk=chunk)
        assert np.array_equal(got.numpy(), want), (prefill_len, chunk)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    tok = JTokenizer.build_from_corpus(["ab cd ef gh ij kl mn op qr st"] * 3,
                                       target_vocab_size=300)
    path = str(tmp_path_factory.mktemp("vocab") / "tiny.subwords")
    tok.save(path)
    return tok, SubwordTokenizer.load(path)


@pytest.mark.parametrize("beam", [1, 3])
def test_translate_windowed_matches_jax(vocab, beam):
    jtok, tok = vocab
    kw = dict(LM, decoder_only=False, input_vocab_size=tok.model_vocab_size,
              target_vocab_size=tok.model_vocab_size, attention_window=3)
    jparams, params = _both(kw, seed=3)
    sentences = ["ab cd ef gh ij kl", "mn op", "qr st ab cd ef gh ij kl mn"]
    want = j_translate(jparams, JConfig(**kw), jtok, jtok, sentences, max_len=12,
                       beam_size=beam)
    got = translate(params, ModelConfig(**kw), tok, tok, sentences, max_len=12, beam_size=beam)
    assert got == want
    assert any(got), "vacuous: every translation empty"


def _message(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_speculation_refuses_windowed_models_as_jax():
    """``speculative_generate`` and the model drafter keep JAX's refusal:
    a rolling cache cannot be rolled back."""
    jparams, params = _both(LM)
    jcfg, cfg = JConfig(**LM), ModelConfig(**LM)
    assert _message(lambda: tspec.speculative_generate(
        params, cfg, [1, 5, 6], 4, 2, speculate_k=2)) == _message(
        lambda: jspec.speculative_generate(jparams, jcfg, [1, 5, 6], 4, 2, speculate_k=2))
    assert _message(lambda: tspec.ModelDrafter(params, cfg, 16, device="cpu")) == _message(
        lambda: jspec.ModelDrafter(jparams, jcfg, 16))


def test_cache_refusals_carry_jax_messages():
    jc = jattn.init_cache(1, 8, 2, 4, jnp.float32, window=4)
    tc = tattn.init_cache(1, 8, 2, 4, torch.float32, window=4)
    blocks = {"k": np.zeros((1, 2, 2, 4), np.float32), "v": np.zeros((1, 2, 2, 4), np.float32)}
    cases = [
        (lambda: jattn.slice_kv_blocks(jc, 0, 2), lambda: tattn.slice_kv_blocks(tc, 0, 2)),
        (lambda: jattn.insert_kv_blocks(jc, blocks, 0),
         lambda: tattn.insert_kv_blocks(tc, {k: torch.as_tensor(v) for k, v in blocks.items()},
                                        0)),
        (lambda: jattn.rollback_cache(jc, 1), lambda: tattn.rollback_cache(tc, 1)),
    ]
    for jfn, tfn in cases:
        assert _message(tfn) == _message(jfn)
    # A rolling prefill chunk wider than the buffer, straight at the layer.
    kw = dict(LM, num_layers=1)
    jparams, params = _both(kw)
    x = np.random.default_rng(0).standard_normal((1, 6, 32)).astype(np.float32)
    mp = params["decoder"]["layers"][0]["self_mha"]
    jmp = jparams["decoder"]["layers"][0]["self_mha"]
    want = _message(lambda: jattn.mha_apply(jmp, jnp.asarray(x), jnp.asarray(x), cache=dict(
        jattn.init_cache(1, 16, 4, 8, jnp.float32, window=4))))
    got = _message(lambda: tattn.cached_self_attention(mp, torch.as_tensor(x), tattn.init_cache(
        1, 16, 4, 8, torch.float32, window=4)))
    assert got == want and "s_q=6 > buf_len=4" in got


def test_scheduler_refusals_carry_jax_messages(vocab):
    jtok, tok = vocab
    kw = dict(LM, input_vocab_size=tok.model_vocab_size, target_vocab_size=tok.model_vocab_size)
    jparams, params = _both(kw)
    jcfg, cfg = JConfig(**kw), ModelConfig(**kw)
    for extra in ({"speculate_k": 2}, {"kv_layout": "paged"}):
        want = _message(lambda: JScheduler(jparams, jcfg, jtok, num_slots=1, **extra))
        assert _message(lambda: ContinuousScheduler(params, cfg, tok, num_slots=1, device="cpu",
                                                    **extra)) == want
    # the prefix cache refuses the config itself, and the scheduler refuses
    # a cache built against another config
    assert (_message(lambda: PrefixCache(cfg, block_tokens=4))
            == _message(lambda: JPrefixCache(jcfg, block_tokens=4)))
    plain = ModelConfig(**dict(kw, attention_window=0))
    jplain = JConfig(**dict(kw, attention_window=0))
    want = _message(lambda: JScheduler(jparams, jcfg, jtok, num_slots=1,
                                       prefix_cache=JPrefixCache(jplain, block_tokens=4)))
    got = _message(lambda: ContinuousScheduler(params, cfg, tok, num_slots=1, device="cpu",
                                               prefix_cache=PrefixCache(plain, block_tokens=4)))
    assert got == want
    # a request that insists on the prefix cache answers alone, JAX's words
    reqs = [{"prompt": "ab cd", "max_new": 2, "cache_prefix": True},
            {"prompt": "ab cd", "max_new": 2}]
    want = JScheduler(jparams, jcfg, jtok, num_slots=1).run([dict(r) for r in reqs])
    got = ContinuousScheduler(params, cfg, tok, num_slots=1, device="cpu").run(
        [dict(r) for r in reqs])
    assert got == want
    assert got[0]["code"] == "validation" and "cache_prefix=true" in got[0]["error"]
