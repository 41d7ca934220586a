"""MoE decoding and serving: the port against the JAX package on the CPU.

Tiny fp32 models (2 layers, d 32, 4 heads, dff 64, E 4, top-2,
``moe_every`` 2 unless a case says otherwise, weights converted from the
JAX init), with a capacity factor of 1.0 so that prompts overflow their
experts and drop tokens:

- greedy ``lm_generate`` / ``generate`` tokens identical to JAX's (and
  under ``speculate_k``, ``lm_generate_speculative``), the
  seq2seq ``translate`` (greedy and beam 4) and ``fill_mask`` answers
  identical;
- ``ContinuousScheduler`` on the dense layout, the paged layout through
  gathered views (``decode_kernel="xla"``) and on the paged_flash layout
  (the kernels' plain versions on the CPU; the dense layers' fused FFN,
  the MoE layers' plain sublayer): greedy answers equal JAX's scheduler's
  for the same prompts (lengths that are not powers of two), with and
  without a ``prefill_chunk``, and under ``speculate_k``;
- routing groups are per row of each forward, with that forward's
  capacity: JAX's own prefill of a prompt in one forward and in chunks
  gives different logits for the same prompt, and JAX's speculative
  answers differ from its plain ones; the port gives JAX's in each case
  (the gaps are the reference's behaviour, not the port's).
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
from transformer_tpu.models.transformer import transformer_prefill as j_prefill
from transformer_tpu.serve import ContinuousScheduler as JScheduler
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu.train.decode import fill_mask as j_fill_mask
from transformer_tpu.train.decode import generate as j_generate
from transformer_tpu.train.decode import translate as j_translate
from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
from transformer_tpu_torch.models.decoder import init_decoder_caches
from transformer_tpu_torch.models.transformer import transformer_prefill
from transformer_tpu_torch.serve.scheduler import ContinuousScheduler
from transformer_tpu_torch.train.decode import fill_mask, generate, translate

CORPUS = ["ab cd ef gh ij kl mn op qr st", "er geht zur schule", "wo ist das haus"] * 3
MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=1.0, moe_every=2)
REQS = [
    {"prompt": "ab cd ef gh ab cd ef gh ab cd", "max_new": 7},
    {"prompt": "mn op", "max_new": 5},
    {"prompt": "qr st ab cd ef gh ij kl mn op qr st ab", "max_new": 6},
    {"prompt": "ef", "max_new": 3},
    {"prompt": "st qr op mn kl st qr op", "max_new": 8},
]


def _kw(vocab, **kw):
    return dict(num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=vocab,
                target_vocab_size=vocab, max_position=64, dtype="float32", dropout_rate=0.0,
                **{**MOE, **kw})


def _both(kw, seed=0):
    jcfg, cfg = JConfig(**kw), ModelConfig(**kw)
    jparams = transformer_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, cfg, params_from_numpy(_flatten(jparams), cfg, device="cpu")


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    jtok = JTokenizer.build_from_corpus(CORPUS, target_vocab_size=300)
    path = str(tmp_path_factory.mktemp("vocab") / "tiny.subwords")
    jtok.save(path)
    return jtok, SubwordTokenizer.load(path)


@pytest.fixture(scope="module")
def lm(tok):
    return _both(_kw(tok[0].model_vocab_size, decoder_only=True))


# --------------------------------------------------------------------------
# decode loops


def test_generate_greedy_tokens_equal_jax(tok, lm):
    jcfg, jparams, cfg, params = lm
    prompts = [r["prompt"] for r in REQS]
    want = j_generate(jparams, jcfg, tok[0], prompts, max_new=8)
    got = generate(params, cfg, tok[1], prompts, max_new=8)
    assert got == want
    for p in prompts[:2]:  # one row at a time too
        assert generate(params, cfg, tok[1], [p], max_new=8) == \
            j_generate(jparams, jcfg, tok[0], [p], max_new=8)


@pytest.mark.parametrize("k", [2, 4])
def test_speculative_generate_equals_jax(tok, lm, k):
    """``lm_generate_speculative`` (n-gram drafts, verify forwards of k + 1
    rows) through ``generate(speculate_k=k)``, prompt by prompt."""
    jcfg, jparams, cfg, params = lm
    prompts = [r["prompt"] for r in REQS[:3]]
    want = j_generate(jparams, jcfg, tok[0], prompts, max_new=8, speculate_k=k, prefill_chunk=4)
    got = generate(params, cfg, tok[1], prompts, max_new=8, speculate_k=k, prefill_chunk=4)
    assert got == want


@pytest.mark.parametrize("beam", [1, 4])
def test_translate_equals_jax(tok, beam):
    v = tok[0].model_vocab_size
    jcfg, jparams, cfg, params = _both(_kw(v, moe_every=1), seed=2)
    sentences = ["er geht zur schule", "wo ist das haus ab cd", "ef"]
    want = j_translate(jparams, jcfg, tok[0], tok[0], sentences, max_len=12, beam_size=beam)
    got = translate(params, cfg, tok[1], tok[1], sentences, max_len=12, beam_size=beam)
    assert got == want


def test_fill_mask_equals_jax(tok):
    v = tok[0].model_vocab_size + 1  # [MASK] on top
    jcfg, jparams, cfg, params = _both(_kw(v, encoder_only=True, tie_output=True), seed=3)
    texts = ["er geht zur [MASK]", "[MASK] ist das haus ab cd ef", "wo [MASK]"]
    want = j_fill_mask(jparams, jcfg, tok[0], texts, top_k=4)
    got = fill_mask(params, cfg, tok[1], texts, top_k=4)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [[t for t, _ in c] for c in g["candidates"]] == \
            [[t for t, _ in c] for c in w["candidates"]]
        np.testing.assert_allclose([p for c in g["candidates"] for _, p in c],
                                   [p for c in w["candidates"] for _, p in c], atol=1e-5)


# --------------------------------------------------------------------------
# the scheduler

LAYOUTS = {
    "dense": dict(kv_layout="dense"),
    "paged_gathered": dict(kv_layout="paged", decode_kernel="xla", kv_block=4),
    "paged_flash": dict(kv_layout="paged", decode_kernel="paged_flash", kv_block=4),
}
COMMON = dict(num_slots=2, max_total=48, default_max_new=4)
_JAX: dict = {}


def _jax_answers(tok, lm, layout, chunk, k):
    key = (layout, chunk, k)
    if key not in _JAX:
        jcfg, jparams = lm[0], lm[1]
        sched = JScheduler(jparams, jcfg, tok[0], prefill_chunk=chunk, speculate_k=k,
                           **LAYOUTS[layout], **COMMON)
        _JAX[key] = sched.run([dict(r) for r in REQS])
    return _JAX[key]


@pytest.mark.parametrize("chunk", [0, 3])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_scheduler_answers_equal_jax(tok, lm, layout, chunk):
    _, _, cfg, params = lm
    sched = ContinuousScheduler(params, cfg, tok[1], device="cpu", prefill_chunk=chunk,
                                **LAYOUTS[layout], **COMMON)
    got = sched.run([dict(r) for r in REQS])
    assert got == _jax_answers(tok, lm, layout, chunk, 0)
    assert all(g.get("continuation") is not None for g in got)


@pytest.mark.parametrize("k", [2, 3])
def test_speculative_answers_equal_jax(tok, lm, k):
    _, _, cfg, params = lm
    sched = ContinuousScheduler(params, cfg, tok[1], device="cpu", prefill_chunk=3,
                                speculate_k=k, **LAYOUTS["paged_flash"], **COMMON)
    got = sched.run([dict(r) for r in REQS])
    assert got == _jax_answers(tok, lm, "paged_flash", 3, k)
    # JAX's own gap: a verify step routes its k + 1 rows as one group with
    # that group's capacity, so speculative answers differ from plain ones.
    plain = _jax_answers(tok, lm, "paged_flash", 3, 0)
    assert any(a != b for a, b in zip(plain, got))


def test_chunked_prefill_routes_otherwise_in_jax_and_in_the_port(tok, lm):
    """Capacity is per forward: a prompt prefilled in one forward and in
    chunks of 3 routes differently in JAX itself (different logits); the
    port reproduces each of JAX's two results."""
    jcfg, jparams, cfg, params = lm
    ids = tok[0].encode(REQS[2]["prompt"])
    jtoks = jnp.asarray([ids], jnp.int32)
    ttoks = torch.tensor([ids], dtype=torch.long)
    outs = {}
    for chunk in (0, 3):
        jl, _ = j_prefill(jparams, jtoks, None, None, j_init_caches(jcfg, 1, 64), 0, jcfg,
                          chunk=chunk)
        tl, _ = transformer_prefill(params, ttoks, init_decoder_caches(cfg, 1, 64), 0, cfg,
                                    chunk=chunk)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
        outs[chunk] = np.asarray(jl)
    assert np.abs(outs[0] - outs[3]).max() > 1e-3  # JAX's own gap
