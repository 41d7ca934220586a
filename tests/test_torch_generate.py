"""LM continuation over dense KV caches: the port against the JAX package.

A tiny fp32 decoder-only model (2 layers, d 32, 4 heads, dff 64) with
weights converted from a JAX init; every case feeds the same numpy-seeded
inputs to the JAX function and the port's.

- ``transformer_verify``: logits of every fed position and the cache rows
  it writes, within 1e-5.
- ``lm_generate`` greedy over ragged prompts (PAD on the right, all-PAD
  bucketing rows), with and without the hoisted prefill, chunked and not,
  and an EOS id that rows reach at different ticks: token-identical.
- ``generate``: the same strings, the same over-length ``ValueError``
  message, the same ``max_new`` clamp; ``speculate_k`` gives the same text.
- ``speculative_generate`` (n-gram drafter) at k 1 and 4: tokens equal to
  JAX's and to the port's ``lm_generate``; ``verify_forwards`` /
  ``drafted`` / ``accepted`` equal to JAX's. Its two refusals.
- A sampled batch-1 ``generate`` answers as the port's
  ``ContinuousScheduler`` does at the same seed (both key a pick at
  position t by (seed, t)).
- ``cli.generate --device cpu`` prints ``generate``'s strings, refuses a
  seq2seq export with JAX's message, and without ``--device`` raises.
"""

import dataclasses
import io

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
from transformer_tpu.models.transformer import transformer_verify as j_verify
from transformer_tpu.serve.speculative import speculative_generate as j_speculative
from transformer_tpu.train.checkpoint import _flatten, export_params
from transformer_tpu.train.decode import _pad_batch as j_pad_batch
from transformer_tpu.train.decode import generate as j_generate
from transformer_tpu.train.decode import lm_generate as j_lm_generate
from transformer_tpu_torch.cli import generate as cli_generate
from transformer_tpu_torch.config import PAD_ID
from transformer_tpu_torch.config import ModelConfig as TConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer as TTokenizer
from transformer_tpu_torch.models.decoder import init_decoder_caches
from transformer_tpu_torch.models.transformer import transformer_prefill, transformer_verify
from transformer_tpu_torch.serve.scheduler import ContinuousScheduler
from transformer_tpu_torch.serve.speculative import speculative_generate
from transformer_tpu_torch.train.decode import generate, lm_generate, prefill_len_for

CORPUS = ["ab cd ef gh ij kl mn op qr st"] * 3
PROMPTS = ["ab cd ef gh ij kl mn", "qr st", "ab cd ab cd ab cd ab", "mn op qr st ab cd ef gh ij"]
MAX_NEW = 12


def _cfg_kw(vocab_size, **kw):
    return dict(
        num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=vocab_size,
        target_vocab_size=vocab_size, max_position=64, decoder_only=True,
        dtype="float32", dropout_rate=0.0, **kw,
    )


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    tok = JTokenizer.build_from_corpus(CORPUS, target_vocab_size=300)
    path = str(tmp_path_factory.mktemp("vocab") / "tiny.subwords")
    tok.save(path)
    return tok, TTokenizer.load(path), path


@pytest.fixture(scope="module")
def model(vocab):
    kw = _cfg_kw(vocab[0].model_vocab_size)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jparams = transformer_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_numpy(_flatten(jparams), tcfg, device="cpu")


def _ragged_ids(vocab_size, seed=5):
    """5 BOS-led prompts of 3-11 tokens in a PAD canvas of 8 rows x 16."""
    rng = np.random.default_rng(seed)
    encoded = [[vocab_size - 2, *rng.integers(3, vocab_size - 2, size=n).tolist()]
               for n in (6, 2, 10, 4, 8)]
    ids, n = j_pad_batch(encoded, 16)
    assert ids.shape == (8, 16) and n == 5
    return ids, min(len(e) for e in encoded)


def test_transformer_verify_matches_jax(model):
    jcfg, tcfg, jparams, params = model
    rng = np.random.default_rng(1)
    prompt = rng.integers(3, tcfg.target_vocab_size, size=(2, 5))
    row = rng.integers(3, tcfg.target_vocab_size, size=(2, 4))
    _, jc = j_prefill(jparams, jnp.asarray(prompt), None, None, j_init_caches(jcfg, 2, 16), 0,
                      jcfg)
    want, jc = j_verify(jparams, jnp.asarray(row), jc, 5, jcfg)
    caches = init_decoder_caches(tcfg, 2, 16)
    _, caches = transformer_prefill(params, torch.from_numpy(prompt), caches, 0, tcfg)
    got, caches = transformer_verify(params, torch.from_numpy(row), caches, 5, tcfg)
    assert got.shape == (2, 4, tcfg.target_vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert caches[0]["index"] == 9
    np.testing.assert_allclose(caches[1]["k"][:, :9].numpy(), np.asarray(jc[1]["k"])[:, :9],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("chunk, prefill", [(0, False), (0, True), (4, True)],
                         ids=["no-prefill", "prefill", "prefill-chunk4"])
def test_lm_generate_greedy_tokens_match_jax(model, chunk, prefill):
    jcfg, tcfg, jparams, params = model
    ids, shortest = _ragged_ids(tcfg.target_vocab_size)
    n = prefill_len_for(shortest, chunk) if prefill else 0
    free = np.asarray(j_lm_generate(jparams, jnp.asarray(ids), jcfg, MAX_NEW, eos_id=-1))
    eos = int(free[0, 3])  # row 0 stops by tick 3; others wherever they emit it
    want = np.asarray(j_lm_generate(jparams, jnp.asarray(ids), jcfg, MAX_NEW, eos_id=eos,
                                    prefill_len=n, prefill_chunk=chunk))
    got = lm_generate(params, torch.from_numpy(ids).long(), tcfg, MAX_NEW, eos,
                      prefill_len=n, prefill_chunk=chunk).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[5:] == PAD_ID).all()  # the all-PAD bucketing rows
    first = free[0].tolist().index(eos)
    assert got[0, first] == eos and (got[0, first + 1 :] == PAD_ID).all()
    assert (got[:5] != PAD_ID).sum(axis=1).max() > first + 1  # rows stop apart


def test_generate_strings_match_jax(vocab, model):
    jcfg, tcfg, jparams, params = model
    want = j_generate(jparams, jcfg, vocab[0], PROMPTS, max_new=MAX_NEW, prefill_chunk=4)
    got = generate(params, tcfg, vocab[1], PROMPTS, max_new=MAX_NEW, prefill_chunk=4)
    assert got == want and any(got)
    assert generate(params, tcfg, vocab[1], PROMPTS[1], max_new=MAX_NEW) == [want[1]]


def test_generate_over_length_and_clamp_as_jax(vocab, model):
    jcfg, tcfg, jparams, params = model
    long = " ".join(["ab cd ef gh"] * 40)
    with pytest.raises(ValueError) as j_err:
        j_generate(jparams, jcfg, vocab[0], [long, "ab"])
    with pytest.raises(ValueError) as err:
        generate(params, tcfg, vocab[1], [long, "ab"])
    assert str(err.value) == str(j_err.value) and "max_position is 64" in str(err.value)
    # A prompt 4 short of max_position: max_new is clamped to 4.
    near = " ".join(["ab"] * 400)
    words = near.split()
    while len(vocab[1].encode(" ".join(words))) + 1 > 60:
        words.pop()
    near = " ".join(words)
    want = j_generate(jparams, jcfg, vocab[0], [near], max_new=50)
    got = generate(params, tcfg, vocab[1], [near], max_new=50)
    assert got == want == generate(params, tcfg, vocab[1], [near], max_new=4)


@pytest.mark.parametrize("k", [1, 4])
def test_speculative_generate_matches_jax(model, k):
    jcfg, tcfg, jparams, params = model
    ids, _ = _ragged_ids(tcfg.target_vocab_size, seed=9)
    free = lm_generate(params, torch.from_numpy(ids).long(), tcfg, MAX_NEW, -1).numpy()
    eos = int(free[2, 6])
    plain = lm_generate(params, torch.from_numpy(ids).long(), tcfg, MAX_NEW, eos).numpy()
    prompts = [[int(t) for t in row if t != PAD_ID] for row in ids[:5]]
    prompts.append([tcfg.target_vocab_size - 2, 5, 9, 5, 9, 5, 9, 7])  # drafts land
    drafted = 0
    for i, prompt in enumerate(prompts):
        want, want_stats = j_speculative(jparams, jcfg, prompt, MAX_NEW, eos, speculate_k=k,
                                         prefill_chunk=4)
        got, stats = speculative_generate(params, tcfg, prompt, MAX_NEW, eos, speculate_k=k,
                                          prefill_chunk=4)
        assert got == list(want) and stats == want_stats, i
        drafted += stats["drafted"]
        if i < 5:
            row = plain[i][plain[i] != PAD_ID].tolist()
            assert got == row, i
    assert drafted > 0


def test_speculative_generate_refusals(model):
    _, tcfg, _, params = model
    with pytest.raises(ValueError, match="speculate_k must be >= 1, got 0"):
        speculative_generate(params, tcfg, [1, 5], 4, 2, speculate_k=0)
    windowed = dataclasses.replace(tcfg, attention_window=8)
    with pytest.raises(ValueError, match="cannot roll back a rolling-window cache"):
        speculative_generate(params, windowed, [1, 5], 4, 2, speculate_k=2)


def test_generate_speculative_route_gives_the_same_text(vocab, model):
    jcfg, tcfg, jparams, params = model
    want = j_generate(jparams, jcfg, vocab[0], PROMPTS, max_new=MAX_NEW, speculate_k=3)
    got = generate(params, tcfg, vocab[1], PROMPTS, max_new=MAX_NEW, speculate_k=3)
    assert got == want == generate(params, tcfg, vocab[1], PROMPTS, max_new=MAX_NEW)


@pytest.mark.parametrize("seed", [3, 11])
def test_sampled_generate_equals_the_scheduler(vocab, model, seed):
    _, tcfg, _, params = model
    kw = dict(temperature=0.9, top_k=20, top_p=0.95)
    sched = ContinuousScheduler(params, tcfg, vocab[1], num_slots=2, kv_block=4,
                                prefill_chunk=4, kv_layout="paged",
                                decode_kernel="paged_flash", device="cpu")
    answers = sched.run([{"prompt": p, "max_new": MAX_NEW, "seed": seed, **kw}
                         for p in PROMPTS])
    got = [generate(params, tcfg, vocab[1], [p], max_new=MAX_NEW, seed=seed, prefill_chunk=4,
                    **kw)[0] for p in PROMPTS]
    assert [a["continuation"] for a in answers] == got
    greedy = generate(params, tcfg, vocab[1], PROMPTS, max_new=MAX_NEW, prefill_chunk=4)
    assert got != greedy  # the draws matter


def test_cli_generate_prints_generate(vocab, model, tmp_path):
    jcfg, tcfg, jparams, params = model
    export = str(tmp_path / "lm")
    export_params(jparams, jcfg, export)
    want = generate(params, tcfg, vocab[1], PROMPTS, max_new=MAX_NEW)
    out = io.StringIO()
    got = cli_generate.main(["--export_path", export, "--vocab_file", vocab[2], "--prompts",
                             ";".join(PROMPTS) + "; ", "--max_new", str(MAX_NEW),
                             "--device", "cpu"], stdout=out)
    assert got == want and out.getvalue() == "".join(t + "\n" for t in want)
    from_stdin = cli_generate.main(["--export_path", export, "--vocab_file", vocab[2],
                                    "--max_new", str(MAX_NEW), "--device", "cpu"],
                                   stdin=io.StringIO("\n".join(PROMPTS) + "\n\n"),
                                   stdout=io.StringIO())
    assert from_stdin == want


def test_cli_generate_refuses_seq2seq_and_needs_a_card(vocab, tmp_path):
    kw = {**_cfg_kw(vocab[0].model_vocab_size), "decoder_only": False}
    jcfg = JConfig(**kw)
    export_params(transformer_init(jax.random.PRNGKey(0), jcfg), jcfg, str(tmp_path))
    argv = ["--export_path", str(tmp_path), "--vocab_file", vocab[2], "--prompts", "ab"]
    with pytest.raises(SystemExit, match="the export is a seq2seq model; use cli.translate"):
        cli_generate.main(argv + ["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_generate.main(argv)
