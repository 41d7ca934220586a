"""Seq2seq decoding and scoring: the port against the JAX package.

Weights come from a JAX init through ``convert.params_from_numpy``; fp32
throughout (2 layers, d 64, 4 heads, dff 128).

- ``greedy_decode`` and ``beam_search_decode`` (K 4, alpha 0.6) give
  token ids identical to JAX's, xla and flash encoders, for a batch of 5
  sources that ``_pad_batch`` fills to 8 rows with all-PAD dummies, and
  an EOS id that the rows reach at different positions; greedy also over
  an int8 KV cache. A beam case with exactly tied logits (a zero output
  kernel and a bias with five equal maxima, EOS the highest of them)
  picks what ``lax.top_k`` picks: the lowest flat indices.
- ``translate`` returns JAX's strings, greedy and beam; with ``truncate``
  an over-long source is clipped to EOS; without it both raise the same
  error.
- ``corpus_bleu`` and ``bleu_on_pairs`` equal JAX's exactly on the same
  hypotheses; ``perplexity_on_lines`` of an LM within 1e-5 relative, and
  ``cli.evaluate`` on an LM export the same (printed to 3 decimals).
- The CLIs on the CPU: ``cli.train --device=cpu`` in seq2seq mode (200
  corpus lines, tiny widths, the ``tied`` and ``big`` presets' other
  flags) writes an export that ``cli.translate`` and ``cli.evaluate``
  read and the JAX package's ``cli/translate.py`` ``load_export`` loads;
  ``cli.evaluate`` prints one JSON line.
- Without ``--device=cpu`` the new entry points raise: no silent CPU; with
  it, ``cli.translate --attention_out`` writes JAX's attention-map dump of
  the same export (the keys, and every map within 1e-5).
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tpu.cli.translate import load_export as j_load_export
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu.models import transformer_init
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu.train.decode import beam_search_decode as j_beam
from transformer_tpu.train.decode import greedy_decode as j_greedy
from transformer_tpu.train.decode import translate as j_translate
from transformer_tpu.train.evaluate import bleu_on_pairs as j_bleu_on_pairs
from transformer_tpu.train.evaluate import perplexity_on_lines as j_perplexity
from transformer_tpu.utils.bleu import corpus_bleu as j_corpus_bleu
from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.convert import params_from_numpy, params_to_numpy
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
from transformer_tpu_torch.models.transformer import unflatten
from transformer_tpu_torch.train.decode import (
    _pad_batch,
    beam_search_decode,
    greedy_decode,
    translate,
)
from transformer_tpu_torch.train.evaluate import bleu_on_pairs, perplexity_on_lines
from transformer_tpu_torch.utils.bleu import corpus_bleu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 60
BOS, NEVER = VOCAB - 2, VOCAB + 7  # NEVER: an EOS id no row can emit
MODEL = dict(
    num_layers=2, d_model=64, num_heads=4, dff=128, input_vocab_size=VOCAB,
    target_vocab_size=VOCAB, max_position=64, dropout_rate=0.0, dtype="float32",
)
MAX_LEN = 12


def _init(model_kw, seed=0):
    return _flatten(transformer_init(jax.random.PRNGKey(seed), JConfig(**model_kw)))


def _both(flat, model_kw):
    """(JAX params, port params) of one flat init."""
    jparams = unflatten(jax.tree.map(jnp.asarray, flat))
    return jparams, params_from_numpy(flat, ModelConfig(**model_kw), device="cpu")


def _sources():
    """5 ragged sources in a PAD canvas of 8 rows (3 all-PAD dummies)."""
    rng = np.random.default_rng(3)
    encoded = [[BOS, *rng.integers(1, VOCAB - 2, size=n).tolist(), VOCAB - 1]
               for n in (3, 9, 14, 6, 1)]
    ids, n = _pad_batch(encoded, 16)
    assert ids.shape == (8, 16) and n == 5
    return ids


def _decode_both(kind, flat, model_kw, src, eos, **kw):
    jparams, params = _both(flat, model_kw)
    fn = {"greedy": (j_greedy, greedy_decode), "beam": (j_beam, beam_search_decode)}[kind]
    want = np.asarray(fn[0](jparams, jnp.asarray(src), JConfig(**model_kw), MAX_LEN, BOS, eos,
                            **kw))
    got = fn[1](params, torch.from_numpy(src).long(), ModelConfig(**model_kw), MAX_LEN, BOS,
                eos, **kw).numpy()
    return got, want


CASES = [
    ("greedy", "xla", {}), ("greedy", "flash", {}), ("greedy", "xla", {"kv_cache_int8": True}),
    ("beam", "xla", {}), ("beam", "flash", {}),
]


@pytest.mark.parametrize("kind, impl, extra", CASES,
                         ids=["greedy-xla", "greedy-flash", "greedy-int8", "beam-xla",
                              "beam-flash"])
def test_decode_tokens_match_jax(kind, impl, extra):
    kw = {**MODEL, "attention_impl": impl, **extra}
    flat = _init(kw)
    src = _sources()
    beam = dict(beam_size=4, alpha=0.6) if kind == "beam" else {}
    # An EOS the rows reach at different positions: a token row 0 emits
    # mid-way when nothing stops it.
    free, _ = _decode_both(kind, flat, kw, src, NEVER, **beam)
    eos = int(free[0, MAX_LEN // 2])
    got, want = _decode_both(kind, flat, kw, src, eos, **beam)
    assert got.shape == want.shape == (8, MAX_LEN)
    assert np.array_equal(got, want), (got, want)
    assert (got[5:] == 0).all()  # the dummies start finished
    assert (got[:5] == eos).any()  # EOS was reached, so rows finished early


def test_beam_ties_pick_what_top_k_picks():
    kw = {**MODEL, "attention_impl": "flash"}
    flat = _init(kw, seed=1)
    flat["final/kernel"] = np.zeros_like(flat["final/kernel"])
    bias = np.zeros_like(flat["final/bias"])
    bias[[5, 9, 12, 20, 33]] = 1.0  # five exactly tied maxima
    flat["final/bias"] = bias
    got, want = _decode_both("beam", flat, kw, _sources(), 33, beam_size=4, alpha=0.6)
    assert np.array_equal(got, want), (got, want)
    # Every tick keeps the four lowest flat indices among the tied
    # candidates, so EOS (33, the highest tied id) is never kept and the
    # best beam repeats the lowest id; a pick of the highest would end at
    # once on EOS.
    assert (got[:5] == 5).all()


# --------------------------------------------------------------------------
# text


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("corpus")
    for split, n in (("train", 200), ("test", 60)):
        for side in ("src", "tgt"):
            with open(os.path.join(ROOT, "data", f"{side}-{split}.txt"), encoding="utf-8") as f:
                head = [next(f) for _ in range(n)]
            (tmp / f"{side}-{split}.txt").write_text("".join(head), encoding="utf-8")
    lines = {side: (tmp / f"{side}-train.txt").read_text(encoding="utf-8").splitlines()
             for side in ("src", "tgt")}
    lines["joint"] = lines["src"] + lines["tgt"]  # one id space, for tied tables
    vocabs = {}
    for side, text in lines.items():
        vocabs[side] = str(tmp / f"{side}.subwords")
        size = 1000 if side == "joint" else 400
        SubwordTokenizer.build_from_corpus(text, target_vocab_size=size).save(vocabs[side])
    return tmp, vocabs


@pytest.fixture(scope="module")
def text_model(corpus):
    _, vocabs = corpus
    src_tok, tgt_tok = (SubwordTokenizer.load(vocabs[s]) for s in ("src", "tgt"))
    kw = {**MODEL, "input_vocab_size": src_tok.model_vocab_size,
          "target_vocab_size": tgt_tok.model_vocab_size, "attention_impl": "flash"}
    jparams, params = _both(_init(kw, seed=2), kw)
    jtoks = tuple(JTokenizer.load(vocabs[s]) for s in ("src", "tgt"))
    return kw, jparams, params, jtoks, (src_tok, tgt_tok)


@pytest.mark.parametrize("beam", [1, 4])
def test_translate_returns_jax_strings(text_model, beam):
    kw, jparams, params, jtoks, toks = text_model
    sentences = ["he go to school", "where is the house ?", "i like it very much", "yes"]
    want = j_translate(jparams, JConfig(**kw), *jtoks, sentences, max_len=MAX_LEN,
                       beam_size=beam)
    got = translate(params, ModelConfig(**kw), *toks, sentences, max_len=MAX_LEN,
                    beam_size=beam)
    assert got == want and len(got) == 4
    assert translate(params, ModelConfig(**kw), *toks, "yes", max_len=MAX_LEN,
                     beam_size=beam) == want[-1:]


def test_translate_truncates_or_raises_as_jax(text_model):
    kw, jparams, params, jtoks, toks = text_model
    long = " ".join(["the house is big and the school is far"] * 12)
    assert len(toks[0].encode(long)) + 2 > kw["max_position"]
    want = j_translate(jparams, JConfig(**kw), *jtoks, [long, "yes"], max_len=MAX_LEN,
                       truncate=True)
    got = translate(params, ModelConfig(**kw), *toks, [long, "yes"], max_len=MAX_LEN,
                    truncate=True)
    assert got == want
    with pytest.raises(ValueError) as j_err:
        j_translate(jparams, JConfig(**kw), *jtoks, [long], max_len=MAX_LEN)
    with pytest.raises(ValueError) as err:
        translate(params, ModelConfig(**kw), *toks, [long], max_len=MAX_LEN)
    assert str(err.value) == str(j_err.value)


def test_bleu_equals_jax(corpus, text_model):
    refs = ["the cat sat on the mat", "he goes to school", "", "a b c d e"]
    hyps = ["the cat sat on a mat", "he go to school", "nothing", "a b c d e"]
    for smooth in (True, False):
        assert corpus_bleu(refs, hyps, smooth=smooth) == j_corpus_bleu(refs, hyps, smooth=smooth)
    assert corpus_bleu(refs, [""] * 4) == j_corpus_bleu(refs, [""] * 4) == 0.0
    tmp, _ = corpus
    kw, jparams, params, jtoks, toks = text_model
    src = (tmp / "src-test.txt").read_text(encoding="utf-8").splitlines()[:10]
    ref = (tmp / "tgt-test.txt").read_text(encoding="utf-8").splitlines()[:10]
    want_bleu, want_hyps = j_bleu_on_pairs(jparams, JConfig(**kw), *jtoks, src, ref,
                                           batch_size=4, max_len=MAX_LEN)
    bleu, hyps = bleu_on_pairs(params, ModelConfig(**kw), *toks, src, ref, batch_size=4,
                               max_len=MAX_LEN)
    assert hyps == want_hyps and bleu == want_bleu


def test_perplexity_matches_jax(corpus):
    tmp, vocabs = corpus
    tok = SubwordTokenizer.load(vocabs["tgt"])
    kw = {**MODEL, "decoder_only": True, "attention_impl": "flash",
          "input_vocab_size": tok.model_vocab_size, "target_vocab_size": tok.model_vocab_size}
    jparams, params = _both(_init(kw, seed=4), kw)
    lines = (tmp / "tgt-test.txt").read_text(encoding="utf-8").splitlines()[:12]
    want, want_n = j_perplexity(jparams, JConfig(**kw), JTokenizer.load(vocabs["tgt"]), lines,
                                batch_size=5)
    got, n = perplexity_on_lines(params, ModelConfig(**kw), tok, lines, batch_size=5)
    assert n == want_n > 0
    assert abs(got - want) <= 1e-5 * want


def test_cli_evaluate_scores_an_lm_export(corpus, tmp_path):
    from transformer_tpu.train.checkpoint import export_params as j_export_params
    from transformer_tpu_torch.cli import evaluate

    tmp, vocabs = corpus
    tok = JTokenizer.load(vocabs["tgt"])
    jcfg = JConfig(**{**MODEL, "decoder_only": True, "input_vocab_size": tok.model_vocab_size,
                      "target_vocab_size": tok.model_vocab_size})
    jparams = transformer_init(jax.random.PRNGKey(5), jcfg)
    j_export_params(jparams, jcfg, str(tmp_path))
    lines = (tmp / "tgt-test.txt").read_text(encoding="utf-8").splitlines()[:12]
    want, want_n = j_perplexity(jparams, jcfg, tok, lines, batch_size=5)
    out = io.StringIO()
    result = evaluate.main(["--export_path", str(tmp_path), "--tgt_vocab_file", vocabs["tgt"],
                            "--tgt_file", str(tmp / "tgt-test.txt"), "--limit", "12",
                            "--batch_size", "5", "--device=cpu"], stdout=out)
    assert json.loads(out.getvalue()) == result and result["n_tokens"] == want_n
    assert abs(result["perplexity"] - want) <= 1e-5 * want + 5e-4  # printed to 3 decimals


# --------------------------------------------------------------------------
# CLIs


def _train_argv(tmp, vocabs, export, *extra):
    return [
        "--device=cpu", "--dataset_path", str(tmp), "--src_vocab_file", vocabs["src"],
        "--tgt_vocab_file", vocabs["tgt"], "--num_layers", "1", "--d_model", "32",
        "--dff", "64", "--num_heads", "4", "--sequence_length", "64", "--batch_size", "16",
        "--epochs", "1", "--attention_impl", "flash", "--bleu_limit", "8",
        "--export_path", export, "--ckpt_path", os.path.join(os.path.dirname(export), "ckpt"),
        *extra,
    ]


@pytest.mark.parametrize("preset", ["", "tied", "big"])
def test_cli_train_translate_evaluate(corpus, tmp_path, preset):
    from transformer_tpu_torch.cli import evaluate, train
    from transformer_tpu_torch.cli import translate as cli_translate
    from transformer_tpu_torch.convert import load_export

    tmp, vocabs = corpus
    if preset == "tied":  # one id space for the two tied tables
        vocabs = {"src": vocabs["joint"], "tgt": vocabs["joint"]}
    export = str(tmp_path / "export")
    logs = []
    extra = ["--preset", preset] if preset else []
    trainer = train.main(_train_argv(tmp, vocabs, export, *extra), log_fn=logs.append)
    cfg = trainer.model_cfg
    assert not cfg.decoder_only and trainer.state.step == len(trainer.step_seconds) > 0
    assert cfg.max_position == 64 and cfg.d_model == 32
    assert cfg.tie_embeddings == (preset == "tied")
    assert trainer.train_cfg.label_smoothing == (0.1 if preset == "big" else 0.0)
    for head in ("sample translation", "eval loss", "exported params", "test BLEU"):
        assert any(line.startswith(head) for line in logs), (head, logs)
    params, loaded = load_export(export, device="cpu")
    assert loaded == cfg
    jparams, jcfg = j_load_export(export)
    assert jcfg.tie_embeddings == cfg.tie_embeddings
    assert all(a.tobytes() == b.tobytes() for a, b in zip(
        params_to_numpy(params).values(), (_flatten(jparams)[k] for k in params_to_numpy(params))
    ))
    common = ["--export_path", export, "--src_vocab_file", vocabs["src"],
              "--tgt_vocab_file", vocabs["tgt"], "--max_len", "8", "--device=cpu"]
    out = io.StringIO()
    greedy = cli_translate.main(common, stdin=io.StringIO("he go to school\n\nyes\n"),
                                stdout=out)
    assert len(greedy) == 2 and out.getvalue().count("\n") == 2
    want = translate(params, cfg, SubwordTokenizer.load(vocabs["src"]),
                     SubwordTokenizer.load(vocabs["tgt"]), ["he go to school", "yes"],
                     max_len=8, beam_size=4)
    assert cli_translate.main(common + ["--beam", "4", "--sentences", "he go to school;yes"],
                              stdout=io.StringIO()) == want
    out = io.StringIO()
    result = evaluate.main(common + ["--src_file", str(tmp / "src-test.txt"), "--tgt_file",
                                     str(tmp / "tgt-test.txt"), "--limit", "6"], stdout=out)
    assert json.loads(out.getvalue()) == result
    assert result["n"] == 6 and result["beam"] == 1 and 0.0 <= result["bleu"] <= 100.0


def test_new_entry_points_refuse_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from transformer_tpu_torch.cli import evaluate, train
    from transformer_tpu_torch.cli import translate as cli_translate

    jcfg = JConfig(**MODEL)
    from transformer_tpu.train.checkpoint import export_params as j_export_params

    j_export_params(transformer_init(jax.random.PRNGKey(0), jcfg), jcfg, str(tmp_path))
    export = ["--export_path", str(tmp_path)]
    for main, argv in ((cli_translate.main, export + ["--sentences", "yes"]),
                       (evaluate.main, export)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--preset", "base", "--dataset_path", str(tmp_path),
                    "--ckpt_path", str(tmp_path / "ckpt")])
    # --attention_out (once refused) writes JAX's dump of the same export.
    pieces = [*"abcdefghijklmnopqrstuvwxyz_", *(c + "_" for c in "abcdefghijklmnopqrstuvwxyz"),
              "he_", "go_", "yes_", "the_"]
    vocab = str(tmp_path / "v.subwords")
    SubwordTokenizer(pieces).save(vocab)
    assert SubwordTokenizer.load(vocab).model_vocab_size == VOCAB
    maps = str(tmp_path / "a.npz")
    outputs = cli_translate.main(
        export + ["--src_vocab_file", vocab, "--tgt_vocab_file", vocab, "--max_len", "4",
                  "--sentences", "he go;yes", "--attention_out", maps, "--device=cpu"],
        stdout=io.StringIO())
    from transformer_tpu.train.evaluate import dump_attention_maps as j_dump

    jparams, _ = j_load_export(str(tmp_path))
    j_dump(jparams, jcfg, JTokenizer.load(vocab), JTokenizer.load(vocab), ["he go", "yes"],
           outputs, str(tmp_path / "want.npz"))
    got, want = np.load(maps), np.load(str(tmp_path / "want.npz"))
    assert sorted(got.files) == sorted(want.files) and len(got.files) == 2 * (2 + 2 * 3)
    for key in want.files:
        assert np.abs(got[key] - want[key]).max() <= 1e-5, key
