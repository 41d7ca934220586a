"""Attention maps (``return_weights``, ``train/evaluate.py``
``dump_attention_maps``, ``cli.translate --attention_out``) against the
JAX package, fp32, weights from a JAX init (2 layers, d 32, 4 heads).

- ``dump_attention_maps`` writes the keys of JAX's dump (``s{i}/src_ids``,
  ``s{i}/tgt_ids``, ``s{i}/encoder_layer{L}``,
  ``s{i}/decoder_layer{L}_block{1,2}``), every map within 1e-5 of JAX's:
  seq2seq post-LN and pre-LN with GQA, decoder-only, encoder-only. Under
  flash, as in JAX, the blockwise self-attention keeps no map: a
  decoder-only export writes the ids only, a seq2seq one the ids and the
  cross-attention maps (which take the plain path).
- Every map row sums to 1, and a decoder self-attention map is zero above
  the diagonal.
- ``transformer_apply(return_weights=True)`` returns the logits of the
  plain call.
- ``cli.translate --attention_out`` on an fp32 xla export converted from
  JAX writes JAX's dump of the same translations, within 1e-5; on a flash
  export, JAX's keys.
"""

import io
import os

import jax
import numpy as np
import pytest
import torch

from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu.models import transformer_init
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu.train.checkpoint import export_params as j_export_params
from transformer_tpu.train.evaluate import dump_attention_maps as j_dump
from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
from transformer_tpu_torch.models.transformer import transformer_apply
from transformer_tpu_torch.train.evaluate import dump_attention_maps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ["he go to school", "the house is big and old", "yes"]
TARGETS = ["er geht zur schule", "das haus", ""]
VARIANTS = {
    "seq2seq": {},
    "pre_gqa": dict(norm_scheme="pre", num_kv_heads=2),
    "decoder_only": dict(decoder_only=True),
    "encoder_only": dict(encoder_only=True),
}


@pytest.fixture(scope="module")
def tok():
    with open(os.path.join(ROOT, "data", "src-train.txt"), encoding="utf-8") as f:
        lines = [next(f) for _ in range(200)]
    return SubwordTokenizer.build_from_corpus(lines + TARGETS, target_vocab_size=400)


def _model(tok, **extra):
    return dict(num_layers=2, d_model=32, num_heads=4, dff=64,
                input_vocab_size=tok.model_vocab_size, target_vocab_size=tok.model_vocab_size,
                max_position=64, dropout_rate=0.0, dtype="float32", **extra)


def _both(kw):
    jparams = transformer_init(jax.random.PRNGKey(0), JConfig(**kw))
    return jparams, params_from_numpy(_flatten(jparams), ModelConfig(**kw), device="cpu")


def _hold(got_path, want_path):
    got, want = np.load(got_path), np.load(want_path)
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
        if key.endswith("_ids"):
            assert np.array_equal(got[key], want[key]), key
        else:
            assert np.abs(got[key] - want[key]).max() <= 1e-5, key
    return got


@pytest.mark.parametrize("impl,variant", [
    *(("xla", v) for v in sorted(VARIANTS)), ("flash", "seq2seq"), ("flash", "decoder_only"),
])
def test_dump_equals_jax(tok, tmp_path, impl, variant):
    kw = _model(tok, attention_impl=impl, **VARIANTS[variant])
    jparams, params = _both(kw)
    got_path, want_path = str(tmp_path / "got.npz"), str(tmp_path / "want.npz")
    assert dump_attention_maps(params, ModelConfig(**kw), tok, tok, SOURCES, TARGETS,
                               got_path) == 3
    j_dump(jparams, JConfig(**kw), JTokenizer(tok.subwords), JTokenizer(tok.subwords),
           SOURCES, TARGETS, want_path)
    got = _hold(got_path, want_path)
    maps = [k for k in got.files if not k.endswith("_ids")]
    if impl == "flash":
        want = [] if variant == "decoder_only" else ["block2"]
        assert sorted({k.rsplit("_", 1)[-1] for k in maps}) == want
    else:
        assert len(maps) == 3 * 2 * (1 if variant in ("decoder_only", "encoder_only") else 3)
    for key in maps:
        w = got[key]
        assert w.shape[0] == 4 and np.allclose(w.sum(-1), 1.0, atol=1e-5), key
        if key.endswith("block1"):
            assert not np.triu(w, k=1).any(), key


@pytest.mark.parametrize("variant", ["seq2seq", "decoder_only"])
def test_return_weights_keeps_the_logits(tok, variant):
    kw = _model(tok, **VARIANTS[variant])
    _, params = _both(kw)
    cfg = ModelConfig(**kw)
    g = torch.Generator().manual_seed(0)
    src = torch.randint(1, tok.vocab_size, (2, 9), generator=g)
    tgt = torch.randint(1, tok.vocab_size, (2, 7), generator=g)
    tgt[1, 5:] = 0
    logits, maps = transformer_apply(params, src, tgt, cfg, return_weights=True)
    assert torch.equal(logits, transformer_apply(params, src, tgt, cfg))
    assert maps["decoder_layer1_block1"].shape == (2, 4, 7, 7)
    assert maps["decoder_layer1_block1"].dtype == torch.float32


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_cli_translate_attention_out_equals_jax(tok, tmp_path, impl):
    from transformer_tpu_torch.cli import translate

    vocab = str(tmp_path / "v.subwords")
    tok.save(vocab)
    kw = _model(tok, attention_impl=impl)
    jparams = transformer_init(jax.random.PRNGKey(1), JConfig(**kw))
    export = str(tmp_path / "export")
    j_export_params(jparams, JConfig(**kw), export)
    out_path = str(tmp_path / "maps.npz")
    outputs = translate.main(["--device=cpu", "--export_path", export, "--src_vocab_file",
                              vocab, "--tgt_vocab_file", vocab, "--max_len", "8",
                              "--sentences", ";".join(SOURCES), "--attention_out", out_path],
                             stdout=io.StringIO())
    assert len(outputs) == 3
    j_dump(jparams, JConfig(**kw), JTokenizer.load(vocab), JTokenizer.load(vocab), SOURCES,
           outputs, str(tmp_path / "want.npz"))
    got = _hold(out_path, str(tmp_path / "want.npz"))
    assert all(f"s{i}/src_ids" in got.files for i in range(3))
