"""Masked-LM serving: the port's ``fill_mask`` and ``cli.serve``'s fill
requests against the JAX package's on the same export.

A tiny fp32 encoder-only model (2 layers, d 32, 4 heads, dff 64, the
flash attention impl run through its plain version, max_position 32) with
a subword vocabulary built from a few German lines plus [MASK], its
weights from a JAX init written as a JAX export. The answers hold the same
``filled`` text and candidate tokens as JAX's, in the same order, with
probabilities within 1e-5; an answer line with its probabilities taken
out is byte-identical to JAX's, and every error line is. The request
lines hold one marker, two markers, a ``top_k`` override, raw lines, a
text with no marker, a bad ``top_k``, a ``prompt`` and a ``src`` request
(JAX's routing errors), malformed JSON and an over-long text that poisons
its group. ``cli.serve.main --device cpu`` serves the export (grouped,
whatever ``--serve_slots`` says, as the JAX CLI), and an export written by
the port's ``cli.train --objective mlm --device cpu --dtype float32``
loads in JAX and answers the same there.
"""

import io
import json
import os

import jax
import numpy as np
import pytest

from transformer_tpu.cli import serve as j_serve
from transformer_tpu.cli.translate import load_export as j_load_export
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu.models import transformer_init
from transformer_tpu.train.checkpoint import export_params
from transformer_tpu.train.decode import fill_mask as j_fill_mask
from transformer_tpu_torch.cli import serve
from transformer_tpu_torch.convert import load_export
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer as TTokenizer
from transformer_tpu_torch.train.decode import fill_mask

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = ["er geht zur schule", "wo ist das haus", "ich mag es sehr",
          "das haus ist klein", "er mag die schule"] * 3
LONG = " ".join(["wo ist das haus er geht zur schule"] * 6) + " [MASK]"
LINES = [
    "er geht zur [MASK]",                                          # raw: a fill
    json.dumps({"fill": "wo ist das [MASK]"}),                     # default top_k 5
    json.dumps({"fill": "[MASK] mag es [MASK]", "top_k": 3}),      # two markers, top_k 3
    json.dumps({"fill": "das haus ist klein"}),                    # no marker
    json.dumps({"fill": "er [MASK]", "top_k": 0}),                 # bad top_k
    json.dumps({"prompt": "er geht"}),                             # routing
    json.dumps({"src": "he goes"}),                                # routing
    "{broken",                                                     # malformed
    json.dumps({"fill": LONG}),                                    # poisons its group
    json.dumps({"fill": "ich [MASK] es sehr", "top_k": 3}),        # the top_k 3 group
    json.dumps({"nothing": 1}),                                    # no kind
]


def _model_kw(vocab, **kw):
    return dict(num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=vocab,
                target_vocab_size=vocab, max_position=32, dtype="float32", dropout_rate=0.0,
                encoder_only=True, attention_impl="flash", **kw)


@pytest.fixture(scope="module")
def mlm(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mlm")
    jtok = JTokenizer.build_from_corpus(CORPUS, target_vocab_size=300)
    vocab = str(tmp / "tgt.subwords")
    jtok.save(vocab)
    jcfg = JConfig(**_model_kw(jtok.model_vocab_size + 1))
    jparams = transformer_init(jax.random.PRNGKey(3), jcfg)
    export = str(tmp / "export")
    export_params(jparams, jcfg, export)
    params, cfg = load_export(export, device="cpu")
    return dict(jtok=jtok, tok=TTokenizer.load(vocab), vocab=vocab, export=export,
                jcfg=jcfg, jparams=jparams, cfg=cfg, params=params)


def _split_probs(answer):
    """(the answer with its probabilities taken out, the probabilities)."""
    if "candidates" not in answer:
        return answer, []
    probs = [p for cands in answer["candidates"] for _, p in cands]
    bare = {**answer, "candidates": [[t for t, _ in cands] for cands in answer["candidates"]]}
    return bare, probs


def assert_same_answers(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gb, gp = _split_probs(g)
        wb, wp = _split_probs(w)
        assert json.dumps(gb) == json.dumps(wb)
        np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-5)
        if "candidates" in g:  # lists, not tuples: the JSON round trip keeps them
            assert all(isinstance(c, list) for cands in g["candidates"] for c in cands)


def test_fill_mask_matches_jax(mlm):
    texts = ["er geht zur [MASK]", "[MASK] ist das [MASK]", "ich mag es [MASK]"]
    want = j_fill_mask(mlm["jparams"], mlm["jcfg"], mlm["jtok"], texts, top_k=4)
    got = fill_mask(mlm["params"], mlm["cfg"], mlm["tok"], texts, top_k=4)
    assert [g["filled"] for g in got] == [w["filled"] for w in want]
    for g, w in zip(got, want):
        assert len(g["candidates"]) == len(w["candidates"])
        for gc, wc in zip(g["candidates"], w["candidates"]):
            assert [t for t, _ in gc] == [t for t, _ in wc]
            np.testing.assert_allclose([p for _, p in gc], [p for _, p in wc], atol=1e-5)
            assert all(isinstance(c, tuple) for c in gc)
    assert len(got[1]["candidates"]) == 2


@pytest.mark.parametrize("text, kw, match", [
    ("no marker here", {}, "no '\\[MASK\\]' marker"),
    ("er [MASK]", dict(top_k=0), "top_k must be in"),
    ("er [MASK]", dict(top_k=101), "top_k must be in"),
    (LONG, {}, "max_position is 32"),
])
def test_fill_mask_raises_as_jax(mlm, text, kw, match):
    with pytest.raises(ValueError, match=match):
        j_fill_mask(mlm["jparams"], mlm["jcfg"], mlm["jtok"], text, **kw)
    with pytest.raises(ValueError, match=match):
        fill_mask(mlm["params"], mlm["cfg"], mlm["tok"], text, **kw)


def test_fill_mask_refuses_other_families(mlm):
    import dataclasses

    cfg = dataclasses.replace(mlm["cfg"], encoder_only=False, decoder_only=True)
    with pytest.raises(ValueError, match="encoder_only"):
        fill_mask(mlm["params"], cfg, mlm["tok"], "er [MASK]")


def test_serve_lines_match_jax(mlm):
    want = j_serve.serve_lines(LINES, mlm["jparams"], mlm["jcfg"], mlm["jtok"], mlm["jtok"])
    got = serve.serve_lines(LINES, mlm["params"], mlm["cfg"], mlm["tok"], mlm["tok"])
    assert_same_answers(got, want)
    assert got[3] == {"error": "ValueError: no '[MASK]' marker in 'das haus ist klein'"}
    assert got[4] == {"error": "ValueError: top_k must be in [1, 100], got 0"}
    assert got[5] == {"error": "fill-mask export serves 'fill', not 'prompt'"}
    assert got[6] == {"error": "fill-mask export serves 'fill', not 'src'"}
    assert got[8]["error"].startswith("ValueError: a text encodes to")
    assert len(got[2]["candidates"]) == 2 and len(got[2]["candidates"][0]) == 3
    assert sum("filled" in a for a in got) == 4


def _serve_main(argv, lines):
    out = io.StringIO()
    serve.main([*argv, "--device", "cpu"], stdin=io.StringIO("".join(f"{ln}\n" for ln in lines)),
               stdout=out)
    return [json.loads(ln) for ln in out.getvalue().splitlines()]


@pytest.mark.parametrize("slots", ["0", "8"])
def test_main_serves_an_mlm_export_grouped(mlm, slots):
    want = j_serve.serve_lines(LINES, mlm["jparams"], mlm["jcfg"], mlm["jtok"], mlm["jtok"])
    got = _serve_main(["--export_path", mlm["export"], "--tgt_vocab_file", mlm["vocab"],
                       "--serve_slots", slots, "--serve_batch", "4"], LINES)
    assert_same_answers(got, want)


def test_cli_train_mlm_export_serves_the_same_in_jax(tmp_path):
    from transformer_tpu_torch.cli import train

    data = tmp_path / "data"
    data.mkdir()
    with open(os.path.join(ROOT, "data", "tgt-train.txt"), encoding="utf-8") as f:
        lines = [next(f) for _ in range(120)]
    for split, part in (("train", lines[:100]), ("test", lines[100:])):
        (data / f"tgt-{split}.txt").write_text("".join(part), encoding="utf-8")
        (data / f"src-{split}.txt").write_text("".join(part), encoding="utf-8")
    vocab, export = str(tmp_path / "v.subwords"), str(tmp_path / "export")
    logs = []
    trainer = train.main([
        "--device", "cpu", "--objective", "mlm", "--dataset_path", str(data),
        "--tgt_vocab_file", vocab, "--target_vocab_size", "400", "--num_layers", "1",
        "--d_model", "32", "--dff", "64", "--num_heads", "4", "--sequence_length", "32",
        "--batch_size", "8", "--epochs", "1", "--attention_impl", "flash", "--dtype", "float32",
        "--ckpt_path", str(tmp_path / "ckpt"), "--export_path", export,
    ], log_fn=logs.append)
    tok = TTokenizer.load(vocab)
    cfg = trainer.model_cfg
    assert cfg.encoder_only and cfg.input_vocab_size == tok.model_vocab_size + 1
    assert any(ln.startswith("eval loss") for ln in logs)
    assert not any("BLEU" in ln or "sample translation" in ln for ln in logs)
    jparams, jcfg = j_load_export(export)
    assert jcfg.encoder_only and jcfg.input_vocab_size == cfg.input_vocab_size
    requests = [json.dumps({"fill": "die [MASK] ist", "top_k": 3}), "ich [MASK] das",
                json.dumps({"x": 1})]
    jtok = JTokenizer.load(vocab)
    want = j_serve.serve_lines(requests, jparams, jcfg, jtok, jtok)
    got = _serve_main(["--export_path", export, "--tgt_vocab_file", vocab], requests)
    assert_same_answers(got, want)
    with pytest.raises(ValueError, match="length_buckets"):
        train.main(["--device", "cpu", "--objective", "mlm", "--length_buckets", "16,32",
                    "--dataset_path", str(data), "--tgt_vocab_file", vocab,
                    "--ckpt_path", str(tmp_path / "ckpt2")])
