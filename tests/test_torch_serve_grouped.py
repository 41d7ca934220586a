"""The grouped serving path: the port's ``cli.serve.serve_lines`` and its
loop against the JAX package's ``serve_lines``, answer JSON byte for byte.

A tiny fp32 translator (2 + 2 layers, d 32, 4 heads, dff 64, the flash
encoder, max_position 32) and a tiny fp32 LM, with weights converted from
a JAX init. The request lines hold greedy requests, ``beam`` 2, a
``max_len`` override, raw lines, malformed JSON, an unconvertible field,
kind mismatches and a group that one over-length member poisons (the
group is retried member by member, so only that member answers an
error). Grouped answers carry no ``code``. A sampled LM request runs
alone and answers as the port's continuous scheduler does at its seed.
``translate`` is called once per signature group (counted as JAX's
``tests/test_flags.py`` counts it), once more per member of a poisoned
group. ``cli.serve.main --device cpu`` serves a seq2seq export (always
grouped, whatever ``--serve_slots`` says) and an LM export at
``--serve_slots 0``, and an encoder-only export (grouped) answers JAX's
routing errors to ``prompt`` and ``src`` requests.
"""

import io
import json

import jax
import pytest

from transformer_tpu.cli import serve as j_serve
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu.models import transformer_init
from transformer_tpu.train.checkpoint import _flatten, export_params
from transformer_tpu_torch.cli import serve
from transformer_tpu_torch.config import ModelConfig as TConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer as TTokenizer
from transformer_tpu_torch.serve.scheduler import ContinuousScheduler
from transformer_tpu_torch.train import decode

SRC_CORPUS = ["he goes to school", "where is the house", "i like it very much"] * 3
TGT_CORPUS = ["er geht zur schule", "wo ist das haus", "ich mag es sehr"] * 3
LONG = " ".join(["where is the house he goes to school"] * 6)
S2S_LINES = [
    "he goes to school",                                  # raw: greedy group
    json.dumps({"src": "where is the house", "beam": 2}),  # beam-2 group
    "i like it",                                          # raw: greedy group
    "{broken json",                                       # malformed
    json.dumps({"prompt": "he goes"}),                    # kind mismatch
    json.dumps({"src": LONG}),                            # poisons the greedy group
    json.dumps({"src": "the house", "beam": 2}),          # beam-2 group
    json.dumps({"src": "he likes it", "max_len": 5}),     # its own group
    json.dumps({"src": "he", "beam": "four"}),            # unconvertible field
    json.dumps({"nothing": 1}),                           # no kind at all
    json.dumps(["he goes"]),                              # raw line starting with [
]
LM_LINES = [
    "er geht zur",                                                   # raw: greedy
    json.dumps({"prompt": "wo ist", "max_new": 6}),
    json.dumps({"prompt": "ich mag", "max_new": 6}),
    json.dumps({"src": "he goes"}),                                   # kind mismatch
    json.dumps({"fill": "er [MASK]"}),                                # kind mismatch
    json.dumps({"prompt": " ".join(["wo ist das haus"] * 12), "max_new": 6}),  # poisons
    json.dumps({"prompt": "das haus", "max_new": "six"}),             # unconvertible
    "{]",                                                             # malformed
]
SAMPLED = {"prompt": "er geht", "max_new": 8, "temperature": 0.9, "top_k": 10, "seed": 4}


def _model_kw(src_vocab, tgt_vocab, **kw):
    return dict(
        num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=src_vocab,
        target_vocab_size=tgt_vocab, max_position=32, dtype="float32", dropout_rate=0.0,
        **kw,
    )


def _tokenizers(corpus, tmp):
    tok = JTokenizer.build_from_corpus(corpus, target_vocab_size=300)
    tok.save(str(tmp))
    return tok, TTokenizer.load(str(tmp)), str(tmp)


@pytest.fixture(scope="module")
def s2s(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("s2s")
    src = _tokenizers(SRC_CORPUS, tmp / "src.subwords")
    tgt = _tokenizers(TGT_CORPUS, tmp / "tgt.subwords")
    kw = _model_kw(src[0].model_vocab_size, tgt[0].model_vocab_size, attention_impl="flash")
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jparams = transformer_init(jax.random.PRNGKey(1), jcfg)
    export = str(tmp / "export")
    export_params(jparams, jcfg, export)
    params = params_from_numpy(_flatten(jparams), tcfg, device="cpu")
    return dict(jcfg=jcfg, cfg=tcfg, jparams=jparams, params=params, src=src, tgt=tgt,
                export=export)


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm")
    tok = _tokenizers(TGT_CORPUS, tmp / "tgt.subwords")
    v = tok[0].model_vocab_size
    kw = _model_kw(v, v, decoder_only=True)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jparams = transformer_init(jax.random.PRNGKey(2), jcfg)
    export = str(tmp / "export")
    export_params(jparams, jcfg, export)
    params = params_from_numpy(_flatten(jparams), tcfg, device="cpu")
    return dict(jcfg=jcfg, cfg=tcfg, jparams=jparams, params=params, tok=tok, export=export)


def _dumps(answers):
    return [json.dumps(a) for a in answers]


def _jax_s2s(m, lines, **kw):
    return j_serve.serve_lines(lines, m["jparams"], m["jcfg"], m["src"][0], m["tgt"][0],
                               default_max_len=8, **kw)


def _count_translate(monkeypatch):
    calls = []
    real = decode.translate

    def counted(params, cfg, src_tok, tgt_tok, sentences, **kw):
        calls.append((tuple(sentences), kw["beam_size"], kw["max_len"]))
        return real(params, cfg, src_tok, tgt_tok, sentences, **kw)

    monkeypatch.setattr(decode, "translate", counted)
    return calls


def test_seq2seq_answers_equal_jax_byte_for_byte(s2s, monkeypatch):
    calls = _count_translate(monkeypatch)
    want = _jax_s2s(s2s, S2S_LINES)
    got = serve.serve_lines(S2S_LINES, s2s["params"], s2s["cfg"], s2s["src"][1],
                            s2s["tgt"][1], default_max_len=8)
    assert _dumps(got) == _dumps(want)
    assert got[4] == {"error": "seq2seq export serves 'src', not 'prompt'"}
    assert got[5]["error"].startswith("ValueError: a sentence encodes to")
    assert got[3]["error"].startswith("JSONDecodeError: ")
    assert not any("code" in a for a in got)
    assert sum("translation" in a for a in got) == 6 and any(a.get("translation") for a in got)
    # One call per group: greedy (whose 4 members then run alone: a raw
    # line starting with '[' is a source too), beam 2 and max_len 5.
    greedy = ("he goes to school", "i like it", LONG, '["he goes"]')
    assert calls == [(greedy, 1, 8), *(((s,), 1, 8) for s in greedy),
                     (("where is the house", "the house"), 2, 8), (("he likes it",), 1, 5)]


def test_default_beam_and_max_len_follow_the_flags(s2s):
    lines = ["he goes to school", json.dumps({"src": "i like it", "beam": 1})]
    want = _jax_s2s(s2s, lines, default_beam=3)
    got = serve.serve_lines(lines, s2s["params"], s2s["cfg"], s2s["src"][1], s2s["tgt"][1],
                            default_max_len=8, default_beam=3)
    assert _dumps(got) == _dumps(want)


def test_one_translate_per_signature_group(monkeypatch):
    """The grouping contract on a stub translate, as JAX's test counts it."""
    calls = []

    def fake_translate(params, cfg, src_tok, tgt_tok, sentences, **kw):
        calls.append((tuple(sentences), kw["beam_size"]))
        return [f"T({s})" for s in sentences]

    monkeypatch.setattr(decode, "translate", fake_translate)
    cfg = TConfig(num_layers=1, d_model=16, num_heads=2, dff=32, input_vocab_size=32,
                  target_vocab_size=32, max_position=16, decoder_only=False)
    lines = ["hello there", '{"src": "b", "beam": 2}', "not json but raw", "{broken json",
             '{"src": "c", "beam": 2}']
    resp = serve.serve_lines(lines, None, cfg, None, None)
    assert len(calls) == 2
    grouped = {beam: s for s, beam in calls}
    assert grouped[1] == ("hello there", "not json but raw")
    assert grouped[2] == ("b", "c")
    assert resp[0] == {"translation": "T(hello there)"}
    assert resp[1] == {"translation": "T(b)"}
    assert resp[2] == {"translation": "T(not json but raw)"}
    assert "error" in resp[3]
    assert resp[4] == {"translation": "T(c)"}


def test_lm_answers_equal_jax_byte_for_byte(lm):
    want = j_serve.serve_lines(LM_LINES, lm["jparams"], lm["jcfg"], lm["tok"][0], lm["tok"][0],
                               default_max_len=8, prefill_chunk=4)
    got = serve.serve_lines(LM_LINES, lm["params"], lm["cfg"], lm["tok"][1], lm["tok"][1],
                            default_max_len=8, prefill_chunk=4)
    assert _dumps(got) == _dumps(want)
    assert got[3] == {"error": "LM export serves 'prompt', not 'src'"}
    assert got[4] == {"error": "LM export serves 'prompt', not 'fill'"}
    assert got[5]["error"].startswith("ValueError: a prompt encodes to")
    assert sum("continuation" in a for a in got) == 3 and any(a.get("continuation") for a in got)


def test_sampled_lm_request_runs_alone_as_the_scheduler_answers(lm, monkeypatch):
    sizes = []
    real = decode.generate

    def counted(params, cfg, tok, prompts, **kw):
        sizes.append((len(prompts), kw["temperature"]))
        return real(params, cfg, tok, prompts, **kw)

    monkeypatch.setattr(decode, "generate", counted)
    lines = [json.dumps(SAMPLED), json.dumps(SAMPLED), json.dumps({**SAMPLED, "seed": 5}),
             json.dumps({"prompt": "wo ist", "max_new": 8, "seed": 9}),
             json.dumps({"prompt": "ich", "max_new": 8})]
    got = serve.serve_lines(lines, lm["params"], lm["cfg"], lm["tok"][1], lm["tok"][1])
    # Three sampled requests alone; the two greedy ones (a seed is
    # ignored there) in one group.
    assert sorted(sizes) == [(1, 0.9), (1, 0.9), (1, 0.9), (2, 0.0)]
    sched = ContinuousScheduler(lm["params"], lm["cfg"], lm["tok"][1], num_slots=2,
                                kv_block=4, kv_layout="paged", decode_kernel="paged_flash",
                                device="cpu")
    want = sched.run([json.loads(line) for line in lines])
    assert got == want
    assert got[0] == got[1] and got[0] != got[2]


def _serve_main(argv, lines):
    out = io.StringIO()
    result = serve.main(argv + ["--device", "cpu"], stdin=io.StringIO("\n".join(lines) + "\n"),
                        stdout=out)
    return out.getvalue().splitlines(), result


@pytest.mark.parametrize("slots", ["0", "4"])
def test_main_serves_a_seq2seq_export_grouped(s2s, slots):
    want = _dumps(_jax_s2s(s2s, S2S_LINES))
    got, batches = _serve_main(
        ["--export_path", s2s["export"], "--src_vocab_file", s2s["src"][2],
         "--tgt_vocab_file", s2s["tgt"][2], "--max_len", "8", "--serve_batch", "64",
         "--serve_slots", slots], S2S_LINES + [""],
    )
    assert got == want
    assert sum(b["size"] for b in batches) == len(S2S_LINES)
    assert sum(b["errors"] for b in batches) == 5


def test_main_one_vocab_file_serves_both_sides(s2s, tmp_path):
    """The source and target vocab flags naming one file load one
    tokenizer (the JAX CLI's rule)."""
    lines = ["er geht", json.dumps({"src": "wo ist", "beam": 2})]
    kw = _model_kw(s2s["tgt"][0].model_vocab_size, s2s["tgt"][0].model_vocab_size)
    jcfg = JConfig(**kw)
    jparams = transformer_init(jax.random.PRNGKey(3), jcfg)
    export_params(jparams, jcfg, str(tmp_path))
    want = j_serve.serve_lines(lines, jparams, jcfg, s2s["tgt"][0], s2s["tgt"][0],
                               default_max_len=8)
    got, _ = _serve_main(["--export_path", str(tmp_path), "--src_vocab_file", s2s["tgt"][2],
                          "--tgt_vocab_file", s2s["tgt"][2], "--max_len", "8"], lines)
    assert got == _dumps(want)


def test_main_serves_an_lm_export_at_zero_slots(lm):
    want = j_serve.serve_lines(LM_LINES, lm["jparams"], lm["jcfg"], lm["tok"][0], lm["tok"][0],
                               default_max_len=8)
    got, batches = _serve_main(
        ["--export_path", lm["export"], "--tgt_vocab_file", lm["tok"][2], "--max_len", "8",
         "--serve_slots", "0", "--serve_batch", "3"], LM_LINES,
    )
    assert got == _dumps(want)
    assert all(b["size"] <= 3 for b in batches) and len(batches) >= 3


def test_main_refuses_an_encoder_only_export(tmp_path):
    """An encoder-only export refuses every request kind but 'fill', with
    JAX's routing errors, and answers fills as JAX does."""
    tok = _tokenizers(TGT_CORPUS, tmp_path / "tgt.subwords")
    v = tok[0].model_vocab_size + 1  # + [MASK]
    jcfg = JConfig(**_model_kw(v, v, encoder_only=True))
    jparams = transformer_init(jax.random.PRNGKey(0), jcfg)
    export_params(jparams, jcfg, str(tmp_path / "export"))
    lines = [json.dumps({"prompt": "er geht"}), json.dumps({"src": "he goes"}),
             json.dumps({"fill": "er [MASK]", "top_k": 1})]
    want = j_serve.serve_lines(lines, jparams, jcfg, tok[0], tok[0])
    out = io.StringIO()
    serve.main(["--export_path", str(tmp_path / "export"), "--tgt_vocab_file", tok[2],
                "--device", "cpu"], stdin=io.StringIO("".join(f"{ln}\n" for ln in lines)),
               stdout=out)
    got = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert got[:2] == want[:2] == [{"error": "fill-mask export serves 'fill', not 'prompt'"},
                                   {"error": "fill-mask export serves 'fill', not 'src'"}]
    assert got[2]["filled"] == want[2]["filled"]
    assert [c[0][0] for c in got[2]["candidates"]] == [c[0][0] for c in want[2]["candidates"]]
    assert abs(got[2]["candidates"][0][0][1] - want[2]["candidates"][0][0][1]) <= 1e-5
