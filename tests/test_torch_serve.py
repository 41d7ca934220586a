"""The port's serving path against the JAX package's, on converted weights.

The port's ``ContinuousScheduler`` (paged KV pool, both kernels' plain
versions on the CPU) against JAX's ``ContinuousScheduler(kv_layout=
"paged", decode_kernel="paged_flash")`` (Pallas in interpret mode): 2
slots, more requests than slots, chunked prefill with prompt tails fed
through decode steps, prompts ending mid-block. Greedy answers must be
token-identical (fp32). Then ``transformer_tpu_torch.cli.serve --device
cpu`` over an export written by JAX ``export_params`` answers the same
JSONL, plus the routing and parse errors the JAX CLI gives.
"""

import io
import json

import jax
import pytest

from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu.models import transformer_init
from transformer_tpu.serve import ContinuousScheduler as JScheduler
from transformer_tpu.train.checkpoint import _flatten, export_params
from transformer_tpu_torch.cli import serve
from transformer_tpu_torch.config import ModelConfig as TConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer as TTokenizer
from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

CORPUS = ["ab cd ef gh ij kl mn op qr st"] * 3
REQUESTS = [
    {"prompt": "ab cd ef gh ij kl", "max_new": 6},
    {"prompt": "mn op", "max_new": 5},
    {"prompt": "qr st ab cd ef gh ij kl mn op qr", "max_new": 7},
    {"prompt": "ef", "max_new": 3},
    {"prompt": "st qr op mn kl", "max_new": 8},
]
COMMON = dict(num_slots=2, max_total=48, default_max_new=4, prefill_chunk=3)


def _cfg_kw(tok, **kw):
    return dict(
        num_layers=2, d_model=32, num_heads=4, dff=64,
        input_vocab_size=tok.model_vocab_size,
        target_vocab_size=tok.model_vocab_size, max_position=64,
        decoder_only=True, dtype="float32", dropout_rate=0.0, **kw,
    )


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    tok = JTokenizer.build_from_corpus(CORPUS, target_vocab_size=300)
    path = str(tmp_path_factory.mktemp("vocab") / "tiny.subwords")
    tok.save(path)
    return tok, TTokenizer.load(path), path


def _both(vocab, **kw):
    jtok, ttok, _ = vocab
    jcfg, tcfg = JConfig(**_cfg_kw(jtok, **kw)), TConfig(**_cfg_kw(jtok, **kw))
    jparams = transformer_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_numpy(_flatten(jparams), tcfg, device="cpu")


def _jax_answers(vocab, jcfg, jparams):
    sched = JScheduler(
        jparams, jcfg, vocab[0], kv_layout="paged", kv_block=4,
        decode_kernel="paged_flash", **COMMON,
    )
    return sched.run([dict(r) for r in REQUESTS])


def test_tokenizers_agree(vocab):
    jtok, ttok, _ = vocab
    for text in ("ab cd ef", "qr st zz", "mn_op <0x41> ü"):
        assert ttok.encode(text) == jtok.encode(text)
        assert ttok.decode(ttok.encode(text)) == jtok.decode(jtok.encode(text))
    assert (ttok.bos_id, ttok.eos_id) == (jtok.bos_id, jtok.eos_id)


@pytest.mark.parametrize(
    "variant", [{}, {"kv_cache_int8": True}, {"num_kv_heads": 2}],
    ids=["fp32", "int8", "gqa"],
)
def test_scheduler_greedy_token_identical_to_jax(vocab, variant):
    jcfg, tcfg, jparams, tparams = _both(vocab, **variant)
    want = _jax_answers(vocab, jcfg, jparams)
    sched = ContinuousScheduler(tparams, tcfg, vocab[1], kv_block=4, device="cpu", **COMMON)
    got = sched.run([dict(r) for r in REQUESTS])
    assert got == want
    assert any(r.get("continuation") for r in got), "vacuous: every answer empty"
    assert sched.stats["max_active"] == 2  # more requests than slots
    assert sched.stats["prefill_tokens"] < sched.stats["prompt_tokens"]  # tails fed by steps
    sched.alloc.check_consistency()
    assert sched.alloc.used_blocks == 0  # every retired slot returned its blocks


def test_cli_serves_jax_export(vocab, tmp_path):
    jcfg, _, jparams, _ = _both(vocab)
    want = _jax_answers(vocab, jcfg, jparams)
    export = str(tmp_path / "export")
    export_params(jparams, jcfg, export)
    lines = [json.dumps(r) for r in REQUESTS] + ['{"src": "ab"}', "{not json", "cd ef"]
    out = io.StringIO()
    serve.main(
        [
            "--export_path", export, "--tgt_vocab_file", vocab[2],
            "--serve_slots", "2", "--serve_max_total", "48", "--prefill_chunk", "3",
            "--prefix_block", "4", "--max_len", "4", "--device", "cpu",
        ],
        stdin=io.StringIO("\n".join(lines) + "\n"), stdout=out,
    )
    answers = [json.loads(line) for line in out.getvalue().splitlines()]
    assert answers[: len(REQUESTS)] == want
    assert answers[len(REQUESTS)] == {
        "error": "LM export serves 'prompt', not 'src'", "code": "routing"
    }
    assert answers[len(REQUESTS) + 1]["code"] == "validation"
    assert "continuation" in answers[len(REQUESTS) + 2]  # a raw line is a prompt
    assert len(answers) == len(lines)


def test_admission_errors_answer_alone(vocab):
    _, tcfg, _, tparams = _both(vocab)
    sched = ContinuousScheduler(tparams, tcfg, vocab[1], kv_block=4, device="cpu", **COMMON)
    got = sched.run([
        {"prompt": "ab " * 60},  # over the 48-token slot budget
        {"prompt": "ab cd", "max_new": 2},
        {"prompt": "cd", "temperature": 0.7, "top_k": 10_000},
    ])
    assert got[0]["code"] == "validation" and "serve_max_total" in got[0]["error"]
    assert "continuation" in got[1]
    assert got[2]["code"] == "validation" and "top_k" in got[2]["error"]


def test_sampled_requests_are_seeded_and_independent_of_neighbours(vocab):
    _, tcfg, _, tparams = _both(vocab)
    req = {"prompt": "ab cd ef", "max_new": 6, "temperature": 1.0, "top_p": 0.9, "seed": 5}

    def serve_with(neighbours):
        sched = ContinuousScheduler(
            tparams, tcfg, vocab[1], kv_block=4, device="cpu", **COMMON
        )
        return sched.run([dict(req)] + neighbours)[0]

    alone = serve_with([])
    assert alone == serve_with([{"prompt": "qr st", "max_new": 5}])
    assert alone == serve_with([dict(req, seed=6), {"prompt": "kl", "max_new": 3}])
