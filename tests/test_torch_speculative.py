"""The port's speculative decoding against the JAX package's.

The numpy helpers (``build_verify_row`` with the n-gram drafter,
``judge_row``, ``filtered_probs``, ``sampled_accept``) must equal JAX's on
the same inputs (exactly; ``filtered_probs`` to 1e-6 absolute, fp32). The
port's ``ContinuousScheduler(speculate_k=k)`` (both kernels' plain versions
on the CPU) against JAX's ``ContinuousScheduler(kv_layout="paged",
decode_kernel="paged_flash", speculate_k=k)`` (Pallas in interpret mode),
fp32 on converted weights: greedy answers must be token-identical, under
the n-gram drafter and under a ``ModelDrafter`` on the same export, and
equal to the port's own ``speculate_k=0`` answers, with chunked prefill
feeding prompt tails through the verify rows.
"""

import jax
import numpy as np
import pytest

from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu.models import transformer_init
from transformer_tpu.serve import ContinuousScheduler as JScheduler
from transformer_tpu.serve import speculative as jspec
from transformer_tpu.train.checkpoint import _flatten, export_params
from transformer_tpu_torch.config import ModelConfig as TConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.data.seeding import keyed_rng
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer as TTokenizer
from transformer_tpu_torch.serve import speculative as tspec
from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

CORPUS = ["ab cd ef gh ij kl mn op qr st"] * 3
# Repeated n-grams give the n-gram drafter something to find.
REQUESTS = [
    {"prompt": "ab cd ef gh ab cd ef gh ab cd", "max_new": 9},
    {"prompt": "mn op", "max_new": 5},
    {"prompt": "qr st ab cd ef gh ij kl mn op qr st ab", "max_new": 8},
    {"prompt": "ef", "max_new": 3},
    {"prompt": "st qr op mn kl st qr op", "max_new": 10},
]
COMMON = dict(num_slots=2, max_total=48, default_max_new=4)


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
    jtok = vocab[0]
    jcfg, tcfg = JConfig(**_cfg_kw(jtok, **kw)), TConfig(**_cfg_kw(jtok, **kw))
    jparams = transformer_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_numpy(_flatten(jparams), tcfg, device="cpu")


@pytest.fixture(scope="module")
def models(vocab):
    return {name: _both(vocab, **kw)
            for name, kw in (("fp32", {}), ("int8", {"kv_cache_int8": True}))}


_JAX_ANSWERS: dict = {}


def _jax_answers(vocab, models, name, k, chunk):
    """JAX's speculative answers (n-gram drafter), computed once per case."""
    key = (name, k, chunk)
    if key not in _JAX_ANSWERS:
        jcfg, _, jparams, _ = models[name]
        sched = JScheduler(
            jparams, jcfg, vocab[0], kv_layout="paged", kv_block=4,
            decode_kernel="paged_flash", speculate_k=k, prefill_chunk=chunk, **COMMON,
        )
        _JAX_ANSWERS[key] = (sched.run([dict(r) for r in REQUESTS]), dict(sched.stats))
    return _JAX_ANSWERS[key]


def _port(vocab, models, name, k, chunk=3, drafter=None, reqs=REQUESTS):
    _, tcfg, _, tparams = models[name]
    sched = ContinuousScheduler(
        tparams, tcfg, vocab[1], kv_block=4, device="cpu", speculate_k=k,
        drafter=drafter, prefill_chunk=chunk, kv_layout="paged", decode_kernel="paged_flash",
        **COMMON,
    )
    return sched.run([dict(r) for r in reqs]), sched


# --------------------------------------------------------------------------
# the numpy helpers


HISTORIES = {
    "prompt tail": ([1, 5, 6, 7, 5, 6, 7, 5, 6], 3),
    "generation": ([1, 5, 6, 7, 5, 6, 7, 5, 6, 7, 5], 10),
    "no match": ([1, 2, 3, 4, 5], 4),
    "short": ([1, 9], 1),
}


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("case", sorted(HISTORIES))
def test_build_verify_row_with_ngram_drafter_equals_jax(case, k):
    history, pos = HISTORIES[case]
    jd, td = jspec.NgramDrafter(max_n=3), tspec.NgramDrafter(max_n=3)
    js, ts = jd.start(history), td.start(history)
    want = jspec.build_verify_row(history, pos, k, jd, js)
    assert tspec.build_verify_row(history, pos, k, td, ts) == want
    # grown contexts keep using the incremental index
    longer = history + [6, 7, 5]
    want = jspec.build_verify_row(longer, len(longer) - 1, k, jd, js)
    assert tspec.build_verify_row(longer, len(longer) - 1, k, td, ts) == want


def test_ngram_drafter_proposals_equal_jax_as_the_context_grows():
    rng = np.random.default_rng(0)
    ctx = [1]
    jd, td = jspec.NgramDrafter(max_n=4, min_n=2), tspec.NgramDrafter(max_n=4, min_n=2)
    js, ts = jd.start(ctx), td.start(ctx)
    for _ in range(60):
        ctx.append(int(rng.integers(3, 8)))
        for k in (1, 4):
            assert td.propose(ts, ctx, k) == jd.propose(js, ctx, k)


JUDGE_CASES = {
    # (row, pos, prompt_len, picks)
    "mismatch": ([4, 7, 8, 9], 10, 5, [7, 3, 9, 2]),
    "accept all and bonus": ([4, 7, 8, 9], 10, 5, [7, 8, 9, 6]),
    "prompt positions skipped": ([4, 5, 6, 9, 2], 2, 5, [1, 1, 3, 2, 8]),
    "all prompt": ([4, 5, 6], 0, 9, [1, 2, 3]),
    "bonus only": ([4], 7, 3, [11]),
}


@pytest.mark.parametrize("case", sorted(JUDGE_CASES))
def test_judge_row_equals_jax(case):
    row, pos, prompt_len, picks = JUDGE_CASES[case]

    def accept(j, draft):
        return picks[j] == draft, picks[j]

    want = jspec.judge_row(row, pos, prompt_len, accept, lambda j: picks[j])
    assert tspec.judge_row(row, pos, prompt_len, accept, lambda j: picks[j]) == want


@pytest.mark.parametrize(
    "temperature,top_k,top_p",
    [(1.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0), (1.3, 0, 0.8), (0.9, 12, 0.6)],
)
def test_filtered_probs_and_sampled_accept_equal_jax(temperature, top_k, top_p):
    rng = np.random.default_rng(7)
    for trial in range(8):
        logits = rng.standard_normal(40).astype(np.float32) * 3
        want = jspec.filtered_probs(logits, temperature, top_k, top_p)
        got = tspec.filtered_probs(logits, temperature, top_k, top_p)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        for draft in (int(np.argmax(want)), int(np.argmin(want)), trial):
            assert tspec.sampled_accept(got, draft, keyed_rng(3, trial)) == \
                jspec.sampled_accept(want, draft, keyed_rng(3, trial))


def test_sampled_accept_of_a_draft_holding_all_the_mass():
    probs = np.zeros(6, np.float32)
    probs[2] = 1.0
    assert tspec.sampled_accept(probs, 2, keyed_rng(0, 1)) == (True, 2)


# --------------------------------------------------------------------------
# the scheduler


@pytest.mark.parametrize("drafter", ["ngram", "model"])
@pytest.mark.parametrize("k", [1, 3])
def test_speculative_greedy_token_identical_to_jax(vocab, models, k, drafter):
    want, jstats = _jax_answers(vocab, models, "fp32", k, 3)
    d = None
    if drafter == "model":
        _, tcfg, _, tparams = models["fp32"]
        d = tspec.ModelDrafter(tparams, tcfg, COMMON["max_total"], eos_id=vocab[1].eos_id,
                               target_vocab_size=tcfg.target_vocab_size, device="cpu")
    got, sched = _port(vocab, models, "fp32", k, drafter=d)
    assert got == want
    assert any(r.get("continuation") for r in got), "vacuous: every answer empty"
    plain, _ = _port(vocab, models, "fp32", 0)
    assert got == plain
    st = sched.stats
    assert st["drafted"] > 0 and st["accepted"] > 0  # the drafts were real
    if drafter == "ngram":
        assert (st["drafted"], st["accepted"]) == (jstats["drafted"], jstats["accepted"])
    else:  # the draft is the target itself: it proposes the target's greedy picks
        assert st["accepted"] >= st["drafted"] // 2
    sched.alloc.check_consistency()
    assert sched.alloc.used_blocks == 0


def test_speculative_int8_pool_token_identical_to_jax(vocab, models):
    want, _ = _jax_answers(vocab, models, "int8", 3, 3)
    got, _ = _port(vocab, models, "int8", 3)
    assert got == want


@pytest.mark.parametrize("chunk", [0, 3, 8])
def test_speculation_with_chunked_prefill_gives_the_plain_answers(vocab, models, chunk):
    got, sched = _port(vocab, models, "fp32", 2, chunk=chunk)
    plain, _ = _port(vocab, models, "fp32", 0, chunk=chunk)
    assert got == plain
    assert sched.stats["prefill_tokens"] < sched.stats["prompt_tokens"]  # tails in verify rows


class _NoDrafts:
    def start(self, prompt_ids):
        return None

    def propose(self, state, context, k):
        return []


def test_sampled_requests_without_drafts_equal_the_plain_sampled_path(vocab, models):
    reqs = [dict(r, temperature=0.9, top_k=8, top_p=0.9, seed=i)
            for i, r in enumerate(REQUESTS)]
    got, sched = _port(vocab, models, "fp32", 3, drafter=_NoDrafts(), reqs=reqs)
    plain, _ = _port(vocab, models, "fp32", 0, reqs=reqs)
    assert got == plain
    assert sched.stats["drafted"] == 0
    # drafting opted out per request is the same path
    off, _ = _port(vocab, models, "fp32", 3, reqs=[dict(r, speculate=False) for r in reqs])
    assert off == plain


def test_sampled_speculation_is_seeded(vocab, models):
    reqs = [dict(r, temperature=0.8, seed=5) for r in REQUESTS]
    first, sched = _port(vocab, models, "fp32", 3, reqs=reqs)
    again, _ = _port(vocab, models, "fp32", 3, reqs=reqs)
    assert first == again and sched.stats["drafted"] > 0
    assert all("continuation" in r for r in first)


def test_draft_vocabulary_must_equal_the_targets(vocab, models, tmp_path):
    jcfg, tcfg, jparams, tparams = models["fp32"]
    with pytest.raises(ValueError, match="SHARED tokenizer"):
        tspec.ModelDrafter(tparams, tcfg, 48, target_vocab_size=tcfg.target_vocab_size + 1,
                           device="cpu")
    export = str(tmp_path / "draft")
    export_params(jparams, jcfg, export)
    with pytest.raises(ValueError, match="SHARED tokenizer"):
        tspec.drafter_from_flags(export, 3, 48, target_vocab_size=7, device="cpu")
    d = tspec.drafter_from_flags(export, 3, 48, target_vocab_size=tcfg.target_vocab_size,
                                 device="cpu")
    assert isinstance(d, tspec.ModelDrafter)
    assert isinstance(tspec.drafter_from_flags("", 2, 48), tspec.NgramDrafter)


def test_model_drafter_proposals_equal_jax(vocab, models):
    jcfg, tcfg, jparams, tparams = models["fp32"]
    jd = jspec.ModelDrafter(jparams, jcfg, 48, eos_id=vocab[0].eos_id)
    td = tspec.ModelDrafter(tparams, tcfg, 48, eos_id=vocab[1].eos_id, device="cpu")
    ids = [vocab[1].bos_id, *vocab[1].encode("ab cd ef gh ij")]
    js, ts = jd.start(ids), td.start(ids)
    ctx = list(ids)
    for step in range(4):
        want = jd.propose(js, ctx, 3)
        assert td.propose(ts, ctx, 3) == want
        ctx += want[:1] + [5 + step]  # accept one draft, then a correction
    assert td.propose(ts, ctx[:-3], 2) == jd.propose(js, ctx[:-3], 2)  # rollback


def test_bad_requests_under_speculation_answer_alone(vocab, models):
    got, sched = _port(vocab, models, "fp32", 3, reqs=[
        {"prompt": "ab " * 60},  # over the 48-token slot budget
        {"prompt": "ab cd ab cd", "max_new": 4},
        {"prompt": "cd", "temperature": 0.7, "top_k": 10_000},
        {"prompt": "ef gh", "max_new": 0},
    ])
    assert got[0]["code"] == "validation" and "serve_max_total" in got[0]["error"]
    assert "continuation" in got[1]
    assert got[2]["code"] == "validation" and "top_k" in got[2]["error"]
    assert got[3] == {"continuation": ""}
    sched.alloc.check_consistency()
    assert sched.alloc.used_blocks == 0


def test_scheduler_refuses_negative_speculate_k(vocab, models):
    _, tcfg, _, tparams = models["fp32"]
    with pytest.raises(ValueError, match="speculate_k"):
        ContinuousScheduler(tparams, tcfg, vocab[1], device="cpu", speculate_k=-1)
