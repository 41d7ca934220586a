"""KV layout parity, ported from the JAX package's ``tests/test_kv_pool.py``
(the full-stack parity matrix and the rolling-window refusal): the port's
three layouts (dense, paged through gathered views, paged through the
kernels' plain versions) against JAX's scheduler on its default dense
layout, fp32 on converted weights, composed with chunked prefill, the
prefix cache (wave 2 replays wave 1's prompts: a full hit and a
divergent-tail partial hit) and speculative decoding at k 0 and 4, over
int8 and GQA (one kv head) variants. Greedy answers equal JAX's on every
layout; dense and paged-xla answers are equal to each other, sampled ones
included, and their step logits bit for bit in bf16 (the gathered views
run the dense step at the dense shapes). The paged layout refuses a
rolling window with JAX's message, and the dense layout's prefix restore
writes the blocks ``PrefixHit.stacked`` gives, which equal JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu.models import transformer_init
from transformer_tpu.serve import ContinuousScheduler as JScheduler
from transformer_tpu.serve import PrefixCache as JPrefixCache
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu_torch.config import ModelConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
from transformer_tpu_torch.serve.prefix_cache import PrefixCache
from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

VARIANTS = {"fp32": {}, "int8": dict(kv_cache_int8=True), "gqa": dict(num_kv_heads=1)}
LAYOUTS = {
    "dense": dict(kv_layout="dense"),
    "paged_xla": dict(kv_layout="paged", decode_kernel="xla"),
    "paged_flash": dict(kv_layout="paged", decode_kernel="paged_flash"),
}
WAVES = [
    [
        {"prompt": "ab cd ef gh ij", "max_new": 6},
        {"prompt": "ab cd ef gh kl", "max_new": 5, "temperature": 0.9, "seed": 3},
    ],
    [
        {"prompt": "ab cd ef gh ij", "max_new": 6},  # full hit
        {"prompt": "ab cd ef gh mn", "max_new": 4, "temperature": 0.7, "seed": 5},
        {"prompt": "mn", "max_new": 3},  # a miss
    ],
]
COMMON = dict(num_slots=2, max_total=48, default_max_new=4, prefill_chunk=4)


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    jtok = JTokenizer.build_from_corpus(["ab cd ef gh ij kl mn"] * 3, target_vocab_size=300)
    path = str(tmp_path_factory.mktemp("vocab") / "tiny.subwords")
    jtok.save(path)
    return jtok, SubwordTokenizer.load(path)


def _model(jtok, **extra):
    kw = dict(
        num_layers=1, d_model=16, num_heads=2, dff=32,
        input_vocab_size=jtok.model_vocab_size, target_vocab_size=jtok.model_vocab_size,
        max_position=64, decoder_only=True, tie_output=True, dtype="float32",
        dropout_rate=0.0,
    )
    kw.update(extra)
    jparams = transformer_init(jax.random.PRNGKey(0), JConfig(**kw))
    cfg = ModelConfig(**kw)
    return jparams, JConfig(**kw), params_from_numpy(_flatten(jparams), cfg, device="cpu"), cfg


def _waves(sched):
    return [sched.run([dict(r) for r in wave]) for wave in WAVES]


def _greedy(waves):
    return [[a for a, r in zip(wave, reqs) if "temperature" not in r]
            for wave, reqs in zip(waves, WAVES)]


@pytest.mark.parametrize("speculate_k", [0, 4])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_layouts_match_jax(tok, variant, speculate_k):
    jtok, ttok = tok
    jparams, jcfg, params, cfg = _model(jtok, **VARIANTS[variant])
    want = _waves(JScheduler(jparams, jcfg, jtok, speculate_k=speculate_k,
                             prefix_cache=JPrefixCache(jcfg, block_tokens=4, budget_mb=8),
                             **COMMON))
    got = {}
    for name, layout in LAYOUTS.items():
        sched = ContinuousScheduler(params, cfg, ttok, speculate_k=speculate_k, device="cpu",
                                    prefix_cache=PrefixCache(cfg, block_tokens=4, budget_mb=8),
                                    **layout, **COMMON)
        got[name] = _waves(sched)
        assert _greedy(got[name]) == _greedy(want), name
        assert sched.stats["prefix_hit_tokens"] > 0, name
        assert len(sched._free) == 2 and not sched._active
        if sched.alloc is not None:
            sched.alloc.check_consistency()
    assert got["dense"] == got["paged_xla"], "paged-xla answers differ from dense"
    assert any(a.get("continuation") for wave in got["dense"] for a in wave), "vacuous"


@pytest.mark.parametrize("variant", ["bf16", "int8"])
def test_dense_and_gathered_views_bit_identical(tok, variant):
    """The same slots admitted on both layouts: the next step's logits,
    plain and verify width, are equal bit for bit, and so are the answers."""
    jtok, ttok = tok
    extra = dict(dtype="bfloat16") if variant == "bf16" else dict(kv_cache_int8=True)
    _, _, params, cfg = _model(jtok, **extra)
    reqs = [{"prompt": "ab cd ef gh ij kl", "max_new": 9},
            {"prompt": "mn ab", "max_new": 7, "temperature": 0.8, "seed": 1}]
    scheds = {name: ContinuousScheduler(params, cfg, ttok, speculate_k=3, device="cpu",
                                        **LAYOUTS[name], **COMMON)
              for name in ("dense", "paged_xla")}
    for s in scheds.values():
        for r in reqs:
            s.submit(dict(r))
        s.admit()
        if s.paged:
            s._prepare(4)
    dense, paged = scheds["dense"], scheds["paged_xla"]
    rng = np.random.default_rng(0)
    index = np.asarray([st.pos for _, st in sorted(dense._active.items())], np.int32)
    for width in (1, 4):
        toks = rng.integers(3, cfg.target_vocab_size, (2, width))
        a = dense.forward.eager(toks, None, index)
        b = paged.forward.eager(toks, paged.alloc.table, index)
        assert torch.equal(a, b), width
    assert dense.run([]) == paged.run([])


def test_paged_refuses_rolling_window(tok):
    jtok, ttok = tok
    jparams, jcfg, params, cfg = _model(jtok, attention_window=8)
    with pytest.raises(ValueError) as want:
        JScheduler(jparams, jcfg, jtok, num_slots=2, max_total=48, kv_layout="paged")
    with pytest.raises(ValueError, match="rolling-window") as got:
        ContinuousScheduler(params, cfg, ttok, num_slots=2, max_total=48, kv_layout="paged",
                            device="cpu")
    assert str(got.value) == str(want.value)


def test_dense_prefix_restore_writes_stacked_blocks(tok):
    """Wave 1 feeds both tries; the wave-2 prompt then matches the same
    blocks in each. ``PrefixHit.stacked`` pads the hit to a power-of-two
    block count clamped to the slot buffer: the port's equals JAX's in
    width and values, and the dense restore writes exactly those rows into
    the slot (the suffix prefill then overwrites from the hit onward)."""
    jtok, ttok = tok
    jparams, jcfg, params, cfg = _model(jtok)
    jcache = JPrefixCache(jcfg, block_tokens=4, budget_mb=8)
    cache = PrefixCache(cfg, block_tokens=4, budget_mb=8)
    prompt = "ab cd ef gh ij kl mn ab cd ef gh ij kl mn ab"
    JScheduler(jparams, jcfg, jtok, prefix_cache=jcache, **COMMON).run([{"prompt": prompt}])
    sched = ContinuousScheduler(params, cfg, ttok, prefix_cache=cache, device="cpu", **COMMON)
    sched.run([{"prompt": prompt}])
    ids = [jtok.bos_id, *jtok.encode(prompt)]
    for cap in (48, 14):
        jhit, hit = jcache.match(ids[:-1]), cache.match(ids[:-1])
        try:
            assert hit.tokens == jhit.tokens > 4
            want, got = jhit.stacked(cap), hit.stacked(cap)
            assert len(got) == len(want) == cfg.num_layers
            for g, w in zip(got, want):
                assert sorted(g) == sorted(w)
                for key in g:
                    assert g[key].shape == w[key].shape and g[key].dtype == w[key].dtype
                    np.testing.assert_allclose(g[key], w[key], atol=1e-5, rtol=1e-5)
            padded = 4 * (1 << (hit.tokens // 4 - 1).bit_length())
            assert got[0]["k"].shape[1] == min(padded, cap)  # the pad clamped to the buffer
        finally:
            jhit.release()
            hit.release()
    from transformer_tpu_torch.serve.scheduler import _slot_restore

    hit = cache.match(ids[:-1])
    blocks = hit.stacked(sched.buf_len)
    hit.release()
    _slot_restore(sched.pools, 1, blocks)
    for layer, b in zip(sched.pools, blocks):
        width = b["k"].shape[1]
        assert np.array_equal(layer["k"][1, :width].numpy(), b["k"][0])
        assert np.array_equal(layer["v"][1, :width].numpy(), b["v"][0])
    assert cache.outstanding_refs() == 0
    again = sched.run([{"prompt": prompt}])
    assert sched.stats["prefix_hit_tokens"] > 0
    want = JScheduler(jparams, jcfg, jtok, prefix_cache=jcache, **COMMON).run([{"prompt": prompt}])
    assert again == want
