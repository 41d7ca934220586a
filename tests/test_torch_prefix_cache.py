"""The port's prefix cache against the JAX package's.

The trie (insert, match, release, LRU eviction under a byte budget, the
device tier's donation, aliasing and spill) is driven through the port's
``PrefixCache`` and JAX's with the same operations: hit lengths,
evictions, ``bytes_used`` and pool refcounts must be equal. Pool blocks
round-trip bit-identical through the host block format (bf16 as raw
16-bit patterns, int8 codes with their scales) and carry JAX's bytes.
Served on converted weights, fp32, greedy answers with the cache on must
equal the answers with it off and JAX's with its cache on (paged_flash,
Pallas in interpret mode), across ``speculate_k`` and ``prefill_chunk``;
a small pool spills to the host tier with the same answers; a corrupt
block is dropped at match and the request prefills in full.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.data.tokenizer import SubwordTokenizer as JTokenizer
from transformer_tpu.kernels.kv_pool import KVPool as JKVPool
from transformer_tpu.models import transformer_init
from transformer_tpu.ops.attention import init_block_pool as j_init_block_pool
from transformer_tpu.serve import ContinuousScheduler as JScheduler
from transformer_tpu.serve import PrefixCache as JPrefixCache
from transformer_tpu.serve.scheduler import _pool_read_block as j_pool_read_block
from transformer_tpu.train.checkpoint import _flatten, export_params
from transformer_tpu_torch.cli import serve
from transformer_tpu_torch.config import ModelConfig as TConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.data.tokenizer import SubwordTokenizer as TTokenizer
from transformer_tpu_torch.kernels.kv_pool import (
    KVPool,
    pool_copy_blocks,
    pool_read_block,
    pool_write_blocks,
)
from transformer_tpu_torch.ops.attention import (
    _quantize_kv,
    init_cache,
    insert_kv_blocks,
    rollback_cache,
    slice_kv_blocks,
)
from transformer_tpu_torch.serve.prefix_cache import PrefixCache, PrefixCorruptionError
from transformer_tpu_torch.serve.scheduler import ContinuousScheduler
from transformer_tpu_torch.serve.speculative import ModelDrafter

CORPUS = ["ab cd ef gh ij kl mn op qr st"] * 3
SYSTEM = "ab cd ef gh ij kl mn op qr st ab cd"
REQUESTS = [
    {"prompt": SYSTEM + " ef gh", "max_new": 5},
    {"prompt": SYSTEM + " mn", "max_new": 4},
    {"prompt": "qr st ab cd ef gh ij", "max_new": 6},
    {"prompt": SYSTEM + " op qr st ab", "max_new": 6},
    {"prompt": SYSTEM, "max_new": 3},
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


@pytest.fixture(scope="module")
def models(vocab):
    out = {}
    for name, kw in (("fp32", {}), ("int8", {"kv_cache_int8": True})):
        jcfg, tcfg = JConfig(**_cfg_kw(vocab[0], **kw)), TConfig(**_cfg_kw(vocab[0], **kw))
        jparams = transformer_init(jax.random.PRNGKey(0), jcfg)
        out[name] = (jcfg, tcfg, jparams,
                     params_from_numpy(_flatten(jparams), tcfg, device="cpu"))
    return out


def _serve(vocab, models, name, *, k=0, chunk=0, pc=None, passes=2, reqs=REQUESTS, **kw):
    """Port answers of ``passes`` runs of ``reqs`` through one scheduler
    (the later passes hit what the earlier ones donated)."""
    _, tcfg, _, tparams = models[name]
    sched = ContinuousScheduler(
        tparams, tcfg, vocab[1], kv_block=4, device="cpu", speculate_k=k,
        prefill_chunk=chunk, prefix_cache=pc, kv_layout="paged", decode_kernel="paged_flash",
        **{**COMMON, **kw},
    )
    got = []
    for _ in range(passes):
        got += sched.run([dict(r) for r in reqs])
    return got, sched


# --------------------------------------------------------------------------
# the trie against JAX's


def _blocks(seed: int):
    """One host block: two layers of random k/v rows, 64 KiB each buffer."""
    rng = np.random.default_rng(seed)
    return [{key: rng.standard_normal((1, 4, 8, 512), np.float32) for key in ("k", "v")}
            for _ in range(2)]


def _reader(store):
    def read_block(start):
        return store[start]
    return read_block


def test_trie_ops_equal_jax(vocab, models):
    """One sequence of insert / match / release through both caches at a
    1 MiB budget (four blocks): same hits, evictions, bytes and blocks."""
    jcfg, tcfg = models["fp32"][0], models["fp32"][1]
    jpc = JPrefixCache(jcfg, block_tokens=4, budget_mb=1)
    tpc = PrefixCache(tcfg, block_tokens=4, budget_mb=1)
    prompts = {
        "a": [3] * 8 + [4] * 4, "b": [5] * 8, "c": [3] * 4 + [9] * 8,
        "d": [7] * 12, "e": [3] * 8 + [6] * 4,
    }
    stores = {name: {j * 4: _blocks(10 * i + j) for j in range(3)}
              for i, name in enumerate(prompts)}
    pinned = {}
    script = [
        ("insert", "a"), ("match", "a"), ("insert", "b"), ("insert", "c"),
        ("release", "a"), ("insert", "d"), ("match", "b"), ("release", "b"),
        ("match", "c"), ("insert", "e"), ("release", "c"), ("match", "e"),
        ("release", "e"), ("insert", "a"), ("match", "d"), ("release", "d"),
    ]
    for op, name in script:
        ids = prompts[name]
        if op == "insert":
            got = tpc.insert(ids, len(ids), _reader(stores[name]))
            want = jpc.insert(ids, len(ids), _reader(stores[name]))
            assert got == want, (op, name)
        elif op == "match":
            th, jh = tpc.match(ids), jpc.match(ids)
            assert th.tokens == jh.tokens, (op, name)
            pinned[name] = (th, jh)
        else:
            for h in pinned.pop(name):
                h.release()
        assert tpc.bytes_used == jpc.bytes_used
        assert tpc.stats == jpc.stats
        assert tpc.outstanding_refs() == jpc.outstanding_refs()
    assert tpc.stats["evicted_blocks"] > 0  # the budget bit
    assert tpc.outstanding_refs() == 0


def test_device_tier_ops_equal_jax(vocab, models):
    """Donation by reference, aliasing, adoption and spill through both
    caches over their own allocators: same hits, stats and refcounts."""
    jcfg, tcfg = models["fp32"][0], models["fp32"][1]
    jpool, tpool = JKVPool(16, 4, 2, 6), KVPool(16, 4, 2, 6)
    store = {bid: _blocks(bid) for bid in range(16)}
    jpc = JPrefixCache(jcfg, block_tokens=4, budget_mb=1)
    tpc = PrefixCache(tcfg, block_tokens=4, budget_mb=1)
    jpc.attach_device_pool(jpool, lambda bid: store[bid])
    tpc.attach_device_pool(tpool, lambda bid: store[bid])
    a, b = list(range(3, 15)), list(range(3, 7)) + [20] * 8

    def both(fn):
        got, want = fn(tpc, tpool), fn(jpc, jpool)
        assert got == want
        assert tpc.stats == jpc.stats and tpc.bytes_used == jpc.bytes_used
        assert [tpool.refs(i) for i in range(16)] == [jpool.refs(i) for i in range(16)]
        return got

    def donate(ids):
        def fn(pc, pool):
            pool.ensure(0, len(ids))
            out = pc.insert_device(ids, len(ids), [int(x) for x in pool.table[0][:3]])
            pool.free_slot(0)
            return out
        return fn

    both(donate(a))
    both(donate(b))

    def plan(pc, pool):
        hit = pc.match(b)
        out = [(bid is not None, blocks is not None) for _, bid, blocks in hit.paged_plan()]
        hit.release()
        return hit.tokens, out

    assert both(plan) == (12, [(True, False)] * 3)
    both(lambda pc, pool: pc.release_device_blocks(2))  # spill the two LRU blocks
    both(plan)
    both(lambda pc, pool: pc.release_device_blocks(16))

    def hits(pc, pool):
        out = []
        for ids in (a, b):
            hit = pc.match(ids)
            out.append(hit.tokens)
            hit.release()
        return out

    # five nodes spilled into a four-block host budget: a's LRU leaf went
    assert both(hits) == [8, 12]
    assert tpc.stats["device_blocks"] == 0 and tpc.stats["spilled_blocks"] == 5
    assert tpool.used_blocks == 0
    tpool.check_consistency()


def test_corrupt_block_is_dropped_at_match(models):
    tpc = PrefixCache(models["fp32"][1], block_tokens=4, budget_mb=1)
    ids = list(range(3, 15))
    store = {j * 4: _blocks(j) for j in range(3)}
    tpc.insert(ids, 12, _reader(store))
    node = next(iter(tpc._root.children.values()))
    node = next(iter(node.children.values()))  # depth 2
    arr = node.blocks[1]["v"]
    raw = arr.reshape(-1).view(np.uint8).copy()
    raw[5] ^= 0x10
    node.blocks[1]["v"] = raw.view(arr.dtype).reshape(arr.shape)
    with pytest.raises(PrefixCorruptionError):
        tpc.match(ids)
    assert tpc.outstanding_refs() == 0
    assert tpc.stats["corrupt_blocks"] == 1 and tpc.stats["blocks"] == 1
    hit = tpc.match(ids)
    assert hit.tokens == 4  # only the block above the corrupt one is left
    hit.release()
    unchecked = PrefixCache(models["fp32"][1], block_tokens=4, budget_mb=1,
                            verify_checksums=False)
    unchecked.insert(ids, 12, _reader(store))
    assert unchecked.match(ids).tokens == 12


# --------------------------------------------------------------------------
# blocks round-trip bit for bit


@pytest.mark.parametrize("layout", ["bf16", "int8", "fp32"])
def test_pool_blocks_round_trip_bit_identical_and_carry_jax_bytes(layout):
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((6, 4, 2, 8), np.float32)
    if layout == "int8":
        k, ks = _quantize_kv(torch.from_numpy(rows))
        v, vs = _quantize_kv(torch.from_numpy(rows[::-1].copy()))
        pool = {"k": k, "k_scale": ks, "v": v, "v_scale": vs}
    else:
        dt = torch.bfloat16 if layout == "bf16" else torch.float32
        pool = {"k": torch.from_numpy(rows).to(dt), "v": torch.from_numpy(rows[::-1].copy()).to(dt)}
    pools = [pool, {key: t.clone() for key, t in pool.items()}]
    # JAX's read of the same pool: the same bytes, block for block
    jpools = []
    for p in pools:
        jp = j_init_block_pool(6, 4, 2, 8, jnp.bfloat16 if layout == "bf16" else jnp.float32,
                               quantize=layout == "int8")
        for key, t in p.items():
            raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            jp[key] = jnp.asarray(raw.numpy()).view(jp[key].dtype)
        jpools.append(jp)
    want = jax.device_get(j_pool_read_block(jpools, jnp.int32(3)))
    before = {key: t.clone() for key, t in pools[0].items()}
    host = pool_read_block(pools, 3)
    for t in pools[0].values():
        t[3].zero_()  # the host block is a copy, not a view of the pool
    for got_layer, want_layer in zip(host, want):
        assert sorted(got_layer) == sorted(want_layer)
        for key in got_layer:
            assert got_layer[key].shape == want_layer[key].shape
            assert got_layer[key].tobytes() == np.asarray(want_layer[key]).tobytes()
    pool_write_blocks(pools, [5, 1], [host, pool_read_block(pools, 2)])
    pool_copy_blocks(pools, [5], [4])
    for key, t in pools[0].items():
        for dst, src in ((5, 3), (1, 2), (4, 3)):
            assert torch.equal(t[dst].view(torch.uint8), before[key][src].view(torch.uint8))
        assert torch.equal(t[0], before[key][0])


def test_dense_cache_block_slice_insert_and_rollback():
    cache = init_cache(2, 12, 2, 8, torch.bfloat16, quantize=True)
    for key in ("k", "v"):
        q, s = _quantize_kv(torch.randn(2, 12, 2, 8))
        cache[key], cache[key + "_scale"] = q, s
    blocks = slice_kv_blocks(cache, 4, 4)
    other = init_cache(2, 12, 2, 8, torch.bfloat16, quantize=True)
    insert_kv_blocks(other, blocks, 8)
    for key in ("k", "k_scale", "v", "v_scale"):
        assert torch.equal(other[key][:, 8:12], cache[key][:, 4:8])
        assert not other[key][:, :8].any()
    assert rollback_cache(dict(cache, index=9), 5)["index"] == 5


# --------------------------------------------------------------------------
# serving


_JAX: dict = {}


def _jax_cached_answers(vocab, models, k, chunk):
    if (k, chunk) not in _JAX:
        jcfg, _, jparams, _ = models["fp32"]
        pc = JPrefixCache(jcfg, block_tokens=4, budget_mb=8)
        sched = JScheduler(
            jparams, jcfg, vocab[0], kv_layout="paged", kv_block=4,
            decode_kernel="paged_flash", speculate_k=k, prefill_chunk=chunk,
            prefix_cache=pc, **COMMON,
        )
        got = sched.run([dict(r) for r in REQUESTS]) + sched.run([dict(r) for r in REQUESTS])
        _JAX[(k, chunk)] = got, dict(sched.stats)
    return _JAX[(k, chunk)]


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("k", [0, 2])
def test_greedy_answers_with_the_cache_equal_off_and_jax(vocab, models, k, chunk):
    want, jstats = _jax_cached_answers(vocab, models, k, chunk)
    off, _ = _serve(vocab, models, "fp32", k=k, chunk=chunk)
    pc = PrefixCache(models["fp32"][1], block_tokens=4, budget_mb=8)
    got, sched = _serve(vocab, models, "fp32", k=k, chunk=chunk, pc=pc)
    assert got == off == want
    st = sched.stats
    for key in ("prefix_hit_tokens", "prefix_alias_tokens", "host_restored_tokens",
                "prefill_forwards"):
        assert st[key] == jstats[key], key
    assert st["prefix_hit_tokens"] > 0 and st["prefix_alias_tokens"] > 0
    assert st["prefill_tokens"] < st["prompt_tokens"]
    sched.alloc.check_consistency()
    assert sched.alloc.used_blocks == pc.stats["device_blocks"]  # only the tier holds blocks
    assert pc.outstanding_refs() == 0


def test_int8_pool_answers_with_the_cache_equal_off(vocab, models):
    off, _ = _serve(vocab, models, "int8", k=2, chunk=4)
    pc = PrefixCache(models["int8"][1], block_tokens=4, budget_mb=8)
    got, sched = _serve(vocab, models, "int8", k=2, chunk=4, pc=pc)
    assert got == off and sched.stats["prefix_alias_tokens"] > 0


def test_cache_prefix_false_neither_reads_nor_feeds(vocab, models):
    pc = PrefixCache(models["fp32"][1], block_tokens=4, budget_mb=8)
    reqs = [dict(r, cache_prefix=False) for r in REQUESTS]
    got, sched = _serve(vocab, models, "fp32", pc=pc, reqs=reqs)
    off, _ = _serve(vocab, models, "fp32", reqs=reqs)
    assert got == off
    assert sched.stats["prefix_hit_tokens"] == 0
    assert pc.stats["device_blocks"] == 0 and pc.block_count() == 0
    assert sched.alloc.used_blocks == 0


def test_small_pool_spills_to_the_host_tier_with_the_same_answers(vocab, models):
    words = CORPUS[0].split()
    reqs = [{"prompt": " ".join(words[i:] + words[:i] + words[3 * i % 10 : 3 * i % 10 + 1]),
             "max_new": 5} for i in range(8)]
    off, _ = _serve(vocab, models, "fp32", k=2, chunk=4, reqs=reqs)
    pc = PrefixCache(models["fp32"][1], block_tokens=4, budget_mb=8)
    # The sink and what both slots can reach (2 x 13 blocks): every live
    # slot fits, the device tier's donations beside them do not.
    got, sched = _serve(vocab, models, "fp32", k=2, chunk=4, pc=pc, reqs=reqs,
                        kv_pool_blocks=27)
    assert got == off
    assert all("continuation" in r for r in got)
    st = sched.stats
    assert st["kv_spilled_blocks"] > 0 and pc.stats["spilled_blocks"] > 0
    assert st["host_restored_tokens"] > 0  # a spilled block was restored from the host
    assert st["kv_preempted"] == 0 and pc.stats["corrupt_blocks"] == 0
    sched.alloc.check_consistency()


def test_corrupt_host_block_prefills_in_full_with_the_same_answer(vocab, models):
    pc = PrefixCache(models["fp32"][1], block_tokens=4, budget_mb=8)
    got, sched = _serve(vocab, models, "fp32", pc=pc, passes=1)
    pc.release_device_blocks(10_000)  # the whole device tier to the host
    assert pc.stats["device_blocks"] == 0 and pc.block_count() > 0
    stack = [pc._root]
    while stack:
        node = stack.pop()
        stack.extend(node.children.values())
        if node.blocks is not None:
            node.blocks[0]["k"] = node.blocks[0]["k"] + np.float32(1.0)
    again = sched.run([dict(r) for r in REQUESTS])
    assert again == got
    assert pc.stats["corrupt_blocks"] > 0
    assert sched.stats["host_restored_tokens"] == 0


def test_cli_flags_serve_the_plain_answers(vocab, models, tmp_path):
    """``cli.serve --speculate_k --draft_checkpoint --prefix_cache_mb
    --prefix_verify_checksums`` over a JAX export answers as plain serving."""
    jcfg, _, jparams, _ = models["fp32"]
    export = str(tmp_path / "export")
    export_params(jparams, jcfg, export)
    lines = "".join(json.dumps(r) + "\n" for r in REQUESTS * 2)
    base = ["--export_path", export, "--tgt_vocab_file", vocab[2], "--serve_slots", "2",
            "--serve_max_total", "48", "--prefix_block", "4", "--max_len", "4",
            "--kv_layout", "paged", "--decode_kernel", "paged_flash", "--device", "cpu"]

    def run(*extra):
        out = io.StringIO()
        sched = serve.main(base + list(extra), stdin=io.StringIO(lines), stdout=out)
        return [json.loads(line) for line in out.getvalue().splitlines()], sched

    plain, _ = run()
    got, sched = run("--speculate_k", "2", "--draft_checkpoint", export,
                     "--prefix_cache_mb", "8", "--prefix_verify_checksums", "false")
    assert got == plain and len(got) == 2 * len(REQUESTS)
    assert sched.stats["prefix_hit_tokens"] > 0 and sched.stats["drafted"] > 0
    assert isinstance(sched.drafter, ModelDrafter)
    assert not sched.prefix_cache.verify_checksums
