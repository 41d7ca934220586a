"""The port's paged decode forward and prefill against the JAX package's,
on the same converted weights and the same pool state.

``paged_decode_forward`` (both kernels' plain versions on the CPU) against
JAX's (both Pallas kernels in interpret mode): logits and every updated
pool buffer, for post-LN relu, int8 pools, GQA, and pre-LN swiglu + RoPE
+ tied output, at S_q = 1 (decode) and S_q = 3 (verify rows). Then the
chunked cached prefill against ``transformer_prefill``.

Tolerances, fp32: logits and float pool rows 2e-5 absolute (projections
and the FFN sum in a different order); int8 codes within one quantum and
their scales 1e-5 relative (a row whose scaled value sits at a rounding
midpoint may round the other way)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.models import transformer_init
from transformer_tpu.models.decoder import init_decoder_caches
from transformer_tpu.models.paged_decode import paged_decode_forward as j_forward
from transformer_tpu.models.transformer import transformer_prefill as j_prefill
from transformer_tpu.ops.attention import _quantize_kv as j_quantize
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu_torch.config import ModelConfig as TConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.models.paged_decode import paged_decode_forward
from transformer_tpu_torch.models.transformer import transformer_prefill

BASE = dict(
    num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=50,
    target_vocab_size=50, max_position=64, decoder_only=True,
    dtype="float32", dropout_rate=0.0,
)
VARIANTS = {
    "post_relu": {},
    "int8": dict(kv_cache_int8=True),
    "gqa": dict(num_kv_heads=2),
    "pre_swiglu_rope_tied": dict(
        norm_scheme="pre", ffn_activation="swiglu", position_scheme="rope",
        tie_output=True,
    ),
}
TOL = 2e-5
BLOCK = 8


def _models(variant):
    kw = {**BASE, **VARIANTS[variant]}
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jparams = transformer_init(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_numpy(_flatten(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _pool_state(cfg, seed=0):
    """Random pool contents (9 blocks of 8 rows), a fragmented table with
    slot 1 sharing slot 0's first block, and slot 2 free (index 0, all-sink
    table): numpy arrays for both sides."""
    rng = np.random.default_rng(seed)
    shape = (9, BLOCK, cfg.kv_heads, cfg.head_dim)
    pools = []
    for _ in range(cfg.num_layers):
        kf = rng.standard_normal(shape).astype(np.float32)
        vf = rng.standard_normal(shape).astype(np.float32)
        if cfg.kv_cache_int8:
            k, ks = (np.asarray(a) for a in j_quantize(jnp.asarray(kf)))
            v, vs = (np.asarray(a) for a in j_quantize(jnp.asarray(vf)))
            pools.append({"k": k, "k_scale": ks, "v": v, "v_scale": vs})
        else:
            pools.append({"k": kf, "v": vf})
    table = np.asarray([[3, 5, 1, 0], [3, 7, 0, 0], [0, 0, 0, 0]], np.int32)
    index = np.asarray([2 * BLOCK + 3, BLOCK + 1, 0], np.int32)
    return pools, table, index


@pytest.mark.parametrize("s_q", [1, 3])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_decode_forward_matches_jax(variant, s_q):
    jcfg, tcfg, jparams, tparams = _models(variant)
    pools, table, index = _pool_state(tcfg)
    toks = np.random.default_rng(3).integers(1, 50, (3, s_q)).astype(np.int32)
    want, jpools = j_forward(
        jparams, jnp.asarray(toks), jax.tree.map(jnp.asarray, pools),
        jnp.asarray(table), jnp.asarray(index), jcfg,
        block_tokens=BLOCK, interpret=True,
    )
    tpools = [{k: torch.from_numpy(v.copy()) for k, v in p.items()} for p in pools]
    got, tpools = paged_decode_forward(
        tparams, torch.from_numpy(toks).long(), tpools, torch.from_numpy(table),
        torch.from_numpy(index), tcfg, block_tokens=BLOCK,
    )
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    for jp, tp in zip(jpools, tpools):
        for key in jp:
            a, b = tp[key].numpy(), np.asarray(jp[key])
            if key in ("k", "v") and tcfg.kv_cache_int8:
                assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
                assert (a == b).mean() > 0.99
            elif key.endswith("_scale"):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_reference_flag_runs_the_plain_versions():
    """On the CPU the kernel wrappers already run the plain versions, so
    ``reference=True`` must give bit-identical logits and pools."""
    _, tcfg, _, tparams = _models("int8")
    pools, table, index = _pool_state(tcfg)
    toks = torch.tensor([[4], [9], [0]])
    outs = []
    for reference in (False, True):
        tp = [{k: torch.from_numpy(v.copy()) for k, v in p.items()} for p in pools]
        logits, tp = paged_decode_forward(
            tparams, toks, tp, torch.from_numpy(table), torch.from_numpy(index),
            tcfg, block_tokens=BLOCK, reference=reference,
        )
        outs.append((logits, tp))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("variant", ["post_relu", "int8", "pre_swiglu_rope_tied"])
def test_prefill_matches_jax(variant):
    """Chunked cached prefill (chunks of 3 over 7 tokens, starting at
    position 2 of a cache that already holds 2 rows): next-token logits
    and every cache row against ``transformer_prefill``."""
    jcfg, tcfg, jparams, tparams = _models(variant)
    jcfg = dataclasses.replace(jcfg, max_position=32)
    tcfg = dataclasses.replace(tcfg, max_position=32)
    toks = np.random.default_rng(4).integers(1, 50, (1, 9)).astype(np.int32)
    caches = init_decoder_caches(jcfg, 1, 16)
    _, caches = j_prefill(jparams, jnp.asarray(toks[:, :2]), None, None, caches, 0, jcfg)
    want, jcaches = j_prefill(
        jparams, jnp.asarray(toks[:, 2:]), None, None, caches, jnp.int32(2), jcfg, chunk=3
    )
    tcaches = [
        {k: (torch.from_numpy(np.array(v)) if k != "index" else 2) for k, v in c.items()}
        for c in caches
    ]
    got, tcaches = transformer_prefill(
        tparams, torch.from_numpy(toks[:, 2:]).long(), tcaches, 2, tcfg, chunk=3
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    for jc, tc in zip(jcaches, tcaches):
        assert tc["index"] == int(jc["index"]) == 9
        for key in ("k", "v"):
            a, b = tc[key][:, :9].numpy(), np.asarray(jc[key])[:, :9]
            if tcfg.kv_cache_int8:
                assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
