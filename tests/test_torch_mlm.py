"""The encoder-only masked-LM family: the port against the JAX package.

Sizes are JAX ``tests/test_mlm.py``'s: 2 layers, d 32, 4 heads, dff 64,
vocab 41 (40 real ids and [MASK] = 40), fp32, dropout 0.

- ``mask_from_draws`` given the draws JAX's ``mask_tokens`` makes
  (``jax.random.split(rng, 3)``, then ``uniform``, ``uniform`` and
  ``randint``) equals JAX's output bit for bit, over seeds, rates and
  excluded sets; the port's ``mask_tokens`` (torch generators) holds JAX's
  ``TestMasking`` statistics.
- The encoder-only parameter layout is JAX's (the encoder tower, plus
  ``final`` when untied), and converts numpy -> port -> numpy byte for
  byte.
- Encoder-only logits against JAX ``transformer_apply`` on converted
  weights, xla and flash (plain), tied and untied head: within 1e-5.
- Loss and gradients on JAX's masked batch, injected through a hook of
  ``_prepare_batch``: loss within 1e-6 relative, gradients within 1e-4
  of ||d||/||want|| per leaf (the key biases', rounding noise that the
  softmax cancels, below 1e-7 on both sides).
- Three Adam steps on JAX's masks, against JAX ``make_train_step``: the
  seq2seq checks' limits (loss 1e-5 relative, grad norm 1e-4, params in
  units of the summed learning rate within 1e-5 on average and 1e-2 at
  worst; the key biases within 2x it).
- Grad accumulation equals the whole batch (same masks); the eval masks
  are constant; JAX's ``test_learns_and_eval_deterministic`` round trip;
  JAX's "go together" messages.
- ``DistributedTrainer`` over 2 gloo processes (``--dp 2``): three steps
  equal the one-process trainer's (loss within 1e-6 relative, the params
  within the Adam limits above), which holds only if the masks are drawn
  over the global batch; ``seq`` > 1 raises JAX's message.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ring_attention import join_job, spawn
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.config import TrainConfig as JTrain
from transformer_tpu.models import transformer_apply as j_transformer_apply
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu.train.loss import masked_cross_entropy as j_masked_ce
from transformer_tpu.train.mlm import mask_tokens as j_mask_tokens
from transformer_tpu.train.state import create_train_state as j_create_state
from transformer_tpu.train.trainer import make_train_step as j_make_train_step
from transformer_tpu_torch.config import PAD_ID, MeshConfig, ModelConfig, TrainConfig
from transformer_tpu_torch.convert import params_from_numpy
from transformer_tpu_torch.models.transformer import flatten, param_spec, transformer_apply
from transformer_tpu_torch.parallel.mesh import make_mesh
from transformer_tpu_torch.train import trainer as trainer_mod
from transformer_tpu_torch.train.mlm import allowed_draws, mask_from_draws, mask_tokens
from transformer_tpu_torch.train.state import create_train_state
from transformer_tpu_torch.train.trainer import (
    loss_and_grads,
    make_eval_step,
    make_train_step,
)

VOCAB = 41  # 40 real ids + the reserved top id (40) for [MASK]
MODEL = dict(
    num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=VOCAB,
    target_vocab_size=VOCAB, max_position=16, dropout_rate=0.0, dtype="float32",
    encoder_only=True, tie_output=True,
)
TRAIN = dict(
    batch_size=8, sequence_length=12, warmup_steps=20, lr_schedule="constant",
    peak_lr=3e-3, objective="mlm", log_every_steps=0, eval_every_steps=0,
)
CFG, TCFG = ModelConfig(**MODEL), TrainConfig(**TRAIN)
EXCLUDED = (VOCAB - 3, VOCAB - 2)  # the auto default: BOS, EOS below [MASK]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _batch():
    """JAX test_mlm's batch: each row one repeated id (3 + row), a PAD tail."""
    tok = np.arange(3, 11, dtype=np.int32)[:, None]
    x = np.broadcast_to(tok, (8, 12)).copy()
    x[:, -2:] = PAD_ID
    return x


def _random_batch(seed, b=8, s=12):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, VOCAB - 1, (b, s)).astype(np.int32)
    x[1, s - 4:] = PAD_ID
    x[:, 0] = VOCAB - 3  # BOS-like specials, which the auto exclusion skips
    return x


def _jax_init(model=MODEL, train=TRAIN):
    state = j_create_state(jax.random.PRNGKey(0), JConfig(**model), JTrain(**train))
    return state, {k: np.asarray(v) for k, v in _flatten(state.params).items()}


def _port_params(init, cfg=CFG):
    return params_from_numpy(init, cfg, device="cpu")


def _jax_masks(tgt, rng, step, excluded=EXCLUDED, rate=0.15):
    """The masks JAX's train step draws at ``step`` (its _prepare_batch)."""
    step_rng = jax.random.fold_in(rng, step)
    r_mask, _ = jax.random.split(step_rng)
    masked, labels = j_mask_tokens(jnp.asarray(tgt), r_mask, VOCAB, rate, excluded_ids=excluded)
    return np.asarray(masked), np.asarray(labels)


@pytest.fixture
def inject(monkeypatch):
    """Route the port's ``_prepare_batch`` to fixed (masked, labels) per
    step: ``inject(steps)`` with ``steps[i]`` the i-th step's pair."""

    def install(steps):
        def prepare(model_cfg, train_cfg, tgt, key):
            masked, labels = steps[0 if key is None else key[1]]
            fwd_key = None if key is None else tuple(key) + (1,)
            return torch.tensor(masked).long(), torch.tensor(labels).long(), fwd_key

        monkeypatch.setattr(trainer_mod, "_prepare_batch", prepare)

    return install


# --------------------------------------------------------------------------
# masking


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("rate", [0.15, 0.5])
@pytest.mark.parametrize("excluded", [(), EXCLUDED, (3, 17, 39)], ids=["none", "bos_eos", "three"])
def test_mask_from_draws_equals_jax_on_its_draws(seed, rate, excluded):
    tokens = np.random.default_rng(seed).integers(0, VOCAB - 1, (16, 40)).astype(np.int32)
    tokens[:, 0] = VOCAB - 3
    rng = jax.random.PRNGKey(seed)
    want_masked, want_labels = j_mask_tokens(jnp.asarray(tokens), rng, VOCAB, rate,
                                             excluded_ids=excluded)
    _, n_allowed = allowed_draws(VOCAB, excluded)
    r_sel, r_kind, r_rand = jax.random.split(rng, 3)
    draws = (jax.random.uniform(r_sel, tokens.shape), jax.random.uniform(r_kind, tokens.shape),
             jax.random.randint(r_rand, tokens.shape, 1, n_allowed + 1))
    masked, labels = mask_from_draws(
        torch.from_numpy(tokens).long(), *(torch.from_numpy(np.array(d)) for d in draws),
        VOCAB, rate, excluded,
    )
    assert np.array_equal(masked.numpy(), np.asarray(want_masked))
    assert np.array_equal(labels.numpy(), np.asarray(want_labels))


def test_mask_tokens_stats_and_determinism():
    tokens = torch.from_numpy(np.random.default_rng(0).integers(1, VOCAB - 1, (64, 128)))
    masked, labels = mask_tokens(tokens, torch.Generator().manual_seed(0), VOCAB, 0.15)
    masked2, labels2 = mask_tokens(tokens, torch.Generator().manual_seed(0), VOCAB, 0.15)
    assert torch.equal(masked, masked2) and torch.equal(labels, labels2)
    sel = (labels != PAD_ID).numpy()
    assert 0.12 < sel.mean() < 0.18, sel.mean()
    tokens, masked, labels = tokens.numpy(), masked.numpy(), labels.numpy()
    assert np.array_equal(labels[sel], tokens[sel])
    assert np.array_equal(masked[~sel], tokens[~sel])
    m, orig = masked[sel], tokens[sel]
    assert 0.72 < (m == VOCAB - 1).mean() < 0.88
    assert 0.05 < (m == orig).mean() < 0.16
    assert (m != PAD_ID).all()


def test_pad_positions_never_selected():
    tokens = torch.from_numpy(_batch()).long()
    masked, labels = mask_tokens(tokens, torch.Generator().manual_seed(1), VOCAB)
    pad = tokens == PAD_ID
    assert (labels[pad] == PAD_ID).all() and (masked[pad] == PAD_ID).all()


def test_excluded_ids_never_selected_nor_injected():
    bos, eos = EXCLUDED
    base = np.random.default_rng(1).integers(1, VOCAB - 1, (64, 128))
    base[:, 0], base[:, 70] = bos, eos
    masked, labels = mask_tokens(torch.from_numpy(base), torch.Generator().manual_seed(2), VOCAB,
                                 excluded_ids=(bos, eos))
    masked, labels = masked.numpy(), labels.numpy()
    special = (base == bos) | (base == eos)
    assert (labels[special] == PAD_ID).all()
    assert np.array_equal(masked[special], base[special])
    drawn = masked[(masked != base) & (masked != VOCAB - 1)]
    assert drawn.size > 0 and not np.isin(drawn, [bos, eos, PAD_ID]).any()


def test_excluding_whole_vocab_rejected():
    with pytest.raises(ValueError, match="no real tokens"):
        mask_tokens(torch.ones((2, 4), dtype=torch.long), torch.Generator(), 4,
                    excluded_ids=(1, 2))


def test_train_step_auto_excludes_bos_eos():
    bos, eos = EXCLUDED
    tgt = torch.tensor([[bos, eos] * 6] * 8)
    inp, labels, _ = trainer_mod._prepare_batch(CFG, TCFG, tgt, (0, 3))
    assert (labels == PAD_ID).all() and torch.equal(inp, tgt)


# --------------------------------------------------------------------------
# the model


def test_param_spec_is_the_encoder_tower_and_converts_byte_for_byte():
    from transformer_tpu_torch.convert import params_to_numpy

    for tie in (True, False):
        cfg = dataclasses.replace(CFG, tie_output=tie)
        _, init = _jax_init({**MODEL, "tie_output": tie})
        assert set(init) == set(param_spec(cfg))
        assert {k.split("/")[0] for k in init} == ({"encoder"} if tie else {"encoder", "final"})
        back = params_to_numpy(_port_params(init, cfg))
        assert sorted(back) == sorted(init)
        assert all(back[k].tobytes() == init[k].tobytes() for k in init)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_logits_match_jax(impl, tie):
    model = {**MODEL, "attention_impl": impl, "tie_output": tie}
    jstate, init = _jax_init(model)
    x = _random_batch(3)
    want, _ = j_transformer_apply(jstate.params, None, jnp.asarray(x), JConfig(**model))
    cfg = ModelConfig(**model)
    got = transformer_apply(_port_params(init, cfg), None, torch.from_numpy(x).long(), cfg)
    assert got.shape == (8, 12, VOCAB)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
def test_loss_and_grads_on_jax_masks(inject, remat):
    _, init = _jax_init()
    x = _random_batch(4)
    masked, labels = _jax_masks(x, jax.random.PRNGKey(9), 0)
    jcfg = JConfig(**MODEL)

    def j_loss(p):
        logits, _ = j_transformer_apply(p, None, jnp.asarray(masked), jcfg)
        return j_masked_ce(logits, jnp.asarray(labels))[0]

    jparams = jax.tree.map(jnp.asarray, jax.tree.map(np.asarray, _jax_init()[0].params))
    want_loss, want = jax.value_and_grad(j_loss)(jparams)
    want = _flatten(want)
    inject([(masked, labels)])
    cfg = ModelConfig(**{**MODEL, "remat": remat})
    params = _port_params(init, cfg)
    for p in flatten(params).values():
        p.requires_grad_(True)
    metrics, grads = loss_and_grads(params, torch.from_numpy(x).long(), cfg, TCFG, (0, 0))
    assert _rel(float(metrics["loss"]), float(want_loss)) <= 1e-6
    assert float(metrics["weight"]) == float((labels != PAD_ID).sum())
    for key, g in grads.items():
        if key.endswith("mha/key/bias"):  # zero up to rounding on both sides
            assert np.abs(g.numpy()).max() <= 1e-7 and np.abs(want[key]).max() <= 1e-7
        else:
            assert _rel(g.numpy(), want[key]) <= 1e-4, key


def test_three_adam_steps_match_jax(inject):
    jstate, init = _jax_init()
    rng = jax.random.PRNGKey(0)
    step = jax.jit(j_make_train_step(JConfig(**MODEL), JTrain(**TRAIN)))
    batches = [_random_batch(s) for s in (10, 11, 12)]
    want_losses, want_norms, steps = [], [], []
    for i, tgt in enumerate(batches):
        steps.append(_jax_masks(tgt, rng, i))
        jstate, m = step(jstate, jnp.asarray(tgt), jnp.asarray(tgt), rng)
        want_losses.append(float(m["loss"]))
        want_norms.append(float(m["grad_norm"]))
    want_params = {k: np.asarray(v) for k, v in _flatten(jstate.params).items()}
    inject(steps)
    state = create_train_state(CFG, TCFG, params=_port_params(init))
    port_step = make_train_step(CFG, TCFG)
    for i, tgt in enumerate(batches):
        state, m = port_step(state, tgt, tgt)
        assert _rel(float(m["loss"]), want_losses[i]) <= 1e-5, i
        assert _rel(float(m["grad_norm"]), want_norms[i]) <= 1e-4, i
    lr_sum = 3 * TRAIN["peak_lr"]  # constant schedule, warmup ramps below it
    for key, p in flatten(state.params).items():
        diff = np.abs(p.detach().numpy() - want_params[key]) / lr_sum
        assert diff.max() <= 2.0, key
        if not key.endswith("mha/key/bias"):
            assert diff.mean() <= 1e-5 and diff.max() <= 1e-2, (key, diff.mean(), diff.max())


class _Sgd:
    """optax.sgd(1.0) on flat dicts: the update is the negated gradient."""

    def init(self, params):
        return None

    def update(self, grads, state, params=None):
        return {k: -g for k, g in grads.items()}, state


def test_grad_accum_matches_whole_batch():
    _, init = _jax_init()
    x = _random_batch(5)
    runs = []
    for accum in (1, 2):
        tcfg = dataclasses.replace(TCFG, grad_accum_steps=accum)
        state = create_train_state(CFG, tcfg, params=_port_params(init))
        state, m = make_train_step(CFG, tcfg, tx=_Sgd())(state, x, x)
        runs.append((float(m["loss"]), flatten(state.params)))
    assert _rel(runs[1][0], runs[0][0]) <= 1e-5
    for key, a in runs[0][1].items():
        np.testing.assert_allclose(runs[1][1][key].detach().numpy(), a.detach().numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=key)


def test_loss_chunks_match_whole_logits():
    _, init = _jax_init({**MODEL, "tie_output": False})
    cfg = ModelConfig(**{**MODEL, "tie_output": False})
    x = _random_batch(6)
    losses = []
    for chunks in (1, 3):
        tcfg = dataclasses.replace(TCFG, loss_chunks=chunks)
        state = create_train_state(cfg, tcfg, params=_port_params(init, cfg))
        _, m = make_train_step(cfg, tcfg)(state, x, x)
        losses.append(float(m["loss"]))
    assert _rel(losses[1], losses[0]) <= 1e-6


def test_steps_draw_fresh_masks_and_eval_a_constant_one():
    tgt = torch.from_numpy(_random_batch(7)).long()
    a = trainer_mod._prepare_batch(CFG, TCFG, tgt, (0, 0))
    b = trainer_mod._prepare_batch(CFG, TCFG, tgt, (0, 1))
    assert not torch.equal(a[1], b[1]) and a[2] == (0, 0, 1)
    e1 = trainer_mod._prepare_batch(CFG, TCFG, tgt, None)
    e2 = trainer_mod._prepare_batch(CFG, TCFG, tgt, None)
    assert torch.equal(e1[0], e2[0]) and torch.equal(e1[1], e2[1]) and e1[2] is None


def test_learns_and_eval_deterministic():
    state = create_train_state(CFG, TCFG, device="cpu")
    step = make_train_step(CFG, TCFG)
    x = _batch()
    first = None
    for _ in range(150):
        state, m = step(state, x, x)
        first = float(m["loss"]) if first is None else first
    last = float(m["loss"])
    assert last < first / 4, (first, last)
    assert float(m["correct"]) / max(float(m["weight"]), 1.0) > 0.9
    ev = make_eval_step(CFG, TCFG)
    e1, e2 = ev(state, x, x), ev(state, x, x)
    assert float(e1["loss"]) == float(e2["loss"]) and float(e1["weight"]) > 0
    probe = torch.from_numpy(_batch()).long()
    probe[0, 4] = VOCAB - 1
    with torch.no_grad():
        logits = transformer_apply(state.params, None, probe, CFG)
    assert int(torch.argmax(logits[0, 4])) == 3


def test_objective_family_cross_validation():
    causal = dataclasses.replace(CFG, encoder_only=False)
    with pytest.raises(ValueError, match="go together"):
        make_train_step(causal, TCFG)
    with pytest.raises(ValueError, match="go together"):
        make_train_step(CFG, dataclasses.replace(TCFG, objective="causal"))
    with pytest.raises(ValueError, match="go together"):
        make_eval_step(causal, TCFG)


def test_no_decode_path():
    from transformer_tpu_torch.train.decode import translate

    class _Tok:
        bos_id, eos_id = 1, 2

        def encode(self, s):
            return [3]

    params = _port_params(_jax_init()[1])
    with pytest.raises(ValueError, match="no autoregressive decode"):
        translate(params, CFG, _Tok(), _Tok(), "x")


# --------------------------------------------------------------------------
# over processes


def _dp_worker(rank, world, port, init, batches, out_path):
    from transformer_tpu_torch.parallel.distributed import DistributedTrainer

    mesh = make_mesh(MeshConfig(data=world), join_job(rank, world, port))
    state = create_train_state(CFG, TCFG, params=_port_params(init))
    trainer = DistributedTrainer(CFG, TCFG, mesh, state=state, log_fn=lambda *_: None)
    losses = []
    for tgt in batches:
        trainer.state, m = trainer.train_step(trainer.state, None, tgt)
        losses.append(float(m["loss"]))
    ev = trainer.eval_step(trainer.state, None, batches[0])
    params = {k: v.detach().numpy() for k, v in flatten(trainer.state.params).items()}
    if rank == 0:
        np.savez(out_path, losses=losses, eval_loss=float(ev["loss"]), **params)
    torch.distributed.destroy_process_group()


def test_dp2_matches_one_process(tmp_path):
    _, init = _jax_init()
    batches = [_random_batch(s) for s in (20, 21, 22)]
    spawn(_dp_worker, 2, init, batches, str(tmp_path / "dp.npz"))
    got = np.load(tmp_path / "dp.npz")
    state = create_train_state(CFG, TCFG, params=_port_params(init))
    step, losses = make_train_step(CFG, TCFG), []
    for tgt in batches:
        state, m = step(state, None, tgt)
        losses.append(float(m["loss"]))
    for g, w in zip(got["losses"], losses):
        assert _rel(g, w) <= 1e-6, (list(got["losses"]), losses)
    ev = make_eval_step(CFG, TCFG)(state, None, batches[0])
    assert _rel(float(got["eval_loss"]), float(ev["loss"])) <= 1e-5
    lr_sum = 3 * TRAIN["peak_lr"]
    for key, p in flatten(state.params).items():
        diff = np.abs(got[key] - p.detach().numpy()) / lr_sum
        assert diff.max() <= 2.0, key
        if not key.endswith("mha/key/bias"):
            assert diff.mean() <= 1e-5 and diff.max() <= 1e-2, (key, diff.mean(), diff.max())


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_refused_as_in_jax(impl):
    from test_torch_distributed import _fake_mesh
    from transformer_tpu_torch.parallel.distributed import check_mesh

    with pytest.raises(ValueError, match="pipe and seq are not wired for the encoder-only"):
        check_mesh(dataclasses.replace(CFG, attention_impl=impl), TCFG,
                   _fake_mesh(MeshConfig(seq=2)))
    check_mesh(CFG, TCFG, _fake_mesh(MeshConfig(data=2)))
