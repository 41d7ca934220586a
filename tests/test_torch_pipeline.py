"""Pipeline parallelism over processes: the port against the JAX package.

Tiny fp32 models (2 layers, d 32, 4 heads, dff 64, vocabulary 64; the MoE
one 4 experts, top-2, every layer), weights from a JAX init converted
with ``convert.params_from_numpy``; the port runs on gloo processes on
the CPU (``torch_pipeline_jobs``, two spawns started before the JAX side
runs, each computing many cases), JAX on the virtual CPU devices of
``conftest.py``:

- the tick and stash counts equal JAX's functions; ``stack_layer_params``
  and ``unstack_layer_params`` round-trip and stack as JAX's does;
- the GPipe logits and hiddens equal JAX's ``pipelined_transformer_apply``
  for decoder-only and seq2seq at (data, pipe, microbatches) (1, 2, 2),
  (1, 2, 4) and (2, 2, 2), within 1e-5;
- three train steps against JAX's ``DistributedTrainer`` on the same mesh
  (pipe 2; pipe 2 × fsdp 2; data 2 × pipe 2 with a homogeneous MoE stack),
  under GPipe and under 1F1B: the loss, ``moe_aux`` and ``grad_norm``
  within 1e-5 relative, the eval loss too (GPipe's forward, under either
  schedule, as in JAX: held once per mesh), the parameters held to JAX's as
  ``test_torch_moe_train.py`` holds the one-process port to JAX (mean 1e-5
  and max 1e-2 of the summed learning rate; the key biases, whose gradient
  is rounding noise, 2x it); the dense cases also to the one-process port
  as ``test_dp2_matches_jax_single_program`` holds ``--dp 2`` (1e-6 /
  1e-3); the MoE aux is JAX's microbatch mean, not the unsplit batch's;
- in the port alone: 1F1B against GPipe with dropout on (the same masks
  per (layer, microbatch)), ``remat`` bit for bit against the plain run,
  ``loss_chunks`` against it within 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pipeline_jobs as jobs
from transformer_tpu.config import MeshConfig as JMesh
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.config import TrainConfig as JTrain
from transformer_tpu.parallel import pipeline as jpipe
from transformer_tpu.parallel.distributed import DistributedTrainer as JTrainer
from transformer_tpu.parallel.mesh import make_mesh as j_make_mesh
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu.train.state import create_train_state as j_create_state
from transformer_tpu.train.trainer import make_train_step as j_make_train_step
from transformer_tpu_torch.parallel import pipeline as tpipe

VOCAB = 64
BASE = dict(
    num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=VOCAB,
    target_vocab_size=VOCAB, max_position=32, dropout_rate=0.0, dtype="float32",
    attention_impl="flash",
)
FAMILIES = {
    "lm": dict(decoder_only=True),
    "s2s": dict(),
    "moe": dict(decoder_only=True, moe_experts=4, moe_top_k=2, moe_every=1),
}
TRAIN = dict(batch_size=8, sequence_length=16, warmup_steps=4)


def _ids(seed, b=8, s=16, pad_tail=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB - 1, size=(b, s)).astype(np.int32)
    ids[1, s - pad_tail:] = 0
    ids[6, s - 2:] = 0
    return ids


def _batches(family):
    tgts = [_ids(10 + i) for i in range(3)]
    srcs = [_ids(20 + i, s=12, pad_tail=3) for i in range(3)] if family == "s2s" else tgts
    return list(zip(srcs, tgts))


def _model(family, **kw):
    return {**BASE, **FAMILIES[family], **kw}


_INITS: dict = {}


def _init(family):
    if family not in _INITS:
        state = j_create_state(jax.random.PRNGKey(0), JConfig(**_model(family)), JTrain(**TRAIN))
        _INITS[family] = {k: np.asarray(v) for k, v in _flatten(state.params).items()}
    return _INITS[family]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# (mesh, schedule, family, microbatches); each against JAX's trainer
TRAIN_CASES = {
    "pp2-gpipe-s2s": (dict(pipe=2), "gpipe", "s2s", 4),
    "pp2-1f1b-s2s": (dict(pipe=2), "1f1b", "s2s", 4),
    "pp2xfsdp2-gpipe-lm": (dict(fsdp=2, pipe=2), "gpipe", "lm", 2),
    "pp2xfsdp2-1f1b-lm": (dict(fsdp=2, pipe=2), "1f1b", "lm", 2),
    "dp2xpp2-gpipe-moe": (dict(data=2, pipe=2), "gpipe", "moe", 2),
    "dp2xpp2-1f1b-moe": (dict(data=2, pipe=2), "1f1b", "moe", 2),
}
# (data, pipe, microbatches) of the forward cases
FORWARD_CASES = [(1, 2, 2), (1, 2, 4), (2, 2, 2)]


def _train_job(name, mesh, schedule, family, mbs, **extra):
    model = _model(family, **extra.pop("model", {}))
    return dict(name=name, kind="train", mesh=mesh, model=model,
                train={**TRAIN, "pp_microbatches": mbs, "pp_schedule": schedule,
                       **extra.pop("train", {})},
                init=_init(family), batches=_batches(family), **extra)


def _jobs_by_world():
    by_world: dict[int, list] = {2: [], 4: []}
    for name, (mesh, schedule, family, mbs) in TRAIN_CASES.items():
        by_world[int(np.prod(list(mesh.values())))].append(
            _train_job(name, mesh, schedule, family, mbs))
    pp2 = dict(pipe=2)
    by_world[2] += [
        _train_job("pp2-gpipe-s2s-remat", pp2, "gpipe", "s2s", 4, model={"remat": True}),
        _train_job("pp2-gpipe-s2s-chunks", pp2, "gpipe", "s2s", 4, train={"loss_chunks": 2}),
    ]
    for schedule in ("gpipe", "1f1b"):
        by_world[4].append(_train_job(f"dropout-{schedule}", dict(fsdp=2, pipe=2), schedule,
                                      "s2s", 2, model={"dropout_rate": 0.1}))
    for d, p, mbs in FORWARD_CASES:
        for family in ("lm", "s2s"):
            src, tgt = _batches(family)[0]
            for hidden in (False, True):
                by_world[d * p].append(dict(
                    name=f"fwd-{family}-{d}-{p}-{mbs}-{int(hidden)}", kind="forward",
                    mesh=dict(data=d, pipe=p), model=_model(family), init=_init(family),
                    batch=(src if family == "s2s" else None, tgt), mbs=mbs, hidden=hidden))
    return by_world


def _jax_train(mesh_kw, schedule, family, mbs):
    n = int(np.prod(list(mesh_kw.values())))
    mesh = j_make_mesh(JMesh(**mesh_kw), devices=jax.devices()[:n])
    tcfg = JTrain(**TRAIN, pp_microbatches=mbs, pp_schedule=schedule)
    trainer = JTrainer(JConfig(**_model(family)), tcfg, mesh, log_fn=lambda *_: None,
                       donate_state=False)
    state = trainer.state
    out = {"losses": [], "auxes": [], "norms": []}
    for src, tgt in _batches(family):
        state, m = trainer.train_step(state, src, tgt, jax.random.PRNGKey(0))
        out["losses"].append(float(m["loss"]))
        out["auxes"].append(float(m.get("moe_aux", 0.0)))
        out["norms"].append(float(m["grad_norm"]))
    if schedule == "gpipe":  # eval is GPipe's forward under either schedule, as in JAX
        out["eval_loss"] = float(trainer.eval_step(state, *_batches(family)[0])["loss"])
    out["params"] = {k: np.asarray(v) for k, v in _flatten(state.params).items()}
    return out


def _jax_forward(family, d, p, mbs):
    mesh = j_make_mesh(JMesh(data=d, pipe=p), devices=jax.devices()[: d * p])
    cfg = JConfig(**_model(family))
    from transformer_tpu_torch.models.transformer import unflatten

    params = jax.tree.map(jnp.asarray, unflatten(dict(_init(family))))
    src, tgt = _batches(family)[0]
    hidden = jax.jit(lambda p, s, t: jpipe.pipelined_transformer_apply(
        p, s, t, cfg, mesh=mesh, num_microbatches=mbs, return_hidden=True))(
        params, None if family != "s2s" else jnp.asarray(src), jnp.asarray(tgt))
    from transformer_tpu.models.transformer import _logits

    return np.asarray(_logits(params, hidden, cfg)), np.asarray(hidden)


def _port_single(family, extra_model=None):
    """The one-process port's three steps: params after them."""
    from transformer_tpu_torch.config import ModelConfig, TrainConfig
    from transformer_tpu_torch.convert import params_from_numpy
    from transformer_tpu_torch.models.transformer import flatten
    from transformer_tpu_torch.train.state import create_train_state
    from transformer_tpu_torch.train.trainer import make_train_step

    cfg, tcfg = ModelConfig(**_model(family, **(extra_model or {}))), TrainConfig(**TRAIN)
    state = create_train_state(cfg, tcfg, params=params_from_numpy(_init(family), cfg, "cpu"))
    step = make_train_step(cfg, tcfg)
    for src, tgt in _batches(family):
        state, _ = step(state, src, tgt)
    return {f"params/{k}": v.detach().numpy() for k, v in flatten(state.params).items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pipeline"))
    handles = [jobs.start_jobs(js, out, world) for world, js in _jobs_by_world().items()]
    want = {name: _jax_train(*case) for name, case in TRAIN_CASES.items()}
    fwd = {(f, *c): _jax_forward(f, *c) for c in FORWARD_CASES for f in ("lm", "s2s")}
    single = {f: _port_single(f) for f in ("lm", "s2s")}
    for h in handles:
        jobs.finish(h)
    got = {}
    for name in os.listdir(out):
        with np.load(os.path.join(out, name)) as data:
            got[name[: -len(".npz")]] = {k: data[k] for k in data.files}
    return got, want, fwd, single


# --------------------------------------------------------------------------
# schedule arithmetic


@pytest.mark.parametrize("stages", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("mbs", [1, 2, 4, 8, 16])
def test_tick_and_stash_counts_equal_jax(mbs, stages):
    assert tpipe.gpipe_ticks(mbs, stages) == jpipe.gpipe_ticks(mbs, stages)
    assert tpipe.one_f1b_ticks(mbs, stages) == jpipe.one_f1b_ticks(mbs, stages)
    assert tpipe.one_f1b_stash_slots(stages) == jpipe.one_f1b_stash_slots(stages)


def test_stack_and_unstack_round_trip_as_jax_stacks():
    from transformer_tpu_torch.models.transformer import unflatten

    init = _init("s2s")
    layers = unflatten({k: torch.from_numpy(v) for k, v in init.items()})["decoder"]["layers"]
    stacked = tpipe.stack_layer_params(layers)
    jstacked = jpipe.stack_layer_params(
        unflatten({k: jnp.asarray(v) for k, v in init.items()})["decoder"]["layers"])
    flat = lambda t, p="": {f"{p}{k}": v for k, v in t.items()} if not any(  # noqa: E731
        isinstance(v, dict) for v in t.values()) else {
        kk: vv for k, v in t.items() for kk, vv in flat(v, f"{p}{k}/").items()}
    got, want = flat(stacked), flat(jstacked)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    back = tpipe.unstack_layer_params(stacked, len(layers))
    for a, b in zip(back, layers):
        for k in flat(a):
            assert torch.equal(flat(a)[k], flat(b)[k])


# --------------------------------------------------------------------------
# the GPipe forward


@pytest.mark.parametrize("hidden", [False, True])
@pytest.mark.parametrize("d,p,mbs", FORWARD_CASES)
@pytest.mark.parametrize("family", ["lm", "s2s"])
def test_gpipe_forward_matches_jax(results, family, d, p, mbs, hidden):
    got_all, _, fwd, _ = results
    want = fwd[family, d, p, mbs][1 if hidden else 0]
    seen = 0
    for rank in range(d * p):
        got = got_all[f"fwd-{family}-{d}-{p}-{mbs}-{int(hidden)}.r{rank}"]
        rows = got["out"].shape[0]
        row = int(got["row"])
        np.testing.assert_allclose(got["out"], want[row : row + rows], atol=1e-5, rtol=0)
        seen += rows
    assert seen == want.shape[0] * p  # every stage returns its rows


# --------------------------------------------------------------------------
# training against JAX's DistributedTrainer


def _check_params(got, want, tol_mean, tol_max, steps=3):
    from transformer_tpu.train.schedule import noam_schedule as j_noam

    lr_sum = sum(float(j_noam(BASE["d_model"], TRAIN["warmup_steps"])(s)) for s in range(steps))
    keys = [k for k in want if k.startswith("params/")] or list(want)
    for key in keys:
        name = key if key.startswith("params/") else f"params/{key}"
        diff = np.abs(got[name] - want[key]) / lr_sum
        assert diff.max() <= 2.0, key
        if not key.endswith("mha/key/bias"):
            assert diff.mean() <= tol_mean and diff.max() <= tol_max, (key, diff.mean(),
                                                                       diff.max())


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_steps_match_jax_trainer(results, case):
    got_all, want_all, _, single = results
    got, want = got_all[case], want_all[case]
    for key in ("losses", "auxes", "norms"):
        for g, w in zip(got[key], want[key]):
            assert _rel(g, w) <= 1e-5, (key, list(got[key]), want[key])
    if "eval_loss" in want:
        assert _rel(got["eval_loss"], want["eval_loss"]) <= 1e-5
    _check_params(got, {f"params/{k}": v for k, v in want["params"].items()}, 1e-5, 1e-2)
    family = TRAIN_CASES[case][2]
    if family in single:  # dense: the pipelined step is the unsplit step's
        _check_params(got, single[family], 1e-6, 1e-3)


def test_moe_aux_is_jax_microbatch_mean(results):
    got_all, want_all, _, _ = results
    for case in ("dp2xpp2-gpipe-moe", "dp2xpp2-1f1b-moe"):
        got, want = got_all[case]["auxes"], want_all[case]["auxes"]
        assert all(_rel(g, w) <= 1e-5 for g, w in zip(got, want)), (list(got), want)
    # ... which is not the unsplit batch's aux
    model = _model("moe")
    state = j_create_state(jax.random.PRNGKey(0), JConfig(**model), JTrain(**TRAIN))
    src, tgt = _batches("moe")[0]
    _, m = jax.jit(j_make_train_step(JConfig(**model), JTrain(**TRAIN)))(
        state, jnp.asarray(src), jnp.asarray(tgt), jax.random.PRNGKey(0))
    assert abs(float(m["moe_aux"]) - got_all["dp2xpp2-gpipe-moe"]["auxes"][0]) > 1e-4


# --------------------------------------------------------------------------
# the port's own identities


def test_one_f1b_equals_gpipe_with_dropout(results):
    got_all = results[0]
    a, b = got_all["dropout-gpipe"], got_all["dropout-1f1b"]
    for key in ("losses", "norms"):
        for g, w in zip(a[key], b[key]):
            assert _rel(g, w) <= 1e-5, (key, list(a[key]), list(b[key]))
    # dropout is on: the first loss is not the deterministic run's
    assert abs(a["losses"][0] - got_all["pp2-gpipe-s2s"]["losses"][0]) > 1e-4
    _check_params(a, {k: v for k, v in b.items() if k.startswith("params/")}, 1e-6, 1e-3)


def test_remat_and_loss_chunks_under_pipe(results):
    got_all = results[0]
    plain = got_all["pp2-gpipe-s2s"]
    remat = got_all["pp2-gpipe-s2s-remat"]
    for key in plain:
        np.testing.assert_array_equal(remat[key], plain[key], err_msg=key)
    chunks = got_all["pp2-gpipe-s2s-chunks"]
    for key in ("losses", "norms"):
        assert all(_rel(g, w) <= 1e-5 for g, w in zip(chunks[key], plain[key])), key
    _check_params(chunks, {k: v for k, v in plain.items() if k.startswith("params/")},
                  1e-6, 1e-3)
