"""Tensor parallelism over processes: the port against the JAX package.

Tiny fp32 models as ``test_torch_pipeline.py``'s (2 layers, d 32, 4
heads, dff 64, vocabulary 64, dropout 0; weights from a JAX init converted
with ``convert.params_from_numpy``); the port runs on four gloo processes
on the CPU (``torch_pipeline_jobs``, one spawn started before the JAX side
runs, every case one job of it), JAX on the virtual CPU devices of
``conftest.py``. Each mesh case is three train steps against JAX's
``DistributedTrainer`` on the same mesh, its loss, ``moe_aux``,
``grad_norm`` within 1e-5 relative (the eval loss too, once per mesh),
its parameters held as
``test_torch_pipeline.py`` holds them (mean 1e-5 and max 1e-2 of the
summed learning rate; the key biases 2x it):

- ``data 2 × model 2`` for the decoder-only LM (``tie_output``: whole
  logits through the embedding table), seq2seq (label smoothing over the
  vocabulary-split CE, in 2 ``loss_chunks``) and a homogeneous MoE stack
  (4 experts, top-2);
- ``fsdp 2 × model 2`` under Adam and under Adafactor, and ``data 2 ×
  fsdp 2`` under Adafactor; the Adafactor cases on a wider model (d 128,
  dff 256, 1 layer), whose FFN kernels Adafactor factors (at d 32 no leaf
  reaches ``MIN_DIM_SIZE_TO_FACTOR``): their row and column sums are
  taken over the ``fsdp`` and ``model`` slices of the whole leaf, the
  other leaves' unfactored statistics over theirs;
- ``pipe 2 × model 2`` under GPipe (seq2seq) and 1F1B (LM), and GPipe at
  ``grad_accum_steps 2``;
- ``seq 2 × model 2`` under ring and under Ulysses, and a grouped-query
  Ulysses case (one kv head, which the model axis does not divide: kept
  whole and repeated to the query heads).

In the port alone, against the one-process port (loss and ``grad_norm``
within 1e-5 relative, params as the mesh cases hold them): ``--tp 2``
with dropout on (the same masks; JAX's masks come from its own PRNG);
and every leaf split over ``fsdp × model`` gathers back to itself bit for
bit.
"""

import os

import jax
import numpy as np
import pytest

import torch_pipeline_jobs as jobs
from test_torch_pipeline import BASE, TRAIN, VOCAB, _ids, _rel
from transformer_tpu.config import MeshConfig as JMesh
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.config import TrainConfig as JTrain
from transformer_tpu.parallel.distributed import DistributedTrainer as JTrainer
from transformer_tpu.parallel.mesh import make_mesh as j_make_mesh
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu.train.state import create_train_state as j_create_state

LM = dict(decoder_only=True)
WIDE = dict(LM, d_model=128, dff=256, num_layers=1)
MOE = dict(decoder_only=True, moe_experts=4, moe_top_k=2, moe_every=1)

# name: (mesh, model fields, train fields); each against JAX's trainer
CASES = {
    "dp2tp2-lm-tied": (dict(data=2, model=2), dict(LM, tie_output=True), {}),
    "dp2tp2-s2s-smooth-chunks": (dict(data=2, model=2), {},
                                 dict(label_smoothing=0.1, loss_chunks=2)),
    "dp2tp2-moe": (dict(data=2, model=2), MOE, {}),
    "fsdp2tp2-lm-adam": (dict(fsdp=2, model=2), LM, {}),
    "fsdp2tp2-lm-adafactor": (dict(fsdp=2, model=2), WIDE, dict(optimizer="adafactor")),
    "dp2fsdp2-lm-adafactor": (dict(data=2, fsdp=2), WIDE, dict(optimizer="adafactor")),
    "pp2tp2-gpipe-s2s": (dict(pipe=2, model=2), {}, dict(pp_microbatches=2)),
    "pp2tp2-1f1b-lm": (dict(pipe=2, model=2), LM, dict(pp_microbatches=2, pp_schedule="1f1b")),
    "pp2tp2-gpipe-accum-lm": (dict(pipe=2, model=2), LM,
                              dict(pp_microbatches=2, grad_accum_steps=2)),
    "sp2tp2-ring-lm": (dict(seq=2, model=2), dict(LM, attention_impl="ring"), {}),
    "sp2tp2-ulysses-lm": (dict(seq=2, model=2), dict(LM, attention_impl="ulysses"), {}),
    "sp2tp2-ulysses-gqa-lm": (dict(seq=2, model=2), dict(LM, attention_impl="ulysses",
                                                         num_kv_heads=1), {}),
}
# the eval loss is held once per mesh (its forward is the train step's)
EVAL = {"dp2tp2-s2s-smooth-chunks", "fsdp2tp2-lm-adam", "dp2fsdp2-lm-adafactor",
        "pp2tp2-gpipe-s2s", "sp2tp2-ring-lm"}
# name: (mesh, model fields, train fields); each against the one-process port
PORT_ALONE = {
    "dp2tp2-dropout": (dict(data=2, model=2), dict(LM, dropout_rate=0.1), {}),
}


def _batches(model):
    tgts = [_ids(10 + i) for i in range(3)]
    if model.get("decoder_only"):
        return list(zip(tgts, tgts))
    return list(zip([_ids(20 + i, s=12, pad_tail=3) for i in range(3)], tgts))


def _model(extra):
    return {**BASE, **extra}


_INITS: dict = {}


def _init(model):
    key = tuple(sorted(model.items()))
    if key not in _INITS:
        state = j_create_state(jax.random.PRNGKey(0), JConfig(**model), JTrain(**TRAIN))
        _INITS[key] = {k: np.asarray(v) for k, v in _flatten(state.params).items()}
    return _INITS[key]


def _job(name, mesh, model, train, **extra):
    model = _model(model)
    return dict(name=name, kind="train", mesh=mesh, model=model, train={**TRAIN, **train},
                init=_init(model), batches=_batches(model), **extra)


def _jobs():
    out = [_job(name, *case) for name, case in {**CASES, **PORT_ALONE}.items()]
    out.append(dict(name="roundtrip", kind="roundtrip", mesh=dict(fsdp=2, model=2),
                    init=_init(_model(MOE))))
    return out


def _jax_train(mesh_kw, model, train, eval_loss=True):
    model = _model(model)
    n = int(np.prod(list(mesh_kw.values())))
    mesh = j_make_mesh(JMesh(**mesh_kw), devices=jax.devices()[:n])
    trainer = JTrainer(JConfig(**model), JTrain(**TRAIN, **train), mesh,
                       log_fn=lambda *_: None, donate_state=False)
    state = trainer.state
    out = {"losses": [], "auxes": [], "norms": []}
    batches = _batches(model)
    for src, tgt in batches:
        state, m = trainer.train_step(state, src, tgt, jax.random.PRNGKey(0))
        out["losses"].append(float(m["loss"]))
        out["auxes"].append(float(m.get("moe_aux", 0.0)))
        out["norms"].append(float(m["grad_norm"]))
    if eval_loss:
        out["eval_loss"] = float(trainer.eval_step(state, *batches[0])["loss"])
    out["params"] = {k: np.asarray(v) for k, v in _flatten(state.params).items()}
    return out


def _port_single(model, train=None):
    """The one-process port's three steps: (losses, norms, params)."""
    from transformer_tpu_torch.config import ModelConfig, TrainConfig
    from transformer_tpu_torch.convert import params_from_numpy
    from transformer_tpu_torch.models.transformer import flatten
    from transformer_tpu_torch.train.state import create_train_state
    from transformer_tpu_torch.train.trainer import make_train_step

    model = _model(model)
    cfg, tcfg = ModelConfig(**model), TrainConfig(**TRAIN, **(train or {}))
    state = create_train_state(cfg, tcfg, params=params_from_numpy(_init(model), cfg, "cpu"))
    step = make_train_step(cfg, tcfg)
    losses, norms = [], []
    for src, tgt in _batches(model):
        state, m = step(state, src, tgt)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms,
            **{f"params/{k}": v.detach().numpy() for k, v in flatten(state.params).items()}}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tensor_parallel"))
    handle = jobs.start_jobs(_jobs(), out, 4)
    want = {name: _jax_train(*case, eval_loss=name in EVAL) for name, case in CASES.items()}
    single = {name: _port_single(model, train) for name, (_, model, train) in PORT_ALONE.items()}
    jobs.finish(handle)
    got = {}
    for name in os.listdir(out):
        with np.load(os.path.join(out, name)) as data:
            got[name[: -len(".npz")]] = {k: data[k] for k in data.files}
    return got, want, single


def _check_params(got, want, tol_mean, tol_max, steps=3, d_model=BASE["d_model"]):
    from transformer_tpu.train.schedule import noam_schedule as j_noam

    lr_sum = sum(float(j_noam(d_model, TRAIN["warmup_steps"])(s)) for s in range(steps))
    for key in [k for k in want if k.startswith("params/")]:
        diff = np.abs(got[key] - want[key]) / lr_sum
        assert diff.max() <= 2.0, key
        if not key.endswith("mha/key/bias"):
            assert diff.mean() <= tol_mean and diff.max() <= tol_max, (key, diff.mean(),
                                                                       diff.max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_match_jax_trainer(results, case):
    got_all, want_all, _ = results
    got, want = got_all[case], want_all[case]
    for key in ("losses", "auxes", "norms"):
        for g, w in zip(got[key], want[key]):
            assert _rel(g, w) <= 1e-5, (key, list(got[key]), want[key])
    if "eval_loss" in want:
        assert _rel(got["eval_loss"], want["eval_loss"]) <= 1e-5
    _check_params(got, {f"params/{k}": v for k, v in want["params"].items()}, 1e-5, 1e-2,
                  d_model=_model(CASES[case][1])["d_model"])
    if "adafactor" in case:  # the case exists to factor leaves split over the mesh
        from transformer_tpu_torch.train.state import factored_dims

        factored = [k for k, v in want["params"].items() if factored_dims(v.shape)]
        assert factored and all("/ffn/" in k for k in factored), factored


@pytest.mark.parametrize("case", sorted(PORT_ALONE))
def test_port_alone_equals_one_process(results, case):
    """``--tp 2`` with dropout on draws the one process's masks."""
    got_all, want_all, single = results
    got, want = got_all[case], single[case]
    for key in ("losses", "norms"):
        for g, w in zip(got[key], want[key]):
            assert _rel(g, w) <= 1e-5, (key, list(got[key]), want[key])
    # dropout is on: the loss is not the deterministic run's
    plain = want_all["fsdp2tp2-lm-adam"]["losses"][0]
    assert abs(float(got["losses"][0]) - plain) > 1e-4
    _check_params(got, want, 1e-5, 1e-2, d_model=_model(PORT_ALONE[case][1])["d_model"])


def test_split_leaves_gather_back_bit_for_bit(results):
    got = results[0]["roundtrip"]
    # of the (post-LN) MoE LM's 37 leaves, the table, each layer's q/k/v
    # kernels and biases, out kernel and expert in/out kernels and in bias,
    # and the output layer are split; the LayerNorms, routers and the out
    # and expert-out biases are whole
    assert (int(got["split"]), int(got["leaves"])) == (23, 37)
