"""Seq2seq training over processes: the port's ``DistributedTrainer`` on
the encoder-decoder translator, over gloo processes, against the JAX
package's one-device train step on converted weights.

- Three steps (2 + 2 layers, d 64, 4 heads, B 4, ragged source and target
  rows with PAD tails, source width 30 and target 32, fp32, dropout 0,
  label smoothing 0.1) under data × sequence meshes: dp 4 (flash, its
  plain versions on the CPU), ring sp 4 (chunks of 8: the source pads to
  32 and its shortest row leaves whole chunks of PAD), Ulysses sp 2 and
  sp 4, and ring dp 2 × sp 2 with remat; against JAX ``make_train_step``
  with ``tests/test_torch_distributed.py``'s limits: loss per step within
  1e-5 relative, grad norm within 1e-4, params in units of the summed
  learning rate within 1e-5 on average and 1e-2 at worst (the key biases,
  whose gradient is rounding noise, within 2x it). Every process ends
  with the same parameters, bit for bit. (Adam turns rounding in a
  near-zero gradient element into a whole learning rate, so the
  per-element mean depends on the batches: on seeds 30-32, used here, the
  port's one-process step reads 8e-7 against JAX's.)
- Seeds 10-12, where JAX's own xla and flash steps differ by 2e-4 on
  average in ``decoder/layers/0/ln2/scale``: dp 4, ring sp 4 and Ulysses
  sp 2 held to JAX's xla step within the limits above plus that JAX-vs-JAX
  spread, per step and per leaf.
- Rope at source and target width 9 under ring sp 2 and sp 4 and Ulysses
  sp 2: the source pads to its own multiple of ``seq``, so its chunks are
  wider than the target's and the encoder must rotate at the source's
  global positions; against JAX.
- Dropout 0.1 at ring sp 4: the gradients, encoder included, equal the
  single-process ones from the same seed to 1e-5 per leaf, which holds
  only if both towers draw the global masks.
- Length-bucketed batches (widths 8, 6, 8) through the trainer at ring sp
  2, and ``steps_per_dispatch`` 2 over 2 processes, against JAX.
- ``gather_sequence`` over 4 processes: forward equal to the whole
  sequence, gradient equal to a single process's.
- ``cli.distributed_train`` under ``torch.distributed.run`` (2 CPU
  processes): tiny seq2seq on 200 pairs with ``--consistency_check``
  writes an export that ``convert.load_export`` reads and
  ``cli.translate`` runs; ``--length_buckets`` under ``--dp 2``.

Workers are module-level functions run in spawned processes (gloo on the
CPU, one thread each); they import no JAX.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_ring_attention import join_job, spawn
from transformer_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from transformer_tpu_torch.convert import load_export, params_from_numpy
from transformer_tpu_torch.models.transformer import flatten
from transformer_tpu_torch.parallel.mesh import make_mesh
from transformer_tpu_torch.train.state import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_VOCAB, TGT_VOCAB = 50, 60
MODEL = dict(
    num_layers=2, d_model=64, num_heads=4, dff=128, input_vocab_size=SRC_VOCAB,
    target_vocab_size=TGT_VOCAB, max_position=64, dropout_rate=0.0, dtype="float32",
)
TRAIN = dict(batch_size=4, sequence_length=64, warmup_steps=4, label_smoothing=0.1)
MESHES = {
    "dp4_flash": dict(dp=4, sp=1, impl="flash"),
    "ring_sp4": dict(dp=1, sp=4, impl="ring"),
    "ulysses_sp2": dict(dp=1, sp=2, impl="ulysses"),
    "ulysses_sp4": dict(dp=1, sp=4, impl="ulysses"),
    "ring_dp2_sp2_remat": dict(dp=2, sp=2, impl="ring", remat=True),
}


def _pairs(seed, b=4, s_src=30, s_tgt=32):
    """(src, tgt) batches with every row padded after its own length; the
    last source row keeps 5 tokens, so at ring sp 4 (chunks of 8) its
    later chunks are PAD only."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, SRC_VOCAB, size=(b, s_src)).astype(np.int32)
    tgt = rng.integers(1, TGT_VOCAB, size=(b, s_tgt)).astype(np.int32)
    for row, (ls, lt) in enumerate(zip((30, 21, 13, 5), (32, 27, 17, 9))):
        src[row, ls:] = 0
        tgt[row, lt:] = 0
    return src, tgt


def _bucket_batches():
    """Three batches of bucketed widths 8, 6 and 8 (source and target)."""
    out = []
    for i, w in enumerate((8, 6, 8)):
        src, tgt = _pairs(20 + i, s_src=w, s_tgt=w)
        src[:, w - 2 :] = np.where(np.arange(4)[:, None] > 1, 0, src[:, w - 2 :])
        tgt[:, w - 1 :] = np.where(np.arange(4)[:, None] > 0, 0, tgt[:, w - 1 :])
        out.append((src, tgt))
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _jax_run(batches, model=MODEL):
    """Three JAX steps from one init: (init, losses, grad norms, params)."""
    import jax
    import jax.numpy as jnp

    from transformer_tpu.config import ModelConfig as JConfig
    from transformer_tpu.config import TrainConfig as JTrain
    from transformer_tpu.train.checkpoint import _flatten
    from transformer_tpu.train.state import create_train_state as j_create_state
    from transformer_tpu.train.trainer import make_train_step as j_make_train_step

    jcfg, jtcfg = JConfig(**model), JTrain(**TRAIN)
    state = j_create_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    init = {k: np.asarray(v) for k, v in _flatten(state.params).items()}
    step = jax.jit(j_make_train_step(jcfg, jtcfg))
    losses, norms = [], []
    for src, tgt in batches:
        state, m = step(state, jnp.asarray(src), jnp.asarray(tgt), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return init, losses, norms, {k: np.asarray(v) for k, v in _flatten(state.params).items()}


@pytest.fixture(scope="module")
def jax_run():
    return _jax_run([_pairs(30 + i) for i in range(3)])


def _hold_to_jax(runs, want_losses, want_norms, want_params, got_losses=True, spread=None):
    """``spread`` adds to each limit the distance between two of JAX's own
    runs on the same batches (per step for the loss and grad norm,
    ``losses`` and ``norms``; per leaf for the parameters' mean and worst
    element, ``params``): by the triangle inequality, a port within the
    limits of one JAX run is within limit + spread of the other."""
    spread = spread or {}
    for run in runs:  # every process took the same steps
        for key in want_params:
            assert np.array_equal(run[key], runs[0][key]), key
    got = runs[0]
    if got_losses:
        assert all(np.array_equal(r["losses"], got["losses"]) for r in runs)
        for i, (g, w) in enumerate(zip(got["losses"], want_losses)):
            limit = 1e-5 + spread.get("losses", [0.0] * 3)[i]
            assert _rel(g, w) <= limit, (list(got["losses"]), want_losses)
        for i, (g, w) in enumerate(zip(got["norms"], want_norms)):
            limit = 1e-4 + spread.get("norms", [0.0] * 3)[i]
            assert _rel(g, w) <= limit, (list(got["norms"]), want_norms)
    from transformer_tpu.train.schedule import noam_schedule as j_noam

    sched = j_noam(MODEL["d_model"], TRAIN["warmup_steps"])
    lr_sum = sum(float(sched(s)) for s in range(3))
    for key, want in want_params.items():
        diff = np.abs(got[key] - want) / lr_sum
        assert diff.max() <= 2.0, key
        if not key.endswith("mha/key/bias"):
            mean, worst = spread.get("params", {}).get(key, (0.0, 0.0))
            assert diff.mean() <= 1e-5 + mean and diff.max() <= 1e-2 + worst, (
                key, diff.mean(), diff.max())


# --------------------------------------------------------------------------
# the trainer against JAX


def _train_worker(rank, world, port, mesh_kw, init, batches, out_dir):
    from transformer_tpu_torch.parallel.distributed import DistributedTrainer

    mesh = make_mesh(MeshConfig(data=mesh_kw["dp"], seq=mesh_kw["sp"]),
                     join_job(rank, world, port))
    cfg = ModelConfig(**{**MODEL, **mesh_kw.get("model", {}), "attention_impl": mesh_kw["impl"],
                         "remat": mesh_kw.get("remat", False)})
    tcfg = TrainConfig(**TRAIN)
    state = create_train_state(cfg, tcfg, params=params_from_numpy(init, cfg, device="cpu"))
    trainer = DistributedTrainer(cfg, tcfg, mesh, state=state, log_fn=lambda *_: None)
    losses, norms = [], []
    for src, tgt in batches:
        trainer.state, m = trainer.train_step(trainer.state, src, tgt)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    params = {k: v.detach().numpy() for k, v in flatten(trainer.state.params).items()}
    np.savez(os.path.join(out_dir, f"{rank}.npz"), losses=losses, norms=norms, **params)
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("name", list(MESHES))
def test_seq2seq_trainer_matches_jax(jax_run, tmp_path, name):
    init, want_losses, want_norms, want_params = jax_run
    mesh_kw = MESHES[name]
    world = mesh_kw["dp"] * mesh_kw["sp"]
    spawn(_train_worker, world, mesh_kw, init, [_pairs(30 + i) for i in range(3)],
          str(tmp_path))
    runs = [np.load(tmp_path / f"{r}.npz") for r in range(world)]
    _hold_to_jax(runs, want_losses, want_norms, want_params)


def test_bucketed_widths_at_sp2_match_jax(tmp_path):
    batches = _bucket_batches()
    init, want_losses, want_norms, want_params = _jax_run(batches)
    spawn(_train_worker, 2, dict(dp=1, sp=2, impl="ring"), init, batches, str(tmp_path))
    runs = [np.load(tmp_path / f"{r}.npz") for r in range(2)]
    _hold_to_jax(runs, want_losses, want_norms, want_params)


@pytest.fixture(scope="module")
def jax_spread_run():
    """JAX's xla steps on seeds 10-12 and the distance of JAX's own flash
    steps from them: per step for the loss and grad norm, and per leaf the
    parameters' mean and worst element in units of the summed learning
    rate."""
    batches = [_pairs(10 + i) for i in range(3)]
    init, losses, norms, params = _jax_run(batches)
    _, f_losses, f_norms, flash = _jax_run(batches, {**MODEL, "attention_impl": "flash"})
    from transformer_tpu.train.schedule import noam_schedule as j_noam

    sched = j_noam(MODEL["d_model"], TRAIN["warmup_steps"])
    lr_sum = sum(float(sched(s)) for s in range(3))
    spread = dict(
        losses=[_rel(f, w) for f, w in zip(f_losses, losses)],
        norms=[_rel(f, w) for f, w in zip(f_norms, norms)],
        params={k: (float(np.abs(flash[k] - w).mean() / lr_sum),
                    float(np.abs(flash[k] - w).max() / lr_sum)) for k, w in params.items()},
    )
    return batches, init, losses, norms, params, spread


@pytest.mark.parametrize("name", ["dp4_flash", "ring_sp4", "ulysses_sp2"])
def test_seq2seq_trainer_within_jax_own_spread_on_seeds_10_to_12(jax_spread_run, tmp_path, name):
    batches, init, want_losses, want_norms, want_params, spread = jax_spread_run
    assert max(m for m, _ in spread["params"].values()) > 1e-5  # Adam amplifies rounding
    mesh_kw = MESHES[name]
    world = mesh_kw["dp"] * mesh_kw["sp"]
    spawn(_train_worker, world, mesh_kw, init, batches, str(tmp_path))
    runs = [np.load(tmp_path / f"{r}.npz") for r in range(world)]
    _hold_to_jax(runs, want_losses, want_norms, want_params, spread=spread)


ROPE_MESHES = {
    "ring_sp2": dict(dp=1, sp=2, impl="ring", model={"position_scheme": "rope"}),
    "ulysses_sp2": dict(dp=1, sp=2, impl="ulysses", model={"position_scheme": "rope"}),
    "ring_sp4": dict(dp=1, sp=4, impl="ring", model={"position_scheme": "rope"}),
}


@pytest.mark.parametrize("name", list(ROPE_MESHES))
def test_rope_seq2seq_with_unequal_chunk_widths_matches_jax(tmp_path, name):
    """Source and target width 9: the source pads to a multiple of ``seq``
    on its own (10 at sp 2, 12 at sp 4) and the teacher-forcing input is 8,
    so the encoder's chunks are wider than the decoder's and each tower
    must rotate at its own global positions."""
    batches = []
    for i in range(3):
        src, tgt = _pairs(40 + i, s_src=9, s_tgt=9)
        src[2:, 6:], tgt[1:, 7:] = 0, 0
        batches.append((src, tgt))
    mesh_kw = ROPE_MESHES[name]
    init, want_losses, want_norms, want_params = _jax_run(
        batches, {**MODEL, "position_scheme": "rope"})
    world = mesh_kw["sp"]
    spawn(_train_worker, world, mesh_kw, init, batches, str(tmp_path))
    runs = [np.load(tmp_path / f"{r}.npz") for r in range(world)]
    _hold_to_jax(runs, want_losses, want_norms, want_params)


def _dispatch_worker(rank, world, port, init, batches, out_dir):
    """Steps 1-2 as one ``steps_per_dispatch`` 2 dispatch, step 3 alone."""
    from transformer_tpu_torch.parallel.distributed import DistributedTrainer

    mesh = make_mesh(MeshConfig(seq=world), join_job(rank, world, port))
    cfg = ModelConfig(**{**MODEL, "attention_impl": "ring"})
    tcfg = TrainConfig(**TRAIN, steps_per_dispatch=2)
    state = create_train_state(cfg, tcfg, params=params_from_numpy(init, cfg, device="cpu"))
    trainer = DistributedTrainer(cfg, tcfg, mesh, state=state, log_fn=lambda *_: None)
    src = np.stack([b[0] for b in batches[:2]])
    tgt = np.stack([b[1] for b in batches[:2]])
    trainer.state, _ = trainer.multi_step(trainer.state, src, tgt)
    trainer.state, _ = trainer.train_step(trainer.state, *batches[2])
    params = {k: v.detach().numpy() for k, v in flatten(trainer.state.params).items()}
    np.savez(os.path.join(out_dir, f"{rank}.npz"), step=trainer.state.step, **params)
    torch.distributed.destroy_process_group()


def test_steps_per_dispatch_over_two_processes_matches_jax(jax_run, tmp_path):
    init, want_losses, want_norms, want_params = jax_run
    spawn(_dispatch_worker, 2, init, [_pairs(30 + i) for i in range(3)], str(tmp_path))
    runs = [np.load(tmp_path / f"{r}.npz") for r in range(2)]
    assert all(int(r["step"]) == 3 for r in runs)
    _hold_to_jax(runs, want_losses, want_norms, want_params, got_losses=False)


# --------------------------------------------------------------------------
# dropout: both towers draw the global masks


DROPOUT_MODEL = {**MODEL, "dropout_rate": 0.1}


def _grads_worker(rank, world, port, init, batch, out_dir):
    from transformer_tpu_torch.parallel.distributed import _seq_parallel_forward_loss
    from transformer_tpu_torch.train.trainer import loss_and_grads

    mesh = make_mesh(MeshConfig(seq=world), join_job(rank, world, port))
    cfg = ModelConfig(**{**DROPOUT_MODEL, "attention_impl": "ring"})
    params = params_from_numpy(init, cfg, device="cpu")
    for p in flatten(params).values():
        p.requires_grad_(True)
    src, tgt = (torch.from_numpy(a).long() for a in batch)
    metrics, grads = loss_and_grads(params, tgt, cfg, TrainConfig(**TRAIN), (0, 0),
                                    forward_loss=_seq_parallel_forward_loss(mesh), src=src)
    mesh.all_reduce_sum_([*grads.values(), *metrics.values()])
    if rank == 0:
        np.savez(os.path.join(out_dir, "grads.npz"), loss=metrics["loss"].numpy(),
                 **{k: g.numpy() for k, g in grads.items()})
    torch.distributed.destroy_process_group()


def test_ring_sp4_dropout_draws_the_single_process_masks(jax_run, tmp_path):
    from transformer_tpu_torch.train.trainer import loss_and_grads

    init = jax_run[0]
    batch = _pairs(7)
    spawn(_grads_worker, 4, init, batch, str(tmp_path))
    got = np.load(tmp_path / "grads.npz")
    src, tgt = (torch.from_numpy(a).long() for a in batch)

    def single(model_kw):
        cfg = ModelConfig(**model_kw)
        params = params_from_numpy(init, cfg, device="cpu")
        for p in flatten(params).values():
            p.requires_grad_(True)
        return loss_and_grads(params, tgt, cfg, TrainConfig(**TRAIN), (0, 0), src=src)

    metrics, want = single(DROPOUT_MODEL)
    assert _rel(got["loss"], float(metrics["loss"])) <= 1e-5
    for key, w in want.items():
        if key.endswith("mha/key/bias"):  # zero up to rounding on both sides
            assert np.abs(got[key]).max() <= 1e-6 and w.abs().max() <= 1e-6, key
        else:
            assert _rel(got[key], w.numpy()) <= 1e-5, (key, _rel(got[key], w.numpy()))
    assert any(k.startswith("encoder/") for k in want)
    # ...and dropout did act, on the encoder too: without it the gradients differ.
    no_drop, plain = single(MODEL)
    assert abs(float(no_drop["loss"]) - float(got["loss"])) > 1e-3
    enc = "encoder/layers/0/ffn/in/kernel"
    assert _rel(got[enc], plain[enc].numpy()) > 1e-3


# --------------------------------------------------------------------------
# gather_sequence


def _gather_worker(rank, world, port, x, weights, out_dir):
    from transformer_tpu_torch.parallel.seq_context import SeqParallelContext, gather_sequence

    mesh = make_mesh(MeshConfig(seq=world), join_job(rank, world, port))
    c = x.shape[1] // world
    part = torch.from_numpy(np.ascontiguousarray(x[:, rank * c : (rank + 1) * c]))
    part.requires_grad_(True)
    full = gather_sequence(part, SeqParallelContext(mesh.seq_group, rank, world, rank * c))
    (full * torch.from_numpy(weights[rank])).sum().backward()  # each rank reads it otherwise
    np.savez(os.path.join(out_dir, f"{rank}.npz"), full=full.detach().numpy(),
             grad=part.grad.numpy())
    torch.distributed.destroy_process_group()


def test_gather_sequence_gradient_matches_a_single_process(tmp_path):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 8)).astype(np.float32)
    weights = rng.standard_normal((4, 2, 16, 8)).astype(np.float32)
    spawn(_gather_worker, 4, x, weights, str(tmp_path))
    runs = [np.load(tmp_path / f"{r}.npz") for r in range(4)]
    for run in runs:
        assert np.array_equal(run["full"], x)
    # One process reading x four ways: d/dx of sum_r (x * w_r).sum().
    xt = torch.from_numpy(x).requires_grad_(True)
    sum((xt * torch.from_numpy(w)).sum() for w in weights).backward()
    got = np.concatenate([r["grad"] for r in runs], axis=1)
    np.testing.assert_allclose(got, xt.grad.numpy(), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# the CLI


def _corpus(tmp_path, train_lines=200, test_lines=60):
    for split, n in (("train", train_lines), ("test", test_lines)):
        for side in ("src", "tgt"):
            with open(os.path.join(ROOT, "data", f"{side}-{split}.txt"), encoding="utf-8") as f:
                head = [next(f) for _ in range(n)]
            (tmp_path / f"{side}-{split}.txt").write_text("".join(head), encoding="utf-8")


TINY = ["--device", "cpu", "--target_vocab_size", "400", "--num_layers", "1",
        "--d_model", "32", "--dff", "64", "--num_heads", "4", "--sequence_length", "32",
        "--batch_size", "8", "--epochs", "1", "--bleu_limit", "8"]


def _torchrun(tmp_path, *flags):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "transformer_tpu_torch.cli.distributed_train", *TINY,
         "--dataset_path", str(tmp_path), "--src_vocab_file", str(tmp_path / "s.subwords"),
         "--tgt_vocab_file", str(tmp_path / "t.subwords"), *flags],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )


def test_cli_trains_seq2seq_over_a_ring_with_the_consistency_check(tmp_path):
    _corpus(tmp_path)
    export, report = tmp_path / "export", tmp_path / "report.json"
    proc = _torchrun(tmp_path, "--attention_impl", "ring", "--sp", "2", "--consistency_check",
                     "--export_path", str(export), "--ckpt_path", str(tmp_path / "ckpt"),
                     "--metrics_json", str(report))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for line in ("transport: gloo", "sample translation", "exported params to",
                 "consistency check: params after epoch 1 identical on 2 processes",
                 "consistency check: final params identical on 2 processes", "test BLEU"):
        assert line in proc.stdout, (line, proc.stdout)
    params, cfg = load_export(str(export), device="cpu")
    assert not cfg.decoder_only and cfg.attention_impl == "ring" and cfg.num_layers == 1
    ranks = json.loads(report.read_text())["ranks"]
    assert len({r["params_sha256"] for r in ranks}) == 1
    for r in ranks:
        assert r["consistency_check"]["passed"] and r["consistency_check"]["checks"] == 2
        assert set(r["staged_bytes"]) >= {"ring", "ulysses", "gather", "collectives"}
    from transformer_tpu_torch.cli import translate

    out = io.StringIO()
    got = translate.main(["--device", "cpu", "--export_path", str(export),
                          "--src_vocab_file", str(tmp_path / "s.subwords"),
                          "--tgt_vocab_file", str(tmp_path / "t.subwords"),
                          "--sentences", "he go to school;the house"], stdout=out)
    assert len(got) == 2 and out.getvalue() == "".join(t + "\n" for t in got)


def test_cli_length_buckets_under_dp2(tmp_path):
    _corpus(tmp_path)
    proc = _torchrun(tmp_path, "--attention_impl", "flash", "--dp", "2",
                     "--length_buckets", "16,24,32", "--eval_bleu", "false",
                     "--export_path", str(tmp_path / "export"),
                     "--ckpt_path", str(tmp_path / "ckpt"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "mesh: {'data': 2" in proc.stdout and "exported params to" in proc.stdout
    assert load_export(str(tmp_path / "export"), device="cpu")[1].num_layers == 1
