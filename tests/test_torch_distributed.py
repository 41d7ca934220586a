"""Data × sequence parallel training: the port's ``DistributedTrainer``
over gloo processes against the JAX package's one-device train step.

- ``DistributedTrainer`` at sp=4 and at dp=2 × sp=2 with remat (ring
  attention; 2 layers, d 64, 4 heads, S 64, fp32, dropout 0), three steps from
  converted JAX params, against JAX ``make_train_step`` (flash, one
  device), with ``tests/test_torch_train.py``'s limits: loss per step
  within 1e-5 relative, grad norm within 1e-4, params in units of the
  summed learning rate within 1e-5 on average and 1e-2 at worst (the key
  biases, whose gradient is rounding noise, within 2x it).
- Dropout 0.1: the sp=4 gradients equal the single-process ones from the
  same seed to 1e-5 per leaf (the key biases' below 1e-7), which holds
  only if every process draws the global masks.
- ``cli.distributed_train`` under ``torch.distributed.run`` (2 CPU
  processes, ring, sp 2) on 200 corpus lines writes an export that
  ``convert.load_export`` reads and logs an eval loss; as a console script
  in a world of one it exits 0.
- The transport rule on layouts, the rank -> (data, seq) map, and the
  guards: ring attention without a context, ``--tp 2`` (LM and seq2seq),
  ``--sp 2`` with flash attention, encoder-only models, Ulysses over heads
  the seq axis does not divide; seq2seq models and Ulysses are admitted.

Workers are module-level functions run in spawned processes (gloo on the
CPU, one thread each); they import no JAX.
"""

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
from transformer_tpu_torch.parallel.mesh import Mesh, Process, choose_transport, make_mesh
from transformer_tpu_torch.train.state import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 96
MODEL = dict(
    num_layers=2, d_model=64, num_heads=4, dff=128, input_vocab_size=VOCAB,
    target_vocab_size=VOCAB, max_position=64, decoder_only=True,
    attention_impl="flash", dropout_rate=0.0, dtype="float32",
)
TRAIN = dict(batch_size=2, sequence_length=64, warmup_steps=4)


def _batches(n, seed=0, b=2, s=64):
    """LM windows with PAD tails in the second row."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tgt = rng.integers(1, VOCAB, size=(b, s)).astype(np.int32)
        tgt[1, s - 9:] = 0
        out.append(tgt)
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _jax_init():
    import jax

    from transformer_tpu.config import ModelConfig as JConfig
    from transformer_tpu.config import TrainConfig as JTrain
    from transformer_tpu.train.checkpoint import _flatten
    from transformer_tpu.train.state import create_train_state as j_create_state

    state = j_create_state(jax.random.PRNGKey(0), JConfig(**MODEL), JTrain(**TRAIN))
    return state, {k: np.asarray(v) for k, v in _flatten(state.params).items()}


# --------------------------------------------------------------------------
# the trainer against JAX


def _train_worker(rank, world, port, dp, remat, init, batches, out_dir):
    from transformer_tpu_torch.parallel.distributed import DistributedTrainer

    mesh = make_mesh(MeshConfig(data=dp, seq=world // dp), join_job(rank, world, port))
    cfg = ModelConfig(**{**MODEL, "attention_impl": "ring", "remat": remat})
    tcfg = TrainConfig(**TRAIN)
    state = create_train_state(cfg, tcfg, params=params_from_numpy(init, cfg, device="cpu"))
    trainer = DistributedTrainer(cfg, tcfg, mesh, state=state, log_fn=lambda *_: None)
    losses, norms = [], []
    for tgt in batches:
        trainer.state, m = trainer.train_step(trainer.state, None, tgt)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    params = {k: v.detach().numpy() for k, v in flatten(trainer.state.params).items()}
    np.savez(os.path.join(out_dir, f"{rank}.npz"), losses=losses, norms=norms, **params)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def jax_run():
    import jax
    import jax.numpy as jnp

    from transformer_tpu.config import ModelConfig as JConfig
    from transformer_tpu.config import TrainConfig as JTrain
    from transformer_tpu.train.checkpoint import _flatten
    from transformer_tpu.train.trainer import make_train_step as j_make_train_step

    state, init = _jax_init()
    step = jax.jit(j_make_train_step(JConfig(**MODEL), JTrain(**TRAIN)))
    losses, norms = [], []
    for tgt in _batches(3):
        state, m = step(state, jnp.asarray(tgt), jnp.asarray(tgt), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return init, losses, norms, {k: np.asarray(v) for k, v in _flatten(state.params).items()}


@pytest.mark.parametrize("dp, sp, remat", [(1, 4, False), (2, 2, True)],
                         ids=["sp4", "dp2_sp2_remat"])
def test_distributed_trainer_matches_jax(jax_run, tmp_path, dp, sp, remat):
    from transformer_tpu.train.schedule import noam_schedule as j_noam

    init, want_losses, want_norms, want_params = jax_run
    spawn(_train_worker, dp * sp, dp, remat, init, _batches(3), str(tmp_path))
    runs = [np.load(tmp_path / f"{r}.npz") for r in range(dp * sp)]
    for run in runs:  # every process took the same steps
        assert np.array_equal(run["losses"], runs[0]["losses"])
        for key in want_params:
            assert np.array_equal(run[key], runs[0][key]), key
    got = runs[0]
    for g, w in zip(got["losses"], want_losses):
        assert _rel(g, w) <= 1e-5, (list(got["losses"]), want_losses)
    for g, w in zip(got["norms"], want_norms):
        assert _rel(g, w) <= 1e-4, (list(got["norms"]), want_norms)
    sched = j_noam(MODEL["d_model"], TRAIN["warmup_steps"])
    lr_sum = sum(float(sched(s)) for s in range(3))
    for key, want in want_params.items():
        diff = np.abs(got[key] - want) / lr_sum
        assert diff.max() <= 2.0, key
        if not key.endswith("self_mha/key/bias"):
            assert diff.mean() <= 1e-5 and diff.max() <= 1e-2, (key, diff.mean(), diff.max())


def _dispatch_worker(rank, world, port, init, batches, out_dir):
    """Steps 1-2 as one ``steps_per_dispatch`` 2 dispatch, step 3 alone."""
    from transformer_tpu_torch.parallel.distributed import DistributedTrainer

    mesh = make_mesh(MeshConfig(seq=world), join_job(rank, world, port))
    cfg = ModelConfig(**{**MODEL, "attention_impl": "ring"})
    tcfg = TrainConfig(**TRAIN, steps_per_dispatch=2)
    state = create_train_state(cfg, tcfg, params=params_from_numpy(init, cfg, device="cpu"))
    logs = []
    trainer = DistributedTrainer(cfg, tcfg, mesh, state=state, log_fn=logs.append)
    stacked = np.stack(batches[:2])
    trainer.state, m = trainer.multi_step(trainer.state, stacked, stacked)
    sums = [float(m[k]) for k in ("loss_sum", "weight", "correct")]
    trainer.state, _ = trainer.train_step(trainer.state, None, batches[2])
    params = {k: v.detach().numpy() for k, v in flatten(trainer.state.params).items()}
    np.savez(os.path.join(out_dir, f"{rank}.npz"), sums=sums, step=trainer.state.step,
             logs=np.asarray(logs), **params)
    torch.distributed.destroy_process_group()


def test_distributed_steps_per_dispatch_matches_jax(jax_run, tmp_path):
    """``steps_per_dispatch`` 2 over 2 gloo processes (ring, sp 2): the
    dispatch runs uncaptured (and says so once), and three steps land on
    the JAX step's params within the limits above."""
    from transformer_tpu.train.schedule import noam_schedule as j_noam

    init, _, _, want_params = jax_run
    spawn(_dispatch_worker, 2, init, _batches(3), str(tmp_path))
    runs = [np.load(tmp_path / f"{r}.npz") for r in range(2)]
    for run in runs:
        assert int(run["step"]) == 3 and np.array_equal(run["sums"], runs[0]["sums"])
        for key in want_params:
            assert np.array_equal(run[key], runs[0][key]), key
    assert [str(x) for x in runs[0]["logs"] if "uncaptured" in str(x)] == [
        "steps_per_dispatch 2: the steps of a dispatch run uncaptured (transport gloo: its "
        "sums go through host memory, which a CUDA graph cannot capture)"
    ]
    assert len(runs[1]["logs"]) == len(runs[0]["logs"])  # the test logs every rank
    sched = j_noam(MODEL["d_model"], TRAIN["warmup_steps"])
    lr_sum = sum(float(sched(s)) for s in range(3))
    for key, want in want_params.items():
        diff = np.abs(runs[0][key] - want) / lr_sum
        assert diff.max() <= 2.0, key
        if not key.endswith("self_mha/key/bias"):
            assert diff.mean() <= 1e-5 and diff.max() <= 1e-2, (key, diff.mean(), diff.max())


# --------------------------------------------------------------------------
# dropout: the global draws


DROPOUT_MODEL = {**MODEL, "dropout_rate": 0.1}


def _grads_worker(rank, world, port, init, tgt, out_dir):
    from transformer_tpu_torch.parallel.distributed import _seq_parallel_forward_loss
    from transformer_tpu_torch.train.trainer import loss_and_grads

    mesh = make_mesh(MeshConfig(seq=world), join_job(rank, world, port))
    cfg = ModelConfig(**{**DROPOUT_MODEL, "attention_impl": "ring"})
    params = params_from_numpy(init, cfg, device="cpu")
    for p in flatten(params).values():
        p.requires_grad_(True)
    metrics, grads = loss_and_grads(
        params, torch.from_numpy(tgt).long(), cfg, TrainConfig(**TRAIN), (0, 0),
        forward_loss=_seq_parallel_forward_loss(mesh),
    )
    mesh.all_reduce_sum_([*grads.values(), *metrics.values()])
    if rank == 0:
        np.savez(os.path.join(out_dir, "grads.npz"), loss=metrics["loss"].numpy(),
                 **{k: g.numpy() for k, g in grads.items()})
    torch.distributed.destroy_process_group()


def test_sp4_dropout_draws_the_single_process_masks(tmp_path):
    from transformer_tpu_torch.train.trainer import loss_and_grads

    _, init = _jax_init()
    tgt = _batches(1, seed=7)[0]
    spawn(_grads_worker, 4, init, tgt, str(tmp_path))
    got = np.load(tmp_path / "grads.npz")
    cfg = ModelConfig(**DROPOUT_MODEL)
    params = params_from_numpy(init, cfg, device="cpu")
    for p in flatten(params).values():
        p.requires_grad_(True)
    metrics, want = loss_and_grads(params, torch.from_numpy(tgt).long(), cfg,
                                   TrainConfig(**TRAIN), (0, 0))
    assert _rel(got["loss"], float(metrics["loss"])) <= 1e-5
    for key, w in want.items():
        if key.endswith("self_mha/key/bias"):  # zero up to rounding on both sides
            assert np.abs(got[key]).max() <= 1e-7 and w.abs().max() <= 1e-7
        else:
            assert _rel(got[key], w.numpy()) <= 1e-5, (key, _rel(got[key], w.numpy()))
    # ...and dropout did act: without it the loss differs.
    no_drop, _ = loss_and_grads(params, torch.from_numpy(tgt).long(), ModelConfig(**MODEL),
                                TrainConfig(**TRAIN), (0, 0))
    assert abs(float(no_drop["loss"]) - float(got["loss"])) > 1e-3


# --------------------------------------------------------------------------
# the CLI


def _corpus(tmp_path, train_lines=200, test_lines=60):
    for split, n in (("train", train_lines), ("test", test_lines)):
        for side in ("src", "tgt"):
            with open(os.path.join(ROOT, "data", f"{side}-{split}.txt"), encoding="utf-8") as f:
                head = [next(f) for _ in range(n)]
            (tmp_path / f"{side}-{split}.txt").write_text("".join(head), encoding="utf-8")


TINY = ["--device", "cpu", "--decoder_only", "--target_vocab_size", "400",
        "--num_layers", "1", "--d_model", "32", "--dff", "64", "--num_heads", "4",
        "--sequence_length", "64", "--batch_size", "8", "--epochs", "1", "--remat"]


def test_cli_under_torchrun_trains_a_ring_and_exports(tmp_path):
    _corpus(tmp_path)
    export, report = tmp_path / "export", tmp_path / "report.json"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "transformer_tpu_torch.cli.distributed_train", *TINY,
         "--attention_impl", "ring", "--sp", "2", "--dataset_path", str(tmp_path),
         "--tgt_vocab_file", str(tmp_path / "v.subwords"), "--export_path", str(export),
         "--ckpt_path", str(tmp_path / "ckpt"), "--metrics_json", str(report)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "transport: gloo" in proc.stdout and "eval loss" in proc.stdout, proc.stdout
    params, cfg = load_export(str(export), device="cpu")
    assert cfg.attention_impl == "ring" and cfg.num_layers == 1
    import json

    ranks = json.loads(report.read_text())["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert len(ranks[0]["step_seconds"]) > 0 and ranks[0]["eval_batches"] > 0
    assert ranks[0]["eval_loss"] == ranks[1]["eval_loss"]  # the metrics are summed over ranks
    for r in ranks:  # CPU tensors: plain versions, nothing staged through the host
        assert set(r["launches"].values()) == {0} and set(r["staged_bytes"].values()) == {0}


def test_console_script_exits_zero_in_a_world_of_one(tmp_path, monkeypatch):
    from transformer_tpu_torch.cli import distributed_train

    _corpus(tmp_path, 100, 40)
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(sys, "argv", [
        "ttpu-torch-distributed-train", *TINY, "--attention_impl", "flash",
        "--dataset_path", str(tmp_path), "--tgt_vocab_file", str(tmp_path / "v.subwords"),
        "--export_path", str(tmp_path / "export"), "--ckpt_path", str(tmp_path / "ckpt"),
    ])
    assert distributed_train.run() == 0
    assert load_export(str(tmp_path / "export"), device="cpu")[1].num_layers == 1


# --------------------------------------------------------------------------
# layout, transport and guards


@pytest.mark.parametrize(
    "device, ranks, cards, want",
    [("cpu", 4, 0, "gloo"), ("cuda", 4, 1, "gloo"), ("cuda", 4, 4, "nccl"), ("cuda", 2, 8, "nccl")],
)
def test_transport_rule(device, ranks, cards, want):
    assert choose_transport(device, ranks, cards) == want


def _fake_mesh(cfg, rank=0):
    process = Process(rank, cfg.num_devices, torch.device("cpu"), "gloo")
    coords = tuple(int(i) for i in np.unravel_index(rank, cfg.axis_sizes))
    return Mesh(cfg, process, coords, None)


def test_rank_layout_is_row_major_with_seq_fastest():
    cfg = MeshConfig(data=2, seq=2)
    got = [(_fake_mesh(cfg, r).index("data"), _fake_mesh(cfg, r).index("seq")) for r in range(4)]
    assert got == [(0, 0), (0, 1), (1, 0), (1, 1)]
    with pytest.raises(ValueError, match="needs 4 processes"):
        make_mesh(cfg, Process(0, 1, torch.device("cpu"), "none"))


def test_ring_attention_without_a_context_raises():
    from transformer_tpu_torch.ops.attention import mha_apply

    d, h = 16, 2
    p = {n: {"kernel": torch.zeros(d, h, d // h), "bias": torch.zeros(h, d // h)}
         for n in ("query", "key", "value")}
    p["out"] = {"kernel": torch.zeros(h, d // h, d), "bias": torch.zeros(d)}
    x = torch.zeros(1, 8, d)
    with pytest.raises(RuntimeError, match="needs an active sequence-parallel context"):
        mha_apply(p, x, x, impl="ring", causal=True)


def test_guards(tmp_path):
    from transformer_tpu_torch.cli import distributed_train
    from transformer_tpu_torch.parallel.distributed import DistributedTrainer, check_mesh

    for extra in (["--decoder_only"], []):  # LM and seq2seq alike
        with pytest.raises(NotImplementedError, match="--tp > 1"):
            distributed_train.main(["--tp", "2", *extra, "--device", "cpu",
                                    "--ckpt_path", str(tmp_path / "ckpt")])
    # Seq2seq models and Ulysses are admitted; encoder-only models and
    # heads that the seq axis does not divide are not.
    s2s = ModelConfig(**{**MODEL, "decoder_only": False})
    trainer = DistributedTrainer(s2s, TrainConfig(**TRAIN), _fake_mesh(MeshConfig()))
    assert trainer.train_step.uses_src
    check_mesh(ModelConfig(**{**MODEL, "decoder_only": False, "attention_impl": "ulysses"}),
               TrainConfig(**TRAIN), _fake_mesh(MeshConfig(seq=2)))
    with pytest.raises(ValueError, match="divisible by the seq axis"):
        check_mesh(ModelConfig(**{**MODEL, "attention_impl": "ulysses"}),
                   TrainConfig(**TRAIN), _fake_mesh(MeshConfig(seq=8)))
    with pytest.raises(NotImplementedError, match="encoder-only"):
        check_mesh(ModelConfig(**{**MODEL, "decoder_only": False, "encoder_only": True}),
                   TrainConfig(**TRAIN), _fake_mesh(MeshConfig()))
    with pytest.raises(ValueError, match="needs a sequence-parallel attention impl"):
        DistributedTrainer(ModelConfig(**MODEL), TrainConfig(**TRAIN),
                           _fake_mesh(MeshConfig(seq=2)))
    with pytest.raises(NotImplementedError, match="not ported"):
        DistributedTrainer(ModelConfig(**MODEL), TrainConfig(**TRAIN),
                           _fake_mesh(MeshConfig(model=2)))
    with pytest.raises(ValueError, match="divisible"):
        DistributedTrainer(ModelConfig(**MODEL), TrainConfig(**{**TRAIN, "batch_size": 3}),
                           _fake_mesh(MeshConfig(data=2)))


def test_cli_refuses_cuda_without_a_card(tmp_path):
    """Without a card the default device is refused, never replaced by the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from transformer_tpu_torch.cli import distributed_train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed_train.main(["--preset", "long4k", "--attention_impl", "ring",
                                "--dataset_path", str(tmp_path),
                                "--ckpt_path", str(tmp_path / "ckpt")])
