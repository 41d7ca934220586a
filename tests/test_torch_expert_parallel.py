"""Expert parallelism, MoE over the sequence axis, ``sharded-v1``
checkpoints with ``model`` and ``expert`` windows, and ``dcn_data``: the
port against the JAX package.

Tiny fp32 MoE LMs as ``test_torch_pipeline.py``'s (2 layers, d 32, 4
heads, dff 64, vocabulary 64, 4 experts, top-2, dropout 0; weights from a
JAX init); the port runs on four gloo processes on the CPU
(``torch_pipeline_jobs``, one spawn started before the JAX side runs),
JAX on the virtual CPU devices of ``conftest.py``:

- three train steps against JAX's ``DistributedTrainer`` at ``data 2 ×
  expert 2`` (a homogeneous MoE stack), ``model 2 × expert 2`` (a mixed
  dense/MoE stack, ``moe_every`` 2) and ``data 2 × seq 2`` under ring
  attention (each row routed over its whole sequence): loss, ``moe_aux``,
  ``grad_norm`` and the eval loss within 1e-5 relative, the parameters as
  ``test_torch_tensor_parallel.py`` holds them;
- the port's ``sharded-v1`` checkpoint of its ``model 2 × expert 2`` run
  (every rank writes its slices) restores in JAX byte for byte, and
  JAX's sharded checkpoint of its run restores in the port on that mesh
  and on one process byte for byte; the port's checkpoint restores on one
  process, whose checkpoint restores at ``data 2 × model 2``, each
  byte for byte;
- ``dcn_data``: ranks on interleaved nodes take their places in node
  order, and the refusals (``dcn_data`` not dividing ``data``, a node
  count other than ``dcn_data``) raise JAX's messages; one run of
  ``cli.distributed_train`` on two one-process nodes (``torch.distributed
  .run --nnodes 2`` on localhost, ``--dcn_data 2``);
- the refusals that remain (experts the expert axis does not divide,
  ``pipe`` with ``expert``) raise JAX's messages.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_pipeline_jobs as jobs
from test_torch_pipeline import TRAIN, _rel
from test_torch_tensor_parallel import _batches, _check_params, _init, _model
from transformer_tpu.config import MeshConfig as JMesh
from transformer_tpu.config import ModelConfig as JConfig
from transformer_tpu.config import TrainConfig as JTrain
from transformer_tpu.parallel.distributed import DistributedTrainer as JTrainer
from transformer_tpu.parallel.mesh import make_mesh as j_make_mesh
from transformer_tpu.train.checkpoint import CheckpointManager as JManager
from transformer_tpu.train.checkpoint import _flatten
from transformer_tpu.train.state import create_train_state as j_create_state
from transformer_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from transformer_tpu_torch.parallel.mesh import Process, make_mesh
from transformer_tpu_torch.train.checkpoint import CheckpointManager
from transformer_tpu_torch.train.state import create_train_state, state_to_flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE = dict(decoder_only=True, moe_experts=4, moe_top_k=2, moe_every=1)
CASES = {
    "dp2ep2-moe": (dict(data=2, expert=2), MOE, {}),
    "tp2ep2-moe": (dict(model=2, expert=2), dict(MOE, moe_every=2), {}),
    "dp2sp2-ring-moe": (dict(data=2, seq=2), dict(MOE, attention_impl="ring"), {}),
}
CKPT_CASE = "tp2ep2-moe"
NODES = [0, 1, 0, 1]  # ranks 0 and 2 on node 0, 1 and 3 on node 1
DCN = dict(data=2, model=2, dcn_data=2)


def _corpus(path, train_lines=100, test_lines=30):
    for split, n in (("train", train_lines), ("test", test_lines)):
        for side in ("src", "tgt"):
            with open(os.path.join(ROOT, "data", f"{side}-{split}.txt"), encoding="utf-8") as f:
                head = [next(f) for _ in range(n)]
            (path / f"{side}-{split}.txt").write_text("".join(head), encoding="utf-8")


def _start_two_nodes(root):
    """``cli.distributed_train`` on two one-process nodes of localhost."""
    from test_torch_ring_attention import free_port

    _corpus(root)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    port = str(free_port())
    argv = ["--device", "cpu", "--decoder_only", "--target_vocab_size", "300",
            "--num_layers", "1", "--d_model", "32", "--dff", "64", "--num_heads", "4",
            "--sequence_length", "32", "--batch_size", "8", "--epochs", "1",
            "--dcn_data", "2", "--dataset_path", str(root),
            "--tgt_vocab_file", str(root / "v.subwords"), "--ckpt_path", str(root / "ckpt"),
            "--export_path", str(root / "export"),
            "--metrics_json", str(root / "report.json"), "--consistency_check"]
    return [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2", "--node_rank",
         str(node), "--nproc_per_node", "1", "--master_addr", "localhost", "--master_port",
         port, "-m", "transformer_tpu_torch.cli.distributed_train", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for node in (0, 1)]


def _job(name, mesh, model, train, **extra):
    model = _model(model)
    return dict(name=name, kind="train", mesh=mesh, model=model, train={**TRAIN, **train},
                init=_init(model), batches=_batches(model), **extra)


def _jax_train(mesh_kw, model, train, ckpt=None):
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
    out["eval_loss"] = float(trainer.eval_step(state, *batches[0])["loss"])
    out["params"] = {k: np.asarray(v) for k, v in _flatten(state.params).items()}
    if ckpt is not None:
        out["state"] = {k: np.asarray(v) for k, v in _flatten(state).items()}
        JManager(ckpt, is_primary=True).save(state)
    return out


def _port_cfgs():
    mesh, model, train = CASES[CKPT_CASE]
    return ModelConfig(**_model(model)), TrainConfig(**TRAIN, **train)


def _one_card_hop(root):
    """The port's checkpoint of its run restored on one process, then saved
    from there (the replicated layout); returns that state's arrays."""
    jobs._wait_for(str(root / "port" / "ckpt_00000003"))
    cfg, tcfg = _port_cfgs()
    state = CheckpointManager(str(root / "port")).restore_latest(
        create_train_state(cfg, tcfg, device="cpu"))
    CheckpointManager(str(root / "one")).save(state)
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in state_to_flat(state).items()}


@pytest.fixture(scope="module")
def ep_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("expert")
    two = tmp_path_factory.mktemp("two_nodes")
    nodes = _start_two_nodes(two)
    mesh, model, train = CASES[CKPT_CASE]
    base = dict(mesh=mesh, model=_model(model), train={**TRAIN, **train},
                init=_init(_model(model)))
    js = [_job(CKPT_CASE, *CASES[CKPT_CASE], ckpt=str(root / "port"), state=True)]
    js += [_job(name, *case) for name, case in CASES.items() if name != CKPT_CASE]
    js += [
        dict(name="dcn-interleaved", kind="dcn", mesh=DCN, nodes=NODES),
        dict(name="dcn-one-node", kind="dcn", mesh=DCN, nodes=[0] * 4),
        dict(base, name="restore-jax", kind="restore", ckpt=str(root / "jax"),
             wait_for=str(root / "jax_saved")),
        dict(base, name="restore-dp2tp2", kind="restore", mesh=dict(data=2, model=2),
             ckpt=str(root / "one"), wait_for=str(root / "one_saved")),
    ]
    handle = jobs.start_jobs(js, str(root), 4)
    try:
        want = {name: _jax_train(*case, ckpt=str(root / "jax") if name == CKPT_CASE else None)
                for name, case in CASES.items()}
        (root / "jax_saved").touch()
        one = _one_card_hop(root)
        (root / "one_saved").touch()
    except BaseException:
        for proc in handle.processes:  # else the restore jobs wait for their markers
            proc.terminate()
        for proc in nodes:
            proc.kill()
        raise
    jobs.finish(handle)
    logs = [proc.communicate(timeout=300)[0] for proc in nodes]
    got = {}
    for name in os.listdir(root):
        if name.endswith(".npz"):
            with np.load(root / name) as data:
                got[name[: -len(".npz")]] = {k: data[k] for k in data.files}
    return root, got, want, one, (nodes, logs, two)


def _state(got: dict) -> dict:
    return {k[len("state:"):]: v for k, v in got.items() if k.startswith("state:")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_match_jax_trainer(ep_run, case):
    _, got_all, want_all, _, _ = ep_run
    got, want = got_all[case], want_all[case]
    for key in ("losses", "auxes", "norms"):
        for g, w in zip(got[key], want[key]):
            assert _rel(g, w) <= 1e-5, (key, list(got[key]), want[key])
    assert _rel(got["eval_loss"], want["eval_loss"]) <= 1e-5
    _check_params(got, {f"params/{k}": v for k, v in want["params"].items()}, 1e-5, 1e-2)


def test_port_sharded_checkpoint_restores_in_jax_byte_for_byte(ep_run):
    root, got, _, _, _ = ep_run
    (ckpt,) = [d for d in os.listdir(root / "port") if d.startswith("ckpt_")]
    files = sorted(os.listdir(root / "port" / ckpt))
    # every rank holds a distinct slice of the leaves model × expert split
    assert files == ["meta.json"] + [f"shards_p{r:05d}.npz" for r in range(4)]
    windows = []
    for rank in range(4):  # rank = 2 × model + expert
        with np.load(root / "port" / ckpt / f"shards_p{rank:05d}.npz") as shard:
            windows.append(set(shard.files))
    assert "params/decoder/layers/1/moe/in/kernel@2:4,0:32,32:64" in windows[3]
    # one writer per slice: a dense leaf split over model alone is written
    # by the rank at expert 0, a whole leaf by rank 0 alone
    key = "params/decoder/layers/0/ffn/in/kernel@0:32,32:64"
    assert [key in w for w in windows] == [False, False, True, False]
    key = "params/decoder/layers/0/ln1/scale@0:32"
    assert [key in w for w in windows] == [True, False, False, False]
    mesh, model, train = CASES[CKPT_CASE]
    template = j_create_state(jax.random.PRNGKey(1), JConfig(**_model(model)),
                              JTrain(**TRAIN, **train))
    back = _flatten(JManager(str(root / "port"), is_primary=True).restore_latest(template))
    port = _state(got[CKPT_CASE])
    assert sorted(back) == sorted(port)
    for key, arr in port.items():
        assert np.asarray(back[key]).tobytes() == arr.tobytes(), key


def test_jax_sharded_checkpoint_restores_in_port_byte_for_byte(ep_run):
    root, got, want, _, _ = ep_run
    jstate = want[CKPT_CASE]["state"]
    (ckpt,) = [d for d in os.listdir(root / "jax") if d.startswith("ckpt_")]
    assert any(n.startswith("shards_p") for n in os.listdir(root / "jax" / ckpt))
    on_mesh = got["restore-jax"]
    cfg, tcfg = _port_cfgs()
    one = state_to_flat(CheckpointManager(str(root / "jax")).restore_latest(
        create_train_state(cfg, tcfg, device="cpu")))
    assert sorted(on_mesh) == sorted(jstate) == sorted(one)
    for key, arr in jstate.items():
        assert on_mesh[key].tobytes() == np.asarray(arr).tobytes(), key
        v = one[key]
        v = v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        assert v.tobytes() == np.asarray(arr).tobytes(), key


def test_checkpoint_restores_across_topologies(ep_run):
    _, got, _, one, _ = ep_run
    port = _state(got[CKPT_CASE])  # written at model 2 × expert 2
    wide = got["restore-dp2tp2"]  # one card's checkpoint at data 2 × model 2
    assert sorted(port) == sorted(one) == sorted(wide)
    for key, arr in port.items():
        assert one[key].tobytes() == arr.tobytes() == wide[key].tobytes(), key


def test_dcn_data_places_ranks_in_node_order(ep_run):
    got = ep_run[1]
    order = sorted(range(4), key=lambda r: (NODES[r], r))  # JAX's granule order
    assert order == [0, 2, 1, 3]
    shape = MeshConfig(**DCN).axis_sizes
    for rank in range(4):
        mine = got[f"dcn-interleaved.r{rank}"]
        assert list(mine["order"]) == order
        want = np.unravel_index(order.index(rank), shape)
        assert tuple(int(c) for c in mine["coords"]) == tuple(int(c) for c in want)
        # the data axis spans the nodes: the data peer sits on the other node
        assert NODES[int(mine["peer"])] != NODES[rank]


def test_dcn_data_refusals_raise_jax_messages(ep_run):
    got = ep_run[1]
    with pytest.raises(ValueError) as want:
        j_make_mesh(JMesh(**DCN), devices=jax.devices()[:4])
    for rank in range(4):
        assert str(got[f"dcn-one-node.r{rank}"]["error"]) == str(want.value)
    with pytest.raises(ValueError) as port:
        make_mesh(MeshConfig(data=3, dcn_data=2), Process(0, 3, torch.device("cpu"), "gloo"))
    with pytest.raises(ValueError) as jax_msg:
        j_make_mesh(JMesh(data=3, dcn_data=2), devices=jax.devices()[:3])
    assert str(port.value) == str(jax_msg.value)


def test_cli_trains_on_two_nodes_with_dcn_data(ep_run):
    nodes, logs, two = ep_run[4]
    for proc, log in zip(nodes, logs):
        assert proc.returncode == 0, log[-3000:]
    assert "mesh: {'data': 2," in logs[0] and "consistency check" in logs[0], logs[0][-3000:]
    ranks = json.loads((two / "report.json").read_text())["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert ranks[0]["params_sha256"] == ranks[1]["params_sha256"]


REFUSALS = {
    "experts_over_ep": (dict(expert=2), dict(MOE, moe_experts=3), {}),
    "pipe_with_expert": (dict(pipe=2, expert=2), MOE, {}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_remaining_refusals_raise_jax_messages(case):
    from test_torch_sharding import _fake_mesh

    from transformer_tpu_torch.parallel.distributed import check_mesh

    axes, model, train = REFUSALS[case]
    model, train = _model(model), {**TRAIN, **train}
    with pytest.raises(ValueError) as got:
        check_mesh(ModelConfig(**model), TrainConfig(**train), _fake_mesh(axes))
    n = MeshConfig(**axes).num_devices
    mesh = j_make_mesh(JMesh(**axes), devices=jax.devices()[:n])
    with pytest.raises(ValueError) as want:
        JTrainer(JConfig(**model), JTrain(**train), mesh, log_fn=lambda *_: None)
    assert str(got.value) == str(want.value)
