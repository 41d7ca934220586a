"""The port's side of the pipe, fsdp, tensor- and expert-parallel tests
(``test_torch_pipeline.py``, ``test_torch_sharding.py``,
``test_torch_tensor_parallel.py``, ``test_torch_expert_parallel.py``):
jobs run by gloo processes on the CPU, many cases to one spawn. This
module imports no JAX, so the spawned processes start quickly.

A job is a dict: ``name``, ``kind`` ("train", "forward", "restore",
"roundtrip" or "dcn"),
``mesh`` (``MeshConfig`` fields), ``model`` and ``train`` (config
fields), ``init`` (flat JAX-named arrays), and per kind ``batches`` ((src,
tgt) pairs), ``ckpt`` (a directory to save into after training, or to
restore from), ``hidden``/``mbs`` (forward), optionally ``wait_for`` (a
path to wait for before the job runs); "roundtrip" splits each leaf of
``init`` over the axes its rules name and gathers it back; "dcn" lays a
``dcn_data`` mesh over ranks that take ``nodes[rank]`` for their node and
writes each rank's coordinates (or the error). Rank 0 writes
``<out>/<name>.npz``; a forward job writes one file per rank
(``<name>.r<rank>.npz``) with the rows that rank holds.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from test_torch_ring_attention import join_job, spawn


def _gathered_state(trainer) -> dict[str, np.ndarray]:
    """The whole train state under its flat checkpoint names: each slice
    gathered over the axes that split it."""
    from transformer_tpu_torch.parallel import sharding
    from transformer_tpu_torch.train.checkpoint import to_numpy
    from transformer_tpu_torch.train.state import state_to_flat

    lay = trainer.layout
    out = {}
    for key, v in state_to_flat(trainer.state).items():
        if isinstance(v, torch.Tensor):
            v = sharding.gather_leaf(v.detach(), lay.splits.get(key, {}), trainer.mesh)
        out[key] = to_numpy(v)
    return out


def _trainer(job, mesh, ckpt=None):
    from transformer_tpu_torch.config import ModelConfig, TrainConfig
    from transformer_tpu_torch.convert import params_from_numpy
    from transformer_tpu_torch.parallel.distributed import DistributedTrainer
    from transformer_tpu_torch.train.state import create_train_state

    cfg, tcfg = ModelConfig(**job["model"]), TrainConfig(**job["train"])
    state = create_train_state(cfg, tcfg, params=params_from_numpy(job["init"], cfg, "cpu"))
    return DistributedTrainer(cfg, tcfg, mesh, state=state, log_fn=lambda *_: None,
                              checkpoint=ckpt)


def _run(job, mesh, rank, out):
    from transformer_tpu_torch.config import ModelConfig
    from transformer_tpu_torch.convert import params_from_numpy
    from transformer_tpu_torch.models.transformer import flatten
    from transformer_tpu_torch.parallel.pipeline import pipelined_transformer_apply
    from transformer_tpu_torch.train.checkpoint import CheckpointManager

    path = os.path.join(out, job["name"])
    if job["kind"] == "forward":
        cfg = ModelConfig(**job["model"])
        params = params_from_numpy(job["init"], cfg, "cpu")
        src, tgt = (None if a is None else torch.from_numpy(a).long() for a in job["batch"])
        got = pipelined_transformer_apply(mesh, params, src, tgt, cfg, job["mbs"],
                                          return_hidden=job["hidden"])
        rows = tgt.shape[0] // mesh.size("batch")
        np.savez(f"{path}.r{rank}.npz", out=got.numpy(),
                 row=mesh.group_index("batch") * rows)
        return
    if job["kind"] == "roundtrip":
        from transformer_tpu_torch.parallel import sharding

        same = []
        for name, arr in job["init"].items():
            full = torch.from_numpy(arr.copy())
            split = sharding.leaf_split(name, full.shape, mesh.shape)
            part = sharding.shard_leaf(full, split, mesh)
            back = sharding.gather_leaf(part, split, mesh)
            same.append(bool(split) and torch.equal(back, full))
            assert torch.equal(back, full), name
        if rank == 0:
            np.savez(path + ".npz", split=sum(same), leaves=len(same))
        return
    if job["kind"] == "restore":
        trainer = _trainer(job, mesh, CheckpointManager(job["ckpt"]))
        trainer.state = trainer.checkpoint.restore_latest(trainer.state)
        state = _gathered_state(trainer)
        if rank == 0:
            np.savez(path + ".npz", **state)
        return
    trainer = _trainer(job, mesh, CheckpointManager(job["ckpt"]) if job.get("ckpt") else None)
    losses, auxes, norms = [], [], []
    for src, tgt in job["batches"]:
        trainer.state, m = trainer.train_step(trainer.state, src, tgt)
        losses.append(float(m["loss"]))
        auxes.append(float(m.get("moe_aux", 0.0)))
        norms.append(float(m["grad_norm"]))
    if job.get("ckpt"):
        trainer.checkpoint.save(trainer.state)
    eval_m = trainer.eval_step(trainer.state, *job["batches"][0])
    full = {f"params/{k}": v.detach().numpy() for k, v in flatten(trainer.full_params()).items()}
    state = _gathered_state(trainer) if job.get("state") else {}
    if rank == 0:
        np.savez(path + ".npz", losses=losses, auxes=auxes, norms=norms,
                 eval_loss=float(eval_m["loss"]), **full,
                 **{f"state:{k}": v for k, v in state.items()})


def _worker(rank, world, port, jobs_path, out):
    from transformer_tpu_torch.config import MeshConfig
    from transformer_tpu_torch.parallel.mesh import make_mesh

    process = join_job(rank, world, port)
    with open(jobs_path, "rb") as f:
        jobs = pickle.load(f)
    for job in jobs:
        if job.get("wait_for"):
            _wait_for(job["wait_for"])
        if job["kind"] == "dcn":
            _dcn(job, process, rank, out)
            continue
        _run(job, make_mesh(MeshConfig(**job["mesh"]), process), rank, out)
    torch.distributed.destroy_process_group()


def _dcn(job, process, rank, out):
    import dataclasses

    from transformer_tpu_torch.config import MeshConfig
    from transformer_tpu_torch.parallel.mesh import make_mesh

    node = dataclasses.replace(process, node=job["nodes"][rank])
    path = os.path.join(out, f"{job['name']}.r{rank}.npz")
    try:
        mesh = make_mesh(MeshConfig(**job["mesh"]), node)
        np.savez(path, coords=np.asarray(mesh.coords), order=np.asarray(mesh.order),
                 peer=mesh.rank_at(data=(mesh.index("data") + 1) % mesh.shape["data"]))
    except ValueError as e:
        np.savez(path, error=str(e))


def _wait_for(path: str, timeout: float = 600.0) -> None:
    """Block until ``path`` exists (a file the test writes once the JAX
    side has made what the job reads)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.05)


def _stage(jobs: list[dict], out: str, world: int) -> str:
    """The jobs pickled beside ``out``: the processes read them from there,
    so what the spawn itself sends stays small and the processes start
    side by side (a large spawn argument is read by one child at a time,
    each after its imports)."""
    path = f"{out.rstrip(os.sep)}.jobs{world}.pkl"
    with open(path, "wb") as f:
        pickle.dump(jobs, f)
    return path


def start(worker, world: int, *args):
    """Start ``worker(rank, world, port, *args)`` on ``world`` gloo
    processes without waiting; ``finish`` waits (a failing process fails
    it). Spawns started together run side by side."""
    import torch.multiprocessing as mp

    from test_torch_ring_attention import free_port

    os.environ["OMP_NUM_THREADS"] = "1"
    return mp.spawn(worker, args=(world, free_port(), *args), nprocs=world, join=False)


def finish(handle) -> None:
    while not handle.join():
        pass


def run_jobs(jobs: list[dict], out: str, world: int) -> None:
    spawn(_worker, world, _stage(jobs, out, world), out)


def start_jobs(jobs: list[dict], out: str, world: int):
    return start(_worker, world, _stage(jobs, out, world), out)
