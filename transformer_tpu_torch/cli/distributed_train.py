"""Train a decoder-only LM over several processes: data × sequence parallel.

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m transformer_tpu_torch.cli.distributed_train --preset long4k \\
        --attention_impl ring --sp 4 --epochs 1 --dataset_path data \\
        --tgt_vocab_file tgt_vocab.subwords [--export_path model] [--device cuda]

Port of the LM-window mode of ``transformer_tpu/cli/distributed_train.py``.
The flags are ``cli.train``'s plus the mesh: ``--dp`` (0 = every process
not used by the other axes), ``--sp`` (the ring, with ``--attention_impl
ring``), and ``--fsdp/--tp/--pp/--ep``, which raise above 1. Without the
launcher's environment it runs as a world of one. Each process reads the
same data and keeps its part of each batch; rank 0 builds a missing
vocabulary before the others read it, logs, reports the eval and writes
the export. Checkpoints follow ``cli.train``'s flags (``--ckpt_path``,
``--max_ckpt_keep``, ``--async_checkpoint``): rank 0 writes them, every
rank restores the newest at start. The transport (NCCL, or gloo through
host memory when ranks share a card or run on the CPU) is chosen at
start-up and logged.
``--metrics_json`` writes every rank's step times, losses, kernel launch
counts, staged bytes, step, whether it writes checkpoints and a digest of
its parameters, gathered on rank 0.
"""

from __future__ import annotations

import json
import sys

from transformer_tpu_torch.cli import train

_FLAGS: dict[str, tuple] = {
    **train._FLAGS,
    "dp": (int, 0, "data-parallel mesh size (0 = the processes left by the other axes)"),
    "fsdp": (int, 1, "fsdp mesh size (only 1 is ported)"),
    "tp": (int, 1, "tensor-parallel mesh size (only 1 is ported)"),
    "sp": (int, 1, "sequence-parallel mesh size (ring attention)"),
    "pp": (int, 1, "pipeline-parallel mesh size (only 1 is ported)"),
    "ep": (int, 1, "expert-parallel mesh size (only 1 is ported)"),
    "metrics_json": (str, "", "write every rank's counters and step times here (rank 0)"),
}


def _report(trainer, process) -> dict:
    from transformer_tpu_torch.convert import params_digest
    from transformer_tpu_torch.kernels.flash_attention import (
        flash_dkdv,
        flash_dq,
        flash_fwd,
        flash_ring_step,
    )
    from transformer_tpu_torch.parallel.mesh import staged_bytes

    return {
        "rank": process.rank, "device": str(process.device), "transport": process.transport,
        "launches": {f.__name__: f.launches
                     for f in (flash_fwd, flash_ring_step, flash_dq, flash_dkdv)},
        "staged_bytes": dict(staged_bytes), "step_seconds": trainer.step_seconds,
        "tokens": trainer.tokens, "eval_batches": trainer.eval_batches,
        "train_loss": trainer.train_metrics.loss, "eval_loss": trainer.eval_metrics.loss,
        "params_sha256": params_digest(trainer.state.params),
        "step": trainer.state.step, "checkpoint_writer": trainer.checkpoint.is_primary,
    }


def main(argv: list[str] | None = None, log_fn=print):
    """Train over the launcher's processes and export from rank 0;
    returns the trainer."""
    args = train.resolve_flags(argv, _FLAGS, __doc__)
    if not args.decoder_only:
        raise NotImplementedError(
            "cli.distributed_train trains decoder-only LMs (--decoder_only); seq2seq "
            "models train on one card through cli.train"
        )
    for name in ("fsdp", "tp", "pp", "ep"):
        if getattr(args, name) > 1:
            raise NotImplementedError(
                f"--{name} > 1 is not ported yet; the port runs --dp and --sp"
            )
    import torch.distributed as dist

    from transformer_tpu_torch.config import MeshConfig
    from transformer_tpu_torch.parallel.distributed import DistributedTrainer
    from transformer_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    process = initialize_distributed(args.device, log_fn)
    log = log_fn if process.rank == 0 else (lambda *_: None)
    try:
        dp = args.dp or max(1, process.world_size // args.sp)
        mesh = make_mesh(MeshConfig(data=dp, seq=args.sp), process)
        log(f"mesh: {mesh.shape} over {process.world_size} processes")
        train_cfg = train.train_config(args)
        if process.rank != 0:
            mesh.barrier()  # rank 0 builds a missing vocabulary first
        train_ds, test_ds, tok = train.load_data(args, train_cfg, log)
        if process.rank == 0:
            mesh.barrier()
        model_cfg = train.model_config(args, tok.model_vocab_size)
        trainer = DistributedTrainer(model_cfg, train_cfg, mesh, log_fn=log,
                                     checkpoint=train.checkpoint_manager(args, train_cfg))
        trainer.fit(train_ds, test_ds)
        if process.rank == 0:
            train.report_and_export(trainer, test_ds, args.export_path, log)
        if args.metrics_json:
            reports = [None] * process.world_size if process.rank == 0 else None
            if process.world_size > 1:
                dist.gather_object(_report(trainer, process), reports, dst=0)
            else:
                reports = [_report(trainer, process)]
            if process.rank == 0:
                with open(args.metrics_json, "w") as f:
                    json.dump({"mesh": mesh.shape, "ranks": reports}, f)
        mesh.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return trainer


def run() -> int:
    """Console-script entry point: train, then exit with status 0."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(run())
