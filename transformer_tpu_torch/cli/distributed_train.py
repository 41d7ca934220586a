"""Train a seq2seq translator or a decoder-only LM over several processes:
data × sequence parallel.

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m transformer_tpu_torch.cli.distributed_train --preset base \\
        --attention_impl ulysses --sp 4 --epochs 1 --dataset_path data \\
        --src_vocab_file src_vocab.subwords --tgt_vocab_file tgt_vocab.subwords \\
        [--consistency_check] [--export_path model] [--device cuda]
    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m transformer_tpu_torch.cli.distributed_train --preset long4k \\
        --attention_impl ring --sp 4 --epochs 1 --dataset_path data \\
        --tgt_vocab_file tgt_vocab.subwords

Port of ``transformer_tpu/cli/distributed_train.py``. The flags are
``cli.train``'s plus the mesh: ``--dp`` (0 = every process not used by
the other axes), ``--sp`` (the sequence split, with ``--attention_impl
ring`` or ``ulysses``), and ``--fsdp/--tp/--pp/--ep/--dcn_data``, which
raise above 1 (``--pp_microbatches`` and ``--pp_schedule`` away from
their defaults too). Without the launcher's environment it runs as a
world of one. Each process reads the same data (the same global batches
in the same order: the native loader's by default, as ``cli.train``'s,
length buckets and ``--streaming`` included) and keeps its part of each
batch; rank 0 builds
a missing vocabulary before the others read it, logs, and runs the
epilogue of ``cli.train``: for seq2seq the sample translation, the export
and ``--eval_bleu``; for an LM the eval loss and the export.
``--consistency_check`` asserts after every epoch, and once on the final
parameters, that every process holds the same parameter bytes
(``utils.consistency``). Checkpoints follow ``cli.train``'s flags
(``--ckpt_path``, ``--max_ckpt_keep``, ``--async_checkpoint``): rank 0
writes them, every rank restores the newest at start. The transport
(NCCL, or gloo through host memory when ranks share a card or run on the
CPU) is chosen at start-up and logged. ``--metrics_json`` writes every
rank's step times, dispatch losses, kernel launch counts, staged bytes
by kind, step, whether it writes checkpoints, the consistency check's
outcome and time, and a digest of its parameters, gathered on rank 0.
Rank 0 alone owns the telemetry (``--metrics_jsonl``, ``--trace``, ...),
the ``--profile_dir`` window and the TensorBoard logs, as in the JAX CLI:
the metrics it records are already summed over the processes.
"""

from __future__ import annotations

import json
import os
import sys
import time

from transformer_tpu_torch.cli import train

_FLAGS: dict[str, tuple] = {
    **train._FLAGS,
    "dp": (int, 0, "data-parallel mesh size (0 = the processes left by the other axes)"),
    "fsdp": (int, 1, "fsdp mesh size (only 1 is ported)"),
    "tp": (int, 1, "tensor-parallel mesh size (only 1 is ported)"),
    "sp": (int, 1, "sequence-parallel mesh size (ring or ulysses attention)"),
    "pp": (int, 1, "pipeline-parallel mesh size (only 1 is ported)"),
    "ep": (int, 1, "expert-parallel mesh size (only 1 is ported)"),
    "metrics_json": (str, "", "write every rank's counters and step times here (rank 0)"),
    "consistency_check": (train._bool, False, "assert after every epoch and at the end that "
                          "every process holds bit-identical parameters"),
}


def _report(trainer, process, consistency: dict) -> dict:
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
        "losses": trainer.losses, "tokens": trainer.tokens,
        "target_tokens": trainer.train_metrics.weight, "eval_batches": trainer.eval_batches,
        "train_loss": trainer.train_metrics.loss, "eval_loss": trainer.eval_metrics.loss,
        "params_sha256": params_digest(trainer.state.params),
        "step": trainer.state.step, "checkpoint_writer": trainer.checkpoint.is_primary,
        "consistency_check": consistency,
    }


def main(argv: list[str] | None = None, log_fn=print):
    """Train over the launcher's processes and export from rank 0;
    returns the trainer."""
    args = train.resolve_flags(argv, _FLAGS, __doc__)
    for name in ("fsdp", "tp", "pp", "ep", "dcn_data"):
        if getattr(args, name) > 1:
            raise NotImplementedError(
                f"--{name} > 1 is not ported yet; the port runs --dp and --sp"
            )
    for name in ("pp_microbatches", "pp_schedule"):
        if getattr(args, name) != _FLAGS[name][1]:
            raise NotImplementedError(
                f"--{name} belongs to the pipeline axis (--pp), which is not ported yet"
            )
    import torch.distributed as dist

    from transformer_tpu_torch.config import MeshConfig
    from transformer_tpu_torch.parallel.distributed import DistributedTrainer
    from transformer_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from transformer_tpu_torch.utils.consistency import assert_cross_process_consistent

    process = initialize_distributed(args.device, log_fn)
    log = log_fn if process.rank == 0 else (lambda *_: None)
    try:
        dp = args.dp or max(1, process.world_size // args.sp)
        mesh = make_mesh(MeshConfig(data=dp, seq=args.sp), process)
        log(f"mesh: {mesh.shape} over {process.world_size} processes")
        train_cfg = train.train_config(args)
        if process.rank != 0:
            mesh.barrier()  # rank 0 builds missing vocabularies first
        train_ds, test_ds, model_cfg, toks = train.load_for_model(args, train_cfg, log)
        if process.rank == 0:
            mesh.barrier()
        primary = process.rank == 0
        telemetry = train.flags_to_telemetry(args, log) if primary else None
        trainer = DistributedTrainer(
            model_cfg, train_cfg, mesh, log_fn=log,
            checkpoint=train.checkpoint_manager(args, train_cfg),
            log_dir=os.path.join(args.tb_log_dir, train.run_stamp()) if primary else None,
            profiler=train.flags_to_profiler(args) if primary else None,
            telemetry=telemetry,
        )
        consistency = {"enabled": bool(args.consistency_check), "checks": 0, "passed": None,
                       "seconds": 0.0}

        def check(label: str) -> None:
            t0 = time.perf_counter()
            assert_cross_process_consistent(trainer.state.params, label=label)
            seconds = time.perf_counter() - t0
            consistency["checks"] += 1
            consistency["seconds"] += seconds
            log(f"consistency check: {label} identical on {process.world_size} processes "
                f"({seconds:.3f}s)")

        if args.consistency_check:
            trainer.fit(train_ds, test_ds,
                        epoch_callback=lambda epoch, _: check(f"params after epoch {epoch + 1}"))
            check("final params")
            consistency["passed"] = True
        else:
            trainer.fit(train_ds, test_ds)
        if telemetry is not None:
            telemetry.close()
        if process.rank == 0:
            train.epilogue(trainer, test_ds, toks, args, log)
        if args.metrics_json:
            reports = [None] * process.world_size if process.rank == 0 else None
            report = _report(trainer, process, consistency)
            if process.world_size > 1:
                dist.gather_object(report, reports, dst=0)
            else:
                reports = [report]
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
