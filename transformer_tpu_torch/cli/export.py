"""Turn a training checkpoint into a serving export.

    python -m transformer_tpu_torch.cli.export --ckpt_path model_dist \\
        --export_path model --preset base --src_vocab_file src_vocab.subwords \\
        --tgt_vocab_file tgt_vocab.subwords [--step N] [--average_last 2] \\
        [--quantize int8] [--device cuda]

Port of ``transformer_tpu/cli/export.py``. Training already exports at
its end; this exports from a mid-run or preempted run's rotated
checkpoints (either package's), the chosen step (``--step``, default the
newest) or the average of the parameters of the last ``--average_last``
checkpoints up to it, optionally int8-quantized. The model flags are
``cli.train``'s and must match the training run's; the vocabulary sizes
come from the vocab files.
"""

from __future__ import annotations

import sys

from transformer_tpu_torch.cli import train

_FLAGS: dict[str, tuple] = {
    **train._FLAGS,
    "step": (int, 0, "checkpoint step to export (0 = the newest)"),
    "average_last": (int, 1, "average the params of the last N checkpoints up to the step"),
    "quantize": (str, "", "'int8': large weights as symmetric int8 codes + fp32 scales"),
}


def main(argv: list[str] | None = None, log_fn=print) -> list[int]:
    """Write the export; returns the checkpoint steps it was made from."""
    args = train.resolve_flags(argv, _FLAGS, __doc__)
    if args.quantize not in ("", "int8"):  # before any restore
        raise ValueError(f"--quantize must be '' or 'int8', got {args.quantize!r}")
    if args.average_last < 1:
        raise ValueError(f"--average_last must be >= 1, got {args.average_last}")
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
    from transformer_tpu_torch.device import resolve_device
    from transformer_tpu_torch.train.checkpoint import (
        CheckpointManager,
        average_checkpoints,
        export_params,
    )
    from transformer_tpu_torch.train.state import create_train_state

    device = resolve_device(args.device)
    mgr = CheckpointManager(args.ckpt_path, args.max_ckpt_keep, is_primary=False)
    available = mgr.all_steps()
    step = args.step or mgr.latest_step
    if step is None:
        raise ValueError(f"no checkpoints under {args.ckpt_path!r}")
    if args.step and args.step not in available:
        raise ValueError(
            f"no checkpoint at step {args.step} under {args.ckpt_path!r} (available: {available})"
        )
    tgt_vocab = SubwordTokenizer.load(args.tgt_vocab_file).model_vocab_size
    src_vocab = None if args.decoder_only else (
        SubwordTokenizer.load(args.src_vocab_file).model_vocab_size
    )
    model_cfg = train.model_config(args, tgt_vocab, src_vocab)
    template = create_train_state(model_cfg, train.train_config(args), device=device)
    steps = [s for s in available if s <= step][-args.average_last:]
    if len(steps) < args.average_last:
        log_fn(f"only {len(steps)} checkpoint(s) retained up to step {step}; averaging those "
               f"instead of the requested {args.average_last}")
    if len(steps) > 1:
        params = average_checkpoints(mgr, template, steps)
    else:
        params = mgr.restore(template, step).params
    export_params(params, model_cfg, args.export_path, quantize=args.quantize)
    what = f"average of steps {steps}" if len(steps) > 1 else f"step {step}"
    log_fn(f"exported {what} from {args.ckpt_path} to {args.export_path}"
           + (" (int8)" if args.quantize else ""))
    return steps


def run() -> int:
    """Console-script entry point: export, then exit with status 0."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(run())
