"""Train a seq2seq translator on a parallel corpus, or a decoder-only LM
on its target side.

    python -m transformer_tpu_torch.cli.train --preset base --epochs 1 \
        --dataset_path data --src_vocab_file src_vocab.subwords \
        --tgt_vocab_file tgt_vocab.subwords [--export_path model] [--device cuda]
    python -m transformer_tpu_torch.cli.train --preset long4k --epochs 1 \
        --dataset_path data --tgt_vocab_file tgt_vocab.subwords

Port of ``transformer_tpu/cli/train.py``. Seq2seq (the default): load (or
build) both vocabularies and the sentence pairs, fit, translate a sample
sentence, write the export, then score BLEU on the first ``--bleu_limit``
test pairs (``--eval_bleu``). LM mode (``--decoder_only``): the LM windows
of the target side, then eval loss and perplexity from the final epoch's
full eval, and the export. As the JAX CLI does, both always checkpoint,
to ``--ckpt_path`` (default ``model_dist`` in the working directory):
the newest intact checkpoint there is restored before training, so a
relaunch with the same path resumes (after a finished run it trains
nothing and exports again); SIGTERM/SIGINT saves and ends the run. The
export (``params.npz`` + ``config.json``, the JAX export layout) loads
in ``cli.translate``/``cli.evaluate`` or ``cli.serve``. Flags keep the JAX CLI's names and defaults, and
``--preset`` fills the flags not given explicitly; argparse replaces
absl. ``--export_path`` (default ``model``) and ``--device`` (default
``cuda``) are the port's own. ``--steps_per_dispatch K`` runs K steps a
host dispatch (on the card by replaying a CUDA graph of the step, one per
batch shape), ``--length_buckets`` (seq2seq) pads each batch to the
smallest fitting width, ``--remat_policy dots`` keeps the dense products'
outputs under ``--remat``. Masked-LM training raises until its slice.
"""

from __future__ import annotations

import argparse
import math
import sys

# ``--preset`` values, a copy of transformer_tpu/cli/flags.py _PRESETS.
_PRESETS: dict[str, dict] = {
    "tiny": dict(num_layers=2, d_model=128, num_heads=4, dff=512, batch_size=64),
    "base": dict(num_layers=6, d_model=512, num_heads=8, dff=2048, batch_size=64),
    "big": dict(
        num_layers=6, d_model=1024, num_heads=16, dff=4096,
        label_smoothing=0.1, batch_size=32,
    ),
    "tied": dict(
        num_layers=6, d_model=512, num_heads=8, dff=2048,
        tie_embeddings=True, tie_output=True, batch_size=64,
    ),
    "long4k": dict(
        num_layers=6, d_model=512, num_heads=8, dff=2048,
        decoder_only=True, attention_impl="flash", sequence_length=4096,
        remat=True, batch_size=4,
    ),
}


def _bool(text: str) -> bool:
    if text.lower() in ("1", "true", "yes"):
        return True
    if text.lower() in ("0", "false", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


# name -> (type, default, help); the JAX CLI's defaults.
_FLAGS: dict[str, tuple] = {
    "dataset_path": (str, "data", "directory with src/tgt line files"),
    "src_vocab_file": (str, "src_vocab.subwords", "source subword vocab path (seq2seq)"),
    "tgt_vocab_file": (str, "tgt_vocab.subwords", "target subword vocab path"),
    "target_vocab_size": (int, 2**15, "subword vocab build target"),
    "sequence_length": (int, 50, "max sentence / LM window length (tokens incl. BOS/EOS)"),
    "epochs": (int, 4, "training epochs"),
    "batch_size": (int, 64, "global batch size"),
    "num_layers": (int, 4, "transformer layers"),
    "d_model": (int, 512, "model width"),
    "dff": (int, 1024, "FFN hidden width"),
    "num_heads": (int, 4, "attention heads"),
    "num_kv_heads": (int, 0, "grouped-query kv heads (0 = num_heads)"),
    "dropout_rate": (float, 0.1, "dropout rate"),
    "warmup_steps": (int, 60000, "LR warmup steps"),
    "lr_schedule": (str, "noam", "noam | cosine | constant"),
    "peak_lr": (float, 0.0, "peak LR for cosine/constant"),
    "lr_decay_steps": (int, 0, "cosine horizon"),
    "label_smoothing": (float, 0.0, "label smoothing epsilon"),
    "loss_normalization": (str, "tokens", "tokens | batch"),
    "max_grad_norm": (float, 0.0, "global-norm gradient clip (0 = off)"),
    "optimizer": (str, "adam", "adam | adamw (adafactor is not ported)"),
    "weight_decay": (float, 0.0, "adamw weight decay"),
    "tie_embeddings": (_bool, False, "share src/tgt embedding tables"),
    "tie_output": (_bool, False, "tie the output projection to the embedding"),
    "norm_scheme": (str, "post", "post | pre"),
    "ffn_activation": (str, "relu", "FFN activation"),
    "position_scheme": (str, "sinusoidal", "sinusoidal | rope"),
    "decoder_only": (_bool, False, "causal-LM mode (default: seq2seq translation)"),
    "objective": (str, "causal", "causal (mlm is not ported)"),
    "attention_impl": (str, "xla", "xla | flash | ring | ulysses (ring, ulysses: "
                       "cli.distributed_train --sp > 1)"),
    "attention_window": (int, 0, "sliding-window causal attention (0 = full)"),
    "dtype": (str, "bfloat16", "compute dtype"),
    "remat": (_bool, False, "rematerialize each layer in the backward"),
    "remat_policy": (str, "full", "what remat may keep: 'full' recomputes everything; 'dots' "
                     "keeps the dense products' outputs and recomputes the rest"),
    "eval_max_batches": (int, 8, "cap on in-loop eval batches (0 = all)"),
    "grad_accum": (int, 1, "gradient-accumulation micro-steps per optimizer update (1 = off)"),
    "loss_chunks": (int, 1, "vocab projection + CE over this many sequence slices (1 = off)"),
    "steps_per_dispatch": (int, 1, "optimizer steps per host dispatch (1 = off); on the card "
                           "each replays the step's CUDA graph, with no synchronize between "
                           "them; log/eval/preemption granularity becomes this many steps"),
    "length_buckets": (str, "", "seq2seq: comma-separated ascending batch widths (e.g. "
                       "'16,32,48,64', last <= sequence_length); batches pad to the smallest "
                       "fitting bucket, one CUDA graph per bucket ('' = off)"),
    "seed": (int, 0, "seed of the init, the shuffle and dropout"),
    "eval_bleu": (_bool, True, "seq2seq: corpus BLEU on the test split after training"),
    "bleu_limit": (int, 200, "score only the first N test pairs (0 = all)"),
    "export_path": (str, "model", "where to write params.npz + config.json"),
    "ckpt_path": (str, "model_dist", "checkpoint directory (restored from, then written)"),
    "max_ckpt_keep": (int, 5, "checkpoints to retain"),
    "async_checkpoint": (_bool, False, "write checkpoints from a background thread"),
    "early_stop_patience": (int, 0, "stop after this many epochs without eval-loss "
                            "improvement (0 = run all epochs)"),
    "device": (str, "cuda", "cuda (default) or cpu"),
}


def build_parser(flags: dict[str, tuple] = _FLAGS, doc: str = __doc__) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--preset", default="", choices=["", *sorted(_PRESETS)],
                    help="start from a benchmark config; explicit flags win")
    for name, (typ, _, help_) in flags.items():
        kw = dict(nargs="?", const=True) if typ is _bool else {}
        ap.add_argument(f"--{name}", type=typ, default=argparse.SUPPRESS, help=help_, **kw)
    return ap


def resolve_flags(
    argv: list[str] | None, flags: dict[str, tuple] = _FLAGS, doc: str = __doc__
) -> argparse.Namespace:
    """Defaults, then the preset, then the flags given explicitly."""
    explicit = vars(build_parser(flags, doc).parse_args(argv))
    preset = _PRESETS.get(explicit.pop("preset"), {})
    values = {name: spec[1] for name, spec in flags.items()}
    values.update(preset)
    values.update(explicit)
    if values["objective"] != "causal":
        raise NotImplementedError(
            "the port trains with the causal objective (seq2seq or --decoder_only); "
            "masked-LM training is a later slice"
        )
    return argparse.Namespace(**values)


def train_config(args: argparse.Namespace):
    from transformer_tpu_torch.config import TrainConfig

    return TrainConfig(
        batch_size=args.batch_size, sequence_length=args.sequence_length,
        epochs=args.epochs, warmup_steps=args.warmup_steps,
        lr_schedule=args.lr_schedule, peak_lr=args.peak_lr,
        lr_decay_steps=args.lr_decay_steps, label_smoothing=args.label_smoothing,
        loss_normalization=args.loss_normalization, max_grad_norm=args.max_grad_norm,
        optimizer=args.optimizer, weight_decay=args.weight_decay, seed=args.seed,
        eval_max_batches=args.eval_max_batches, grad_accum_steps=args.grad_accum,
        loss_chunks=args.loss_chunks, steps_per_dispatch=args.steps_per_dispatch,
        objective=args.objective, early_stop_patience=args.early_stop_patience,
        max_ckpt_keep=args.max_ckpt_keep, ckpt_path=args.ckpt_path,
    )


def checkpoint_manager(args: argparse.Namespace, train_cfg):
    """The run's checkpoint manager: async with ``--async_checkpoint``."""
    from transformer_tpu_torch.train.checkpoint import AsyncCheckpointManager, CheckpointManager

    cls = AsyncCheckpointManager if args.async_checkpoint else CheckpointManager
    return cls(train_cfg.ckpt_path, train_cfg.max_ckpt_keep)


def length_buckets(args: argparse.Namespace) -> tuple[int, ...]:
    return tuple(int(x) for x in args.length_buckets.split(",") if x.strip())


def load_data(args: argparse.Namespace, train_cfg, log_fn=print):
    """(train, test, tokenizer) LM splits; builds the vocabulary file when
    it is missing."""
    from transformer_tpu_torch.data.pipeline import load_lm_splits

    if length_buckets(args):
        raise ValueError(
            "--length_buckets applies to the seq2seq pipeline only; LM windows are "
            "already fixed-width (drop the flag with --decoder_only)"
        )
    train_ds, test_ds, tok = load_lm_splits(
        args.dataset_path, args.tgt_vocab_file, batch_size=train_cfg.batch_size,
        sequence_length=train_cfg.sequence_length,
        target_vocab_size=args.target_vocab_size, seed=train_cfg.seed,
    )
    log_fn(
        f"data: {train_ds.num_examples} train windows ({len(train_ds)} batches), "
        f"{test_ds.num_examples if test_ds else 0} test windows "
        f"({len(test_ds) if test_ds else 0} batches), vocab {tok.vocab_size}"
    )
    return train_ds, test_ds, tok


def load_pairs(args: argparse.Namespace, train_cfg, log_fn=print):
    """(train, test, src tokenizer, tgt tokenizer) seq2seq splits; builds
    missing vocabulary files."""
    from transformer_tpu_torch.data.pipeline import load_dataset

    train_ds, test_ds, src_tok, tgt_tok = load_dataset(
        args.dataset_path, args.src_vocab_file, args.tgt_vocab_file,
        batch_size=train_cfg.batch_size, sequence_length=train_cfg.sequence_length,
        target_vocab_size=args.target_vocab_size, seed=train_cfg.seed,
        length_buckets=length_buckets(args),
    )
    log_fn(
        f"data: {train_ds.num_examples} train pairs ({len(train_ds)} batches), "
        f"{test_ds.num_examples if test_ds else 0} test pairs, "
        f"vocabs {src_tok.vocab_size}/{tgt_tok.vocab_size}"
    )
    return train_ds, test_ds, src_tok, tgt_tok


def model_config(args: argparse.Namespace, vocab: int, input_vocab: int | None = None):
    """The model of the flags: ``vocab`` target ids, and ``input_vocab``
    source ids (default ``vocab``); ``max_position`` is
    ``max(sequence_length, 64)``, as the JAX CLI sets it."""
    from transformer_tpu_torch.config import ModelConfig

    return ModelConfig(
        num_layers=args.num_layers, d_model=args.d_model, num_heads=args.num_heads,
        num_kv_heads=args.num_kv_heads, dff=args.dff,
        input_vocab_size=vocab if input_vocab is None else input_vocab,
        target_vocab_size=vocab, dropout_rate=args.dropout_rate,
        max_position=max(args.sequence_length, 64), norm_scheme=args.norm_scheme,
        position_scheme=args.position_scheme, decoder_only=args.decoder_only,
        tie_embeddings=args.tie_embeddings, tie_output=args.tie_output,
        ffn_activation=args.ffn_activation, dtype=args.dtype,
        attention_impl=args.attention_impl, attention_window=args.attention_window,
        remat=args.remat, remat_policy=args.remat_policy,
    )


def load_for_model(args: argparse.Namespace, train_cfg, log_fn=print):
    """(train, test, model config, tokenizers) of the flags: LM windows and
    (tok,) with ``--decoder_only``, else sentence pairs and (src tok, tgt
    tok)."""
    if args.decoder_only:
        train_ds, test_ds, tok = load_data(args, train_cfg, log_fn)
        return train_ds, test_ds, model_config(args, tok.model_vocab_size), (tok,)
    train_ds, test_ds, src_tok, tgt_tok = load_pairs(args, train_cfg, log_fn)
    cfg = model_config(args, tgt_tok.model_vocab_size, src_tok.model_vocab_size)
    return train_ds, test_ds, cfg, (src_tok, tgt_tok)


def report_and_export(trainer, test_ds, export_path: str, log_fn=print) -> None:
    """Eval loss and perplexity of the final epoch's full eval (per target
    token, for seq2seq too), then the export."""
    from transformer_tpu_torch.convert import export_params

    if test_ds is not None and trainer.eval_metrics.weight > 0:
        loss = trainer.eval_metrics.loss
        log_fn(f"eval loss {loss:.4f}, perplexity {math.exp(min(loss, 30.0)):.2f}")
    elif test_ds is not None:
        log_fn("eval split produced no tokens; no perplexity")
    export_params(trainer.state.params, trainer.model_cfg, export_path)
    log_fn(f"exported params to {export_path}")


def epilogue(trainer, test_ds, toks, args, log_fn=print) -> None:
    """After the fit (``cli.distributed_train`` runs it on rank 0): an LM
    reports its eval loss and writes the export; a seq2seq model first
    translates a sample sentence, and after the export scores BLEU on the
    first ``--bleu_limit`` test pairs (``--eval_bleu``)."""
    if args.decoder_only:
        report_and_export(trainer, test_ds, args.export_path, log_fn)
        return
    from transformer_tpu_torch.train.decode import translate
    from transformer_tpu_torch.train.evaluate import bleu_on_test_files

    src_tok, tgt_tok = toks
    params, cfg, train_cfg = trainer.state.params, trainer.model_cfg, trainer.train_cfg
    sample = "he go to school"
    out = translate(params, cfg, src_tok, tgt_tok, sample, max_len=train_cfg.sequence_length)
    log_fn(f"sample translation {sample!r} -> {out[0]!r}")
    report_and_export(trainer, test_ds, args.export_path, log_fn)
    if args.eval_bleu:
        bleu_on_test_files(
            params, cfg, src_tok, tgt_tok, args.dataset_path,
            batch_size=train_cfg.batch_size, max_len=train_cfg.sequence_length,
            limit=args.bleu_limit, log_fn=log_fn,
        )


def main(argv: list[str] | None = None, log_fn=print):
    """Train and export (seq2seq: then translate and score); returns the
    trainer."""
    args = resolve_flags(argv)
    from transformer_tpu_torch.device import resolve_device
    from transformer_tpu_torch.train.state import create_train_state
    from transformer_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    train_cfg = train_config(args)
    train_ds, test_ds, model_cfg, toks = load_for_model(args, train_cfg, log_fn)
    state = create_train_state(model_cfg, train_cfg, device=device)
    trainer = Trainer(model_cfg, train_cfg, state, log_fn=log_fn,
                      checkpoint=checkpoint_manager(args, train_cfg))
    trainer.fit(train_ds, test_ds)
    if trainer.graph is not None:
        log_fn(
            f"steps_per_dispatch {train_cfg.steps_per_dispatch}: "
            f"{len(trainer.graph.captures)} CUDA graph capture(s) ("
            + ", ".join(f"src {sig[0]} tgt {sig[1]} in {sec:.2f}s"
                        for sig, sec in trainer.graph.captures) + ")"
        )
    epilogue(trainer, test_ds, toks, args, log_fn)
    return trainer


def run() -> int:
    """Console-script entry point: train, then exit with status 0."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(run())
