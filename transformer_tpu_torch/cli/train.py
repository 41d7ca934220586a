"""Train a seq2seq translator on a parallel corpus, or a decoder-only LM
or an encoder-only masked LM on its target side.

    python -m transformer_tpu_torch.cli.train --preset base --epochs 1 \
        --dataset_path data --src_vocab_file src_vocab.subwords \
        --tgt_vocab_file tgt_vocab.subwords [--export_path model] [--device cuda]
    python -m transformer_tpu_torch.cli.train --preset long4k --epochs 1 \
        --dataset_path data --tgt_vocab_file tgt_vocab.subwords
    python -m transformer_tpu_torch.cli.train --preset base --objective mlm \
        --attention_impl flash --sequence_length 128 --epochs 1 \
        --dataset_path data --tgt_vocab_file tgt_vocab.subwords

Port of ``transformer_tpu/cli/train.py``. Seq2seq (the default): load (or
build) both vocabularies and the sentence pairs, fit, translate a sample
sentence, write the export, then score BLEU on the first ``--bleu_limit``
test pairs (``--eval_bleu``). LM mode (``--decoder_only``, or
``--objective mlm``, which trains an encoder-only model on the same
windows, masked afresh every step, with the vocabulary one id larger for
[MASK]): the LM windows of the target side, then eval loss and
perplexity from the final epoch's full eval (the MLM's over its constant
eval masks), and the export. As the JAX CLI does, both always checkpoint,
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
outputs under ``--remat``. ``--optimizer adafactor`` trains with
optax's Adafactor.

Every flag of the JAX CLI parses here, with absl's spellings (``--f=v``,
``--f``, ``--nof``). Seq2seq batches come from the C++ loader
(``--native_loader``, default true: the JAX CLI's batch order), or with
``--streaming`` from disk through a ``--buffer_size`` shuffle buffer.
The reference's ``--enable_function`` (false: no captured steps) and
``--per_replica_batch_size`` (unused) keep JAX's meaning, ``--platform``
picks ``--device``, and the mesh flags are accepted and unused (they are
``cli.distributed_train``'s). ``--moe_experts`` above 0 is refused by
name: MoE is a later slice of the port.

Telemetry, as the JAX CLI's: ``--metrics_jsonl PATH`` streams JSONL
events (``train.window``, ``train.eval``, ``train.memory``,
``train.compile``, periodic ``metrics.snapshot``) and rewrites a
Prometheus exposition at ``PATH.prom`` every ``--metrics_interval``
seconds; ``--metrics_port`` serves ``/metrics`` and ``/healthz``;
``--trace`` adds ``trace.span`` events (``train.fit``, ``train.step``,
``train.eval``, ``ckpt.*``); ``--profile_programs`` (default on) the
``perf_seconds_train_step`` stream; ``--flight_recorder`` (default on)
keeps the last events in memory and dumps them to
``PATH.flight.json``. Read them with ``python -m
transformer_tpu_torch.obs summarize PATH``. ``--profile_dir`` records a
``torch.profiler`` window of ``--profile_num_steps`` steps from
``--profile_start_step``; TensorBoard scalars go under
``--tb_log_dir/<run stamp>/{train,test}`` (default ``logs``).
"""

from __future__ import annotations

import argparse
import math
import os
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
    if text.lower() in ("1", "true", "t", "yes"):
        return True
    if text.lower() in ("0", "false", "f", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def add_bool_flag(ap: argparse.ArgumentParser, name: str, default, help_: str) -> None:
    """A boolean flag with absl's spellings: ``--name``, ``--name=false``
    (or ``--name false``) and ``--noname``."""
    ap.add_argument(f"--{name}", type=_bool, nargs="?", const=True, default=default,
                    help=help_)
    ap.add_argument(f"--no{name}", dest=name, action="store_const", const=False,
                    default=default, help=argparse.SUPPRESS)


# The JAX CLIs' telemetry flags (its define_metrics_flags), shared by the
# trainers, cli.serve, cli.router and the replica worker: name -> (type,
# default, help).
METRICS_FLAGS: dict[str, tuple] = {
    "metrics_jsonl": (str, "", "write structured telemetry (JSONL events + periodic metric "
                      "snapshots) to this file; a Prometheus text exposition is rewritten "
                      "alongside it at <file>.prom. Summarize with `python -m "
                      "transformer_tpu_torch.obs summarize <file>`. '' = off"),
    "metrics_port": (int, 0, "serve a Prometheus /metrics (and /healthz) scrape endpoint on "
                     "this port (0 = off); works with or without --metrics_jsonl"),
    "metrics_interval": (float, 10.0, "seconds between periodic metric-snapshot flushes (prom "
                         "file + metrics.snapshot events)"),
    "trace": (_bool, False, "record hierarchical trace.span events into --metrics_jsonl; "
              "export with `python -m transformer_tpu_torch.obs trace <file> --out "
              "trace.json` and load in chrome://tracing / Perfetto. Answers, losses and kernel "
              "launches are unaffected"),
    "profile_programs": (_bool, True, "per-program profiler (obs/profile.py): each pool step, "
                         "verify, prefill and train dispatch, timed up to its device "
                         "synchronize, into perf_seconds_* histograms and tokens/s gauges; "
                         "report with `python -m transformer_tpu_torch.obs roofline <file>`"),
    "flight_recorder": (_bool, True, "bounded flight recorder (obs/flight.py): the last "
                        "events/spans/snapshots in memory, dumped to "
                        "<metrics_jsonl>.flight.json on SIGTERM, on close and every 2 s. "
                        "Needs --metrics_jsonl"),
}
# The trainers' profiler and TensorBoard flags.
_PROFILER_FLAGS: dict[str, tuple] = {
    "profile_dir": (str, "", "record a torch.profiler trace (CUDA kernels on the card) of a "
                    "window of steps into this dir ('' = off)"),
    "profile_start_step": (int, 2, "first step of the profile window (after the first step "
                           "seen)"),
    "profile_num_steps": (int, 3, "profile window length in steps"),
    "tb_log_dir": (str, "logs", "TensorBoard log root: each run writes <root>/<stamp>/train "
                   "and /test"),
}

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
    "optimizer": (str, "adam", "adam | adafactor | adamw"),
    "weight_decay": (float, 0.0, "adamw weight decay"),
    "tie_embeddings": (_bool, False, "share src/tgt embedding tables"),
    "tie_output": (_bool, False, "tie the output projection to the embedding"),
    "norm_scheme": (str, "post", "post | pre"),
    "ffn_activation": (str, "relu", "FFN activation"),
    "position_scheme": (str, "sinusoidal", "sinusoidal | rope"),
    "decoder_only": (_bool, False, "causal-LM mode (default: seq2seq translation)"),
    "objective": (str, "causal", "training objective: 'causal' (teacher-forcing seq2seq / "
                  "LM) or 'mlm' (BERT-style masked-LM on an encoder-only model: trains on "
                  "target-side LM windows like --decoder_only, masks dynamically in-step, "
                  "reserves the top input id for [MASK])"),
    "mlm_mask_rate": (float, 0.15, "fraction of non-pad positions selected per MLM step "
                      "(80/10/10 mask/random/keep split within the selection)"),
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
    # The data path.
    "native_loader": (_bool, True, "seq2seq: batch through the C++ prefetching loader "
                      "(native/), in its splitmix64 order per (seed, epoch), the JAX CLI's "
                      "default batch sequence; without the library, or false, the numpy "
                      "order"),
    "streaming": (_bool, False, "seq2seq: stream the train corpus from disk through a "
                  "--buffer_size shuffle buffer instead of loading it (needs the vocab "
                  "files; no --length_buckets, and the native loader is not used)"),
    "buffer_size": (int, 100000, "shuffle buffer of --streaming, in examples: bounds host "
                    "memory (the in-memory paths shuffle whole epochs)"),
    # The reference's compat flags and the JAX CLI's platform switch.
    "enable_function": (_bool, True, "false = the reference's eager-debug mode: the step is "
                        "never captured, and --steps_per_dispatch > 1 is refused"),
    "per_replica_batch_size": (int, 16, "the reference's compat flag: accepted and unused "
                               "(the batch is --batch_size), as in the JAX CLI"),
    "platform": (str, "", "'cpu' runs on the CPU, 'gpu' or 'cuda' on the card (must agree "
                 "with --device when both are given); '' = --device"),
    # The JAX CLI's mesh flags: cli.distributed_train reads them; here they
    # are accepted and unused, as the JAX cli.train leaves them.
    "dp": (int, 0, "cli.distributed_train's data axis (unused here)"),
    "fsdp": (int, 1, "cli.distributed_train's fsdp axis (unused here)"),
    "tp": (int, 1, "cli.distributed_train's tensor axis (unused here)"),
    "sp": (int, 1, "cli.distributed_train's sequence axis (unused here)"),
    "pp": (int, 1, "cli.distributed_train's pipeline axis (unused here)"),
    "ep": (int, 1, "cli.distributed_train's expert axis (unused here)"),
    "pp_microbatches": (int, 0, "cli.distributed_train's GPipe microbatches (unused here)"),
    "pp_schedule": (str, "gpipe", "cli.distributed_train's pipeline schedule (unused here)"),
    "dcn_data": (int, 1, "cli.distributed_train's multi-slice data split (unused here)"),
    "consistency_check": (_bool, False, "cli.distributed_train's cross-process check "
                          "(unused here)"),
    # MoE: accepted at the JAX CLI's defaults, --moe_experts refused by
    # name above 0 (_LATER).
    "moe_experts": (int, 0, "refused above 0: MoE is a later slice of the port"),
    "moe_top_k": (int, 2, "experts each token routes to (with --moe_experts)"),
    "moe_capacity_factor": (float, 1.25, "expert capacity slack (with --moe_experts)"),
    "moe_every": (int, 1, "every k-th layer carries the MoE FFN (with --moe_experts)"),
    "moe_aux_weight": (float, 0.01, "load-balance loss weight (with --moe_experts)"),
    **METRICS_FLAGS,
    **_PROFILER_FLAGS,
}

# Flags of later slices, refused by name when set away from the JAX CLI's
# default (as cli.router does).
_LATER: dict[str, str] = {
    "moe_experts": "--moe_experts > 0: MoE (ops/moe.py) is a later slice of the port",
}

_PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def build_parser(flags: dict[str, tuple] = _FLAGS, doc: str = __doc__) -> argparse.ArgumentParser:
    """The flags with absl's spellings: ``--name value``, ``--name=value``,
    and for a boolean also ``--name`` and ``--noname``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--preset", default="", choices=["", *sorted(_PRESETS)],
                    help="start from a benchmark config; explicit flags win")
    for name, (typ, _, help_) in flags.items():
        if typ is _bool:
            add_bool_flag(ap, name, argparse.SUPPRESS, help_)
        else:
            ap.add_argument(f"--{name}", type=typ, default=argparse.SUPPRESS, help=help_)
    return ap


def resolve_flags(
    argv: list[str] | None, flags: dict[str, tuple] = _FLAGS, doc: str = __doc__
) -> argparse.Namespace:
    """Defaults, then the preset, then the flags given explicitly. A flag
    of a later slice set away from its default is refused by name;
    ``--platform`` picks ``--device``."""
    explicit = vars(build_parser(flags, doc).parse_args(argv))
    values = {name: spec[1] for name, spec in flags.items()}
    values.update(_PRESETS.get(explicit["preset"], {}))
    values.update(explicit)
    if values["objective"] not in ("causal", "mlm"):
        raise ValueError(f"--objective must be 'causal' or 'mlm', got {values['objective']!r}")
    for name, message in _LATER.items():
        if name in flags and values[name] != flags[name][1]:
            raise SystemExit(message)
    if values.get("platform"):
        device = _PLATFORMS.get(values["platform"].lower())
        if device is None:
            raise SystemExit(f"--platform {values['platform']!r}: the port runs on 'cpu' or "
                             "on the card ('gpu' or 'cuda')")
        given = explicit.get("device")
        if given is not None and given.split(":")[0] != device:
            raise SystemExit(f"--platform {values['platform']!r} conflicts with --device "
                             f"{given!r}")
        values["device"] = given or device
    return argparse.Namespace(**values)


def flags_to_profiler(args: argparse.Namespace):
    """``utils.profiling.Profiler`` from the ``--profile_*`` flags, or None
    when profiling is off."""
    if not args.profile_dir:
        return None
    from transformer_tpu_torch.utils.profiling import Profiler

    return Profiler(args.profile_dir, start_step=args.profile_start_step,
                    num_steps=args.profile_num_steps)


def flags_to_telemetry(args: argparse.Namespace, log_fn=print):
    """``obs.Telemetry`` from the ``--metrics_*`` flags, or None when
    telemetry is off (``--metrics_jsonl`` unset and ``--metrics_port`` 0, the
    zero-overhead default), as the JAX CLI's ``flags_to_telemetry``: the
    event log behind a sink breaker (3 failures open it, a re-probe after
    30 s), ``--trace``'s tracer, ``--profile_programs``' profiler, the
    flight recorder at ``<metrics_jsonl>.flight.json`` with its SIGTERM
    dump (autodump every 2 s), and the ``/metrics`` endpoint."""
    if not args.metrics_jsonl and not args.metrics_port:
        return None
    from transformer_tpu_torch.obs import EventLog, Telemetry
    from transformer_tpu_torch.obs.breaker import CircuitBreaker

    events = None
    if args.metrics_jsonl:
        events = EventLog(
            args.metrics_jsonl,
            breaker=CircuitBreaker("event_sink", threshold=3, cooldown_s=30.0),
        )
    if args.trace and events is None:
        log_fn("--trace needs --metrics_jsonl to record trace.span events; tracing disabled "
               "for this run")
    telemetry = Telemetry(
        events=events,
        prom_path=f"{args.metrics_jsonl}.prom" if args.metrics_jsonl else None,
        interval=args.metrics_interval,
        trace=args.trace and events is not None,
    )
    if args.profile_programs:
        telemetry.arm_profiler()
    if args.flight_recorder and args.metrics_jsonl:
        from transformer_tpu_torch.obs.flight import flight_path_for

        recorder = telemetry.arm_flight(flight_path_for(args.metrics_jsonl), autodump_s=2.0)
        recorder.install_signal_handlers()
    if args.metrics_port:
        port = telemetry.start_prometheus_server(args.metrics_port)
        log_fn(f"Prometheus /metrics (+ /healthz) on port {port}")
    return telemetry


def run_stamp() -> str:
    """The per-run directory name under ``--tb_log_dir``."""
    import datetime

    return datetime.datetime.now().strftime("%Y%m%d-%H%M%S")


def lm_mode(args: argparse.Namespace) -> bool:
    """LM windows of the target side: the causal decoder-only LM and the
    encoder-only masked LM."""
    return args.decoder_only or args.objective == "mlm"


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
        objective=args.objective, mlm_mask_rate=args.mlm_mask_rate,
        early_stop_patience=args.early_stop_patience,
        max_ckpt_keep=args.max_ckpt_keep, ckpt_path=args.ckpt_path,
        enable_function=args.enable_function, buffer_size=args.buffer_size,
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
            "--length_buckets applies to the seq2seq pipeline only; LM "
            "windows are already fixed-width (drop the flag with "
            "--decoder_only / --objective=mlm)"
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
    missing vocabulary files. Batches through the native loader with
    ``--native_loader`` (the default), from disk with ``--streaming``."""
    from transformer_tpu_torch.data.pipeline import load_dataset

    train_ds, test_ds, src_tok, tgt_tok = load_dataset(
        args.dataset_path, args.src_vocab_file, args.tgt_vocab_file,
        batch_size=train_cfg.batch_size, sequence_length=train_cfg.sequence_length,
        target_vocab_size=args.target_vocab_size, seed=train_cfg.seed,
        # streaming reads line by line and leaves the native loader out: it
        # needs the in-memory example table
        prefetch=args.native_loader and not args.streaming,
        length_buckets=length_buckets(args), streaming=args.streaming,
        buffer_size=args.buffer_size,
    )
    test = (f"{test_ds.num_examples if test_ds else 0} test pairs, "
            f"vocabs {src_tok.vocab_size}/{tgt_tok.vocab_size}")
    if args.streaming:
        # counting the train pairs would cost the corpus pass streaming avoids
        log_fn(f"data: streaming corpus (buffer {args.buffer_size}), {test}")
    else:
        loader = "native loader" if args.native_loader else "numpy order"
        log_fn(f"data: {train_ds.num_examples} train pairs ({len(train_ds)} batches, "
               f"{loader}), {test}")
    return train_ds, test_ds, src_tok, tgt_tok


def model_config(args: argparse.Namespace, vocab: int, input_vocab: int | None = None):
    """The model of the flags: ``vocab`` target ids, and ``input_vocab``
    source ids (default ``vocab``); ``max_position`` is
    ``max(sequence_length, 64)``, as the JAX CLI sets it. ``--objective
    mlm`` makes it encoder-only, with one id space one larger than the
    tokenizer's: the top id is [MASK]."""
    from transformer_tpu_torch.config import ModelConfig

    input_vocab = vocab if input_vocab is None else input_vocab
    if args.objective == "mlm":
        input_vocab += 1
        vocab = input_vocab
    return ModelConfig(
        num_layers=args.num_layers, d_model=args.d_model, num_heads=args.num_heads,
        num_kv_heads=args.num_kv_heads, dff=args.dff,
        input_vocab_size=input_vocab,
        target_vocab_size=vocab, dropout_rate=args.dropout_rate,
        max_position=max(args.sequence_length, 64), norm_scheme=args.norm_scheme,
        position_scheme=args.position_scheme, decoder_only=args.decoder_only,
        encoder_only=args.objective == "mlm", tie_embeddings=args.tie_embeddings,
        tie_output=args.tie_output,
        ffn_activation=args.ffn_activation, dtype=args.dtype,
        attention_impl=args.attention_impl, attention_window=args.attention_window,
        remat=args.remat, remat_policy=args.remat_policy,
    )


def load_for_model(args: argparse.Namespace, train_cfg, log_fn=print):
    """(train, test, model config, tokenizers) of the flags: LM windows and
    (tok,) with ``--decoder_only`` or ``--objective mlm``, else sentence
    pairs and (src tok, tgt tok)."""
    if lm_mode(args):
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
    or a masked LM reports its eval loss and writes the export; a seq2seq
    model first translates a sample sentence, and after the export scores
    BLEU on the first ``--bleu_limit`` test pairs (``--eval_bleu``)."""
    if lm_mode(args):
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
    trainer, whose ``train_ds`` is the train split it fit (the native
    loader's counts, a streaming split's buffer marks)."""
    args = resolve_flags(argv)
    from transformer_tpu_torch.device import resolve_device
    from transformer_tpu_torch.train.state import create_train_state
    from transformer_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    train_cfg = train_config(args)
    train_ds, test_ds, model_cfg, toks = load_for_model(args, train_cfg, log_fn)
    state = create_train_state(model_cfg, train_cfg, device=device)
    telemetry = flags_to_telemetry(args, log_fn)
    trainer = Trainer(model_cfg, train_cfg, state, log_fn=log_fn,
                      checkpoint=checkpoint_manager(args, train_cfg),
                      log_dir=os.path.join(args.tb_log_dir, run_stamp()),
                      profiler=flags_to_profiler(args), telemetry=telemetry)
    trainer.train_ds = train_ds
    trainer.fit(train_ds, test_ds)
    if telemetry is not None:
        telemetry.close()
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
