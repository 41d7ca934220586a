"""Load a seq2seq export and translate text.

    python -m transformer_tpu_torch.cli.translate --export_path=model \\
        --src_vocab_file=src_vocab.subwords --tgt_vocab_file=tgt_vocab.subwords \\
        [--sentences="he go to school"] [--beam=4] [--device=cuda]

Port of ``transformer_tpu/cli/translate.py``: the export directory
(``params.npz`` + ``config.json``, either package's) is loaded without the
training stack and driven end to end: tokenize, greedy or beam decode,
detokenize. Sentences come from ``--sentences`` (``;``-separated) or one
per stdin line; one translation is printed per line. ``--attention_out
maps.npz`` then writes each (sentence, translation) pair's attention maps
(``train/evaluate.py`` ``dump_attention_maps``, the JAX keys).
``--platform`` (``cpu``, ``gpu``) is the JAX CLI's device switch.
"""

from __future__ import annotations

import argparse
import sys

from transformer_tpu_torch.cli.train import _PLATFORMS, add_bool_flag
from transformer_tpu_torch.convert import load_export

__all__ = ["build_parser", "export_device", "load_export", "main", "run"]


def add_export_flags(ap: argparse.ArgumentParser) -> None:
    """The flags every export-consuming CLI of the port shares."""
    ap.add_argument("--export_path", default="model",
                    help="directory holding params.npz and config.json")
    ap.add_argument("--src_vocab_file", default="src_vocab.subwords",
                    help="source subword vocab file")
    ap.add_argument("--tgt_vocab_file", default="tgt_vocab.subwords",
                    help="target subword vocab file")
    ap.add_argument("--max_len", type=int, default=64,
                    help="max generated tokens per sentence")
    ap.add_argument("--beam", type=int, default=1, help="beam size (1 = greedy)")
    add_bool_flag(ap, "kv_cache_int8", False,
                  "decode with an int8 KV cache (codes with fp32 scales)")
    ap.add_argument("--platform", default="",
                    help="'cpu' runs on the CPU, 'gpu' or 'cuda' on the card (must agree "
                         "with --device when both are given); '' = --device")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")


def export_device(args: argparse.Namespace) -> str:
    """The device of an export-consuming CLI: ``--device``, else the one
    ``--platform`` names, else ``cuda``; a ``--platform`` the port cannot
    run on, or one that disagrees with ``--device``, is refused."""
    if not args.platform:
        return args.device or "cuda"
    device = _PLATFORMS.get(args.platform.lower())
    if device is None:
        raise SystemExit(f"--platform {args.platform!r}: the port runs on 'cpu' or on the "
                         "card ('gpu' or 'cuda')")
    if args.device is not None and args.device.split(":")[0] != device:
        raise SystemExit(f"--platform {args.platform!r} conflicts with --device "
                         f"{args.device!r}")
    return args.device or device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_export_flags(ap)
    ap.add_argument("--sentences", default="",
                    help="';'-separated sentences (default: stdin lines)")
    ap.add_argument("--attention_out", default="",
                    help="dump per-layer attention maps to this .npz: a teacher-forced "
                         "forward over (source, translation) saves encoder self-attention "
                         "and decoder self/cross maps per sentence (the reference's "
                         "attention_weights; '' = off)")
    return ap


def main(argv: list[str] | None = None, stdin=None, stdout=None) -> list[str]:
    """Translate and print; returns the translations."""
    args = build_parser().parse_args(argv)
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
    from transformer_tpu_torch.device import resolve_device
    from transformer_tpu_torch.train.decode import translate

    device = resolve_device(export_device(args))
    params, cfg = load_export(args.export_path, kv_cache_int8=args.kv_cache_int8, device=device)
    src_tok = SubwordTokenizer.load(args.src_vocab_file)
    tgt_tok = SubwordTokenizer.load(args.tgt_vocab_file)
    if args.sentences:
        sentences = [s.strip() for s in args.sentences.split(";") if s.strip()]
    else:
        sentences = [line.strip() for line in (stdin or sys.stdin) if line.strip()]
    if not sentences:
        print("no input sentences", file=sys.stderr)
        return []
    outputs = translate(params, cfg, src_tok, tgt_tok, sentences, max_len=args.max_len,
                        beam_size=args.beam)
    out = stdout or sys.stdout
    for text in outputs:
        print(text, file=out)
    if args.attention_out:
        from transformer_tpu_torch.train.evaluate import dump_attention_maps

        n = dump_attention_maps(params, cfg, src_tok, tgt_tok, sentences, outputs,
                                args.attention_out)
        print(f"wrote {n} attention maps to {args.attention_out}", file=sys.stderr)
    return outputs


def run() -> int:
    """Console-script entry point: translate, then exit with status 0."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(run())
