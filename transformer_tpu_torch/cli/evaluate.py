"""Score an export: corpus BLEU (seq2seq) or perplexity (LM).

    python -m transformer_tpu_torch.cli.evaluate --export_path=model \\
        --src_file=data/src-test.txt --tgt_file=data/tgt-test.txt \\
        --src_vocab_file=src_vocab.subwords --tgt_vocab_file=tgt_vocab.subwords \\
        [--limit=200] [--beam=1] [--device=cuda]

Port of ``transformer_tpu/cli/evaluate.py``. Prints one JSON line on
stdout: ``{"bleu": ..., "n": ..., "beam": ...}`` for a seq2seq export, or
``{"perplexity": ..., "n_tokens": ...}`` for a decoder-only export (scored
on ``--tgt_file``; the source flags are unused). Progress goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys

from transformer_tpu_torch.cli.translate import add_export_flags, export_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_export_flags(ap)
    ap.add_argument("--src_file", default="data/src-test.txt",
                    help="source sentences, one per line")
    ap.add_argument("--tgt_file", default="data/tgt-test.txt",
                    help="reference translations (or LM text)")
    ap.add_argument("--batch_size", type=int, default=64, help="decode batch size")
    ap.add_argument("--limit", type=int, default=0,
                    help="evaluate only the first N lines (0 = all)")
    return ap


def main(argv: list[str] | None = None, stdout=None) -> dict:
    """Score and print the JSON line; returns it as a dict."""
    args = build_parser().parse_args(argv)
    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
    from transformer_tpu_torch.device import resolve_device
    from transformer_tpu_torch.train.evaluate import (
        bleu_on_pairs,
        perplexity_on_lines,
        read_lines,
    )

    device = resolve_device(export_device(args))
    params, cfg = load_export(args.export_path, kv_cache_int8=args.kv_cache_int8, device=device)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr)

    if cfg.decoder_only:
        lines = read_lines(args.tgt_file)
        if args.limit:
            lines = lines[: args.limit]
        ppl, n_tokens = perplexity_on_lines(
            params, cfg, SubwordTokenizer.load(args.tgt_vocab_file), lines,
            batch_size=args.batch_size, log_fn=log,
        )
        result = {"perplexity": round(ppl, 3), "n_tokens": n_tokens}
    else:
        src_lines, ref_lines = read_lines(args.src_file), read_lines(args.tgt_file)
        if args.limit:
            src_lines, ref_lines = src_lines[: args.limit], ref_lines[: args.limit]
        bleu, _ = bleu_on_pairs(
            params, cfg, SubwordTokenizer.load(args.src_vocab_file),
            SubwordTokenizer.load(args.tgt_vocab_file), src_lines, ref_lines,
            batch_size=args.batch_size, max_len=args.max_len, beam_size=args.beam,
            log_fn=log,
        )
        result = {"bleu": round(bleu, 2), "n": len(src_lines), "beam": args.beam}
    print(json.dumps(result), file=stdout or sys.stdout, flush=True)
    return result


def run() -> int:
    """Console-script entry point: score, then exit with status 0."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(run())
