"""Load a decoder-only export and continue prompts.

    python -m transformer_tpu_torch.cli.generate --export_path=model \\
        --vocab_file=tgt_vocab.subwords [--prompts="der Mann;die Frau"] \\
        [--max_new=64] [--temperature=0.8 --top_k=40 --top_p=0.95 --seed=0] \\
        [--kv_cache_int8] [--device=cuda]

Port of ``transformer_tpu/cli/generate.py``: prompts come from
``--prompts`` (``;``-separated) or one per stdin line; ``generate`` runs
them as one bucketed batch over dense KV caches (greedy by default,
sampled at a temperature above 0) and one continuation is printed per
line. A seq2seq export is refused (``cli.translate`` serves it). Flags keep
the JAX CLI's names; argparse replaces absl.
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["build_parser", "main", "run"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--export_path", default="model",
                    help="directory holding params.npz and config.json")
    ap.add_argument("--vocab_file", default="tgt_vocab.subwords", help="subword vocab path")
    ap.add_argument("--prompts", default="",
                    help="';'-separated prompts (default: stdin lines)")
    ap.add_argument("--max_new", type=int, default=64, help="max generated tokens per prompt")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top_k", type=int, default=0,
                    help="top-k truncation for sampling (0 = off)")
    ap.add_argument("--top_p", type=float, default=1.0,
                    help="nucleus (top-p) truncation for sampling (1 = off)")
    ap.add_argument("--seed", type=int, default=0, help="sampling seed")
    ap.add_argument("--kv_cache_int8", action="store_true",
                    help="decode with an int8 KV cache (codes with fp32 scales)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: list[str] | None = None, stdin=None, stdout=None) -> list[str]:
    """Generate and print; returns the continuations."""
    args = build_parser().parse_args(argv)
    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
    from transformer_tpu_torch.device import resolve_device
    from transformer_tpu_torch.train.decode import generate

    device = resolve_device(args.device)
    params, cfg = load_export(args.export_path, kv_cache_int8=args.kv_cache_int8, device=device)
    if not cfg.decoder_only:
        raise SystemExit("the export is a seq2seq model; use cli.translate instead")
    tok = SubwordTokenizer.load(args.vocab_file)
    if args.prompts:
        prompts = [p.strip() for p in args.prompts.split(";") if p.strip()]
    else:
        prompts = [line.strip() for line in (stdin or sys.stdin) if line.strip()]
    if not prompts:
        print("no input prompts", file=sys.stderr)
        return []
    outputs = generate(
        params, cfg, tok, prompts, max_new=args.max_new, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p, seed=args.seed,
    )
    out = stdout or sys.stdout
    for text in outputs:
        print(text, file=out)
    return outputs


def run() -> int:
    """Console-script entry point: generate, then exit with status 0."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(run())
