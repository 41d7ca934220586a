"""Serving loop: JSONL LM requests on stdin, JSONL answers on stdout.

    python -m transformer_tpu_torch.cli.serve --export_path=model \
        --tgt_vocab_file=tgt.subwords --serve_slots=4 --prefix_block=16 \
        --prefill_chunk=64 [--device=cuda]

Each input line is ``{"prompt": ..., "max_new": N, "temperature": T,
"top_k": K, "top_p": P, "seed": S}`` (all but ``prompt`` optional) or a raw
line, taken as the prompt. One answer line per request, in request order:
``{"continuation": ...}`` or ``{"error": ..., "code": ...}``; a malformed
line answers an error and never stops the loop.

Port of ``transformer_tpu/cli/serve.py``'s continuous-batching path with
``--kv_layout paged --decode_kernel paged_flash``: a decoder-only export
(``params.npz`` + ``config.json``, the JAX export layout) served by the
paged-KV scheduler on the CUDA kernels. Flags keep the JAX CLI's names;
argparse replaces absl.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--export_path", default="model",
                    help="directory holding params.npz and config.json")
    ap.add_argument("--tgt_vocab_file", default="tgt_vocab.subwords",
                    help="target subword vocab file")
    ap.add_argument("--serve_slots", type=int, default=8,
                    help="KV-cache slots for continuous batching")
    ap.add_argument("--serve_max_total", type=int, default=0,
                    help="per-slot KV budget (prompt + generated tokens); "
                         "0 = the model's max_position + 1")
    ap.add_argument("--prefill_chunk", type=int, default=0,
                    help="prefill prompts in chunks of this many tokens "
                         "(0 = one forward)")
    ap.add_argument("--prefix_block", type=int, default=16,
                    help="KV pool block size in tokens")
    ap.add_argument("--kv_pool_blocks", type=int, default=0,
                    help="KV pool size in blocks (0 = every slot can reach "
                         "--serve_max_total)")
    ap.add_argument("--kv_cache_int8", action="store_true",
                    help="store the KV pool as int8 codes with fp32 scales")
    ap.add_argument("--max_len", type=int, default=64,
                    help="default max generated tokens per request")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


class _RoutingError(ValueError):
    """A request for another export kind: answered with the bare message."""


def _route_lm_request(line: str) -> dict:
    """One stdin line -> LM request dict (raises on malformed input), with
    the JAX CLI's key precedence and messages."""
    if line.startswith("{"):
        req = json.loads(line)
        if not isinstance(req, dict):
            raise ValueError("request must be a JSON object")
    else:
        req = {"prompt": line}
    if "src" in req:
        raise _RoutingError("LM export serves 'prompt', not 'src'")
    if "prompt" not in req:
        if "fill" in req:
            raise _RoutingError("LM export serves 'prompt', not 'fill'")
        raise _RoutingError(
            "request needs 'src' (seq2seq), 'prompt' (LM) or "
            "'fill' (masked-LM)"
        )
    return req


def _reader(stream, q: queue.Queue) -> None:
    for line in stream:
        q.put(line)
    q.put(None)


def serve_continuous(q: queue.Queue, sched, out) -> None:
    """Drive the scheduler from the line queue: take whatever is queued,
    admit into free slots, step every occupied slot, write the answers
    that are complete in request order. Blocks on input only when nothing
    is in flight and nothing waits to be written."""
    eof = False
    backlog_cap = max(1, sched.num_slots) * 8
    while not eof or sched.busy:
        while not eof and sched.backlog + sched.ready_count < backlog_cap:
            try:
                line = q.get(block=not (sched.busy or sched.has_ready))
            except queue.Empty:
                break
            if line is None:
                eof = True
                break
            line = line.strip()
            if not line:
                continue
            try:
                req = _route_lm_request(line)
            except _RoutingError as e:
                sched.submit_done({"error": str(e), "code": "routing"})
                continue
            except Exception as e:  # noqa: BLE001 — a bad line answers, never kills the loop
                sched.submit_done(
                    {"error": f"{type(e).__name__}: {e}", "code": "validation"}
                )
                continue
            sched.submit(req)
        sched.admit()
        sched.step()
        for resp in sched.drain_ready():
            print(json.dumps(resp), file=out, flush=True)


def main(argv: list[str] | None = None, stdin=None, stdout=None):
    """Serve until stdin ends; returns the scheduler (for its stats)."""
    args = build_parser().parse_args(argv)
    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
    from transformer_tpu_torch.device import resolve_device
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    device = resolve_device(args.device)
    params, cfg = load_export(
        args.export_path, kv_cache_int8=args.kv_cache_int8, device=device
    )
    if not cfg.decoder_only:
        raise SystemExit("the port serves decoder-only LM exports only")
    if args.serve_slots < 1:
        raise SystemExit("--serve_slots must be >= 1 (continuous batching)")
    tok = SubwordTokenizer.load(args.tgt_vocab_file)
    sched = ContinuousScheduler(
        params, cfg, tok,
        num_slots=args.serve_slots,
        max_total=args.serve_max_total or None,
        prefill_chunk=args.prefill_chunk,
        default_max_new=args.max_len,
        kv_block=args.prefix_block,
        kv_pool_blocks=args.kv_pool_blocks,
        device=device,
    )
    q: queue.Queue = queue.Queue(maxsize=max(1, args.serve_slots) * 8)
    reader = threading.Thread(
        target=_reader, args=(stdin or sys.stdin, q), daemon=True
    )
    reader.start()
    serve_continuous(q, sched, stdout or sys.stdout)
    reader.join(timeout=5.0)
    return sched


def run() -> int:
    """Console-script entry point: serve, then exit with status 0."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(run())
