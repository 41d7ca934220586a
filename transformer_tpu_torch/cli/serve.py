"""Serving loop: JSONL requests on stdin, JSONL answers on stdout.

    python -m transformer_tpu_torch.cli.serve --export_path=model \
        --src_vocab_file=src.subwords --tgt_vocab_file=tgt.subwords \
        [--serve_batch=8] [--beam=1] [--device=cuda]            # seq2seq
    python -m transformer_tpu_torch.cli.serve --export_path=model \
        --tgt_vocab_file=tgt.subwords --serve_slots=4 --prefix_block=16 \
        --prefill_chunk=64 [--kv_layout=dense|paged] \
        [--decode_kernel=xla|paged_flash] [--speculate_k=4 \
        [--draft_checkpoint=draft]] [--prefix_cache_mb=256] \
        [--max_backlog=0] [--fault_spec=...] [--device=cuda]     # LM

Each input line is a JSON object or a raw line:

    {"src": "he goes to school"}            seq2seq translation
    {"src": "...", "beam": 4, "max_len": 32}
    {"prompt": "...", "max_new": 32}        decoder-only LM continuation
                                            (+ temperature, top_k, top_p,
                                            seed, deadline_ms, cache_prefix,
                                            speculate)
    {"fill": "the [MASK] house", "top_k": 5}  masked-LM fill (encoder-only)
    he goes to school                       raw line: the export's kind

One answer line per request, in request order: ``{"translation": ...}``,
``{"continuation": ...}``, ``{"filled": ..., "candidates": [[[token,
prob], ...], ...]}`` or ``{"error": ...}``; a malformed line answers an
error and never stops the loop.

Port of ``transformer_tpu/cli/serve.py``. Seq2seq and encoder-only
(masked-LM) exports, and LM exports at ``--serve_slots 0``, take the
grouped path: a reader thread queues
stdin lines; each round drains up to ``--serve_batch`` lines already
queued (it never waits for more), groups them by decode signature (kind,
max_len and beam, the sampling parameters, or a fill's top_k) and runs
ONE ``translate``, ``generate`` or ``fill_mask`` per group
(``serve_lines``). Its errors carry no ``code``.
LM exports at ``--serve_slots`` > 0 take the continuous path
(``serve/scheduler.py``) on the layout ``--kv_layout`` and
``--decode_kernel`` name, with the JAX CLI's defaults: the dense slot
pool (``dense``, the only layout that serves an ``attention_window``
model, through rolling caches), the paged pool through gathered views
(``paged`` + ``xla``), or the paged pool read in place by the CUDA
kernels (``paged`` + ``paged_flash``); with speculative decoding
(``--speculate_k``, ``--draft_checkpoint``, ``--draft_ngram``), the
prefix cache (``--prefix_cache_mb``, ``--prefix_verify_checksums``),
admission retries (``--admission_retries``), circuit breakers
(``--breaker_threshold``, ``--breaker_cooldown``), fault injection
(``--fault_spec``, armed before the scheduler is built), deadlines and
cancellation (``deadline_ms``; ``ContinuousScheduler.cancel``) and
backpressure (``--max_backlog``); its errors carry a ``code``. Flags keep
the JAX CLI's names; argparse replaces absl.

Telemetry, as the JAX server's: ``--metrics_jsonl PATH`` streams a
``serve.request`` event per answer (a ``serve.batch`` per grouped
batch), periodic ``metrics.snapshot`` events and ``PATH.prom``;
``--trace`` adds each request's span tree; ``--profile_programs`` the
``perf_seconds_serve_*`` streams; ``--flight_recorder`` the
``PATH.flight.json`` dumps; ``--metrics_port`` the ``/metrics`` endpoint.
With telemetry on, ``--slo_spec`` ('' = ``obs.slo.DEFAULT_SLOS``,
``none`` = off) evaluates burn rates over the answers
(``serve_slo_burn_*`` gauges, ``slo.burn`` events). ``python -m
transformer_tpu_torch.obs summarize PATH`` reads them.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time

from transformer_tpu_torch.cli.train import METRICS_FLAGS, _bool, add_bool_flag, flags_to_telemetry
from transformer_tpu_torch.cli.translate import add_export_flags, export_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_export_flags(ap)
    ap.add_argument("--serve_batch", type=int, default=8,
                    help="max already-queued requests aggregated into one decode "
                         "(grouped by decode signature) on the grouped path")
    ap.add_argument("--serve_slots", type=int, default=8,
                    help="KV-cache slots for continuous batching of LM requests; "
                         "0 = the grouped path (--serve_batch). Seq2seq exports "
                         "always take the grouped path")
    ap.add_argument("--serve_max_total", type=int, default=0,
                    help="per-slot KV budget (prompt + generated tokens); "
                         "0 = the model's max_position + 1")
    ap.add_argument("--prefill_chunk", type=int, default=0,
                    help="prefill prompts in chunks of this many tokens "
                         "(0 = one forward); also the grouped path's generate()")
    ap.add_argument("--speculate_k", type=int, default=0,
                    help="speculative decoding lookahead: a drafter proposes up to "
                         "this many tokens per step and one verify forward scores "
                         "them all (greedy answers unchanged; sampled requests use "
                         "rejection-sampling acceptance); 0 = off")
    ap.add_argument("--draft_checkpoint", default="",
                    help="export directory of a small draft model sharing the "
                         "target tokenizer ('' = the model-free n-gram drafter)")
    ap.add_argument("--draft_ngram", type=int, default=3,
                    help="longest suffix n-gram the model-free drafter matches "
                         "against earlier context (without --draft_checkpoint)")
    ap.add_argument("--prefix_cache_mb", type=int, default=0,
                    help="host-memory budget (MiB) of the cross-request prefix KV "
                         "cache: prompt KV kept as block-aligned blocks in a radix "
                         "trie, restored instead of forwarded again (greedy answers "
                         "unchanged); 0 = off")
    ap.add_argument("--prefix_block", type=int, default=16,
                    help="KV pool block size in tokens, and the prefix cache's "
                         "matching granularity")
    add_bool_flag(ap, "prefix_verify_checksums", True,
                  "re-verify each matched prefix-cache block's crc32 at admission (a "
                  "corrupt block is dropped, not restored)")
    ap.add_argument("--kv_layout", choices=("dense", "paged"), default="dense",
                    help="per-slot KV storage of the continuous path: 'dense' "
                         "reserves max_total rows per slot (the reference layout, "
                         "and the only one serving attention_window models through "
                         "rolling caches); 'paged' backs every slot from ONE block "
                         "pool through per-slot block tables (resident KV "
                         "proportional to used tokens, prefix-cache hits restored "
                         "by block-table aliasing), answers byte-identical")
    ap.add_argument("--kv_pool_blocks", type=int, default=0,
                    help="paged KV pool size in blocks of --prefix_block tokens "
                         "(0 = every slot can reach --serve_max_total)")
    ap.add_argument("--decode_kernel", choices=("xla", "paged_flash"), default="xla",
                    help="decode/verify forward of the paged layout: 'xla' gathers "
                         "a dense view of each slot's KV through the block table "
                         "(plain torch ops: the bitwise parity reference); "
                         "'paged_flash' runs the CUDA kernels that read pool blocks "
                         "in place plus the fused residual+LN+FFN kernel (requires "
                         "--kv_layout paged and no attention_window)")
    ap.add_argument("--max_backlog", type=int, default=0,
                    help="bounded admission backpressure on the continuous path: "
                         "submissions beyond this many queued requests answer a "
                         "'backpressure' error at once (0 = unbounded)")
    ap.add_argument("--admission_retries", type=int, default=2,
                    help="bounded retries (with jittered exponential backoff) when "
                         "the KV pool is exhausted at admission; exhausted retries "
                         "answer a structured 'transient' error")
    ap.add_argument("--breaker_threshold", type=int, default=3,
                    help="consecutive faults before a serving circuit breaker "
                         "(speculative decoding / prefix cache) fails its subsystem "
                         "open to the plain byte-parity path")
    ap.add_argument("--breaker_cooldown", type=float, default=30.0,
                    help="seconds an open circuit breaker waits before one "
                         "half-open re-probe of its subsystem")
    ap.add_argument("--fault_spec", default="",
                    help="deterministic fault injection for chaos drills, e.g. "
                         "'serve.prefill:p=0.25,seed=7;draft.slow:every=3,ms=40' "
                         "(serve/resilience.py grammar); '' = disarmed")
    add_metrics_flags(ap)
    ap.add_argument("--slo_spec", default="",
                    help="SLO objectives evaluated as multi-window burn rates over the answer "
                         "stream, e.g. 'availability:objective=0.999;ttft_p95:threshold=0.5'. "
                         "'' = the default objectives when telemetry is on; 'none' = off. "
                         "Surfaced as serve_slo_burn_* gauges + slo.burn events; report "
                         "offline with `python -m transformer_tpu_torch.obs slo <jsonl>`")
    return ap


def add_metrics_flags(ap: argparse.ArgumentParser) -> None:
    """The JAX CLIs' telemetry flags (``cli.train``'s ``METRICS_FLAGS``)."""
    for name, (typ, default, help_) in METRICS_FLAGS.items():
        if typ is _bool:
            add_bool_flag(ap, name, default, help_)
        else:
            ap.add_argument(f"--{name}", type=typ, default=default, help=help_)


def slos_for(args: argparse.Namespace, telemetry):
    """The scheduler's ``slos``: the spec given, or with telemetry on the
    default objectives ('none' parses to no objective)."""
    from transformer_tpu_torch.obs.slo import DEFAULT_SLOS

    return args.slo_spec or (DEFAULT_SLOS if telemetry else None)


class _RoutingError(ValueError):
    """A request for another export kind: answered with the bare message."""


def _parse_line(line: str, model_cfg) -> dict:
    """One stdin line -> request dict (raises on malformed input). A raw
    line is the request kind the export serves."""
    if line.startswith("{"):
        req = json.loads(line)
        if not isinstance(req, dict):
            raise ValueError("request must be a JSON object")
        return req
    if model_cfg.encoder_only:
        return {"fill": line}
    return {"prompt" if model_cfg.decoder_only else "src": line}


def _signature(req: dict, model_cfg, default_max_len: int, default_beam: int) -> tuple | None:
    """The grouping key: requests of one group run as ONE decode call.
    None = a kind mismatch (answered alone with the routing message).
    A stray 'fill' key beside 'src' or 'prompt' is ignored by the other
    kinds' exports."""
    if model_cfg.encoder_only:
        if "fill" not in req:
            return None
        top_k = int(req.get("top_k", 5))
        if not 1 <= top_k <= 100:
            # Raised, so this request answers with the message.
            raise ValueError(f"top_k must be in [1, 100], got {top_k}")
        return ("fill", top_k)
    if "src" in req:
        if model_cfg.decoder_only:
            return None
        return ("src", int(req.get("max_len", default_max_len)),
                int(req.get("beam", default_beam)))
    if "prompt" in req:
        if not model_cfg.decoder_only:
            return None
        temperature = float(req.get("temperature", 0.0))
        return (
            "prompt",
            int(req.get("max_new", default_max_len)),
            temperature,
            int(req.get("top_k", 0)),
            float(req.get("top_p", 1.0)),
            # One generate() call draws from one seed, so the seed of a
            # sampled request is part of its key; greedy never draws.
            int(req.get("seed", 0)) if temperature > 0.0 else 0,
        )
    return None


def serve_lines(
    lines: list[str], params, model_cfg, src_tok, tgt_tok,
    default_max_len: int = 64, default_beam: int = 1,
    prefill_chunk: int = 0,
) -> list[dict]:
    """Answer a batch of request lines with one decode per signature
    group, in input order: ``fill_mask`` for ``fill`` groups (the answers'
    candidates as lists), ``translate`` for ``src`` groups, ``generate``
    for ``prompt`` groups (a sampled request alone, so its draws do not
    depend on its neighbours and equal the continuous scheduler's). A
    malformed line answers ``{"error": "<Type>: <msg>"}``, a kind mismatch
    the bare routing message; a group that fails is retried member by
    member so one bad request answers alone. No ``code`` key: that is the
    continuous path's."""
    from transformer_tpu_torch.train import decode

    responses: list[dict | None] = [None] * len(lines)
    groups: dict[tuple, list[tuple[int, dict]]] = {}
    kind = ("fill-mask" if model_cfg.encoder_only
            else "LM" if model_cfg.decoder_only else "seq2seq")
    served_key = {"fill-mask": "fill", "LM": "prompt", "seq2seq": "src"}[kind]
    for i, line in enumerate(lines):
        try:
            req = _parse_line(line, model_cfg)
            sig = _signature(req, model_cfg, default_max_len, default_beam)
        except Exception as e:  # noqa: BLE001 — a bad line answers, never kills the loop
            responses[i] = {"error": f"{type(e).__name__}: {e}"}
            continue
        if sig is not None and sig[0] == "prompt" and sig[2] > 0.0:
            sig = (*sig, i)  # sampled: batch 1
        if sig is None:
            sent = next((k for k in ("src", "prompt", "fill") if k in req), None)
            if sent:
                msg = f"{kind} export serves '{served_key}', not '{sent}'"
            else:
                msg = ("request needs 'src' (seq2seq), 'prompt' (LM) or "
                       "'fill' (masked-LM)")
            responses[i] = {"error": msg}
            continue
        groups.setdefault(sig, []).append((i, req))

    def run_group(sig, members) -> list[dict]:
        if sig[0] == "fill":
            outs = decode.fill_mask(params, model_cfg, tgt_tok,
                                    [str(req["fill"]) for _, req in members], top_k=sig[1])
            return [{"filled": o["filled"],
                     "candidates": [[[t, p] for t, p in cands] for cands in o["candidates"]]}
                    for o in outs]
        if sig[0] == "src":
            _, max_len, beam = sig
            outs = decode.translate(
                params, model_cfg, src_tok, tgt_tok,
                [str(req["src"]) for _, req in members], max_len=max_len, beam_size=beam,
            )
            return [{"translation": out} for out in outs]
        _, max_new, temperature, top_k, top_p, seed = sig[:6]
        outs = decode.generate(
            params, model_cfg, tgt_tok, [str(req["prompt"]) for _, req in members],
            max_new=max_new, temperature=temperature, top_k=top_k, top_p=top_p,
            seed=seed, prefill_chunk=prefill_chunk,
        )
        return [{"continuation": out} for out in outs]

    for sig, members in groups.items():
        try:
            outs = run_group(sig, members)
        except Exception:  # noqa: BLE001 — retried member by member below
            outs = []
            for member in members:
                try:
                    outs.extend(run_group(sig, [member]))
                except Exception as e:  # noqa: BLE001 — answers, never kills the loop
                    outs.append({"error": f"{type(e).__name__}: {e}"})
        for (i, _), out in zip(members, outs):
            responses[i] = out
    return [r if r is not None else {"error": "internal: unanswered"} for r in responses]


def _route_lm_request(line: str, model_cfg) -> dict:
    """One stdin line -> LM request dict for the continuous scheduler
    (raises on malformed input), with ``_signature``'s key precedence and
    ``serve_lines``' messages."""
    req = _parse_line(line, model_cfg)
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


def serve_continuous(q: queue.Queue, sched, out, telemetry=None) -> None:
    """Drive the scheduler from the line queue: take whatever is queued,
    admit into free slots, step every occupied slot, write the answers
    that are complete in request order. Blocks on input only when nothing
    is in flight and nothing waits to be written. Flushes ``telemetry``'s
    sinks at the end."""
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
                req = _route_lm_request(line, sched.cfg)
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
    if telemetry is not None:
        telemetry.maybe_flush(force=True)


def serve_grouped(q: queue.Queue, params, cfg, src_tok, tgt_tok, args, out,
                  telemetry=None) -> list[dict]:
    """The grouped loop: wait for one line, drain up to ``serve_batch`` that
    are already queued, answer them with ``serve_lines`` and write the
    answers. Returns one record per drained batch (size, errors, seconds);
    with ``telemetry``, each batch is also a ``serve.batch`` event and a
    ``serve_batch_seconds`` sample."""
    batches = []
    eof = False
    while not eof:
        first = q.get()
        if first is None:
            break
        lines = [first]
        while len(lines) < max(1, args.serve_batch):
            try:
                nxt = q.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                eof = True
                break
            lines.append(nxt)
        lines = [line.strip() for line in lines]
        lines = [line for line in lines if line]
        if not lines:
            continue
        t0 = time.perf_counter()
        responses = serve_lines(
            lines, params, cfg, src_tok, tgt_tok, default_max_len=args.max_len,
            default_beam=args.beam, prefill_chunk=args.prefill_chunk,
        )
        batch_s = time.perf_counter() - t0
        errors = sum(1 for r in responses if "error" in r)
        batches.append({"size": len(responses), "errors": errors, "seconds": batch_s})
        if telemetry is not None:
            reg = telemetry.registry
            reg.counter("serve_requests_total").inc(len(responses))
            if errors:
                reg.counter("serve_errors_total").inc(errors)
            reg.histogram("serve_batch_seconds", "one grouped decode batch").observe(batch_s)
            telemetry.emit("serve.batch", size=len(responses), errors=errors,
                           batch_s=round(batch_s, 6))
            telemetry.maybe_flush()
        for resp in responses:
            print(json.dumps(resp), file=out, flush=True)
    return batches


def build_scheduler(args: argparse.Namespace, loaded=None, breaker_clock=time.monotonic,
                    telemetry=None):
    """The continuous scheduler the flags describe: the export on the
    device, the drafter (``--speculate_k``) and the prefix cache
    (``--prefix_cache_mb``). ``loaded`` = (params, cfg, tokenizer, device)
    when the caller has them already; ``breaker_clock`` is the breakers'
    clock (a test clock makes their cooldowns deterministic); ``telemetry``
    the ``obs.Telemetry`` it records into (with ``slos_for``'s SLOs)."""
    from transformer_tpu_torch.serve.prefix_cache import PrefixCache
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler
    from transformer_tpu_torch.serve.speculative import drafter_from_flags

    params, cfg, tok, device = loaded or _load(args)
    if not cfg.decoder_only:
        raise SystemExit("continuous batching serves decoder-only LM exports; "
                         "seq2seq exports take the grouped path")
    if args.serve_slots < 1:
        raise SystemExit("--serve_slots must be >= 1 (continuous batching)")
    drafter = None
    if args.speculate_k > 0:
        drafter = drafter_from_flags(
            args.draft_checkpoint, args.draft_ngram,
            args.serve_max_total or cfg.max_position + 1,
            eos_id=tok.eos_id, target_vocab_size=cfg.target_vocab_size, device=device,
        )
    prefix_cache = None
    if args.prefix_cache_mb > 0:
        prefix_cache = PrefixCache(
            cfg, block_tokens=args.prefix_block, budget_mb=args.prefix_cache_mb,
            verify_checksums=args.prefix_verify_checksums,
        )
    return ContinuousScheduler(
        params, cfg, tok,
        num_slots=args.serve_slots,
        max_total=args.serve_max_total or None,
        prefill_chunk=args.prefill_chunk,
        default_max_new=args.max_len,
        speculate_k=args.speculate_k,
        drafter=drafter,
        prefix_cache=prefix_cache,
        kv_layout=args.kv_layout,
        kv_block=args.prefix_block,
        kv_pool_blocks=args.kv_pool_blocks,
        decode_kernel=args.decode_kernel,
        admission_retries=args.admission_retries,
        max_backlog=args.max_backlog,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown,
        breaker_clock=breaker_clock,
        telemetry=telemetry,
        slos=slos_for(args, telemetry),
        device=device,
    )


def _load(args: argparse.Namespace):
    """(params, cfg, target tokenizer, device) of the export."""
    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
    from transformer_tpu_torch.device import resolve_device

    device = resolve_device(export_device(args))
    params, cfg = load_export(args.export_path, kv_cache_int8=args.kv_cache_int8, device=device)
    return params, cfg, SubwordTokenizer.load(args.tgt_vocab_file), device


def main(argv: list[str] | None = None, stdin=None, stdout=None):
    """Serve until stdin ends. Returns the scheduler on the continuous
    path (for its stats), else the grouped loop's batch records."""
    args = build_parser().parse_args(argv)
    if not args.fault_spec:
        return _serve(args, stdin, stdout)
    from transformer_tpu_torch.serve import resilience

    # Armed before any subsystem starts (the points fire per (seed, point,
    # call index), so a drill replays exactly), disarmed when serving ends.
    with resilience.active(resilience.FaultPlane.parse(args.fault_spec)):
        print(f"fault plane armed: {args.fault_spec}", file=sys.stderr)
        return _serve(args, stdin, stdout)


def _serve(args: argparse.Namespace, stdin, stdout):
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer

    params, cfg, tgt_tok, device = _load(args)
    telemetry = flags_to_telemetry(args, lambda msg: print(msg, file=sys.stderr))
    if args.slo_spec and args.slo_spec.lower() not in ("none", "off") and telemetry is None:
        # The engine's whole output is gauges and slo.burn events.
        print("--slo_spec needs --metrics_jsonl (or --metrics_port) to surface burn rates; "
              "SLO evaluation disabled for this run", file=sys.stderr)
    continuous = cfg.decoder_only and args.serve_slots > 0
    sched = (build_scheduler(args, (params, cfg, tgt_tok, device), telemetry=telemetry)
             if continuous else None)
    # Bounded queue: the reader blocks once it is this far ahead, so a
    # piped request file does not pile up in host memory.
    q: queue.Queue = queue.Queue(maxsize=max(1, args.serve_batch) * 8)
    reader = threading.Thread(
        target=_reader, args=(stdin or sys.stdin, q), daemon=True
    )
    reader.start()
    out = stdout or sys.stdout
    if continuous:
        serve_continuous(q, sched, out, telemetry)
        result = sched
    else:
        src_tok = tgt_tok
        if not (cfg.decoder_only or cfg.encoder_only):
            src_tok = (tgt_tok if args.src_vocab_file == args.tgt_vocab_file
                       else SubwordTokenizer.load(args.src_vocab_file))
        result = serve_grouped(q, params, cfg, src_tok, tgt_tok, args, out, telemetry)
    if telemetry is not None:
        telemetry.close()
    reader.join(timeout=5.0)
    return result


def run() -> int:
    """Console-script entry point: serve, then exit with status 0."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(run())
