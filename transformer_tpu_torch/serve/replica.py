"""Replica worker: one model copy and one ``ContinuousScheduler`` behind a pipe.

Port of ``transformer_tpu/serve/replica.py``: the unit the router
(``serve/router.py``) multiplies. Launched as

    python -m transformer_tpu_torch.serve.replica --export_path=model \\
        --tgt_vocab_file=vocab.subwords [scheduler flags...] [--device=cuda]

it loads its own copy of the model (or builds a deterministic one from a
``--model_spec`` JSON), captures its step graph (``warm_up``) and speaks
the JAX worker's line protocol on stdin/stdout:

router -> replica:
    {"type": "req", "rid": N, "req": {...}}            serve a request
    {"type": "req", "rid": N, "req": {...},
     "blocks": ..., "tokens": T}                       ... after a prefill
                                                       handoff: inject T
                                                       prompt tokens' KV
                                                       into the local
                                                       PrefixCache first
    {"type": "prefill", "rid": N, "req": {...}}        disaggregation stage
                                                       1: ingest the prompt,
                                                       export its KV blocks
    {"type": "export_state", "limit": K}               the K hottest cached
                                                       prefixes (warm-up)
    {"type": "inject_state", "entries": [...],         ... into a new replica
     "path": P}
    {"type": "upgrade", "ckpt": D, "version": V}       verify and stage a
                                                       weight set (the flip
                                                       lands at a drained
                                                       step boundary)
    {"type": "rollback"}                               stage the resident
                                                       previous weights
    {"type": "dump"}                                   flight-recorder dump
    {"type": "shutdown"}                               drain and exit

replica -> router:
    {"type": "ready", "replica": name, "slots": N, "role": R
     [, "control_port": P] [, "weight_version": V]}    P with --ha only
    {"type": "hb", "backlog": B, "free": F, "active": A [, "wv": V]}
    {"type": "answer", "rid": N, "resp": {...} [, "slo": {...}]}
    {"type": "prefilled", "rid": N, "tokens": T, "blocks": ...}
    {"type": "prefix_state", "entries": [...], "path": P}
    {"type": "state_injected", "tokens": T}
    {"type": "upgrade_staged", "ok": B, "version": V [, "error": E]}
    {"type": "upgraded", "ok": B, "version": V [, "error": E]}
    {"type": "flight", "record": {...}|null}          the dump reply: the
                                                       flight recorder's
                                                       ring (null when none
                                                       is armed)
    {"type": "stats", "stats": {...}}                  final, at shutdown

``rid`` is the router's order for the request: the replica never invents
identity. ``slo`` is the answer's span (``ttft_s``, ``queue_s``,
``total_s``, ``prefix_hit_tokens``, ``new_tokens``) for the router's SLO
engine; the router strips it before the client. The final ``stats`` add
``graph_captures`` (the step graphs captured, all before ``ready``) and
``params_moved`` (serving tensors whose storage moved: a flip copies in
place, so 0) to the scheduler's counters.

**KV handoff format**: the prompt's KV crosses the process boundary as
the prefix cache's own host blocks (per layer, per ``block_tokens``
positions, in the cache's storage layout), each array as base64 bytes
with its numpy dtype string and shape: JAX's wire format, so a block
exported by either package injects into the other (a bf16 array travels
as ``V2`` words, the port's int16 host form). The warm-up's prefixes
(``export_state``) go beside the line instead, raw in an ``.npz`` file
that the line names; ``inject_state`` takes either form.

Telemetry: with ``--metrics_jsonl PATH`` (the router passes
``<its path>.r<index>``) the scheduler records into ``PATH`` (the
program profiler on by default), ``--trace`` adds the span trees, whose
roots parent under the router's ``route.request`` span through the
forwarded ``traceparent``, and the flight recorder dumps to
``PATH.flight.json`` every 0.5 s (what a SIGKILL leaves for the
supervisor's postmortem), on SIGTERM and on a ``dump`` request. The
final ``stats`` message then carries the profiler's rows as ``perf``.

**Router HA** (``--ha``): the worker also listens on a localhost TCP
control socket (an ephemeral port, announced in ``ready``). A warm standby
router (``serve/standby.py``) that finds the primary dead connects and
sends::

    {"type": "takeover", "epoch": E, "inflight": [rid, ...]}

An epoch higher than that of the channel holding authority (stdin starts
at 1) wins. The reply says, for each rid the standby believes in flight,
whether it is ``done`` (the answer message replayed from a bounded cache
of recent answers: an answer lost in the dead primary's pipe is delivered
again, and the standby's funnel keeps it at most once), still
``inflight`` (it will answer on the new channel) or ``unknown`` (the
standby redispatches it)::

    {"type": "adopted", "replica": name, "epoch": E,
     "statuses": {rid: "done"|"inflight"|"unknown"},
     "messages": {rid: <the answer or prefilled message>}}

and every later message goes to the adopting channel. A takeover at an
epoch not above the current one answers ``{"type": "rejected", "epoch":
cur}`` and changes nothing: after an adoption, what still arrives from the
old channel (a primary wrongly declared dead) is dropped and counted
(``stale_dropped``), never served twice. In HA mode stdin's EOF does not
end the worker (the primary's death must not take the fleet with it);
shutdown comes from the channel in authority. The final ``stats`` add
``stale_dropped``, ``takeovers`` and ``rejected_takeovers``.

Left out (a later slice): ``--mesh`` (``serve/sharded.py``).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import queue
import socket
import sys
import threading
import time
from collections import deque

_LATER = {
    "mesh": "--mesh (sharded replicas) comes with serve/sharded.py, a later slice "
            "of the port",
}

RECENT_ANSWERS = 512  # the re-delivery cache a takeover replays from


class _Channel:
    """One duplex control link: stdin/stdout, or an accepted takeover
    socket. The main loop is its only writer, so lines never tear; reader
    threads only feed its inbound lines to the main queue. ``epoch`` is the
    authority the channel last proved (stdin starts at 1, a socket earns
    one in the handshake). A write failure marks it broken: the answers
    are not lost with it, the re-delivery cache replays them to whoever
    adopts next."""

    def __init__(self, write_file, epoch: int = 0):
        self._write = write_file
        self.epoch = epoch
        self.broken = False

    def send(self, msg: dict) -> bool:
        if self.broken or self._write is None:
            return False
        try:
            self._write.write(json.dumps(msg) + "\n")
            self._write.flush()
            return True
        except (OSError, ValueError):
            self.broken = True
            return False


# --------------------------------------------------------------------------
# deterministic test-model bootstrap


def build_model_from_spec(spec: dict, device="cuda"):
    """(params, cfg, tok) from a model-spec dict::

        {"config": {...ModelConfig overrides (vocab sizes filled from the
                    corpus tokenizer)...},
         "seed": 0,
         "corpus": ["line", ...],
         "target_vocab_size": 300}

    Every process that builds the same spec gets bit-identical parameters
    and vocabulary (the port's own init from ``seed`` through a
    ``torch.Generator``; not the JAX package's values, so cross-package
    runs load a JAX-written checkpoint through ``--init_ckpt``)."""
    import torch

    from transformer_tpu_torch.config import ModelConfig
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer
    from transformer_tpu_torch.models.transformer import init_params

    tok = SubwordTokenizer.build_from_corpus(
        list(spec["corpus"]), target_vocab_size=int(spec.get("target_vocab_size", 300)),
    )
    cfg = ModelConfig(**{
        **dict(spec.get("config", {})),
        "input_vocab_size": tok.model_vocab_size,
        "target_vocab_size": tok.model_vocab_size,
    })
    params = init_params(cfg, torch.Generator().manual_seed(int(spec.get("seed", 0))),
                         device=device)
    return params, cfg, tok


# --------------------------------------------------------------------------
# KV-block handoff (disaggregated prefill/decode, supervisor warm-up)


def _encode_array(a) -> dict:
    import numpy as np

    a = np.ascontiguousarray(a)
    # The host form keeps bf16 as int16 bit patterns (no other KV buffer
    # is int16); on the wire it is JAX's 2-byte void.
    dtype = "<V2" if a.dtype == np.int16 else a.dtype.str
    return {
        "dtype": dtype, "shape": list(a.shape),
        "b64": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def _decode_array(d: dict):
    import numpy as np

    dtype = np.dtype(d["dtype"])
    if dtype.kind == "V" and dtype.itemsize == 2:
        dtype = np.dtype(np.int16)  # bf16 words, the host form
    return np.frombuffer(base64.b64decode(d["b64"]), dtype=dtype).reshape(d["shape"])


def export_blocks(cache, ids: "list[int]") -> "tuple[int, list]":
    """The longest block-aligned prefix of ``ids`` in ``cache`` (a
    ``PrefixCache`` a ``max_new`` 0 admission just fed) as the wire
    payload: ``payload[j]`` is block j, per-layer dicts of encoded arrays
    in the cache's storage layout. Returns ``(tokens, payload)``; (0, [])
    when nothing aligned is stored (the decode side then prefills it)."""
    tokens, blocks = _host_blocks(cache, ids)
    return tokens, [[{key: _encode_array(layer[key]) for key in sorted(layer)}
                     for layer in blk] for blk in blocks]


def _host_blocks(cache, ids: "list[int]") -> "tuple[int, list]":
    """``export_blocks``'s prefix as the cache's host blocks (per-layer
    dicts of arrays), not encoded."""
    B = cache.block_tokens
    aligned = (len(ids) // B) * B
    if not aligned:
        return 0, []
    hit = cache.match(ids[:aligned])
    try:
        payload = []
        for node in hit._nodes:
            try:
                # Host blocks as stored, or one read of a device-tier block:
                # the same wire format.
                blocks = cache.host_blocks_for(node)
            except Exception:  # noqa: BLE001 — an unreadable block ends the payload; the rest is prefilled
                break
            payload.append(blocks)
        return len(payload) * B, payload
    finally:
        hit.release()


def export_state(cache, limit: int, beat=None) -> dict:
    """The ``limit`` hottest cached prefixes, for warming a respawned
    replica, as the ``prefix_state`` message's fields: ``entries``
    (``ids``, ``tokens``, ``blocks``: the count of blocks) and ``path``,
    an uncompressed ``.npz`` in the temp directory holding block j of
    entry i, layer l, under ``{i}_{j}_{l}_{key}`` (None when nothing was
    exported). The blocks travel beside the control line, not in it: tens
    to hundreds of MB of base64 JSON, encoded, piped to the router,
    forwarded and parsed again, outlasted the router's heartbeat timeout
    and the warm-up's own on a slow host. ``beat()`` runs after each
    prefix, so the worker's heartbeats keep flowing meanwhile."""
    import tempfile

    import numpy as np

    entries, arrays = [], {}
    for ids in cache.hot_prefixes(limit):
        try:
            tokens, blocks = _host_blocks(cache, list(ids))
        except Exception:  # noqa: BLE001 — warm-up is best-effort: skip the prefix
            tokens = 0
        if tokens:
            i = len(entries)
            for j, blk in enumerate(blocks):
                for l, layer in enumerate(blk):
                    for key, a in layer.items():
                        arrays[f"{i}_{j}_{l}_{key}"] = np.ascontiguousarray(a)
            entries.append({"ids": list(ids), "tokens": tokens, "blocks": len(blocks)})
        if beat is not None:
            beat()
    path = None
    if entries:
        fd, path = tempfile.mkstemp(prefix="warm-state-", suffix=".npz")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
    return {"entries": entries, "path": path}


def inject_state(cache, msg: dict, beat=None) -> int:
    """An ``inject_state`` message's prefixes into ``cache`` (None: none):
    the blocks read from ``msg["path"]`` (``export_state``'s file, removed
    once read) or, with no path, each entry's wire ``blocks`` (the JAX
    worker's form). A prefix that does not load is skipped; ``beat()``
    runs after each. Returns the tokens inserted."""
    import numpy as np

    path, total = msg.get("path"), 0
    data = None
    try:
        if path and cache is not None:
            names: dict = {}
            try:
                data = np.load(path, allow_pickle=False)
                for name in data.files:
                    i, j, l, key = name.split("_", 3)
                    names.setdefault((int(i), int(j)), {}).setdefault(int(l), {})[key] = name
            except Exception:  # noqa: BLE001 — a missing or corrupt file leaves the cache cold
                return 0
        for i, e in enumerate(msg.get("entries", []) if cache is not None else []):
            try:
                if data is None:
                    total += inject_blocks(cache, list(e["ids"]), e.get("tokens", 0),
                                           e.get("blocks", []))
                else:
                    blocks = [[{key: data[name] for key, name in layers[l].items()}
                               for l in sorted(layers)]
                              for layers in (names[i, j] for j in range(int(e["blocks"])))]
                    total += _insert_blocks(cache, list(e["ids"]), e.get("tokens", 0), blocks)
            except Exception:  # noqa: BLE001 — a corrupt payload leaves the cache cold
                pass
            if beat is not None:
                beat()
    finally:
        if data is not None:
            data.close()
        if path:
            try:
                os.unlink(path)
            except OSError:
                pass
    return total


def inject_blocks(cache, ids: "list[int]", tokens: int, payload: list) -> int:
    """Insert a handoff payload into the local ``PrefixCache`` so that the
    next admission of ``ids`` restores it without a forward. Returns the
    tokens inserted (the cache's budget may take fewer)."""
    return _insert_blocks(cache, ids, tokens, [
        [{key: _decode_array(d) for key, d in layer.items()} for layer in blk]
        for blk in payload
    ])


def _insert_blocks(cache, ids: "list[int]", tokens: int, blocks: list) -> int:
    B = cache.block_tokens
    tokens = min(int(tokens), (len(ids) // B) * B, len(blocks) * B)
    if tokens <= 0:
        return 0
    cache.insert(ids[:tokens], tokens, lambda start: blocks[start // B])
    return tokens


# --------------------------------------------------------------------------
# the worker


def _parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="router replica worker")
    p.add_argument("--replica_name", default="replica0")
    p.add_argument("--role", choices=("both", "prefill", "decode"), default="both")
    p.add_argument("--export_path", default="")
    p.add_argument("--tgt_vocab_file", default="")
    p.add_argument("--model_spec", default="",
                   help="JSON file with a deterministic test-model spec "
                        "(build_model_from_spec)")
    p.add_argument("--kv_cache_int8", action="store_true")
    p.add_argument("--serve_slots", type=int, default=4)
    p.add_argument("--serve_max_total", type=int, default=0)
    p.add_argument("--prefill_chunk", type=int, default=0)
    p.add_argument("--max_len", type=int, default=64, help="default max_new per request")
    p.add_argument("--speculate_k", type=int, default=0)
    p.add_argument("--prefix_cache_mb", type=int, default=0)
    p.add_argument("--prefix_block", type=int, default=16)
    p.add_argument("--kv_layout", choices=("dense", "paged"), default="dense",
                   help="per-slot KV storage: dense max_total buffers, or the paged "
                        "block pool (read through gathered views)")
    p.add_argument("--kv_pool_blocks", type=int, default=0,
                   help="paged pool size in blocks (0 = full provisioning)")
    p.add_argument("--mesh", default="", help="refused: a later slice")
    p.add_argument("--max_backlog", type=int, default=0)
    p.add_argument("--heartbeat_ms", type=float, default=200.0)
    from transformer_tpu_torch.cli.serve import add_metrics_flags

    add_metrics_flags(p)
    p.add_argument("--fault_spec", default="")
    p.add_argument("--ha", action="store_true",
                   help="router HA: listen on a localhost control socket for a warm "
                        "standby's takeover handshake, and outlive stdin's EOF (the "
                        "primary's death must not end the fleet)")
    p.add_argument("--init_ckpt", default="",
                   help="bootstrap the serving weights from this manifest-verified "
                        "checkpoint instead of the export or spec weights (the "
                        "supervisor passes the fleet's target version here)")
    p.add_argument("--weight_version", default="",
                   help="the weight_version digest --init_ckpt must verify to (a "
                        "mismatch refuses the bootstrap); also tags the answers of "
                        "a replica that was never upgraded")
    p.add_argument("--device", default="cuda",
                   help="where the model runs; 'cuda' (the default) raises without "
                        "a card")
    return p.parse_args(argv)


def refuse_later_slices(args: argparse.Namespace) -> None:
    """Raise, naming the later slice, for a flag whose module is not
    ported yet."""
    for name, message in _LATER.items():
        if getattr(args, name):
            raise SystemExit(message)


def stdin_reader(q: "queue.Queue") -> None:
    """Feed stdin lines into ``q``, then a ``None`` EOF sentinel: the one
    line-intake reader of this worker and ``cli/router.py``."""
    for line in sys.stdin:
        q.put(line)
    q.put(None)


def _control_server(listener: socket.socket, q: "queue.Queue") -> None:
    """Accept takeover connections; for each, one reader thread puts
    ``(channel, line)`` pairs on the main queue, as ``stdin_reader`` puts
    lines, so the main loop stays the only owner of the serving state."""
    while True:
        try:
            conn, _ = listener.accept()
        except OSError:
            return  # the listener closed at exit
        chan = _Channel(conn.makefile("w", encoding="utf-8", buffering=1))
        rf = conn.makefile("r", encoding="utf-8")

        def reader(chan=chan, rf=rf):
            try:
                for line in rf:
                    q.put((chan, line))
            except (OSError, ValueError):
                pass
            chan.broken = True

        threading.Thread(target=reader, daemon=True, name="replica-control-read").start()


def replica_telemetry(args: argparse.Namespace):
    """The worker's ``obs.Telemetry`` (None without ``--metrics_jsonl``), as
    the JAX worker builds it: the event log, ``--trace``'s tracer, the
    program profiler, and a flight recorder that dumps every 0.5 s (a
    SIGKILL leaves at most half a second of the ring unwritten) and on
    SIGTERM."""
    if not args.metrics_jsonl:
        return None
    from transformer_tpu_torch.obs import EventLog, Telemetry
    from transformer_tpu_torch.obs.flight import flight_path_for

    telemetry = Telemetry(events=EventLog(args.metrics_jsonl), trace=args.trace,
                          interval=args.metrics_interval)
    if args.profile_programs:
        telemetry.arm_profiler()
    if args.flight_recorder:
        flight = telemetry.arm_flight(flight_path_for(args.metrics_jsonl), autodump_s=0.5)
        flight.install_signal_handlers()
    if args.metrics_port:
        telemetry.start_prometheus_server(args.metrics_port)
    return telemetry


def _load_model(args, device):
    from transformer_tpu_torch.convert import load_export
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer

    if args.model_spec:
        with open(args.model_spec) as f:
            spec = json.load(f)
        return build_model_from_spec(spec, device=device)
    params, cfg = load_export(args.export_path, kv_cache_int8=args.kv_cache_int8,
                              device=device)
    return params, cfg, SubwordTokenizer.load(args.tgt_vocab_file)


def main(argv=None) -> None:
    args = _parse_args(argv)
    refuse_later_slices(args)
    from transformer_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # no card for "cuda": raises before ready
    stdin_chan = _Channel(sys.stdout, epoch=1)
    out = stdin_chan  # the channel in authority; its epoch is the worker's
    sys.stdout = sys.stderr  # stray prints never reach the protocol line
    if args.fault_spec:
        from transformer_tpu_torch.serve import resilience

        resilience.install(resilience.FaultPlane.parse(args.fault_spec))

    params, cfg, tok = _load_model(args, device)
    telemetry = replica_telemetry(args)
    weight_version = args.weight_version or None
    if args.init_ckpt:
        # The bootstrap at the fleet's target version: the checkpoint's
        # bytes are verified and its arrays matched against the spec's tree
        # before anything serves; a bad artifact kills the bootstrap, and
        # the supervisor's restart budget absorbs it.
        from transformer_tpu_torch.models.transformer import flatten, unflatten
        from transformer_tpu_torch.serve.scheduler import as_tensor
        from transformer_tpu_torch.serve.upgrade import load_checkpoint_params

        loaded, loaded_version = load_checkpoint_params(args.init_ckpt, params)
        if args.weight_version and args.weight_version != loaded_version:
            print(
                f"replica: --init_ckpt {args.init_ckpt} verifies to {loaded_version} but "
                f"--weight_version expected {args.weight_version}; refusing to serve the "
                "wrong weights", file=sys.stderr,
            )
            raise SystemExit(2)
        params = unflatten({k: as_tensor(v).to(device) for k, v in flatten(loaded).items()})
        weight_version = loaded_version

    from transformer_tpu_torch.models.transformer import flatten
    from transformer_tpu_torch.serve.prefix_cache import PrefixCache
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    prefix_cache = None
    if args.prefix_cache_mb > 0 or args.role in ("prefill", "decode"):
        # Disaggregation rides the prefix-cache block format on both sides.
        prefix_cache = PrefixCache(
            cfg, block_tokens=args.prefix_block, budget_mb=max(1, args.prefix_cache_mb or 64),
        )
    # The span side channel: each answer's span, shipped beside the answer
    # for the router's SLO engine.
    spans_by_order: "dict[int, dict]" = {}
    sched = ContinuousScheduler(
        params, cfg, tok,
        num_slots=args.serve_slots,
        max_total=args.serve_max_total or None,
        prefill_chunk=args.prefill_chunk,
        default_max_new=args.max_len,
        speculate_k=args.speculate_k,
        prefix_cache=prefix_cache,
        max_backlog=args.max_backlog,
        kv_layout=args.kv_layout,
        kv_block=args.prefix_block,
        kv_pool_blocks=args.kv_pool_blocks,
        weight_version=weight_version,
        span_tap=lambda span: spans_by_order.__setitem__(span.get("order"), span),
        telemetry=telemetry,
        device=device,
    )
    del params
    # Capture the step graph now: a first capture under traffic could
    # outlast the router's heartbeat timeout.
    sched.warm_up()
    warm_captures = len(sched.forward.captures)
    ptrs = {k: t.data_ptr() for k, t in flatten(sched.params).items()}

    q: queue.Queue = queue.Queue()
    threading.Thread(target=stdin_reader, args=(q,), daemon=True).start()
    listener = None
    ready = {"type": "ready", "replica": args.replica_name, "slots": args.serve_slots,
             "role": args.role}
    if args.ha:
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.bind(("127.0.0.1", 0))
        listener.listen(4)
        ready["control_port"] = listener.getsockname()[1]
        threading.Thread(target=_control_server, args=(listener, q), daemon=True,
                         name="replica-control-accept").start()
    if weight_version is not None:
        ready["weight_version"] = weight_version
    out.send(ready)

    hb_s = max(args.heartbeat_ms, 1.0) / 1e3
    hb_at = [0.0]

    def heartbeat() -> None:
        """An ``hb`` line once ``heartbeat_ms`` has passed since the last:
        from the loop, and between the prefixes of a warm-up export or
        inject, which can outlast the router's heartbeat timeout."""
        now = time.monotonic()
        if now - hb_at[0] < hb_s:
            return
        hb_at[0] = now
        hb = {"type": "hb", "backlog": sched.backlog,
              "free": sched.num_slots - sched.active_count, "active": sched.active_count}
        if sched.weight_version is not None:
            hb["wv"] = sched.weight_version
        out.send(hb)

    # The scheduler answers in arrival order and this loop is its only
    # submitter: a FIFO of (rid, scheduler order) maps answers back.
    rid_fifo: "list[tuple[int, int]]" = []
    prefill_rids: "set[int]" = set()
    prompt_ids: "dict[int, list[int]]" = {}
    # The bounded re-delivery cache: each answered rid's whole message,
    # replayed through a takeover when the answer died in the old
    # primary's pipe (the adopting funnel drops duplicates).
    recent_answers: "dict[int, dict]" = {}
    answer_fifo: deque = deque()
    stats_extra = {"stale_dropped": 0, "takeovers": 0, "rejected_takeovers": 0}
    # At most one checkpoint verification in flight, on a worker thread
    # (a large checkpoint must not starve the heartbeats); the main loop
    # stages its result on its own stream.
    upgrade_load: "list[tuple[threading.Thread, dict]]" = []

    def reap_upgrade_load() -> None:
        if not upgrade_load or upgrade_load[0][0].is_alive():
            return
        _, holder = upgrade_load.pop(0)
        if holder["error"] is not None:
            out.send({"type": "upgrade_staged", "ok": False, "version": holder["version"],
                      "error": holder["error"]})
            return
        new_params, digest = holder["result"]
        try:
            sched.stage_params(new_params, digest)
        except ValueError as e:
            out.send({"type": "upgrade_staged", "ok": False, "version": digest,
                      "error": f"{type(e).__name__}: {e}"})
            return
        out.send({"type": "upgrade_staged", "ok": True, "version": digest})

    template = sched.stored_template()
    # Warm-up files this worker wrote: the replacement removes each one it
    # reads; whatever no replacement read goes at exit.
    exported: "list[str]" = []

    def remember(rid, msg) -> None:
        recent_answers[rid] = msg
        answer_fifo.append(rid)
        while len(answer_fifo) > RECENT_ANSWERS:
            recent_answers.pop(answer_fifo.popleft(), None)

    def handle_takeover(chan: _Channel, msg: dict) -> None:
        nonlocal out
        e = int(msg.get("epoch", 0))
        if e <= out.epoch:
            # The split-brain guard: a stale or second adopter changes
            # nothing.
            stats_extra["rejected_takeovers"] += 1
            chan.send({"type": "rejected", "replica": args.replica_name, "epoch": out.epoch})
            return
        inflight_here = {rid for rid, _ in rid_fifo}
        statuses, messages = {}, {}
        for rid in msg.get("inflight", []):
            if rid in recent_answers:
                statuses[str(rid)] = "done"
                messages[str(rid)] = recent_answers[rid]
            elif rid in inflight_here:
                statuses[str(rid)] = "inflight"
            else:
                statuses[str(rid)] = "unknown"
        chan.epoch = e
        out = chan
        stats_extra["takeovers"] += 1
        out.send({
            "type": "adopted", "replica": args.replica_name, "epoch": e, "role": args.role,
            "slots": args.serve_slots, "statuses": statuses, "messages": messages,
            "backlog": sched.backlog, "active": sched.active_count,
        })

    def ingest(chan: _Channel, msg: dict) -> bool:
        """Handle one control message from ``chan``; False on shutdown."""
        kind = msg.get("type")
        if kind == "takeover":
            handle_takeover(chan, msg)
            return True
        if chan.epoch < out.epoch:
            # A channel that lost authority (the old primary after a
            # takeover): its requests must not be served twice.
            stats_extra["stale_dropped"] += 1
            return True
        if kind == "shutdown":
            sched.shutdown()
            return False
        if kind == "dump":
            # Persist the ring and ship it: the supervisor keeps the newest
            # record for a postmortem.
            record = None
            if telemetry is not None and telemetry.flight is not None:
                record = telemetry.flight.dump("request")
            out.send({"type": "flight", "record": record})
            return True
        if kind == "export_state":
            state = {"entries": [], "path": None}
            if prefix_cache is not None:
                state = export_state(prefix_cache, int(msg.get("limit", 8)), heartbeat)
                if state["path"]:
                    exported.append(state["path"])
            out.send({"type": "prefix_state", **state})
            return True
        if kind == "upgrade":
            # Verify the checkpoint and match it against the running tree
            # on a thread; reap_upgrade_load stages the result, and the
            # flip lands at a drained step boundary ("upgraded"). Any
            # failure answers a refusal with the old weights untouched.
            version = msg.get("version")
            if upgrade_load:
                out.send({"type": "upgrade_staged", "ok": False, "version": version,
                          "error": "an upgrade is already being verified"})
                return True
            holder = {"version": version, "result": None, "error": None}

            def load(ckpt=str(msg.get("ckpt", "")), holder=holder):
                try:
                    from transformer_tpu_torch.serve.upgrade import (
                        UpgradeError,
                        load_checkpoint_params,
                    )

                    new_params, digest = load_checkpoint_params(ckpt, template)
                    expected = holder["version"]
                    if expected and digest != expected:
                        raise UpgradeError(
                            f"checkpoint verifies to {digest} but the rollout "
                            f"targets {expected} — wrong artifact"
                        )
                    holder["result"] = (new_params, digest)
                except Exception as e:  # noqa: BLE001 — a refusal, never a dead worker
                    holder["error"] = f"{type(e).__name__}: {e}"

            t = threading.Thread(target=load, daemon=True, name="replica-upgrade-load")
            t.start()
            upgrade_load.append((t, holder))
            return True
        if kind == "rollback":
            try:
                version = sched.stage_rollback()
            except ValueError as e:
                out.send({"type": "upgraded", "ok": False, "version": None,
                          "error": f"{type(e).__name__}: {e}"})
                return True
            out.send({"type": "upgrade_staged", "ok": True, "version": version,
                      "rollback": True})
            return True
        if kind == "inject_state":
            total = inject_state(prefix_cache, msg, heartbeat)
            out.send({"type": "state_injected", "tokens": total})
            return True
        if kind not in ("req", "prefill"):
            return True
        rid = msg.get("rid")
        req = msg.get("req")
        if not isinstance(req, dict):
            req = {"prompt": ""}
        if kind == "prefill":
            # Stage 1: ingest the prompt only (max_new 0 feeds the prefix
            # cache at retirement), then export its KV.
            req = {**req, "max_new": 0, "cache_prefix": True}
            prefill_rids.add(rid)
        if prefix_cache is not None:
            try:
                ids = [tok.bos_id, *tok.encode(str(req.get("prompt", "")))]
            except Exception:  # noqa: BLE001 — admission answers the validation error
                ids = []
            prompt_ids[rid] = ids
            if kind == "req" and msg.get("blocks") and ids:
                try:
                    inject_blocks(prefix_cache, ids, msg.get("tokens", 0), msg["blocks"])
                except Exception:  # noqa: BLE001 — a corrupt handoff means a full prefill
                    pass
        rid_fifo.append((rid, sched.submit(req)))
        return True

    def flush_answers() -> None:
        for resp in sched.drain_ready():
            rid, order = rid_fifo.pop(0)
            span = spans_by_order.pop(order, None)
            if rid in prefill_rids:
                prefill_rids.discard(rid)
                tokens, payload = 0, []
                ids = prompt_ids.pop(rid, [])
                if "error" not in resp and prefix_cache is not None and ids:
                    try:
                        tokens, payload = export_blocks(prefix_cache, ids)
                    except Exception:  # noqa: BLE001 — the decode side prefills in full
                        tokens, payload = 0, []
                msg = {"type": "prefilled", "rid": rid, "tokens": tokens, "blocks": payload}
            else:
                prompt_ids.pop(rid, None)
                msg = {"type": "answer", "rid": rid, "resp": resp}
                if span is not None:
                    msg["slo"] = {
                        k: span[k]
                        for k in ("ttft_s", "queue_s", "total_s", "prefix_hit_tokens",
                                  "new_tokens")
                        if k in span
                    }
            remember(rid, msg)
            out.send(msg)

    alive = True
    while alive or sched.busy:
        # Take in whatever the router sent; block only when idle.
        while alive:
            try:
                if sched.busy or sched.has_ready:
                    item = q.get_nowait()
                else:
                    item = q.get(timeout=hb_s)  # idle: wake for heartbeats
            except queue.Empty:
                break
            if item is None:
                # stdin's EOF: drain and exit, unless in HA mode, where the
                # worker outlives its primary and a standby adopts it.
                if args.ha:
                    continue
                alive = False
                break
            chan, line = (stdin_chan, item) if isinstance(item, str) else item
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            if not isinstance(msg, dict):
                continue
            if not ingest(chan, msg):
                alive = False
                break
        reap_upgrade_load()
        sched.admit()
        sched.step()
        flush_answers()
        for ev in sched.consume_swap_events():
            # The step-boundary flip (or its ckpt.swap abort) just happened.
            out.send({"type": "upgraded", **ev})
        heartbeat()
    flush_answers()
    stats = {
        **dict(sched.stats),
        **stats_extra,
        "graph_captures": len(sched.forward.captures),
        "warm_captures": warm_captures,
        "params_moved": sum(
            1 for k, t in flatten(sched.params).items() if t.data_ptr() != ptrs[k]
        ),
    }
    final = {"type": "stats", "stats": stats}
    if telemetry is not None and telemetry.profiler is not None:
        # The measured per-program rows, without a parse of the worker's log.
        final["perf"] = telemetry.profiler.summary()
    out.send(final)
    if listener is not None:
        listener.close()
    if telemetry is not None:
        telemetry.close()
    for path in exported:
        try:
            os.unlink(path)
        except OSError:
            pass


if __name__ == "__main__":
    main()
