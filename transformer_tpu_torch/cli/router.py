"""The serving fleet's front end: spawn N replica workers and route to them.

    python -m transformer_tpu_torch.cli.router --replicas 2 --export_path=model \\
        --tgt_vocab_file=vocab.subwords [--device=cuda]
    python -m transformer_tpu_torch.cli.router --replicas 2 --model_spec spec.json \\
        --device=cpu

Port of ``transformer_tpu/cli/router.py``, with its flags and defaults
(argparse replaces absl; booleans take ``--flag`` or ``--flag=false``).
The wire contract is ``cli.serve``'s: one JSON request (or raw prompt
line) per stdin line, one JSON answer per line, in request order. The
router process loads no model; it owns intake, the prefix-affinity /
least-loaded dispatch, heartbeat liveness and zero-loss failover
(``serve/router.py``). Each replica worker (``serve/replica.py``) is a
subprocess running the continuous scheduler over its own copy of the
model, on ``--device`` (``cuda`` by default: several workers share one
card, each with its own CUDA context and step graphs).

``--disaggregate`` makes replica 0 prefill-only and the rest
decode-only: prompts are ingested on the prefill side and their KV
handed to the decode side as prefix-cache blocks.

``--supervise`` (on by default) respawns a dead replica from the same
recipe under its old name, warms its PrefixCache from a survivor, within
a restart budget (``--max_restarts`` per ``--restart_window``).
``--max_replicas N`` above ``--replicas`` turns on SLO-driven scaling.

Live weights: a stdin line ``{"upgrade": "<checkpoint dir>"}`` (or
``--upgrade`` at startup) starts a rolling swap to a manifest-verified
checkpoint (``serve/upgrade.py``): one replica at a time is quiesced and
flipped in place, the first as a canary judged over ``--canary_window``
seconds; the line answers the coordinator's status at its order.
Answers carry the ``weight_version`` they were admitted under once a
replica serves a tagged version.

Telemetry: with ``--metrics_jsonl=PATH`` the router logs to PATH (the
``route.*`` events, ``router_*`` metrics) and each replica to
``PATH.r<index>``; ``--trace`` traces both, the replicas' request spans
under the router's, so

    python -m transformer_tpu_torch.obs summarize PATH PATH.r0 PATH.r1
    python -m transformer_tpu_torch.obs trace PATH PATH.r0 PATH.r1 --out t.json

render the fleet (its ``fleet:`` line) and join each request's spans
across the processes. ``--metrics_port`` serves the router's
``/metrics``.

Router HA: ``--ha`` journals intake, delivery and a heartbeat to
``--metrics_jsonl`` and gives each worker a takeover socket, so that a
warm standby

    python -m transformer_tpu_torch.cli.router --standby PATH --model_spec spec.json \
        --metrics_jsonl standby.jsonl --device=cpu

tails the primary's log, finds it dead after ``--takeover_after`` seconds
of heartbeat silence, adopts the fleet (``serve/standby.py``), answers
every request in flight exactly once and then serves its own stdin.
Without ``--metrics_jsonl``, ``--ha`` warns and is turned off for the
router and its workers (there would be no journal to tail), and
``--standby`` warns that the next standby will have nothing to tail.

Refused here, naming the later slice: ``--mesh`` (``serve/sharded.py``).
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading

from transformer_tpu_torch.cli.serve import add_metrics_flags
from transformer_tpu_torch.cli.train import _bool

_REFUSED = {
    "mesh": "--mesh (sharded replicas) comes with serve/sharded.py, a later slice of the "
            "port",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    flag = ap.add_argument

    def boolean(name, default, help):
        flag(name, type=_bool, nargs="?", const=True, default=default, help=help)

    # the telemetry flags (the JAX define_metrics_flags)
    add_metrics_flags(ap)
    flag("--replicas", type=int, default=2, help="replica worker processes to spawn")
    flag("--export_path", default="model", help="export directory (per replica)")
    flag("--tgt_vocab_file", default="tgt_vocab.subwords",
         help="target subword vocab (router affinity + replicas)")
    flag("--model_spec", default="",
         help="JSON test-model spec file (serve.replica build_model_from_spec) instead of "
              "an export")
    boolean("--kv_cache_int8", False, "int8 KV cache in replicas")
    flag("--serve_slots", type=int, default=4, help="KV-cache slots per replica")
    flag("--serve_max_total", type=int, default=0, help="per-slot KV budget")
    flag("--prefill_chunk", type=int, default=0, help="replica prefill chunk")
    flag("--max_len", type=int, default=64, help="default max_new per request")
    flag("--speculate_k", type=int, default=0, help="replica speculative lookahead")
    flag("--prefix_cache_mb", type=int, default=64,
         help="per-replica prefix KV cache budget (0 = off)")
    flag("--prefix_block", type=int, default=16, help="prefix-cache block tokens")
    flag("--kv_layout", choices=("dense", "paged"), default="dense",
         help="per-slot KV storage in each replica worker: dense buffers or the paged "
              "block pool")
    flag("--kv_pool_blocks", type=int, default=0,
         help="paged pool size per replica, in --prefix_block-token blocks "
              "(0 = full provisioning)")
    flag("--mesh", default="", help="refused: sharded replicas are a later slice")
    flag("--affinity_block", type=int, default=0,
         help="token-block granularity of prefix-affinity hashing (0 = --prefix_block)")
    flag("--affinity_slack", type=int, default=4,
         help="load gap (in-flight + heartbeat backlog) past which an affine request "
              "falls back to the least-loaded replica")
    flag("--max_redispatch", type=int, default=2,
         help="bounded failover: redispatches per request before answering a "
              "'transient' error")
    flag("--heartbeat_ms", type=float, default=200.0, help="replica heartbeat period")
    flag("--fault_spec", default="",
         help="deterministic fault injection (serve/resilience.py grammar), armed in "
              "the router (route.spawn / route.hb / route.upgrade / route.canary fire "
              "here) and forwarded to every replica (serve.* / prefix.* / draft.* / "
              "ckpt.swap fire there)")
    flag("--heartbeat_timeout", type=float, default=5.0,
         help="seconds without a heartbeat before a replica is failed over (0 = pipe "
              "EOF / process exit only)")
    boolean("--disaggregate", False,
            "prefill/decode disaggregation: replica 0 ingests prompts only and hands "
            "KV blocks to decode-only peers")
    boolean("--supervise", True,
            "supervised respawn under the old rendezvous name, the PrefixCache warmed "
            "from a survivor before admission")
    flag("--max_restarts", type=int, default=3,
         help="respawn budget per replica within --restart_window")
    flag("--restart_window", type=float, default=120.0,
         help="seconds over which --max_restarts is counted")
    flag("--spawn_backoff_ms", type=float, default=200.0,
         help="base exponential backoff between respawn attempts")
    flag("--warm_prefixes", type=int, default=8,
         help="hottest survivor PrefixCache prefixes exported to warm a respawned "
              "replica (0 = admit cold)")
    flag("--max_replicas", type=int, default=0,
         help="SLO-driven autoscaling ceiling (0 = fixed fleet)")
    flag("--min_replicas", type=int, default=1, help="autoscaling floor")
    flag("--scale_signal", default="ttft_p95",
         help="the SLO whose burn rate drives scale-up")
    flag("--scale_sustain", type=float, default=5.0,
         help="seconds of sustained burn > 1 before a scale-up")
    flag("--scale_idle", type=float, default=30.0,
         help="seconds of sustained idleness before a drain")
    flag("--scale_cooldown", type=float, default=15.0,
         help="seconds between consecutive scaling decisions")
    flag("--slo_spec", default="",
         help="SLO objectives of the router's burn-rate engine (obs/slo.py grammar; "
              "'' = defaults when autoscaling is on; 'none' disables)")
    boolean("--ha", False,
            "router HA primary: journal intake/delivery/heartbeat events to "
            "--metrics_jsonl and give replicas takeover control sockets so a warm "
            "standby (--standby) can adopt the fleet")
    flag("--upgrade", default="",
         help="start a rolling weight swap to this manifest-verified checkpoint at "
              "startup; at runtime a control line {\"upgrade\": \"<ckpt>\"} does the same")
    flag("--canary_window", type=float, default=5.0,
         help="seconds the first upgraded replica serves its pinned slice before the "
              "rollout promotes (clean) or rolls back (burn)")
    flag("--canary_every", type=int, default=0,
         help="pin every Nth accepted order to the canary (0 = the fleet size)")
    flag("--canary_slo", default="",
         help="SLO objectives of the per-version canary verdict (obs/slo.py grammar; "
              "'' = short-window availability + ttft_p95)")
    flag("--standby", default="",
         help="run as the warm standby for the primary whose --metrics_jsonl is this "
              "path: tail its journal, adopt the fleet when its heartbeat goes silent, "
              "then serve from this process's stdin")
    flag("--takeover_after", type=float, default=2.0,
         help="standby: seconds of primary heartbeat silence before takeover")
    flag("--device", default="cuda",
         help="where the replicas run ('cuda', the default, raises without a card)")
    return ap


def refuse_later_slices(args: argparse.Namespace) -> None:
    for name, message in _REFUSED.items():
        if getattr(args, name):
            raise SystemExit(message)


def worker_args(args: argparse.Namespace, replica_jsonl: str = "") -> list[str]:
    """The replica-worker argv tail every spawned process shares, plus the
    replica's own event log (``replica_jsonl``, with ``--trace`` when the
    router traces)."""
    out = [
        "--serve_slots", str(args.serve_slots),
        "--serve_max_total", str(args.serve_max_total),
        "--prefill_chunk", str(args.prefill_chunk),
        "--max_len", str(args.max_len),
        "--speculate_k", str(args.speculate_k),
        "--prefix_cache_mb", str(args.prefix_cache_mb),
        "--prefix_block", str(args.prefix_block),
        "--kv_layout", args.kv_layout,
        "--kv_pool_blocks", str(args.kv_pool_blocks),
        "--heartbeat_ms", str(args.heartbeat_ms),
        "--device", args.device,
    ]
    if args.model_spec:
        out += ["--model_spec", args.model_spec]
    else:
        out += ["--export_path", args.export_path, "--tgt_vocab_file", args.tgt_vocab_file]
        if args.kv_cache_int8:
            out += ["--kv_cache_int8"]
    if replica_jsonl:
        out += ["--metrics_jsonl", replica_jsonl]
        if args.trace:
            out += ["--trace"]
    if args.fault_spec:
        out += ["--fault_spec", args.fault_spec]
    if args.ha or args.standby:
        out += ["--ha"]
    return out


def replica_jsonl(args: argparse.Namespace, index: int) -> str:
    """Replica ``index``'s event log: ``<--metrics_jsonl>.r<index>``."""
    return f"{args.metrics_jsonl}.r{index}" if args.metrics_jsonl else ""


def route_lines(q: "queue.Queue", router, out) -> None:
    """Drive the router from the line queue: parse lines (a bad or
    wrong-kind one answers at once, at its reserved order), pump, write
    the answers in arrival order."""
    from transformer_tpu_torch.serve.router import _RouterLineError, parse_router_line

    eof = False
    while not eof or router.busy:
        while not eof:
            try:
                line = q.get_nowait()
            except queue.Empty:
                break
            if line is None:
                eof = True
                break
            line = line.strip()
            if not line:
                continue
            if line.startswith("{") and '"upgrade"' in line:
                # The control line {"upgrade": "<ckpt_dir>"}: start a rolling
                # swap and answer the coordinator's status at this order.
                try:
                    obj = json.loads(line)
                except ValueError:
                    obj = None
                if isinstance(obj, dict) and "upgrade" in obj and "prompt" not in obj:
                    status = router.start_upgrade(str(obj["upgrade"]))
                    router.submit_done({"upgrade": str(obj["upgrade"]), **status})
                    continue
            try:
                req = parse_router_line(line)
            except _RouterLineError as e:
                router.submit_done({"error": str(e), "code": "routing"})
                continue
            except Exception as e:  # noqa: BLE001 — a bad line answers, never kills the loop
                router.submit_done({"error": f"{type(e).__name__}: {e}", "code": "validation"})
                continue
            router.submit(req)
        router.pump()
        for resp in router.drain_ready():
            print(json.dumps(resp), file=out, flush=True)


def load_tokenizer(args: argparse.Namespace):
    """The tokenizer, all the router needs (for affinity hashing)."""
    from transformer_tpu_torch.data.tokenizer import SubwordTokenizer

    if args.model_spec:
        with open(args.model_spec) as f:
            spec = json.load(f)
        return SubwordTokenizer.build_from_corpus(
            list(spec["corpus"]), target_vocab_size=int(spec.get("target_vocab_size", 300)),
        )
    return SubwordTokenizer.load(args.tgt_vocab_file)


def spawn_recipe(args: argparse.Namespace):
    """The supervisor's re-bootstrap callable: the fleet's worker argv
    under the replica's old name, from the fleet's target checkpoint
    (``--init_ckpt`` / ``--weight_version``) once a rollout set one."""
    from transformer_tpu_torch.serve.router import ReplicaProcess

    def spawn(index: int, name: str, role: str, weight_target=None):
        argv = worker_args(args, replica_jsonl(args, index))
        if weight_target is not None:
            ckpt_dir, version = weight_target
            argv += ["--init_ckpt", ckpt_dir, "--weight_version", version]
        return ReplicaProcess.spawn(index, argv, role=role, name=name)

    return spawn


def supervision_kwargs(args: argparse.Namespace) -> dict:
    """The Router's coordinator, Supervisor, FleetScaler and SLO kwargs."""
    from transformer_tpu_torch.obs.slo import DEFAULT_SLOS, parse_slo_spec
    from transformer_tpu_torch.serve.supervisor import FleetScaler, Supervisor
    from transformer_tpu_torch.serve.upgrade import UpgradeCoordinator

    out: dict = {
        # Always attached: --upgrade and the control line drive it.
        "upgrader": UpgradeCoordinator(
            canary_window_s=args.canary_window, canary_every=args.canary_every,
            canary_slos=args.canary_slo or None,
        ),
    }
    if args.supervise:
        out["supervisor"] = Supervisor(
            spawn_recipe(args), max_restarts=args.max_restarts,
            restart_window_s=args.restart_window, backoff_ms=args.spawn_backoff_ms,
            warm_prefixes=args.warm_prefixes,
        )
    slo_spec = args.slo_spec
    autoscale = args.supervise and args.max_replicas > 0
    if slo_spec.lower() in ("none", "off"):
        slo_spec = ""
        autoscale = False
    if autoscale:
        out["scaler"] = FleetScaler(
            signal=args.scale_signal, sustain_s=args.scale_sustain, idle_s=args.scale_idle,
            max_replicas=args.max_replicas, min_replicas=args.min_replicas,
            cooldown_s=args.scale_cooldown,
        )
    if slo_spec:
        out["slos"] = slo_spec
    elif autoscale:
        out["slos"] = DEFAULT_SLOS
    if autoscale:
        # A watched signal missing from the objectives would pin the
        # scale-up burn at 0 while idle drain kept working.
        specs = parse_slo_spec(out["slos"]) if isinstance(out["slos"], str) else out["slos"]
        names = {s.name for s in specs}
        if args.scale_signal not in names:
            raise ValueError(
                f"--scale_signal {args.scale_signal!r} is not among the SLO objectives "
                f"{sorted(names)}; scale-up could never trigger"
            )
    return out


def _warn(message: str) -> None:
    print(f"warning: {message}", file=sys.stderr)


def router_kwargs(args: argparse.Namespace) -> dict:
    """The dispatch settings and supervision kwargs of a Router, the same
    for a primary and for an adopting standby."""
    return dict(
        affinity_block=args.affinity_block or args.prefix_block,
        affinity_slack=args.affinity_slack, max_redispatch=args.max_redispatch,
        heartbeat_timeout_s=args.heartbeat_timeout, **supervision_kwargs(args),
    )


def build_router(args: argparse.Namespace, telemetry=None):
    """Spawn the fleet the flags describe and return its ``Router``, its
    reader threads started. The device is checked first: with no card,
    ``--device cuda`` raises before any worker is spawned. ``--ha`` without
    an event sink (``telemetry`` None) warns and is turned off, in ``args``
    too, so that no worker outlives this router where no standby could
    find it."""
    from transformer_tpu_torch.device import resolve_device
    from transformer_tpu_torch.serve.router import ReplicaProcess, Router

    refuse_later_slices(args)
    resolve_device(args.device)
    if args.ha and telemetry is None:
        _warn("--ha needs --metrics_jsonl for the standby journal; disabling")
        args.ha = False
    tok = load_tokenizer(args)
    kwargs = router_kwargs(args)
    links = []
    for i in range(max(1, args.replicas)):
        role = "both"
        if args.disaggregate:
            role = "prefill" if i == 0 else "decode"
        links.append(ReplicaProcess.spawn(i, worker_args(args, replica_jsonl(args, i)),
                                          role=role))
    router = Router(links, encode=tok.encode, bos_id=tok.bos_id,
                    disaggregate=args.disaggregate, telemetry=telemetry, ha=args.ha, **kwargs)
    for link in links:
        link.start_reader(router.inbox)
    return router


def build_standby(args: argparse.Namespace, telemetry=None):
    """The warm ``Standby`` for the primary whose event log is
    ``--standby``, with a primary's supervision and dispatch settings for
    the router it adopts into. Without an event sink it warns: after
    adopting it writes no journal for a next standby."""
    from transformer_tpu_torch.device import resolve_device
    from transformer_tpu_torch.serve.standby import Standby

    refuse_later_slices(args)
    resolve_device(args.device)  # respawned workers run there
    if telemetry is None:
        _warn("--standby without --metrics_jsonl: after adopting, this router writes no "
              "journal — the NEXT standby will have nothing to tail")
    tok = load_tokenizer(args)
    return Standby(args.standby, takeover_after_s=args.takeover_after, encode=tok.encode,
                   bos_id=tok.bos_id, telemetry=telemetry, router_kwargs=router_kwargs(args))


def main(argv: list[str] | None = None, stdin=None, stdout=None):
    """Serve until stdin ends; returns the (shut down) router."""
    args = build_parser().parse_args(argv)
    refuse_later_slices(args)
    if not args.fault_spec:
        return _serve(args, stdin, stdout)
    from transformer_tpu_torch.serve import resilience

    with resilience.active(resilience.FaultPlane.parse(args.fault_spec)):
        print(f"fault plane armed: {args.fault_spec}", file=sys.stderr)
        return _serve(args, stdin, stdout)


def _serve(args: argparse.Namespace, stdin, stdout):
    from transformer_tpu_torch.cli.train import flags_to_telemetry

    telemetry = flags_to_telemetry(args, lambda msg: print(msg, file=sys.stderr))
    if args.standby:
        # The warm standby: tail the primary's journal until its heartbeat
        # goes silent, adopt the fleet, then serve this process's stdin.
        standby = build_standby(args, telemetry)
        print(f"standby up: tailing {args.standby} (takeover after "
              f"{args.takeover_after:.1f}s of silence)", file=sys.stderr)
        router = standby.run_until_takeover()
        print(f"adopted the fleet as epoch {router.epoch}: {standby.stats}", file=sys.stderr)
    else:
        router = build_router(args, telemetry)
        print(
            f"router up: {len(router.links)} replica(s) x {args.serve_slots} slots, affinity "
            f"block {args.affinity_block or args.prefix_block}"
            f"{', disaggregated prefill/decode' if args.disaggregate else ''}"
            f"{', supervised' if args.supervise else ''}"
            f"{', HA journal on' if args.ha else ''}", file=sys.stderr,
        )
    try:
        if args.upgrade and not args.standby:
            status = router.start_upgrade(args.upgrade)
            if status.get("ok"):
                print(f"rolling upgrade started: {args.upgrade} -> version "
                      f"{status.get('version')}", file=sys.stderr)
            else:
                print(f"upgrade refused: {status.get('error')}", file=sys.stderr)
        q: queue.Queue = queue.Queue(
            maxsize=max(1, args.serve_slots * max(1, len(router.links))) * 8
        )
        stream = stdin or sys.stdin

        def reader():
            for line in stream:
                q.put(line)
            q.put(None)

        threading.Thread(target=reader, daemon=True).start()
        route_lines(q, router, stdout or sys.stdout)
    finally:
        router.shutdown()
        if telemetry is not None:
            telemetry.close()
    return router


def run() -> int:
    """Console-script entry point: serve, then exit with status 0."""
    main()
    return 0


if __name__ == "__main__":
    sys.exit(run())
