"""``python -m transformer_tpu_torch.obs <summarize|trace|slo|roofline|postmortem>``
— telemetry CLI.

Port of ``transformer_tpu/obs/__main__.py`` (standard library only). It
reads the event logs of either package and renders them byte for byte as
the JAX package's CLI does (so its wording is the JAX package's: "jit
programs compiled" counts the port's captured CUDA graphs).

- ``summarize`` aggregates a structured event log into the
  operator-facing numbers: tokens/s, step p50/p95, slot utilization, the
  per-request latency breakdown (queue → prefill → first-token → total),
  the ``perf:`` rows of the program profiler, SLOs and the fleet. Works
  on logs from a train run, a serve session, or a file that interleaves
  both (the aggregator keys on ``kind``).
- ``trace`` exports ``trace.span`` events (the ``--trace`` flag's output)
  to Chrome trace-event JSON — load the file in chrome://tracing or
  ui.perfetto.dev; one lane per serve slot plus scheduler/intake/train.
- ``slo`` evaluates declarative SLOs (``obs/slo.py``) as multi-window burn
  rates over the same log.
- ``roofline`` joins an episode's measured per-program histograms
  (``obs/profile.py``, the ``perf_seconds_*`` stream) against predictions
  (``--costs``, ``python -m transformer_tpu_torch.analysis costs
  --format=json``'s shape, the JAX package's)
  and the banked baseline. ``--check`` exits 1 on a banked-band breach;
  ``--update`` re-banks the measured p50s.
- ``postmortem`` reconstructs a fleet's last seconds from any mix of
  event logs, ``*.flight.json`` flight-recorder dumps, and the flight
  records the Supervisor embedded in ``route.postmortem`` events.

All accept MULTIPLE jsonl files (``--merge``): events are tagged with
their source and clock-aligned via per-file skew estimation
(``obs/merge.py``). ``--since TS`` / ``--last N{s,m,h}`` slice long logs.
Host-only: it runs anywhere, on logs copied off the card's machine.
"""

from __future__ import annotations

import argparse
import json
import sys

from transformer_tpu_torch.obs.merge import filter_events, merge_events, parse_duration
from transformer_tpu_torch.obs.profile import (
    BASELINE_PATH,
    band_breaches,
    load_baseline,
    measured_from_events,
    predictions_by_program,
    roofline_report,
    write_baseline,
)
from transformer_tpu_torch.obs.quantiles import StreamingHistogram


def _fmt_s(seconds: float) -> str:
    if seconds >= 1.0:
        return f"{seconds:.2f}s"
    return f"{seconds * 1e3:.1f}ms"


def _span_quantiles(reqs: list[dict], field: str) -> dict | None:
    h = StreamingHistogram()
    for r in reqs:
        v = r.get(field)
        if isinstance(v, (int, float)) and v >= 0:
            h.observe(v)
    return h.snapshot() if h.count else None


def summarize_events(events: list[dict]) -> dict:
    """Event list -> JSON-able report (the text renderer formats this)."""
    report: dict = {"events": len(events)}

    # ---- serve: per-request spans ----------------------------------------
    reqs = [e for e in events if e.get("kind") == "serve.request"]
    if reqs:
        ok = [r for r in reqs if "error" not in r]
        spans = {}
        for field in ("queue_s", "prefill_s", "ttft_s", "total_s"):
            q = _span_quantiles(ok, field)
            if q:
                spans[field] = q
        gen_tokens = sum(int(r.get("new_tokens", 0)) for r in ok)
        busy_s = sum(
            float(r["total_s"]) for r in ok
            if isinstance(r.get("total_s"), (int, float))
        )
        report["serve"] = {
            "requests": len(reqs),
            "errors": len(reqs) - len(ok),
            "generated_tokens": gen_tokens,
            "spans": spans,
            # In-flight tokens/s: generated tokens over summed per-request
            # residency. With N slots busy the wall-clock rate is ~N× this.
            "tokens_per_request_second": (
                round(gen_tokens / busy_s, 2) if busy_s > 0 else None
            ),
        }
        # Speculative decoding: tokens per target-model decode forward
        # (the number speculation exists to raise past 1.0) and draft
        # acceptance. Spans carry "forwards" whenever the scheduler
        # recorded them, so tokens-per-forward is comparable with
        # speculation on OR off.
        forwards = sum(int(r.get("forwards", 0)) for r in ok)
        if forwards:
            report["serve"]["tokens_per_forward"] = round(
                gen_tokens / forwards, 3
            )
        # Prefix cache: prompt tokens restored from stored KV blocks
        # instead of a prefill forward. Spans carry prefix_hit_tokens
        # (zero on misses) only for requests that PARTICIPATED, so the
        # hit rate's denominator excludes opted-out traffic.
        prefix_reqs = [r for r in ok if "prefix_hit_tokens" in r]
        if prefix_reqs:
            hit = sum(int(r["prefix_hit_tokens"]) for r in prefix_reqs)
            prompt = sum(int(r.get("prompt_tokens", 0)) for r in prefix_reqs)
            report["serve"]["prefix_cache"] = {
                "requests": len(prefix_reqs),
                "hit_tokens": hit,
                "prompt_tokens": prompt,
                "hit_rate": round(hit / prompt, 4) if prompt else None,
            }
        drafted = sum(int(r.get("drafted", 0)) for r in ok)
        if drafted:
            accepted = sum(int(r.get("draft_accepted", 0)) for r in ok)
            rate_h = StreamingHistogram()
            for r in ok:
                d = int(r.get("drafted", 0))
                if d > 0:
                    rate_h.observe(int(r.get("draft_accepted", 0)) / d)
            report["serve"]["speculative"] = {
                "drafted": drafted,
                "accepted": accepted,
                "acceptance_rate": round(accepted / drafted, 4),
                # Per-request acceptance-rate spread (p50/p95/... over
                # requests that drafted at least once).
                "request_acceptance": rate_h.snapshot(),
            }

    # ---- serve: circuit breakers (degraded time) -------------------------
    transitions = [e for e in events if e.get("kind") == "serve.breaker"]
    if transitions:
        per_name: dict[str, list[dict]] = {}
        for t in transitions:
            name = t.get("name")
            if isinstance(name, str) and isinstance(t.get("ts"), (int, float)):
                per_name.setdefault(name, []).append(t)
        last_ts = max(
            (e["ts"] for e in events if isinstance(e.get("ts"), (int, float))),
            default=0.0,
        )
        breakers = {}
        for name, ts in sorted(per_name.items()):
            ts.sort(key=lambda t: t["ts"])
            degraded = 0.0
            degraded_since = None
            opens = 0
            for t in ts:
                state = t.get("state")
                if state in ("open", "half_open"):
                    if state == "open":
                        opens += 1
                    if degraded_since is None:
                        degraded_since = t["ts"]
                elif state == "closed" and degraded_since is not None:
                    degraded += t["ts"] - degraded_since
                    degraded_since = None
            if degraded_since is not None:
                # Still degraded at end-of-log: count up to the last event.
                degraded += max(0.0, last_ts - degraded_since)
            breakers[name] = {
                "opens": opens,
                "degraded_s": round(degraded, 6),
                "final_state": ts[-1].get("state"),
            }
        if breakers:
            report.setdefault("serve", {})["breakers"] = breakers

    # ---- router: multi-replica dispatch / failover ------------------------
    dispatches = [e for e in events if e.get("kind") == "route.dispatch"]
    failovers = [e for e in events if e.get("kind") == "route.failover"]
    if dispatches or failovers:
        per_replica: dict[str, int] = {}
        redispatches = 0
        for d in dispatches:
            name = str(d.get("replica"))
            if int(d.get("redispatch", 0) or 0) > 0:
                redispatches += 1
                continue  # request share counts FIRST dispatches only
            if d.get("stage") == "prefill":
                continue  # disaggregated stage 1: the request's share is
                #           attributed to the replica that DECODES it
            per_replica[name] = per_replica.get(name, 0) + 1
        total = sum(per_replica.values())
        report["router"] = {
            "dispatches": len(dispatches),
            "requests": total,
            "redispatches": redispatches,
            "failovers": len(failovers),
            "failed_over_requests": sum(
                len(f.get("orders", ())) for f in failovers
            ),
            "replicas": {
                name: {
                    "requests": n,
                    "share": round(n / total, 4) if total else None,
                }
                for name, n in sorted(per_replica.items())
            },
        }

    # ---- fleet: supervision / autoscaling / router HA ---------------------
    spawns = [e for e in events if e.get("kind") == "route.spawn"]
    retires = [e for e in events if e.get("kind") == "route.retire"]
    scales = [e for e in events if e.get("kind") == "route.scale"]
    takeovers = [e for e in events if e.get("kind") == "route.takeover"]
    if spawns or retires or scales or takeovers:
        heals = [
            e["heal_s"] for e in spawns
            if isinstance(e.get("heal_s"), (int, float))
        ]
        fleet: dict = {
            "respawns": sum(
                1 for e in spawns
                if not e.get("gave_up") and not e.get("scale_up")
            ),
            "gave_up": sum(1 for e in spawns if e.get("gave_up")),
            "warmed_tokens": sum(
                int(e.get("warmed_tokens", 0) or 0) for e in spawns
            ),
            "scale_ups": sum(
                1 for e in scales if e.get("direction") == "up"
            ),
            "scale_downs": sum(
                1 for e in scales if e.get("direction") == "down"
            ),
            "retired": len(retires),
            "takeovers": len(takeovers),
        }
        if heals:
            fleet["time_to_heal_s"] = {
                "count": len(heals),
                "mean": round(sum(heals) / len(heals), 6),
                "max": round(max(heals), 6),
            }
        if scales:
            last = scales[-1]
            fleet["final_fleet_size"] = last.get("fleet_size")
            fleet["last_scale_evidence"] = last.get("evidence")
        if takeovers:
            t = takeovers[-1]
            fleet["takeover"] = {
                k: t.get(k)
                for k in (
                    "epoch", "adopted", "failed", "recovered_answers",
                    "reowned_inflight", "redispatched", "delivered_upto",
                )
                if t.get(k) is not None
            }
        report["fleet"] = fleet

    # ---- upgrade: live-weights rollouts (serve/upgrade.py) ----------------
    upgrades = [e for e in events if e.get("kind") == "route.upgrade"]
    canaries = [e for e in events if e.get("kind") == "route.canary"]
    if upgrades or canaries:
        completed = [e for e in upgrades if e.get("phase") == "completed"]
        rollbacks = [e for e in upgrades if e.get("rolled_back")]
        per_version: dict[str, int] = {}
        for d in dispatches:
            if int(d.get("redispatch", 0) or 0) > 0:
                continue
            if d.get("stage") == "prefill":
                continue
            wv = d.get("weight_version")
            if wv is not None:
                per_version[str(wv)] = per_version.get(str(wv), 0) + 1
        total_v = sum(per_version.values())
        up: dict = {
            "started": sum(1 for e in upgrades if e.get("phase") == "started"),
            "completed": len(completed),
            "rejected": sum(
                1 for e in upgrades if e.get("phase") == "rejected"
            ),
            "rollbacks": len(rollbacks),
            "replicas_swapped": sum(
                1 for e in upgrades if e.get("phase") == "swapped"
            ),
            "per_version_requests": {
                v: {
                    "requests": n,
                    "share": round(n / total_v, 4) if total_v else None,
                }
                for v, n in sorted(per_version.items())
            },
        }
        if completed:
            up["time_to_upgrade_s"] = completed[-1].get("time_to_upgrade_s")
            up["version"] = completed[-1].get("version")
        if rollbacks:
            up["rollback"] = {
                k: rollbacks[-1].get(k)
                for k in ("version", "reason", "evidence")
                if rollbacks[-1].get(k) is not None
            }
        promoted = [c for c in canaries if c.get("phase") == "promoted"]
        started_c = [c for c in canaries if c.get("phase") == "started"]
        if started_c:
            up["canary"] = {
                "replica": started_c[-1].get("replica"),
                "every": started_c[-1].get("every"),
                "window_s": started_c[-1].get("window_s"),
                "promoted": bool(promoted),
                "requests": (
                    promoted[-1].get("requests") if promoted else None
                ),
            }
        report["upgrade"] = up

    # ---- serve: grouped-path batches --------------------------------------
    batches = [e for e in events if e.get("kind") == "serve.batch"]
    if batches:
        h = StreamingHistogram()
        for b in batches:
            v = b.get("batch_s")
            if isinstance(v, (int, float)) and v >= 0:
                h.observe(v)
        report["serve_grouped"] = {
            "batches": len(batches),
            "requests": sum(int(b.get("size", 0)) for b in batches),
            "errors": sum(int(b.get("errors", 0)) for b in batches),
            "batch_s": h.snapshot() if h.count else None,
        }

    # ---- serve: slot utilization from metric snapshots -------------------
    snaps = [e for e in events if e.get("kind") == "metrics.snapshot"]
    if snaps:
        # A crash-truncated final line never parses (read_events skips it),
        # but a snapshot written by a DIFFERENT/older producer can carry a
        # non-dict metrics payload — tolerate, never raise (the summarize
        # CLI must work on exactly the logs crashes leave behind).
        snaps = [s for s in snaps if isinstance(s.get("metrics"), dict)]
    if snaps:
        utils = []
        for s in snaps:
            m = s.get("metrics", {})
            active, total = m.get("serve_slots_active"), m.get("serve_slots_total")
            if isinstance(active, (int, float)) and total:
                utils.append(active / total)
        if utils:
            report.setdefault("serve", {})["slot_utilization"] = {
                "mean": round(sum(utils) / len(utils), 4),
                "max": round(max(utils), 4),
                "samples": len(utils),
            }
        last = snaps[-1].get("metrics", {})
        step_hist = last.get("serve_step_seconds")
        if isinstance(step_hist, dict) and step_hist.get("count"):
            report.setdefault("serve", {})["step_seconds"] = step_hist
        # Paged KV pool utilization (--kv_layout paged): block occupancy
        # over the run from the used/free gauges, plus the aliased-vs-
        # host-restored split of the prefix hit tokens (aliased hits paid
        # ZERO host<->device copies).
        pool_utils = []
        for s in snaps:
            m = s.get("metrics", {})
            used, free = (
                m.get("serve_kv_pool_used_blocks"),
                m.get("serve_kv_pool_free_blocks"),
            )
            if isinstance(used, (int, float)) and isinstance(
                free, (int, float)
            ) and used + free > 0:
                pool_utils.append(used / (used + free))
        if pool_utils:
            kv_pool = {
                "used_blocks": last.get("serve_kv_pool_used_blocks"),
                "free_blocks": last.get("serve_kv_pool_free_blocks"),
                "utilization_mean": round(
                    sum(pool_utils) / len(pool_utils), 4
                ),
                "utilization_max": round(max(pool_utils), 4),
                "samples": len(pool_utils),
            }
            alias = last.get("serve_prefix_alias_tokens_total")
            hit = last.get("serve_prefix_hit_tokens_total")
            if isinstance(alias, (int, float)) and isinstance(
                hit, (int, float)
            ):
                kv_pool["alias_tokens"] = int(alias)
                kv_pool["host_restored_tokens"] = int(hit - alias)
                if hit:
                    kv_pool["alias_rate"] = round(alias / hit, 4)
            report.setdefault("serve", {})["kv_pool"] = kv_pool

    # ---- train: throughput + step-time quantiles -------------------------
    windows = [e for e in events if e.get("kind") == "train.window"]
    if windows:
        steps = sum(int(w.get("steps", 0)) for w in windows)
        tokens = sum(int(w.get("tokens", 0)) for w in windows)
        wall = sum(float(w.get("window_s", 0.0)) for w in windows)
        h = StreamingHistogram()
        for w in windows:
            n = int(w.get("steps", 0))
            ws = float(w.get("window_s", 0.0))
            if n > 0 and ws > 0:
                # A window's wall time, attributed evenly to its steps —
                # the same accounting StepTimer.sync() uses.
                h.observe(ws / n, n=n)
        last = windows[-1]
        report["train"] = {
            "windows": len(windows),
            "steps": steps,
            "tokens": tokens,
            "tokens_per_sec": round(tokens / wall, 1) if wall > 0 else None,
            "steps_per_sec": round(steps / wall, 2) if wall > 0 else None,
            "step_seconds": h.snapshot() if h.count else None,
            "final": {
                k: last[k]
                for k in ("loss", "accuracy", "grad_norm", "step")
                if k in last
            },
        }
        compiles = [e for e in events if e.get("kind") == "train.compile"]
        if compiles:
            report["train"]["compiles"] = compiles[-1].get("cache_sizes")

    # ---- train: measured memory vs the cost model's prediction -----------
    # The trainer records device.memory_stats() samples (train.memory) and,
    # when the jaxpr cost model could price its step, one train.predicted
    # event. Either side may be absent (older logs, un-traceable configs,
    # backends without allocator stats) — report what exists, never raise.
    mem = [e for e in events if e.get("kind") == "train.memory"]
    if mem:
        report.setdefault("train", {})["memory"] = mem[-1].get(
            "devices", mem[-1].get("stats")
        )
    predicted = [e for e in events if e.get("kind") == "train.predicted"]
    if predicted:
        p = predicted[-1]
        entry = {
            k: p[k]
            for k in ("peak_bytes", "flops", "bytes_moved", "tokens_per_step")
            if isinstance(p.get(k), (int, float))
        }
        measured = None
        for e in mem:
            devices = e.get("devices")
            if not isinstance(devices, dict):
                continue
            for stats in devices.values():
                if isinstance(stats, dict) and isinstance(
                    stats.get("peak_bytes_in_use"), (int, float)
                ):
                    peak = stats["peak_bytes_in_use"]
                    measured = peak if measured is None else max(measured, peak)
        if measured is not None:
            entry["measured_peak_bytes"] = measured
            if entry.get("peak_bytes"):
                # > 1: the allocator holds more than the model predicts
                # (fragmentation, workspace, other programs); << 1 or >> 1
                # drift over rounds is the regression signal.
                entry["measured_over_predicted"] = round(
                    measured / entry["peak_bytes"], 3
                )
        if entry:
            report.setdefault("train", {})["predicted"] = entry

    # ---- perf: measured programs vs the cost model (obs/profile.py) ------
    # The profiler's per-program histograms ride metrics.snapshot; join
    # them against the banked baseline's frozen predictions. Tolerant when
    # either side is absent: no profiler stream -> no section; an unbanked
    # program rows without the bytes/drift columns. `obs roofline` is the
    # full report (this section skips the --costs join).
    perf = roofline_report(events)
    if perf.get("programs"):
        report["perf"] = perf

    # ---- bench attribution ----------------------------------------------
    bench = [e for e in events if str(e.get("kind", "")).startswith("bench.")]
    if bench:
        counts: dict[str, int] = {}
        for e in bench:
            counts[e["kind"]] = counts.get(e["kind"], 0) + 1
        report["bench"] = counts

    # ---- tracing (span volume only; `obs trace` renders the timeline) ----
    spans = [e for e in events if e.get("kind") == "trace.span"]
    if spans:
        traces = {e.get("trace") for e in spans}
        report["tracing"] = {"spans": len(spans), "traces": len(traces)}

    # ---- SLO breach transitions ------------------------------------------
    burns = [e for e in events if e.get("kind") == "slo.burn"]
    if burns:
        slo: dict[str, dict] = {}
        for e in burns:
            name = str(e.get("name"))
            entry = slo.setdefault(name, {"breaches": 0})
            if e.get("breached"):
                entry["breaches"] += 1
            entry["final_breached"] = bool(e.get("breached"))
        report["slo_transitions"] = slo

    return report


def render_text(report: dict) -> str:
    lines = [f"{report['events']} events"]
    serve = report.get("serve")
    if serve:
        # A serve section can exist with only snapshot-derived fields (a
        # session scraped before any request finished) — .get throughout.
        lines.append(
            f"serve: {serve.get('requests', 0)} requests "
            f"({serve.get('errors', 0)} errored), "
            f"{serve.get('generated_tokens', 0)} tokens generated"
        )
        util = serve.get("slot_utilization")
        if util:
            lines.append(
                f"  slot utilization: mean {util['mean'] * 100:.1f}%, "
                f"max {util['max'] * 100:.1f}% over {util['samples']} samples"
            )
        if serve.get("tokens_per_request_second"):
            lines.append(
                f"  decode rate: {serve['tokens_per_request_second']} "
                "tokens/s per in-flight request"
            )
        if serve.get("tokens_per_forward"):
            lines.append(
                f"  tokens/forward: {serve['tokens_per_forward']}"
            )
        pc = serve.get("prefix_cache")
        if pc:
            rate = (
                f" ({pc['hit_rate'] * 100:.1f}% hit rate)"
                if pc.get("hit_rate") is not None else ""
            )
            lines.append(
                f"  prefix cache: {pc['hit_tokens']}/{pc['prompt_tokens']} "
                f"prompt tokens reused{rate} over {pc['requests']} requests"
            )
        kv = serve.get("kv_pool")
        if kv:
            lines.append(
                f"  kv pool: {kv.get('used_blocks')} used / "
                f"{kv.get('free_blocks')} free blocks, utilization mean "
                f"{kv['utilization_mean'] * 100:.1f}% max "
                f"{kv['utilization_max'] * 100:.1f}% over "
                f"{kv['samples']} samples"
            )
            if kv.get("alias_tokens") is not None:
                rate = (
                    f" ({kv['alias_rate'] * 100:.1f}% aliased)"
                    if kv.get("alias_rate") is not None else ""
                )
                lines.append(
                    f"  prefix restore split: {kv['alias_tokens']} tokens "
                    f"device-aliased (zero copies) vs "
                    f"{kv['host_restored_tokens']} host-restored{rate}"
                )
        spec = serve.get("speculative")
        if spec:
            q = spec.get("request_acceptance") or {}
            spread = (
                f" (per-request p50 {q['p50'] * 100:.0f}%)" if q else ""
            )
            lines.append(
                f"  speculative: {spec['accepted']}/{spec['drafted']} drafts "
                f"accepted ({spec['acceptance_rate'] * 100:.1f}%){spread}"
            )
        for field, label in (
            ("queue_s", "queue"), ("prefill_s", "prefill"),
            ("ttft_s", "first token"), ("total_s", "total"),
        ):
            q = serve.get("spans", {}).get(field)
            if q:
                lines.append(
                    f"  {label:>11}: p50 {_fmt_s(q['p50'])}  "
                    f"p95 {_fmt_s(q['p95'])}  p99 {_fmt_s(q['p99'])}  "
                    f"max {_fmt_s(q['max'])}"
                )
        step = serve.get("step_seconds")
        if step:
            lines.append(
                f"  scheduler step: p50 {_fmt_s(step['p50'])}  "
                f"p95 {_fmt_s(step['p95'])} over {step['count']} steps"
            )
        brk = serve.get("breakers")
        if brk:
            parts = [
                f"{name} {b['opens']} open(s), "
                f"{_fmt_s(b['degraded_s'])} degraded"
                + ("" if b.get("final_state") == "closed"
                   else f" [{b.get('final_state')}]")
                for name, b in sorted(brk.items())
            ]
            lines.append("  breakers: " + "; ".join(parts))
    router = report.get("router")
    if router:
        line = (
            f"router: {router['requests']} requests over "
            f"{len(router['replicas'])} replica(s)"
        )
        if router.get("failovers"):
            line += (
                f"; {router['failovers']} failover(s), "
                f"{router['failed_over_requests']} request(s) failed over, "
                f"{router['redispatches']} redispatched"
            )
        lines.append(line)
        for name, rep in sorted(router["replicas"].items()):
            share = (
                f" ({rep['share'] * 100:.1f}%)"
                if rep.get("share") is not None else ""
            )
            lines.append(f"  {name}: {rep['requests']} requests{share}")
    fleet = report.get("fleet")
    if fleet:
        parts = []
        if fleet.get("respawns"):
            h = fleet.get("time_to_heal_s")
            heal = (
                f" (time-to-heal mean {_fmt_s(h['mean'])}, "
                f"max {_fmt_s(h['max'])})" if h else ""
            )
            parts.append(f"{fleet['respawns']} respawn(s){heal}")
        if fleet.get("warmed_tokens"):
            parts.append(f"{fleet['warmed_tokens']} cache tokens warmed")
        if fleet.get("gave_up"):
            parts.append(f"{fleet['gave_up']} crash-loop give-up(s)")
        if fleet.get("scale_ups") or fleet.get("scale_downs"):
            part = (
                f"scaled up x{fleet['scale_ups']}, "
                f"down x{fleet['scale_downs']}"
            )
            if fleet.get("final_fleet_size") is not None:
                part += f" (final fleet {fleet['final_fleet_size']})"
            parts.append(part)
        if fleet.get("retired"):
            parts.append(f"{fleet['retired']} retired")
        if fleet.get("takeovers"):
            t = fleet.get("takeover", {})
            part = f"{fleet['takeovers']} router takeover(s)"
            if t:
                part += (
                    f" [epoch {t.get('epoch')}: "
                    f"{t.get('recovered_answers', 0)} recovered, "
                    f"{t.get('reowned_inflight', 0)} re-owned, "
                    f"{t.get('redispatched', 0)} re-dispatched]"
                )
            parts.append(part)
        lines.append("fleet: " + "; ".join(parts))
    upgrade = report.get("upgrade")
    if upgrade:
        parts = []
        if upgrade.get("completed"):
            part = f"{upgrade['completed']} rollout(s) completed"
            if upgrade.get("time_to_upgrade_s") is not None:
                part += (
                    f" (last {_fmt_s(upgrade['time_to_upgrade_s'])} "
                    f"to version {upgrade.get('version')})"
                )
            parts.append(part)
        elif upgrade.get("started"):
            parts.append(f"{upgrade['started']} rollout(s) started")
        if upgrade.get("rollbacks"):
            rb = upgrade.get("rollback", {})
            part = f"{upgrade['rollbacks']} rolled back"
            if rb.get("reason"):
                part += f" ({rb['reason']})"
            parts.append(part)
        if upgrade.get("rejected"):
            parts.append(f"{upgrade['rejected']} rejected at verification")
        canary = upgrade.get("canary")
        if canary:
            verdict = "promoted" if canary.get("promoted") else "pending"
            parts.append(
                f"canary {canary.get('replica')} every "
                f"{canary.get('every')}th order, {verdict}"
            )
        lines.append("upgrade: " + "; ".join(parts))
        for v, rep in upgrade.get("per_version_requests", {}).items():
            share = (
                f" ({rep['share'] * 100:.1f}%)"
                if rep.get("share") is not None else ""
            )
            lines.append(f"  version {v}: {rep['requests']} requests{share}")
    grouped = report.get("serve_grouped")
    if grouped:
        line = (
            f"serve (grouped): {grouped['requests']} requests "
            f"({grouped['errors']} errored) in {grouped['batches']} batches"
        )
        if grouped.get("batch_s"):
            q = grouped["batch_s"]
            line += f"; batch p50 {_fmt_s(q['p50'])}  p95 {_fmt_s(q['p95'])}"
        lines.append(line)
    train = report.get("train")
    if train:
        tps = train.get("tokens_per_sec")
        lines.append(
            f"train: {train.get('steps', 0)} steps, "
            f"{train.get('tokens', 0)} tokens"
            + (f", {tps:,.0f} tokens/s" if tps else "")
        )
        step = train.get("step_seconds")
        if step:
            lines.append(
                f"  step time: p50 {_fmt_s(step['p50'])}  "
                f"p95 {_fmt_s(step['p95'])}  p99 {_fmt_s(step['p99'])}"
            )
        final = train.get("final", {})
        if final:
            parts = [f"{k} {final[k]:.4f}" if isinstance(final[k], float)
                     else f"{k} {final[k]}" for k in sorted(final)]
            lines.append("  final: " + ", ".join(parts))
        if train.get("compiles"):
            total = sum(train["compiles"].values())
            lines.append(f"  jit programs compiled: {total} {train['compiles']}")
        if train.get("memory"):
            lines.append(f"  device memory: {train['memory']}")
        pred = train.get("predicted")
        if pred:
            line = f"  cost model: predicted peak {pred.get('peak_bytes', '?')}B/step"
            if pred.get("measured_peak_bytes") is not None:
                line += f", measured peak {pred['measured_peak_bytes']}B"
            if pred.get("measured_over_predicted") is not None:
                line += f" (measured/predicted {pred['measured_over_predicted']}x)"
            lines.append(line)
    perf = report.get("perf")
    if perf:
        lines.append(
            f"perf: {len(perf['programs'])} measured program(s) "
            "(`obs roofline` renders the full join)"
        )
        for r in perf["programs"]:
            line = (
                f"  {r['program']}: p50 {r['p50_ms']:.3f}ms "
                f"over {r['dispatches']} dispatches"
            )
            if r.get("measured_tokens_per_s"):
                line += f", {r['measured_tokens_per_s']} tokens/s"
            if r.get("roofline_ratio") is not None:
                line += f", roofline {r['roofline_ratio']}"
            if r.get("drift") is not None:
                line += f", drift {r['drift']}x" + (
                    "" if r.get("in_band", True) else " OUT OF BAND"
                )
            lines.append(line)
    bench = report.get("bench")
    if bench:
        lines.append(
            "bench: " + ", ".join(f"{k.split('.', 1)[1]} x{v}"
                                  for k, v in sorted(bench.items()))
        )
    tracing = report.get("tracing")
    if tracing:
        lines.append(
            f"tracing: {tracing['spans']} spans across {tracing['traces']} "
            "traces (`obs trace` exports the timeline)"
        )
    slo = report.get("slo_transitions")
    if slo:
        parts = [
            f"{name} {s['breaches']} breach(es)"
            + (" [still breached]" if s.get("final_breached") else "")
            for name, s in sorted(slo.items())
        ]
        lines.append("slo: " + "; ".join(parts))
    sources = report.get("sources")
    if sources:
        parts = [
            f"{name} ({s['events']} events"
            + (f", skew {s['skew_s']:+g}s" if s.get("skew_s") else "")
            + ")"
            for name, s in sorted(sources.items())
        ]
        lines.append("sources: " + "; ".join(parts))
    if len(lines) == 1:
        lines.append("no serve/train/bench telemetry kinds found")
    return "\n".join(lines)


def render_roofline_text(report: dict) -> str:
    rows = report.get("programs", [])
    lines = [
        f"{len(rows)} measured program(s); roofline peak "
        f"{report.get('peak_bytes_per_s', 0):.4g} B/s"
    ]
    for r in rows:
        line = (
            f"  {r['program']}: p50 {r['p50_ms']:.3f}ms "
            f"p95 {r['p95_ms']:.3f}ms over {r['dispatches']} dispatches"
        )
        if r.get("measured_tokens_per_s"):
            line += f", {r['measured_tokens_per_s']} tokens/s"
        if r.get("predicted_bytes_moved"):
            line += (
                f"; predicted {r['predicted_bytes_moved']}B moved -> "
                f"{r['effective_bytes_per_s']:.4g} B/s effective, "
                f"roofline {r['roofline_ratio']}"
            )
        if r.get("measured_over_predicted_tokens") is not None:
            line += (
                f"; measured/predicted tokens/s "
                f"{r['measured_over_predicted_tokens']}x"
            )
        if r.get("drift") is not None:
            verdict = "in band" if r.get("in_band") else "OUT OF BAND"
            line += f"; drift {r['drift']}x {r.get('band')} {verdict}"
        lines.append(line)
    if len(lines) == 1:
        lines.append(
            "no perf_seconds_* histograms found (profiler not armed, or "
            "no metrics.snapshot flushed?)"
        )
    return "\n".join(lines)


def _flight_doc(path: str) -> dict | None:
    """json.load the whole file: a flight dump is ONE dict carrying an
    ``events`` ring and no top-level ``kind`` — anything else (a JSONL
    log, a torn file) is not a dump and falls back to the merge path."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if (
        isinstance(doc, dict)
        and isinstance(doc.get("events"), list)
        and "kind" not in doc
    ):
        return doc
    return None


def postmortem_report(
    events: list[dict], flights: list[dict], info: dict | None = None
) -> dict:
    """Fuse merged event logs, standalone flight dumps, and the records
    embedded in ``route.postmortem`` events into one fleet timeline plus
    a per-victim postmortem table (their final ``serve.request`` spans
    are the rows an incident review reads first)."""
    timeline = [dict(e) for e in events]
    postmortems: list[dict] = []

    def ingest(record: dict, replica: str, origin: str) -> None:
        ring_events = [
            e for e in (record.get("events") or []) if isinstance(e, dict)
        ]
        ring_spans = [
            s for s in (record.get("spans") or []) if isinstance(s, dict)
        ]
        for entry in ring_events + ring_spans:
            tagged = dict(entry)
            tagged["source"] = f"postmortem:{replica}"
            timeline.append(tagged)
        reqs = [e for e in ring_events if e.get("kind") == "serve.request"]
        postmortems.append({
            "replica": replica,
            "origin": origin,
            "reason": record.get("reason"),
            "ts": record.get("ts"),
            "pid": record.get("pid"),
            "events": len(ring_events),
            "spans": len(ring_spans),
            "final_requests": reqs[-5:],
        })

    for e in events:
        if e.get("kind") == "route.postmortem" and isinstance(
            e.get("record"), dict
        ):
            ingest(e["record"], str(e.get("replica")), str(e.get("origin")))
    for doc in flights:
        ingest(doc, str(doc.get("source") or doc.get("pid") or "?"), "file")

    timeline = [t for t in timeline if isinstance(t.get("ts"), (int, float))]
    timeline.sort(key=lambda t: t["ts"])
    report = {
        "events": len(events),
        "flight_files": len(flights),
        "postmortems": postmortems,
        "timeline": timeline[-80:],
    }
    if info:
        report.update(info)
    return report


def render_postmortem_text(report: dict) -> str:
    pms = report.get("postmortems", [])
    lines = [
        f"{len(pms)} postmortem(s) over {report.get('events', 0)} log "
        f"event(s) + {report.get('flight_files', 0)} flight dump file(s)"
    ]
    for p in pms:
        lines.append(
            f"  {p['replica']} [{p['origin']}] reason={p.get('reason')} "
            f"pid={p.get('pid')}: {p['events']} events, {p['spans']} spans, "
            f"{len(p['final_requests'])} final request(s)"
        )
        for r in p["final_requests"]:
            total = r.get("total_s")
            lines.append(
                f"    request order={r.get('order')} "
                f"tokens={r.get('new_tokens')}"
                + (f" total={_fmt_s(total)}"
                   if isinstance(total, (int, float)) else "")
                + (" ERROR" if "error" in r else "")
            )
    tail = report.get("timeline", [])[-15:]
    if tail:
        lines.append("last seconds:")
        for t in tail:
            src = t.get("source")
            lines.append(
                f"  {t['ts']:.3f} "
                + (f"[{src}] " if src else "")
                + str(t.get("kind"))
            )
    sources = report.get("sources")
    if sources:
        parts = [
            f"{name} ({s['events']} events"
            + (f", skew {s['skew_s']:+g}s" if s.get("skew_s") else "")
            + ")"
            for name, s in sorted(sources.items())
        ]
        lines.append("sources: " + "; ".join(parts))
    return "\n".join(lines)


def _add_common_args(p) -> None:
    p.add_argument(
        "jsonl", nargs="+",
        help="event log(s) written via --metrics_jsonl; pass several to "
        "aggregate across processes/replicas",
    )
    p.add_argument(
        "--merge", action="store_true",
        help="treat inputs as a multi-source merge (implied when more than "
        "one file is given): tag events with their source, align clocks "
        "via per-file skew estimation, and report the per-source table "
        "(with one file, forces the source-tagged report)",
    )
    p.add_argument(
        "--no-align", action="store_true",
        help="merge without clock-skew alignment (raw timestamps)",
    )
    p.add_argument(
        "--since", type=float, default=None, metavar="TS",
        help="drop events before this unix timestamp (seconds)",
    )
    p.add_argument(
        "--last", type=str, default=None, metavar="N{s,m,h}",
        help="keep only the trailing window of the log, e.g. 90s / 5m / 2h "
        "(measured back from the newest event)",
    )


def _load(args) -> "tuple[list, dict]":
    """Common input path: read one file or merge several, then apply the
    time-window slice. Returns (events, merge_report)."""
    events, info = merge_events(args.jsonl, align=not args.no_align)
    if args.last is not None:
        events = filter_events(events, last=parse_duration(args.last))
    if args.since is not None:
        events = filter_events(events, since=args.since)
    # The per-source table rides along whenever this IS a merge — more
    # than one input, or --merge forcing the tagged report for one file.
    return events, info if (len(args.jsonl) > 1 or args.merge) else {}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m transformer_tpu_torch.obs",
        description="telemetry tools",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_sum = sub.add_parser(
        "summarize", help="render a run report from JSONL event log(s)"
    )
    _add_common_args(p_sum)
    p_sum.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="output format (json is diff-able across runs)",
    )
    p_trace = sub.add_parser(
        "trace",
        help="export trace.span events to Chrome trace-event JSON "
        "(chrome://tracing / ui.perfetto.dev)",
    )
    _add_common_args(p_trace)
    p_trace.add_argument(
        "--out", default="trace.json",
        help="output path for the trace-event JSON (default: trace.json)",
    )
    p_slo = sub.add_parser(
        "slo", help="evaluate SLO burn rates over the event log(s)"
    )
    _add_common_args(p_slo)
    p_slo.add_argument(
        "--slo_spec", default="",
        help="SLO spec string (obs/slo.py grammar, same as the serve "
        "flag); '' = the default objectives",
    )
    p_slo.add_argument(
        "--format", choices=("text", "json"), default="text",
    )
    p_roof = sub.add_parser(
        "roofline",
        help="measured-vs-predicted per-program report from the profiler "
        "stream (perf_seconds_* histograms in metrics.snapshot)",
    )
    _add_common_args(p_roof)
    p_roof.add_argument(
        "--costs", default=None, metavar="JSON",
        help="predictions document to join (`python -m transformer_tpu_torch.analysis "
        "costs --format=json`'s shape; without it, the banked baseline's "
        "frozen predictions apply)",
    )
    p_roof.add_argument(
        "--baseline", default=BASELINE_PATH,
        help="banked roofline baseline (default: the checked-in "
        "obs/roofline_baseline.json)",
    )
    p_roof.add_argument(
        "--update", action="store_true",
        help="re-bank the episode's measured p50s into --baseline "
        "(absolute times are per card: run on the card that enforces "
        "the band)",
    )
    p_roof.add_argument(
        "--check", action="store_true",
        help="exit 1 when any banked program's measured p50 left its band",
    )
    p_roof.add_argument(
        "--format", choices=("text", "json"), default="text",
    )
    p_pm = sub.add_parser(
        "postmortem",
        help="reconstruct the fleet's last seconds from event logs, "
        "*.flight.json dumps, and route.postmortem records",
    )
    _add_common_args(p_pm)
    p_pm.add_argument(
        "--format", choices=("text", "json"), default="text",
    )
    args = parser.parse_args(argv)

    if args.cmd == "postmortem":
        # Inputs are a MIX of flight dumps (whole-file JSON) and JSONL
        # logs — sniff each before the merge machinery sees it.
        flights, jsonls = [], []
        for path in args.jsonl:
            doc = _flight_doc(path)
            if doc is not None:
                doc.setdefault("source", path)
                flights.append(doc)
            else:
                jsonls.append(path)
        events, info = [], {}
        if jsonls:
            try:
                events, info = merge_events(jsonls, align=not args.no_align)
            except OSError as e:
                print(f"cannot read {', '.join(jsonls)}: {e}", file=sys.stderr)
                return 2
            if args.last is not None:
                events = filter_events(events, last=parse_duration(args.last))
            if args.since is not None:
                events = filter_events(events, since=args.since)
        report = postmortem_report(
            events, flights,
            info if (len(jsonls) > 1 or args.merge) else {},
        )
        if args.format == "json":
            print(json.dumps(report, indent=2, sort_keys=True))
        else:
            print(render_postmortem_text(report))
        return 0

    try:
        events, info = _load(args)
    except OSError as e:
        print(f"cannot read {', '.join(args.jsonl)}: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"bad arguments: {e}", file=sys.stderr)
        return 2

    if args.cmd == "summarize":
        report = summarize_events(events)
        report.update(info)
        if args.format == "json":
            print(json.dumps(report, indent=2, sort_keys=True))
        else:
            print(render_text(report))
        return 0

    if args.cmd == "roofline":
        costs_doc = None
        if args.costs:
            try:
                with open(args.costs, encoding="utf-8") as f:
                    costs_doc = json.load(f)
            except (OSError, ValueError) as e:
                print(f"cannot read --costs {args.costs}: {e}", file=sys.stderr)
                return 2
        if args.update:
            measured = measured_from_events(events)
            if not measured:
                print(
                    "no perf_seconds_* histograms in the episode; "
                    "nothing to bank",
                    file=sys.stderr,
                )
                return 2
            prior = load_baseline(args.baseline)
            # Predictions to freeze next to the banked p50s: a --costs
            # document when given, else whatever the prior bank froze.
            preds = (
                predictions_by_program(costs_doc)
                if costs_doc else dict(prior.get("programs") or {})
            )
            doc = write_baseline(
                args.baseline, measured, predictions=preds,
                peak_bytes_per_s=prior.get("peak_bytes_per_s"),
            )
            print(
                f"banked {len(doc['programs'])} program(s) -> {args.baseline}"
            )
            return 0
        report = roofline_report(
            events, costs=costs_doc, baseline=load_baseline(args.baseline)
        )
        report.update(info)
        if args.format == "json":
            print(json.dumps(report, indent=2, sort_keys=True))
        else:
            print(render_roofline_text(report))
        if args.check:
            breaches = band_breaches(report)
            if breaches:
                for r in breaches:
                    print(
                        f"BAND BREACH {r['program']}: drift {r['drift']}x "
                        f"outside {r['band']}",
                        file=sys.stderr,
                    )
                return 1
        return 0

    if args.cmd == "trace":
        from transformer_tpu_torch.obs.trace import chrome_trace

        doc = chrome_trace(events)
        if info.get("sources"):
            doc["otherData"]["skews"] = {
                name: s["skew_s"] for name, s in info["sources"].items()
            }
        with open(args.out, "w") as f:
            json.dump(doc, f)
        n = doc["otherData"]["spans"]
        if not n:
            print(
                f"warning: no trace.span events found (run with --trace?); "
                f"wrote an empty trace to {args.out}",
                file=sys.stderr,
            )
        else:
            print(
                f"{n} spans from {len(doc['otherData']['sources'])} "
                f"source(s) -> {args.out} (load in chrome://tracing or "
                "ui.perfetto.dev)"
            )
        return 0

    # slo
    from transformer_tpu_torch.obs.slo import (
        DEFAULT_SLOS,
        evaluate_slos,
        parse_slo_spec,
        render_slo_text,
    )

    try:
        specs = parse_slo_spec(args.slo_spec) if args.slo_spec else DEFAULT_SLOS
    except ValueError as e:
        print(f"bad --slo_spec: {e}", file=sys.stderr)
        return 2
    report = evaluate_slos(events, specs)
    if info:
        report.update(info)
    if args.format == "json":
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(render_slo_text(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
