"""The port's serving fleet front end (``transformer_tpu_torch/serve/router.py``
and ``replica.py``) against the JAX package's, ported from
``tests/test_router.py``.

The pure functions (``affinity_key``, ``_rendezvous``,
``parse_router_line``) give JAX's values on the same inputs. The router
core runs the JAX tests' fake-link drills on both packages' routers, fed
the same messages, and must make the same decisions: the same requests
to the same links, the same answers and counters. The subprocess fleets
are the port's worker processes on the CPU, loaded with the JAX spec
model's weights (a JAX-written checkpoint through ``--init_ckpt``); their
greedy answers must be byte-identical to JAX's single
``ContinuousScheduler`` on those weights, through a SIGKILL failover and
through disaggregated prefill/decode. The KV-block wire format
round-trips between the packages. Telemetry: on the same fake-link drill
both packages' routers, each with its own ``obs.Telemetry`` and tracer,
emit the same ``route.*`` kinds with the same fields, the same
``route.request`` spans and the same metric names; a subprocess fleet
with ``--metrics_jsonl`` per replica (``<path>.r<i>``, as ``cli.router``
passes it) and ``--trace`` writes one log a process, whose request spans
join the router's in one trace each.
"""

import json
import os
import signal
import time

import numpy as np
import pytest

from torch_fleet import (
    PACKAGES,
    PROMPT_A,
    PROMPT_B,
    Events,
    both,
    continuations,
    fake_link_class,
    jax_checkpoint,
    jax_model,
    jax_reference,
    port_model,
    spawn_fleet,
    telemetry_of,
    write_spec,
)
from transformer_tpu.serve import router as jrouter
from transformer_tpu_torch.serve import router as trouter

REQS = [{"prompt": PROMPT_A, "max_new": 5}] * 5 + [{"prompt": PROMPT_B, "max_new": 4}] * 5
# A long-budget burst aimed (by affinity) at one replica: the kill window.
BURST = [{"prompt": PROMPT_A, "max_new": 24}] * 12


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    """CPU workers of one intra-op thread each: a fleet's processes must
    not crowd out other tests running beside it on the machine."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def lm():
    return jax_model()


@pytest.fixture(scope="module")
def fleet_files(tmp_path_factory, lm):
    root = tmp_path_factory.mktemp("router")
    return write_spec(root / "spec.json"), jax_checkpoint(root / "ckpt", lm[0])


def _worker(fleet_files, *extra):
    spec, ckpt = fleet_files
    return ["--model_spec", spec, "--init_ckpt", ckpt, "--serve_slots", "2",
            "--heartbeat_ms", "50", "--prefix_cache_mb", "8", "--prefix_block", "4", *extra]


# --------------------------------------------------------------------------
# the pure functions


@pytest.mark.parametrize("block", [1, 4, 16])
def test_affinity_key_and_rendezvous_match_jax(block):
    rng = np.random.default_rng(block)
    for n in (1, 3, 4, 5, 17, 40):
        ids = [int(i) for i in rng.integers(1, 300, n)]
        assert trouter.affinity_key(ids, block) == jrouter.affinity_key(ids, block)
        key = jrouter.affinity_key(ids, block)
        if key is not None:
            for name in ("replica0", "replica1", "f7"):
                assert trouter._rendezvous(key, name) == jrouter._rendezvous(key, name)
    assert trouter.affinity_key([1, 2, 3, 4, 5, 6, 7, 8, 9], 4) == \
        trouter.affinity_key([1, 2, 3, 4, 5, 6, 7, 8, 200], 4)
    assert trouter.affinity_key([1, 2, 3], 4) is None


LINES = [
    "ab cd", '{"prompt": "x", "max_new": 2}', '{"src": "y"}', '{"fill": "y"}',
    '{"beam": 4}', "[1, 2]", '{"prompt": "a", "src": "b"}', "{not json",
]


@pytest.mark.parametrize("line", LINES)
def test_parse_router_line_matches_jax(line):
    def parse(mod):
        try:
            return ("ok", mod.parse_router_line(line))
        except mod._RouterLineError as e:
            return ("routing", str(e))
        except Exception as e:  # noqa: BLE001
            return (type(e).__name__, str(e))

    assert parse(trouter) == parse(jrouter)


# --------------------------------------------------------------------------
# the router core over in-process fake links, both packages


def _fake_router(pkg, n=2, answer=True, **kw):
    Fake = fake_link_class(pkg)
    links = [Fake(i, f"f{i}", answer=answer) for i in range(n)]
    router = pkg.Router(links, **kw)
    for link in links:
        link.router = router
    return router, links


def _sent(links):
    """What each link was sent, less the random trace ids."""
    return [[{k: v for k, v in m.items() if k != "req"} | {"req": {
        k: v for k, v in m.get("req", {}).items() if k != "traceparent"}} for m in l.sent]
        for l in links]


def test_affinity_pins_shared_prefixes():
    def drill(pkg):
        router, links = _fake_router(
            pkg, 2, encode=lambda s: [ord(c) % 40 + 3 for c in s], bos_id=1,
            affinity_block=4, affinity_slack=100,
        )
        out = router.run([{"prompt": "shared system prompt, tail %d" % i} for i in range(6)])
        return out, [l.dispatched for l in links], _sent(links)

    got = both(drill)
    assert got["torch"] == got["jax"]
    assert sorted(got["torch"][1]) == [0, 6]


def test_least_loaded_fallback_when_affine_overloaded():
    def drill(pkg):
        router, links = _fake_router(
            pkg, 2, answer=False, encode=lambda s: [5] * 10, bos_id=1,
            affinity_block=4, affinity_slack=2,
        )
        for _ in range(5):
            router.submit({"prompt": "same prompt"})
        router.pump(timeout=0)
        return [l.dispatched for l in links], _sent(links)

    got = both(drill)
    assert got["torch"] == got["jax"]
    assert all(d > 0 for d in got["torch"][0])
    assert abs(got["torch"][0][0] - got["torch"][0][1]) <= 3


def test_answer_funnel_at_most_once():
    def drill(pkg):
        router, _ = _fake_router(pkg, 1, encode=None)
        order = router.submit({"prompt": "p"})
        router.pump(timeout=0)
        router.pump(timeout=0)
        router.inbox.put((0, {"type": "answer", "rid": order, "resp": {"continuation": "dup"}}))
        router.pump(timeout=0)
        return router.drain_ready(), router.stats["duplicate_answers"], router.stats["answered"]

    got = both(drill)
    assert got["torch"] == got["jax"] == ([{"continuation": "f0"}], 1, 1)


def test_failover_preserves_order_and_bounds_redispatch():
    def drill(pkg):
        router, links = _fake_router(pkg, 2, answer=False, encode=None, max_redispatch=1)
        for _ in range(4):
            router.submit({"prompt": "p"})
        router.pump(timeout=0)
        first = [l for l in links if l.inflight][0]
        survivor = links[1 - first.index]
        victims = sorted(m["rid"] for m in first.sent)
        before = len(survivor.sent)
        first.ok = False
        router.pump(timeout=0)
        moved = [m["rid"] for m in survivor.sent[before:]]
        survivor.ok = False
        out = []
        deadline = time.time() + 10
        while router.busy and time.time() < deadline:
            router.pump(timeout=0)
            out.extend(router.drain_ready())
        return victims, moved, out, router.stats

    got = both(drill)
    assert got["torch"] == got["jax"]
    victims, moved, out, stats = got["torch"]
    assert moved == victims and stats["failovers"] == 2
    assert len(out) == 4 and all(o.get("code") == "transient" for o in out)


def test_late_answer_from_failed_replica_releases_survivor_slot():
    def drill(pkg):
        router, links = _fake_router(pkg, 2, answer=False, encode=None)
        order = router.submit({"prompt": "p"})
        router.pump(timeout=0)
        first = [l for l in links if l.inflight][0]
        survivor = links[1 - first.index]
        first.ok = False
        router.pump(timeout=0)
        trail = [survivor.inflight, router._inflight[order].replica == survivor.index]
        router.inbox.put((first.index, {"type": "answer", "rid": order,
                                        "resp": {"continuation": "late"}}))
        router.pump(timeout=0)
        trail += [router.drain_ready(), survivor.inflight]
        router.inbox.put((survivor.index, {"type": "answer", "rid": order,
                                           "resp": {"continuation": "dup"}}))
        router.pump(timeout=0)
        return trail + [router.stats["duplicate_answers"], survivor.inflight]

    got = both(drill)
    assert got["torch"] == got["jax"] == [1, True, [{"continuation": "late"}], 0, 1, 0]


def test_heartbeat_timeout_failover_then_revival():
    def drill(pkg):
        router, links = _fake_router(pkg, 2, encode=None, heartbeat_timeout_s=0.01,
                                     breaker_cooldown_s=0.0)
        lagger = links[0]
        lagger.last_hb = time.monotonic() - 1.0
        router.pump(timeout=0)
        trail = [lagger.dead, router.stats["failovers"], router.breakers[0].state]
        router.inbox.put((0, {"type": "hb", "backlog": 0, "free": 2, "active": 0}))
        router.pump(timeout=0)
        trail += [lagger.dead, router.stats["revivals"]]
        router.heartbeat_timeout_s = 0.0
        out = router.run([{"prompt": "p"} for _ in range(4)])
        return trail + [len(out), lagger.dispatched > 0, router.breakers[0].state]

    got = both(drill)
    assert got["torch"] == got["jax"] == [True, 1, "open", False, 1, 4, True, "closed"]


def test_disaggregate_decode_death_degrades_to_prefill_worker():
    def drill(pkg):
        Fake = fake_link_class(pkg)
        links = [Fake(0, "pf"), Fake(1, "dec")]
        links[0].role, links[1].role = "prefill", "decode"
        router = pkg.Router(links, encode=None, disaggregate=True)
        for link in links:
            link.router = router
        links[1].ok = False
        router.submit({"prompt": "p"})
        out = []
        deadline = time.time() + 10
        while router.busy and time.time() < deadline:
            router.pump(timeout=0)
            out.extend(router.drain_ready())
        return out, [m["type"] for m in links[0].sent], router.stats["redispatched"]

    got = both(drill)
    assert got["torch"] == got["jax"] == ([{"continuation": "pf"}], ["prefill", "req"], 0)


def test_submit_done_reserves_order():
    def drill(pkg):
        router, _ = _fake_router(pkg, 1, encode=None)
        a = router.submit({"prompt": "p"})
        b = router.submit_done({"error": "LM export serves 'prompt', not 'src'",
                                "code": "routing"})
        c = router.submit({"prompt": "q"})
        return (a, b, c), router.run([])

    got = both(drill)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == (0, 1, 2) and got["torch"][1][1]["code"] == "routing"


def test_router_deadline_expires_in_queue():
    def drill(pkg):
        router, _ = _fake_router(pkg, 1, answer=False, encode=None)
        router.submit({"prompt": "p", "deadline_ms": 0.0})
        time.sleep(0.002)
        router.pump(timeout=0)
        out = router.drain_ready()
        return out[0]["code"], out[0]["error"].split(" after ")[0], router.stats["expired"]

    got = both(drill)
    assert got["torch"] == got["jax"] == (
        "deadline", "deadline_ms elapsed in the router queue", 1)


def test_forwarded_request_carries_trace_and_deadline():
    """The router mints one trace per request (under the client's
    traceparent) and forwards it with the remaining deadline, as JAX's."""
    from transformer_tpu_torch.obs.trace import SpanContext

    parent = SpanContext.new()
    router, links = _fake_router(PACKAGES["torch"], 1, answer=False, encode=None)
    router.submit({"prompt": "p", "traceparent": parent.to_traceparent(),
                   "deadline_ms": 60000})
    router.pump(timeout=0)
    fwd = links[0].sent[0]["req"]
    ctx = SpanContext.from_traceparent(fwd["traceparent"])
    assert ctx.trace_id == parent.trace_id and ctx.span_id != parent.span_id
    assert 0 < fwd["deadline_ms"] <= 60000
    assert SpanContext.from_traceparent("00-" + "0" * 32 + "-" + "1" * 16 + "-01") is None


# --------------------------------------------------------------------------
# the KV-block handoff: the wire format and the scheduler round trip


def test_kv_block_handoff_parity(lm):
    """export_blocks -> JSON wire -> inject_blocks restores the prompt's KV
    into a second port scheduler's PrefixCache: the decode side answers as
    JAX's single scheduler does while restoring real prefix tokens without
    a forward; and a payload JAX exported injects into the port's cache,
    and the port's into JAX's, with the same answers."""
    from transformer_tpu.serve import ContinuousScheduler as JScheduler
    from transformer_tpu.serve import PrefixCache as JCache
    from transformer_tpu.serve.replica import export_blocks as j_export
    from transformer_tpu.serve.replica import inject_blocks as j_inject
    from transformer_tpu_torch.serve.prefix_cache import PrefixCache
    from transformer_tpu_torch.serve.replica import export_blocks, inject_blocks
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    params, cfg, tok = port_model(lm)
    jparams, jcfg, jtok = lm
    prompt = "ab cd ef gh ij kl"
    ids = [tok.bos_id, *tok.encode(prompt)]
    want = jax_reference(lm, [{"prompt": prompt, "max_new": 6}], num_slots=1)

    def port_sched(cache):
        return ContinuousScheduler(params, cfg, tok, num_slots=1, prefix_cache=cache,
                                   device="cpu")

    prefill_cache = PrefixCache(cfg, block_tokens=4, budget_mb=8)
    assert port_sched(prefill_cache).run([{"prompt": prompt, "max_new": 0}]) == \
        [{"continuation": ""}]
    tokens, payload = export_blocks(prefill_cache, ids)
    assert tokens > 0 and payload
    wire = json.loads(json.dumps(payload))
    decode_cache = PrefixCache(cfg, block_tokens=4, budget_mb=8)
    assert inject_blocks(decode_cache, ids, tokens, wire) == tokens
    s2 = port_sched(decode_cache)
    assert s2.run([{"prompt": prompt, "max_new": 6}]) == want
    assert s2.stats["prefix_hit_tokens"] == tokens

    # JAX's payload into the port, the port's into JAX: the same bytes.
    jcache = JCache(jcfg, block_tokens=4, budget_mb=8)
    JScheduler(jparams, jcfg, jtok, num_slots=1, prefix_cache=jcache).run(
        [{"prompt": prompt, "max_new": 0}])
    j_tokens, j_payload = j_export(jcache, ids)

    def layout(p):  # the values differ by rounding; the format must not
        return [[{k: (a["dtype"], a["shape"]) for k, a in layer.items()} for layer in blk]
                for blk in p]

    assert (j_tokens, layout(j_payload)) == (tokens, layout(wire))
    from_jax = PrefixCache(cfg, block_tokens=4, budget_mb=8)
    assert inject_blocks(from_jax, ids, j_tokens, json.loads(json.dumps(j_payload))) == tokens
    s3 = port_sched(from_jax)
    assert s3.run([{"prompt": prompt, "max_new": 6}]) == want
    assert s3.stats["prefix_hit_tokens"] == tokens
    into_jax = JCache(jcfg, block_tokens=4, budget_mb=8)
    assert j_inject(into_jax, ids, tokens, wire) == tokens
    assert JScheduler(jparams, jcfg, jtok, num_slots=1, prefix_cache=into_jax).run(
        [{"prompt": prompt, "max_new": 6}]) == want


def test_bf16_blocks_cross_as_two_byte_words():
    """A bf16 block travels as JAX's 2-byte void; the port keeps bf16 host
    rows as int16 bit patterns: both directions keep every bit."""
    import ml_dtypes

    from transformer_tpu.serve.replica import _decode_array as j_decode
    from transformer_tpu.serve.replica import _encode_array as j_encode
    from transformer_tpu_torch.serve.replica import _decode_array, _encode_array

    bits = np.random.default_rng(0).integers(-2**15, 2**15, (1, 4, 2, 8), dtype=np.int16)
    jax_rows = bits.view(ml_dtypes.bfloat16)
    port = _decode_array(json.loads(json.dumps(j_encode(jax_rows))))
    assert port.dtype == np.int16 and np.array_equal(port, bits)
    wire = _encode_array(bits)
    assert wire == j_encode(jax_rows)
    back = j_decode(json.loads(json.dumps(wire)))
    assert back.tobytes() == jax_rows.tobytes()


# --------------------------------------------------------------------------
# subprocess fleets of the port's workers


def test_failover_zero_loss_byte_identical(lm, fleet_files):
    """Two port worker processes, one SIGKILLed mid-stream: every accepted
    request answers exactly once, with JAX's single-scheduler answers; the
    route.failover event names the victim and its requests' traces."""
    from transformer_tpu_torch.serve.router import _rendezvous, affinity_key

    events = Events()
    router = spawn_fleet(2, _worker(fleet_files), telemetry=events, heartbeat_timeout_s=10.0)
    tok = lm[2]
    reqs = [*REQS, *BURST]
    want = jax_reference(lm, reqs)
    deadline = time.time() + 60
    try:
        for r in REQS:
            router.submit(dict(r))
        answered = []
        while (len(answered) < len(REQS) or not all(l.answered >= 1 for l in router.links)) \
                and time.time() < deadline:
            router.pump()
            answered.extend(router.drain_ready())
        assert all(l.answered >= 1 for l in router.links)
        key = affinity_key([tok.bos_id, *tok.encode(PROMPT_A)], 4)
        victim = max(router.links, key=lambda l: _rendezvous(key, l.name))
        for r in BURST:
            router.submit(dict(r))
        router.pump(timeout=0)
        assert victim.inflight >= 1
        while len(answered) < len(REQS) + 2 and time.time() < deadline:
            router.pump()
            answered.extend(router.drain_ready())
        assert victim.inflight >= 1, "burst drained before the kill window"
        os.kill(victim.pid(), signal.SIGKILL)
        while router.busy and time.time() < deadline:
            router.pump()
            answered.extend(router.drain_ready())
        answered.extend(router.drain_ready())
        assert len(answered) == len(reqs)
        assert router.stats["failovers"] == 1 and router.stats["redispatched"] >= 1
        assert all("continuation" in a for a in answered), answered
        assert continuations(answered) == continuations(want)
    finally:
        router.shutdown()
    failovers = events.of("route.failover")
    assert len(failovers) == 1 and failovers[0]["replica"] == victim.name
    assert failovers[0]["traces"] and failovers[0]["orders"]
    redispatched = [e for e in events.of("route.dispatch") if e["redispatch"]]
    assert len(redispatched) == router.stats["redispatched"]
    assert {e["trace"] for e in redispatched} <= set(failovers[0]["traces"])


def test_disaggregated_prefill_decode(lm, fleet_files):
    """--disaggregate: prompts ingest on a prefill-only worker and their KV
    crosses to a decode-only worker as prefix-cache blocks; answers equal
    JAX's, every request rode a handoff, and the decode worker prefilled
    fewer than one block + 1 tokens per request."""
    reqs = REQS[:4] + [{"prompt": "ab cd ef gh ij kl mn ab cd", "max_new": 4}]
    router = spawn_fleet(2, _worker(fleet_files), disaggregate=True)
    try:
        out = router.run([dict(r) for r in reqs])
    finally:
        router.shutdown()
    assert continuations(out) == continuations(jax_reference(lm, reqs))
    assert router.stats["prefill_handoffs"] == len(reqs)
    assert router.stats["redispatched"] == 0
    decode = router.links[1].final_stats
    assert decode["admitted"] == len(reqs) and decode["prefix_hit_tokens"] > 0
    assert decode["prefill_tokens"] < len(reqs) * (4 + 1), decode


# --------------------------------------------------------------------------
# telemetry


def test_route_telemetry_matches_jax_on_the_failover_drill():
    import io

    def drill(pkg):
        buf = io.StringIO()
        tel = telemetry_of(pkg, buf)
        router, links = _fake_router(pkg, 2, answer=False, encode=None, max_redispatch=1,
                                     telemetry=tel)
        router.submit_done({"error": "bad line", "code": "validation"})
        for _ in range(4):
            router.submit({"prompt": "p"})
        router.pump(timeout=0)
        first = [l for l in links if l.inflight][0]
        survivor = links[1 - first.index]
        first.ok = False
        router.pump(timeout=0)
        for m in survivor.sent:
            router.inbox.put((survivor.index, {"type": "answer", "rid": m["rid"],
                                               "resp": {"continuation": "ok"}}))
        deadline = time.time() + 10
        while router.busy and time.time() < deadline:
            router.pump(timeout=0)
            router.drain_ready()
        router.run([])
        tel.close()
        events = [json.loads(line) for line in buf.getvalue().splitlines()]
        route = [(e["kind"], sorted(k for k in e if k != "ts")) for e in events
                 if e["kind"].startswith("route.")]
        spans = sorted((e["name"], e.get("lane"), sorted(k for k in e if k != "ts"))
                       for e in events if e["kind"] == "trace.span")
        metrics = sorted(k for e in events if e["kind"] == "metrics.snapshot"
                         for k in e["metrics"])
        return route, spans, metrics, router.stats

    got = both(drill)
    assert got["torch"] == got["jax"]
    route, spans, metrics, stats = got["torch"]
    assert [k for k, _ in route].count("route.failover") == 1 and stats["failovers"] == 1
    assert len(spans) == 5 and {"router_dispatch_total", "router_queue_seconds"} <= set(metrics)


def test_metrics_jsonl_per_replica_and_joined_traces(lm, fleet_files, tmp_path):
    import contextlib
    import io

    import transformer_tpu_torch.obs as tobs
    from transformer_tpu_torch.obs.__main__ import main as obs_main

    path = str(tmp_path / "router.jsonl")
    tel = telemetry_of(PACKAGES["torch"], path)
    router = spawn_fleet(2, _worker(fleet_files, "--trace"), telemetry=tel,
                         per_replica=lambda i: ["--metrics_jsonl", f"{path}.r{i}"])
    assert [l.metrics_jsonl for l in router.links] == [f"{path}.r0", f"{path}.r1"]
    try:
        out = router.run([dict(r) for r in REQS])
    finally:
        router.shutdown()
        tel.close()
    assert continuations(out) == continuations(jax_reference(lm, REQS))
    logs = [path, f"{path}.r0", f"{path}.r1"]
    assert all(os.path.exists(p) for p in logs)
    assert all(os.path.exists(f"{p}.flight.json") for p in logs[1:])  # the workers' recorders
    events, _ = tobs.merge_events(logs)
    spans = [e for e in events if e["kind"] == "trace.span"]
    by_id = {e["span"]: e for e in spans}
    routes = [e for e in spans if e["name"] == "route.request"]
    roots = [e for e in spans if e["name"] == "serve.request"]
    assert len(routes) == len(roots) == len(REQS)
    # Each replica's request span is a child of the router's, in its trace.
    assert all(by_id[e["parent"]]["name"] == "route.request" for e in roots)
    assert {e["trace"] for e in roots} == {e["trace"] for e in routes}
    assert {e["source"] for e in roots} <= {"router.jsonl.r0", "router.jsonl.r1"}
    assert all(l.final_perf for l in router.links if l.answered)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert obs_main(["summarize", *logs]) == 0
    report = buf.getvalue()
    assert "router: 10 requests over" in report and "sources:" in report



def test_warm_up_export_keeps_heartbeats_flowing(lm):
    """``export_state`` returns the hottest prefixes as the worker's
    ``prefix_state`` fields, the KV blocks in a file beside the line
    (which ``inject_state`` reads back into a cold cache, byte for byte,
    and removes), and runs the heartbeat after every prefix, so an export
    longer than the router's heartbeat timeout does not fail the
    exporting worker over; ``inject_state`` beats after every prefix too,
    leaves the cache cold when the file is gone, and takes the JAX
    worker's inline form as well."""
    import os

    from transformer_tpu_torch.serve.prefix_cache import PrefixCache
    from transformer_tpu_torch.serve.replica import (
        _host_blocks,
        export_blocks,
        export_state,
        inject_state,
    )
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler

    params, cfg, tok = port_model(lm)
    cache = PrefixCache(cfg, block_tokens=4, budget_mb=8)
    prompts = [PROMPT_A, PROMPT_B, "ab cd ef gh ij kl mn ab"]
    ContinuousScheduler(params, cfg, tok, num_slots=1, prefix_cache=cache, device="cpu").run(
        [{"prompt": p, "max_new": 0} for p in prompts])
    beats = []
    state = export_state(cache, 8, lambda: beats.append(len(beats)))
    entries = state["entries"]
    assert entries and len(beats) == len(cache.hot_prefixes(8)) >= len(entries)
    assert os.path.exists(state["path"])
    msg = json.loads(json.dumps({"type": "inject_state", **state}))
    cold = PrefixCache(cfg, block_tokens=4, budget_mb=8)
    beats.clear()
    assert inject_state(cold, msg, lambda: beats.append(1)) == \
        sum(e["tokens"] for e in entries) > 0
    assert len(beats) == len(entries) and not os.path.exists(state["path"])
    for e in entries:
        want, got = _host_blocks(cache, e["ids"])[1], _host_blocks(cold, e["ids"])[1]
        assert len(got) == len(want) == e["blocks"]
        assert all(g[k].tobytes() == w[k].tobytes() and g[k].dtype == w[k].dtype
                   for gb, wb in zip(got, want) for g, w in zip(gb, wb) for k in w)
    assert inject_state(cold, {"entries": entries, "path": state["path"]}) == 0  # gone
    inline = [{"ids": e["ids"], "tokens": e["tokens"],
               "blocks": export_blocks(cache, e["ids"])[1]} for e in entries]
    cold = PrefixCache(cfg, block_tokens=4, budget_mb=8)
    assert inject_state(cold, json.loads(json.dumps({"entries": inline}))) == \
        sum(e["tokens"] for e in entries)


def test_warm_up_line_is_forwarded_unparsed():
    """A worker's ``prefix_state`` line reaches the supervisor as its line
    (the reader does not parse the warm-up's payload; a torn one is
    dropped) and goes on to the replacement as the same JSON typed
    ``inject_state``, the message the JAX router builds from the parse."""
    import io
    import queue

    from transformer_tpu_torch.serve.router import (
        PREFIX_STATE_HEAD,
        ReplicaProcess,
        inject_state_line,
    )

    entries = [{"ids": [1, 5, 9], "tokens": 16, "blocks": [[{"k": {"dtype": "<f4"}}]]}]
    line = json.dumps({"type": "prefix_state", "entries": entries})
    link = ReplicaProcess.__new__(ReplicaProcess)
    link.index, link._proc = 3, type("P", (), {"pid": 42})()
    inbox: queue.Queue = queue.Queue()
    link._read_loop(inbox, io.StringIO(f'{line}\n{{"type": "hb"}}\n{line[:40]}\n'))
    got = [inbox.get_nowait() for _ in range(inbox.qsize())]
    assert got == [(3, {"type": "prefix_state", "line": line}), (3, {"type": "hb"}),
                   (3, {"type": "exit", "pid": 42})]
    assert line.startswith(PREFIX_STATE_HEAD)
    assert inject_state_line(line) == json.dumps({"type": "inject_state", "entries": entries})
