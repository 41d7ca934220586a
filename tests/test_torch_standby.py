"""The port's warm-standby router (``transformer_tpu_torch/serve/standby.py``),
the primary's HA journal (``serve/router.py`` in ``ha`` mode) and the
worker's ``--ha`` takeover socket (``serve/replica.py``) against the JAX
package's, ported from the HA cases of ``tests/test_supervisor.py``.

One subprocess drill, shared by every case that needs workers: a primary
over two ``--ha`` port workers on the CPU (the JAX spec model's weights
through ``--init_ckpt``) delivers two answers, dispatches six more and
stops pumping; a ``Standby`` tailing its log adopts the fleet at epoch 2
and answers the rest. Every request crosses the cutover exactly once, the
greedy answers are byte-identical to a single port scheduler's (and to
JAX's), a takeover at epoch 2 is rejected, and what the old primary still
sends is dropped and counted. The cutover is placed by the primary's own
deliveries, not by time, so the drill means the same on a loaded machine.

The standby's units run on synthetic journals, and both packages'
``Standby`` read the same journal, and each other's primaries' journals,
into the same state and the same adoption.
"""

import json
import socket
import time

import pytest

from torch_fleet import (
    PACKAGES,
    PROMPT_A,
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

PORT = PACKAGES["torch"]
DRILL_REQS = [{"prompt": PROMPT_A, "max_new": 20} for _ in range(8)]
DELIVERED_BEFORE_CUTOVER = 2
DEADLINE_S = 120.0  # generous: the drill waits on conditions, never on sleeps


@pytest.fixture(scope="module")
def lm():
    return jax_model()


def _wait(cond, what, seconds=DEADLINE_S, step=None):
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} did not happen within {seconds} s")
        if step is not None:
            step()


def _probe_takeover(port: int, epoch: int) -> dict:
    """One takeover handshake at ``epoch`` on a worker's control socket."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        wf = s.makefile("w", encoding="utf-8", buffering=1)
        rf = s.makefile("r", encoding="utf-8")
        wf.write(json.dumps({"type": "takeover", "epoch": epoch, "inflight": []}) + "\n")
        wf.flush()
        return json.loads(rf.readline())


@pytest.fixture(scope="module")
def drill(tmp_path_factory, lm):
    """The exactly-once drill over two ``--ha`` port workers; returns what
    the cases check."""
    from transformer_tpu_torch.obs import EventLog, Telemetry
    from transformer_tpu_torch.serve.scheduler import ContinuousScheduler
    from transformer_tpu_torch.serve.standby import Standby

    root = tmp_path_factory.mktemp("standby")
    worker = ["--model_spec", write_spec(root / "spec.json"),
              "--init_ckpt", jax_checkpoint(root / "ckpt", lm[0]),
              "--serve_slots", "2", "--heartbeat_ms", "50", "--ha"]
    primary_log, standby_log = str(root / "primary.jsonl"), str(root / "standby.jsonl")
    tel = Telemetry(events=EventLog(primary_log), interval=1e9)
    with pytest.MonkeyPatch.context() as mp:
        # One intra-op thread a worker: the fleet must not crowd out the
        # tests running beside it.
        mp.setenv("OMP_NUM_THREADS", "1")
        # A beacon every pump, so that the last one before the cutover
        # names both workers' ports.
        router = spawn_fleet(2, worker, telemetry=tel, ha=True, ha_heartbeat_s=0.0)
    new = None
    rec = {}
    try:
        params, cfg, tok = port_model(lm)
        rec["want"] = continuations(ContinuousScheduler(
            params, cfg, tok, num_slots=2, device="cpu").run([dict(r) for r in DRILL_REQS]))
        rec["jax_want"] = continuations(jax_reference(lm, DRILL_REQS))
        delivered = []
        for r in DRILL_REQS[:DELIVERED_BEFORE_CUTOVER]:
            router.submit(dict(r))

        def pump_primary():
            router.pump()
            delivered.extend(router.drain_ready())

        _wait(lambda: len(delivered) == DELIVERED_BEFORE_CUTOVER
              and all(l.control_port is not None for l in router.links),
              "the primary's first answers", step=pump_primary)
        for r in DRILL_REQS[DELIVERED_BEFORE_CUTOVER:]:
            router.submit(dict(r))
        router.pump(timeout=0)  # dispatches the rest; then the primary stops
        rec["cut"] = {"inflight": len(router._inflight), "pending": len(router._pending),
                      "delivered": len(delivered)}
        standby = Standby(primary_log, takeover_after_s=0.5, encode=tok.encode,
                          bos_id=tok.bos_id,
                          telemetry=Telemetry(events=EventLog(standby_log), interval=1e9))
        new = standby.run_until_takeover(poll_s=0.05, timeout=60)
        rec["standby_stats"] = dict(standby.stats)
        rec["epoch"] = new.epoch
        rec["links"] = [l.name for l in new.links]

        def pump_new():
            new.pump()
            delivered.extend(new.drain_ready())

        _wait(lambda: not new.busy, "the adopted router's answers", step=pump_new)
        delivered.extend(new.drain_ready())
        rec["delivered"] = delivered
        rec["rejected"] = _probe_takeover(new.links[1].control_port, 2)
        # The old primary, wrongly declared dead, sends on: a request, then
        # a takeover at its own epoch on the same pipe. The worker reads the
        # pipe in order, so the rejection proves the request was handled.
        old = router.links[0]
        old.send({"type": "req", "rid": 1000, "req": {"prompt": PROMPT_A, "max_new": 2}})
        old.send({"type": "takeover", "epoch": 1, "inflight": []})
        stale = []

        def read_old():
            try:
                index, msg = router.inbox.get(timeout=1.0)
            except Exception:  # noqa: BLE001 — queue.Empty: wait on
                return
            if index == 0 and msg.get("type") == "rejected":
                stale.append(msg)

        _wait(lambda: stale, "the old primary's rejected takeover", step=read_old)
        rec["stale_reply"] = stale[0]
        for _ in range(20):
            new.pump(timeout=0.01)
        rec["late_answers"] = new.drain_ready()
        rec["router_stats"] = dict(new.stats)
    finally:
        if new is not None:
            new.shutdown()
        for link in router.links:
            link.kill()
        router.shutdown()
        tel.close()
    rec["final"] = {l.name: l.final_stats for l in new.links}
    rec["logs"] = (primary_log, standby_log)
    return rec


# --------------------------------------------------------------------------
# the drill


def test_router_ha_takeover_exactly_once(drill):
    """Every request crosses the cutover exactly once, byte-identical to a
    single port scheduler's answers (and JAX's), at epoch 2."""
    assert drill["cut"] == {"inflight": 6, "pending": 0, "delivered": 2}
    assert len(drill["delivered"]) == len(DRILL_REQS)
    assert continuations(drill["delivered"]) == drill["want"] == drill["jax_want"]
    assert drill["epoch"] == 2 and drill["links"] == ["replica0", "replica1"]
    st = drill["standby_stats"]
    assert st["recovered_answers"] + st["reowned_inflight"] + st["redispatched"] == 6, st
    assert st["skipped_replicas"] == 0 and st["hb_seen"] > 0
    assert drill["router_stats"]["duplicate_answers"] == 0
    assert all(s["takeovers"] == 1 for s in drill["final"].values()), drill["final"]


def test_takeover_at_a_non_higher_epoch_is_rejected(drill):
    """The split-brain guard: epoch 2 on the socket and epoch 1 on the old
    pipe are both rejected, naming the epoch that owns the worker."""
    assert drill["rejected"]["type"] == "rejected" and drill["rejected"]["epoch"] == 2
    assert drill["stale_reply"] == {"type": "rejected", "replica": "replica0", "epoch": 2}
    assert drill["final"]["replica1"]["rejected_takeovers"] == 1
    assert drill["final"]["replica0"]["rejected_takeovers"] == 1


def test_old_primary_stragglers_are_dropped(drill):
    """What the old primary sends after the takeover is dropped and
    counted by the worker, and never answered."""
    assert drill["final"]["replica0"]["stale_dropped"] == 1
    assert drill["final"]["replica1"]["stale_dropped"] == 0
    assert drill["late_answers"] == []


def test_summarize_merges_both_routers_logs(drill):
    """``obs summarize`` over the two routers' logs: both sources, one
    takeover at epoch 2, from the standby's log."""
    from transformer_tpu_torch.obs.__main__ import render_text, summarize_events
    from transformer_tpu_torch.obs.merge import merge_events

    events, info = merge_events(list(drill["logs"]))
    assert set(info["sources"]) == {"primary.jsonl", "standby.jsonl"}
    takeovers = [e for e in events if e.get("kind") == "route.takeover"]
    assert len(takeovers) == 1
    assert takeovers[0]["epoch"] == 2 and takeovers[0]["source"] == "standby.jsonl"
    fleet = summarize_events(events)["fleet"]
    assert fleet["takeovers"] == 1 and fleet["takeover"]["epoch"] == 2
    assert "router takeover" in render_text(summarize_events(events))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_adopted_routers_journal_serves_a_chained_standby(drill, pkg):
    """The adopted router's own log, read by either package's Standby:
    its beacon at epoch 2 names both workers' ports, and everything it
    adopted was delivered."""
    standby = PACKAGES[pkg].Standby(drill["logs"][1])
    standby.poll()
    assert standby.epoch == 2 and sorted(standby.ports) == ["replica0", "replica1"]
    assert standby.delivered_upto == len(DRILL_REQS) and standby.intake == {}


# --------------------------------------------------------------------------
# the standby's units (synthetic journals, no worker)


def _write(path, events):
    path.write_text("".join(json.dumps(e) + "\n" for e in events))
    return str(path)


class _NoopLink(PORT.ReplicaLink):
    def start_reader(self, inbox):
        pass


def test_standby_tail_reconstruction(tmp_path):
    log = tmp_path / "primary.jsonl"
    clk = [100.0]
    standby = PORT.Standby(str(log), takeover_after_s=2.0, clock=lambda: clk[0])
    _write(log, [
        {"kind": "route.intake", "order": 0, "req": {"prompt": "a"}, "traceparent": None,
         "ts": 1.0},
        {"kind": "route.intake", "order": 1, "resp": {"error": "x", "code": "routing"},
         "ts": 1.0},
        {"kind": "route.hb", "epoch": 3, "ports": {"replica0": 1234}, "ts": 1.1},
        {"kind": "route.answered", "first": 0, "upto": 0, "n": 1, "ts": 1.2},
    ])
    assert standby.poll() == 0.0
    assert standby.epoch == 3
    assert standby.ports == {"replica0": 1234}
    assert standby.delivered_upto == 1  # order 0 reached the client
    # Delivered orders are pruned; the order clock still resumes past all.
    assert set(standby.intake) == {1}
    assert standby.max_order == 1
    # A torn last line waits for its newline.
    with open(log, "a") as f:
        f.write(json.dumps({"kind": "route.intake", "order": 2, "req": {"prompt": "c"}})[:25])
    clk[0] += 1.0
    assert standby.poll() > 0  # the beacon's silence accrues
    assert 2 not in standby.intake
    assert not standby.primary_dead
    clk[0] += 5.0
    assert standby.primary_dead


def test_standby_merge_prefers_owner_claim(tmp_path, monkeypatch):
    """An early peer's "unknown" never hides the owner's later "inflight"
    claim, and "done" beats both: re-owned once by its owner, not
    redispatched."""
    log = _write(tmp_path / "primary.jsonl", [
        *({"kind": "route.intake", "order": o, "req": {"prompt": "p"}, "ts": 1.0}
          for o in (5, 6)),
        {"kind": "route.hb", "epoch": 1, "ports": {"a": 1, "b": 2}, "ts": 1.1},
    ])
    standby = PORT.Standby(log)
    standby.poll()

    def handshake(index, name, port, ask):
        link = _NoopLink(index, name)
        if name == "a":  # handshaken first (sorted), owns nothing
            return link, {"5": "unknown", "6": "unknown"}, {}
        return link, {"5": "inflight", "6": "done"}, {
            "6": {"type": "answer", "rid": 6, "resp": {"continuation": "x"}}}

    monkeypatch.setattr(standby, "_handshake", handshake)
    router = standby.adopt()
    assert standby.stats["reowned_inflight"] == 1
    assert standby.stats["recovered_answers"] == 1
    assert standby.stats["redispatched"] == 0
    assert router._inflight[5].replica == 1  # re-owned by its owner
    assert router._done[6] == {"continuation": "x"}
    assert router._next_order == 7


def test_adopted_router_rejournals_for_chained_takeover(tmp_path, monkeypatch):
    """The adopted orders are journaled again by the new primary (intake
    records and the delivery floor): a second standby tailing it rebuilds
    the same undelivered set."""
    from transformer_tpu_torch.obs import EventLog, Telemetry

    log = _write(tmp_path / "primary.jsonl", [
        {"kind": "route.intake", "order": 0, "req": {"prompt": "a"}, "ts": 1.0},
        {"kind": "route.intake", "order": 1, "req": {"prompt": "b"}, "ts": 1.0},
        {"kind": "route.intake", "order": 2, "resp": {"error": "bad line", "code": "validation"},
         "ts": 1.0},
        {"kind": "route.answered", "first": 0, "upto": 0, "n": 1, "ts": 1.1},
        {"kind": "route.hb", "epoch": 1, "ports": {"r0": 7}, "ts": 1.2},
    ])
    new_log = str(tmp_path / "adopted.jsonl")
    standby = PORT.Standby(log, telemetry=Telemetry(events=EventLog(new_log)))
    standby.poll()
    monkeypatch.setattr(standby, "_handshake", lambda index, name, port, ask: (
        _NoopLink(index, name), {"1": "inflight"}, {}))
    router = standby.adopt()
    standby._tel.maybe_flush(force=True)
    chained = PORT.Standby(new_log)
    chained.poll()
    assert chained.delivered_upto == 1           # the floor survived
    assert set(chained.intake) == {1, 2}         # the adopted orders replay
    assert chained.intake[1]["req"] == {"prompt": "b"}
    assert chained.intake[2]["resp"]["code"] == "validation"
    assert chained.max_order == 2
    assert router._inflight[1].replica == 0      # and the adoption held


def test_standby_stands_down_on_higher_epoch(tmp_path, monkeypatch):
    """TakeoverRejected leaves adopt(): another standby won the fleet."""
    log = _write(tmp_path / "primary.jsonl", [
        {"kind": "route.hb", "epoch": 1, "ports": {"replica0": 9}, "ts": 1.0}])
    standby = PORT.Standby(log)
    standby.poll()

    def reject(index, name, port, ask):
        raise PORT.TakeoverRejected("epoch 5 owns the fleet")

    monkeypatch.setattr(standby, "_handshake", reject)
    with pytest.raises(PORT.TakeoverRejected):
        standby.adopt()


def test_route_takeover_fault_point_skips_the_replica(tmp_path):
    """``route.takeover`` fires inside each handshake: at call 1 the first
    worker is skipped (a partial adoption) and the second, a socket that
    answers the handshake, is adopted; the order nobody claimed is
    redispatched."""
    import threading

    from transformer_tpu_torch.serve import resilience

    server = socket.socket()
    server.bind(("127.0.0.1", 0))
    server.listen(1)
    conns = []

    def answer():
        conn, _ = server.accept()
        conns.append(conn)
        conn.makefile("r").readline()
        conn.sendall(json.dumps({"type": "adopted", "statuses": {"0": "unknown"},
                                 "messages": {}}).encode() + b"\n")

    t = threading.Thread(target=answer, daemon=True)
    t.start()
    log = _write(tmp_path / "primary.jsonl", [
        {"kind": "route.intake", "order": 0, "req": {"prompt": "p"}, "ts": 1.0},
        {"kind": "route.hb", "epoch": 1, "ports": {"a": 1, "b": server.getsockname()[1]},
         "ts": 1.1},
    ])
    standby = PORT.Standby(log)
    standby.poll()
    try:
        with resilience.active(resilience.FaultPlane.parse("route.takeover:at=1")):
            router = standby.adopt()
        t.join(timeout=10)
        assert standby.stats["skipped_replicas"] == 1
        assert [(l.name, l.control_port) for l in router.links] == [
            ("b", server.getsockname()[1])]
        assert standby.stats["redispatched"] == 1 and router.backlog == 1
        assert router.epoch == 2
    finally:
        for link in router.links:
            link.kill()
        for conn in conns:
            conn.close()
        server.close()


def test_summarize_fleet_section_shapes():
    from transformer_tpu_torch.obs.__main__ import render_text, summarize_events

    events = [
        {"kind": "route.spawn", "replica": "r0", "heal_s": 1.5, "warmed_tokens": 12,
         "scale_up": False, "ts": 1.0},
        {"kind": "route.spawn", "replica": "r2", "scale_up": True, "warmed_tokens": 0,
         "heal_s": None, "ts": 2.0},
        {"kind": "route.spawn", "replica": "r1", "gave_up": True, "attempts": 3, "ts": 3.0},
        {"kind": "route.scale", "direction": "up", "signal": "ttft_p95", "burn_rate": 2.0,
         "fleet_size": 3, "evidence": {"60s": {"burn_rate": 2.0}}, "ts": 2.0},
        {"kind": "route.scale", "direction": "down", "signal": "ttft_p95", "burn_rate": 0.0,
         "replica": "r2", "fleet_size": 2, "ts": 4.0},
        {"kind": "route.retire", "replica": "r2", "ts": 4.1},
        {"kind": "route.takeover", "epoch": 2, "adopted": ["r0", "r1"], "failed": [],
         "recovered_answers": 1, "reowned_inflight": 2, "redispatched": 0,
         "delivered_upto": 3, "ts": 5.0},
    ]
    fleet = summarize_events(events)["fleet"]
    assert fleet["respawns"] == 1
    assert fleet["gave_up"] == 1
    assert fleet["warmed_tokens"] == 12
    assert fleet["scale_ups"] == 1 and fleet["scale_downs"] == 1
    assert fleet["retired"] == 1
    assert fleet["takeovers"] == 1
    assert fleet["time_to_heal_s"]["mean"] == 1.5
    assert fleet["final_fleet_size"] == 2
    assert fleet["takeover"]["reowned_inflight"] == 2
    text = render_text(summarize_events(events))
    assert "fleet:" in text and "respawn" in text and "takeover" in text
    from transformer_tpu.obs.__main__ import summarize_events as jax_summarize

    assert fleet == jax_summarize(events)["fleet"]


# --------------------------------------------------------------------------
# the two packages' standbys on the same journals


def _state(standby) -> dict:
    return {"epoch": standby.epoch, "ports": dict(standby.ports),
            "delivered_upto": standby.delivered_upto, "intake": dict(standby.intake),
            "max_order": standby.max_order}


def _adopt_both(log, statuses, messages=None, monkeypatch=None) -> dict:
    """Each package's Standby over ``log``, adopted through fake handshakes
    that answer ``statuses`` / ``messages`` per worker name; the state it
    read, its stats and the seeded router's tables."""
    out = {}
    for name, pkg in PACKAGES.items():
        class Link(pkg.ReplicaLink):
            def start_reader(self, inbox):
                pass

        def handshake(index, worker, port, ask, Link=Link):
            link = Link(index, worker)
            link.control_port = port
            return link, statuses.get(worker, {}), (messages or {}).get(worker, {})

        standby = pkg.Standby(log)
        standby.poll()
        state = _state(standby)
        monkeypatch.setattr(standby, "_handshake", handshake)
        router = standby.adopt()

        def tid(rr, standby=standby):
            # The journal's trace id; an order journaled without one gets a
            # fresh random identity.
            return rr.ctx.trace_id if standby.intake[rr.order].get("traceparent") else None

        out[name] = {
            "state": state, "stats": dict(standby.stats), "epoch": router.epoch,
            "next_order": router._next_order, "emit_next": router._emit_next,
            "done": dict(router._done),
            "inflight": sorted((o, rr.replica, rr.req, tid(rr), rr.deadline is None)
                               for o, rr in router._inflight.items()),
            "pending": [(rr.order, rr.req, tid(rr), rr.deadline is None)
                        for rr in router._pending],
            "links": [(l.name, l.control_port) for l in router.links],
        }
    return out


def test_both_standbys_reconstruct_a_synthetic_journal(tmp_path, monkeypatch):
    tp = "00-0123456789abcdef0123456789abcdef-0123456789abcdef-01"
    log = tmp_path / "primary.jsonl"
    _write(log, [
        {"kind": "route.intake", "order": 0, "req": {"prompt": "a"}, "ts": 1.0},
        {"kind": "route.intake", "order": 1, "req": {"prompt": "b", "max_new": 3},
         "traceparent": tp, "deadline_ms": 1e9, "ts": 1.0},
        {"kind": "route.intake", "order": 2, "resp": {"error": "bad", "code": "validation"},
         "ts": 1.0},
        {"kind": "route.hb", "epoch": 2, "ports": {"r0": 11, "r1": 12, "bad": "x"}, "ts": 1.1},
        {"kind": "route.answered", "first": 0, "upto": 0, "n": 1, "ts": 1.2},
        {"kind": "route.intake", "order": 3, "req": {"prompt": "c"}, "ts": 1.3},
        {"kind": "route.intake", "order": 4, "req": {"prompt": "d"}, "ts": 1.3},
        {"kind": "route.intake", "order": 5, "req": {"prompt": "e"}, "ts": 1.3},
        {"kind": "route.hb", "epoch": 2, "ports": {"r0": 11, "r1": 12}, "ts": 1.4},
    ])
    with open(log, "a") as f:
        f.write('{"kind": "route.intake", "order": 6, "req"')  # torn
    got = _adopt_both(str(log), {
        "r0": {"1": "inflight", "3": "unknown", "4": "done", "5": "unknown"},
        "r1": {"1": "unknown", "3": "inflight", "4": "unknown", "5": "unknown"},
    }, {"r0": {"4": {"type": "answer", "rid": 4, "resp": {"continuation": "d!"}}}},
        monkeypatch)
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t["state"]["epoch"] == 2 and t["state"]["ports"] == {"r0": 11, "r1": 12}
    assert t["state"]["delivered_upto"] == 1 and t["state"]["max_order"] == 5
    assert sorted(t["state"]["intake"]) == [1, 2, 3, 4, 5]
    assert t["stats"]["recovered_answers"] == 1 and t["stats"]["reowned_inflight"] == 2
    assert t["stats"]["redispatched"] == 1
    assert t["epoch"] == 3 and t["next_order"] == 6 and t["emit_next"] == 1
    assert t["inflight"][0][:3] == (1, 0, {"prompt": "b", "max_new": 3})
    assert t["inflight"][0][3] == "0123456789abcdef0123456789abcdef"


def _primary_drill(pkg, log):
    """A primary of ``pkg`` in ``ha`` mode over fake links (the second one
    mute, so orders stay in flight there) writing its journal to ``log``."""
    Fake = fake_link_class(pkg)
    links = [Fake(0, "f0"), Fake(1, "f1", answer=False)]
    for i, link in enumerate(links):
        link.control_port = 4000 + i
    tel = telemetry_of(pkg, log, trace=False)
    router = pkg.Router(links, encode=None, telemetry=tel, ha=True, ha_heartbeat_s=0.0)
    for link in links:
        link.router = router
    for i in range(6):
        router.submit({"prompt": f"p{i}", "max_new": 2, **({"deadline_ms": 60000} if i == 3
                                                           else {})})
    router.submit_done({"error": "LM export serves 'prompt', not 'src'", "code": "routing"})
    for _ in range(3):
        router.pump(timeout=0)
    delivered = router.drain_ready()
    tel.maybe_flush(force=True)
    tel.close()
    return delivered


@pytest.mark.parametrize("primary", ["jax", "torch"])
def test_each_primarys_journal_reads_alike_in_both_standbys(tmp_path, monkeypatch, primary):
    """A primary's journal from a fake-link drill, of either package, is
    read by JAX's Standby and the port's into the same state and the same
    adoption; the two primaries' journals carry the same records."""
    logs = {}
    for name, pkg in PACKAGES.items():
        logs[name] = str(tmp_path / f"{name}.jsonl")
        assert len(_primary_drill(pkg, logs[name])) == 1  # order 1 holds the rest back
    got = _adopt_both(logs[primary], {
        "f0": {"3": "done"}, "f1": {str(o): "inflight" for o in (1, 3, 5)}},
        {"f0": {"3": {"type": "answer", "rid": 3, "resp": {"continuation": "f0"}}}},
        monkeypatch)
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t["state"]["ports"] == {"f0": 4000, "f1": 4001}
    assert t["state"]["delivered_upto"] == 1 and t["state"]["max_order"] == 6
    assert t["done"][6]["code"] == "routing" and t["done"][3] == {"continuation": "f0"}
    assert [o for o, *_ in t["inflight"]] == [1, 5] and t["stats"]["redispatched"] == 2
    assert t["links"] == [("f0", 4000), ("f1", 4001)]

    def records(path):
        from transformer_tpu_torch.obs.events import read_events

        return [{k: v for k, v in e.items() if k not in ("ts", "traceparent")}
                for e in read_events(path)
                if e["kind"] in ("route.intake", "route.answered", "route.hb")]

    assert records(logs["torch"]) == records(logs["jax"])
