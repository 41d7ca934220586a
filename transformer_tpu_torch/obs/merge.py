"""Multi-source telemetry: merge JSONL event logs across processes.

Port of ``transformer_tpu/obs/merge.py`` (a copy, standard library only):
``obs summarize`` / ``obs trace`` / ``obs slo`` over the union of N
per-process logs (the fleet's router and its replicas):

- **Source tagging**: every merged event gains a ``source`` field (the
  file's basename, disambiguated when two paths share one), so a report or
  Perfetto export can always say which replica produced what.
- **Clock alignment**: wall clocks on different hosts disagree. When trace
  context crossed the process boundary (``obs/trace.py`` traceparent — a
  router span whose child span landed in a replica's log), every cross-file
  parent/child span pair constrains the files' relative skew: the child's
  interval, shifted by the true skew, must nest inside its parent's. The
  estimator intersects those constraints per file pair (midpoint of the
  feasible interval, median over pairs) and shifts each file onto the first
  file's clock. Files with no cross-file trace lineage keep their own clock
  (skew 0 — nothing to align against, and guessing would be worse than
  honesty: the per-source skew table in the report says which happened).
- **Time-window slicing**: ``--since TS`` / ``--last N{s,m,h}`` filtering
  (applied AFTER alignment, so one cutoff means one instant across
  replicas) — long soak logs become sliceable without external tooling.
"""

from __future__ import annotations

import os
import statistics

from transformer_tpu_torch.obs.events import read_events

#: ``--last`` suffix -> seconds.
_DURATION_UNITS = {"s": 1.0, "m": 60.0, "h": 3600.0}


def parse_duration(text: str) -> float:
    """``'90s' / '5m' / '2h'`` (bare numbers = seconds) -> seconds.
    Raises ValueError on malformation — CLI flags must fail loudly."""
    text = str(text).strip()
    if not text:
        raise ValueError("empty duration")
    unit = 1.0
    if text[-1].lower() in _DURATION_UNITS:
        unit = _DURATION_UNITS[text[-1].lower()]
        text = text[:-1]
    value = float(text)  # ValueError propagates with the original text
    if value < 0:
        raise ValueError(f"duration must be >= 0, got {value}")
    return value * unit


def filter_events(
    events: list, since: "float | None" = None, last: "float | None" = None
) -> list:
    """Keep events with ``ts >= cutoff``. ``since`` is an absolute unix
    timestamp; ``last`` is seconds counted back from the newest event in
    the list (the end of the log, NOT the current clock — a report over an
    old log must not come back empty). Both given: the later cutoff wins.
    Events without a numeric ``ts`` are dropped by any filter."""
    if since is None and last is None:
        return events
    cutoff = since if since is not None else float("-inf")
    if last is not None:
        end = max(
            (e["ts"] for e in events if isinstance(e.get("ts"), (int, float))),
            default=0.0,
        )
        cutoff = max(cutoff, end - last)
    return [
        e for e in events
        if isinstance(e.get("ts"), (int, float)) and e["ts"] >= cutoff
    ]


def _unique_names(paths: list) -> list:
    """Basenames, disambiguated with the parent directory (then an index)
    when two paths collide — the ``source`` tags must be distinct or the
    per-source accounting silently merges replicas."""
    names = [os.path.basename(p) or p for p in paths]
    out = []
    for i, (path, name) in enumerate(zip(paths, names)):
        if names.count(name) > 1:
            parent = os.path.basename(os.path.dirname(os.path.abspath(path)))
            name = f"{parent}/{name}" if parent else f"{name}#{i}"
        while name in out:
            name = f"{name}#{i}"
        out.append(name)
    return out


def _span_index(events: list) -> dict:
    """span_id -> (t0, t1, parent_id|None) over this file's trace.span
    events."""
    idx = {}
    for e in events:
        if e.get("kind") != "trace.span":
            continue
        t0, dur = e.get("t0"), e.get("dur_s")
        span = e.get("span")
        if not (isinstance(t0, (int, float)) and isinstance(dur, (int, float))
                and isinstance(span, str)):
            continue
        idx[span] = (float(t0), float(t0) + float(dur), e.get("parent"))
    return idx


def estimate_skews(per_file_events: list) -> list:
    """Per-file clock offset (seconds to SUBTRACT from every timestamp)
    relative to file 0's clock, from cross-file parent/child span pairs.

    For a child recorded in file B at ``[c0, c1]`` under a parent recorded
    in file A at ``[p0, p1]``, the true child interval ``[c0 - s, c1 - s]``
    must nest in the parent's: feasible ``s`` in ``[c1 - p1, c0 - p0]``.
    One pair's point estimate is the interval midpoint — symmetric slack,
    the same assumption NTP makes about path delay — and a file pair's
    estimate is the median over its pairs (robust to one weird span).
    Estimates chain: a file aligned only against file 2 inherits file 2's
    offset. Unconstrained files get 0.0.
    """
    n = len(per_file_events)
    indexes = [_span_index(evs) for evs in per_file_events]
    # pairwise[(a, b)] = list of point estimates for (file b's clock minus
    # file a's clock).
    pairwise: dict[tuple, list] = {}
    for b, idx_b in enumerate(indexes):
        for span_id, (c0, c1, parent) in idx_b.items():
            if not isinstance(parent, str):
                continue
            for a, idx_a in enumerate(indexes):
                if a == b or parent not in idx_a:
                    continue
                p0, p1, _ = idx_a[parent]
                lo, hi = c1 - p1, c0 - p0
                pairwise.setdefault((a, b), []).append((lo + hi) / 2.0)
    offsets: list = [None] * n
    offsets[0] = 0.0
    # Propagate along constraint edges breadth-first from file 0 (then from
    # any still-unanchored file, which becomes its own island's reference).
    for root in range(n):
        if offsets[root] is None:
            offsets[root] = 0.0
        frontier = [root]
        while frontier:
            a = frontier.pop()
            for (x, y), ests in pairwise.items():
                if x == a and offsets[y] is None:
                    offsets[y] = offsets[a] + statistics.median(ests)
                    frontier.append(y)
                elif y == a and offsets[x] is None:
                    offsets[x] = offsets[a] - statistics.median(ests)
                    frontier.append(x)
    return [round(o, 6) for o in offsets]


def merge_events(
    paths: list, align: bool = True
) -> "tuple[list, dict]":
    """Read N JSONL logs into one time-sorted event list. Every event is
    tagged with its ``source`` (existing tags from an earlier merge pass
    are preserved); with ``align`` (default), per-file clock skew is
    estimated from cross-file trace lineage and subtracted from ``ts`` and
    span ``t0`` so one timeline is coherent across replicas.

    Returns ``(events, report)`` where ``report['sources']`` maps each
    source tag to its event count and applied ``skew_s`` — summarize
    surfaces it so an operator can see what alignment did."""
    names = _unique_names(paths)
    per_file = [read_events(p) for p in paths]
    skews = estimate_skews(per_file) if align and len(paths) > 1 else [0.0] * len(paths)
    merged: list = []
    sources: dict[str, dict] = {}
    for name, events, skew in zip(names, per_file, skews):
        for e in events:
            e.setdefault("source", name)
            if skew:
                if isinstance(e.get("ts"), (int, float)):
                    e["ts"] = round(e["ts"] - skew, 6)
                if e.get("kind") == "trace.span" and isinstance(
                    e.get("t0"), (int, float)
                ):
                    e["t0"] = round(e["t0"] - skew, 6)
            merged.append(e)
        sources[name] = {"events": len(events), "skew_s": skew}
    merged.sort(
        key=lambda e: e["ts"] if isinstance(e.get("ts"), (int, float)) else 0.0
    )
    return merged, {"sources": sources}
