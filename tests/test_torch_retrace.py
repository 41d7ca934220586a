"""The port's retrace sentinel (``transformer_tpu_torch.analysis.retrace``).

- The sentinel's mechanics: what it watches (the step signatures a
  ``CapturedForward`` or ``CapturedStep`` has met, recorded on the CPU as
  on the card), snapshot and deltas, budgets, the report's dict (JAX's
  ``WatchDelta`` keys).
- Every canned report within budget on the CPU: decode, speculative,
  prefix cache, paged (gathered views and the kernels' plain versions),
  resilience, upgrade and train; the sharded one skipped.
- A canary: a prefill that escaped bucketing, fed through the captured
  step forward at its own length, is caught as a new signature.
- The CLI: ``retrace --device cpu`` exit code and JSON.
"""

import json

import numpy as np
import pytest
import torch

from transformer_tpu.analysis.retrace import WatchDelta as JWatchDelta
from transformer_tpu_torch.analysis import retrace
from transformer_tpu_torch.analysis.__main__ import main as analysis_main
from transformer_tpu_torch.analysis.retrace import RetraceSentinel, WatchDelta


class _Watched:
    def __init__(self):
        self.signatures = set()


def test_sentinel_mechanics():
    fn = _Watched()
    sentinel = RetraceSentinel()
    with pytest.raises(ValueError, match="records no step signatures"):
        sentinel.watch("jit-like", object())
    sentinel.watch("step", fn, budget=0)
    sentinel.watch("step_with_slack", fn, budget=1)
    with pytest.raises(RuntimeError, match="snapshot"):
        sentinel.deltas()
    fn.signatures.add((2, 1, 0))
    assert sentinel.snapshot() == {"step": 1, "step_with_slack": 1}
    fn.signatures.add((2, 1, 0))  # met again: no new graph
    assert sentinel.violations() == []
    fn.signatures.add((2, 5, 0))
    deltas = {d.name: d for d in sentinel.deltas()}
    assert deltas["step"].compiles == 1 and not deltas["step"].within_budget
    assert deltas["step_with_slack"].within_budget
    with pytest.raises(AssertionError, match="step met 1 new step signature"):
        sentinel.assert_within_budget()


def test_watch_delta_dict_is_jaxs():
    ours, jaxs = WatchDelta("w", 0, 2, 3), JWatchDelta("w", 0, 2, 3)
    assert ours.to_dict() == jaxs.to_dict()
    assert (ours.compiles, ours.within_budget) == (jaxs.compiles, jaxs.within_budget)


@pytest.mark.parametrize("report", sorted(retrace.REPORTS))
def test_report_within_budget_on_the_cpu(report):
    deltas = retrace.REPORTS[report](steps=2, device="cpu")
    assert deltas, report
    for d in deltas:
        assert d.before >= 1, d  # warm-up met the path's signature
        assert d.within_budget and d.compiles == 0, d


def test_paged_report_watches_both_step_forwards():
    names = [d.name for d in retrace.paged_retrace_report(steps=1, device="cpu")]
    assert names == ["decode(_pool_step_paged)", "decode(_pool_step_paged_flash)"]


def test_sharded_report_is_skipped():
    assert retrace.SKIPPED_REPORTS == ("sharded",)
    assert "sharded" not in retrace.REPORTS


def test_canary_unbucketed_prefill_is_a_new_signature():
    """After warm-up a prompt suffix fed through the captured step forward
    at its own length (5 rows, where the step's width is 1), as a prefill
    that escaped its bucket would meet it, is a new (slots, S_q, table)
    signature: on the card, a new graph. The sentinel fails it; the same
    width again costs nothing more."""
    cfg, params, tok = retrace._tiny_lm_setup("cpu")
    s = retrace._scheduler("cpu", cfg, params, tok, max_total=32, default_max_new=4)
    s.run([{"prompt": "the quick brown fox"}])
    assert s.forward.signatures == {(2, 1, 0)}
    sentinel = RetraceSentinel()
    sentinel.watch("decode_step(_pool_step)", s.forward, budget=0)
    sentinel.snapshot()
    prompt = np.asarray([tok.encode("the lazy dog")[:5]] * s.num_slots)
    s.forward(prompt, None, np.zeros((s.num_slots,), np.int32))
    (d,) = sentinel.violations()
    assert d.compiles == 1 and d.after == 2
    s.forward(prompt, None, np.zeros((s.num_slots,), np.int32))
    assert sentinel.deltas()[0].compiles == 1
    with pytest.raises(AssertionError, match="retrace budget exceeded"):
        sentinel.assert_within_budget()


def test_captured_step_records_signatures_on_the_cpu():
    from transformer_tpu_torch.train.graph import CapturedStep

    calls = []

    def core(state, src, tgt, scalars):
        calls.append(tuple(tgt.shape))
        return state, {}

    graph = CapturedStep(core, seed=0, device="cpu")
    for width in (8, 8, 16):
        graph("state", None, torch.zeros((2, width), dtype=torch.long), torch.zeros(3))
    assert calls == [(2, 8), (2, 8), (2, 16)]  # eager on the CPU, every call
    assert graph.signatures == {(None, (2, 8)), (None, (2, 16))}
    assert graph.captures == [] and graph.graphs == {}


def test_cli_retrace_on_the_cpu(capsys):
    assert analysis_main(["retrace", "--device", "cpu", "--steps", "1", "--format",
                          "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] is True and payload["device"] == "cpu"
    assert payload["skipped"] == ["sharded"]
    assert len(payload["watches"]) == 8
    assert all(w["compiles"] == 0 for w in payload["watches"])


def test_cli_retrace_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analysis_main(["retrace", "--steps", "1"])
