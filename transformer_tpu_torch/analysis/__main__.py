"""``python -m transformer_tpu_torch.analysis`` — the analysis CLI.

Port of ``transformer_tpu/analysis/__main__.py``, its subcommands so far
(exit code 0 = clean, 1 = regressions or violations):

- ``costs [--baseline FILE] [--update-baseline]`` — the cost model: peak
  live-buffer bytes, FLOPs, bytes moved, arithmetic intensity and the
  collective set of every canned program, traced on the ``meta`` device
  (no card needed), gated against ``analysis/costs_baseline.json``.
- ``retrace [--steps N] [--device D]`` — the step-signature sentinel over
  the steady-state serving and training paths (0 new CUDA-graph
  signatures allowed after warm-up). It runs on the card (``--device
  cuda``, the default) and raises without one; ``--device cpu`` runs the
  same paths eagerly, recording the same signatures.

``--format=json`` emits machine-readable output on both. JAX's other
subcommands (``rules``, ``concurrency``, ``sharding``, ``kernels``,
``all``, ``schedules``, ``contracts``) are refused by name, exit code 2:
they are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys

NOT_PORTED = ("rules", "concurrency", "sharding", "kernels", "all", "schedules", "contracts")


def _emit(payload: dict, text: str, fmt: str) -> None:
    print(json.dumps(payload, indent=2, sort_keys=True) if fmt == "json" else text)


def _cmd_costs(args: argparse.Namespace) -> int:
    from transformer_tpu_torch.analysis.costs import (
        default_costs_baseline_path,
        load_costs_baseline,
        run_costs,
        summarize,
        write_costs_baseline,
    )

    baseline = args.baseline or default_costs_baseline_path()
    result = run_costs(baseline_path=baseline, compare=not args.update_baseline)
    if args.update_baseline:
        # Skipped programs keep their existing budget entries.
        keep = {
            name: entry
            for name, entry in load_costs_baseline(baseline).get("programs", {}).items()
            if name in result.skipped
        }
        write_costs_baseline(result.reports, result.kv, baseline, keep=keep)
        print(
            f"budgeted {len(result.reports)} program(s) + "
            f"{len(result.kv)} kv variant(s)"
            + (f" (+{len(keep)} carried forward)" if keep else "")
            + f" -> {baseline}"
        )
        return 0
    _emit(result.to_dict(), summarize(result), args.format)
    return 0 if result.ok else 1


def _cmd_retrace(args: argparse.Namespace) -> int:
    from transformer_tpu_torch.analysis.retrace import REPORTS, SKIPPED_REPORTS
    from transformer_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    deltas = [d for report in REPORTS.values()
              for d in report(steps=args.steps, device=device)]
    ok = all(d.within_budget for d in deltas)
    lines = [
        f"{'PASS' if d.within_budget else 'FAIL'} {d.name}: "
        f"{d.compiles} new step signature(s) over {args.steps} steady-state rounds "
        f"(budget {d.budget})"
        for d in deltas
    ]
    lines += [f"SKIP {name} (not ported yet)" for name in SKIPPED_REPORTS]
    payload = {
        "steps": args.steps,
        "device": str(device),
        "ok": ok,
        "watches": [d.to_dict() for d in deltas],
        "skipped": list(SKIPPED_REPORTS),
    }
    _emit(payload, "\n".join(lines), args.format)
    return 0 if ok else 1


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in NOT_PORTED:
        print(
            f"analysis {argv[0]}: not ported yet (ported: costs, retrace; "
            "see ROADMAP.md)",
            file=sys.stderr,
        )
        return 2
    parser = argparse.ArgumentParser(
        prog="python -m transformer_tpu_torch.analysis",
        description="analyses of the port's programs: the cost model and "
        "the retrace sentinel",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_costs = sub.add_parser(
        "costs", help="cost model: peak bytes / FLOPs / collectives "
        "vs. budget baselines"
    )
    p_costs.add_argument(
        "--baseline", default=None,
        help="budget JSON (default: analysis/costs_baseline.json)",
    )
    p_costs.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the budget baseline with the current numbers",
    )

    p_retrace = sub.add_parser(
        "retrace", help="step-signature sentinel over the serving/train hot paths"
    )
    p_retrace.add_argument(
        "--steps", type=int, default=3,
        help="steady-state rounds after warmup (default 3)",
    )
    p_retrace.add_argument(
        "--device", default="cuda",
        help="where the paths run (default cuda; cpu runs them eagerly)",
    )

    for p in (p_costs, p_retrace):
        p.add_argument(
            "--format", choices=("text", "json"), default="text",
            help="output format (json is diff-able across rounds)",
        )

    args = parser.parse_args(argv)
    return {"costs": _cmd_costs, "retrace": _cmd_retrace}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
