"""Shared finding/fingerprint/suppression/baseline plumbing for the lint
families (port of ``transformer_tpu/analysis/baselines.py``).

A :class:`Finding` with a line-number-free fingerprint, inline ``# tpa:
disable=CODE`` suppressions, and a checked-in JSON baseline with the
``--update-baseline`` grandfather loop. The fingerprint format, the
baseline JSON schema and the suppression grammar are the JAX package's, so
its baselines read here unchanged. ``_package_root`` is the port's
package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Iterable

# Inline suppression grammar: `# tpa: disable` (blanket) or
# `# tpa: disable=TPA001,TPA006 — reason` (listed codes only).
_SUPPRESS_RE = re.compile(r"#\s*tpa:\s*disable(?:\s*=\s*([A-Z0-9_,\s]+))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding. ``fingerprint`` is line-number-free (code + file +
    enclosing symbol + stripped source text) so baselines survive unrelated
    edits above the finding."""

    code: str
    path: str
    line: int
    symbol: str
    message: str
    snippet: str

    @property
    def fingerprint(self) -> str:
        return f"{self.code}:{self.path}:{self.symbol}:{self.snippet}"

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
            "snippet": self.snippet,
            "fingerprint": self.fingerprint,
        }

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.code} [{self.symbol}] {self.message}"


@dataclasses.dataclass
class RulesReport:
    findings: list[Finding]
    baselined: list[Finding]
    files_checked: int

    @property
    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.code] = out.get(f.code, 0) + 1
        return out

    def to_dict(self) -> dict:
        return {
            "files_checked": self.files_checked,
            "counts": self.counts,
            "findings": [f.to_dict() for f in self.findings],
            "baselined": [f.to_dict() for f in self.baselined],
        }


def line_suppressed(lines: list[str], finding: Finding) -> bool:
    """Is ``finding`` suppressed by a ``# tpa: disable`` comment on its own
    line? (``lines`` is the module source, pre-split.)"""
    if not 0 < finding.line <= len(lines):
        return False
    m = _SUPPRESS_RE.search(lines[finding.line - 1])
    if not m:
        return False
    codes = m.group(1)
    if codes is None:
        return True  # blanket `# tpa: disable`
    return finding.code in {c.strip() for c in codes.split(",")}


def _package_root() -> str:
    import transformer_tpu_torch

    return os.path.dirname(os.path.abspath(transformer_tpu_torch.__file__))


def load_baseline(path: str | None) -> dict[str, str]:
    """fingerprint -> justification. Missing file = empty baseline."""
    if path is None or not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    out: dict[str, str] = {}
    for entry in data.get("findings", []):
        out[entry["fingerprint"]] = entry.get("reason", "")
    return out


def write_baseline(report: RulesReport, path: str, reason: str = "grandfathered") -> None:
    """Persist every current finding as the new baseline (the `--update-
    baseline` workflow: lint, eyeball, grandfather what stays)."""
    payload = {
        "findings": [
            {"fingerprint": f.fingerprint, "reason": reason, "line": f.line}
            for f in (*report.findings, *report.baselined)
        ]
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")


def _iter_py_files(paths: Iterable[str]) -> Iterable[tuple[str, str]]:
    """(abs_path, display_path) for every .py under ``paths``."""
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            yield p, os.path.basename(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for fname in sorted(filenames):
                if fname.endswith(".py"):
                    full = os.path.join(dirpath, fname)
                    yield full, os.path.relpath(full, os.path.dirname(p))
