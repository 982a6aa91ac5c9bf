"""Findings, inline suppressions, and the committed baseline (mirrors
``repro/analysis/findings.py``).

The port's invariant linter (``repro_torch.analysis``) reports
machine-checked contract violations as ``Finding``s with a stable rule id
and a ``file:line`` anchor.  Two escape hatches exist, both auditable:

* **Inline suppression** — ``# repro: suppress[rule-id] — reason`` on
  the finding's line (or the line directly above it).  The reason is
  REQUIRED: a suppression without one is itself reported
  (``suppress-needs-reason``), so every waived contract carries its
  justification in the diff.
* **Committed baseline** — a JSON file of accepted pre-existing
  findings (``.analysis-baseline-torch.json`` at the repo root, the
  port's own; the JAX package's linter keeps ``.analysis-baseline.json``).  Baseline
  entries match on (rule, path, source-line text), NOT on line numbers,
  so unrelated edits above a baselined finding do not resurrect it.

``--strict`` fails on any finding that is neither suppressed inline nor
in the baseline.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

SEVERITIES = ("error", "warning")

# ``# repro: suppress[rule-a,rule-b] — reason`` (the JAX linter's syntax,
# so one comment serves both linters; hyphen/en/em dash all
# accepted as the reason separator; the reason itself is mandatory and
# validated by the linter, not the regex).
_SUPPRESS_RE = re.compile(
    r"#\s*repro:\s*suppress\[(?P<rules>[A-Za-z0-9_,\- ]+)\]"
    r"(?:\s*(?:—|–|--|-)\s*(?P<reason>.*\S))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation at a file:line anchor."""

    rule: str
    path: str          # repo-relative, '/'-separated
    line: int          # 1-indexed
    message: str
    severity: str = "error"
    snippet: str = ""  # stripped source line (baseline fingerprint)

    def format(self) -> str:
        return (f"{self.path}:{self.line}: {self.severity}[{self.rule}] "
                f"{self.message}")

    def fingerprint(self) -> Tuple[str, str, str]:
        """Line-number-free identity used by the baseline: unrelated
        edits that shift a finding do not invalidate its entry."""
        return (self.rule, self.path, self.snippet)


@dataclasses.dataclass(frozen=True)
class Suppression:
    """One parsed inline suppression comment."""

    rules: Tuple[str, ...]
    line: int
    reason: Optional[str]


def parse_suppressions(source_lines: List[str]) -> List[Suppression]:
    out = []
    for i, text in enumerate(source_lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if m is None:
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(",")
                      if r.strip())
        out.append(Suppression(rules=rules, line=i, reason=m.group("reason")))
    return out


def apply_suppressions(findings: List[Finding],
                       suppressions: List[Suppression],
                       path: str) -> List[Finding]:
    """Drop findings covered by an inline suppression on their own line
    or the line directly above; emit ``suppress-needs-reason`` for any
    suppression missing its reason."""
    by_line: Dict[int, List[Suppression]] = {}
    for s in suppressions:
        by_line.setdefault(s.line, []).append(s)

    def covered(f: Finding) -> bool:
        for line in (f.line, f.line - 1):
            for s in by_line.get(line, ()):
                if f.rule in s.rules and s.reason:
                    return True
        return False

    kept = [f for f in findings if not covered(f)]
    for s in suppressions:
        if not s.reason:
            kept.append(Finding(
                rule="suppress-needs-reason", path=path, line=s.line,
                message=(f"suppression of {list(s.rules)} has no reason; "
                         f"write '# repro: suppress[rule] — why'"),
                snippet=f"suppress[{','.join(s.rules)}]"))
    return kept


# ------------------------------------------------------------ baseline ----

def load_baseline(path: Path) -> List[Dict[str, str]]:
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    return list(data.get("findings", []))


def save_baseline(path: Path, findings: Iterable[Finding]) -> None:
    entries = [{"rule": f.rule, "path": f.path, "snippet": f.snippet,
                "message": f.message}
               for f in sorted(findings, key=lambda f: (f.path, f.line))]
    path.write_text(json.dumps(
        {"comment": "accepted pre-existing findings; regenerate with "
                    "`python -m repro_torch.analysis --write-baseline`",
         "findings": entries}, indent=2) + "\n")


def split_baselined(findings: List[Finding],
                    baseline: List[Dict[str, str]]
                    ) -> Tuple[List[Finding], List[Finding]]:
    """(new, baselined) partition by line-free fingerprint.  Each
    baseline entry absorbs at most one finding, so a *second* instance
    of a baselined pattern in the same file is still new."""
    budget: Dict[Tuple[str, str, str], int] = {}
    for e in baseline:
        key = (e["rule"], e["path"], e.get("snippet", ""))
        budget[key] = budget.get(key, 0) + 1
    new, old = [], []
    for f in findings:
        key = f.fingerprint()
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old
