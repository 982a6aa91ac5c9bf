"""``python -m repro_torch.analysis`` — run the port's invariant linter
and, with ``--contracts``, its CUDA audit and runtime contracts.

By default it scans the port's own files: ``src/repro_torch/``,
``tests/test_torch_*.py`` and ``chip_smoke.py`` (the JAX package's linter,
``python -m repro.analysis``, scans the whole repo with its own rules).

Exit codes (the JAX linter's): 0 = clean (modulo suppressions and the
baseline), 1 = findings or contract failures under ``--strict``, 2 =
usage error.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

BASELINE_NAME = ".analysis-baseline-torch.json"


def repo_root() -> Path:
    """The repo root: nearest ancestor of this file holding
    src/repro_torch."""
    here = Path(__file__).resolve()
    for cand in here.parents:
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return Path.cwd()


def default_paths(root: Path) -> List[Path]:
    """The port's files: its package, its tests, its smoke script."""
    paths = [root / "src" / "repro_torch"]
    paths += sorted((root / "tests").glob("test_torch_*.py"))
    if (root / "chip_smoke.py").exists():
        paths.append(root / "chip_smoke.py")
    return [p for p in paths if p.exists()]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's invariant linter + contract checker")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to lint (default: src/repro_torch, "
                             "tests/test_torch_*.py and chip_smoke.py under "
                             "the repo root)")
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 on any unsuppressed, unbaselined "
                             "finding (and on contract failures)")
    parser.add_argument("--baseline", default=None,
                        help=f"baseline file (default: {BASELINE_NAME} at "
                             f"the repo root)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="accept all current findings into the baseline")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline (report everything)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids to run (default all)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("--contracts", nargs="?", const="all", default=None,
                        metavar="NAMES",
                        help="also run the contract checks (all, or a "
                             "comma-separated subset: cuda-plans, "
                             "quarantine-rollback, router-exactly-once, "
                             "replica-merge)")
    args = parser.parse_args(argv)

    root = repo_root()
    from .findings import load_baseline, save_baseline, split_baselined
    from .lint import all_rules, lint_paths

    if args.list_rules:
        for rid, cls in sorted(all_rules().items()):
            print(f"{rid:22s} {cls.contract}")
        return 0

    rule_ids = ([r.strip() for r in args.rules.split(",") if r.strip()]
                if args.rules else None)
    paths = ([Path(p) for p in args.paths] if args.paths
             else default_paths(root))
    try:
        findings = lint_paths(paths, root, rule_ids=rule_ids)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    baseline_path = (Path(args.baseline) if args.baseline
                     else root / BASELINE_NAME)
    if args.write_baseline:
        save_baseline(baseline_path, findings)
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0
    baseline = [] if args.no_baseline else load_baseline(baseline_path)
    new, baselined = split_baselined(findings, baseline)

    for f in new:
        print(f.format())
    if baselined:
        print(f"({len(baselined)} baselined finding(s) suppressed; "
              f"--no-baseline to show)")

    failed = bool(new)
    if args.contracts is not None:
        names = (None if args.contracts == "all"
                 else [n.strip() for n in args.contracts.split(",")
                       if n.strip()])
        from .contracts import run_contracts
        try:
            results = run_contracts(names)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        for name, problems in results.items():
            print(f"contract {name}: {'FAIL' if problems else 'ok'}")
            for p in problems:
                print(f"  - {p}")
            failed = failed or bool(problems)

    if not failed:
        print("analysis clean" + ("" if args.contracts is None
                                  else " (lint + contracts)"))
        return 0
    # informational mode still reports, but only --strict gates
    return 1 if args.strict else 0


if __name__ == "__main__":
    sys.exit(main())
