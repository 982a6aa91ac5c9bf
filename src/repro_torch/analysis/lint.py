"""AST lint engine: file walking, rule registry, suppression plumbing
(mirrors ``repro/analysis/lint.py``).

Rules are plain classes with a stable ``id`` and a ``check(module)``
method returning raw findings; the engine owns everything rule authors
should not re-implement — parsing, repo-relative paths, snippet capture
for baseline fingerprints, and inline-suppression filtering.  All rules
use only stdlib ``ast``: the linter must run in any environment that can
run the repo (no new hard dependencies).
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Type

from .findings import Finding, apply_suppressions, parse_suppressions

# Directories never scanned: the lint fixture corpus is known-bad by
# design, and caches/VCS internals are not source.
SKIP_DIRS = {"__pycache__", ".git", "fixtures", ".pytest_cache",
             "node_modules", ".mypy_cache"}


@dataclasses.dataclass
class Module:
    """One parsed source file handed to every rule."""

    path: str                # repo-relative, '/'-separated
    abspath: Path
    tree: ast.Module
    lines: List[str]         # 1-indexed via lines[line - 1]

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str,
                severity: str = "error") -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule=rule, path=self.path, line=line, message=message,
                      severity=severity, snippet=self.snippet(line))


class Rule:
    """Base class: subclasses define ``id``, ``contract`` (one line,
    printed by ``--list-rules``) and ``check``."""

    id: str = ""
    contract: str = ""

    def check(self, module: Module) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError


_REGISTRY: Dict[str, Type[Rule]] = {}


def register(cls: Type[Rule]) -> Type[Rule]:
    if not cls.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if cls.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {cls.id!r}")
    _REGISTRY[cls.id] = cls
    return cls


def all_rules() -> Dict[str, Type[Rule]]:
    from . import rules  # noqa: F401  (import populates the registry)
    return dict(_REGISTRY)


def parse_module(abspath: Path, root: Path) -> Optional[Module]:
    try:
        text = abspath.read_text(encoding="utf-8")
        tree = ast.parse(text, filename=str(abspath))
    except (OSError, SyntaxError, UnicodeDecodeError):
        return None
    try:
        rel = abspath.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        rel = abspath.as_posix()
    return Module(path=rel, abspath=abspath, tree=tree,
                  lines=text.splitlines())


def iter_py_files(paths: Sequence[Path]) -> Iterable[Path]:
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not any(part in SKIP_DIRS for part in f.parts):
                    yield f


def lint_paths(paths: Sequence[Path], root: Path,
               rule_ids: Optional[Sequence[str]] = None,
               honor_suppressions: bool = True) -> List[Finding]:
    """Run the (selected) rules over every ``*.py`` under ``paths``.

    ``honor_suppressions=False`` reports raw findings — the fixture
    tests use it to pin each rule's exact output independently of any
    suppression comments a fixture might also exercise.
    """
    registry = all_rules()
    ids = list(rule_ids) if rule_ids else sorted(registry)
    unknown = [i for i in ids if i not in registry]
    if unknown:
        raise ValueError(f"unknown rule ids {unknown}; "
                         f"known: {sorted(registry)}")
    rules = [registry[i]() for i in ids]
    out: List[Finding] = []
    for f in iter_py_files(paths):
        module = parse_module(f, root)
        if module is None:
            continue
        found: List[Finding] = []
        for rule in rules:
            found.extend(rule.check(module))
        if honor_suppressions:
            found = apply_suppressions(
                found, parse_suppressions(module.lines), module.path)
        out.extend(found)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


# Small shared AST helpers used by several rules ------------------------

def dotted_name(node: ast.AST) -> str:
    """'torch.nn.functional.pad' for Attribute/Name chains, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def walk_scoped(node: ast.AST,
                enter: Callable[[ast.AST], bool]) -> None:
    """ast.walk that lets the callback prune subtrees (return False)."""
    if not enter(node):
        return
    for child in ast.iter_child_nodes(node):
        walk_scoped(child, enter)
