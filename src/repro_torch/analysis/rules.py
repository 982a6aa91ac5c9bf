"""The port's invariant catalog as machine-checked AST rules (mirrors
``repro/analysis/rules.py`` for the contracts that torch code can break).

* ``pad-fill-literal``: softmax-lane and mask fills come from
  ``models/attention.py::NEG``, clamped to the dtype's range
  (``neg_fill``: ``max(NEG, torch.finfo(dtype).min)``, DESIGN.md §7),
  never a hand-rolled ``-inf`` or ``-1e30``.
* ``serve-lock`` and ``serve-except``: the serving engine's lock and
  supervision discipline, under ``serve/``.
* ``learning-dtype``: learning state is fp32 (DESIGN.md §8): under
  ``core/`` only the ``pack_*``/``packed_*`` serving boundary names
  ``torch.bfloat16``, ``torch.float16``, ``torch.int8`` or calls
  ``.half()``/``.bfloat16()``.
* ``infer-pack-mutation``: an ``InferPack`` is derived at a fold boundary
  and replaced, never edited.

The JAX catalog's ``donated-reuse`` and ``jit-purity`` have no
counterpart: the port has no ``jax.jit`` whose ``donate_argnums`` could
hand a buffer away, and nothing it runs is traced once and replayed from
a Python body (its CUDA graphs replay captured kernels, and a capture
that reads host state fails at capture).

Every pattern is a string (``_INF_NAMES``, ``_LOW_PRECISION``), so that
the JAX package's linter, which scans these files too, finds no fill or
dtype in them.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding
from .lint import Module, Rule, dotted_name, register

# ======================================================== pad-fill hygiene --

_INF_NAMES = {"torch.inf", "math.inf", "np.inf", "numpy.inf"}
_FILL_MAG = 10.0 ** 30  # a finite constant this large is a fill


def _is_inf(node: ast.AST) -> bool:
    """Positive infinity in any spelling (the USub parent makes it a fill)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, float) and node.value == float("inf")
    if isinstance(node, ast.Attribute):
        return dotted_name(node) in _INF_NAMES
    if isinstance(node, ast.Call) and dotted_name(node.func) == "float":
        return bool(node.args) and isinstance(node.args[0], ast.Constant) \
            and str(node.args[0].value).strip().lower() == "inf"
    return False


def _fill_of(node: ast.AST) -> Optional[str]:
    """The fill literal ``node`` spells, or None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, float) \
            and node.value == node.value and \
            _FILL_MAG <= abs(node.value) != float("inf"):
        # huge finite magnitudes are fills whatever their sign (the source
        # text `-1e30` parses as USub over this node)
        return repr(node.value)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub) \
            and _is_inf(node.operand):
        return f"-{dotted_name(node.operand) or 'inf'}"
    if isinstance(node, ast.Call) and dotted_name(node.func) == "float" \
            and node.args and isinstance(node.args[0], ast.Constant) and \
            str(node.args[0].value).strip().lower() == "-inf":
        return "float('-inf')"
    return None


@register
class PadFillLiteralRule(Rule):
    """Softmax-lane and mask fills are ``NEG`` clamped to the dtype's
    range (``models/attention.py::neg_fill``), never a hand-rolled
    ``-1e30`` or -inf: -1e30 overflows to -inf in fp16, and a row whose
    every lane is -inf softmaxes to ``-inf - (-inf) = NaN``."""

    id = "pad-fill-literal"
    contract = ("no hand-rolled -1e30 / -inf fill values; use "
                "models.attention.NEG clamped by neg_fill(dtype)")

    def check(self, module: Module) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(module.tree):
            bad = _fill_of(node)
            if bad is not None:
                out.append(module.finding(
                    self.id, node,
                    f"hand-rolled fill literal {bad}: take softmax-lane and "
                    f"mask fills from models.attention.NEG clamped to the "
                    f"dtype's range (neg_fill: max(NEG, "
                    f"torch.finfo(dtype).min)), so narrow floats stay "
                    f"NaN-free"))
        return out


# ===================================================== serve-lock discipline --


_MUTATORS = {"append", "appendleft", "extend", "extendleft", "insert",
             "pop", "popleft", "popitem", "remove", "update", "setdefault",
             "add", "discard"}


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _lock_name(item: ast.withitem) -> Optional[str]:
    attr = _self_attr(item.context_expr)
    if attr is not None and "lock" in attr.lower():
        return attr
    return None


class _Mutation:
    __slots__ = ("attr", "node", "kind")

    def __init__(self, attr: str, node: ast.AST, kind: str) -> None:
        self.attr, self.node, self.kind = attr, node, kind


def _mutations(node: ast.AST) -> List[_Mutation]:
    """self-attribute mutations in a statement subtree: assignments,
    augmented assignments, subscript stores, and container-mutator calls.
    """
    out: List[_Mutation] = []
    for n in ast.walk(node):
        targets: Sequence[ast.AST] = ()
        if isinstance(n, ast.Assign):
            targets = n.targets
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            targets = (n.target,)
        for t in targets:
            attr = _self_attr(t)
            if attr is not None:
                out.append(_Mutation(attr, t, "assignment"))
            if isinstance(t, ast.Subscript):
                attr = _self_attr(t.value)
                if attr is not None:
                    out.append(_Mutation(attr, t, "item assignment"))
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in _MUTATORS:
            attr = _self_attr(n.func.value)
            if attr is not None:
                out.append(_Mutation(attr, n, f".{n.func.attr}() call"))
    return out


@register
class ServeLockRule(Rule):
    """Any ``self`` attribute a class ever mutates under a
    ``with self.<...lock...>:`` block is lock-guarded state: every other
    mutation of it (outside ``__init__``) must also hold a lock,
    otherwise the serving engine's telemetry/registry invariants race."""

    id = "serve-lock"
    contract = ("an attribute mutated under `with self._lock` is never "
                "written without a lock outside __init__")

    def check(self, module: Module) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(module, node))
        return out

    def _check_class(self, module: Module,
                     cls: ast.ClassDef) -> List[Finding]:
        guarded: Dict[str, str] = {}      # attr -> lock attr
        inside_lock: Set[int] = set()     # ids of nodes under any lock
        for n in ast.walk(cls):
            if isinstance(n, ast.With):
                locks = [ln for item in n.items
                         for ln in (_lock_name(item),) if ln]
                if not locks:
                    continue
                for stmt in n.body:
                    for sub in ast.walk(stmt):
                        inside_lock.add(id(sub))
                    for m in _mutations(stmt):
                        guarded.setdefault(m.attr, locks[0])
        if not guarded:
            return []
        out: List[Finding] = []
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__":
                continue  # construction precedes sharing
            for m in _mutations(fn):
                if m.attr in guarded and id(m.node) not in inside_lock:
                    out.append(module.finding(
                        self.id, m.node,
                        f"'self.{m.attr}' is mutated under "
                        f"'self.{guarded[m.attr]}' elsewhere in "
                        f"{cls.name}, but this {m.kind} holds no lock — "
                        f"take the lock or document the threading story "
                        f"with a suppression"))
        return out


# ====================================================== serve-except sinks --


_EXC_SINKS = {
    # supervision sinks: counting or completing is NOT swallowing
    "record_crash", "_note_crash", "_die",
    "_fail_request", "_fail_requests", "_finish_exceptionally",
}


def _catches_broadly(handler: ast.ExceptHandler) -> bool:
    """True for ``except:``, ``except Exception`` and
    ``except BaseException`` (any dotted spelling, incl. tuples)."""
    t = handler.type
    if t is None:
        return True
    parts = t.elts if isinstance(t, ast.Tuple) else [t]
    return any(dotted_name(p).split(".")[-1] in ("Exception",
                                                 "BaseException")
               for p in parts)


def _handler_discharges(handler: ast.ExceptHandler) -> bool:
    """True if the handler re-raises, completes a request future
    (``.error`` assignment / ``done.set()``), or calls a supervision
    sink that does."""
    for n in ast.walk(handler):
        if isinstance(n, ast.Raise):
            return True
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Attribute) and t.attr == "error":
                    return True
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            if n.func.attr in _EXC_SINKS:
                return True
            if n.func.attr == "set" and \
                    isinstance(n.func.value, ast.Attribute) and \
                    n.func.value.attr == "done":
                return True
    return False


@register
class ServeExceptRule(Rule):
    """The serving worker survives exceptions by design, but a broad
    handler that neither re-raises, completes the affected futures, nor
    routes through a supervision sink turns a crash into a silent hang:
    the caller blocks in ``result()`` on a request nobody will finish."""

    id = "serve-except"
    contract = ("an `except Exception`/bare handler under serve/ must "
                "re-raise, complete futures (.error / done.set()), or "
                "call a supervision sink (record_crash/_note_crash/"
                "_fail_*/_die)")

    def check(self, module: Module) -> List[Finding]:
        if "serve/" not in module.path.replace("\\", "/"):
            return []
        out: List[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ExceptHandler) and \
                    _catches_broadly(node) and \
                    not _handler_discharges(node):
                out.append(module.finding(
                    self.id, node,
                    "broad exception handler swallows the error without "
                    "re-raising, completing request futures, or recording "
                    "the crash — a supervised serving path must discharge "
                    "every exception (DESIGN.md §10)"))
        return out


# ========================================================= dtype contracts --


_LOW_PRECISION = {"torch.bfloat16", "torch.float16", "torch.half",
                  "torch.int8"}
_LOW_PRECISION_CASTS = {"half", "bfloat16"}
# The packing boundary (DESIGN.md §8): the core functions that may name a
# low-precision dtype; they derive serving views, never state.
_PACK_PREFIXES = ("pack_", "packed_")
_PACK_FUNCS = {"infer_packed"}


def _is_pack_func(name: str) -> bool:
    return name.startswith(_PACK_PREFIXES) or name in _PACK_FUNCS


@register
class LearningDtypeRule(Rule):
    """Learning state is fp32 (DESIGN.md §8: trace increments ``alpha*x``
    underflow in bf16).  Under ``core/`` only the ``pack_*``/``packed_*``
    serving boundary may name a low-precision torch dtype or cast to
    one."""

    id = "learning-dtype"
    contract = ("no torch.bfloat16/float16/int8 or .half()/.bfloat16() in "
                "core/ outside the pack_*/packed_* serving boundary")

    def check(self, module: Module) -> List[Finding]:
        if "core/" not in module.path.replace("\\", "/"):
            return []
        spans: List[Tuple[int, int]] = [
            (node.lineno, node.end_lineno or node.lineno)
            for node in ast.walk(module.tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and _is_pack_func(node.name)]
        out: List[Finding] = []
        for node in ast.walk(module.tree):
            what = None
            if isinstance(node, ast.Attribute) and \
                    dotted_name(node) in _LOW_PRECISION:
                what = f"dtype '{dotted_name(node)}'"
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _LOW_PRECISION_CASTS and not node.args:
                what = f"cast '.{node.func.attr}()'"
            if what is None:
                continue
            if any(a <= node.lineno <= b for a, b in spans):
                continue
            out.append(module.finding(
                self.id, node,
                f"low-precision {what} in a core learning-state module "
                f"outside the pack_*/packed_* serving boundary — learning "
                f"state is fp32 (DESIGN.md §8)"))
        return out


@register
class InferPackMutationRule(Rule):
    """``InferPack`` is a derived, immutable view: it is constructed by
    ``pack_projection`` at fold boundaries and only ever *replaced*,
    never edited in place — a field write would desynchronize served
    weights from the fp32 state (stale int8 scales, dead tables)."""

    id = "infer-pack-mutation"
    contract = ("InferPack is constructed only in pack_projection and "
                "its fields are never assignment targets")

    _FIELDS = {"w", "b", "scale", "table"}

    def check(self, module: Module) -> List[Finding]:
        out: List[Finding] = []
        pack_spans = [(node.lineno, node.end_lineno or node.lineno)
                      for node in ast.walk(module.tree)
                      if isinstance(node, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))
                      and node.name == "pack_projection"]
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call) and \
                    dotted_name(node.func).split(".")[-1] == "InferPack" \
                    and not any(a <= node.lineno <= b
                                for a, b in pack_spans):
                out.append(module.finding(
                    self.id, node,
                    "InferPack constructed outside pack_projection — "
                    "serving views are derived at fold boundaries only "
                    "(DESIGN.md §8)"))
        # field stores on known packs: names assigned from
        # pack_projection/pack_state, or any `<x>.pack.<field>` chain
        pack_vars: Set[str] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                callee = dotted_name(node.value.func).split(".")[-1]
                if callee in ("pack_projection", "pack_state"):
                    pack_vars.update(t.id for t in node.targets
                                     if isinstance(t, ast.Name))
        for node in ast.walk(module.tree):
            targets: Sequence[ast.AST] = ()
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = (node.target,)
            for t in targets:
                if not isinstance(t, ast.Attribute) or \
                        t.attr not in self._FIELDS:
                    continue
                base = t.value
                if (isinstance(base, ast.Name) and base.id in pack_vars) or \
                        (isinstance(base, ast.Attribute) and
                         base.attr == "pack"):
                    out.append(module.finding(
                        self.id, t,
                        f"assignment to InferPack field '.{t.attr}' — "
                        f"packs are immutable derived views; re-derive "
                        f"with pack_projection/pack_state at a fold "
                        f"boundary instead"))
        return out
