"""CUDA kernel audit: accumulators, guarded TMA paths, launch plans and
logical output shapes (the port's counterpart of
``repro/analysis/plans.py``, which audits the Pallas kernels).

1. **Accumulators** (static): every tensor-core instruction in
   ``kernels/csrc`` (``mma.sync``, ``wgmma.mma_async``, ``wmma.mma``)
   accumulates in the dtype its source declares
   (``KERNEL_ACCUMULATOR_DTYPES``): f32 everywhere, s32 for the exact int8
   products of ``quant.cu``; never an f16 or bf16 accumulator.
2. **TMA guard** (static): every host-side choice of a TMA copy (a
   ``kCopyTma`` copy mode, or the update's bulk-copy bit ``kVecP``) is
   taken only behind a condition that tests the operand's address for
   16-byte alignment (``aligned16(p)``, ``addr % 16 == 0``) and a row or
   column size for divisibility, as ``launch_fwd_tc_any`` does (a TMA box
   whose first column is off a 16-byte boundary faults).  Local ``bool``
   names are read through their definitions; code inside ``__global__``
   and ``__device__`` functions is not a launch path.
3. **Launch plans** (on the card): ``bcpnn_fwd.cluster_size``,
   ``hc_softmax.softmax_plan`` and ``quant.quant_fwd_plan`` return valid
   plans over the JAX audit's hostile geometry sweep (``_DIMS``,
   ``_HC_GEOMS``).
4. **Logical output shapes**: every kernel wrapper of ``kernels/ops.py``
   returns its logical shapes on a deliberately misaligned geometry (B=5,
   pre 7x3, post 3x10, nact 2) and, on the card, agrees with its plain
   version there (``check_output_shapes``; ``check_wrappers`` takes any
   geometry, and the ``gpu`` test sweeps ``_HC_GEOMS`` through it).

1 and 2 read the sources alone; 4 runs the plain versions on the CPU.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "kernels" / "csrc"

# The accumulator dtypes each source's tensor-core instructions may
# carry, and whether it must hold at least one (yardstick.cu reaches the
# tensor cores through common.cuh's mma).
KERNEL_ACCUMULATOR_DTYPES: Dict[str, set] = {
    "bcpnn.cu": {"f32"},
    "common.cuh": {"f32"},
    "quant.cu": {"s32"},
    "yardstick.cu": {"f32"},
}
_HOLDS_PRODUCTS = {"bcpnn.cu", "common.cuh", "quant.cu"}

# The JAX audit's hostile geometry sweep (``repro/analysis/plans.py``):
# the repo's real shapes plus primes and degenerate sizes.
_DIMS = (1, 2, 3, 5, 7, 8, 10, 13, 16, 21, 100, 127, 128, 129, 130, 200,
         1009, 1568)
_HC_GEOMS = ((1, 2), (1, 10), (3, 10), (7, 3), (28, 2), (32, 128),
             (13, 5), (784, 2))

_WGMMA = re.compile(r"wgmma\.mma_async\.sync\.aligned\.m\d+n\d+k\d+"
                    r"\.(\w+)\.(\w+)\.(\w+)")
_MMA = re.compile(r"(?<![\w.])mma\.sync\.aligned\.m\d+n\d+k\d+"
                  r"(?:\.(?:row|col)){0,2}\.(\w+)\.(\w+)\.(\w+)\.(\w+)")
_WMMA = re.compile(r"wmma\.mma\.sync\.aligned\.\w+\.\w+\.m\d+n\d+k\d+"
                   r"\.(\w+)\.(\w+)")


def strip_comments(text: str) -> str:
    """C/C++ source with its comments blanked (newlines kept, so offsets
    and line numbers stay), string and character literals left whole."""
    out, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        if c in "\"'":
            j = i + 1
            while j < n and text[j] != c:
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        elif text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append("".join(ch if ch == "\n" else " " for ch in text[i:j]))
            i = j
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _line(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def check_accumulators(csrc: Optional[Path] = None) -> List[str]:
    """Layer 1: every tensor-core instruction's accumulator dtype is its
    source's declared one; every source is declared; the sources that
    hold products hold at least one."""
    csrc = Path(csrc) if csrc is not None else CSRC
    problems: List[str] = []
    on_disk = {p.name for p in csrc.iterdir()
               if p.suffix in (".cu", ".cuh")}
    for name in sorted(on_disk - set(KERNEL_ACCUMULATOR_DTYPES)):
        problems.append(f"{name}: a CUDA source with no declared "
                        f"accumulator contract (KERNEL_ACCUMULATOR_DTYPES)")
    for name, allowed in sorted(KERNEL_ACCUMULATOR_DTYPES.items()):
        path = csrc / name
        if not path.exists():
            problems.append(f"{name}: declared in KERNEL_ACCUMULATOR_DTYPES "
                            f"but missing on disk")
            continue
        text = strip_comments(path.read_text(encoding="utf-8"))
        found = 0
        for regex, acc_groups in ((_WGMMA, (1,)), (_MMA, (1, 4)),
                                  (_WMMA, (1, 2))):
            for m in regex.finditer(text):
                found += 1
                for g in acc_groups:
                    dt = m.group(g)
                    if dt not in allowed:
                        low = dt in ("f16", "bf16")
                        problems.append(
                            f"{name}:{_line(text, m.start())}: "
                            f"'{m.group(0)}' accumulates in {dt}"
                            + (" (a 16-bit accumulator)" if low else "")
                            + f", but {name} declares {sorted(allowed)}")
        if name in _HOLDS_PRODUCTS and found == 0:
            problems.append(f"{name}: expected tensor-core instructions to "
                            f"audit, found none (scan out of date?)")
    return problems


# ----------------------------------------------------------- TMA guard ----

_SELECTORS = (re.compile(r"\bkCopyTma\b"), re.compile(r"\bkVecP\b"))
_BOOL_DEF = re.compile(r"\bbool\s+(\w+)\s*=\s*([^;]+);")
_ADDR_DECL = re.compile(r"\buintptr_t\s+([^;]+);")
_ADDR_NAME = re.compile(r"(\w+)\s*=\s*\(\s*uintptr_t\s*\)\s*(\w+)")
_SIZE_TEST = re.compile(r"([\w.]+)\s*%\s*(?:\d+|kPer\w*)\s*==\s*0")


def _device_spans(text: str) -> List[Tuple[int, int]]:
    """(start, end) of the bodies of ``__global__`` and ``__device__``
    functions."""
    spans = []
    for m in re.finditer(r"\b__(?:global|device)__\b", text):
        brace, semi = text.find("{", m.end()), text.find(";", m.end())
        if brace < 0 or (0 <= semi < brace):
            continue  # a declaration or a __device__ variable
        depth, i = 0, brace
        while i < len(text):
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
                if depth == 0:
                    break
            i += 1
        spans.append((brace, i))
    return spans


def _paren(text: str, start: int) -> str:
    """The text inside the parenthesis that opens at or after ``start``."""
    i = text.find("(", start)
    depth, j = 0, i
    while j < len(text):
        if text[j] == "(":
            depth += 1
        elif text[j] == ")":
            depth -= 1
            if depth == 0:
                return text[i + 1:j]
        j += 1
    return text[i + 1:]


_IF = re.compile(r"^\s*(?:else\s+)?if\s*(?:constexpr\s*)?\(")


def _is_selection(stmt: str, m: re.Match) -> bool:
    """The selector at ``m`` is a value chosen (not compared, tested or
    defined)."""
    before = stmt[:m.start()].rstrip()
    after = stmt[m.end():].lstrip()
    if before.endswith(("==", "!=", "&")) or after.startswith(("==", "!=")):
        return False
    if re.match(r"=(?!=)", after):  # the enumerator or constant itself
        return False
    return True


def _conditions(text: str, stmt_start: int, stmt: str, at: int,
                stack: List[str]) -> List[str]:
    """The conditions a selection at ``at`` of ``stmt`` stands behind: a
    ternary's, the statement's own ``if``, the enclosing blocks' ``if``s."""
    out = []
    rel = at - stmt_start
    q = stmt.rfind("?", 0, rel)
    if q >= 0 and ":" not in stmt[q:rel]:  # the selector is the true arm
        out.append(stmt[:q])
    if _IF.match(stmt):
        out.append(_paren(stmt, 0))
    for header in stack:
        if _IF.match(header):
            out.append(_paren(header, 0))
    return out


def _expand(cond: str, bools: Dict[str, str], depth: int = 3) -> str:
    """``cond`` with the local ``bool`` names it reads replaced by their
    definitions."""
    for _ in range(depth):
        new = re.sub(r"\b(\w+)\b",
                     lambda m: f"({bools[m.group(1)]})"
                     if m.group(1) in bools else m.group(1), cond)
        if new == cond:
            break
        cond = new
    return cond


def _sized(cond: str, addrs: Dict[str, str]) -> bool:
    """A divisibility test of something other than an address."""
    return any(m.group(1) not in addrs for m in _SIZE_TEST.finditer(cond))


def _aligned(cond: str, addrs: Dict[str, str], operand: str) -> bool:
    """A 16-byte alignment test of ``operand``'s address: ``aligned16(op)``,
    ``((uintptr_t)op & 15u) == 0``, or ``a % 16 == 0`` of an address
    ``a = (uintptr_t)op``."""
    op = re.escape(operand)
    if re.search(rf"\baligned16\s*\(\s*{op}\s*\)", cond) or re.search(
            rf"\(\s*uintptr_t\s*\)\s*{op}\s*&\s*15u?\b", cond):
        return True
    return any(re.search(rf"\b{a}\s*(?:%\s*16\s*==\s*0|&\s*15u?\b)", cond)
               for a, of in addrs.items() if of == operand)


# the operand whose copies a selector chooses: ``<op>copy = ... kCopyTma``,
# and the update's bulk copies of pij for kVecP
_COPY_TARGET = re.compile(r"\*?\s*(\w+)copy\s*=(?!=)")


def _operands(stmt: str, m: re.Match) -> List[str]:
    if m.group(0) == "kVecP":
        return ["pij"]
    return [t.group(1) for t in _COPY_TARGET.finditer(stmt[:m.start()])]


def check_tma_guards(csrc: Optional[Path] = None) -> List[str]:
    """Layer 2: every host-side choice of a TMA path stands behind a
    16-byte alignment test of the address of each operand it moves and a
    size test."""
    csrc = Path(csrc) if csrc is not None else CSRC
    problems: List[str] = []
    n_sites = 0
    for path in sorted(p for p in csrc.iterdir()
                       if p.suffix in (".cu", ".cuh")):
        text = strip_comments(path.read_text(encoding="utf-8"))
        device = _device_spans(text)
        stack: List[str] = []
        start = 0
        for i, c in enumerate(text):
            if c not in "{};":
                continue
            stmt = text[start:i]
            if c == "{":
                stack.append(stmt.strip())
            if not any(a <= start <= b for a, b in device):
                for regex in _SELECTORS:
                    for m in regex.finditer(stmt):
                        if not _is_selection(stmt, m):
                            continue
                        n_sites += 1
                        before = text[:start + m.start()]
                        bools = {b.group(1): b.group(2)
                                 for b in _BOOL_DEF.finditer(before)}
                        addrs = {a.group(1): a.group(2)
                                 for d in _ADDR_DECL.finditer(before)
                                 for a in _ADDR_NAME.finditer(d.group(1))}
                        conds = " && ".join(
                            _expand(cd, bools) for cd in _conditions(
                                text, start, stmt, start + m.start(), stack))
                        ops_ = _operands(stmt, m) or ["?"]
                        bare = [o for o in ops_
                                if not _aligned(conds, addrs, o)]
                        if bare or not _sized(conds, addrs):
                            problems.append(
                                f"{path.name}:{_line(text, start + m.start())}"
                                f": a TMA path ('{' '.join(stmt.split())}') "
                                f"is chosen without a 16-byte alignment "
                                f"guard of {', '.join(bare) or 'its rows'}"
                                f" (guard it as launch_fwd_tc_any does)")
            if c == "}" and stack:
                stack.pop()
            start = i + 1
    if n_sites == 0:
        problems.append("no TMA path found to audit (scan out of date?)")
    return problems


# ------------------------------------------------------------ on the card --

def check_launch_plans() -> List[str]:
    """Layer 3 (needs the card): the launchers' plans over the hostile
    sweep — a forward's cluster size within 1..8 and no wider than its
    contraction's slices, an int8 plan of 64 or 128 rows and a cluster of
    1..MAX_CLUSTER, a softmax plan whose loads cover the segment."""
    import torch
    from ..kernels.bcpnn_fwd import cluster_size
    from ..kernels.hc_softmax import softmax_plan
    from ..kernels.quant import MAX_CLUSTER, quant_fwd_plan
    problems: List[str] = []
    dev = "cuda"
    top = max(_DIMS)
    nj_top = max(h * m for h, m in _HC_GEOMS)
    xbuf = torch.zeros(top * top, device=dev)
    wbuf = torch.zeros(top * nj_top, dtype=torch.int8, device=dev)
    sbuf = torch.zeros(top * nj_top, device=dev)

    def fwd_ok(where, ks, k):
        if not (1 <= ks <= 8 and (ks == 1 or ks <= -(-k // 16))):
            problems.append(f"{where}: cluster size {ks} (contraction {k})")

    for b in _DIMS:
        for hj, mj in _HC_GEOMS:
            s = sbuf[:b * hj * mj].view(b, hj * mj)
            v, lanes, iters = softmax_plan(s, s, mj)
            ok = v in (1, 2, 4) and mj % v == 0 and lanes in (
                1, 2, 4, 8, 16, 32)
            ok &= (iters == 0) if mj > 256 else (
                iters in (1, 2, 4, 8) and lanes * iters * v >= mj)
            if not ok:
                problems.append(f"softmax_plan(B={b}, M={mj}): {(v, lanes, iters)}")
            for ni in _DIMS:
                for bf16 in (False, True):
                    fwd_ok(f"cluster_size({b}, {ni}, {hj}, {mj}, bf16="
                           f"{bf16})", cluster_size(b, ni, hj, mj, bf16), ni)
                x = xbuf[:b * ni].view(b, ni)
                w = wbuf[:ni * hj * mj].view(ni, hj * mj)
                rows, ks = quant_fwd_plan(x, w, hj, mj)
                if rows not in (64, 128) or not 1 <= ks <= MAX_CLUSTER:
                    problems.append(f"quant_fwd_plan(B={b}, Ni={ni}, {hj}x"
                                    f"{mj}): {(rows, ks)}")
            for hi, mi in ((7, 3), (784, 2)):
                for nact in (1, 2):
                    k = nact * mi
                    for layout in ("patchy", "compact"):
                        fwd_ok(f"cluster_size({b}, K={k}, {hj}, {mj}, "
                               f"{layout})",
                               cluster_size(b, k, hj, mj, layout=layout), k)
                    table = torch.zeros((hj, nact), dtype=torch.int32,
                                        device=dev)
                    x = xbuf[:b * hi * mi].view(b, hi * mi)
                    for w in (wbuf[:hi * mi * hj * mj].view(hi * mi, hj * mj),
                              wbuf[:hj * k * mj].view(hj, k, mj)):
                        rows, ks = quant_fwd_plan(x, w, hj, mj, table, mi)
                        if rows not in (64, 128) or not 1 <= ks <= MAX_CLUSTER:
                            problems.append(
                                f"quant_fwd_plan(B={b}, {hi}x{mi} -> {hj}x"
                                f"{mj}, nact {nact}, w {tuple(w.shape)}): "
                                f"{(rows, ks)}")
    return problems


# --------------------------------------------------------- output shapes --

HOSTILE = dict(b=5, hi=7, mi=3, hj=3, mj=10, nact=2)


def check_wrappers(device: str = "cpu", b: int = 5, hi: int = 7, mi: int = 3,
                   hj: int = 3, mj: int = 10, nact: int = 2,
                   seed: int = 0) -> List[str]:
    """Every kernel wrapper of ``kernels/ops.py`` on one geometry: outputs
    of the logical shapes, finite, and on the card equal to the plain
    version within the ``gpu`` tests' tolerances (rates 1e-5 and softmax
    2e-6 absolute; pij' 1e-5 relative, the log-weights 1e-4; int8 rates
    1e-6)."""
    import torch
    from ..core.bcpnn_layer import topk_mask
    from ..core.compact import build_table
    from ..kernels import ops, ref
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int8)

    nact = min(nact, hi)
    ni, nj, k = hi * mi, hj * mj, nact * mi
    table = build_table(topk_mask(rand(hi, hj), nact), nact)
    x, y = rand(b, ni), rand(b, nj)
    w, bias, w_c = randn(ni, nj) * 0.1, randn(nj), randn(hj, k, mj) * 0.1
    lpi = torch.log(rand(ni) * 0.5 + 1e-4)
    lpj = torch.log(rand(nj) * 0.5 + 1e-4)
    pij, pij_c = rand(ni, nj) * 0.01 + 1e-5, rand(hj, k, mj) * 0.01 + 1e-5
    mask = (rand(hi, hj) > 0.3).float()
    a = torch.tensor(0.02, device=device)
    scale = rand(hj) * 0.02 + 1e-3
    w_q, w_qc = codes(ni, nj), codes(hj, k, mj)
    s = randn(b, nj) * 4
    rates, upd, sm, q = 1e-5, (1e-5, 1e-4), 2e-6, 1e-6
    cases: Dict[str, Tuple[Callable, Callable, tuple, object]] = {
        "hc_softmax": (lambda: ops.hc_softmax(s, hj, mj, 1.5),
                       lambda: ref.ref_hc_softmax(s, hj, mj, 1.5),
                       ((b, nj),), sm),
        "bcpnn_fwd": (lambda: ops.bcpnn_fwd(x, w, bias, hj, mj, 1.25),
                      lambda: ref.ref_bcpnn_fwd(x, w, bias, hj, mj, 1.25),
                      ((b, nj),), rates),
        "bcpnn_update": (
            lambda: ops.bcpnn_update(pij, lpi, lpj, x, y, mask, a),
            lambda: ref.ref_bcpnn_update(pij, lpi, lpj, x, y, mask, a),
            ((ni, nj), (ni, nj)), upd),
        "patchy_forward": (
            lambda: ops.patchy_forward(x, w, bias, table, mi, hj, mj, 1.25),
            lambda: ref.ref_patchy_forward(x, w, bias, table, mi, hj, mj,
                                           1.25), ((b, nj),), rates),
        "patchy_update": (
            lambda: ops.patchy_update(pij, lpi, lpj, x, y, table, a, mi, hj,
                                      mj),
            lambda: ref.ref_patchy_update(pij, lpi, lpj, x, y, table, a, mi,
                                          hj, mj), ((ni, nj), (ni, nj)), upd),
        "compact_forward": (
            lambda: ops.compact_forward(x, w_c, bias, table, mi, 1.25),
            lambda: ref.ref_compact_forward(x, w_c, bias, table, mi, 1.25),
            ((b, nj),), rates),
        "compact_update": (
            lambda: ops.compact_update(pij_c, lpi, lpj, x, y, table, a, mi),
            lambda: ref.ref_compact_update(pij_c, lpi, lpj, x, y, table, a,
                                           mi), ((hj, k, mj), (hj, k, mj)),
            upd),
        "quant_fwd": (
            lambda: ops.quant_fwd(x, w_q, bias, scale, hj, mj, 1.25),
            lambda: ref.ref_quant_fwd(x, w_q, bias, scale, hj, mj, 1.25),
            ((b, nj),), q),
        "quant_patchy_forward": (
            lambda: ops.quant_patchy_forward(x, w_q, bias, scale, table, mi,
                                             hj, mj, 1.25),
            lambda: ref.ref_quant_patchy_forward(x, w_q, bias, scale, table,
                                                 mi, hj, mj, 1.25),
            ((b, nj),), q),
        "quant_compact_forward": (
            lambda: ops.quant_compact_forward(x, w_qc, bias, scale, table,
                                              mi, 1.25),
            lambda: ref.ref_quant_compact_forward(x, w_qc, bias, scale,
                                                  table, mi, 1.25),
            ((b, nj),), q),
    }
    problems: List[str] = []
    missing = set(ops.launch_counts()) - set(cases)
    if missing:
        problems.append(f"kernels counted by ops.launch_counts but not "
                        f"checked here: {sorted(missing)}")
    where = f"B={b}, {hi}x{mi} -> {hj}x{mj}, nact {nact} on {device}"
    for name, (kern, plain, shapes, tol) in cases.items():
        try:
            got = kern()
        except Exception as e:  # noqa: BLE001 — any launch failure is the finding
            problems.append(f"{name} ({where}): {type(e).__name__}: {e}")
            continue
        got = got if isinstance(got, tuple) else (got,)
        if tuple(tuple(g.shape) for g in got) != shapes:
            problems.append(f"{name} ({where}): output shapes "
                            f"{[tuple(g.shape) for g in got]} != logical "
                            f"{list(shapes)}")
            continue
        if not all(bool(torch.isfinite(g).all()) for g in got):
            problems.append(f"{name} ({where}): non-finite output")
            continue
        if device == "cpu":
            continue  # the wrapper ran the plain version itself
        want = plain()
        want = want if isinstance(want, tuple) else (want,)
        if isinstance(tol, tuple):  # (pij' relative, w absolute)
            (gp, gw), (wp, ww) = got, want
            bad = not bool(((gp - wp).abs() <= 1e-9 + tol[0] * wp.abs())
                           .all()) or (gw - ww).abs().max().item() > tol[1]
        else:
            bad = (got[0] - want[0]).abs().max().item() > tol
        if bad:
            problems.append(f"{name} ({where}): differs from its plain "
                            f"version beyond {tol}")
    return problems


def check_output_shapes(device: str = "cpu") -> List[str]:
    """Layer 4 on the hostile geometry."""
    return check_wrappers(device, **HOSTILE)


def check_cuda_plans(device: str = "cpu") -> List[str]:
    """Layers 1, 2 and 4; layer 3 too where ``device`` is the card."""
    problems = (check_accumulators() + check_tma_guards()
                + check_output_shapes(device))
    if device != "cpu":
        problems += check_launch_plans()
    return problems
