"""repro_torch.analysis — the port's invariant lint, its CUDA kernel audit
and its runtime contracts (mirrors ``repro.analysis``).

* **AST lint rules** (``lint.py``, ``rules.py``): the contracts torch code
  can break — pad-fill hygiene, serve-lock and serve-except discipline,
  the fp32-learning/packed-serving dtype split, immutable serving packs.
  Findings carry file:line anchors, inline suppressions require a reason
  (the JAX linter's ``# repro: suppress[rule] — reason``), and the port's
  own committed baseline (``.analysis-baseline-torch.json``) absorbs
  accepted findings.
* **Kernel audit and contracts** (``plans.py``, ``contracts.py``): the
  static audit of the CUDA sources (accumulator dtypes, guarded TMA
  paths) and the launch plans and output shapes of the kernel wrappers,
  in place of the Pallas audit; the serving quarantine, the router's
  exactly-once ladder and the replica merge, run on the port's engine and
  router on the CPU.

CLI: ``python -m repro_torch.analysis [--strict] [--contracts]``.
"""
from .findings import Finding, load_baseline, save_baseline, split_baselined
from .lint import Module, Rule, all_rules, lint_paths

__all__ = [
    "Finding", "Module", "Rule", "all_rules", "lint_paths",
    "load_baseline", "save_baseline", "split_baselined",
]
