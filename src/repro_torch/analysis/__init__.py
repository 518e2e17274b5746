"""Static analysis over the port: plan/IR verification and a lint.

Two independent layers share this package because they guard the same
contract — everything the engine launches stays inside the statically
verifiable, device-executable fragment:

* :mod:`repro_torch.analysis.verifier` — a non-executing pass over
  compiled :class:`~repro_torch.core.compiler.Plan` / ``CorePlan``
  artifacts (and the executors built from them) checking the invariants
  the paper's Algorithms 1/4 and the static-capacity runtime rely on.
  Wired into ``Engine`` prepare behind
  ``RuntimeConfig(verify_plans=...)``.
* :mod:`repro_torch.analysis.lint` — an AST lint ("replint") over the
  port's source for device-code pitfalls under torch (hidden host
  syncs, data-dependent shapes, unstable sorts), run through
  ``tools/replint_torch.py``.
"""

from repro_torch.analysis.lint import (
    LintFinding, RULES, lint_file, lint_paths, lint_source,
)
from repro_torch.analysis.verifier import (
    PlanDiagnostic, PlanVerificationError, VerificationReport,
    verify_core, verify_executor, verify_plan, verify_prepared,
)

__all__ = [
    "PlanDiagnostic", "PlanVerificationError", "VerificationReport",
    "verify_plan", "verify_core", "verify_executor", "verify_prepared",
    "LintFinding", "RULES", "lint_source", "lint_file", "lint_paths",
]
