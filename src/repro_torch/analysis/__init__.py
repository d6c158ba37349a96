"""repro_torch.analysis — static analysis and invariant verification for
the balancing stack, the port of ``repro.analysis``.

Four passes behind one CLI (``python -m repro_torch.analysis
[lint|audit|races|invariants|all]``), all reporting structured
:class:`~repro_torch.analysis.findings.Finding`s:

* :mod:`~repro_torch.analysis.lint` — repo-specific AST rules
  (RL001–RL006);
* :mod:`~repro_torch.analysis.step_audit` — the host-sync and region
  contracts of recorded decode steps (JA001–JA004; the counterpart of the
  reference's ``jaxpr_audit``);
* :mod:`~repro_torch.analysis.races` — vector-clock happens-before race
  detection over replayed pool schedules (RC001);
* :mod:`~repro_torch.analysis.invariants` — toggleable runtime contracts
  (IV001–IV005, enabled with ``REPRO_ANALYSIS_CONTRACTS=1``).

Submodules are imported lazily: ``findings``/``lint``/``invariants`` are
stdlib+numpy only, and instrumented hot paths import ``invariants``
without pulling the torch-facing passes in.
"""

from .findings import Finding, format_findings

__all__ = [
    "Finding",
    "format_findings",
    "lint",
    "step_audit",
    "races",
    "invariants",
]

_SUBMODULES = ("lint", "step_audit", "races", "invariants", "findings")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
