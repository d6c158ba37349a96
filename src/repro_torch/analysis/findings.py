"""Structured findings shared by all `repro.analysis` passes.

Every pass (lint, jaxpr audit, race detection, invariant contracts) reports
the same shape: a rule id, a severity, a location — ``file:line`` for static
rules, a trace location (``trace:…`` / ``jaxpr:…``) for dynamic ones — and a
human-readable message.  The CLI renders them one per line and fails the
build when any error-severity finding survives.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

__all__ = ["Finding", "format_findings"]

SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    """One rule violation reported by an analysis pass."""

    rule: str        # "RL001", "JA002", "RC001", "IV003", ...
    severity: str    # "error" | "warning"
    location: str    # "src/repro/foo.py:42" | "trace:KernelTuner#1.tables" | "jaxpr:compiled step"
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, got {self.severity!r}")

    def format(self) -> str:
        return f"{self.location}: {self.severity}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return asdict(self)


def format_findings(findings) -> str:
    """Render findings one per line, errors first, stable within severity."""
    ordered = sorted(findings, key=lambda f: (f.severity != "error", f.rule, f.location))
    return "\n".join(f.format() for f in ordered)
