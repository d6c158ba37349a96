"""repro_torch.analysis — the numpy-only analysis modules of
``repro.analysis``: structured findings and the runtime contracts
(IV001-IV005, enabled with ``REPRO_ANALYSIS_CONTRACTS=1``) that the
balancing stack checks on its hot paths."""

from .findings import Finding, format_findings

__all__ = ["Finding", "format_findings"]
