"""Data pipeline substrate."""

from .pipeline import DataConfig, SyntheticLM, Prefetcher

__all__ = ["DataConfig", "SyntheticLM", "Prefetcher"]
