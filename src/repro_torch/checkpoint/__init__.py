"""Checkpointing substrate (atomic, versioned, in the reference's layout)."""

from .ckpt import save, restore, latest_step, all_steps

__all__ = ["save", "restore", "latest_step", "all_steps"]
