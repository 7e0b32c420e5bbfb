"""Atomic, manifest-verified checkpoints (the export plane's collector
durability)."""
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
