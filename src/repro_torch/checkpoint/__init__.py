"""Atomic, async checkpoints (the port's copy of ``repro/checkpoint``)."""

from . import checkpoint
from .checkpoint import (gc_keep_last, latest_step, restore, save, save_async,
                         wait_for_pending)

__all__ = ["checkpoint", "save", "save_async", "restore", "latest_step",
           "gc_keep_last", "wait_for_pending"]
