"""Serving errors (the part of ``repro.runtime.guard`` this slice serves)."""
from __future__ import annotations

from typing import Optional, Tuple


class PoisonFrameError(RuntimeError):
    """A frame failed its health verdict under ``plan.on_poison="raise"``.

    ``health`` carries the ``(nan, inf, out_of_range)`` pixel counts (None
    for a frame rejected for its dtype)."""

    def __init__(self, msg: str, health: Optional[Tuple[int, int, int]] = None):
        super().__init__(msg)
        self.health = health
