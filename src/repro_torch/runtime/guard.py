"""Serving errors and the resilience ledger (the part of
``repro.runtime.guard`` this package serves).

`ResilienceGuard` here is the reference's event ledger alone: poison
verdicts and stream retirements are recorded through ``record`` and
reported by ``summary`` (``SREngine.summary()["degradations"]``). The
degradation ladder and the fault injector are not ported: a kernel launch
or a graph capture that fails raises, and never steps down to a plain
version.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class PoisonFrameError(RuntimeError):
    """A frame failed its health verdict under ``plan.on_poison="raise"``.

    ``health`` carries the ``(nan, inf, out_of_range)`` pixel counts (None
    for a frame rejected for its dtype)."""

    def __init__(self, msg: str, health: Optional[Tuple[int, int, int]] = None):
        super().__init__(msg)
        self.health = health


class ResilienceGuard:
    """The serving-side event ledger. Every event is ``{"index", "kind",
    "reason"}``; ``index`` is the engine's monotone frame index."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []

    def record(self, index, kind: str, reason: str) -> None:
        self.events.append({"index": index, "kind": kind, "reason": reason})

    def summary(self) -> Dict[str, Any]:
        """The ledger in the reference's shape: the ladder never moves here,
        so ``level`` stays 0, ``variant`` "as-planned" and ``by_step`` empty."""
        by_kind: Dict[str, int] = {}
        for e in self.events:
            by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
        return {"total": len(self.events), "by_kind": by_kind, "by_step": {},
                "level": 0, "variant": "as-planned", "events": list(self.events[-32:])}
