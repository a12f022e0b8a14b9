"""FrameResult — the one return type of every SREngine call (twin of
``repro.api.result`` over the fields this package serves)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import subnet_policy as sp


@dataclasses.dataclass
class FrameResult:
    image: Optional[torch.Tensor]             # (H*s, W*s, 3); None in stats records
    mode: str                                 # "edge_select" | "all_patches" | "whole"
    backend: str                              # "cuda" | "cuda-plain" | "ref"
    ids: Optional[np.ndarray] = None          # (N,) subnet id per patch
    scores: Optional[np.ndarray] = None       # (N,) edge score per patch
    counts: Tuple[int, int, int] = (0, 0, 0)  # (bilinear, C27, C54) patches
    mac_saving: float = 0.0                   # vs all-C54
    latency_s: float = 0.0                    # wall clock incl. device sync
    thresholds: Tuple[float, float] = (0.0, 0.0)   # (0, 0) when routing ignored them
    dispatch: str = "host"
    # False when this call paid one-off set-up (the first frame of a
    # geometry: index maps, kernel builds); excluded from latency aggregates
    compiled: bool = True
    # (nan, inf, out-of-[0,1]) pixel counts of the raw frame; None when
    # plan.on_poison == "off"
    health: Optional[Tuple[int, int, int]] = None

    @property
    def n_patches(self) -> int:
        return 0 if self.ids is None else int(len(self.ids))


def summarize_stats(stats) -> dict:
    """Aggregate over frame records: routing shares, MAC saving, latency of
    the frames that paid no set-up (all frames if every one did)."""
    stats = list(stats)
    if not stats:
        return {}
    counts = np.array([s.counts for s in stats])
    total = counts.sum()
    steady = [s for s in stats if s.compiled]
    lat = [s.latency_s for s in (steady if steady else stats)]
    out = {
        "frames": len(stats),
        "subnet_share": dict(zip(sp.SUBNET_NAMES,
                                 (counts.sum(0) / max(total, 1)).round(4).tolist())),
        "mean_mac_saving": float(np.mean([s.mac_saving for s in stats])),
        "mean_latency_s": float(np.mean(lat)),
    }
    if len(steady) < len(stats):
        out["warmup_frames_excluded"] = len(stats) - len(steady)
    poisoned = sum(1 for s in stats if any(s.health or ()))
    if poisoned:
        out["poison_frames"] = poisoned
    return out
