"""Subnet decision with input edge thresholds (twin of
``repro.core.subnet_policy``).

Three subnets: 0 = bilinear, 1 = C27, 2 = C54.
    score <  t1        -> bilinear
    t1 <= score < t2   -> C27
    score >= t2        -> C54
MAC savings are relative to running every patch through C54.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.models.essr import ESSRConfig, essr_macs_per_lr_pixel

BILINEAR, C27, C54 = 0, 1, 2
SUBNET_NAMES = ("bilinear", "C27", "C54")

DEFAULT_T1 = 8.0
DEFAULT_T2 = 40.0


def decide(scores, t1: float = DEFAULT_T1, t2: float = DEFAULT_T2) -> np.ndarray:
    """(N,) float32 edge scores (host array) -> (N,) int32 subnet ids. The
    thresholds compare in the scores' own precision, as in the reference."""
    s = np.asarray(scores)
    return np.where(s >= s.dtype.type(t2), C54,
                    np.where(s >= s.dtype.type(t1), C27, BILINEAR)).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SubnetMacs:
    """Per-patch MAC cost of each subnet for one config / patch size."""
    per_patch: Tuple[int, int, int]

    @staticmethod
    def make(cfg: ESSRConfig, patch: int = 32) -> "SubnetMacs":
        area = patch * patch
        return SubnetMacs(tuple(essr_macs_per_lr_pixel(cfg, w) * area
                                for w in cfg.subnet_widths()))

    def total(self, counts) -> int:
        return int(sum(int(c) * m for c, m in zip(counts, self.per_patch)))

    def saving_vs_c54(self, counts) -> float:
        n = int(sum(int(c) for c in counts))
        full = n * self.per_patch[C54]
        return 1.0 - self.total(counts) / full if full else 0.0


def subnet_counts(ids) -> Tuple[int, int, int]:
    ids = np.asarray(ids)
    return tuple(int((ids == k).sum()) for k in (BILINEAR, C27, C54))


def _decide_f32(scores, t1: float, t2: float) -> np.ndarray:
    """`decide` on the scores as float32: the reference routes
    ``jnp.asarray(scores)``, which is float32 with x64 off, so a float64
    score within float32 rounding of t1 or t2 routes as its float32 does."""
    return decide(np.asarray(scores, np.float32), t1, t2)


def mac_saving(scores, t1: float, t2: float, cfg: ESSRConfig,
               patch: int = 32) -> Dict[str, float]:
    counts = subnet_counts(_decide_f32(scores, t1, t2))
    m = SubnetMacs.make(cfg, patch)
    return {
        "counts": counts,
        "total_macs": m.total(counts),
        "saving_vs_c54": m.saving_vs_c54(counts),
    }


def thresholds_for_target_saving(scores, target: float, cfg: ESSRConfig,
                                 patch: int = 32,
                                 t1_grid=None, t2_grid=None) -> Tuple[float, float]:
    """(t1, t2) on a coarse grid whose MAC saving is closest to ``target``
    (Table X's 40/50/60% operating points); the first of equals wins."""
    t1_grid = t1_grid if t1_grid is not None else np.arange(0, 41, 2)
    t2_grid = t2_grid if t2_grid is not None else np.arange(10, 201, 5)
    best, best_err = (DEFAULT_T1, DEFAULT_T2), np.inf
    m = SubnetMacs.make(cfg, patch)
    for t1 in t1_grid:
        for t2 in t2_grid:
            if t2 <= t1:
                continue
            counts = subnet_counts(_decide_f32(scores, float(t1), float(t2)))
            err = abs(m.saving_vs_c54(counts) - target)
            if err < best_err:
                best, best_err = (float(t1), float(t2)), err
    return best
