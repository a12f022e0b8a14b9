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
from typing import Tuple

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
