"""Resource-adaptive model switching, paper Sec. IV-A, Algorithm 1 (twin of
the single-stream half of ``repro.core.adaptive``).

Host-side feedback controller over the two edge thresholds:

  * hard compute ceiling: if the number of C54 patches this second exceeds
    ``c54_per_sec_budget`` (25 500 for 8K@30FPS on the paper's PE array), the
    rest of the patches run with C27;
  * per-frame trim: > ``frame_high`` C54 patches in a frame -> (t1,t2) += (1,5)
                    < ``frame_low``  C54 patches in a frame -> (t1,t2) -= (1,5)

A missed frame deadline raises the thresholds too (straggler demotion).
Host numpy throughout; the serving path feeds it the frame's scores (host
dispatch) or its materialized C54 count (fused dispatch).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import subnet_policy as sp


@dataclasses.dataclass
class SwitchingConfig:
    t1: float = sp.DEFAULT_T1
    t2: float = sp.DEFAULT_T2
    c54_per_sec_budget: int = 25_500
    frame_high: int = 1000
    frame_low: int = 700
    fps: int = 30
    t1_step: float = 1.0
    t2_step: float = 5.0
    t1_bounds: Tuple[float, float] = (0.0, 255.0)
    t2_bounds: Tuple[float, float] = (1.0, 255.0)


class AdaptiveSwitcher:
    """Stateful Algorithm-1 controller, one per stream."""

    def __init__(self, cfg: Optional[SwitchingConfig] = None):
        self.cfg = cfg = cfg if cfg is not None else SwitchingConfig()
        self.t1 = float(cfg.t1)
        self.t2 = float(cfg.t2)
        self._c54_this_second = 0
        self._frames_this_second = 0

    def assign(self, scores) -> np.ndarray:
        """Edge scores of one frame's patches (raster order) -> subnet ids:
        the per-second C54 ceiling (overflow demoted to C27 in raster order),
        then the per-frame threshold trim."""
        scores = np.asarray(scores)
        ids = np.array(sp.decide(scores, self.t1, self.t2))
        budget_left = self.cfg.c54_per_sec_budget - self._c54_this_second
        c54_idx = np.flatnonzero(ids == sp.C54)
        if len(c54_idx) > budget_left:
            ids[c54_idx[max(budget_left, 0):]] = sp.C27
        self.observe_frame(int((ids == sp.C54).sum()))
        return ids

    def observe_frame(self, n_c54: int) -> None:
        """Feed back one served frame's C54 count: the per-frame trim and the
        per-second bookkeeping (``assign`` minus the routing; fused dispatch
        routes in its graph and calls this with the materialized count)."""
        n_c54 = int(n_c54)
        self._c54_this_second += n_c54
        if n_c54 > self.cfg.frame_high:
            self.t1 += self.cfg.t1_step
            self.t2 += self.cfg.t2_step
        elif n_c54 < self.cfg.frame_low:
            self.t1 -= self.cfg.t1_step
            self.t2 -= self.cfg.t2_step
        self._clamp()
        self._frames_this_second += 1
        if self._frames_this_second >= self.cfg.fps:
            self._frames_this_second = 0
            self._c54_this_second = 0

    def demote_for_straggler(self, severity: float = 1.0) -> None:
        """A late frame raises the thresholds in proportion to ``severity``."""
        self.t1 += self.cfg.t1_step * severity
        self.t2 += self.cfg.t2_step * severity
        self._clamp()

    def _clamp(self) -> None:
        c = self.cfg
        self.t1 = float(np.clip(self.t1, *c.t1_bounds))
        self.t2 = float(np.clip(self.t2, *c.t2_bounds))
        if self.t2 <= self.t1:          # keep the decision boundary ordered
            self.t2 = self.t1 + 1.0

    @property
    def thresholds(self) -> Tuple[float, float]:
        return (self.t1, self.t2)
