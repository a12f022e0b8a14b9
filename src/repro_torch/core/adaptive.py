"""Resource-adaptive model switching, paper Sec. IV-A, Algorithm 1 (twin of
``repro.core.adaptive`` for one stream and for multi-tenant serving).

Host-side feedback controller over the two edge thresholds:

  * hard compute ceiling: if the number of C54 patches this second exceeds
    ``c54_per_sec_budget`` (25 500 for 8K@30FPS on the paper's PE array), the
    rest of the patches run with C27;
  * per-frame trim: > ``frame_high`` C54 patches in a frame -> (t1,t2) += (1,5)
                    < ``frame_low``  C54 patches in a frame -> (t1,t2) -= (1,5)

A missed frame deadline raises the thresholds too (straggler demotion).
Host numpy throughout; the serving path feeds it the frame's scores (host
dispatch) or its materialized C54 count (fused dispatch).

The sharded patch stream (`ShardSwitcherBank`) gives each raster strip of
a frame a controller of its own, its budgets split evenly
(`per_shard_config`); a missed frame deadline demotes the strips whose MAC
cost runs past the mean.

Multi-tenant serving (`StreamSwitcherBank`) gives every tenant stream a
controller of its own, its budgets split by the stream's share
(`per_stream_config`); a missed tick deadline demotes only the streams whose
share-weighted MAC cost runs past the mean.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# the sharded patch stream: one Algorithm-1 controller per shard
# ---------------------------------------------------------------------------

def per_shard_config(cfg: SwitchingConfig, shards: int) -> SwitchingConfig:
    """``cfg`` split across ``shards`` equal shards: each sees ~1/shards of
    a frame's patches, so the C54 budget a second and the trim bands scale
    down with it (positive values floored at 1; 0 stays 0, since
    ``frame_low=0`` means "never decay"); thresholds, steps and bounds
    stay."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if shards == 1:
        return cfg
    split = lambda v: max(1, v // shards) if v > 0 else v
    return dataclasses.replace(cfg, c54_per_sec_budget=split(cfg.c54_per_sec_budget),
                               frame_high=split(cfg.frame_high),
                               frame_low=split(cfg.frame_low))


class ShardSwitcherBank:
    """One `AdaptiveSwitcher` per shard (a contiguous raster strip of the
    frame's patches), each on ``cfg`` split by `per_shard_config`.
    ``assign`` routes each strip under its own thresholds; ``note_frame``
    attributes a missed frame deadline by the shards' estimated MAC costs:
    the shards past the mean are demoted with severity = cost / mean
    (capped at 3), and a frame loaded evenly demotes every shard."""

    def __init__(self, cfg: Optional[SwitchingConfig] = None, shards: int = 1):
        cfg = cfg if cfg is not None else SwitchingConfig()
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.shards = shards
        self.switchers: List[AdaptiveSwitcher] = [
            AdaptiveSwitcher(per_shard_config(cfg, shards)) for _ in range(shards)]

    def assign(self, scores, slices: Sequence[slice]) -> np.ndarray:
        """A frame's scores (raster order) and its shard slices -> subnet ids."""
        if len(slices) != self.shards:
            raise ValueError(f"got {len(slices)} slices for {self.shards} shards")
        scores = np.asarray(scores)
        ids = np.empty(len(scores), dtype=np.int64)
        for sw, sl in zip(self.switchers, slices):
            ids[sl] = sw.assign(scores[sl])
        return ids

    def note_frame(self, missed: bool, costs: Sequence[float]) -> Tuple[bool, ...]:
        """One frame's outcome; returns which shards were demoted.
        ``costs``: each shard's estimated MAC cost of that frame."""
        if len(costs) != self.shards:
            raise ValueError(f"got {len(costs)} costs for {self.shards} shards")
        if not missed:
            return (False,) * self.shards
        costs = np.asarray(costs, np.float64)
        mean = float(costs.mean())
        if mean <= 0 or np.allclose(costs, mean):
            demoted, severities = [True] * self.shards, [1.0] * self.shards
        else:
            demoted = [bool(c > mean) for c in costs]
            severities = [min(float(c / mean), 3.0) for c in costs]
        for sw, d, sev in zip(self.switchers, demoted, severities):
            if d:
                sw.demote_for_straggler(severity=sev)
        return tuple(demoted)

    @property
    def thresholds(self) -> Tuple[Tuple[float, float], ...]:
        return tuple(sw.thresholds for sw in self.switchers)


# ---------------------------------------------------------------------------
# multi-stream serving: one Algorithm-1 controller per tenant stream
# ---------------------------------------------------------------------------

def per_stream_config(cfg: SwitchingConfig, share: float) -> SwitchingConfig:
    """``cfg`` scaled to one tenant's normalised share in (0, 1]: the C54
    budget a second and the trim bands scale with it (positive values
    floored at 1; 0 stays 0, since ``frame_low=0`` means "never decay");
    thresholds, steps and bounds stay."""
    if not (0.0 < share <= 1.0):
        raise ValueError(f"share must be in (0, 1], got {share}")
    if share == 1.0:
        return cfg
    split = lambda v: max(1, int(v * share)) if v > 0 else v
    return dataclasses.replace(cfg, c54_per_sec_budget=split(cfg.c54_per_sec_budget),
                               frame_high=split(cfg.frame_high),
                               frame_low=split(cfg.frame_low))


class StreamSwitcherBank:
    """One `AdaptiveSwitcher` per tenant stream, each on ``cfg`` split by the
    stream's normalised share, so one tenant's content never moves another's
    thresholds. ``tick_quotas`` gives each stream's C54 slots for one tick
    (the tick graph's ``quotas`` input); ``note_tick`` attributes a missed
    tick deadline by share-weighted cost."""

    def __init__(self, cfg: Optional[SwitchingConfig] = None, streams: int = 1,
                 shares: Optional[Sequence[float]] = None):
        cfg = cfg if cfg is not None else SwitchingConfig()
        if streams < 1:
            raise ValueError(f"streams must be >= 1, got {streams}")
        if shares is None:
            shares = (1.0,) * streams
        if len(shares) != streams:
            raise ValueError(f"got {len(shares)} shares for {streams} streams")
        total = float(sum(shares))
        if not (total > 0 and np.isfinite(total)):
            raise ValueError(f"shares must sum to a positive finite value, "
                             f"got {tuple(shares)}")
        self.streams = streams
        self.shares: Tuple[float, ...] = tuple(float(s) / total for s in shares)
        self.switchers: List[AdaptiveSwitcher] = [
            AdaptiveSwitcher(per_stream_config(cfg, sh)) for sh in self.shares]

    def tick_quotas(self) -> Tuple[int, ...]:
        """Each stream's C54 slots for one tick: its budget a second over its
        fps, floored at 1 (a share lowers quality, never starves a stream)."""
        return tuple(max(1, sw.cfg.c54_per_sec_budget // max(1, sw.cfg.fps))
                     for sw in self.switchers)

    def observe(self, stream: int, n_c54: int) -> None:
        """One stream's served C54 count, to its own controller."""
        self.switchers[stream].observe_frame(n_c54)

    def note_tick(self, missed: bool, costs: Sequence[float],
                  streams: Optional[Sequence[int]] = None) -> Tuple[bool, ...]:
        """One tick's outcome; returns which streams were demoted.

        ``costs``: the live streams' MAC costs this tick; ``streams``: their
        ids (default all). On a miss, the streams whose cost over share runs
        past the mean are demoted with severity = that ratio (capped at 3);
        a tick loaded exactly in share proportion demotes every live one."""
        live = tuple(range(self.streams)) if streams is None else tuple(streams)
        if len(costs) != len(live):
            raise ValueError(f"got {len(costs)} costs for {len(live)} live streams")
        if not missed:
            return (False,) * self.streams
        weighted = np.asarray([float(c) / self.shares[s] for c, s in zip(costs, live)],
                              np.float64)
        mean = float(weighted.mean())
        demoted = [False] * self.streams
        if mean <= 0 or np.allclose(weighted, mean):
            for s in live:
                demoted[s] = True
                self.switchers[s].demote_for_straggler(severity=1.0)
        else:
            for w, s in zip(weighted, live):
                if w > mean:
                    demoted[s] = True
                    self.switchers[s].demote_for_straggler(severity=min(float(w / mean), 3.0))
        return tuple(demoted)

    @property
    def thresholds(self) -> Tuple[Tuple[float, float], ...]:
        return tuple(sw.thresholds for sw in self.switchers)
