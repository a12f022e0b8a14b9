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
    # (N,) subnet id / edge score per patch: numpy arrays under host
    # dispatch; tensors on the engine's device under fused dispatch (the
    # control loop never copies them; consumers do, on use)
    ids: Optional[np.ndarray] = None
    scores: Optional[np.ndarray] = None
    counts: Tuple[int, int, int] = (0, 0, 0)  # (bilinear, C27, C54) patches
    mac_saving: float = 0.0                   # vs all-C54
    latency_s: float = 0.0                    # wall clock incl. device sync
    # upscale(): the thresholds routing used ((0, 0) when it ignored them);
    # streamed frames: the switcher's live thresholds AFTER this frame
    thresholds: Tuple[float, float] = (0.0, 0.0)
    deadline_missed: bool = False             # streaming only
    # what ran this frame: "host" (routing on the host) or "fused" (the
    # frame's single dispatch); a fused-plan call that a mode forces back to
    # host dispatch says "host"
    dispatch: str = "host"
    # fused dispatch only: entry k counts the patches demoted from subnet k
    # to k-1 because k's slots were full (hops, so a patch cascading
    # C54 -> C27 -> bilinear counts in both conv entries; entry 0 is 0).
    # None under host dispatch
    spill_counts: Optional[Tuple[int, ...]] = None
    # False when this call paid one-off set-up (the first frame of a
    # geometry: index maps, kernel builds; under fused dispatch the first
    # frame of a capacity profile: its graph capture); excluded from
    # latency aggregates
    compiled: bool = True
    # the sharded patch stream (plan.shards > 1): the logical shards, and
    # per shard, in raster-strip order, its (bilinear, C27, C54) counts, its
    # (t1, t2) after this frame and whether this frame demoted it; None on
    # single-shard runs (and the thresholds and demotions under fused
    # dispatch, which reports the counts only)
    shards: int = 1
    shard_counts: Optional[Tuple[Tuple[int, int, int], ...]] = None
    shard_thresholds: Optional[Tuple[Tuple[float, float], ...]] = None
    shard_deadline_missed: Optional[Tuple[bool, ...]] = None
    # multi-stream serving (plan.streams > 1): the tenant stream this frame
    # belongs to (its index in serve_streams' argument), else None. There
    # deadline_missed means this stream was blamed for a missed tick (by
    # share-weighted cost), and latency_s is the tick's marginal time: a
    # tick's streams are served together
    stream_id: Optional[int] = None
    # (nan, inf, out-of-[0,1]) pixel counts of the raw frame; None when
    # plan.on_poison == "off"
    health: Optional[Tuple[int, int, int]] = None
    # degradation-ladder steps newly taken while serving this frame or tick
    # (e.g. "backend:->ref"); the whole ledger is in
    # SREngine.summary()["degradations"]
    degraded: Tuple[str, ...] = ()

    @property
    def n_patches(self) -> int:
        return 0 if self.ids is None else int(len(self.ids))

    def summary(self) -> dict:
        """Compact per-frame telemetry (no arrays): what ran, how it routed,
        and the occupancy of the process-wide compiled caches."""
        from repro_torch.core.pipeline import compiled_cache_occupancy
        out = {
            "mode": self.mode,
            "backend": self.backend,
            "dispatch": self.dispatch,
            "n_patches": self.n_patches,
            "counts": tuple(int(c) for c in self.counts),
            "mac_saving": float(self.mac_saving),
            "latency_s": float(self.latency_s),
            "compiled": bool(self.compiled),
            "compiled_caches": compiled_cache_occupancy(),
        }
        if self.stream_id is not None:
            out["stream_id"] = int(self.stream_id)
        if self.shards > 1:
            out["shards"] = int(self.shards)
        if self.health is not None:
            out["health"] = tuple(int(c) for c in self.health)
        if self.degraded:
            out["degraded"] = tuple(self.degraded)
        return out


def summarize_stats(stats) -> dict:
    """Aggregate over frame records: routing shares, MAC saving, latency of
    the frames that paid no set-up (all frames if every one did), deadline
    misses, the last frame's thresholds and, under fused dispatch, the
    spilled patches per subnet; under the sharded stream the shards, their
    demotions and their last thresholds; under multi-stream serving a "streams" block
    per tenant (its routing mix, deadline misses and last thresholds)."""
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
        "deadline_misses": int(sum(s.deadline_missed for s in stats)),
        "final_thresholds": stats[-1].thresholds,
    }
    if len(steady) < len(stats):
        out["warmup_frames_excluded"] = len(stats) - len(steady)
    spills = [s.spill_counts for s in stats if s.spill_counts is not None]
    if spills:
        out["spilled_patches"] = np.asarray(spills).sum(0).tolist()
    poisoned = sum(1 for s in stats if any(s.health or ()))
    if poisoned:
        out["poison_frames"] = poisoned
    shards = max(s.shards for s in stats)
    if shards > 1:
        # straggler demotions per shard over the window, and the newest
        # per-shard thresholds
        out["shards"] = shards
        misses = np.zeros(shards, np.int64)
        for s in stats:
            if s.shard_deadline_missed is not None:
                misses[: len(s.shard_deadline_missed)] += np.asarray(s.shard_deadline_missed,
                                                                     np.int64)
        out["shard_deadline_misses"] = misses.tolist()
        last = next((s for s in reversed(stats) if s.shard_thresholds is not None), None)
        if last is not None:
            out["final_shard_thresholds"] = last.shard_thresholds
    sids = sorted({s.stream_id for s in stats if s.stream_id is not None})
    if sids:
        per = {}
        for sid in sids:
            recs = [s for s in stats if s.stream_id == sid]
            c = np.array([r.counts for r in recs])
            per[sid] = {
                "frames": len(recs),
                "subnet_share": dict(zip(sp.SUBNET_NAMES,
                                         (c.sum(0) / max(c.sum(), 1)).round(4).tolist())),
                "mean_mac_saving": float(np.mean([r.mac_saving for r in recs])),
                "deadline_misses": int(sum(r.deadline_missed for r in recs)),
                "final_thresholds": recs[-1].thresholds,
            }
        out["streams"] = per
    return out
