"""ExecutionPlan — the frozen description of how a frame is run (twin of
``repro.api.plan`` over the fields this package serves).

Validation is declarative: ``_FIELD_RULES`` (one predicate + allowed-set
description per field) and ``_CROSS_RULES`` (constraints spanning fields),
with one error format, ``ExecutionPlan.<field>=<got!r>: allowed <set>``,
word for word the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core import subnet_policy as sp
from repro_torch.core.patching import PatchGeometry, get_geometry
from repro_torch.core.pipeline import DEFAULT_BUCKETS, FUSION_MODES, HEALTH_POLICIES
from repro_torch.runtime.guard import FaultPlan

SUBNET_POLICIES = ("threshold", "all_bilinear", "all_c27", "all_c54")
DISPATCH_MODES = ("host", "fused")
QUANT_MODES = (None, "fxp10", "int8")


def _plan_error(field: str, got, allowed: str) -> ValueError:
    return ValueError(f"ExecutionPlan.{field}={got!r}: allowed {allowed}")


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _pos_int(v) -> bool:
    return _is_int(v) and v >= 1


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


_FIELD_RULES: Dict[str, Tuple[Callable, str]] = {
    "patch": (_pos_int, "a positive int"),
    "overlap": (lambda v: _is_int(v) and v >= 0, "an int >= 0"),
    "t1": (_is_num, "a number"),
    "t2": (_is_num, "a number"),
    "buckets": (lambda v: bool(v) and all(_pos_int(b) for b in v)
                and list(v) == sorted(set(v)),
                "a non-empty ascending tuple of positive ints"),
    "subnet_policy": (lambda v: v in SUBNET_POLICIES, f"one of {SUBNET_POLICIES}"),
    "quant": (lambda v: v in QUANT_MODES, f"one of {QUANT_MODES}"),
    "dispatch": (lambda v: v in DISPATCH_MODES, f"one of {DISPATCH_MODES}"),
    "fusion": (lambda v: v in FUSION_MODES, f"one of {FUSION_MODES}"),
    "capacity": (lambda v: v is None or all(c >= 0 for c in v),
                 "None or a tuple of ints >= 0"),
    "inflight": (_pos_int, "a positive int"),
    "stats_window": (_pos_int, "a positive int"),
    "shards": (_pos_int, "a positive int"),
    "streams": (_pos_int, "a positive int"),
    "stream_shares": (lambda v: v is None or (bool(v)
                      and all(s > 0 and np.isfinite(s) for s in v)),
                      "None or a tuple of finite floats > 0"),
    "on_poison": (lambda v: v in HEALTH_POLICIES, f"one of {HEALTH_POLICIES}"),
    # the text names the reference's class, word for word; the port takes
    # its own `repro_torch.runtime.guard.FaultPlan`
    "faults": (lambda v: v is None or isinstance(v, FaultPlan),
               "None or a repro.runtime.guard.FaultPlan"),
    "max_retries": (lambda v: _is_int(v) and v >= 0, "an int >= 0"),
    "quarantine_ticks": (lambda v: _is_int(v) and v >= 0,
                         "an int >= 0 (0 retires a quarantined stream "
                         "permanently)"),
    "watchdog_s": (lambda v: v is None or (_is_num(v) and v > 0),
                   "None or a number > 0"),
}

_CROSS_RULES: Tuple[Tuple[str, Callable, Callable], ...] = (
    ("overlap", lambda p: p.overlap < p.patch, lambda p: f"an int < patch ({p.patch})"),
    ("t2", lambda p: p.t2 >= p.t1, lambda p: f"a number >= t1 ({p.t1})"),
    # host dispatch blocks per frame, so inflight > 1 would do nothing
    ("inflight", lambda p: p.inflight == 1 or p.dispatch == "fused",
     lambda p: "1 unless dispatch='fused' (host dispatch serves "
               "synchronously)"),
    # every tick is one fused dispatch; there is no host-dispatch multiplexer
    ("streams", lambda p: p.streams == 1 or p.dispatch == "fused",
     lambda p: "1 unless dispatch='fused' (stream packing rides the fused "
               "executable)"),
    # per-stream QoS adapts thresholds; a forced policy has none to adapt
    ("streams", lambda p: p.streams == 1 or p.subnet_policy == "threshold",
     lambda p: "1 unless subnet_policy='threshold' (per-stream QoS adapts "
               "thresholds)"),
    ("stream_shares", lambda p: (p.stream_shares is None
                                 or len(p.stream_shares) == p.streams),
     lambda p: f"None or a tuple of exactly streams={p.streams} shares"),
    # the watchdog meters fused launches and ticks; host dispatch has none
    ("watchdog_s", lambda p: p.watchdog_s is None or p.dispatch == "fused",
     lambda p: "None unless dispatch='fused' (the watchdog meters fused "
               "admission ticks)"),
)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    patch: int = 32
    overlap: int = 2
    t1: float = sp.DEFAULT_T1
    t2: float = sp.DEFAULT_T2
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    subnet_policy: str = "threshold"
    #: "host": routing on the host, one batch per subnet; "fused": the whole
    #: frame (extract, edge score, routing into fixed per-subnet slots,
    #: forward, fusion) as one dispatch, on the card one CUDA graph replay
    #: per (geometry, capacity profile). Fused serves threshold-routed
    #: edge_select calls; forced policies, ids_override, all_patches and
    #: whole run host dispatch and say so in FrameResult.dispatch
    dispatch: str = "host"
    #: "layer": one kernel launch per layer group (BSConv, each SFB, DSConv);
    #: "group": one megakernel launch per routed bucket runs the whole chain
    fusion: str = "layer"
    #: None = fp32 serving; "fxp10" | "int8" serve the PAMS lattice (engine
    #: state: the engine calibrates its alphas once, at construction)
    quant: Optional[str] = None
    #: what serving does about a frame with NaN/Inf/out-of-[0,1] pixels
    on_poison: str = "raise"
    #: fused dispatch's per-subnet slot capacities, aligned with
    #: ``cfg.subnet_widths()`` (entry 0, bilinear, is ignored: that lane runs
    #: dense). None: probed on the first frame of a geometry, snapped to
    #: ``buckets``, grown after a frame that spilled and, when streaming, the
    #: C54 entry clamped to the frame's share of the Algorithm-1 budget. A
    #: pinned profile is served verbatim, streaming or not
    capacity: Optional[Tuple[int, ...]] = None
    #: ``SREngine.stream`` under fused dispatch keeps up to this many frames
    #: in flight (>= 2: the switcher reads routing one frame late)
    inflight: int = 1
    #: bound on the per-frame records ``SREngine.stats`` keeps
    stats_window: int = 4096
    #: data-parallel patch-stream shards: 1 is the single-device path; > 1
    #: gives each raster strip of a frame its own Algorithm-1 controller and
    #: splits every routed bucket across that many CUDA devices. With fewer
    #: devices visible (one card, or a CPU engine) the engine warns and
    #: dispatches on those; routing control stays per shard. Engine state,
    #: like quant
    shards: int = 1
    #: tenant streams multiplexed into one fused dispatch per admission tick
    #: (`SREngine.serve_streams`); >= 2 needs dispatch="fused" and the
    #: threshold policy. Each stream keeps its own switcher; the tick's graph
    #: and the calibration behind it are shared
    streams: int = 1
    #: relative QoS weight per stream (len == streams), normalised by the
    #: engine: stream s gets share_s / sum(shares) of the C54 budget and of
    #: the trim bands. None: equal shares
    stream_shares: Optional[Tuple[float, ...]] = None
    #: an optional seeded chaos schedule (`runtime.guard.FaultPlan`): poison
    #: pixels, iterator errors, backend failures and launch delays. None: no
    #: injection; fault handling itself is always on
    faults: Optional[FaultPlan] = None
    #: extra launch attempts the degradation ladder may spend per frame or
    #: tick (`runtime.guard.ResilienceGuard`): a failed launch steps down
    #: (fusion group->layer, backend ->ref, quant ->fp32; sticky) or retries
    #: at the floor, at most this many times, then raises
    max_retries: int = 2
    #: multi-tenant quarantine under on_poison="raise": a poisoned stream is
    #: not admitted for this many ticks, then re-admitted; 0 retires it.
    #: An iterator that raises always retires its stream
    quarantine_ticks: int = 0
    #: wall-clock budget (s) per fused launch or admission tick: a slower one
    #: steps the ladder down one rung, as a "watchdog" event. None: no
    #: watchdog
    watchdog_s: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "buckets", tuple(self.buckets))
        if self.capacity is not None:
            try:
                caps = tuple(int(c) for c in self.capacity)
            except (TypeError, ValueError) as e:
                raise _plan_error("capacity", self.capacity,
                                  _FIELD_RULES["capacity"][1]) from e
            object.__setattr__(self, "capacity", caps)
        if self.stream_shares is not None:
            try:
                shares = tuple(float(s) for s in self.stream_shares)
            except (TypeError, ValueError) as e:
                raise _plan_error("stream_shares", self.stream_shares,
                                  _FIELD_RULES["stream_shares"][1]) from e
            object.__setattr__(self, "stream_shares", shares)
        for field, (ok, allowed) in _FIELD_RULES.items():
            value = getattr(self, field)
            if not ok(value):
                raise _plan_error(field, value, allowed)
        for field, ok, allowed in _CROSS_RULES:
            if not ok(self):
                raise _plan_error(field, getattr(self, field), allowed(self))

    def replace(self, **kw) -> "ExecutionPlan":
        return dataclasses.replace(self, **kw)

    def decide(self, scores) -> np.ndarray:
        """Edge scores -> subnet ids under this plan's policy."""
        scores = np.asarray(scores)
        if self.subnet_policy == "threshold":
            return sp.decide(scores, self.t1, self.t2)
        fixed = {"all_bilinear": sp.BILINEAR, "all_c27": sp.C27,
                 "all_c54": sp.C54}[self.subnet_policy]
        return np.full(scores.shape, fixed, dtype=np.int64)

    def geometry(self, h: int, w: int, scale: int, device: str = "cuda") -> PatchGeometry:
        """Cached patch geometry of an (h, w) frame on ``device`` ("cuda",
        the engine's default device, unless given)."""
        return get_geometry(int(h), int(w), self.patch, self.overlap, int(scale), str(device))

    @property
    def thresholds(self) -> Tuple[float, float]:
        return (self.t1, self.t2)
