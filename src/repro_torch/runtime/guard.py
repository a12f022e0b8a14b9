"""Serving-side resilience: the seeded fault harness, the degradation ladder
and the serving ledger (twin of ``repro.runtime.guard``).

* `FaultPlan` / `FaultInjector` — a deterministic chaos harness. Every
  injection decision is a pure function of
  ``sha256(f"{seed}:{kind}:{stream}:{index}")``, so two runs of one plan
  inject the same faults whatever the timing, and the port's schedule is
  byte for byte the reference's.
* `ResilienceGuard` — the degradation ladder. From the configured serving
  point it lays out the step-down order (fusion ``group->layer``, backend
  ``->ref``: the "cuda" kernels to their plain versions, quant
  ``int8/fxp10->fp32``); a failed launch steps down, or retries at the
  floor, at most ``plan.max_retries`` times a call, each step recorded. The
  ladder is sticky: later frames serve at the level reached. On a CUDA
  device only a fault the `FaultInjector` raised steps down (and a watchdog
  overrun, under a `FaultPlan`): a real build, capture or launch error
  raises, so the card never serves the plain versions in the kernels'
  place unless a fault plan asked for it. Its step labels
  are the reference's, so the two ledgers compare equal. The reference's
  ``pallas->interpret`` rung has no twin: the CUDA kernels have no
  interpreter, and on the CPU the reference resolves ``interpret=True`` and
  leaves that rung out too.
* Typed faults — `PoisonFrameError` (a frame failed its health verdict
  under ``plan.on_poison="raise"``) and the injected-fault family.

The engine (`api/engine.py`) and the multiplexer (`runtime/multiplex.py`)
run every fused launch through ``ResilienceGuard.run``; a step down comes
only from a raised exception or a watchdog overrun (on the card: an
injected fault, or an overrun under a `FaultPlan`), and is always in the
ledger and in ``FrameResult.degraded``/``backend``.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

POISON_KINDS = ("nan", "inf", "range", "dtype")


class PoisonFrameError(RuntimeError):
    """A frame failed its health verdict under ``plan.on_poison="raise"``.

    ``health`` carries the ``(nan, inf, out_of_range)`` pixel counts (None
    for a frame rejected for its dtype)."""

    def __init__(self, msg: str, health: Optional[Tuple[int, int, int]] = None):
        super().__init__(msg)
        self.health = health


class InjectedFault(RuntimeError):
    """Base class of the faults the `FaultInjector` raises."""


class InjectedBackendFailure(InjectedFault):
    """A simulated kernel/backend launch failure."""


class InjectedStreamError(InjectedFault):
    """A simulated exception from a tenant's frame iterator."""


def _check(field_name: str, ok: bool, got, allowed: str) -> None:
    if not ok:
        raise ValueError(f"FaultPlan.{field_name}={got!r}: allowed {allowed}")


@dataclass(frozen=True)
class FaultPlan:
    """Declarative, seeded chaos schedule, attached through
    ``ExecutionPlan.faults``. Rates are per-event probabilities in [0, 1];
    every decision derives from ``seed`` alone."""

    seed: int = 0
    #: probability that a given (stream, frame) gets its pixels poisoned
    poison_rate: float = 0.0
    #: the corruptions drawn from: nan / inf / range (1e6 pixels) / dtype
    poison_kinds: Tuple[str, ...] = ("nan",)
    #: probability that a given stream frame raises from the tenant iterator
    iterator_error_rate: float = 0.0
    #: probability that a launch index raises InjectedBackendFailure (once)
    backend_failure_rate: float = 0.0
    #: probability and length of a delay before a launch (exercises
    #: plan.watchdog_s; timing-dependent)
    delay_rate: float = 0.0
    delay_s: float = 0.0
    #: stream-level faults only on these stream ids (None: every stream)
    target_streams: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        _check("seed", isinstance(self.seed, int) and not isinstance(self.seed, bool),
               self.seed, "an int")
        for name in ("poison_rate", "iterator_error_rate", "backend_failure_rate",
                     "delay_rate"):
            v = getattr(self, name)
            _check(name, isinstance(v, (int, float)) and not isinstance(v, bool)
                   and 0.0 <= float(v) <= 1.0, v, "a number in [0, 1]")
        _check("delay_s", isinstance(self.delay_s, (int, float))
               and not isinstance(self.delay_s, bool) and float(self.delay_s) >= 0.0,
               self.delay_s, "a number >= 0")
        object.__setattr__(self, "poison_kinds", tuple(self.poison_kinds))
        _check("poison_kinds", bool(self.poison_kinds)
               and all(k in POISON_KINDS for k in self.poison_kinds),
               self.poison_kinds, f"a non-empty subset of {POISON_KINDS}")
        if self.target_streams is not None:
            object.__setattr__(self, "target_streams", tuple(self.target_streams))
            _check("target_streams",
                   all(isinstance(s, int) and not isinstance(s, bool) and s >= 0
                       for s in self.target_streams),
                   self.target_streams, "None or a tuple of stream ids >= 0")


class FaultInjector:
    """The fault harness of one `FaultPlan`. Each decision is a coin
    ``sha256(f"{seed}:{kind}:{stream}:{index}")`` mapped to [0, 1).
    Backend failures fire at most once per launch index, so the guarded
    retry one rung down succeeds and the ledger is deterministic."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._failed_launches: set = set()

    def _coin(self, kind: str, stream: int, index: int) -> float:
        key = f"{self.plan.seed}:{kind}:{stream}:{index}".encode()
        return int.from_bytes(hashlib.sha256(key).digest()[:8], "big") / 2.0 ** 64

    def _targets(self, stream: int) -> bool:
        t = self.plan.target_streams
        return t is None or stream in t

    def poison_frame(self, frame, stream: int, index: int) -> np.ndarray:
        """``frame`` corrupted deterministically, as a numpy array (uint8 for
        the "dtype" kind)."""
        kinds = self.plan.poison_kinds
        kind = kinds[int(self._coin("poison-kind", stream, index) * len(kinds)) % len(kinds)]
        arr = np.array(frame, dtype=np.float32, copy=True)
        if kind == "dtype":
            return (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)
        h = max(1, arr.shape[0] // 8)
        w = max(1, arr.shape[1] // 8) if arr.ndim > 1 else 1
        y = int(self._coin("poison-y", stream, index) * max(1, arr.shape[0] - h))
        x = int(self._coin("poison-x", stream, index) * max(1, arr.shape[1] - w))
        arr[y:y + h, x:x + w] = {"nan": np.nan, "inf": np.inf, "range": 1.0e6}[kind]
        return arr

    def wrap_stream(self, stream: int, frames: Iterable) -> Iterator:
        """A tenant's frames with the plan's poison and iterator errors."""
        for index, frame in enumerate(frames):
            if self._targets(stream):
                if self._coin("iter-error", stream, index) < self.plan.iterator_error_rate:
                    raise InjectedStreamError(
                        f"injected iterator error (stream {stream}, frame {index})")
                if self._coin("poison", stream, index) < self.plan.poison_rate:
                    frame = self.poison_frame(frame, stream, index)
            yield frame

    def maybe_fail_launch(self, index: int) -> None:
        """Raise `InjectedBackendFailure` for this launch index, once ever."""
        if index in self._failed_launches:
            return
        if self._coin("backend", 0, index) < self.plan.backend_failure_rate:
            self._failed_launches.add(index)
            raise InjectedBackendFailure(f"injected backend failure (launch {index})")

    def maybe_delay(self, index: int) -> None:
        """Sleep ``delay_s`` before this launch (exercises the watchdog)."""
        if self.plan.delay_s > 0.0 and self._coin("delay", 0, index) < self.plan.delay_rate:
            time.sleep(self.plan.delay_s)


@dataclass(frozen=True)
class LadderVariant:
    """One rung of the degradation ladder: a whole serving variant."""

    backend: str         # "cuda" | "ref"
    quant: bool          # serve the calibrated QuantPack (False: fp32)
    fusion: str          # "layer" | "group"
    step: str = ""       # the step that produced this rung ("": as planned)


def build_ladder(backend: str, quant_on: bool, fusion: str) -> Tuple[LadderVariant, ...]:
    """The step-down order from the configured serving point, each step only
    where it changes something: fusion ``group->layer``, backend ``->ref``,
    quant ``->fp32``. The last rung is the ref/fp32/layer floor."""
    rungs = [LadderVariant(backend, quant_on, fusion)]

    def push(step, **delta):
        prev = rungs[-1]
        nxt = LadderVariant(backend=delta.get("backend", prev.backend),
                            quant=delta.get("quant", prev.quant),
                            fusion=delta.get("fusion", prev.fusion), step=step)
        if (nxt.backend, nxt.quant, nxt.fusion) != (prev.backend, prev.quant, prev.fusion):
            rungs.append(nxt)

    if fusion == "group":
        push("fusion:group->layer", fusion="layer")
    if backend != "ref":
        push("backend:->ref", backend="ref")
    if quant_on:
        push("quant:->fp32", quant=False)
    return tuple(rungs)


class ResilienceGuard:
    """The sticky degradation ladder and the serving ledger.

    ``run(attempt, index)`` calls ``attempt(variant)`` at the current rung;
    on any exception but `PoisonFrameError` it steps down (at the floor it
    retries in place) and records the step, up to ``max_retries`` extra
    attempts a call, then re-raises. Every event is ``{"index", "kind",
    "reason"}``, funnelled through ``record``.

    ``injected_only`` (the engine sets it on a CUDA device): only an
    `InjectedFault` steps down; any other exception is recorded as a
    "failure" and raised at once. ``chaos`` (a `FaultPlan` is set): a
    watchdog overrun steps down; with ``injected_only`` and no ``chaos`` it
    is recorded and holds the rung."""

    def __init__(self, backend: str, quant_on: bool, fusion: str, max_retries: int = 2,
                 injected_only: bool = False, chaos: bool = False):
        self.ladder = build_ladder(backend, quant_on, fusion)
        self.level = 0
        self.max_retries = max_retries
        self.injected_only = injected_only
        self.chaos = chaos
        self.events: List[Dict[str, Any]] = []

    @property
    def variant(self) -> LadderVariant:
        return self.ladder[self.level]

    def record(self, index, kind: str, reason: str) -> None:
        self.events.append({"index": index, "kind": kind, "reason": reason})

    def _step_down(self, floor: str) -> str:
        if self.level + 1 < len(self.ladder):
            self.level += 1
            return self.ladder[self.level].step
        return floor

    def run(self, attempt: Callable[[LadderVariant], Any], index) -> Tuple[Any, Tuple[str, ...]]:
        """``attempt`` under the ladder; returns (result, the steps taken)."""
        steps: List[str] = []
        tries = 0
        while True:
            try:
                return attempt(self.ladder[self.level]), tuple(steps)
            except PoisonFrameError:
                raise                      # a policy verdict, not a launch failure
            except Exception as e:
                tries += 1
                if self.injected_only and not isinstance(e, InjectedFault):
                    self.record(index, "failure", f"not stepping down on the card: {e!r}")
                    raise
                if tries > self.max_retries:
                    self.record(index, "failure",
                                f"ladder exhausted after {tries} attempts: {e!r}")
                    raise
                step = self._step_down("retry")
                steps.append(step)
                self.record(index, "degrade", f"{step}: {e!r}")

    def note_watchdog(self, index, dt: float, limit: float) -> Tuple[str, ...]:
        """A launch or tick took longer than ``plan.watchdog_s``: one step
        down (none at the floor; none on the card without a `FaultPlan`:
        "held"), recorded as a "watchdog" event."""
        step = "held" if self.injected_only and not self.chaos else self._step_down("floor")
        self.record(index, "watchdog", f"{step}: tick took {dt:.4f}s > watchdog_s={limit}")
        return (step,) if step not in ("floor", "held") else ()

    def summary(self) -> Dict[str, Any]:
        """The ledger for ``SREngine.summary()["degradations"]``."""
        by_kind: Dict[str, int] = {}
        by_step: Dict[str, int] = {}
        for e in self.events:
            by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
            if e["kind"] in ("degrade", "watchdog"):
                step = e["reason"].split(":", 1)[0]
                by_step[step] = by_step.get(step, 0) + 1
        return {"total": len(self.events), "by_kind": by_kind, "by_step": by_step,
                "level": self.level, "variant": self.variant.step or "as-planned",
                "events": list(self.events[-32:])}
