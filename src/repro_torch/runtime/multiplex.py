"""StreamMultiplexer — N tenant frame streams through one fused dispatch per
admission tick (twin of ``repro.runtime.multiplex``).

`SREngine.serve_streams` delegates here when ``plan.streams >= 2``; this
module is not an entry point of its own.

Admission: each tick takes the next frame of every live stream (strict
round robin: a tenant is admitted once a tick, so none starves another) and
packs them into one fused tick (`core.pipeline._fused_stream_fn`). The
patch axis is stream-major, so the capacity cascade runs on the shared pool
of slots and each stream's frame is fused on its own. On the card a tick is
one CUDA graph replay per (weights, geometry, live count, capacity profile,
ladder rung, on_poison), captured into the device's shared graph pool; the
per-stream thresholds and C54 quotas are inputs of the graph, so Algorithm-1
moves and share changes never capture again.

QoS: every stream owns an `AdaptiveSwitcher` on its share of the budget
(`StreamSwitcherBank`). The per-stream quota is the hard C54 ceiling, so
an overload degrades each stream by its share, raster-deterministically,
and no frame is dropped. A missed tick deadline is blamed by share-weighted
MAC cost: only the streams past their entitlement are demoted.

Fault isolation per tenant: a stream whose iterator raises is retired (the
ledger records why) and the tick goes on for the others. A stream whose
frame fails its health verdict under ``on_poison="raise"`` is quarantined
instead of raising: its result for that tick is dropped, it is not
admitted for ``plan.quarantine_ticks`` ticks (0 retires it), then it is
admitted again. Every kernel computes each patch on its own, so with a
pinned capacity a healthy stream's frames are bit-equal to a run without
faults. Launch failures step the engine's degradation ladder as the solo
fused path does; ``plan.watchdog_s`` meters the tick's wall clock.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, Iterable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.result import FrameResult
from repro_torch.core import subnet_policy as sp
from repro_torch.core.pipeline import _fused_stream_fn, _host_scores
from repro_torch.kernels.megakernel import _TreeKey


def _as_frame(frame) -> torch.Tensor:
    """A tenant's frame as a float32 tensor, values as given (the tick's
    health verdict judges them; an integer frame is not rescaled here, as
    the reference's stacking does not rescale it)."""
    if isinstance(frame, torch.Tensor):
        return frame.to(torch.float32)
    a = np.asarray(frame, dtype=np.float32)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


class StreamMultiplexer:
    """The admission-tick loop behind `SREngine.serve_streams`. It keeps no
    state of its own beyond the engine: capacity profiles live in the
    engine's fused-caps map (keyed by geometry and live count), control
    state in the engine's `StreamSwitcherBank`."""

    def __init__(self, engine):
        if engine.plan.streams < 2:
            raise ValueError(f"StreamMultiplexer needs plan.streams >= 2, "
                             f"got {engine.plan.streams}")
        if engine.stream_bank is None:
            raise ValueError("engine has no stream bank (was the plan "
                             "replaced after construction?)")
        self.engine = engine
        self.bank = engine.stream_bank
        # streams whose finished tick failed the health verdict under
        # on_poison="raise"; serve() moves them into quarantine
        self._poisoned: List[int] = []

    def serve(self, streams: Sequence[Iterable]) -> Iterator[FrameResult]:
        """Multiplex the tenants' iterables; yields FrameResults tick by tick,
        the live streams in id order within a tick. ``plan.inflight >= 2``
        keeps that many ticks in flight (the controllers then adapt from a
        tick-old frame). The loop keeps ticking while quarantined streams
        wait, even when no stream can be admitted."""
        eng = self.engine
        iters = []
        for s, src in enumerate(streams):
            it = iter(src)
            if eng.injector is not None:
                it = eng.injector.wrap_stream(s, it)
            iters.append(it)
        live: List[int] = list(range(len(iters)))
        quarantined: Dict[int, int] = {}     # stream id -> tick it is admitted again
        pending: Deque[dict] = collections.deque()
        tick = 0
        while live or quarantined or pending:
            self._drain_poisoned(live, quarantined, tick)
            for s in sorted(sid for sid, t in quarantined.items() if tick >= t):
                del quarantined[s]
                live.append(s)
                live.sort()
                eng.guard.record(tick, "readmit", f"stream {s} re-admitted after quarantine")
            frames, nxt = [], []
            for s in live:
                try:
                    frames.append(_as_frame(next(iters[s])))
                    nxt.append(s)
                except StopIteration:
                    pass
                except Exception as e:
                    # one tenant's iterator failure retires that stream only
                    eng.guard.record(tick, "retire", f"stream {s} iterator raised: {e!r}")
            live = nxt
            if frames:
                pending.append(self._launch_tick(live, frames))
                while len(pending) >= eng.plan.inflight:
                    yield from self._finalize_tick(pending.popleft())
            elif pending:
                # nothing to admit now: finish a tick (its verdicts may
                # quarantine streams) before going on
                yield from self._finalize_tick(pending.popleft())
            elif not quarantined:
                break
            tick += 1
        while pending:
            yield from self._finalize_tick(pending.popleft())
        self._drain_poisoned(live, quarantined, tick)

    def _drain_poisoned(self, live: List[int], quarantined: Dict[int, int], tick: int) -> None:
        """Streams flagged by finished ticks leave admission: quarantined for
        ``plan.quarantine_ticks`` ticks, or retired when that is 0."""
        eng = self.engine
        q = eng.plan.quarantine_ticks
        for s in self._poisoned:
            if s in live:
                live.remove(s)
                if q > 0:
                    quarantined[s] = tick + q
                    eng.guard.record(tick, "quarantine",
                                     f"stream {s} quarantined for {q} tick(s) after "
                                     f"poison verdict")
                else:
                    eng.guard.record(tick, "retire",
                                     f"stream {s} retired after poison verdict "
                                     f"(quarantine_ticks=0)")
        self._poisoned = []

    # -- one tick ------------------------------------------------------------

    def _stage(self, frames: List[torch.Tensor]) -> torch.Tensor:
        """The tick's frames as one (S, H, W, C) batch: in pinned host memory
        for an upload that does not block the host (CUDA engine, frames on
        the host), else on the engine's device."""
        dev = self.engine.device
        if dev.type == "cuda" and all(f.device.type == "cpu" for f in frames):
            batch = torch.empty((len(frames),) + tuple(frames[0].shape), dtype=torch.float32,
                                pin_memory=True)
            for i, f in enumerate(frames):
                batch[i].copy_(f)
            return batch
        return torch.stack([f.to(dev) for f in frames])

    def _launch_tick(self, live: Sequence[int], frames: List[torch.Tensor]) -> dict:
        """Enqueue one tick without waiting for the device (the tick's twin
        of the engine's ``_launch_fused``)."""
        eng = self.engine
        p = eng.plan
        t0 = time.perf_counter()
        shape = tuple(frames[0].shape)
        for s, f in zip(live, frames):
            if tuple(f.shape) != shape:
                raise ValueError(
                    f"stream {s} frame shape {tuple(f.shape)} != {shape}: "
                    f"one admission tick packs one geometry; serve "
                    f"same-shaped streams together")
        with torch.inference_mode():
            geom = p.geometry(shape[0], shape[1], eng.cfg.scale, eng.device)
            quotas_all = self.bank.tick_quotas()
            quotas = tuple(quotas_all[s] for s in live)
            thresholds = tuple(self.bank.switchers[s].thresholds for s in live)
            batch = self._stage(frames)
            caps = self._caps_for_tick(geom, p, batch, thresholds, quotas)
            t1s = [t[0] for t in thresholds]
            t2s = [t[1] for t in thresholds]
            index = eng._next_index()
            if eng.injector is not None:
                eng.injector.maybe_delay(index)

            def attempt(v):
                if eng.injector is not None:
                    eng.injector.maybe_fail_launch(index)
                fn = _fused_stream_fn(_TreeKey(eng.params), geom, len(live), caps, eng.cfg,
                                      v.backend, eng.qpack if v.quant else None, v.fusion,
                                      p.on_poison, str(eng.device))
                return fn.launch(batch, t1s, t2s, quotas)

            flight, steps = eng.guard.run(attempt, index)
        v = eng.guard.variant
        compiled = eng._mark_warm(("mux", geom.cache_key, len(live), caps, v.backend, v.quant,
                                   v.fusion, p.on_poison))
        return {"flight": flight, "geom": geom, "plan": p, "live": tuple(live), "t0": t0,
                "compiled": compiled, "variant": v, "steps": steps, "index": index}

    def _caps_for_tick(self, geom, p, batch: torch.Tensor, thresholds, quotas
                       ) -> Tuple[int, ...]:
        """The tick's pool profile. ``plan.capacity`` pins the per-stream
        profile (times the live count); otherwise the first tick of a
        (geometry, live count) is scored on the host under each stream's
        thresholds and the profile cached in the engine, grown after spills.
        The C54 entry is clamped per call to the sum of the live quotas,
        which the in-graph quotas enforce anyway."""
        eng = self.engine
        n_live = len(quotas)
        widths = eng.cfg.subnet_widths()
        if p.capacity is not None:
            if len(p.capacity) != len(widths):
                raise ValueError(f"plan.capacity {p.capacity} must have one entry per "
                                 f"subnet width {widths}")
            return tuple(int(c) * n_live for c in p.capacity)
        key = ("mux", geom.cache_key, n_live)
        caps = eng._fused_caps.get(key)
        if caps is None:
            # the one routing sync multiplexed serving pays, per (geometry,
            # live count)
            frames = batch.to(eng.device)
            flat = torch.cat([geom.extract(frames[i]) for i in range(n_live)])
            scores = _host_scores(flat, eng.backend).reshape(n_live, geom.n)
            agg = np.zeros(len(widths), np.int64)
            for i, (t1, t2) in enumerate(thresholds):
                agg += np.asarray(sp.subnet_counts(sp.decide(scores[i], t1, t2)))
            caps = eng._snap_profile(agg, p, n_live * geom.n)
            eng._fused_caps[key] = caps
        return caps[:-1] + (min(caps[-1], int(sum(quotas))),)

    def _finalize_tick(self, rec: dict) -> List[FrameResult]:
        """Wait for one tick, split it per stream, and run the host control:
        per-stream Algorithm-1 trim from the counts, share-weighted blame of
        a missed tick deadline, capacity growth after a spill."""
        eng = self.engine
        flight = rec["flight"]
        counts, spills, health = flight.wait()
        done = time.perf_counter()
        # marginal tick time, the engine's fused-stream clock
        dt = done - max(rec["t0"], eng._fused_last_done)
        eng._fused_last_done = done
        live, geom, p = rec["live"], rec["geom"], rec["plan"]
        n = geom.n
        counts_np = np.asarray(counts)           # (live, n_subnets)
        spills_np = np.asarray(spills)
        health_np = np.asarray(health) if p.on_poison != "off" else None
        steps = rec["steps"]
        if p.watchdog_s is not None and dt > p.watchdog_s:
            steps = steps + eng.guard.note_watchdog(rec["index"], dt, p.watchdog_s)
        # grow-only after a tick that spilled; quota demotions count as C54
        # spills, but the per-call quota clamp keeps the served C54 entry
        eng._grow_caps(("mux", geom.cache_key, len(live)), p, len(live) * n,
                       counts_np.sum(0).tolist(), spills_np.sum(0).tolist())
        macs = eng._macs if p.patch == eng.plan.patch else sp.SubnetMacs.make(eng.cfg, p.patch)
        # a poisoned frame under "raise" routed on garbage scores: its
        # controller stays as it was while the stream heads into quarantine
        quarantining = set()
        if health_np is not None and p.on_poison == "raise":
            quarantining = {s for i, s in enumerate(live) if health_np[i].any()}
        for i, s in enumerate(live):
            if s not in quarantining:
                self.bank.observe(s, int(counts_np[i][sp.C54]))
        missed = bool(eng.deadline_s and dt > eng.deadline_s)
        costs = [float(macs.total(tuple(int(c) for c in counts_np[i])))
                 for i in range(len(live))]
        demoted = self.bank.note_tick(missed, costs, streams=live)
        results: List[FrameResult] = []
        for i, s in enumerate(live):
            health_t = tuple(int(x) for x in health_np[i]) if health_np is not None else None
            if health_t is not None and any(health_t):
                eng.guard.record(rec["index"], "poison",
                                 f"stream {s} frame failed health verdict "
                                 f"(nan={health_t[0]}, inf={health_t[1]}, "
                                 f"oob={health_t[2]})")
                if p.on_poison == "raise":
                    # the tenant's twin of the solo raise: drop this stream's
                    # result for the tick and quarantine it
                    self._poisoned.append(s)
                    continue
            counts_t = tuple(int(c) for c in counts_np[i])
            out = FrameResult(
                image=flight.image[i], mode="edge_select",
                backend=eng._variant_label(p, rec["variant"]),
                ids=flight.ids[i * n:(i + 1) * n], scores=flight.scores[i * n:(i + 1) * n],
                counts=counts_t, mac_saving=macs.saving_vs_c54(counts_t), latency_s=dt,
                thresholds=self.bank.switchers[s].thresholds,
                deadline_missed=bool(demoted[s]), dispatch="fused",
                spill_counts=tuple(int(x) for x in spills_np[i]),
                compiled=rec["compiled"], shards=eng.plan.shards, stream_id=s,
                health=health_t, degraded=steps)
            eng.stats.append(dataclasses.replace(out, image=None, ids=None, scores=None))
            results.append(out)
        return results
