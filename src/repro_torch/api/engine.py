"""SREngine — the facade over the port's inference entry points (twin of
``repro.api.engine``: single frames, one adaptive stream and multi-tenant
streams, under host or fused dispatch).

One engine owns the supernet weights (an `ESSR` module on one device), the
`ESSRConfig`, a frozen `ExecutionPlan` and a backend chosen once:

  * "cuda" — the fused kernels, the counterpart of the reference's "pallas"
    and the default: under ``plan.fusion="layer"`` the chain BSConv ->
    n_sfb x SFB -> DSConv, one launch each; under "group" one megakernel
    launch per routed bucket. On the card it launches the CUDA kernels and
    is labelled "cuda" (whatever the fusion, as in the reference); on
    ``device="cpu"`` the kernel wrappers take their plain versions and the
    label says "cuda-plain";
  * "ref"  — the plain PyTorch model.

With ``plan.quant`` set ("fxp10" | "int8") the engine serves the PAMS
quantized datapath: per-subnet activation alphas are PTQ-calibrated once, at
construction (``calibrate=`` batch, or a deterministic synthetic default
whose alphas are cached as JSON in ``quant_cache``, in the reference's
format), into a `QuantPack`. "cuda" serves the integer kernels
(`kernels.qconv`), "ref" the fake-quant emulation; the mode is appended to
the label ("cuda-int8", "cuda-plain-fxp10", "ref-int8", ...). Under
``fusion="group"`` "cuda" serves the quantized megakernel, one launch per
routed bucket (the label does not name the fusion). Routing stays fp32.

The engine runs on the card unless the caller asks for ``device="cpu"``;
without a card it raises, never falling back to the CPU.

Under ``plan.dispatch="fused"`` a threshold-routed ``upscale`` runs the
whole frame as one dispatch (`core.pipeline._fused_frame_fn`): on the card
one CUDA graph replay per (geometry, capacity profile), routing on the
device into fixed per-subnet slots; the capacities are probed on the first
frame of a geometry and grow after a frame that spilled.

Modes: ``upscale(frame)`` (edge-selective), ``upscale(frame,
mode="all_patches", width=...)``, ``reference(frame)`` (whole-image
convolution, always the plain model), ``serve(frame)`` /
``stream(frames)``: Algorithm-1 adaptive thresholds (`core.adaptive`), a
per-frame deadline whose miss demotes the thresholds, and under fused
dispatch with ``plan.inflight >= 2`` up to that many frames in flight; and
``serve_streams(streams)``: ``plan.streams`` tenants through one fused tick
each round (`runtime.multiplex`).

Resilience (`runtime.guard`): every fused launch runs under the engine's
degradation ladder (fusion group->layer, backend ->ref, quant ->fp32,
sticky), which steps down only for a raised exception or a watchdog
overrun, each step in the ledger (``summary()["degradations"]``) and in
``FrameResult.degraded``/``backend``; ``plan.faults`` injects seeded faults.
On the card only an injected fault (or an overrun under ``plan.faults``)
steps down: a real build, capture or launch error raises.
"""
from __future__ import annotations

import collections
import dataclasses
import glob
import os
import re
import time
import warnings
from pathlib import Path
from typing import Any, Deque, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.plan import ExecutionPlan
from repro_torch.api.result import FrameResult, summarize_stats
from repro_torch.core import subnet_policy as sp
from repro_torch.core.adaptive import (AdaptiveSwitcher, ShardSwitcherBank, StreamSwitcherBank,
                                       SwitchingConfig)
from repro_torch.core.pipeline import (BACKENDS, _edge_selective_sr, _fused_frame_fn,
                                       _health_counts, _host_scores, _sanitize,
                                       _sr_all_patches_result, _sr_whole,
                                       compiled_cache_occupancy, configure_compiled_caches,
                                       snap_capacity)
from repro_torch.kernels.megakernel import _TreeKey
from repro_torch.launch.mesh import make_patch_devices
from repro_torch.models.essr import ESSR, ESSRConfig
from repro_torch.runtime.guard import FaultInjector, PoisonFrameError, ResilienceGuard

MODES = ("edge_select", "all_patches", "whole")
#: Where `SREngine.from_checkpoint` looks for cached benchmark supernets
#: without a checkpoint directory: ``$BENCH_CACHE``, else
#: ``results/bench_models`` under the repository root.
DEFAULT_BENCH_CACHE = os.environ.get(
    "BENCH_CACHE", str(Path(__file__).resolve().parents[3] / "results" / "bench_models"))


def _bench_steps(path: str) -> int:
    """Steps of a bench-cache directory ``essr_x<s>_sfb<n>_<steps><tag>``:
    the number leading its last ``_`` part (-1 without one), so "newest"
    means most steps, not the last name in sorted order."""
    m = re.match(r"(\d+)", path.rsplit("_", 1)[-1])
    return int(m.group(1)) if m else -1


def default_calibration_batch(patch: int, scale: int, n: int = 16,
                              seed: int = 1234) -> torch.Tensor:
    """Deterministic PTQ calibration batch on the CPU: ``n`` synthetic LR
    patches in [0,1], one per procedural frame (plain / texture / edges, as
    the router tells apart), each ``degrade(random_image(seed + i, patch *
    scale, patch * scale), scale)``, as the reference draws them."""
    from repro_torch.data.synthetic import degrade, random_image
    return torch.stack([degrade(random_image(seed + i, patch * scale, patch * scale), scale)
                        for i in range(n)])


def _serving_copy(model: ESSR, device: torch.device) -> ESSR:
    """The module an engine serves: ``model`` itself on ``device``, frozen,
    unless its weights take gradients (a model under training), which keeps
    its tensors; then a detached copy of its current weights. Engines built
    from one frozen model share its tensors, and with them every cache
    keyed by the param tree (packed weights, prepared quantized operands,
    captured fused frames and ticks), so they are not copied."""
    if any(p.requires_grad for p in model.parameters()):
        twin = ESSR(model.cfg)
        twin.load_state_dict(model.state_dict())
        model = twin
    return model.to(device).requires_grad_(False)


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("SREngine runs on the CUDA card by default and none is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


class SREngine:
    """Facade over the edge-selective pipeline. See module docstring."""

    def __init__(self, model: ESSR, plan: Optional[ExecutionPlan] = None,
                 backend: str = "cuda", device=None, calibrate=None,
                 quant_cache: Optional[str] = None,
                 switching: Optional[SwitchingConfig] = None,
                 deadline_s: Optional[float] = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose from {sorted(BACKENDS)}")
        self.plan = plan if plan is not None else ExecutionPlan()
        self.device = _resolve_device(device)
        self.model = _serving_copy(model, self.device)
        self.cfg: ESSRConfig = model.cfg
        self.params = self.model.tree()
        self.backend = backend
        self.deadline_s = deadline_s
        # quantized serving: calibrate the per-subnet alphas once, here; the
        # pack is engine state, so every frame reuses the same lattice
        self.qpack = self._resolve_quant_pack(calibrate, quant_cache)
        # serving resilience: the sticky degradation ladder from this
        # engine's serving point and the ledger, plus the optional seeded
        # fault harness; engine state, so the level survives across frames
        self.guard = ResilienceGuard(backend, self.plan.quant is not None, self.plan.fusion,
                                     max_retries=self.plan.max_retries,
                                     injected_only=self.device.type == "cuda",
                                     chaos=self.plan.faults is not None)
        self.injector = FaultInjector(self.plan.faults) if self.plan.faults is not None else None
        self._frame_idx = 0
        base_switching = (switching if switching is not None
                          else SwitchingConfig(t1=self.plan.t1, t2=self.plan.t2))
        self.switcher = AdaptiveSwitcher(base_switching)
        # the sharded patch stream (plan.shards > 1): routing and straggler
        # control are per shard whatever the hardware (one controller a
        # raster strip); the devices exist only where more than one card is
        # visible, otherwise dispatch stays on one device, with the
        # reference's warnings
        self.bank: Optional[ShardSwitcherBank] = None
        self.devices: Optional[Tuple[torch.device, ...]] = None
        if self.plan.shards > 1:
            self.bank = ShardSwitcherBank(base_switching, shards=self.plan.shards)
            avail = torch.cuda.device_count() if self.device.type == "cuda" else 1
            if avail > 1:
                self.devices = make_patch_devices(min(self.plan.shards, avail))
                if avail < self.plan.shards:
                    warnings.warn(
                        f"plan.shards={self.plan.shards} but only {avail} "
                        f"devices visible; dispatching over {avail} "
                        f"(per-shard routing control unchanged)")
            else:
                warnings.warn(
                    f"plan.shards={self.plan.shards} on a single-device "
                    f"host; dispatch falls back to one device "
                    f"(per-shard routing control unchanged)")
        # multi-stream serving: one Algorithm-1 controller per tenant, the
        # budgets split by share; engine state (a per-call plan cannot change
        # the tenants)
        self.stream_bank: Optional[StreamSwitcherBank] = None
        if self.plan.streams > 1:
            self.stream_bank = StreamSwitcherBank(base_switching, streams=self.plan.streams,
                                                  shares=self.plan.stream_shares)
        self._macs = sp.SubnetMacs.make(self.cfg, self.plan.patch)
        self.stats: Deque[FrameResult] = collections.deque(maxlen=self.plan.stats_window)
        self._warm: set = set()
        # fused dispatch: the live capacity profile per geometry, and the
        # marginal-latency clock of the in-flight stream
        self._fused_caps: Dict[Tuple, Tuple[int, ...]] = {}
        self._fused_last_done = 0.0
        # the process-wide frame and geometry caches follow the serving
        # horizon, as in the reference (128 at the default window)
        configure_compiled_caches(max(16, min(512, self.plan.stats_window // 32)))

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_config(cls, cfg: Optional[ESSRConfig] = None, *, seed: int = 0,
                    plan: Optional[ExecutionPlan] = None, backend: str = "cuda",
                    device=None, calibrate=None, quant_cache: Optional[str] = None,
                    switching: Optional[SwitchingConfig] = None,
                    deadline_s: Optional[float] = None) -> "SREngine":
        """Fresh engine with He-normal weights drawn from ``seed``.
        ``calibrate`` / ``quant_cache``: see `SREngine` (``plan.quant``);
        ``switching`` / ``deadline_s``: the stream's Algorithm-1 controller
        (default: the plan's thresholds) and per-frame deadline."""
        cfg = cfg if cfg is not None else ESSRConfig()
        model = ESSR(cfg, generator=torch.Generator().manual_seed(seed)).requires_grad_(False)
        return cls(model, plan=plan, backend=backend, device=device, calibrate=calibrate,
                   quant_cache=quant_cache, switching=switching, deadline_s=deadline_s)

    @classmethod
    def from_params(cls, params: Dict[str, Any], cfg: ESSRConfig, *,
                    plan: Optional[ExecutionPlan] = None, backend: str = "cuda",
                    device=None, calibrate=None, quant_cache: Optional[str] = None,
                    switching: Optional[SwitchingConfig] = None,
                    deadline_s: Optional[float] = None) -> "SREngine":
        """Engine over a reference param tree with numpy leaves."""
        from repro_torch.models.convert import params_from_numpy
        return cls(params_from_numpy(params, cfg).requires_grad_(False), plan=plan,
                   backend=backend, device=device, calibrate=calibrate,
                   quant_cache=quant_cache, switching=switching, deadline_s=deadline_s)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: Optional[str] = None, *,
                        cfg: Optional[ESSRConfig] = None, scale: int = 4, prefer: str = "ema",
                        step: Optional[int] = None,
                        bench_cache: Optional[str] = DEFAULT_BENCH_CACHE,
                        plan: Optional[ExecutionPlan] = None, backend: str = "cuda",
                        device=None, calibrate=None, quant_cache: Optional[str] = None,
                        switching: Optional[SwitchingConfig] = None,
                        deadline_s: Optional[float] = None,
                        verbose: bool = False) -> "SREngine":
        """Engine with trained weights, resolved in the reference's priority
        order:

        1. ``ckpt_dir``: a checkpoint the reference's ``CheckpointManager``
           wrote, holding ``{"params", "ema"}`` (or either); ``prefer`` picks
           the tree that serves, else "params", else the first tree by name
           (warned). A checkpoint that fails to restore warns and serves
           fresh init;
        2. without ``ckpt_dir``: the cached benchmark supernet under
           ``bench_cache`` with the most steps (``essr_x<scale>_sfb<n>_<steps>``),
           warning on each candidate that fails to restore;
        3. fresh init, the weights of ``from_config(cfg, seed=0)``.

        ``quant_cache`` defaults to ``bench_cache``, as in the reference;
        ``verbose`` prints which restored weights serve, as the reference
        does."""
        from repro_torch.ckpt.checkpoint import restore_numpy
        cfg = cfg if cfg is not None else ESSRConfig(scale=scale)
        quant_cache = quant_cache if quant_cache is not None else bench_cache
        params = None
        if ckpt_dir:
            try:
                tree, _ = restore_numpy(ckpt_dir, step)
            except Exception as e:
                tree = None
                warnings.warn(f"checkpoint restore failed for {ckpt_dir}: {e!r}; "
                              f"serving fresh random init")
            if tree is not None:
                use = prefer
                if use not in tree:
                    use = "params" if "params" in tree else sorted(tree)[0]
                    warnings.warn(f"checkpoint {ckpt_dir} has no {prefer!r} tree (found "
                                  f"{sorted(tree)}); serving {use!r} instead")
                params = tree[use]
                if verbose:
                    print(f"(restored {use!r} weights from {ckpt_dir})")
        elif bench_cache:
            pattern = os.path.join(bench_cache, f"essr_x{cfg.scale}_sfb{cfg.n_sfb}_*")
            cands = sorted(glob.glob(pattern), key=_bench_steps, reverse=True)
            for cand in cands:
                try:
                    params = restore_numpy(cand)[0]["params"]
                    if verbose:
                        print(f"(using trained weights from {cand})")
                    break
                except Exception as e:
                    warnings.warn(f"bench-cache restore failed for {cand}: {e!r}; "
                                  f"trying next candidate")
            if cands and params is None:
                warnings.warn(f"no bench-cache candidate under {bench_cache} restored "
                              f"cleanly; serving fresh random init")
        kw = dict(plan=plan, backend=backend, device=device, calibrate=calibrate,
                  quant_cache=quant_cache, switching=switching, deadline_s=deadline_s)
        if params is None:
            return cls.from_config(cfg, seed=0, **kw)
        return cls.from_params(params, cfg, **kw)

    # -- quantized serving -----------------------------------------------------

    def _resolve_quant_pack(self, calibrate, quant_cache: Optional[str]):
        """plan.quant -> a calibrated `QuantPack` (None for fp32 serving).

        ``calibrate``: a (N,h,w,3) LR batch in [0,1]; always calibrated
        fresh. None takes `default_calibration_batch`, whose alphas are
        cached in the directory ``quant_cache`` (when given) under the
        reference's file name, keyed by the weights' fingerprint and the
        plan's patch size."""
        from repro_torch.quant.pams import (build_quant_pack, load_quant_pack,
                                            params_fingerprint, save_quant_pack)
        mode = self.plan.quant
        if mode is None:
            return None
        if calibrate is not None:
            sample = calibrate if isinstance(calibrate, torch.Tensor) else \
                torch.tensor(np.asarray(calibrate, np.float32))
            return build_quant_pack(self.params, self.cfg, mode,
                                    sample.to(self.device, torch.float32))
        cache_path = None
        if quant_cache:
            fp = params_fingerprint(self.params)
            cache_path = os.path.join(
                quant_cache, f"quant_alphas_{mode}_x{self.cfg.scale}_sfb{self.cfg.n_sfb}"
                             f"_p{self.plan.patch}_{fp}.json")
            cached = load_quant_pack(cache_path, fp)
            if cached is not None:
                return cached
        sample = default_calibration_batch(self.plan.patch, self.cfg.scale)
        pack = build_quant_pack(self.params, self.cfg, mode, sample.to(self.device))
        if cache_path:
            try:
                os.makedirs(quant_cache, exist_ok=True)
                save_quant_pack(cache_path, pack, fp)
            except OSError as e:
                warnings.warn(f"quant alpha cache write failed: {e!r}")
        return pack

    # -- labels and ingest -----------------------------------------------------

    def _backend_label(self, plan: ExecutionPlan) -> str:
        """What executes: "cuda" on the card, "cuda-plain" when the kernel
        wrappers ran their plain versions on CPU tensors, "ref"; a quant
        mode is appended ("cuda-int8", "cuda-plain-fxp10", "ref-int8")."""
        base = self.backend
        if self.backend == "cuda" and self.device.type != "cuda":
            base = "cuda-plain"
        return base if plan.quant is None else f"{base}-{plan.quant}"

    @property
    def backend_label(self) -> str:
        return self._backend_label(self.plan)

    def _variant_label(self, plan: ExecutionPlan, v) -> str:
        """`_backend_label` of a ladder rung: what the (perhaps stepped
        down) variant executes, so a degraded frame never wears the planned
        label."""
        base = v.backend
        if v.backend == "cuda" and self.device.type != "cuda":
            base = "cuda-plain"
        return base if (plan.quant is None or not v.quant) else f"{base}-{plan.quant}"

    def _next_index(self) -> int:
        """The engine's monotone frame index, the ledger's coordinate."""
        i = self._frame_idx
        self._frame_idx += 1
        return i

    def _ingest(self, frame, p: ExecutionPlan, index: int, stage: bool = False) -> torch.Tensor:
        """Host-side dtype gate: non-float frames are rejected under "raise",
        otherwise normalised by their dtype's range (uint8 -> /255); a dtype
        without integer limits (bool) takes a span of 1, as in the reference.
        Both record a "poison" event unless the policy is "off".

        ``stage``: a float frame in host memory is copied into pinned memory
        (float32) and left there, for a copy to the card that does not block
        the host (fused dispatch on a CUDA device)."""
        if isinstance(frame, torch.Tensor):
            t = frame
        else:
            a = np.asarray(frame)
            pin = stage and self.device.type == "cuda" and a.flags.writeable
            t = torch.from_numpy(a) if pin else torch.tensor(a)
        if t.is_floating_point():
            if stage and self.device.type == "cuda" and t.device.type == "cpu":
                return torch.empty(t.shape, dtype=torch.float32, pin_memory=True).copy_(t)
            return t.to(device=self.device, dtype=torch.float32)
        dtype = str(t.dtype).replace("torch.", "")      # numpy's name, as the ledger's
        if p.on_poison == "raise":
            self.guard.record(index, "poison", f"non-float frame dtype {dtype}")
            raise PoisonFrameError(f"frame dtype {dtype} is not floating point "
                                   f"(plan.on_poison='raise')")
        if p.on_poison != "off":
            self.guard.record(index, "poison",
                              f"non-float frame dtype {dtype} normalized to float32")
        try:
            span = float(torch.iinfo(t.dtype).max)
        except TypeError:
            span = 1.0
        return t.to(device=self.device, dtype=torch.float32) / max(span, 1.0)

    def _host_health(self, frame: torch.Tensor, p: ExecutionPlan, index: int):
        """(frame, health or None, route-to-bilinear) under ``p.on_poison``;
        a poisoned frame records a "poison" event."""
        if p.on_poison == "off":
            return frame, None, False
        health = tuple(int(c) for c in _health_counts(frame).tolist())
        if not any(health):
            return frame, health, False
        self.guard.record(index, "poison",
                          f"frame health nan/inf/oob={health} (policy {p.on_poison})")
        if p.on_poison == "raise":
            raise PoisonFrameError(f"frame failed health verdict nan/inf/oob={health} "
                                   f"(plan.on_poison='raise')", health=health)
        return _sanitize(frame), health, p.on_poison == "bilinear"

    def _guarded_frames(self, frames: Iterable, stream_id: int = 0) -> Iterator:
        """Iterate a stream's frames under the fault harness (``plan.faults``
        wraps the iterator with seeded poison and errors); an iterator that
        raises ends the stream with a recorded "retire" event instead of
        raising into the caller."""
        it = iter(frames)
        if self.injector is not None:
            it = self.injector.wrap_stream(stream_id, it)
        n = 0
        while True:
            try:
                frame = next(it)
            except StopIteration:
                return
            except Exception as e:
                self.guard.record(n, "retire", f"stream {stream_id} iterator raised: {e!r}")
                return
            yield frame
            n += 1

    def _refuse_streams(self) -> None:
        """``serve``/``stream`` take one stream; a multi-stream plan admits a
        frame per tenant per tick, through ``serve_streams``."""
        if self.plan.streams > 1:
            raise ValueError(
                f"plan.streams={self.plan.streams}: multi-stream serving "
                f"admits one frame per tenant per tick — use serve_streams()")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _mark_warm(self, key) -> bool:
        warm = key in self._warm
        self._warm.add(key)
        return warm

    # -- fused dispatch (plan.dispatch == "fused") -----------------------------

    def _snap_profile(self, desired, p: ExecutionPlan, limit: int) -> Tuple[int, ...]:
        """Per-subnet desired counts -> a capacity profile: entry 0 is 0 (the
        bilinear lane runs dense), conv entries snap to the plan's buckets,
        clamped to ``limit`` patches (a frame's, or a tick's pool). Cached
        unclamped: the stream's C54 ceiling is applied per call."""
        return tuple([0] + [snap_capacity(int(d), p.buckets, limit) for d in desired[1:]])

    def _c54_frame_budget(self) -> int:
        """The frame's share of the Algorithm-1 C54-a-second budget: the
        ceiling fused streaming holds in its graph through the C54 capacity
        (the overflow runs C27)."""
        c = self.switcher.cfg
        return max(1, int(c.c54_per_sec_budget) // max(c.fps, 1))

    def _fused_caps_for(self, geom, p: ExecutionPlan, frame: torch.Tensor,
                        thresholds: Tuple[float, float], streaming: bool) -> Tuple[int, ...]:
        """The capacity profile of one frame. ``plan.capacity`` pins it;
        otherwise the first frame of a geometry is scored on the host (the
        one routing sync fused dispatch pays) and later frames reuse or grow
        the cached profile."""
        widths = self.cfg.subnet_widths()
        if p.capacity is not None:
            if len(p.capacity) != len(widths):
                raise ValueError(f"plan.capacity {p.capacity} must have one entry per "
                                 f"subnet width {widths}")
            return p.capacity
        caps = self._fused_caps.get(geom.cache_key)
        if caps is None:
            probe = frame.to(self.device)
            if p.on_poison != "off":
                # a poisoned first frame must not seed its geometry's profile
                probe = _sanitize(probe)
            scores = _host_scores(geom.extract(probe), self.backend)
            caps = self._snap_profile(sp.subnet_counts(sp.decide(scores, *thresholds)), p,
                                      geom.n)
            self._fused_caps[geom.cache_key] = caps
        if streaming:
            # the stream's hard C54 ceiling, per call: the cached profile stays
            # unclamped for upscale()
            caps = caps[:-1] + (min(caps[-1], self._c54_frame_budget()),)
        return caps

    def _grow_caps(self, key, p: ExecutionPlan, limit: int, counts, spills) -> None:
        """After a frame that spilled, grow the geometry's profile to the
        bucket ceiling of the demand seen (served + spilled); grow-only."""
        if p.capacity is not None or not any(spills[1:]):
            return
        old = self._fused_caps.get(key)
        if old is None:
            return
        new = self._snap_profile([c + s for c, s in zip(counts, spills)], p, limit)
        self._fused_caps[key] = tuple(max(o, n) for o, n in zip(old, new))

    def _refuse_devices(self, what: str) -> None:
        """A CUDA graph is captured on one device: fused dispatch over more
        than one distinct device is not ported (ROADMAP item 12b)."""
        if self.devices is not None and len(set(self.devices)) > 1:
            raise ValueError(
                f"{what} over {len(set(self.devices))} devices (plan.shards="
                f"{self.plan.shards}) is not ported (ROADMAP item 12b): a CUDA graph is "
                f"captured on one device; serve with dispatch='host' or on one card")

    def _launch_fused(self, frame, p: ExecutionPlan, thresholds: Tuple[float, float],
                      streaming: bool) -> dict:
        """Enqueue one frame on its fused frame without waiting for the
        device; returns the in-flight record `_finalize_fused` completes.
        The launch runs under the degradation ladder: a failure steps down
        and runs again (on the card only an injected one; a real capture or
        launch failure raises)."""
        self._refuse_devices("fused dispatch")
        with torch.inference_mode():
            t0 = time.perf_counter()
            index = self._next_index()
            frame = self._ingest(frame, p, index, stage=True)
            geom = p.geometry(frame.shape[0], frame.shape[1], self.cfg.scale, self.device)
            caps = self._fused_caps_for(geom, p, frame, thresholds, streaming)
            if self.injector is not None:
                self.injector.maybe_delay(index)

            def attempt(v):
                if self.injector is not None:
                    self.injector.maybe_fail_launch(index)
                fn = _fused_frame_fn(_TreeKey(self.params), geom, caps, self.cfg, v.backend,
                                     self.qpack if v.quant else None, v.fusion, p.on_poison,
                                     str(self.device))
                return fn.launch(frame[None], (thresholds[0],), (thresholds[1],), (0,))

            flight, steps = self.guard.run(attempt, index)
        v = self.guard.variant
        key = ("fused", geom.cache_key, caps, v.backend, v.quant, v.fusion, p.on_poison)
        return {"flight": flight, "geom": geom, "t0": t0, "plan": p,
                "thresholds": tuple(thresholds), "compiled": self._mark_warm(key),
                "streaming": streaming, "index": index, "variant": v, "steps": steps}

    def _finalize_fused(self, rec: dict) -> FrameResult:
        """Wait for one in-flight frame (its own event), copy its counts,
        spills and health to the host in one small copy, and run the control
        that fused dispatch leaves to the host: the health policy's host side,
        capacity growth after a spill and, when streaming, the Algorithm-1
        trim and the deadline demotion."""
        flight = rec["flight"]
        counts, spills, health = (rows[0] for rows in flight.wait())
        done = time.perf_counter()
        # marginal frame time: in flight, a frame's launch-to-ready clock
        # holds earlier frames' device time, so it starts at the later of its
        # launch and the previous frame's completion
        dt = done - max(rec["t0"], self._fused_last_done)
        self._fused_last_done = done
        p, geom, streaming = rec["plan"], rec["geom"], rec["streaming"]
        if p.on_poison == "off":
            health = None
        elif any(health):
            self.guard.record(rec["index"], "poison",
                              f"frame health nan/inf/oob={health} (policy {p.on_poison})")
            if p.on_poison == "raise":
                raise PoisonFrameError(f"frame failed health verdict nan/inf/oob={health} "
                                       f"(plan.on_poison='raise')", health=health)
        steps = rec["steps"]
        if streaming and p.watchdog_s is not None and dt > p.watchdog_s:
            steps = steps + self.guard.note_watchdog(rec["index"], dt, p.watchdog_s)
        macs = self._macs if p.patch == self.plan.patch else sp.SubnetMacs.make(self.cfg, p.patch)
        self._grow_caps(geom.cache_key, p, geom.n, counts, spills)
        live, missed, shard_counts = rec["thresholds"], False, None
        if streaming:
            self.switcher.observe_frame(counts[sp.C54])
            missed = bool(self.deadline_s and dt > self.deadline_s)
            if missed:
                self.switcher.demote_for_straggler(severity=1.0)
            live = self.switcher.thresholds
            if self.bank is not None:
                # reporting only: the fused frame routes in one decision on
                # the device, so per-shard control is host dispatch's; the
                # strips' counts are still reported
                ids = flight.ids.cpu().numpy()
                shard_counts = tuple(sp.subnet_counts(ids[sl])
                                     for sl in geom.shard_slices(self.plan.shards))
        out = FrameResult(image=flight.image[0], mode="edge_select",
                          backend=self._variant_label(p, rec["variant"]), ids=flight.ids,
                          scores=flight.scores, counts=counts,
                          mac_saving=macs.saving_vs_c54(counts), latency_s=dt, thresholds=live,
                          deadline_missed=missed, shards=self.plan.shards,
                          shard_counts=shard_counts, dispatch="fused", spill_counts=spills,
                          compiled=rec["compiled"], health=health, degraded=steps)
        if streaming:
            self.stats.append(dataclasses.replace(out, image=None, ids=None, scores=None))
        return out

    def _upscale_fused(self, frame, p: ExecutionPlan) -> FrameResult:
        return self._finalize_fused(self._launch_fused(frame, p, (p.t1, p.t2), streaming=False))

    # -- single-frame inference ---------------------------------------------

    def upscale(self, frame, mode: str = "edge_select", width: Optional[int] = None,
                ids_override: Optional[np.ndarray] = None,
                plan: Optional[ExecutionPlan] = None) -> FrameResult:
        """One (H,W,3) frame in [0,1] (numpy or tensor) through the pipeline.

        ``mode``: "edge_select" (the plan's routing, or ``ids_override``),
        "all_patches" (every patch through the subnet of ``width``) or
        "whole" (whole-image convolution; ``width`` optional). ``plan``
        overrides the engine's plan for this call. Under ``dispatch="fused"``
        a threshold-routed edge_select call runs the fused frame; every
        other call runs host dispatch and says so. Like the reference's, it
        records nothing in ``stats``."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        if mode == "edge_select" and width is not None:
            raise ValueError("width only applies to mode='all_patches'/'whole'; "
                             "for forced routing use mode='all_patches'")
        if mode != "edge_select" and ids_override is not None:
            raise ValueError("ids_override requires mode='edge_select'")
        p = plan if plan is not None else self.plan
        if p.quant != self.plan.quant:
            # quant is engine state (the calibrated alphas), like the backend
            raise ValueError(
                f"plan.quant is engine-level: engine was built with "
                f"{self.plan.quant!r}, per-call plan asks for {p.quant!r}; "
                f"construct a second engine for a different quant mode")
        if (p.dispatch == "fused" and mode == "edge_select" and ids_override is None
                and p.subnet_policy == "threshold"):
            return self._upscale_fused(frame, p)
        widths = self.cfg.subnet_widths()
        with torch.inference_mode():
            t0 = time.perf_counter()
            index = self._next_index()
            frame = self._ingest(frame, p, index)
            frame, health, force_bilinear = self._host_health(frame, p, index)
            hw = (int(frame.shape[0]), int(frame.shape[1]))
            if mode == "whole":
                if width is not None and width not in widths:
                    raise ValueError(f"mode='whole' needs width in {widths} "
                                     f"(or None for full), got {width}")
                compiled = self._mark_warm(("whole", hw, width))
                img = _sr_whole(self.params, frame, self.cfg, width=width)
                self._sync()
                # the whole-image reference always runs the plain model
                return FrameResult(image=img, mode=mode, backend="ref",
                                   latency_s=time.perf_counter() - t0,
                                   compiled=compiled, health=health)
            geom = p.geometry(hw[0], hw[1], self.cfg.scale, self.device)
            compiled = self._mark_warm(("host", hw, p.patch, p.overlap, p.fusion))
            common = dict(patch=p.patch, overlap=p.overlap, buckets=p.buckets,
                          backend=self.backend, fusion=p.fusion, quant=self.qpack,
                          geometry=geom, devices=self.devices)
            result_mode, scored = mode, False
            if mode == "all_patches":
                if width not in widths:
                    raise ValueError(f"mode='all_patches' needs width in {widths}, "
                                     f"got {width}")
                res = _sr_all_patches_result(self.params, frame, self.cfg, width, **common)
            elif ids_override is None and p.subnet_policy != "threshold":
                result_mode = "all_patches"      # a forced policy ignores the scores
                forced = widths[int(p.decide(np.zeros(1))[0])]
                res = _sr_all_patches_result(self.params, frame, self.cfg, forced, **common)
            else:
                if force_bilinear and ids_override is None:
                    ids_override = np.zeros(geom.n, np.int64)
                scored = ids_override is None
                res = _edge_selective_sr(self.params, frame, self.cfg, t1=p.t1, t2=p.t2,
                                         ids_override=ids_override, **common)
            self._sync()
            out = FrameResult(image=res.image, mode=result_mode, backend=self._backend_label(p),
                              ids=res.ids, scores=res.scores if scored else None,
                              counts=res.counts, mac_saving=res.mac_saving,
                              latency_s=time.perf_counter() - t0,
                              thresholds=p.thresholds if scored else (0.0, 0.0),
                              shards=self.plan.shards, compiled=compiled, health=health)
        return out

    def reference(self, frame, width: Optional[int] = None) -> FrameResult:
        """Whole-image convolution — the lossless reference."""
        return self.upscale(frame, mode="whole", width=width)

    def warmup(self, shape: Tuple[int, int]) -> FrameResult:
        """Pay an ``(h, w)`` frame shape's one-off set-up (index maps, kernel
        builds; under fused dispatch the capacity probe and the graph
        capture) on a synthetic frame — thirds of smooth gradient, mild
        texture and checkerboard, so every subnet runs. Records nothing."""
        h, w = int(shape[0]), int(shape[1])
        yy, xx = torch.meshgrid(torch.linspace(0.0, 1.0, h), torch.linspace(0.0, 1.0, w),
                                indexing="ij")
        checker = ((torch.arange(h)[:, None] + torch.arange(w)[None, :]) % 2).float()
        smooth = torch.stack([yy, xx, (yy + xx) / 2], dim=-1)
        frame = torch.where((xx < 1 / 3)[..., None], smooth,
                            torch.where((xx < 2 / 3)[..., None],
                                        smooth + 0.03 * checker[..., None],
                                        checker[..., None] * torch.ones(3)))
        return self.upscale(torch.clamp(frame, 0.0, 1.0))

    # -- streaming (Algorithm 1 + deadline control) ---------------------------

    def serve(self, frame) -> FrameResult:
        """One frame of the adaptive stream: edge scores -> Algorithm-1
        routing (with the per-second C54 ceiling) -> edge-selective SR. A
        missed ``deadline_s`` raises the thresholds (straggler demotion).
        Appends a compact record (no image, ids or scores) to ``stats``."""
        self._refuse_streams()
        if self.plan.subnet_policy != "threshold":
            raise ValueError(
                f"streaming routes adaptively and cannot honour forced "
                f"subnet_policy {self.plan.subnet_policy!r}; use upscale() "
                f"for forced routing")
        if self.plan.dispatch == "fused":
            # routing and the C54 ceiling run in the frame's graph; the
            # Algorithm-1 trim runs on the host from its counts
            return self._finalize_fused(self._launch_fused(
                frame, self.plan, self.switcher.thresholds, streaming=True))
        p = self.plan
        with torch.inference_mode():
            t0 = time.perf_counter()
            index = self._next_index()
            frame = self._ingest(frame, p, index)
            frame, health, force_bilinear = self._host_health(frame, p, index)
            hw = (int(frame.shape[0]), int(frame.shape[1]))
            geom = p.geometry(hw[0], hw[1], self.cfg.scale, self.device)
            compiled = self._mark_warm(("host", hw, p.patch, p.overlap, p.fusion))
            patches = geom.extract(frame)
            scores = _host_scores(patches, self.backend)
            slices = geom.shard_slices(self.plan.shards) if self.bank is not None else None
            if force_bilinear:
                # the dense fallback lane; the switcher observes nothing
                ids = np.zeros(len(scores), np.int64)
            elif slices is not None:
                ids = self.bank.assign(scores, slices)
            else:
                ids = self.switcher.assign(scores)
            res = _edge_selective_sr(self.params, frame, self.cfg, patch=p.patch,
                                     overlap=p.overlap, ids_override=ids, buckets=p.buckets,
                                     backend=self.backend, fusion=p.fusion, quant=self.qpack,
                                     geometry=geom, precomputed=(patches, scores),
                                     devices=self.devices)
            self._sync()
            dt = time.perf_counter() - t0
        missed = bool(self.deadline_s and dt > self.deadline_s)
        shard_counts = shard_thresholds = shard_missed = None
        if slices is not None:
            # each strip's MAC cost decides which shards a miss demotes; the
            # scalar thresholds are the mean over shards
            shard_counts = tuple(sp.subnet_counts(ids[sl]) for sl in slices)
            shard_missed = self.bank.note_frame(missed, [self._macs.total(c)
                                                         for c in shard_counts])
            shard_thresholds = self.bank.thresholds
            live = tuple(float(np.mean([t[i] for t in shard_thresholds])) for i in (0, 1))
        else:
            if missed:
                self.switcher.demote_for_straggler(severity=1.0)
            live = self.switcher.thresholds
        out = FrameResult(image=res.image, mode="edge_select", backend=self.backend_label,
                          ids=ids, scores=scores, counts=res.counts, mac_saving=res.mac_saving,
                          latency_s=dt, thresholds=live, deadline_missed=missed,
                          shards=self.plan.shards, shard_counts=shard_counts,
                          shard_thresholds=shard_thresholds,
                          shard_deadline_missed=shard_missed, compiled=compiled, health=health)
        # the compact record only: a long stream must not hold every image
        self.stats.append(dataclasses.replace(out, image=None, ids=None, scores=None))
        return out

    def stream(self, frames: Iterable) -> Iterator[FrameResult]:
        """Serve a frame stream; yields one FrameResult per frame, in order.

        Under fused dispatch with ``plan.inflight >= 2`` up to ``inflight``
        frames are in flight, so frame N's device work overlaps frame N+1's
        host work. The cost is a control delay: the switcher (and capacity
        growth) adapt from the newest finished frame, up to ``inflight - 1``
        frames behind the newest launched one. An iterator that raises ends
        the stream with a "retire" event in the ledger."""
        self._refuse_streams()
        frames = self._guarded_frames(frames)
        if self.plan.dispatch == "fused" and self.plan.inflight > 1:
            yield from self._stream_fused_async(frames)
            return
        for frame in frames:
            yield self.serve(frame)

    def _stream_fused_async(self, frames: Iterable) -> Iterator[FrameResult]:
        pending: Deque[dict] = collections.deque()
        for frame in frames:
            pending.append(self._launch_fused(frame, self.plan, self.switcher.thresholds,
                                              streaming=True))
            while len(pending) >= self.plan.inflight:
                yield self._finalize_fused(pending.popleft())
        while pending:
            yield self._finalize_fused(pending.popleft())

    def serve_streams(self, streams: Iterable[Iterable]) -> Iterator[FrameResult]:
        """Serve ``plan.streams`` tenant frame streams through one fused
        dispatch per admission tick (the multi-tenant front door).

        ``streams``: one frame iterable per tenant, in stream-id order. Each
        tick takes the next frame of every live stream (round robin), packs
        the routed patches of all of them into one fused tick, and yields one
        `FrameResult` per live stream (``stream_id`` set), ticks in order and
        streams in id order within a tick. Every stream keeps its own
        Algorithm-1 switcher with a share of the budget
        (``plan.stream_shares``); under overload each stream's C54 slots
        degrade by its share, and no frame is dropped. A stream that runs out
        leaves the tick (on the card, one graph per live count).
        ``plan.inflight >= 2`` keeps that many ticks in flight.

        With ``plan.streams == 1`` this is ``stream()`` over the one
        iterable."""
        streams = list(streams)
        if len(streams) != self.plan.streams:
            raise ValueError(f"serve_streams got {len(streams)} streams for "
                             f"plan.streams={self.plan.streams}")
        if self.plan.streams == 1:
            yield from self.stream(streams[0])
            return
        self._refuse_devices("serve_streams")
        from repro_torch.runtime.multiplex import StreamMultiplexer
        yield from StreamMultiplexer(self).serve(streams)

    # -- aggregate reporting ---------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """Aggregate over the recorded (streamed) frames in ``stats``, the
        newest ``plan.stats_window``, with what served them and the compiled
        caches' occupancy; ``degradations``, the ledger (ladder steps,
        poison, quarantine, retire and watchdog events), whenever it holds
        events. ``{}`` while there is neither, as in the reference."""
        s = summarize_stats(self.stats)
        if s:
            s["backend"] = self.backend_label
            s["stats_window"] = self.plan.stats_window
            s["compiled_caches"] = compiled_cache_occupancy()
        if self.guard.events:
            s["degradations"] = self.guard.summary()
        return s
