"""SREngine — the facade over the port's inference entry points (twin of
``repro.api.engine`` for fp32 single-frame serving under host dispatch).

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

Modes: ``upscale(frame)`` (edge-selective), ``upscale(frame,
mode="all_patches", width=...)`` and ``reference(frame)`` (whole-image
convolution, always the plain model).
"""
from __future__ import annotations

import collections
import glob
import os
import re
import time
import warnings
from pathlib import Path
from typing import Any, Deque, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.plan import ExecutionPlan
from repro_torch.api.result import FrameResult, summarize_stats
from repro_torch.core.pipeline import (BACKENDS, _edge_selective_sr, _health_counts,
                                       _sanitize, _sr_all_patches_result, _sr_whole)
from repro_torch.models.essr import ESSR, ESSRConfig
from repro_torch.runtime.guard import PoisonFrameError

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
                 quant_cache: Optional[str] = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose from {sorted(BACKENDS)}")
        self.plan = plan if plan is not None else ExecutionPlan()
        self.device = _resolve_device(device)
        self.model = model.to(self.device).requires_grad_(False)
        self.cfg: ESSRConfig = model.cfg
        self.params = self.model.tree()
        self.backend = backend
        # quantized serving: calibrate the per-subnet alphas once, here; the
        # pack is engine state, so every frame reuses the same lattice
        self.qpack = self._resolve_quant_pack(calibrate, quant_cache)
        self.stats: Deque[FrameResult] = collections.deque(maxlen=self.plan.stats_window)
        self._warm: set = set()

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_config(cls, cfg: Optional[ESSRConfig] = None, *, seed: int = 0,
                    plan: Optional[ExecutionPlan] = None, backend: str = "cuda",
                    device=None, calibrate=None,
                    quant_cache: Optional[str] = None) -> "SREngine":
        """Fresh engine with He-normal weights drawn from ``seed``.
        ``calibrate`` / ``quant_cache``: see `SREngine` (``plan.quant``)."""
        cfg = cfg if cfg is not None else ESSRConfig()
        model = ESSR(cfg, generator=torch.Generator().manual_seed(seed))
        return cls(model, plan=plan, backend=backend, device=device, calibrate=calibrate,
                   quant_cache=quant_cache)

    @classmethod
    def from_params(cls, params: Dict[str, Any], cfg: ESSRConfig, *,
                    plan: Optional[ExecutionPlan] = None, backend: str = "cuda",
                    device=None, calibrate=None,
                    quant_cache: Optional[str] = None) -> "SREngine":
        """Engine over a reference param tree with numpy leaves."""
        from repro_torch.models.convert import params_from_numpy
        return cls(params_from_numpy(params, cfg), plan=plan, backend=backend,
                   device=device, calibrate=calibrate, quant_cache=quant_cache)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: Optional[str] = None, *,
                        cfg: Optional[ESSRConfig] = None, scale: int = 4, prefer: str = "ema",
                        step: Optional[int] = None,
                        bench_cache: Optional[str] = DEFAULT_BENCH_CACHE,
                        plan: Optional[ExecutionPlan] = None, backend: str = "cuda",
                        device=None, calibrate=None,
                        quant_cache: Optional[str] = None) -> "SREngine":
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

        ``quant_cache`` defaults to ``bench_cache``, as in the reference."""
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
        elif bench_cache:
            pattern = os.path.join(bench_cache, f"essr_x{cfg.scale}_sfb{cfg.n_sfb}_*")
            cands = sorted(glob.glob(pattern), key=_bench_steps, reverse=True)
            for cand in cands:
                try:
                    params = restore_numpy(cand)[0]["params"]
                    break
                except Exception as e:
                    warnings.warn(f"bench-cache restore failed for {cand}: {e!r}; "
                                  f"trying next candidate")
            if cands and params is None:
                warnings.warn(f"no bench-cache candidate under {bench_cache} restored "
                              f"cleanly; serving fresh random init")
        kw = dict(plan=plan, backend=backend, device=device, calibrate=calibrate,
                  quant_cache=quant_cache)
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

    def _ingest(self, frame, p: ExecutionPlan) -> torch.Tensor:
        """Host-side dtype gate: non-float frames are rejected under "raise",
        otherwise normalised by their dtype's range (uint8 -> /255); a dtype
        without integer limits (bool) takes a span of 1, as in the reference."""
        t = frame if isinstance(frame, torch.Tensor) else torch.tensor(np.asarray(frame))
        if t.is_floating_point():
            return t.to(device=self.device, dtype=torch.float32)
        if p.on_poison == "raise":
            raise PoisonFrameError(f"frame dtype {t.dtype} is not floating point "
                                   f"(plan.on_poison='raise')")
        try:
            span = float(torch.iinfo(t.dtype).max)
        except TypeError:
            span = 1.0
        return t.to(device=self.device, dtype=torch.float32) / max(span, 1.0)

    def _host_health(self, frame: torch.Tensor, p: ExecutionPlan):
        """(frame, health or None, route-to-bilinear) under ``p.on_poison``."""
        if p.on_poison == "off":
            return frame, None, False
        health = tuple(int(c) for c in _health_counts(frame).tolist())
        if not any(health):
            return frame, health, False
        if p.on_poison == "raise":
            raise PoisonFrameError(f"frame failed health verdict nan/inf/oob={health} "
                                   f"(plan.on_poison='raise')", health=health)
        return _sanitize(frame), health, p.on_poison == "bilinear"

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _mark_warm(self, key) -> bool:
        warm = key in self._warm
        self._warm.add(key)
        return warm

    # -- single-frame inference ---------------------------------------------

    def upscale(self, frame, mode: str = "edge_select", width: Optional[int] = None,
                ids_override: Optional[np.ndarray] = None,
                plan: Optional[ExecutionPlan] = None) -> FrameResult:
        """One (H,W,3) frame in [0,1] (numpy or tensor) through the pipeline.

        ``mode``: "edge_select" (the plan's routing, or ``ids_override``),
        "all_patches" (every patch through the subnet of ``width``) or
        "whole" (whole-image convolution; ``width`` optional). ``plan``
        overrides the engine's plan for this call. Like the reference's, it
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
        widths = self.cfg.subnet_widths()
        with torch.inference_mode():
            t0 = time.perf_counter()
            frame = self._ingest(frame, p)
            frame, health, force_bilinear = self._host_health(frame, p)
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
                          geometry=geom)
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
                              compiled=compiled, health=health)
        return out

    def reference(self, frame, width: Optional[int] = None) -> FrameResult:
        """Whole-image convolution — the lossless reference."""
        return self.upscale(frame, mode="whole", width=width)

    def warmup(self, shape: Tuple[int, int]) -> FrameResult:
        """Pay an ``(h, w)`` frame shape's one-off set-up (index maps, kernel
        builds) on a synthetic frame — thirds of smooth gradient, mild
        texture and checkerboard, so every subnet runs."""
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

    def summary(self) -> Dict[str, Any]:
        """Aggregate over the recorded frames in ``stats`` (the newest
        ``plan.stats_window``), with what served them; ``{}`` while nothing
        is recorded, as in the reference, whose ``upscale`` records nothing."""
        out = summarize_stats(self.stats)
        if out:
            out.update(backend=self.backend_label, device=str(self.device),
                       fusion=self.plan.fusion, quant=self.plan.quant,
                       stats_window=self.plan.stats_window)
        return out
