"""End-to-end edge-selective SR of full frames, host dispatch (twin of the
host-dispatch path of ``repro.core.pipeline``).

frame -> slim-overlap patches -> edge scores -> subnet decision ->
per-subnet batched forward -> overlap-average fusion.

The "cuda" backend scores the patches with the edge kernel
(`kernels.edge.edge_score_fused`; on CPU tensors it takes its plain
version); the "ref" backend, and a forced routing, keep the plain
`core.edge_score.edge_score`. Routing stays on the host: the scores are
copied back once per frame, each subnet's patches are gathered into a batch
padded to a bucketed size (with the bucket's own last index), run through
the subnet, and set back into the patch tensor. Width-0 patches go through
bilinear resize, never a kernel.

``backend`` picks the per-subnet forward: "cuda" (the fused kernels; on
CPU tensors their wrappers run their plain versions) or "ref" (the plain
PyTorch model); ``fusion`` picks the "cuda" backend's kernel granularity;
``quant`` (a `QuantPack`, or None for fp32) serves the PAMS lattice: "cuda"
through the integer kernels, "ref" through the fake-quant emulation.
Routing stays fp32 either way: the edge scores come from the fp frame.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import subnet_policy as sp
from repro_torch.core.edge_score import edge_score
from repro_torch.core.patching import PatchGeometry, get_geometry
from repro_torch.models.essr import ESSRConfig, essr_forward
from repro_torch.models.layers import bilinear_resize

DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

#: ``ExecutionPlan.on_poison`` values: what serving does about a frame with
#: NaN/Inf/out-of-[0,1] pixels ("off": no verdict; "raise": PoisonFrameError;
#: "sanitize": nan_to_num + clamp; "bilinear": sanitize, then route every
#: patch to bilinear).
HEALTH_POLICIES = ("off", "raise", "sanitize", "bilinear")

#: ``ExecutionPlan.fusion`` values, the "cuda" backend's kernel granularity:
#: "layer" — one launch per layer group (BSConv, each SFB, DSConv), the
#:           feature map round-trips device memory between them;
#: "group" — one megakernel launch per routed bucket runs the whole chain with
#:           each patch's feature (or, under ``quant``, its codes) in shared
#:           memory (`kernels.megakernel`).
#: The "ref" backend has no kernels to fuse and runs both identically.
FUSION_MODES = ("layer", "group")


def _bucket(n: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(np.ceil(n / buckets[-1]) * buckets[-1])


def _forward_width(params, patches, cfg: ESSRConfig, width: int) -> torch.Tensor:
    """The plain model ("ref" backend)."""
    return essr_forward(params, patches, cfg, width=width)


def _forward_width_cuda(params, patches, cfg: ESSRConfig, width: int) -> torch.Tensor:
    """The fused kernel chain ("cuda" backend); width 0 is the bilinear bypass."""
    from repro_torch.kernels.ops import essr_forward_kernels
    if width == 0:
        return bilinear_resize(patches, cfg.scale)
    return essr_forward_kernels(params, patches, cfg, width=width)


def _forward_width_mega(params, patches, cfg: ESSRConfig, width: int) -> torch.Tensor:
    """The subnet-group megakernel ("cuda" backend, fusion "group"): one
    launch runs the whole layer chain; width 0 is the same bilinear bypass."""
    from repro_torch.kernels.megakernel import essr_forward_megakernel
    if width == 0:
        return bilinear_resize(patches, cfg.scale)
    return essr_forward_megakernel(params, patches, cfg, width=width)


BACKENDS = {"cuda": _forward_width_cuda, "ref": _forward_width}


# ---------------------------------------------------------------------------
# quantized per-subnet forwards (ExecutionPlan.quant = "fxp10" | "int8")
# ---------------------------------------------------------------------------

def _forward_width_quant_ref(params, patches, cfg: ESSRConfig, width: int, *, quant):
    """PAMS fake-quant emulation of the whole forward (W/A quantized at every
    conv boundary with the pack's PTQ alphas): the "ref" quant backend."""
    from repro_torch.quant.pams import quantized_essr_forward
    if width == 0:
        return bilinear_resize(patches, cfg.scale)
    scales = {k: torch.tensor(v, dtype=torch.float32, device=patches.device)
              for k, v in quant.act_scales(width).items()}
    return quantized_essr_forward(params, scales, patches, cfg, quant.qcfg, width=width)


def _forward_width_quant_cuda(params, patches, cfg: ESSRConfig, width: int, *, quant):
    """The integer kernel chain (`kernels.qconv`): the "cuda" quant backend;
    width 0 is the bilinear bypass."""
    from repro_torch.kernels.qconv import essr_forward_qkernels
    if width == 0:
        return bilinear_resize(patches, cfg.scale)
    return essr_forward_qkernels(params, patches, cfg, width=width, pack=quant)


def _forward_width_quant_mega(params, patches, cfg: ESSRConfig, width: int, *, quant):
    """The quantized megakernel (`kernels.megakernel.essr_forward_qmegakernel`):
    the "cuda" quant backend under fusion "group", one launch per bucket;
    width 0 is the bilinear bypass."""
    from repro_torch.kernels.megakernel import essr_forward_qmegakernel
    if width == 0:
        return bilinear_resize(patches, cfg.scale)
    return essr_forward_qmegakernel(params, patches, cfg, width=width, pack=quant)


QUANT_BACKENDS = {"cuda": _forward_width_quant_cuda, "ref": _forward_width_quant_ref}


def resolve_forward(backend: str, quant=None, fusion: str = "layer"):
    """(backend, QuantPack or None, fusion) -> the per-subnet forward
    ``(params, patches, cfg, width)``. ``fusion`` (see `FUSION_MODES`)
    selects the "cuda" backend's kernel granularity, fp32 or quantized;
    "ref" resolves both values to the same forward."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {sorted(BACKENDS)}")
    if fusion not in FUSION_MODES:
        raise ValueError(f"unknown fusion {fusion!r}; choose from {FUSION_MODES}")
    if backend == "cuda" and fusion == "group":
        if quant is None:
            return _forward_width_mega
        return functools.partial(_forward_width_quant_mega, quant=quant)
    if quant is None:
        return BACKENDS[backend]
    return functools.partial(QUANT_BACKENDS[backend], quant=quant)


def _health_counts(frame: torch.Tensor) -> torch.Tensor:
    """(nan, inf, out-of-[0,1]) pixel counts of one frame, int32 (3,)."""
    nan = torch.isnan(frame).sum()
    inf = torch.isinf(frame).sum()
    oob = (torch.isfinite(frame) & ((frame < 0.0) | (frame > 1.0))).sum()
    return torch.stack([nan, inf, oob]).to(torch.int32)


def _sanitize(frame: torch.Tensor) -> torch.Tensor:
    """nan -> 0, +inf -> 1, -inf -> 0, clamp to [0,1]; bit-exact identity on
    clean in-range frames."""
    return torch.clamp(torch.nan_to_num(frame, nan=0.0, posinf=1.0, neginf=0.0), 0.0, 1.0)


@dataclasses.dataclass
class SRResult:
    image: torch.Tensor
    ids: np.ndarray
    scores: np.ndarray
    counts: Tuple[int, int, int]
    mac_saving: float


def _edge_selective_sr(params: Dict[str, Any], frame: torch.Tensor, cfg: ESSRConfig, *,
                       t1: float = sp.DEFAULT_T1, t2: float = sp.DEFAULT_T2,
                       patch: int = 32, overlap: int = 2,
                       ids_override: Optional[np.ndarray] = None,
                       buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                       backend: str = "cuda", fusion: str = "layer", quant=None,
                       geometry: Optional[PatchGeometry] = None) -> SRResult:
    """frame: (H,W,3) in [0,1] -> SRResult with the (H*s, W*s, 3) image.
    ``ids_override`` forces the routing and skips the edge scores (reported
    as zeros). ``quant``: a `QuantPack` for quantized serving."""
    forward = resolve_forward(backend, quant, fusion)
    s = cfg.scale
    h, w = int(frame.shape[0]), int(frame.shape[1])
    g = geometry if geometry is not None else get_geometry(
        h, w, patch, overlap, s, str(frame.device))
    patches = g.extract(frame)
    if ids_override is None:
        if backend == "cuda":
            from repro_torch.kernels.edge import edge_score_fused
            scores = edge_score_fused(patches).cpu().numpy()
        else:
            scores = edge_score(patches).cpu().numpy()
        ids = sp.decide(scores, t1, t2)
    else:
        scores = np.zeros(g.n, np.float32)
        ids = np.asarray(ids_override)
    out = torch.zeros((g.n, patch * s, patch * s, cfg.in_channels),
                      dtype=patches.dtype, device=patches.device)
    for k, width in enumerate(cfg.subnet_widths()):
        idx = np.flatnonzero(ids == k)
        if idx.size == 0:
            continue
        if idx.size == len(ids):
            # one subnet takes the whole frame: no gather/scatter and no
            # bucket padding (the full-batch shape recurs per geometry)
            out = forward(params, patches, cfg, width)
            continue
        cap = _bucket(idx.size, buckets)
        # pad with the bucket's own last index: duplicate work, never
        # another subnet's patch
        pad = np.concatenate([idx, np.full(cap - idx.size, idx[-1], idx.dtype)])
        sel = torch.from_numpy(pad).to(patches.device)
        sr = forward(params, patches.index_select(0, sel), cfg, width)[: idx.size]
        # idx is strictly increasing, so this set-scatter is unique and
        # deterministic
        out.index_copy_(0, sel[: idx.size], sr.contiguous())
    counts = sp.subnet_counts(ids)
    saving = sp.SubnetMacs.make(cfg, patch).saving_vs_c54(counts)
    return SRResult(image=g.fuse_average(out), ids=ids, scores=scores, counts=counts,
                    mac_saving=saving)


def _sr_all_patches_result(params, frame: torch.Tensor, cfg: ESSRConfig, width: int, *,
                           patch: int = 32, overlap: int = 2,
                           buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                           backend: str = "cuda", fusion: str = "layer", quant=None,
                           geometry: Optional[PatchGeometry] = None) -> SRResult:
    """Every patch through one subnet (the non-edge-selective reference)."""
    widths = cfg.subnet_widths()
    if width not in widths:
        raise ValueError(f"width {width} not one of the subnet widths {widths}")
    g = geometry if geometry is not None else get_geometry(
        int(frame.shape[0]), int(frame.shape[1]), patch, overlap, cfg.scale,
        str(frame.device))
    ids = np.full((g.n,), widths.index(width), dtype=np.int64)
    return _edge_selective_sr(params, frame, cfg, patch=patch, overlap=overlap,
                              ids_override=ids, buckets=buckets, backend=backend,
                              fusion=fusion, quant=quant, geometry=g)


def _sr_whole(params, frame: torch.Tensor, cfg: ESSRConfig,
              width: Optional[int] = None) -> torch.Tensor:
    """Whole-image convolution (the lossless reference), plain model."""
    return essr_forward(params, frame[None], cfg, width=width)[0]
