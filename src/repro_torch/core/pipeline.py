"""End-to-end edge-selective SR of full frames under host and fused
dispatch (twin of ``repro.core.pipeline`` over the paths this package
serves).

frame -> slim-overlap patches -> edge scores -> subnet decision ->
per-subnet batched forward -> overlap-average fusion.

The "cuda" backend scores the patches with the edge kernel
(`kernels.edge.edge_score_fused`; on CPU tensors it takes its plain
version); the "ref" backend, and a forced routing, keep the plain
`core.edge_score.edge_score`. Under host dispatch routing stays on the
host: the scores are copied back once per frame, each subnet's patches are
gathered into a batch padded to a bucketed size (with the bucket's own last
index), run through the subnet, and set back into the patch tensor. Width-0
patches go through bilinear resize, never a kernel. Under fused dispatch
(section "fused single dispatch" below) the whole frame is one function of
the frame and the thresholds with the routing on the device, captured on
the card as one CUDA graph per capacity profile.

``backend`` picks the per-subnet forward: "cuda" (the fused kernels; on
CPU tensors their wrappers run their plain versions) or "ref" (the plain
PyTorch model); ``fusion`` picks the "cuda" backend's kernel granularity;
``quant`` (a `QuantPack`, or None for fp32) serves the PAMS lattice: "cuda"
through the integer kernels, "ref" through the fake-quant emulation.
Routing stays fp32 either way: the edge scores come from the fp frame.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import subnet_policy as sp
from repro_torch.core.caching import BoundedCache
from repro_torch.core.edge_score import edge_score
from repro_torch.core.patching import PatchGeometry, get_geometry
from repro_torch.core.tree import tree_map
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

#: The pack's activation alphas of one width as fp32 tensors on one device,
#: by (pack, width, device): made once, so a captured frame copies nothing
#: from the host.
_act_scales = BoundedCache(
    lambda quant, width, device: {k: torch.tensor(v, dtype=torch.float32, device=device)
                                  for k, v in quant.act_scales(width).items()},
    maxsize=16)


def _forward_width_quant_ref(params, patches, cfg: ESSRConfig, width: int, *, quant):
    """PAMS fake-quant emulation of the whole forward (W/A quantized at every
    conv boundary with the pack's PTQ alphas): the "ref" quant backend."""
    from repro_torch.quant.pams import quantized_essr_forward
    if width == 0:
        return bilinear_resize(patches, cfg.scale)
    scales = _act_scales(quant, width, str(patches.device))
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


# ---------------------------------------------------------------------------
# data-parallel per-subnet forward (the sharded patch stream)
# ---------------------------------------------------------------------------

def _device(d) -> torch.device:
    """``d`` as a device with its index ("cuda" is the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _replica(params, device: torch.device):
    """``params`` on ``device``: the tree itself where it already lives
    there, else a copy made once per (tree, device) and cached, so each
    device's megakernel packs its own copy once."""
    if params["first"]["pw"].device == device:
        return params
    from repro_torch.kernels.megakernel import _TreeKey
    return _replicas(_TreeKey(params), device)


#: Weight copies by (param tree, device).
_replicas = BoundedCache(lambda key, device: tree_map(lambda t: t.detach().to(device), key.tree),
                         maxsize=16)


def _sharded_forward(params, patches: torch.Tensor, cfg: ESSRConfig, width: int, *,
                     devices: Tuple[torch.device, ...], backend: str = "cuda", quant=None,
                     fusion: str = "layer") -> torch.Tensor:
    """One subnet's patch batch, data-parallel over ``devices`` (the twin of
    the reference's ``sharded_forward``): padded to a multiple of the
    device count by repeating the last patch (duplicate work, never another
    subnet's patch), cut into contiguous chunks, each chunk through the
    resolved forward on its device with the weights copied there, gathered
    back onto the patches' device and sliced back to N. Each chunk runs with
    its card as the current device, since the wrappers launch onto the
    stream of the chunk's device and CUDA launches only onto the current
    device's streams. Every copy in goes before the first launch and every
    copy out after the last: a copy between cards waits on both cards'
    streams, so one interleaved with the launches would hold each chunk
    behind the one before. ``devices`` may name one device more than once;
    every kernel computes each patch on its own, so the result equals the
    unsplit forward's."""
    forward = resolve_forward(backend, quant, fusion)
    devices = tuple(_device(d) for d in devices)
    home = patches.device
    n, k = int(patches.shape[0]), len(devices)
    pad = (-n) % k
    if pad:
        patches = torch.cat([patches, patches[-1:].expand(pad, *patches.shape[1:])])
    chunk = patches.shape[0] // k

    def current(dev):
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    staged = []
    for i, dev in enumerate(devices):
        with current(dev):
            staged.append((_replica(params, dev), patches[i * chunk:(i + 1) * chunk].to(dev)))
    outs = []
    for dev, (weights, part) in zip(devices, staged):
        with current(dev):
            outs.append(forward(weights, part, cfg, width))
    out = torch.cat([o.to(home) for o in outs])
    return out[:n] if pad else out


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


def _host_scores(patches: torch.Tensor, backend: str) -> np.ndarray:
    """The patches' edge scores, copied to the host: the edge kernel on the
    "cuda" backend (its plain version on CPU tensors), the plain score on
    "ref"."""
    if backend == "cuda":
        from repro_torch.kernels.edge import edge_score_fused
        return edge_score_fused(patches).cpu().numpy()
    return edge_score(patches).cpu().numpy()


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
                       geometry: Optional[PatchGeometry] = None,
                       precomputed: Optional[Tuple[torch.Tensor, np.ndarray]] = None,
                       devices: Optional[Tuple[torch.device, ...]] = None) -> SRResult:
    """frame: (H,W,3) in [0,1] -> SRResult with the (H*s, W*s, 3) image.
    ``ids_override`` forces the routing and skips the edge scores (reported
    as zeros). ``quant``: a `QuantPack` for quantized serving.
    ``precomputed``: (patches, scores) of this frame from a caller that
    already extracted and scored it (the stream scores for its switcher).
    ``devices``: with more than one, every subnet's batch is split across
    them (:func:`_sharded_forward`, where the reference takes ``mesh=``);
    None or one device is the single-device path."""
    forward = resolve_forward(backend, quant, fusion)
    if devices is not None and len(devices) > 1:
        forward = functools.partial(_sharded_forward, devices=tuple(devices), backend=backend,
                                    quant=quant, fusion=fusion)
    s = cfg.scale
    h, w = int(frame.shape[0]), int(frame.shape[1])
    g = geometry if geometry is not None else get_geometry(
        h, w, patch, overlap, s, str(frame.device))
    if precomputed is not None:
        patches, scores = precomputed
        scores = np.asarray(scores)
    else:
        patches = g.extract(frame)
        scores = (_host_scores(patches, backend) if ids_override is None
                  else np.zeros(g.n, np.float32))
    ids = sp.decide(scores, t1, t2) if ids_override is None else np.asarray(ids_override)
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
                           geometry: Optional[PatchGeometry] = None,
                           devices: Optional[Tuple[torch.device, ...]] = None) -> SRResult:
    """Every patch through one subnet (the non-edge-selective reference);
    ``devices`` as in :func:`_edge_selective_sr`."""
    widths = cfg.subnet_widths()
    if width not in widths:
        raise ValueError(f"width {width} not one of the subnet widths {widths}")
    g = geometry if geometry is not None else get_geometry(
        int(frame.shape[0]), int(frame.shape[1]), patch, overlap, cfg.scale,
        str(frame.device))
    ids = np.full((g.n,), widths.index(width), dtype=np.int64)
    return _edge_selective_sr(params, frame, cfg, patch=patch, overlap=overlap,
                              ids_override=ids, buckets=buckets, backend=backend,
                              fusion=fusion, quant=quant, geometry=g, devices=devices)


def _sr_whole(params, frame: torch.Tensor, cfg: ESSRConfig,
              width: Optional[int] = None) -> torch.Tensor:
    """Whole-image convolution (the lossless reference), plain model."""
    return essr_forward(params, frame[None], cfg, width=width)[0]


# ---------------------------------------------------------------------------
# fused single dispatch (ExecutionPlan.dispatch = "fused")
# ---------------------------------------------------------------------------

def snap_capacity(n: int, buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                  n_total: Optional[int] = None) -> int:
    """Desired slot count -> capacity: 0 stays 0 (the subnet's lane is left
    out of the frame), otherwise the bucket ceiling, clamped to ``n_total``
    (an all-one-subnet frame runs the exact full batch, as host dispatch
    does)."""
    if n <= 0:
        return 0
    cap = _bucket(n, buckets)
    return min(cap, n_total) if n_total is not None else cap


def _decide(scores: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """(N,) scores -> (N,) int64 subnet ids on the scores' device. ``t1`` and
    ``t2`` are 0-d tensors of the scores' dtype, so the thresholds compare in
    the scores' precision, as the host `subnet_policy.decide` does."""
    return torch.where(scores >= t2, sp.C54, torch.where(scores >= t1, sp.C27, sp.BILINEAR))


def capacity_route(ids: torch.Tensor, caps: Tuple[int, ...]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routing into fixed per-subnet capacities, on the device with no host
    sync: (N,) subnet ids + per-subnet slot counts -> (effective ids, (K,)
    int32 spill counts).

    Priciest subnet first: the patches of subnet ``k`` past ``caps[k]`` in
    raster order are demoted to ``k - 1``, where they compete in raster
    order with that subnet's own patches. Subnet 0 (bilinear) is the dense
    floor and never spills; ``caps[0]`` is ignored. ``spills[k]`` counts the
    patches that wanted ``k`` (natively or by spilling in) and ran ``k - 1``."""
    spills = [torch.zeros((), dtype=torch.int32, device=ids.device)]
    eff = ids
    for k in range(len(caps) - 1, 0, -1):
        member = eff == k
        pos = torch.cumsum(member.to(torch.int32), 0) - 1
        over = member & (pos >= caps[k])
        spills.append(over.sum().to(torch.int32))
        eff = torch.where(over, k - 1, eff)
    spills = spills[:1] + spills[1:][::-1]       # ascending subnet order
    return eff, torch.stack(spills)


def capacity_dispatch(patches: torch.Tensor, eff_ids: torch.Tensor, subnet: int,
                      cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Subnet ``subnet``'s patches into ``cap`` fixed slots, raster order.
    Returns (slot batch (cap, p, p, C), each patch's slot with ``cap`` as the
    non-members' dustbin, membership mask). Slots past the members hold
    zeros. Route ``eff_ids`` through :func:`capacity_route` first, so every
    member's rank is below ``cap``.

    A gather, not a scatter: slot j takes the patch where the members'
    running count first reaches j + 1 (``searchsorted``; N, a zero row,
    where there is none), so every slot is written once, in a fixed order."""
    member = eff_ids == subnet
    count = torch.cumsum(member.to(torch.int64), 0)
    slot = torch.where(member, count - 1, cap)
    want = torch.arange(1, cap + 1, dtype=torch.int64, device=patches.device)
    src = torch.searchsorted(count, want)
    padded = torch.cat([patches, patches.new_zeros((1,) + tuple(patches.shape[1:]))])
    return padded.index_select(0, src), slot, member


def capacity_combine(out_patches: torch.Tensor, sr_slots: torch.Tensor,
                     slot: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """One subnet's slot outputs back over the patch axis: patch n takes
    ``sr_slots[slot[n]]`` where it is a member, and keeps ``out_patches[n]``
    elsewhere (the dustbin row reads zeros and is masked off)."""
    cap = sr_slots.shape[0]
    y = torch.cat([sr_slots, sr_slots.new_zeros((1,) + tuple(sr_slots.shape[1:]))])
    taken = y.index_select(0, slot.clamp(max=cap))
    return torch.where(member[:, None, None, None], taken, out_patches)


def _fused_setup(geometry: PatchGeometry, caps: Tuple[int, ...], cfg: ESSRConfig,
                 backend: str, quant, fusion: str, on_poison: str):
    """Checks shared by the fused frame and the fused tick; returns (the
    per-subnet forward, the edge score)."""
    if on_poison not in HEALTH_POLICIES:
        raise ValueError(f"unknown on_poison {on_poison!r}; choose from {HEALTH_POLICIES}")
    widths = cfg.subnet_widths()
    if len(caps) != len(widths):
        raise ValueError(f"capacity profile {caps} must have one entry per "
                         f"subnet width {widths}")
    forward = resolve_forward(backend, quant, fusion)
    if backend == "cuda":
        from repro_torch.kernels.edge import edge_score_fused as score
    else:
        score = edge_score
    return forward, score


def _conv_lanes(params, patches: torch.Tensor, eff: torch.Tensor, caps: Tuple[int, ...],
                cfg: ESSRConfig, forward) -> torch.Tensor:
    """Bilinear for every patch (the dense floor), then per conv subnet with
    a non-zero capacity: dispatch into its slots, forward, combine."""
    widths = cfg.subnet_widths()
    out = bilinear_resize(patches, cfg.scale)
    for k in range(1, len(widths)):
        if caps[k] == 0:
            continue
        disp, slot, member = capacity_dispatch(patches, eff, k, caps[k])
        out = capacity_combine(out, forward(params, disp, cfg, widths[k]), slot, member)
    return out


def _fused_run(params, geometry: PatchGeometry, caps: Tuple[int, ...], cfg: ESSRConfig,
               backend: str, quant, fusion: str, on_poison: str):
    """The fused frame as one function of (frame, t1, t2) -> (image, eff_ids,
    scores, counts, spills, health), every output on the frame's device and
    nothing copied to the host (the reference's ``fused_frame_fn`` ``run``):

    1. the (nan, inf, oob) health verdict of the raw frame and the
       ``on_poison`` policy, branch-free (zeros under "off");
    2. extract, then the edge score (the edge kernel on "cuda");
    3. decide and :func:`capacity_route`;
    4. bilinear for every patch, the dense floor;
    5. per conv subnet with a non-zero capacity: dispatch, forward, combine;
    6. ``fuse_average``, into ``out`` when given (a graph's image buffer)."""
    forward, score = _fused_setup(geometry, caps, cfg, backend, quant, fusion, on_poison)
    widths = cfg.subnet_widths()

    def run(frame: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor, out=None):
        if on_poison == "off":
            health = torch.zeros((3,), dtype=torch.int32, device=frame.device)
        else:
            health = _health_counts(frame)
            if on_poison in ("sanitize", "bilinear"):
                frame = _sanitize(frame)
        patches = geometry.extract(frame)
        scores = score(patches)
        eff, spills = capacity_route(_decide(scores, t1, t2), caps)
        if on_poison == "bilinear":
            # a poisoned frame serves every patch from the bilinear floor;
            # the conv lanes still run on their now empty slots
            eff = torch.where((health > 0).any(), torch.zeros_like(eff), eff)
        sr = _conv_lanes(params, patches, eff, caps, cfg, forward)
        counts = torch.stack([(eff == k).sum() for k in range(len(widths))]).to(torch.int32)
        return geometry.fuse_average(sr, out=out), eff, scores, counts, spills, health

    return run


def _fused_stream_run(params, geometry: PatchGeometry, streams: int, caps: Tuple[int, ...],
                      cfg: ESSRConfig, backend: str, quant, fusion: str, on_poison: str):
    """The multi-tenant admission tick as one function (the reference's
    ``fused_stream_frame_fn`` ``run``): ``streams`` same-geometry frames
    (S, H, W, C), per-stream thresholds ``t1s``/``t2s`` (S,) and C54 quotas
    (S,) -> (images (S, sH, sW, C), eff_ids (S*N,), scores (S*N,), counts
    (S, K), spills (S, K), health (S, 3)), all on the frames' device.

    The patch axis is stream-major (stream ``i // N``, patch ``i % N``), so
    the capacity cascade runs on the shared pool of slots unchanged, and
    each stream's frame is fused on its own. Each stream's top-subnet (C54)
    patches past its quota are demoted to the next subnet in raster order
    before the cascade, so an overload degrades by share, and no frame is
    dropped. ``spills[s, k]`` counts stream s's patches that wanted ``k``
    or more (before the quota) and ran below ``k``: quota demotions and the
    cascade land in one hop ledger. Under "bilinear" only the poisoned
    streams drop to the dense floor."""
    forward, score = _fused_setup(geometry, caps, cfg, backend, quant, fusion, on_poison)
    if streams < 1:
        raise ValueError(f"streams must be >= 1, got {streams}")
    widths = cfg.subnet_widths()
    top, n = len(widths) - 1, geometry.n
    (h, w), (hp, wp), s = geometry.hw, geometry.padded_hw, cfg.scale

    def run(frames: torch.Tensor, t1s: torch.Tensor, t2s: torch.Tensor,
            quotas: torch.Tensor, out=None):
        if on_poison == "off":
            health = torch.zeros((streams, 3), dtype=torch.int32, device=frames.device)
        else:
            health = torch.stack([_health_counts(frames[i]) for i in range(streams)])
            if on_poison in ("sanitize", "bilinear"):
                frames = _sanitize(frames)
        flat = torch.cat([geometry.extract(frames[i]) for i in range(streams)])
        scores = score(flat)
        want2 = _decide(scores, t1s.repeat_interleave(n), t2s.repeat_interleave(n)
                        ).reshape(streams, n)
        routed2 = want2
        if top > 0:
            member = want2 == top
            pos = torch.cumsum(member.to(torch.int64), 1) - 1
            over = member & (pos >= quotas[:, None])
            routed2 = torch.where(over, top - 1, want2)
        if on_poison == "bilinear":
            poisoned = (health > 0).any(1)
            routed2 = torch.where(poisoned[:, None], torch.zeros_like(routed2), routed2)
        eff, _ = capacity_route(routed2.reshape(-1), caps)
        sr = _conv_lanes(params, flat, eff, caps, cfg, forward)
        buf = out if out is not None else torch.empty(
            (streams, hp * s, wp * s, flat.shape[-1]), dtype=sr.dtype, device=sr.device)
        for i in range(streams):
            geometry.fuse_average(sr[i * n:(i + 1) * n], out=buf[i])
        eff2 = eff.reshape(streams, n)
        counts = torch.stack([(eff2 == k).sum(1) for k in range(len(widths))], 1)
        spills = torch.stack([torch.zeros_like(counts[:, 0])] +
                             [((want2 >= k) & (eff2 < k)).sum(1) for k in range(1, len(widths))],
                             1)
        return (buf[:, :h * s, :w * s], eff, scores, counts.to(torch.int32),
                spills.to(torch.int32), health)

    return run


def _frame_tick(run):
    """A frame's run as a tick of one stream, so frames and ticks share the
    graph machinery: frames (1, H, W, C), t1s, t2s and quotas (1,) -> the
    tick's six outputs. The quota is unused: a frame's C54 ceiling is its
    capacity profile."""
    def tick(frames, t1s, t2s, quotas, out=None):
        image, eff, scores, counts, spills, health = run(
            frames[0], t1s[0], t2s[0], out=None if out is None else out[0])
        return image[None], eff, scores, counts[None], spills[None], health[None]

    return tick


@dataclasses.dataclass
class _InFlight:
    """One launched fused tick (a frame is a tick of one stream): its own
    copies of the images (S, sH, sW, C), ids and scores (a later replay
    overwrites the graph's outputs), the host buffer its counts, spills and
    health land in, and the event its copies end on."""
    image: torch.Tensor
    ids: torch.Tensor
    scores: torch.Tensor
    telemetry: torch.Tensor          # int32 (counts, spills, health), host memory
    done: Optional[torch.cuda.Event]
    keep: Any                        # what the queued copies still read

    def wait(self):
        """Block on this launch's event alone; (counts, spills, health),
        each a tuple with one tuple of ints per stream."""
        if self.done is not None:
            self.done.synchronize()
        v = [int(x) for x in self.telemetry.tolist()]
        s = self.image.shape[0]
        k = (len(v) - 3 * s) // (2 * s)

        def rows(a, width):
            return tuple(tuple(a[i * width:(i + 1) * width]) for i in range(s))

        return rows(v[:s * k], k), rows(v[s * k:2 * s * k], k), rows(v[2 * s * k:], 3)


#: One graph memory pool per CUDA device, shared by every fused frame and
#: tick captured there: device index -> (pool handle, the live fused frames
#: captured into it). Safe because replays run one at a time on one stream,
#: each replay's outputs are copied out before the next, and the graphs'
#: inputs and images live outside the pool: what one capture frees, the next
#: reuses, so the reserved memory follows the largest graph, not the number
#: of graphs. A pool is shared only while a graph captured into it lives:
#: PyTorch refuses to share a pool whose graphs are gone while a block of it
#: is still held (a library workspace first allocated during a capture).
_GRAPH_POOLS: Dict[int, Tuple[Any, "weakref.WeakSet"]] = {}

#: The frame and image buffers the fused graphs read and write, outside the
#: pool, one per (role, shape, device): graphs of one frame shape share them
#: (their replays are ordered, each frame is copied in right before its
#: replay and each image cloned out right after).
_static_buffers = BoundedCache(
    lambda role, shape, device: torch.zeros(shape, dtype=torch.float32, device=device),
    maxsize=16)


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _graph_pool(device: torch.device):
    """The device's shared pool, or a fresh one when no graph of it lives."""
    index = _device_index(device)
    if index not in _GRAPH_POOLS or not _GRAPH_POOLS[index][1]:
        _GRAPH_POOLS[index] = (torch.cuda.graph_pool_handle(), weakref.WeakSet())
    return _GRAPH_POOLS[index]


def _retire_pool(device: torch.device, pool) -> None:
    """After a failed capture: end the allocator's recording into ``pool``
    (PyTorch's capture_end can raise before it does, and a pool left
    recording refuses every later capture) and give the device a fresh pool;
    the old one lives on with the graphs captured into it."""
    index = _device_index(device)
    try:
        torch._C._cuda_endAllocateToPool(index, pool)
    except RuntimeError as e:
        if "not currently recording" not in str(e):
            raise                          # only "capture_end had ended it" is expected
    if index in _GRAPH_POOLS and _GRAPH_POOLS[index][0] == pool:
        del _GRAPH_POOLS[index]


class _FusedFrame:
    """The fused tick of ``streams`` frames of one (weights, geometry,
    capacity profile, backend, quant, fusion, on_poison, device); a single
    frame is a tick of one stream (`_frame_tick`). On a CUDA device it is
    captured once as a CUDA graph into the device's shared pool: a warm-up
    run on a side stream first pays every lazy first use (kernel builds,
    occupancy queries, packed and prepared weights, index maps), then the
    capture. A launch then costs a copy into the graph's frames, the
    thresholds and quotas copied from pinned host memory into theirs (a
    threshold change never recaptures, and nothing waits for the device)
    and one replay. A capture that fails raises; nothing runs eagerly in its
    place (the engine's degradation ladder may then step down, for an
    injected fault). On the CPU the function runs eagerly.

    A replay calls no kernel wrapper, so the wrappers' launch counts move by
    the deltas recorded at capture (``launches``), once a replay.
    ``pool_bytes`` is the device memory the capture added to the shared
    pool (the first graph of a pool pays for the rest); dropping the object
    frees the graph and returns its blocks to the pool."""

    def __init__(self, run, streams: int, shape: Tuple[int, ...], out_shape: Tuple[int, ...],
                 device: torch.device):
        self.run = run
        self.streams = streams
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self.pool_bytes = 0
        if device.type == "cuda":
            self._capture(shape, out_shape, device)

    def _capture(self, shape, out_shape, device) -> None:
        from repro_torch.kernels.ops import KERNELS
        s = (self.streams,)
        self._thresholds = torch.zeros((2,) + s, dtype=torch.float32, device=device)
        self._quotas = torch.zeros(s, dtype=torch.int64, device=device)
        self.inputs = (_static_buffers("frame", s + tuple(shape), str(device)),
                       self._thresholds[0], self._thresholds[1], self._quotas)
        self.image = _static_buffers("image", s + tuple(out_shape), str(device))
        here = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            self.run(*self.inputs, out=self.image)
        here.wait_stream(side)
        before = {k: fn.launches for k, fn in KERNELS.items()}
        graph = torch.cuda.CUDAGraph()
        pool, members = _graph_pool(device)
        try:
            with torch.cuda.graph(graph, pool=pool):
                # entering synchronizes and empties the allocator's cache,
                # so the pool grows by what the capture reserves from here
                reserved = torch.cuda.memory_reserved(device)
                outs = self.run(*self.inputs, out=self.image)
                telemetry = torch.cat([o.to(torch.int32).reshape(-1) for o in outs[3:]])
        except BaseException:
            _retire_pool(device, pool)
            raise
        finally:
            delta = {k: fn.launches - before[k] for k, fn in KERNELS.items()}
            for k, fn in KERNELS.items():
                fn.launches = before[k]          # the capture launched nothing
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.launches = {k: v for k, v in delta.items() if v}
        self.outs, self.telemetry = outs[:3], telemetry
        self.graph = graph
        members.add(self)

    def launch(self, frames: torch.Tensor, t1s, t2s, quotas) -> _InFlight:
        """Enqueue one tick: ``frames`` (S, H, W, C) float32 on the device or
        in pinned host memory, per-stream thresholds and quotas as sequences
        of S numbers; returns without waiting for the device."""
        if self.graph is None:
            dev = frames.device
            outs = self.run(frames, torch.tensor(t1s, dtype=torch.float32, device=dev),
                            torch.tensor(t2s, dtype=torch.float32, device=dev),
                            torch.tensor(quotas, dtype=torch.int64, device=dev))
            return _InFlight(*outs[:3], torch.cat([o.to(torch.int32).reshape(-1)
                                                   for o in outs[3:]]), None, None)
        from repro_torch.kernels.ops import KERNELS
        # pinned sources, so the copies queue behind the previous replay
        # instead of waiting for it
        thresholds = torch.tensor([list(t1s), list(t2s)], dtype=torch.float32).pin_memory()
        quota = torch.tensor(list(quotas), dtype=torch.int64).pin_memory()
        self.inputs[0].copy_(frames, non_blocking=True)
        self._thresholds.copy_(thresholds, non_blocking=True)
        self._quotas.copy_(quota, non_blocking=True)
        self.graph.replay()
        for k, v in self.launches.items():
            KERNELS[k].launches += v
        telemetry = torch.empty(self.telemetry.shape, dtype=torch.int32, pin_memory=True)
        telemetry.copy_(self.telemetry, non_blocking=True)
        image, ids, scores = (o.clone() for o in self.outs)
        done = torch.cuda.Event()
        done.record()
        return _InFlight(image, ids, scores, telemetry, done,
                         (frames, thresholds, quota, self))


def _out_shape(geometry: PatchGeometry, cfg: ESSRConfig) -> Tuple[int, int, int]:
    hp, wp = geometry.padded_hw
    return (hp * cfg.scale, wp * cfg.scale, cfg.in_channels)


def _build_fused_frame(weights, geometry: PatchGeometry, caps: Tuple[int, ...],
                       cfg: ESSRConfig, backend: str, quant, fusion: str, on_poison: str,
                       device: str) -> _FusedFrame:
    run = _fused_run(weights.tree, geometry, caps, cfg, backend, quant, fusion, on_poison)
    return _FusedFrame(_frame_tick(run), 1, tuple(geometry.hw) + (cfg.in_channels,),
                       _out_shape(geometry, cfg), torch.device(device))


def _build_fused_tick(weights, geometry: PatchGeometry, streams: int, caps: Tuple[int, ...],
                      cfg: ESSRConfig, backend: str, quant, fusion: str, on_poison: str,
                      device: str) -> _FusedFrame:
    run = _fused_stream_run(weights.tree, geometry, streams, caps, cfg, backend, quant, fusion,
                            on_poison)
    return _FusedFrame(run, streams, tuple(geometry.hw) + (cfg.in_channels,),
                       _out_shape(geometry, cfg), torch.device(device))


#: The fused frames, one per (weights, geometry, capacity profile, backend,
#: quant, fusion, on_poison, device). ``weights`` is the param tree's
#: `_TreeKey`: a graph reads the weights at the addresses it was captured
#: with. Sized with get_geometry's cache (an evicted geometry re-keys its
#: frames); `configure_compiled_caches` resizes both. Eviction drops the
#: frame and its graph, whose blocks go back to the shared pool.
_fused_frame_fn = BoundedCache(_build_fused_frame, maxsize=128)

#: The fused ticks of multi-tenant serving, one per (weights, geometry, live
#: stream count, capacity profile, backend, quant, fusion, on_poison,
#: device), in the same pool.
_fused_stream_fn = BoundedCache(_build_fused_tick, maxsize=128)


def _fused_frame_forward(params, frame: torch.Tensor, cfg: ESSRConfig, *,
                         geometry: PatchGeometry, caps: Tuple[int, ...],
                         t1: float = sp.DEFAULT_T1, t2: float = sp.DEFAULT_T2,
                         backend: str = "cuda", quant=None, fusion: str = "layer",
                         on_poison: str = "raise"):
    """One frame through the fused frame of its key, waited for. Returns the
    six-tuple (image, eff_ids, scores on the frame's device; counts, spills,
    health as int32 host tensors); the engine owns the capacity profile and
    the ``on_poison`` policy's host side."""
    from repro_torch.kernels.megakernel import _TreeKey
    fn = _fused_frame_fn(_TreeKey(params), geometry, tuple(int(c) for c in caps), cfg,
                         backend, quant, fusion, on_poison, str(frame.device))
    flight = fn.launch(frame[None], (t1,), (t2,), (0,))
    counts, spills, health = (rows[0] for rows in flight.wait())
    return (flight.image[0], flight.ids, flight.scores, torch.tensor(counts, dtype=torch.int32),
            torch.tensor(spills, dtype=torch.int32), torch.tensor(health, dtype=torch.int32))


# ---------------------------------------------------------------------------
# bounded compiled-object caches (runtime-sized, occupancy-observable)
# ---------------------------------------------------------------------------

#: The process-wide caches of per-frame objects: the fused frames and ticks
#: (captured graphs on the card) and the patch geometries they are keyed on,
#: under the reference's names.
COMPILED_CACHES = {"fused_frame_fn": _fused_frame_fn, "fused_stream_frame_fn": _fused_stream_fn,
                   "get_geometry": get_geometry}


def configure_compiled_caches(maxsize: int) -> None:
    """Resize every compiled-object cache to ``maxsize`` entries (LRU;
    shrinking evicts at once). `SREngine` sets the bound from
    ``plan.stats_window`` at construction."""
    for cache in COMPILED_CACHES.values():
        cache.resize(maxsize)


def compiled_cache_occupancy() -> Dict[str, Dict[str, int]]:
    """{cache: {size, maxsize, hits, misses, evictions}}: evictions under a
    steady set of geometries mean the bound is too small and frames are
    being captured again."""
    return {name: cache.occupancy() for name, cache in COMPILED_CACHES.items()}
