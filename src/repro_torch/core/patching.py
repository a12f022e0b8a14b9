"""Slim-overlap patch extraction and overlap-average fusion (twin of
``repro.core.patching``).

LR patches overlap by ``overlap`` px; after upsampling the SR patches
overlap by ``overlap * scale`` px and overlapped pixels are averaged. All
index maps of one (H, W, patch, overlap, scale, device) tiling are built
once and cached (:func:`get_geometry`).

Fusion is deterministic: the patch grid is a cartesian product ``ys x xs``,
so overlap-add folds along y, then along x, as ordered slice adds (a pixel
takes up to 3 patches per axis, when the last start is clamped right after
the previous one). ``index_add_`` is not used: on CUDA it is atomic and sums
in no fixed order.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.caching import bounded_cache


def grid_starts(size: int, patch: int, overlap: int) -> np.ndarray:
    """1-D tiling starts with ``overlap`` px shared between neighbours; the
    final patch is clamped to end at the image edge."""
    if size <= patch:
        return np.array([0], dtype=np.int64)
    starts = list(range(0, size - patch, patch - overlap))
    starts.append(size - patch)
    return np.array(sorted(set(starts)), dtype=np.int64)


def shard_slices(n: int, shards: int) -> Tuple[slice, ...]:
    """Partition ``n`` raster-order patches into ``shards`` contiguous
    slices, balanced as ``np.array_split`` is: the first ``n % shards`` take
    one patch more. ``shards > n`` leaves empty trailing slices (a shard
    with no patches this frame; its switcher sees no scores)."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    base, extra = divmod(n, shards)
    out, start = [], 0
    for k in range(shards):
        stop = start + base + (1 if k < extra else 0)
        out.append(slice(start, stop))
        start = stop
    return tuple(out)


def _reflect_pad_hw(img: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Reflect-pad the bottom/right of (H,W,C) ``img``; edge-pad what a
    dimension too short to reflect cannot cover (as the reference does)."""
    h, w = int(img.shape[0]), int(img.shape[1])
    rh, rw = min(pad_h, max(h - 1, 0)), min(pad_w, max(w - 1, 0))
    x = img.permute(2, 0, 1)[None]
    if rh or rw:
        x = F.pad(x, (0, rw, 0, rh), mode="reflect")
    eh, ew = pad_h - rh, pad_w - rw
    if eh or ew:
        x = F.pad(x, (0, ew, 0, eh), mode="replicate")
    return x[0].permute(1, 2, 0)


def _axis_cnt(starts: np.ndarray, patch: int, scale: int, plane: int) -> np.ndarray:
    """Per-output-pixel coverage multiplicity along one axis (>= 1)."""
    cnt = np.zeros(plane * scale, np.float32)
    for s0 in starts:
        cnt[s0 * scale:(s0 + patch) * scale] += 1.0
    return np.maximum(cnt, 1.0)


@dataclasses.dataclass(frozen=True, eq=False)     # identity eq: fields hold tensors
class PatchGeometry:
    """Index maps for one tiling, on one device. ``pos`` is in (possibly
    padded) LR coordinates; ``padded_hw > hw`` only for frames smaller than
    a patch, whose fused output is cropped back to ``hw * scale``."""
    hw: Tuple[int, int]
    padded_hw: Tuple[int, int]
    patch: int
    overlap: int
    scale: int
    pos: np.ndarray                # (N, 2) LR (y, x) patch starts, raster order
    ys: Tuple[int, ...]            # grid row starts (LR)
    xs: Tuple[int, ...]            # grid column starts (LR)
    gather_idx: torch.Tensor       # (N*p*p,) linear indices into the LR plane
    wy: torch.Tensor               # (n_y*ps,) reciprocal row coverage per patch row
    wx: torch.Tensor               # (n_x*ps,) reciprocal column coverage per patch col

    @property
    def n(self) -> int:
        return len(self.pos)

    @property
    def cache_key(self) -> Tuple[Tuple[int, int], int, int, int]:
        """The tiling's identity, device aside: (hw, patch, overlap, scale)."""
        return (self.hw, self.patch, self.overlap, self.scale)

    def shard_slices(self, shards: int) -> Tuple[slice, ...]:
        """Contiguous raster strips of this tiling's patches: the unit of
        per-shard routing and straggler control (`core.adaptive`)."""
        return shard_slices(self.n, shards)

    def extract(self, img: torch.Tensor) -> torch.Tensor:
        """(H,W,C) -> (N,patch,patch,C): one gather."""
        h, w = self.hw
        hp, wp = self.padded_hw
        if (hp, wp) != (h, w):
            img = _reflect_pad_hw(img, hp - h, wp - w)
        flat = img.reshape(hp * wp, img.shape[-1])
        p = self.patch
        return flat.index_select(0, self.gather_idx).reshape(self.n, p, p, -1)

    def fuse_average(self, sr: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
        """(N, p*s, p*s, C) -> (H*s, W*s, C): overlap-and-average.

        The averaging weights are pre-applied per patch row and column (the
        per-pixel count is the outer product of the axis counts), then the
        rows and columns are folded with ordered slice adds. ``out``: a
        (padded H*s, padded W*s, C) buffer to fold into (zeroed first; the
        result is a view of it), for a captured graph whose image lives
        outside its memory pool."""
        h, w = self.hw
        s = self.scale
        return _fold(sr, self.ys, self.xs, self.wy, self.wx, s, self.padded_hw, out)[:h * s, :w * s]


def _fold(sr: torch.Tensor, ys, xs, wy: torch.Tensor, wx: torch.Tensor, scale: int,
          plane_hw: Tuple[int, int], out: torch.Tensor = None) -> torch.Tensor:
    """Separable overlap-add of a cartesian grid's patches, weighted by the
    reciprocal axis coverage ``wy`` / ``wx``, into a zeroed (plane * scale)
    image (``out`` if given)."""
    s = scale
    ps = int(sr.shape[1])
    n_y, n_x = len(ys), len(xs)
    hp, wp = plane_hw
    c = sr.shape[-1]
    t = sr.reshape(n_y, n_x, ps, ps, c).permute(0, 2, 1, 3, 4)
    t = t.reshape(n_y * ps, n_x, ps, c)
    t = t * wy[:, None, None, None] * wx.reshape(n_x, ps)[None, :, :, None]
    acc = torch.zeros((hp * s, n_x, ps, c), dtype=sr.dtype, device=sr.device)
    for i, y0 in enumerate(ys):
        acc[y0 * s:y0 * s + ps] += t[i * ps:(i + 1) * ps]
    acc = acc.reshape(hp * s, n_x * ps, c)
    if out is None:
        out = torch.zeros((hp * s, wp * s, c), dtype=sr.dtype, device=sr.device)
    else:
        out.zero_()
    for j, x0 in enumerate(xs):
        out[:, x0 * s:x0 * s + ps] += acc[:, j * ps:(j + 1) * ps]
    return out


def _axis_weights(starts, patch: int, scale: int, plane: int) -> np.ndarray:
    """(len(starts) * patch * scale,) reciprocal coverage of each patch row
    (or column): the reciprocal first, then gathered, as the reference's
    ``take(1 / cnt, idx)``."""
    inv = np.float32(1.0) / _axis_cnt(starts, patch, scale, plane)
    ps = patch * scale
    return np.concatenate([inv[s0 * scale:s0 * scale + ps] for s0 in starts])


@bounded_cache(maxsize=128)
def get_geometry(h: int, w: int, patch: int = 32, overlap: int = 2,
                 scale: int = 4, device: str = "cuda") -> PatchGeometry:
    """The cached geometry of one frame shape on one device."""
    hp, wp = max(h, patch), max(w, patch)
    ys, xs = grid_starts(hp, patch, overlap), grid_starts(wp, patch, overlap)
    pos = np.array([(y, x) for y in ys for x in xs], dtype=np.int64)
    pos.setflags(write=False)
    ar = np.arange(patch)
    rows = pos[:, 0][:, None] + ar
    cols = pos[:, 1][:, None] + ar
    gather = (rows[:, :, None] * wp + cols[:, None, :]).reshape(-1)
    wy = _axis_weights(ys, patch, scale, hp)
    wx = _axis_weights(xs, patch, scale, wp)
    dev = torch.device(device)
    return PatchGeometry(
        hw=(h, w), padded_hw=(hp, wp), patch=patch, overlap=overlap, scale=scale,
        pos=pos, ys=tuple(int(y) for y in ys), xs=tuple(int(x) for x in xs),
        gather_idx=torch.from_numpy(gather).to(dev),
        wy=torch.from_numpy(wy).to(dev), wx=torch.from_numpy(wx).to(dev))


def extract_patches(img: torch.Tensor, patch: int = 32, overlap: int = 2
                    ) -> Tuple[torch.Tensor, np.ndarray]:
    """(H,W,C) -> ((N,patch,patch,C), positions (N,2) int64): one gather
    over the cached geometry's map, on ``img``'s device."""
    geom = get_geometry(int(img.shape[0]), int(img.shape[1]), patch, overlap, 1,
                        str(img.device))
    return geom.extract(img), geom.pos


def _is_cartesian(pos: np.ndarray) -> bool:
    """True when ``pos`` is the row-major cartesian product of its unique
    y and x starts (every `grid_starts` tiling is)."""
    ys, xs = np.unique(pos[:, 0]), np.unique(pos[:, 1])
    if len(ys) * len(xs) != len(pos):
        return False
    grid = np.array([(y, x) for y in ys for x in xs], dtype=pos.dtype)
    return bool(np.array_equal(pos, grid))


def _overlap_add(sr: torch.Tensor, pos: np.ndarray, scale: int,
                 plane_hw: Tuple[int, int]) -> torch.Tensor:
    """Each patch added into a zeroed (H, W, C) plane at its scaled start,
    in patch order."""
    ph = int(sr.shape[1])
    out = torch.zeros((plane_hw[0], plane_hw[1], sr.shape[-1]), dtype=sr.dtype,
                      device=sr.device)
    for i, (y, x) in enumerate(pos):
        yy, xx = int(y) * scale, int(x) * scale
        out[yy:yy + ph, xx:xx + ph] += sr[i]
    return out


def fuse_patches_average(sr_patches: torch.Tensor, pos_lr: np.ndarray, scale: int,
                         out_hw: Tuple[int, int]) -> torch.Tensor:
    """Overlap-and-average of SR patches (N, p*s, p*s, C) at LR starts
    ``pos_lr`` into (out_h, out_w, C). A cartesian grid folds separably, as
    `PatchGeometry.fuse_average` does; any other position list adds patch by
    patch in order and divides by the coverage (at least 1)."""
    pos = np.asarray(pos_lr, dtype=np.int64)
    ph = int(sr_patches.shape[1])
    patch = ph // scale
    # the LR plane holds every patch; it exceeds out_hw only for frames
    # reflect-padded up to a patch (cropped below)
    plane_h = max(-(-out_hw[0] // scale), int(pos[:, 0].max()) + patch)
    plane_w = max(-(-out_hw[1] // scale), int(pos[:, 1].max()) + patch)
    if _is_cartesian(pos):
        ys, xs = np.unique(pos[:, 0]), np.unique(pos[:, 1])
        dev = sr_patches.device
        wy = torch.from_numpy(_axis_weights(ys, patch, scale, plane_h)).to(dev)
        wx = torch.from_numpy(_axis_weights(xs, patch, scale, plane_w)).to(dev)
        out = _fold(sr_patches, [int(y) for y in ys], [int(x) for x in xs], wy, wx, scale,
                    (plane_h, plane_w))
        return out[:out_hw[0], :out_hw[1]]
    plane = (plane_h * scale, plane_w * scale)
    cnt = _overlap_add(torch.ones_like(sr_patches[..., :1]), pos, scale, plane)
    out = _overlap_add(sr_patches, pos, scale, plane) / cnt.clamp_(min=1.0)
    return out[:out_hw[0], :out_hw[1]]


def fuse_patches_crop(sr_patches: torch.Tensor, pos_lr: np.ndarray, scale: int,
                      out_hw: Tuple[int, int]) -> torch.Tensor:
    """Naive fusion: each patch overwrites what earlier ones wrote there
    (Table III's zero-cost floor). A loop, since last-write-wins is the
    contract."""
    ph = int(sr_patches.shape[1])
    out = torch.zeros((out_hw[0], out_hw[1], sr_patches.shape[-1]), dtype=sr_patches.dtype,
                      device=sr_patches.device)
    for i, (y, x) in enumerate(pos_lr):
        yy, xx = int(y) * scale, int(x) * scale
        out[yy:yy + ph, xx:xx + ph] = sr_patches[i]
    return out


# ---------------------------------------------------------------------------
# loop oracles (the reference's seed implementations): tests only
# ---------------------------------------------------------------------------

def extract_patches_loop(img: torch.Tensor, patch: int = 32, overlap: int = 2
                         ) -> Tuple[torch.Tensor, np.ndarray]:
    """One slice per patch."""
    h, w = int(img.shape[0]), int(img.shape[1])
    ys, xs = grid_starts(h, patch, overlap), grid_starts(w, patch, overlap)
    pos = np.array([(y, x) for y in ys for x in xs], dtype=np.int64)
    return torch.stack([img[y:y + patch, x:x + patch] for y, x in pos]), pos


def fuse_patches_average_loop(sr_patches: torch.Tensor, pos_lr: np.ndarray, scale: int,
                              out_hw: Tuple[int, int]) -> torch.Tensor:
    """Patch by patch: add each patch and a patch of ones, then divide."""
    out = _overlap_add(sr_patches, pos_lr, scale, out_hw)
    ones = torch.ones_like(sr_patches[..., :1])
    return out / _overlap_add(ones, pos_lr, scale, out_hw)


# ---------------------------------------------------------------------------
# cost accounting for the boundary benchmark (Tables III / IV)
# ---------------------------------------------------------------------------

def overlap_mac_overhead(patch: int, overlap: int) -> float:
    """MAC multiplier of slim-overlap tiling against no overlap (Table IV)."""
    stride = patch - overlap
    return (patch / stride) ** 2


def boundary_sram_bytes(lr_w: int, overlap_lr: int, channels: int,
                        bytes_per: float = 1.25) -> float:
    """Boundary buffer estimate: one stripe of halo rows across the LR
    frame's width and the feature channels, top and left (FXP10: 1.25 B)."""
    return lr_w * max(overlap_lr, 1) * channels * bytes_per * 2
