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
        s, ps = self.scale, self.patch * self.scale
        n_y, n_x = len(self.ys), len(self.xs)
        hp, wp = self.padded_hw
        c = sr.shape[-1]
        t = sr.reshape(n_y, n_x, ps, ps, c).permute(0, 2, 1, 3, 4)
        t = t.reshape(n_y * ps, n_x, ps, c)
        t = t * self.wy[:, None, None, None] * self.wx.reshape(n_x, ps)[None, :, :, None]
        acc = torch.zeros((hp * s, n_x, ps, c), dtype=sr.dtype, device=sr.device)
        for i, y0 in enumerate(self.ys):
            acc[y0 * s:y0 * s + ps] += t[i * ps:(i + 1) * ps]
        acc = acc.reshape(hp * s, n_x * ps, c)
        if out is None:
            out = torch.zeros((hp * s, wp * s, c), dtype=sr.dtype, device=sr.device)
        else:
            out.zero_()
        for j, x0 in enumerate(self.xs):
            out[:, x0 * s:x0 * s + ps] += acc[:, j * ps:(j + 1) * ps]
        h, w = self.hw
        return out[:h * s, :w * s]


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
    ps = patch * scale
    y_cnt = _axis_cnt(ys, patch, scale, hp)
    x_cnt = _axis_cnt(xs, patch, scale, wp)
    # reciprocal first, then gather: the reference's take(1/cnt, idx)
    wy = np.concatenate([(np.float32(1.0) / y_cnt)[y0 * scale:y0 * scale + ps] for y0 in ys])
    wx = np.concatenate([(np.float32(1.0) / x_cnt)[x0 * scale:x0 * scale + ps] for x0 in xs])
    dev = torch.device(device)
    return PatchGeometry(
        hw=(h, w), padded_hw=(hp, wp), patch=patch, overlap=overlap, scale=scale,
        pos=pos, ys=tuple(int(y) for y in ys), xs=tuple(int(x) for x in xs),
        gather_idx=torch.from_numpy(gather).to(dev),
        wy=torch.from_numpy(wy).to(dev), wx=torch.from_numpy(wx).to(dev))
