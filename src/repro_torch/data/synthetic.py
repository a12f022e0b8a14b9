"""Procedural stand-in dataset, in PyTorch (twin of
``repro.data.synthetic``: the images, their bicubic degradation, the
evaluation set and the training patch stream).

Images mix the three content classes the edge-selective router tells apart
(plain gradients, band-limited textures, strokes), HR in [0,1] RGB, drawn
with numpy's generator exactly as the reference draws them, so the same seed
gives the same image. LR is a bicubic downsample.

The cubic resize is `models.layers.bicubic_resize`, the twin of
``jax.image.resize(method="cubic")`` (within 4e-7 of it on the CPU,
tests/test_torch_quant.py and tests/test_torch_baselines.py).
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.models.layers import bicubic_resize


def _smooth_field(rng: np.random.Generator, h: int, w: int, grid: int = 4) -> np.ndarray:
    coarse = rng.uniform(0, 1, size=(grid, grid, 3)).astype(np.float32)
    return bicubic_resize(torch.from_numpy(coarse)[None], (h, w))[0].numpy()


def _texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(rng.integers(2, 5)):
        f = rng.uniform(0.05, 0.45)
        theta = rng.uniform(0, np.pi)
        phase = rng.uniform(0, 2 * np.pi)
        wave = 0.5 + 0.5 * np.sin(2 * np.pi * f * (np.cos(theta) * xx + np.sin(theta) * yy) + phase)
        img += wave[..., None] * rng.uniform(0.2, 0.6, size=3).astype(np.float32)
    img /= max(1e-6, img.max())
    return img


def _strokes(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    img = np.full((h, w, 3), rng.uniform(0.6, 1.0), np.float32)
    n = int(rng.integers(6, 18))
    for _ in range(n):
        color = rng.uniform(0, 0.35, size=3).astype(np.float32)
        if rng.uniform() < 0.5:  # line
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            length = int(rng.integers(max(4, h // 8), h))
            thick = int(rng.integers(1, 3))
            if rng.uniform() < 0.5:
                img[y0:y0 + thick, max(0, x0 - length):x0] = color
            else:
                img[max(0, y0 - length):y0, x0:x0 + thick] = color
        else:     # rectangle outline
            y0, x0 = rng.integers(0, max(1, h - 8)), rng.integers(0, max(1, w - 8))
            hh, ww = int(rng.integers(4, h // 2)), int(rng.integers(4, w // 2))
            y1, x1 = min(h - 1, y0 + hh), min(w - 1, x0 + ww)
            img[y0:y1, x0] = color
            img[y0:y1, x1] = color
            img[y0, x0:x1] = color
            img[y1, x0:x1] = color
    return img


def random_image(seed: int, h: int, w: int, tile: int = 32) -> np.ndarray:
    """Tiled composition of the three content classes. (h,w,3) in [0,1]."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    gens = (_smooth_field, _texture, _strokes)
    for y in range(0, h, tile):
        for x in range(0, w, tile):
            th, tw = min(tile, h - y), min(tile, w - x)
            k = int(rng.integers(0, 3))
            img[y:y + th, x:x + tw] = gens[k](rng, th, tw)[:th, :tw]
    return np.clip(img, 0.0, 1.0)


def degrade(hr, scale: int) -> torch.Tensor:
    """Bicubic downsample of (N,H,W,3) or (H,W,3) (numpy or tensor), clipped
    to [0,1]."""
    hr = hr if isinstance(hr, torch.Tensor) else torch.from_numpy(np.asarray(hr, np.float32))
    single = hr.ndim == 3
    if single:
        hr = hr[None]
    _, h, w, _ = hr.shape
    lr = torch.clamp(bicubic_resize(hr, (h // scale, w // scale)), 0.0, 1.0)
    return lr[0] if single else lr


def make_eval_set(seed: int, n: int, hr: int = 128, device="cuda") -> torch.Tensor:
    """n HR images (n, hr, hr, 3) on ``device``, image i from seed + i (the
    caller degrades them to its scale)."""
    return torch.from_numpy(np.stack([random_image(seed + i, hr, hr) for i in range(n)])
                            ).to(device)


def patch_batches(seed: int, batch: int, lr_patch: int, scale: int, pool: int = 16,
                  pool_hw: int = 256, device="cuda"
                  ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Infinite iterator of (lr (B,p,p,3), hr (B,p*s,p*s,3)) training pairs
    on ``device``: a pool of HR images made once (degraded on the CPU, then
    kept on ``device``), aligned patch pairs cropped from it at random with
    the same numpy generator calls as the reference, so the crops are the
    reference's."""
    rng = np.random.default_rng(seed)
    hr_np = np.stack([random_image(seed + 1000 + i, pool_hw, pool_hw) for i in range(pool)])
    lr_pool = degrade(hr_np, scale).to(device)
    hr_pool = torch.from_numpy(hr_np).to(device)
    lp = lr_patch
    while True:
        idx = rng.integers(0, pool, size=batch)
        ys = rng.integers(0, lr_pool.shape[1] - lp + 1, size=batch)
        xs = rng.integers(0, lr_pool.shape[2] - lp + 1, size=batch)
        lr = torch.stack([lr_pool[i, y:y + lp, x:x + lp] for i, y, x in zip(idx, ys, xs)])
        hr = torch.stack([hr_pool[i, y * scale:(y + lp) * scale, x * scale:(x + lp) * scale]
                          for i, y, x in zip(idx, ys, xs)])
        yield lr, hr
