"""Losses and image metrics (twin of ``repro.train.losses``).

PSNR phase: L1 (paper Sec. V-A). Perceptual phase: 0.01*L1 +
1*artifact(LDL) + 1*perceptual + 0.005*adversarial.

The perceptual features come from a fixed random-init conv stack, as in the
reference (no pretrained VGG is downloaded); the LDL artifact loss is its
definition (a local-variance-weighted residual).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.tree import tree_map
from repro_torch.models import layers as L

# ---------------------------------------------------------------------------
# pixel losses / metrics
# ---------------------------------------------------------------------------


def l1_loss(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(sr - hr))


def charbonnier(sr: torch.Tensor, hr: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.mean(torch.sqrt((sr - hr) ** 2 + eps * eps))


def psnr(sr: torch.Tensor, hr: torch.Tensor, peak: float = 1.0) -> torch.Tensor:
    mse = torch.mean((sr - hr) ** 2)
    return 10.0 * torch.log10(peak * peak / torch.clamp(mse, min=1e-12))


def psnr_y(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """Y-channel PSNR (the SR literature's convention, the paper's)."""
    ys = L.rgb_to_luma(torch.clamp(sr, 0, 1)) / 255.0
    yh = L.rgb_to_luma(torch.clamp(hr, 0, 1)) / 255.0
    return psnr(ys, yh)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(sr: torch.Tensor, hr: torch.Tensor, peak: float = 1.0) -> torch.Tensor:
    """Single-scale SSIM on luma, 11x11 gaussian window (standard constants)."""
    c1, c2 = (0.01 * peak) ** 2, (0.03 * peak) ** 2
    x = L.rgb_to_luma(torch.clamp(sr, 0, 1))[..., None] / 255.0 if sr.shape[-1] == 3 else sr
    y = L.rgb_to_luma(torch.clamp(hr, 0, 1))[..., None] / 255.0 if hr.shape[-1] == 3 else hr
    if x.ndim == 3:
        x, y = x[None], y[None]
    k = _gaussian_kernel().to(x.device).reshape(11, 11, 1, 1)

    def f(z):
        return L.conv2d(z, k, padding="VALID")

    mx, my = f(x), f(y)
    sxx, syy, sxy = f(x * x) - mx * mx, f(y * y) - my * my, f(x * y) - mx * my
    s = ((2 * mx * my + c1) * (2 * sxy + c2)) / ((mx * mx + my * my + c1) * (sxx + syy + c2))
    return torch.mean(s)


# ---------------------------------------------------------------------------
# perceptual distance (fixed random feature stack, an LPIPS stand-in)
# ---------------------------------------------------------------------------

def init_feature_net(generator: Optional[torch.Generator] = None,
                     channels=(16, 32, 64)) -> Dict[str, Any]:
    """He-normal 3x3 convs (stride 2 in use), zero biases, drawn from
    ``generator`` (seeded with 7 when None)."""
    g = generator if generator is not None else torch.Generator().manual_seed(7)
    ps, cin = [], 3
    for c in channels:
        ps.append({"w": L.conv_init((3, 3, cin, c), g), "b": torch.zeros(c)})
        cin = c
    return {"convs": ps}


def feature_stack(params, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    feats = []
    for p in params["convs"]:
        x = torch.relu(L.conv2d(x, p["w"], p["b"], stride=2))
        feats.append(x)
    return tuple(feats)


def perceptual_loss(feat_params, sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    fs, fh = feature_stack(feat_params, sr), feature_stack(feat_params, hr)

    def nrm(f):
        return f * torch.rsqrt(torch.mean(f * f, dim=-1, keepdim=True) + 1e-8)
    return sum(torch.mean(torch.abs(nrm(a) - nrm(b))) for a, b in zip(fs, fh)) / len(fs)


def perceptual_distance(generator_or_params: Union[None, torch.Generator, Dict[str, Any]],
                        sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """LPIPS-like scalar for evaluation (lower = perceptually closer), over
    a feature net drawn from a generator (None: seeded with 7) or given as
    a tree (tensors, or the reference's numpy leaves)."""
    params = generator_or_params
    if not isinstance(params, dict):
        params = init_feature_net(params)
    params = tree_map(lambda a: (a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a)))
                      .to(device=sr.device, dtype=torch.float32), params)
    return perceptual_loss(params, sr, hr)


# ---------------------------------------------------------------------------
# LDL artifact loss (Liang et al. 2022, the paper's ref [24])
# ---------------------------------------------------------------------------

def _local_var(x: torch.Tensor, k: int = 7) -> torch.Tensor:
    ones = torch.ones((k, k, 1, 1), dtype=x.dtype, device=x.device) / (k * k)
    lum = x.mean(dim=-1, keepdim=True)
    mu = L.conv2d(lum, ones)
    return torch.clamp(L.conv2d(lum * lum, ones) - mu * mu, min=0.0)


def artifact_loss(sr: torch.Tensor, hr: torch.Tensor, gamma: float = 0.25) -> torch.Tensor:
    """Residuals penalised where the SR image is locally unstable (the
    variance-refined artifact map, gradient stopped as in LDL)."""
    resid = torch.abs(sr - hr)
    amap = (_local_var(sr) ** gamma * resid.mean(dim=-1, keepdim=True)).detach()
    amap = amap / (torch.mean(amap) + 1e-8)
    return torch.mean(amap * resid)


# ---------------------------------------------------------------------------
# GAN losses (vanilla non-saturating; the discriminator is in train/gan.py)
# ---------------------------------------------------------------------------

def d_loss_fn(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    return torch.mean(F.softplus(-real_logits)) + torch.mean(F.softplus(fake_logits))


def g_adv_loss_fn(fake_logits: torch.Tensor) -> torch.Tensor:
    return torch.mean(F.softplus(-fake_logits))


PERCEPTUAL_WEIGHTS = {"l1": 0.01, "artifact": 1.0, "perceptual": 1.0, "adv": 0.005}
