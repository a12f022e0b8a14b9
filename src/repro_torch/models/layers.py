"""Convolution / resampling primitives of the SR models, in PyTorch.

Twin of ``repro.models.layers``: NHWC activations, HWIO weights, the same
operation order, so the port and the reference agree to fp32 rounding. These
are the plain versions every CUDA kernel of ``repro_torch.kernels`` is held
against.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def conv_init(shape: Tuple[int, ...], generator: torch.Generator,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """He-normal initializer for HWIO weights: std = sqrt(2 / (H*W*I))."""
    fan_in = int(shape[0] * shape[1] * shape[2])
    std = math.sqrt(2.0 / max(1, fan_in))
    return std * torch.randn(shape, generator=generator, dtype=dtype)


def init_bsconv(cin: int, cout: int, generator: torch.Generator, *, bias: bool = True,
                dtype: torch.dtype = torch.float32) -> dict:
    """BSConv weights: He-normal 1x1 pointwise (cin->cout), then 3x3
    depthwise (cout), drawn in that order; zero biases."""
    p = {"pw": conv_init((1, 1, cin, cout), generator, dtype),
         "dw": conv_init((3, 3, 1, cout), generator, dtype)}
    if bias:
        p["pw_b"] = torch.zeros(cout, dtype=dtype)
        p["dw_b"] = torch.zeros(cout, dtype=dtype)
    return p


def init_dsconv(cin: int, cout: int, generator: torch.Generator, *, bias: bool = True,
                dtype: torch.dtype = torch.float32) -> dict:
    """DSConv weights: He-normal 3x3 depthwise (cin), then 1x1 pointwise
    (cin->cout), drawn in that order; zero biases."""
    p = {"dw": conv_init((3, 3, 1, cin), generator, dtype),
         "pw": conv_init((1, 1, cin, cout), generator, dtype)}
    if bias:
        p["dw_b"] = torch.zeros(cin, dtype=dtype)
        p["pw_b"] = torch.zeros(cout, dtype=dtype)
    return p


class ConvWeights(torch.nn.Module):
    """One convolution's weights in the reference's layout: ``w`` (k, k,
    cin, cout) HWIO, He-normal from ``generator``; ``b`` (cout,) zeros;
    with ``prelu``, ``a`` (cout,) PReLU slopes of 0.25."""

    def __init__(self, k: int, cin: int, cout: int, generator: torch.Generator,
                 prelu: bool = False):
        super().__init__()
        self.w = torch.nn.Parameter(conv_init((k, k, cin, cout), generator))
        self.b = torch.nn.Parameter(torch.zeros(cout))
        self.a = torch.nn.Parameter(torch.full((cout,), 0.25)) if prelu else None

    def tree(self) -> dict:
        out = {"w": self.w, "b": self.b}
        if self.a is not None:
            out["a"] = self.a
        return out


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one axis: the output is ceil(size / stride),
    the pad total what that needs, its floor half before and the rest
    after (so a stride-2 3x3 on an even size pads (0, 1))."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
           stride: int = 1, padding="SAME") -> torch.Tensor:
    """Standard conv, as ``lax.conv_general_dilated`` computes it. x:
    (N,H,W,Cin), w: (kh,kw,Cin,Cout). ``padding``: "SAME", "VALID" or
    ((top, bottom), (left, right)); the pads are applied explicitly, since
    ``F.conv2d`` pads both sides alike."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    if padding == "SAME":
        (pt, pb), (pl, pr) = (_same_pads(int(x.shape[1]), kh, stride),
                              _same_pads(int(x.shape[2]), kw, stride))
    elif padding == "VALID":
        pt = pb = pl = pr = 0
    else:
        (pt, pb), (pl, pr) = padding
    xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)
    return y + b if b is not None else y


def _dw3_shift(x: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """3x3 SAME depthwise via 9 shifted multiply-accumulates. x: (N,H,W,C),
    w3: (3,3,C). Zero padding, accumulated in (dy, dx) raster order. Its
    gradient is autograd's of these shifts: the same math as the
    reference's ``_dw3`` custom VJP (the rotated-kernel shift for x, a
    shifted product sum for w3)."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    y = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            y = y + xp[:, dy:dy + h, dx:dx + w, :] * w3[dy, dx]
    return y


def dwconv2d(x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 SAME depthwise conv. x: (N,H,W,C), w: (3,3,1,C)."""
    if tuple(w.shape[:3]) != (3, 3, 1):
        raise ValueError(f"depthwise weight must be (3,3,1,C), got {tuple(w.shape)}")
    y = _dw3_shift(x, w[:, :, 0, :])
    return y + b if b is not None else y


def pointwise(x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1x1 conv as a matmul over the channel dim. w: (1,1,Cin,Cout) or (Cin,Cout)."""
    if w.ndim == 4:
        w = w[0, 0]
    y = torch.matmul(x, w)
    return y + b if b is not None else y


def bsconv(p: dict, x: torch.Tensor) -> torch.Tensor:
    """BSConv: 1x1 pointwise (+bias) then 3x3 depthwise (+bias)."""
    y = pointwise(x, p["pw"], p.get("pw_b"))
    return dwconv2d(y, p["dw"], p.get("dw_b"))


def dsconv(p: dict, x: torch.Tensor) -> torch.Tensor:
    """DSConv: 3x3 depthwise (+bias) then 1x1 pointwise (+bias)."""
    y = dwconv2d(x, p["dw"], p.get("dw_b"))
    return pointwise(y, p["pw"], p.get("pw_b"))


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(N,H,W,C*s^2) -> (N,H*s,W*s,C) in PyTorch's c*s^2 + i*s + j channel
    order: ``F.pixel_shuffle`` on the NCHW view."""
    y = F.pixel_shuffle(x.permute(0, 3, 1, 2), scale)
    return y.permute(0, 2, 3, 1)


def bilinear_resize(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear upsample of (N,H,W,C) by an integer scale: half-pixel
    centres, edge clamp, no antialias (what ``jax.image.resize`` does when
    upsampling)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=scale,
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def bicubic_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(N,H,W,C) -> (N,out_h,out_w,C), as ``jax.image.resize(method="cubic")``:
    Keys' kernel at a = -0.5, half-pixel centres, antialiased when shrinking,
    taps outside the image dropped and the rest renormalised. That is
    ``F.interpolate``'s bicubic with ``antialias=True``; without it torch
    uses a = -0.75 and clamps at the edge."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(int(v) for v in out_hw),
                      mode="bicubic", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def rgb_to_luma(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0,1] -> (...,) BT.601 luma in [16, 235]. Operation
    order matches the reference: the score it feeds decides routing."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return (65.481 * r + 128.553 * g + 24.966 * b) + 16.0


def count_params(tree) -> int:
    """Elements over the leaves of a param tree (tensors or numpy arrays),
    or over an ``nn.Module``'s parameters."""
    if isinstance(tree, torch.nn.Module):
        return sum(int(p.numel()) for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    if tree is None:
        return 0
    return int(tree.numel()) if isinstance(tree, torch.Tensor) else int(np.size(tree))
