"""Edge score (twin of ``repro.core.edge_score``).

luma -> 4-neighbour Laplacian (VALID) -> |.| clamped to [0,255] -> mean,
one scalar per patch. The Laplacian is four shifted adds in fp32, not
``F.conv2d``: cuDNN runs fp32 convolutions in TF32 by default, and on a luma
span of 0-255 that error could move a score across t1 or t2 and change the
routing.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import rgb_to_luma


def laplacian_response(luma: torch.Tensor) -> torch.Tensor:
    """(N,H,W) luma -> (N,H-2,W-2) |Laplacian| clamped to [0,255]. Taps are
    summed in the kernel's raster order (up, left, centre, right, down)."""
    c = luma[:, 1:-1, 1:-1]
    y = (luma[:, :-2, 1:-1] + luma[:, 1:-1, :-2]) + (-4.0) * c
    y = (y + luma[:, 1:-1, 2:]) + luma[:, 2:, 1:-1]
    return torch.clamp(torch.abs(y), 0.0, 255.0)


def edge_score(patches: torch.Tensor) -> torch.Tensor:
    """(N,h,w,3) RGB in [0,1] -> (N,) edge scores in [0,255]."""
    return edge_score_luma(rgb_to_luma(patches))


def edge_score_luma(luma: torch.Tensor) -> torch.Tensor:
    """(N,h,w) luma in [0,255] -> (N,) edge scores."""
    return laplacian_response(luma).mean(dim=(1, 2))
