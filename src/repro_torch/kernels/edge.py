"""Edge-score kernel wrapper (CUDA source: ``csrc/edge.cu``).

Twin of ``repro.kernels.edge.edge_score_fused``: BT.601 luma -> 4-neighbour
Laplacian on the interior (VALID) -> |.| clamped to [0, 255] -> one mean
per patch, in one launch over a batch of patches. The "cuda" serving path
scores every frame's patches with it (`core.pipeline._edge_selective_sr`);
the "ref" backend and a forced routing keep the plain
`core.edge_score.edge_score`.

On CPU tensors the wrapper takes the plain version
(`kernels.ref.edge_score_ref`); on CUDA tensors it launches the kernel or
raises. The kernel sums each patch's mean in another order than the plain
version, so the two agree to rounding (rtol 1e-4 / atol 1e-3, the JAX
kernel test's tolerance), not bit for bit. ``edge_score_fused.launches``
counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_operands, stream_of
from repro_torch.kernels.ref import edge_score_ref


def edge_score_fused(x: torch.Tensor) -> torch.Tensor:
    """x: (N,h,w,3) fp32 RGB in [0,1] -> (N,) fp32 edge scores in [0,255].
    h and w must be at least 3 (the Laplacian needs an interior); any
    larger size is taken. N = 0 returns an empty tensor, no launch."""
    check_operands("edge_score_fused", x, {})
    n, h, w, c = x.shape
    if c != 3:
        raise ValueError(f"edge_score_fused: x must be RGB (N,h,w,3), got {c} channels")
    if h < 3 or w < 3:
        raise ValueError(f"edge_score_fused: a {h}x{w} patch has no interior for the "
                         f"3x3 Laplacian")
    if x.device.type == "cpu":
        return edge_score_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"edge_score_fused: no kernel for device {x.device}")
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    launch = _build.entry("edge", "edge_forward", 2, 3)
    launch(x.data_ptr(), out.data_ptr(), n, h, w, stream_of(x))
    edge_score_fused.launches += 1
    return out


edge_score_fused.launches = 0
