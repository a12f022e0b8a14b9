"""Fused whole-SFB kernel wrapper (CUDA source: ``csrc/sfb.cu``).

Replaces ``repro/kernels/sfb.py::sfb_fused``: BSConv, ReLU, BSConv, ReLU,
shortcut add, 1x1 fuse, ReLU in one launch; the five intermediates stay in
shared memory. ``sfb_fused.launches`` counts launches.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_channels, check_operands, stream_of
from repro_torch.kernels.ref import sfb_ref

#: Operand order of the C entry ``sfb_forward``.
SFB_KEYS = ("b1_pw", "b1_pwb", "b1_dw", "b1_dwb", "b2_pw", "b2_pwb", "b2_dw", "b2_dwb",
            "fuse", "fuse_b")


def sfb_fused(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x: (N,H,W,C) fp32; ``p``: the flat SFB weights of `SFB_KEYS`
    (pointwise (C,C), depthwise (3,3,C), biases (C,)).

    CPU tensors take the plain version (`kernels.ref.sfb_ref`); CUDA tensors
    launch the kernel. N = 0 returns an empty output, no launch."""
    c = int(x.shape[-1]) if x.ndim == 4 else -1
    shapes = {"pw": (c, c), "dw": (3, 3, c), "b": (c,)}
    check_operands("sfb_fused", x, {
        k: (p[k], shapes["dw" if k.endswith("_dw") else
                         "pw" if k in ("b1_pw", "b2_pw", "fuse") else "b"])
        for k in SFB_KEYS})
    check_channels("sfb_fused", C=c)
    if x.device.type == "cpu":
        return sfb_ref(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"sfb_fused: no kernel for device {x.device}")
    n, h, w, _ = x.shape
    out = torch.empty_like(x)
    if n == 0:
        return out
    launch = _build.entry("sfb", "sfb_forward", 12, 4)
    launch(x.data_ptr(), *(p[k].data_ptr() for k in SFB_KEYS), out.data_ptr(),
           n, h, w, c, stream_of(x))
    sfb_fused.launches += 1
    return out


sfb_fused.launches = 0
