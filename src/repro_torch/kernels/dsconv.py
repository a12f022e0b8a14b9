"""Fused DSConv kernel wrapper (CUDA source: ``csrc/dsconv.cu``).

Replaces ``repro/kernels/dsconv.py::dsconv_fused``: 3x3 SAME depthwise +
bias -> 1x1 pointwise + bias -> optional ReLU in one launch.
``dsconv_fused.launches`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_channels, check_operands, stream_of
from repro_torch.kernels.ref import dsconv_ref


def dsconv_fused(x: torch.Tensor, dw: torch.Tensor, dw_b: torch.Tensor,
                 pw: torch.Tensor, pw_b: torch.Tensor, *, relu: bool = False) -> torch.Tensor:
    """x: (N,H,W,Cin) fp32; dw: (3,3,Cin); pw: (Cin,Cout); biases.

    CPU tensors take the plain version (`kernels.ref.dsconv_ref`); CUDA
    tensors launch the kernel. N = 0 returns an empty output, no launch."""
    cin, cout = int(pw.shape[0]), int(pw.shape[-1])
    check_operands("dsconv_fused", x, {
        "dw": (dw, (3, 3, x.shape[-1])), "dw_b": (dw_b, (x.shape[-1],)),
        "pw": (pw, (x.shape[-1], cout)), "pw_b": (pw_b, (cout,))})
    check_channels("dsconv_fused", Cin=cin, Cout=cout)
    if x.device.type == "cpu":
        return dsconv_ref(x, dw, dw_b, pw, pw_b, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"dsconv_fused: no kernel for device {x.device}")
    n, h, w, _ = x.shape
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    launch = _build.entry("dsconv", "dsconv_forward", 6, 6)
    launch(x.data_ptr(), dw.data_ptr(), dw_b.data_ptr(), pw.data_ptr(), pw_b.data_ptr(),
           out.data_ptr(), n, h, w, cin, cout, int(relu), stream_of(x))
    dsconv_fused.launches += 1
    return out


dsconv_fused.launches = 0
