"""Fused BSConv kernel wrapper (CUDA source: ``csrc/bsconv.cu``).

Replaces ``repro/kernels/bsconv.py::bsconv_fused``: 1x1 pointwise + bias ->
3x3 SAME depthwise + bias -> optional ReLU in one launch, the intermediate
kept in shared memory. ``bsconv_fused.launches`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_channels, check_operands, stream_of
from repro_torch.kernels.ref import bsconv_ref


def bsconv_fused(x: torch.Tensor, pw: torch.Tensor, pw_b: torch.Tensor,
                 dw: torch.Tensor, dw_b: torch.Tensor, *, relu: bool = False) -> torch.Tensor:
    """x: (N,H,W,Cin) fp32; pw: (Cin,Cout); dw: (3,3,Cout); biases (Cout,).

    CPU tensors take the plain version (`kernels.ref.bsconv_ref`); CUDA
    tensors launch the kernel. N = 0 returns an empty output, no launch."""
    cin, cout = int(pw.shape[0]), int(pw.shape[-1])
    check_operands("bsconv_fused", x, {
        "pw": (pw, (x.shape[-1], cout)), "pw_b": (pw_b, (cout,)),
        "dw": (dw, (3, 3, cout)), "dw_b": (dw_b, (cout,))})
    check_channels("bsconv_fused", Cin=cin, Cout=cout)
    if x.device.type == "cpu":
        return bsconv_ref(x, pw, pw_b, dw, dw_b, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"bsconv_fused: no kernel for device {x.device}")
    n, h, w, _ = x.shape
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    launch = _build.entry("bsconv", "bsconv_forward", 6, 6)
    launch(x.data_ptr(), pw.data_ptr(), pw_b.data_ptr(), dw.data_ptr(), dw_b.data_ptr(),
           out.data_ptr(), n, h, w, cin, cout, int(relu), stream_of(x))
    bsconv_fused.launches += 1
    return out


bsconv_fused.launches = 0
