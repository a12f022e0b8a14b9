"""Plain PyTorch versions of the fused kernels, in the kernels' operand
layout (twin of ``repro.kernels.ref``): pointwise weights ``(Cin, Cout)``,
depthwise ``(3, 3, C)``, biases ``(C,)``, activations NHWC.

The wrappers take these on CPU tensors; on the card they are what each
kernel is held against.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import layers as L


def bsconv_ref(x, pw, pw_b, dw, dw_b, *, relu: bool = False) -> torch.Tensor:
    """x: (N,H,W,Ci), pw: (Ci,Co), dw: (3,3,Co) -> (N,H,W,Co). SAME zero pad."""
    y = L.pointwise(x, pw, pw_b)
    y = L._dw3_shift(y, dw) + dw_b
    return torch.relu(y) if relu else y


def dsconv_ref(x, dw, dw_b, pw, pw_b, *, relu: bool = False) -> torch.Tensor:
    """x: (N,H,W,Ci), dw: (3,3,Ci), pw: (Ci,Co) -> (N,H,W,Co)."""
    y = L._dw3_shift(x, dw) + dw_b
    y = L.pointwise(y, pw, pw_b)
    return torch.relu(y) if relu else y


def sfb_ref(x, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """relu(BSConv) -> relu(BSConv) -> (+x) -> 1x1 -> relu. ``p`` holds
    b1_pw, b1_pwb, b1_dw, b1_dwb, b2_*, fuse, fuse_b."""
    y = bsconv_ref(x, p["b1_pw"], p["b1_pwb"], p["b1_dw"], p["b1_dwb"], relu=True)
    y = bsconv_ref(y, p["b2_pw"], p["b2_pwb"], p["b2_dw"], p["b2_dwb"], relu=True)
    return torch.relu(L.pointwise(y + x, p["fuse"], p["fuse_b"]))


def mega_ref(x, w: Dict[str, Any]) -> torch.Tensor:
    """The whole subnet-group chain, bsconv_ref -> n x sfb_ref -> dsconv_ref,
    on the pre-shuffle output. ``w``: "first" (pw, pw_b, dw, dw_b), "sfbs"
    (one `sfb_ref` dict each) and "recon" (dw, dw_b, pw, pw_b)."""
    p = w["first"]
    f = bsconv_ref(x, p["pw"], p["pw_b"], p["dw"], p["dw_b"])
    for s in w["sfbs"]:
        f = sfb_ref(f, s)
    r = w["recon"]
    return dsconv_ref(f, r["dw"], r["dw_b"], r["pw"], r["pw_b"])
