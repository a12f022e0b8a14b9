"""Plain PyTorch versions of the fused kernels, in the kernels' operand
layout (twin of ``repro.kernels.ref``): pointwise weights ``(Cin, Cout)``,
depthwise ``(3, 3, C)``, biases ``(C,)``, activations NHWC.

The wrappers take these on CPU tensors; on the card they are what each
kernel is held against.

The quantized versions (twins of ``repro.kernels.qconv``'s ``_*_math``) are
the arithmetic contract of ``csrc/qconv.cu``, ``csrc/qsfb.cu``,
``csrc/dsconv.cu`` (qDSConv) and ``csrc/qmega.cu``, which
must equal them bit for bit: every fp step is its own rounded op (no multiply-add contraction), the
depthwise sums its 9 taps in (dy, dx) raster order from 0 before the bias,
and the site constants ``qc`` (clip, step pairs) are 0-d tensors on the
codes' device, so a division by the step is IEEE division on the card too
(PyTorch's CUDA division by a CPU scalar multiplies by its reciprocal).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.edge_score import edge_score
from repro_torch.models import layers as L


def edge_score_ref(patches: torch.Tensor) -> torch.Tensor:
    """(N,h,w,3) RGB in [0,1] -> (N,) edge scores: `core.edge_score.edge_score`,
    the plain version of ``csrc/edge.cu``."""
    return edge_score(patches)


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


# ---------------------------------------------------------------------------
# the integer (PAMS lattice) versions: codes in, codes out
# ---------------------------------------------------------------------------

def quantize_ref(x: torch.Tensor, qc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """round(clip(x, -a, a) / s) as ``dtype`` codes; ``qc`` = (a, s)."""
    a, s = qc[0], qc[1]
    return torch.round(torch.minimum(torch.maximum(x, -a), a) / s).to(dtype)


def _idot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Integer 1x1: codes (N,H,W,Ci) x code weights (Ci,Co) -> int32 sums.
    Taken in float64 because PyTorch has no integer matmul on CUDA; it is
    exact, as every partial sum (at most 511 * 511 * 64 < 2^24 in size) is
    an integer far below 2^53."""
    return torch.matmul(xq.to(torch.float64), wq.to(torch.float64)).to(torch.int32)


def _dequant(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(float(acc) * scale) + bias, two rounded ops."""
    return acc.to(torch.float32) * scale + bias


def qbsconv_ref(xq, pwq, pw_scale, pw_b, dw_fq, dw_b, qc, *, relu: bool) -> torch.Tensor:
    """Codes -> codes through one BSConv group: integer 1x1, dequant + bias,
    fp 3x3 depthwise (fake-quant weights, zero padding of the dequantized
    map) + bias, optional ReLU, requantize at ``qc``."""
    y = _dequant(_idot(xq, pwq), pw_scale, pw_b)
    y = L._dw3_shift(y, dw_fq) + dw_b
    if relu:
        y = torch.relu(y)
    return quantize_ref(y, qc, xq.dtype)


def qsfb_ref(xq, q: Dict[str, torch.Tensor], qc: torch.Tensor) -> torch.Tensor:
    """Whole SFB on the lattice: two qBSConv groups (sites ``qc[0:2]``,
    ``qc[2:4]``), then the fuse 1x1 split over its two input lattices,
    ((acc_y * sy) + (acc_x * sx)) + b, ReLU, requantize at ``qc[4:6]``."""
    y1 = qbsconv_ref(xq, q["b1_pwq"], q["b1_pw_scale"], q["b1_pwb"], q["b1_dw_fq"],
                     q["b1_dwb"], qc[0:2], relu=True)
    y2 = qbsconv_ref(y1, q["b2_pwq"], q["b2_pw_scale"], q["b2_pwb"], q["b2_dw_fq"],
                     q["b2_dwb"], qc[2:4], relu=True)
    y = (_idot(y2, q["fuseq"]).to(torch.float32) * q["fuse_scale_y"]
         + _idot(xq, q["fuseq"]).to(torch.float32) * q["fuse_scale_x"]) + q["fuseb"]
    return quantize_ref(torch.relu(y), qc[4:6], xq.dtype)


def qdsconv_ref(xq, dwq, dw_scale, dw_b, pw_fq, pw_b, qc) -> torch.Tensor:
    """DSConv on the lattice: exact int32 3x3 depthwise on the codes (zero
    codes off the patch), dequant + bias, fp 1x1 with fake-quant weights as
    an ordered sum over input channels 0..C-1 from 0 (the reference's dot has
    no fixed order; the kernel keeps this one), + bias, requantize."""
    y = _dequant(L._dw3_shift(xq.to(torch.int32), dwq), dw_scale, dw_b)
    out = torch.zeros(y.shape[:-1] + (pw_fq.shape[-1],), dtype=y.dtype, device=y.device)
    for ci in range(y.shape[-1]):
        out = out + y[..., ci:ci + 1] * pw_fq[ci]
    return quantize_ref(out + pw_b, qc, xq.dtype)


def qmega_ref(x: torch.Tensor, q: Dict[str, Any], qc: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """The whole integer chain of one subnet, fp patches in, recon codes out:
    quantize (site ``qc[0:2]``) -> qBSConv (``qc[2:4]``) -> n x qSFB
    (``qc[4 + 6i: 10 + 6i]``) -> qDSConv (``qc[-2:]``), codes of ``dtype``
    between them. ``q``: the operands of `kernels.qconv.prepare_qparams`
    ("first", "sfbs", "recon"); ``qc``: its site-constant buffer."""
    p, r = q["first"], q["recon"]
    f = quantize_ref(x, qc[0:2], dtype)
    f = qbsconv_ref(f, p["pwq"], p["pw_scale"], p["pwb"], p["dw_fq"], p["dwb"], qc[2:4],
                    relu=False)
    for i, s in enumerate(q["sfbs"]):
        f = qsfb_ref(f, s, qc[4 + 6 * i: 10 + 6 * i])
    return qdsconv_ref(f, r["dwq"], r["dw_scale"], r["dwb"], r["pw_fq"], r["pwb"], qc[-2:])
