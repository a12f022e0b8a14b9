"""The ESSR patch-batch forward through the fused kernels (twin of
``repro.kernels.ops``):

    BSConv kernel -> n_sfb x SFB kernel -> DSConv kernel -> pixel shuffle

and the registry of every kernel wrapper with its launch count; the
subnet-group megakernel (``essr_forward_megakernel``, one launch for the
whole chain) and its quantized twin (``essr_forward_qmegakernel``) are
re-exported from `kernels.megakernel`, the quantized chain
(``essr_forward_qkernels``: quantize -> qBSConv -> n_sfb x qSFB -> qDSConv)
from `kernels.qconv`, and the edge-score kernel (``edge_score_fused``) from
`kernels.edge`.

The CUDA kernels take any batch size, so the TPU grid's block padding
(``pad_batch`` / ``resolve_block`` / ``block_patches``) and its
interpreter policy have no counterpart here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.kernels.bsconv import bsconv_fused
from repro_torch.kernels.dsconv import dsconv_fused
from repro_torch.kernels.edge import edge_score_fused
from repro_torch.kernels.megakernel import (essr_forward_megakernel, essr_forward_qmegakernel,
                                            mega_fused, qmega_fused)
from repro_torch.kernels.qconv import (essr_forward_qkernels, qbsconv_fused, qdsconv_fused,
                                       qsfb_fused, quantize_fused)
from repro_torch.kernels.sfb import sfb_fused
from repro_torch.models.essr import ESSRConfig, slice_width
from repro_torch.models.layers import pixel_shuffle

#: Every kernel wrapper of this package; each carries a ``launches`` count.
KERNELS = {"bsconv": bsconv_fused, "sfb": sfb_fused, "dsconv": dsconv_fused,
           "mega": mega_fused, "quantize": quantize_fused, "qbsconv": qbsconv_fused,
           "qsfb": qsfb_fused, "qdsconv": qdsconv_fused, "qmega": qmega_fused,
           "edge": edge_score_fused}

__all__ = ["KERNELS", "edge_score_fused", "essr_forward_kernels", "essr_forward_megakernel",
           "essr_forward_qkernels", "essr_forward_qmegakernel", "flat_sfb", "launch_counts",
           "reset_launch_counts"]


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous()


def _bias(p: Dict[str, Any], key: str, n: int, like: torch.Tensor) -> torch.Tensor:
    b = p.get(key)
    return _flat(b) if b is not None else torch.zeros(n, dtype=like.dtype, device=like.device)


def flat_sfb(p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """One SFB's param subtree -> the kernel's flat, contiguous operands."""
    c = p["fuse"].shape[-1]
    out = {"fuse": _flat(p["fuse"][0, 0]), "fuse_b": _bias(p, "fuse_b", c, p["fuse"])}
    for b in ("b1", "b2"):
        out[f"{b}_pw"] = _flat(p[b]["pw"][0, 0])
        out[f"{b}_pwb"] = _bias(p[b], "pw_b", c, p[b]["pw"])
        out[f"{b}_dw"] = _flat(p[b]["dw"][:, :, 0, :])
        out[f"{b}_dwb"] = _bias(p[b], "dw_b", c, p[b]["dw"])
    return out


def essr_forward_kernels(params: Dict[str, Any], x: torch.Tensor, cfg: ESSRConfig,
                         width: Optional[int] = None) -> torch.Tensor:
    """x: (N,p,p,3) -> (N,p*s,p*s,3) through the fused kernels. ``width`` in
    {C/2, C} (None = C); bilinear patches never reach the kernels."""
    w = width if width is not None else cfg.channels
    if w <= 0:
        raise ValueError("the bilinear subnet does not use the conv kernels")
    if x.shape[0] == 0:
        s = cfg.scale
        return x.new_zeros((0, x.shape[1] * s, x.shape[2] * s, cfg.in_channels))
    if w != cfg.channels:
        params = slice_width(params, w)
    first, recon = params["first"], params["recon"]
    c = first["pw"].shape[-1]
    f = bsconv_fused(x, _flat(first["pw"][0, 0]), _bias(first, "pw_b", c, first["pw"]),
                     _flat(first["dw"][:, :, 0, :]), _bias(first, "dw_b", c, first["dw"]))
    for p in params["sfbs"]:
        f = sfb_fused(f, flat_sfb(p))
    up = dsconv_fused(f, _flat(recon["dw"][:, :, 0, :]), _bias(recon, "dw_b", c, recon["dw"]),
                      _flat(recon["pw"][0, 0]),
                      _bias(recon, "pw_b", recon["pw"].shape[-1], recon["pw"]))
    return pixel_shuffle(up, cfg.scale)
