"""ESSR — Edge Selective Super-Resolution network, in PyTorch.

Twin of ``repro.models.essr``: BSConv(3->C) -> n_sfb x SFB(C) ->
DSConv(C -> 3*s^2) -> pixel shuffle, with the supernet's width slicing
(C27 is the first-27-channel slice of C54; width 0 is bilinear).

Weights live in ``nn.Module``s (`ESSR`, `BSConv`, `SFB`, `DSConv`) in the
reference's HWIO layouts; :meth:`ESSR.tree` hands them to the plain tensor
functions as the reference's param tree ({"first", "sfbs", "recon"}).

Exact parameter counts (asserted in the tests):
    x4, C=54, 5 SFB, bias:  53 886
    x2, C=54, 5 SFB, bias:  51 906
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class ESSRConfig:
    channels: int = 54          # C54 supernet width
    n_sfb: int = 5
    scale: int = 4              # x2 or x4
    bias: bool = True
    in_channels: int = 3

    @property
    def out_channels(self) -> int:
        return self.in_channels * self.scale * self.scale

    def subnet_widths(self) -> tuple:
        """(bilinear, C/2, C) — width 0 is bilinear."""
        return (0, self.channels // 2, self.channels)


ESSR_X4 = ESSRConfig(scale=4)
ESSR_X2 = ESSRConfig(scale=2)


# ---------------------------------------------------------------------------
# modules (weights in the reference's HWIO layouts)
# ---------------------------------------------------------------------------

class BSConv(nn.Module):
    """1x1 pointwise (cin->cout) then 3x3 depthwise (cout)."""

    def __init__(self, cin: int, cout: int, bias: bool, g: torch.Generator):
        super().__init__()
        p = L.init_bsconv(cin, cout, g, bias=bias)
        self.pw, self.dw = nn.Parameter(p["pw"]), nn.Parameter(p["dw"])
        self.pw_b = nn.Parameter(p["pw_b"]) if bias else None
        self.dw_b = nn.Parameter(p["dw_b"]) if bias else None

    def tree(self) -> Dict[str, torch.Tensor]:
        out = {"pw": self.pw, "dw": self.dw}
        if self.pw_b is not None:
            out.update(pw_b=self.pw_b, dw_b=self.dw_b)
        return out


class DSConv(nn.Module):
    """3x3 depthwise (cin) then 1x1 pointwise (cin->cout)."""

    def __init__(self, cin: int, cout: int, bias: bool, g: torch.Generator):
        super().__init__()
        p = L.init_dsconv(cin, cout, g, bias=bias)
        self.dw, self.pw = nn.Parameter(p["dw"]), nn.Parameter(p["pw"])
        self.dw_b = nn.Parameter(p["dw_b"]) if bias else None
        self.pw_b = nn.Parameter(p["pw_b"]) if bias else None

    def tree(self) -> Dict[str, torch.Tensor]:
        out = {"dw": self.dw, "pw": self.pw}
        if self.dw_b is not None:
            out.update(dw_b=self.dw_b, pw_b=self.pw_b)
        return out


class SFB(nn.Module):
    """relu(BSConv) -> relu(BSConv) -> (+x) -> 1x1 fuse -> relu."""

    def __init__(self, c: int, bias: bool, g: torch.Generator):
        super().__init__()
        self.b1 = BSConv(c, c, bias, g)
        self.b2 = BSConv(c, c, bias, g)
        self.fuse = nn.Parameter(L.conv_init((1, 1, c, c), g))
        self.fuse_b = nn.Parameter(torch.zeros(c)) if bias else None

    def tree(self) -> Dict[str, Any]:
        out = {"b1": self.b1.tree(), "b2": self.b2.tree(), "fuse": self.fuse}
        if self.fuse_b is not None:
            out["fuse_b"] = self.fuse_b
        return out


class ESSR(nn.Module):
    """The C54 supernet. He-normal weights and zero biases, drawn from
    ``generator`` (a fresh one seeded with 0 when None)."""

    def __init__(self, cfg: ESSRConfig = ESSR_X4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        c = cfg.channels
        self.first = BSConv(cfg.in_channels, c, cfg.bias, g)
        self.sfbs = nn.ModuleList(SFB(c, cfg.bias, g) for _ in range(cfg.n_sfb))
        self.recon = DSConv(c, cfg.out_channels, cfg.bias, g)

    def tree(self) -> Dict[str, Any]:
        """The reference's param tree over this module's tensors."""
        return {"first": self.first.tree(),
                "sfbs": [s.tree() for s in self.sfbs],
                "recon": self.recon.tree()}

    def forward(self, x: torch.Tensor, width: Optional[int] = None) -> torch.Tensor:
        return essr_forward(self.tree(), x, self.cfg, width=width)


def init_essr(cfg: ESSRConfig = ESSR_X4, generator: Optional[torch.Generator] = None) -> ESSR:
    """A fresh supernet: He-normal weights and zero biases drawn from
    ``generator`` (seeded with 0 when None), on the CPU. Weights equal to
    the reference's come through `models.convert.params_from_numpy`."""
    return ESSR(cfg, generator=generator)


# ---------------------------------------------------------------------------
# supernet width slicing
# ---------------------------------------------------------------------------

def _slice_bsconv(p: Dict[str, Any], cin: Optional[int], cout: int) -> Dict[str, Any]:
    out = {"pw": p["pw"][:, :, :cin, :cout] if cin is not None else p["pw"][..., :cout],
           "dw": p["dw"][..., :cout]}
    if "pw_b" in p:
        out["pw_b"] = p["pw_b"][:cout]
        out["dw_b"] = p["dw_b"][:cout]
    return out


def slice_width(params: Dict[str, Any], width: int) -> Dict[str, Any]:
    """The weight-shared subnet of channel width ``width`` (views). The recon
    DSConv keeps its full 3*s^2 outputs, as pixel shuffle needs them."""
    w = width
    sfbs = []
    for p in params["sfbs"]:
        s = {"b1": _slice_bsconv(p["b1"], w, w), "b2": _slice_bsconv(p["b2"], w, w),
             "fuse": p["fuse"][:, :, :w, :w]}
        if "fuse_b" in p:
            s["fuse_b"] = p["fuse_b"][:w]
        sfbs.append(s)
    recon = {"dw": params["recon"]["dw"][..., :w], "pw": params["recon"]["pw"][:, :, :w, :]}
    if "dw_b" in params["recon"]:
        recon["dw_b"] = params["recon"]["dw_b"][:w]
        recon["pw_b"] = params["recon"]["pw_b"]
    return {"first": _slice_bsconv(params["first"], None, w), "sfbs": sfbs, "recon": recon}


# ---------------------------------------------------------------------------
# plain forward
# ---------------------------------------------------------------------------

def sfb_forward(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    y = torch.relu(L.bsconv(p["b1"], x))
    y = torch.relu(L.bsconv(p["b2"], y))
    return torch.relu(L.pointwise(y + x, p["fuse"], p.get("fuse_b")))


def essr_forward(params: Dict[str, Any], x: torch.Tensor, cfg: ESSRConfig = ESSR_X4,
                 width: Optional[int] = None) -> torch.Tensor:
    """x: (N,H,W,3) in [0,1] -> (N,H*s,W*s,3). ``width``: None or
    cfg.channels -> C54; cfg.channels//2 -> C27; 0 -> bilinear."""
    if width == 0:
        return L.bilinear_resize(x, cfg.scale)
    if width is not None and width != cfg.channels:
        params = slice_width(params, width)
    f = L.bsconv(params["first"], x)
    for p in params["sfbs"]:
        f = sfb_forward(p, f)
    return L.pixel_shuffle(L.dsconv(params["recon"], f), cfg.scale)


# ---------------------------------------------------------------------------
# exact parameter / MAC accounting
# ---------------------------------------------------------------------------

def essr_param_count(cfg: ESSRConfig) -> int:
    c, b = cfg.channels, (1 if cfg.bias else 0)
    first = cfg.in_channels * c + b * c + 9 * c + b * c
    sfb = 2 * (c * c + b * c + 9 * c + b * c) + c * c + b * c
    recon = 9 * c + b * c + c * cfg.out_channels + b * cfg.out_channels
    return first + cfg.n_sfb * sfb + recon


def essr_macs_per_lr_pixel(cfg: ESSRConfig, width: Optional[int] = None) -> int:
    """Multiply-accumulates per LR pixel (bias adds not counted)."""
    if width == 0:
        return 4 * cfg.in_channels * cfg.scale * cfg.scale
    c = width if width is not None else cfg.channels
    first = cfg.in_channels * c + 9 * c
    sfb = 2 * (c * c + 9 * c) + c * c
    recon = 9 * c + c * cfg.out_channels
    return first + cfg.n_sfb * sfb + recon


def essr_macs(cfg: ESSRConfig, lr_hw, width: Optional[int] = None) -> int:
    """Multiply-accumulates of one (H, W) LR frame at ``width``."""
    return essr_macs_per_lr_pixel(cfg, width) * int(lr_hw[0]) * int(lr_hw[1])
