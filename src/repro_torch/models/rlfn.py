"""RLFN, the paper's reference model (Sec. III-A), and its pruned variant
(twin of ``repro.models.rlfn``).

RLFN = conv3 -> N x RLFB -> conv3 -> +global shortcut -> conv3 upsampler ->
pixel shuffle. RLFB = 3 x (conv3 + ReLU) -> +local shortcut -> conv1 -> ESA.
The paper's fair-comparison baseline is the pruned RLFN: 4 RLFBs, channels
52 -> 46. Its convolutions are PyTorch's own (cuDNN on the card), as the
reference's are ``lax`` convolutions outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class RLFNConfig:
    channels: int = 52
    n_blocks: int = 6
    esa_channels: int = 16
    scale: int = 4
    in_channels: int = 3


RLFN_BASE_X2 = RLFNConfig(scale=2)
RLFN_BASE_X4 = RLFNConfig(scale=4)
RLFN_PRUNED_X2 = RLFNConfig(channels=46, n_blocks=4, scale=2)
RLFN_PRUNED_X4 = RLFNConfig(channels=46, n_blocks=4, scale=4)


class ESA(nn.Module):
    """Enhanced spatial attention: reduce (1x1), a stride-2 conv, 7x7 max
    pool, conv, bilinear back up, plus a 1x1 skip, expand to a sigmoid gate."""

    def __init__(self, c: int, f: int, g: torch.Generator):
        super().__init__()
        self.c1 = L.ConvWeights(1, c, f, g)
        self.cf = L.ConvWeights(1, f, f, g)
        self.c2 = L.ConvWeights(3, f, f, g)
        self.c3 = L.ConvWeights(3, f, f, g)
        self.c4 = L.ConvWeights(1, f, c, g)

    def tree(self) -> Dict[str, Any]:
        return {k: getattr(self, k).tree() for k in ("c1", "cf", "c2", "c3", "c4")}


class RLFB(nn.Module):
    def __init__(self, c: int, f: int, g: torch.Generator):
        super().__init__()
        self.c1 = L.ConvWeights(3, c, c, g)
        self.c2 = L.ConvWeights(3, c, c, g)
        self.c3 = L.ConvWeights(3, c, c, g)
        self.fuse = L.ConvWeights(1, c, c, g)
        self.esa = ESA(c, f, g)

    def tree(self) -> Dict[str, Any]:
        return {"c1": self.c1.tree(), "c2": self.c2.tree(), "c3": self.c3.tree(),
                "fuse": self.fuse.tree(), "esa": self.esa.tree()}


class RLFN(nn.Module):
    """RLFN's weights in the reference's tree layout: He-normal weights and
    zero biases drawn from ``generator`` (a fresh one seeded with 0 when
    None)."""

    def __init__(self, cfg: RLFNConfig = RLFN_PRUNED_X4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        c = cfg.channels
        self.head = L.ConvWeights(3, cfg.in_channels, c, g)
        self.blocks = nn.ModuleList(RLFB(c, cfg.esa_channels, g) for _ in range(cfg.n_blocks))
        self.mid = L.ConvWeights(3, c, c, g)
        self.up = L.ConvWeights(3, c, cfg.in_channels * cfg.scale ** 2, g)

    def tree(self) -> Dict[str, Any]:
        return {"head": self.head.tree(), "blocks": [b.tree() for b in self.blocks],
                "mid": self.mid.tree(), "up": self.up.tree()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rlfn_forward(self.tree(), x, self.cfg)


def init_rlfn(cfg: RLFNConfig = RLFN_PRUNED_X4,
              generator: Optional[torch.Generator] = None) -> RLFN:
    """A fresh RLFN on the CPU; weights equal to the reference's come
    through `models.convert.rlfn_from_numpy`."""
    return RLFN(cfg, generator)


def _conv(t: torch.Tensor, p: Dict[str, Any], stride: int = 1) -> torch.Tensor:
    return L.conv2d(t, p["w"], p["b"], stride=stride)


def _max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``reduce_window(max, k x k, stride, "SAME")`` on NHWC: -inf pads as
    XLA places them (the floor half of the total before), which
    ``max_pool2d``'s symmetric ``padding`` cannot express."""
    (pt, pb), (pl, pr) = (L._same_pads(int(x.shape[1]), k, stride),
                          L._same_pads(int(x.shape[2]), k, stride))
    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb), value=float("-inf"))
    return F.max_pool2d(xp, k, stride).permute(0, 2, 3, 1)


def esa_forward(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    _, h, w, _ = x.shape
    f = _conv(x, p["c1"])
    v = _conv(f, p["c2"], stride=2)
    v = _conv(_max_pool_same(v, 7, 3), p["c3"])
    v = F.interpolate(v.permute(0, 3, 1, 2), size=(int(h), int(w)), mode="bilinear",
                      align_corners=False).permute(0, 2, 3, 1)
    v = v + _conv(f, p["cf"])
    return x * torch.sigmoid(_conv(v, p["c4"]))


def rlfb_forward(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    y = torch.relu(_conv(x, p["c1"]))
    y = torch.relu(_conv(y, p["c2"]))
    y = torch.relu(_conv(y, p["c3"]))
    return esa_forward(p["esa"], _conv(y + x, p["fuse"]))


def rlfn_forward(params: Dict[str, Any], x: torch.Tensor, cfg: RLFNConfig) -> torch.Tensor:
    """x: (N,H,W,3) in [0,1] -> (N,H*s,W*s,3)."""
    f0 = _conv(x, params["head"])
    f = f0
    for p in params["blocks"]:
        f = rlfb_forward(p, f)
    f = _conv(f, params["mid"]) + f0                     # global shortcut
    return L.pixel_shuffle(_conv(f, params["up"]), cfg.scale)


def rlfn_macs_per_lr_pixel(cfg: RLFNConfig) -> int:
    """MACs per LR pixel (ESA's downsampled interior counted at 1/4 area)."""
    c, f = cfg.channels, cfg.esa_channels
    esa = c * f + f * f + 9 * f * f // 4 + 9 * f * f // 4 + f * c
    block = 3 * 9 * c * c + c * c + esa
    head = 9 * cfg.in_channels * c
    mid = 9 * c * c
    up = 9 * c * cfg.in_channels * cfg.scale ** 2
    return head + cfg.n_blocks * block + mid + up
