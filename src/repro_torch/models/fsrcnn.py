"""FSRCNN, the lightweight baseline of the paper's Tables V/VI (twin of
``repro.models.fsrcnn``).

FSRCNN(d=56, s=12, m=4): conv5(1->d) -> conv1(d->s) -> m x conv3(s->s) ->
conv1(s->d) -> deconv9(d->1, stride=scale), PReLU after each conv. On the
luma channel. Its convolutions are PyTorch's own (cuDNN on the card), as
the reference's are ``lax`` convolutions outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class FSRCNNConfig:
    d: int = 56
    s: int = 12
    m: int = 4
    scale: int = 4


class FSRCNN(nn.Module):
    """FSRCNN's weights in the reference's tree layout: He-normal weights,
    zero biases and PReLU slopes of 0.25, drawn from ``generator`` (a fresh
    one seeded with 0 when None)."""

    def __init__(self, cfg: FSRCNNConfig = FSRCNNConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.feat = L.ConvWeights(5, 1, cfg.d, g, prelu=True)
        self.shrink = L.ConvWeights(1, cfg.d, cfg.s, g, prelu=True)
        self.maps = nn.ModuleList(L.ConvWeights(3, cfg.s, cfg.s, g, prelu=True)
                                  for _ in range(cfg.m))
        self.expand = L.ConvWeights(1, cfg.s, cfg.d, g, prelu=True)
        self.deconv = L.ConvWeights(9, cfg.d, 1, g)

    def tree(self) -> Dict[str, Any]:
        return {"feat": self.feat.tree(), "shrink": self.shrink.tree(),
                "maps": [p.tree() for p in self.maps], "expand": self.expand.tree(),
                "deconv": self.deconv.tree()}

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return fsrcnn_forward(self.tree(), y, self.cfg)


def init_fsrcnn(cfg: FSRCNNConfig = FSRCNNConfig(),
                generator: Optional[torch.Generator] = None) -> FSRCNN:
    """A fresh FSRCNN on the CPU; weights equal to the reference's come
    through `models.convert.fsrcnn_from_numpy`."""
    return FSRCNN(cfg, generator)


def _prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, a * x)


def conv_transpose_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """``lax.conv_transpose(x, w, (s, s), "SAME")`` on NHWC / HWIO: the
    stride-dilated input correlated with the unflipped kernel, padded
    (pad_a, pad_b) by JAX's rule, (H*s, W*s) out. ``F.conv_transpose2d``
    correlates with the flipped kernel, so it is handed ``w`` flipped; its
    symmetric ``padding`` is k - 1 - pad_a, and the output is cropped (or
    extended by ``output_padding``) to JAX's."""
    k, s = int(w.shape[0]), stride
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    pad_b = pad_len - pad_a
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1).flip(-1, -2),
                           stride=s, padding=k - 1 - pad_a,
                           output_padding=max(pad_b - pad_a, 0))
    h, wd = int(x.shape[1]) * s, int(x.shape[2]) * s
    return y[:, :, :h, :wd].permute(0, 2, 3, 1)


def fsrcnn_forward(params: Dict[str, Any], y: torch.Tensor, cfg: FSRCNNConfig) -> torch.Tensor:
    """y: (N,H,W,1) luma in [0,1] -> (N,H*s,W*s,1)."""
    def conv_prelu(t, p):
        return _prelu(L.conv2d(t, p["w"], p["b"]), p["a"])

    t = conv_prelu(y, params["feat"])
    t = conv_prelu(t, params["shrink"])
    for p in params["maps"]:
        t = conv_prelu(t, p)
    t = conv_prelu(t, params["expand"])
    return conv_transpose_same(t, params["deconv"]["w"], cfg.scale) + params["deconv"]["b"]


def fsrcnn_macs_per_lr_pixel(cfg: FSRCNNConfig) -> int:
    """Multiply-accumulates per LR pixel (bias and PReLU not counted); the
    deconvolution's useful ones only: each LR pixel meets the 9x9 kernel
    once per feature channel."""
    return (25 * cfg.d + cfg.d * cfg.s + cfg.m * 9 * cfg.s * cfg.s + cfg.s * cfg.d
            + 81 * cfg.d)
