"""Weight-shared supernet training (paper Sec. V-A, after ARM; twin of
``repro.core.supernet``).

One parameter set serves C27 and C54: C27 is the first-27-channel slice
(`models.essr.slice_width`, views). Each iteration samples one subnet with
probability proportional to its MACs and takes the loss on it alone, so the
gradients reach only the selected slice: ARM's update rule. Bilinear has no
parameters and is never sampled.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.models.essr import ESSRConfig, essr_forward, essr_macs_per_lr_pixel


def subnet_sampling_probs(cfg: ESSRConfig) -> np.ndarray:
    """p(subnet) proportional to MACs over the trainable subnets (C27, C54)."""
    widths = [w for w in cfg.subnet_widths() if w > 0]
    macs = np.array([essr_macs_per_lr_pixel(cfg, w) for w in widths], dtype=np.float64)
    return macs / macs.sum()


def sample_width(generator: torch.Generator, cfg: ESSRConfig) -> int:
    """One subnet width drawn from ``generator`` by `subnet_sampling_probs`."""
    widths = [w for w in cfg.subnet_widths() if w > 0]
    p = torch.tensor(subnet_sampling_probs(cfg))
    return widths[int(torch.multinomial(p, 1, generator=generator))]


def supernet_loss_fn(loss: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                     cfg: ESSRConfig):
    """``(params, lr, hr, *, width) -> scalar`` for sampled-subnet training."""

    def fn(params: Dict[str, Any], lr: torch.Tensor, hr: torch.Tensor, *, width: int):
        return loss(essr_forward(params, lr, cfg, width=width), hr)

    return fn


def ema_init(params) -> Any:
    """A detached copy of ``params``: the EMA's first value."""
    return tree_map(lambda x: x.detach().clone(), params)


def ema_update(ema, params, decay: float = 0.999):
    """Exponential moving average of the weights (paper: decay 0.999)."""
    with torch.no_grad():
        return tree_map(lambda e, p: decay * e + (1.0 - decay) * p, ema, params)
