"""The perceptual (GAN) training phase, paper Sec. V-A (twin of
``repro.train.gan``).

Starts from the trained PSNR model; the generator's loss is 0.01*L1 +
1*artifact(LDL) + 1*perceptual + 0.005*adversarial, Adam 1e-4 with a
multistep schedule. A compact patch discriminator: four stride-2 3x3 convs
(XLA "SAME" padding, `models.layers.conv2d`) with leaky ReLU, and a 3x3
head averaged to one logit an image.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.supernet import subnet_sampling_probs
from repro_torch.core.tree import tree_map
from repro_torch.models import layers as L
from repro_torch.models.essr import ESSRConfig, essr_forward
from repro_torch.train import losses as Ls
from repro_torch.train import optimizer as O
from repro_torch.train.trainer import _as_tree, true_fp32, value_and_grad


def init_discriminator(generator: Optional[torch.Generator] = None,
                       channels=(32, 64, 64, 128)) -> Dict[str, Any]:
    """He-normal weights and zero biases from ``generator`` (seeded with 0
    when None), on the CPU."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    ps, cin = [], 3
    for c in channels:
        ps.append({"w": L.conv_init((3, 3, cin, c), g), "b": torch.zeros(c)})
        cin = c
    return {"convs": ps, "head": {"w": L.conv_init((3, 3, cin, 1), g), "b": torch.zeros(1)}}


def discriminate(params, x: torch.Tensor) -> torch.Tensor:
    h = x
    for p in params["convs"]:
        h = F.leaky_relu(L.conv2d(h, p["w"], p["b"], stride=2), 0.2)
    return L.conv2d(h, params["head"]["w"], params["head"]["b"]).mean(dim=(1, 2, 3))


def make_gan_steps(cfg: ESSRConfig, g_opt: O.Optimizer, d_opt: O.Optimizer, feat_params,
                   weights=Ls.PERCEPTUAL_WEIGHTS):
    """(g_step, d_step). ``g_step(params, g_state, d_params, lr, hr, *,
    width) -> (params, g_state, sr, loss)``; ``d_step(d_params, d_state, sr,
    hr) -> (d_params, d_state, loss)``. Parameters are updated in place and
    returned; ``sr`` comes back detached."""

    def g_loss(params, d_params, lr_img, hr_img, width: int, out: list):
        sr = essr_forward(params, lr_img, cfg, width=width)
        out.append(sr)
        adv = Ls.g_adv_loss_fn(discriminate(d_params, sr))
        return (weights["l1"] * Ls.l1_loss(sr, hr_img)
                + weights["artifact"] * Ls.artifact_loss(sr, hr_img)
                + weights["perceptual"] * Ls.perceptual_loss(feat_params, sr, hr_img)
                + weights["adv"] * adv)

    def d_loss(d_params, sr, hr_img):
        return Ls.d_loss_fn(discriminate(d_params, hr_img), discriminate(d_params, sr.detach()))

    def g_step(params, g_state, d_params, lr_img, hr_img, *, width: int):
        with true_fp32():
            out = []
            val, grads = value_and_grad(g_loss, params, d_params, lr_img, hr_img, width, out)
            upd, g_state = g_opt.update(grads, g_state, params)
            return O.apply_updates(params, upd), g_state, out[0].detach(), val

    def d_step(d_params, d_state, sr, hr_img):
        with true_fp32():
            val, grads = value_and_grad(d_loss, d_params, sr, hr_img)
            upd, d_state = d_opt.update(grads, d_state, d_params)
            return O.apply_updates(d_params, upd), d_state, val

    return g_step, d_step


def train_essr_gan(params, cfg: ESSRConfig, data: Iterator, steps: int, seed: int = 0,
                   log_every: int = 50, log_fn=print):
    """The perceptual phase's loop. ``params``: an `ESSR` module or its
    tree (trained in place); the discriminator is drawn from ``seed`` and
    the feature net from 7, on the device of the weights. Returns (params,
    discriminator, history of (G, D) losses)."""
    tree = _as_tree(params)
    dev = tree["first"]["pw"].device
    d_params = tree_map(lambda t: t.to(dev),
                        init_discriminator(torch.Generator().manual_seed(seed)))
    feat_params = tree_map(lambda t: t.to(dev),
                           Ls.init_feature_net(torch.Generator().manual_seed(7)))
    g_opt = O.adam(O.multistep(1e-4, [steps // 2, 3 * steps // 4]))
    d_opt = O.adam(O.multistep(1e-4, [steps // 2, 3 * steps // 4]))
    g_state, d_state = g_opt.init(tree), d_opt.init(d_params)
    g_step, d_step = make_gan_steps(cfg, g_opt, d_opt, feat_params)
    rng = np.random.default_rng(seed)
    widths = [w for w in cfg.subnet_widths() if w > 0]
    probs = subnet_sampling_probs(cfg)
    hist = []
    for i in range(steps):
        lr_img, hr_img = next(data)
        width = int(rng.choice(widths, p=probs))
        tree, g_state, sr, gl = g_step(tree, g_state, d_params, lr_img, hr_img, width=width)
        d_params, d_state, dl = d_step(d_params, d_state, sr, hr_img)
        hist.append((float(gl), float(dl)))
        if log_every and (i + 1) % log_every == 0:
            g_m = np.mean([h[0] for h in hist[-log_every:]])
            d_m = np.mean([h[1] for h in hist[-log_every:]])
            log_fn(f"gan step {i+1:5d}  G {g_m:.4f}  D {d_m:.4f}")
    return params, d_params, hist
