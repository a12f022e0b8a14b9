"""Training launcher (twin of ``repro.launch.train``).

``--arch essr-x4`` (the default, any ``essr*``): the paper's workload,
sampled-subnet supernet training (the PSNR phase; ``--gan-steps`` adds the
perceptual phase), checkpointed in the reference's layout, then PSNR_Y of
the EMA weights on a held-out synthetic image per subnet.

Any other ``--arch`` (the LM side's ``ARCH_NAMES``): the reference's LM
smoke run, `train_lm_smoke`: the arch's SMOKE config, `steps.make_optimizer`,
batch 2 x 32, the loss printed every ``steps // 5``.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 200 --batch 16
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3 \\
        --batch 2 --patch 8 --scale 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b --smoke --steps 5

Both run on the card unless ``--device cpu`` is given; with no card they
raise and do not fall back to the CPU.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card is visible; pass --device cpu to train on the CPU")
    return device


def train_essr(args) -> None:
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.synthetic import degrade, patch_batches, random_image
    from repro_torch.models.essr import ESSRConfig, essr_forward, init_essr
    from repro_torch.train import optimizer as O
    from repro_torch.train.losses import psnr_y
    from repro_torch.train.trainer import train_essr_supernet

    device = _device(args.device)
    cfg = ESSRConfig(scale=args.scale)
    model = init_essr(cfg, torch.Generator().manual_seed(args.seed)).to(device)
    data = patch_batches(args.seed, batch=args.batch, lr_patch=args.patch, scale=args.scale,
                         pool=8, pool_hw=128, device=device)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)

    t0 = time.time()
    model, ema, hist = train_essr_supernet(
        model, cfg, data, steps=args.steps, opt=O.lamb(O.cosine_decay(args.lr, args.steps)),
        seed=args.seed, log_every=max(1, args.steps // 10))
    print(f"PSNR phase: {args.steps} steps in {time.time()-t0:.1f}s "
          f"(loss {hist[0]:.4f} -> {np.mean(hist[-10:]):.4f})")
    ckpt.save(args.steps, {"params": model.tree(), "ema": ema}, blocking=True)

    if args.gan_steps:
        from repro_torch.train.gan import train_essr_gan
        model, _, _ = train_essr_gan(model, cfg, data, steps=args.gan_steps, seed=args.seed,
                                     log_every=max(1, args.gan_steps // 5))
        ckpt.save(args.steps + args.gan_steps, {"params": model.tree(), "ema": ema},
                  blocking=True)

    # eval: PSNR_Y of the EMA weights on a held-out synthetic image, per subnet
    hr = torch.from_numpy(random_image(args.seed + 9999, 128, 128)).to(device)
    lr = degrade(hr.cpu(), args.scale).to(device)
    with torch.no_grad():
        for width in cfg.subnet_widths():
            sr = essr_forward(ema, lr[None], cfg, width=width)[0]
            print(f"  eval width={width:2d}: PSNR_Y {float(psnr_y(sr, hr)):.2f} dB")
    print(f"checkpoints in {args.ckpt_dir}")


def train_lm_smoke(args) -> None:
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps as ST
    from repro_torch.models.lm import encdec as E
    from repro_torch.models.lm import transformer as T
    device = _device(args.device)
    cfg = get_config(args.arch, smoke=True)
    opt = ST.make_optimizer()
    step = ST.make_train_step(cfg, opt, remat=False)
    ST.abstract_train_state(cfg, opt)   # shape-checks cfg before init
    gen = torch.Generator(device=device).manual_seed(args.seed)
    init = E.init_encdec if cfg.is_encoder_decoder else T.init_lm
    p = init(cfg, generator=gen, device=device)
    state = {"params": p, "opt": opt.init(p.tree())}
    b, s = 2, 32
    # the reference draws tokens and labels from one key: they are equal
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=device)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = torch.randn((b, s, cfg.d_model), generator=gen,
                                          device=device).to(torch.bfloat16)
    if cfg.frontend == "vision":
        batch["embeds"] = torch.randn((b, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
                                      device=device).to(torch.bfloat16)
    for i in range(args.steps):
        state, metrics = step(state, batch)
        if i % max(1, args.steps // 5) == 0:
            print(f"step {i}: loss {float(metrics['loss']):.4f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="essr-x4")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--gan-steps", type=int, default=0)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--patch", type=int, default=24)
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's flag; an LM arch always trains its SMOKE config, "
                         "as the reference's launcher does")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "essr_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.arch.startswith("essr"):
        train_essr(args)
    else:
        train_lm_smoke(args)


if __name__ == "__main__":
    main()
