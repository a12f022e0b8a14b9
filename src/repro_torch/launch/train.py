"""Training launcher (twin of ``repro.launch.train``'s ESSR mode).

``--arch essr-x4`` (the default, any ``essr*``): the paper's workload,
sampled-subnet supernet training (the PSNR phase; ``--gan-steps`` adds the
perceptual phase), checkpointed in the reference's layout, then PSNR_Y of
the EMA weights on a held-out synthetic image per subnet. The LM archs
belong to the LM side, which is not ported yet.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 200 --batch 16
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3 \\
        --batch 2 --patch 8 --scale 2
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch


def train_essr(args) -> None:
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.synthetic import degrade, patch_batches, random_image
    from repro_torch.models.essr import ESSRConfig, essr_forward, init_essr
    from repro_torch.train import optimizer as O
    from repro_torch.train.losses import psnr_y
    from repro_torch.train.trainer import train_essr_supernet

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card is visible; pass --device cpu to train on the CPU")
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
                    help="the reference's LM smoke run; accepted for the same command line, "
                         "no effect until the LM side is ported (ROADMAP item 16)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "essr_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.arch.startswith("essr"):
        raise SystemExit(f"--arch {args.arch}: the LM archs belong to the LM side, which is not "
                         f"ported yet (ROADMAP queue 1, item 16)")
    train_essr(args)


if __name__ == "__main__":
    main()
