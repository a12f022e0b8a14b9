"""Quickstart on the PyTorch/CUDA port: edge-selective super-resolution of
one synthetic frame.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Walks the paper's Fig. 1 inference path through the port's `SREngine`:
slim-overlap patches -> edge scores -> threshold routing (bilinear / C27 /
C54, shared weights) -> overlap and average, and prints the routing, the
MAC saving and PSNR_Y. Runs on the card unless ``--device cpu`` is given
(there every kernel takes its plain PyTorch version).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.api import ExecutionPlan, SREngine
from repro_torch.core.subnet_policy import SUBNET_NAMES
from repro_torch.data.synthetic import degrade, random_image
from repro_torch.models.essr import ESSR_X4
from repro_torch.train.losses import psnr_y


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    hr = torch.from_numpy(random_image(0, 256, 256))
    lr = degrade(hr, 4)
    print(f"LR {tuple(lr.shape)} -> SR x4 (paper's ESSR, C={ESSR_X4.channels}, "
          f"{ESSR_X4.n_sfb} SFBs, 53,886 params) on {args.device}")

    # untrained demo weights; SREngine.from_checkpoint loads trained ones
    engine = SREngine.from_config(ESSR_X4, plan=ExecutionPlan(t1=8, t2=40), device=args.device)
    res = engine.upscale(lr)
    hr = hr.to(res.image.device)

    print(f"patches: {res.n_patches}  routing: "
          + ", ".join(f"{n}={c}" for n, c in zip(SUBNET_NAMES, res.counts)))
    print(f"MAC saving vs all-C54: {res.mac_saving:.1%} "
          f"(paper: ~50% on Test8K at thresholds 8/40)")
    print(f"SR image: {tuple(res.image.shape)} ({res.backend}), "
          f"PSNR_Y vs ground truth {float(psnr_y(res.image, hr)):.2f} dB "
          f"(untrained weights: see examples/torch_train_essr.py)")
    bilinear = engine.reference(lr, width=0)     # whole-frame bilinear
    print(f"bilinear reference:      {float(psnr_y(bilinear.image, hr)):.2f} dB")


if __name__ == "__main__":
    main()
