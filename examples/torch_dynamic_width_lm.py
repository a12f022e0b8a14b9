"""The paper's technique carried over to an LM on the PyTorch/CUDA port:
edge-selective DYNAMIC WIDTH.

    PYTHONPATH=src python examples/torch_dynamic_width_lm.py
    PYTHONPATH=src python examples/torch_dynamic_width_lm.py --device cpu --steps 5

ESSR routes image patches by edge score to weight-shared C27/C54 subnets.
Here tokens are routed by an input statistic (the RMS of the pre-FFN hidden
state, the 'edge score' analog) to the full-width or the half-width slice
of ONE weight-shared FFN (granite-8b's reduced config). The static and the
dynamic-width variants train for a few steps each on synthetic tokens,
and their losses and the FFN's MAC saving are printed. Runs on the card
unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import granite_8b
from repro_torch.launch import steps as ST
from repro_torch.models.lm import transformer as T
from repro_torch.train import optimizer as O


def run(cfg, steps=30, seed=0, device="cuda"):
    """Losses of ``steps`` Adam steps (3e-3, clipped at 1.0) from seeded
    weights, a fresh (4, 32) batch of tokens a step from
    ``np.random.default_rng(seed)``, each its own label, as the reference
    example draws them."""
    params = T.init_lm(cfg, generator=torch.Generator(device=device).manual_seed(seed),
                       device=device)
    opt = O.chain_clip(O.adam(3e-3), 1.0)
    state = {"params": params, "opt": opt.init(params.tree())}
    step = ST.make_train_step(cfg, opt, remat=False)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32))).to(device)
        state, metrics = step(state, {"tokens": toks, "labels": toks})
        losses.append(float(metrics["loss"]))
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card is visible; pass --device cpu to run on the CPU")
    static_cfg = granite_8b.SMOKE
    dyn_cfg = dataclasses.replace(static_cfg, dynamic_width=True)
    print(f"training {args.steps} steps each on synthetic tokens (granite-8b reduced)...")
    ls = run(static_cfg, args.steps, device=args.device)
    ld = run(dyn_cfg, args.steps, device=args.device)
    # FLOPs/token of the FFN: full width F vs 50% tokens at F + 50% at F/2
    f = static_cfg.d_ff
    print(f"static  FFN width {f:4d}: loss {ls[0]:.3f} -> {np.mean(ls[-5:]):.3f}")
    print(f"dynamic (50% @F, 50% @F/2): loss {ld[0]:.3f} -> {np.mean(ld[-5:]):.3f}")
    print(f"FFN MAC saving: {1 - (0.5 + 0.5 * 0.5):.0%} "
          f"(the LM analog of the paper's 50% MAC reduction)")
    print("token 'edge score' = RMS of the pre-FFN hidden state; "
          "width slices share weights exactly like C27 c C54.")


if __name__ == "__main__":
    main()
