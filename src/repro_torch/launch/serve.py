"""Serving launcher: the paper's deployment loop at reduced scale (twin of
``repro.launch.serve``).

Streams synthetic frames through ``SREngine.stream`` (edge scores ->
Algorithm-1 adaptive thresholds -> per-subnet batched ESSR -> overlap and
average) and prints the summary (subnet shares, MAC saving, latency).
``--quant fxp10|int8`` serves the PAMS quantized datapath, ``--dispatch
fused`` each frame as one dispatch (on the card one CUDA graph replay),
``--inflight 2`` keeps two frames in flight, ``--shards N`` routes each
raster strip with its own controller and splits the buckets over up to N
cards (one card, or the CPU, with a warning).

    PYTHONPATH=src python -m repro_torch.launch.serve --frames 4 --hw 96
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --frames 2 \\
        --hw 48 --scale 2 --shards 2
"""
from __future__ import annotations

import argparse
import collections

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--hw", type=int, default=96, help="LR frame size (square)")
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--ckpt", default=None, help="checkpoint dir from train.py")
    ap.add_argument("--budget", type=int, default=25500)
    ap.add_argument("--deadline-ms", type=float, default=0.0)
    ap.add_argument("--backend", default="cuda", choices=("ref", "cuda"),
                    help="forward path: the plain PyTorch model or the CUDA kernels")
    ap.add_argument("--shards", type=int, default=1,
                    help="patch-stream shards (each gets its own Algorithm-1 controller; "
                         "dispatch uses up to this many cards, one with a warning)")
    ap.add_argument("--quant", default="none", choices=("none", "fxp10", "int8"),
                    help="PAMS quantized serving; alphas calibrate at engine construction")
    ap.add_argument("--dispatch", default="host", choices=("host", "fused"),
                    help="host routing (default) or the fused single-dispatch frame")
    ap.add_argument("--inflight", type=int, default=1,
                    help="frames in flight under fused-dispatch streaming (>= 2: one "
                         "frame of control delay)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.api import ExecutionPlan, SREngine
    from repro_torch.core.adaptive import SwitchingConfig
    from repro_torch.data.synthetic import degrade, random_image
    from repro_torch.models.essr import ESSRConfig
    from repro_torch.train.losses import psnr_y

    # frame counts scaled down from 8K: thresholds adapt around the per-frame C54 share
    n_patches = (args.hw // 30 + 1) ** 2
    sw = SwitchingConfig(c54_per_sec_budget=args.budget,
                         frame_high=max(2, int(n_patches * 0.45)),
                         frame_low=max(1, int(n_patches * 0.30)))
    engine = SREngine.from_checkpoint(
        args.ckpt, cfg=ESSRConfig(scale=args.scale), backend=args.backend,
        plan=ExecutionPlan(shards=args.shards,
                           quant=None if args.quant == "none" else args.quant,
                           dispatch=args.dispatch, inflight=args.inflight),
        switching=sw, deadline_s=args.deadline_ms / 1e3 or None, verbose=True,
        device=args.device)
    print(f"serving backend: {engine.backend_label} "
          f"(dispatch={args.dispatch}, inflight={args.inflight})")
    engine.warmup((args.hw, args.hw))      # the printed latencies are steady-state

    # a lazy frame source: only the frames in flight stay alive
    hr_pending = collections.deque()

    def lr_stream():
        for i in range(args.frames):
            hr = torch.from_numpy(random_image(100 + i, args.hw * args.scale,
                                               args.hw * args.scale))
            hr_pending.append(hr)
            yield degrade(hr, args.scale)

    psnrs = []
    for i, res in enumerate(engine.stream(lr_stream())):
        hr = hr_pending.popleft().to(res.image.device)
        psnrs.append(float(psnr_y(res.image, hr)))
        line = f"frame {i}: PSNR_Y {psnrs[-1]:.2f} dB  thresholds={res.thresholds}"
        if res.dispatch == "fused" and any(res.spill_counts):
            line += f"  spilled={res.spill_counts}"
        if res.shard_counts is not None and res.shard_deadline_missed is not None:
            line += (f"  shard_c54={[c[2] for c in res.shard_counts]}"
                     f"  demoted={list(res.shard_deadline_missed)}")
        print(line)
    s = engine.summary()
    print("\nsummary:", {k: v for k, v in s.items()})
    print(f"mean PSNR_Y {np.mean(psnrs):.2f} dB")


if __name__ == "__main__":
    main()
