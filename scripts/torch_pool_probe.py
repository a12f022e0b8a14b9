#!/usr/bin/env python3
"""Device memory of the port's fused graphs against the number of capacity
profiles (one CUDA card).

    python3 scripts/torch_pool_probe.py [--src DIR] [--profiles K] [--label NAME]

Serves one 1920x1080 -> 7680x4320 frame (ESSR x4, seed-0 weights, chip_smoke's
mixed content: counts (1152, 576, 576)) under ``dispatch="fused"`` with K
distinct pinned capacity profiles, (0, 1024 + 128 j, 1024) for j = 0..K-1
(no spills), one after another, so the engine holds K captured graphs. After
each it prints ``torch.cuda.memory_reserved`` and ``memory_allocated``, the
graph's ``pool_bytes``, and whether the fused image is ``torch.equal`` to
the host-dispatch image. ``--src`` takes the port from another tree's
``src`` (an unpacked older commit), to compare two trees in one call; the
last line is one JSON object of the numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def mixed_frame(seed: int, h: int = 1080, w: int = 1920):
    """chip_smoke.py's content: a smooth left half, a mildly and a strongly
    textured quarter, from a numpy seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                         np.linspace(0, 1, w, dtype=np.float32), indexing="ij")
    smooth = np.stack([yy, xx, (yy + xx) / 2], axis=-1)
    amp = np.where(xx < 0.5, 0.0, np.where(xx < 0.75, 0.12, 0.5)).astype(np.float32)
    noise = rng.random((h, w, 3), dtype=np.float32) - 0.5
    return np.clip(smooth + amp[..., None] * noise, 0.0, 1.0).astype(np.float32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--profiles", type=int, default=6)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    sys.path.insert(0, str(Path(args.src).resolve()))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    from repro_torch.api import ExecutionPlan, SREngine
    from repro_torch.core import pipeline as pl
    from repro_torch.models.essr import ESSRConfig
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{args.label}: card {card.strip()}; src {args.src}")
    frame = mixed_frame(0)
    host = SREngine.from_config(ESSRConfig(scale=4), seed=0)
    want = host.upscale(frame).image
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    rows = []
    engines = []
    for j in range(args.profiles):
        plan = ExecutionPlan(dispatch="fused", capacity=(0, 1024 + 128 * j, 1024))
        eng = SREngine(host.model, plan=plan)
        r = eng.upscale(frame)
        torch.cuda.synchronize()
        graph = pl._fused_frame_fn.values()[-1]
        row = {"profiles": j + 1, "reserved_mib": (torch.cuda.memory_reserved() - base) / 2 ** 20,
               "allocated_mib": torch.cuda.memory_allocated() / 2 ** 20,
               "pool_mib": graph.pool_bytes / 2 ** 20,
               "equal_to_host": bool(torch.equal(r.image, want)), "spills": r.spill_counts}
        rows.append(row)
        engines.append(eng)
        print(f"{args.label}: {row}")
        del r
    growth = [b["reserved_mib"] - a["reserved_mib"] for a, b in zip(rows, rows[1:])]
    print(json.dumps({"label": args.label, "card": card.strip(), "rows": rows,
                      "growth_per_profile_mib": growth}))


if __name__ == "__main__":
    main()
