#!/usr/bin/env python3
"""Multi-tenant tick latency, synchronous and with two ticks in flight (one
CUDA card).

    python3 scripts/torch_tick_probe.py [--src DIR] [--label NAME] [--rounds R]

Serves chip_smoke.py's phase-23 traffic through ``SREngine.serve_streams``:
four tenants of 960x540 -> 3840x2160 frames (ESSR x4, seed-0 weights,
chip_smoke's mixed content), shares (2, 1, 1, 1), lengths (8, 8, 6, 4), so
the ticks hold 4, 4, 4, 4, 3, 3, 2, 2 live streams; capacity pinned at
(0, 256, 256) a stream. Modes fp32 "layer", fp32 "group" and int8 "group".
After one warm run (the captures), each round serves the traffic with
``plan.inflight`` 1 and then 2 on fresh engines that share the graphs, and
keeps every tick's ``latency_s`` but the first (the marginal tick time in
flight). Printed a mode: the median tick time by live count for each
``inflight``, and the device time of one bare replay of each live count's
graph (CUDA events, median of 20), the least a tick in flight can take.
``--src`` takes the port from another tree's ``src`` (an unpacked older
commit), to compare two trees in one call; the last line is one JSON
object of the numbers.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

from torch_pool_probe import mixed_frame  # noqa: E402

TENANT_HW = (540, 960)
TENANT_FRAMES = (8, 8, 6, 4)
TENANT_SHARES = (2.0, 1.0, 1.0, 1.0)
TENANT_CAPACITY = (0, 256, 256)
LIVE = [sum(t < n for n in TENANT_FRAMES) for t in range(max(TENANT_FRAMES))]


def tick_ms(results):
    """Each tick's latency in ms (the results come tick by tick, LIVE[t] of
    them in tick t, all with the tick's latency)."""
    out, i = [], 0
    for n in LIVE:
        out.append(results[i].latency_s * 1e3)
        i += n
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    sys.path.insert(0, str(Path(args.src).resolve()))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    import tempfile
    from repro_torch.api import ExecutionPlan, SREngine
    from repro_torch.core import pipeline as pl
    from repro_torch.core.adaptive import SwitchingConfig
    from repro_torch.models.essr import ESSRConfig
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{args.label}: card {card.strip()}; src {args.src}")
    stable = SwitchingConfig(frame_high=10 ** 9, frame_low=0)
    tenants = [[mixed_frame(100 * s + i, *TENANT_HW) for i in range(n)]
               for s, n in enumerate(TENANT_FRAMES)]
    model = SREngine.from_config(ESSRConfig(scale=4), seed=0).model
    alphas = tempfile.mkdtemp(prefix="essr_alphas_")
    rows = []
    for qmode, fusion in ((None, "layer"), (None, "group"), ("int8", "group")):
        name = f"{qmode or 'fp32'} {fusion}"
        pl._fused_stream_fn.cache_clear()
        plan = ExecutionPlan(dispatch="fused", quant=qmode, fusion=fusion,
                             capacity=TENANT_CAPACITY, streams=len(tenants),
                             stream_shares=TENANT_SHARES)
        mk = dict(switching=stable, quant_cache=alphas)
        want = list(SREngine(model, plan=plan, **mk).serve_streams(tenants))
        by = {1: {}, 2: {}}
        for _ in range(args.rounds):
            for inflight in (1, 2):
                eng = SREngine(model, plan=plan.replace(inflight=inflight), **mk)
                got = list(eng.serve_streams(tenants))
                if not all(torch.equal(a.image, b.image) for a, b in zip(want, got)):
                    sys.exit(f"{name}: inflight={inflight} differs from the warm run")
                for n, ms in zip(LIVE[1:], tick_ms(got)[1:]):
                    by[inflight].setdefault(n, []).append(ms)
        replay = {}
        for g in pl._fused_stream_fn.values():
            times = []
            for _ in range(20):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                g.graph.replay()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            replay[g.streams] = statistics.median(times)
        row = {"mode": name,
               "sync_ms_by_live": {n: statistics.median(v) for n, v in sorted(by[1].items())},
               "inflight2_ms_by_live": {n: statistics.median(v)
                                        for n, v in sorted(by[2].items())},
               "replay_ms_by_live": dict(sorted(replay.items())),
               "ticks_a_live_count": {n: len(v) for n, v in sorted(by[1].items())}}
        rows.append(row)
        print(f"{args.label}: {json.dumps(row)}")
    print(json.dumps({"label": args.label, "card": card.strip(), "rows": rows}))


if __name__ == "__main__":
    main()
