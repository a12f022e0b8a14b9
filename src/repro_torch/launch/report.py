"""Render the dry run's records as markdown tables (twin of
``repro.launch.report``), from ``results/dryrun_torch`` or a directory given.

    PYTHONPATH=src python -m repro_torch.launch.report [--mesh single] [--dir DIR]

Every number is a prediction: one rank's counts from ``launch/dryrun.py`` on
the H100 constants of ``launch/roofline.py``, not a measurement.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

from repro_torch.launch.dryrun import RESULTS

ARCH_ORDER = ["grok-1-314b", "deepseek-v3-671b", "seamless-m4t-medium",
              "granite-8b", "qwen2-0.5b", "minitron-8b", "granite-3-2b",
              "falcon-mamba-7b", "zamba2-1.2b", "internvl2-26b", "essr-x4"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k",
               "serve_8k", "train_patch"]


def _fmt_s(x):
    if x == 0:
        return "0"
    if x < 1e-4:
        return f"{x*1e6:.1f}us"
    if x < 0.1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def _dir(results: Optional[str]) -> str:
    return os.path.abspath(results or RESULTS)


def load(mesh: str, tag_filter: str = "", results: Optional[str] = None):
    rows = []
    for f in sorted(glob.glob(os.path.join(_dir(results), mesh, "*.json"))):
        with open(f) as fh:
            d = json.load(fh)
        if (d.get("tag") or "") != tag_filter:
            continue
        rows.append(d)
    key = lambda d: (ARCH_ORDER.index(d["arch"]) if d["arch"] in ARCH_ORDER else 99,  # noqa: E731
                     SHAPE_ORDER.index(d["shape"]) if d["shape"] in SHAPE_ORDER else 99)
    return sorted(rows, key=key)


def _coll_total(coll) -> float:
    return sum(v for k, v in coll.items() if k != "count")


def dryrun_table(mesh: str, results: Optional[str] = None) -> str:
    out = [f"### Mesh: {mesh} "
           + ("(2 pods x 16 x 16 = 512 ranks)" if mesh == "multi" else "(16 x 16 = 256 ranks)"),
           "",
           "| arch | shape | status | lower | bytes/dev | dot-flops/dev | collective B/dev | #colls |",
           "|---|---|---|---|---|---|---|---|"]
    for d in load(mesh, results=results):
        if d["status"] != "ok":
            reason = d.get("reason", d.get("error", ""))[:60]
            out.append(f"| {d['arch']} | {d['shape']} | **{d['status']}** — {reason} | | | | | |")
            continue
        mem = d["memory_per_device"]
        coll = d["collectives_per_device_bytes"]
        out.append(
            f"| {d['arch']} | {d['shape']} | ok | {d['lower_s']:.1f}s "
            f"| {mem['total_gb']:.2f} GB | {d.get('measured_dot_flops_per_device', 0):.3g} "
            f"| {_coll_total(coll):.3g} | {coll['count']} |")
    return "\n".join(out)


def roofline_table(mesh: str, results: Optional[str] = None) -> str:
    out = ["| arch | shape | compute | memory | collective | dominant | MODEL_FLOPS | useful ratio |",
           "|---|---|---|---|---|---|---|---|"]
    for d in load(mesh, results=results):
        if d["status"] != "ok" or "roofline" not in d:
            continue
        r = d["roofline"]
        out.append(
            f"| {d['arch']} | {d['shape']} | {_fmt_s(r['compute_s'])} | {_fmt_s(r['memory_s'])} "
            f"| {_fmt_s(r['collective_s'])} | **{r['dominant']}** "
            f"| {r['model_flops_global']:.3g} | {r['useful_flops_ratio']:.2f} |")
    return "\n".join(out)


def perf_table(arch: str, shape: str, mesh: str = "single", results: Optional[str] = None) -> str:
    """Iteration log rows for one cell (all tags)."""
    files = glob.glob(os.path.join(_dir(results), mesh, f"{arch}__{shape}*.json"))
    rows = []
    for f in sorted(files):
        with open(f) as fh:
            d = json.load(fh)
        if d["status"] != "ok":
            continue
        r = d["roofline"]
        coll = d["collectives_per_device_bytes"]
        rows.append((d.get("tag") or "baseline",
                     f"| {d.get('tag') or 'baseline'} | {_fmt_s(r['compute_s'])} "
                     f"| {_fmt_s(r['memory_s'])} | {_fmt_s(r['collective_s'])} "
                     f"| {d['memory_per_device']['total_gb']:.1f} GB "
                     f"| {_coll_total(coll)/2**40:.2f} TB "
                     f"| {r['useful_flops_ratio']:.2f} |"))
    head = ["| iteration | compute | memory | collective | mem/dev | coll bytes/dev | useful |",
            "|---|---|---|---|---|---|---|"]
    return "\n".join(head + [r[1] for r in sorted(rows)])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both")
    ap.add_argument("--perf", default="")
    ap.add_argument("--dir", default=None, help="records' directory (default results/dryrun_torch)")
    args = ap.parse_args(argv)
    if args.perf:
        arch, shape = args.perf.split(":")
        print(perf_table(arch, shape, results=args.dir))
        return
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for m in meshes:
        print(dryrun_table(m, results=args.dir))
        print()
        print(roofline_table(m, results=args.dir))
        print()


if __name__ == "__main__":
    main()
