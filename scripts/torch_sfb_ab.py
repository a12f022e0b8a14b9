#!/usr/bin/env python3
"""A/B of the port's fp32 SFB kernel (src/repro_torch/csrc/sfb.cu) against an
earlier version of the same source, on one NVIDIA card, in one process.

    git show <rev>:src/repro_torch/csrc/sfb.cu > build/ab/sfb_base.cu
    python3 scripts/torch_sfb_ab.py build/ab/sfb_base.cu [--variant V.cu ...]
                                    [--time] [--frames]

The base source (and each variant) is built with nvcc into build/ab/ under
its own library name and bound with ctypes: its C entry ``sfb_forward``
takes N, H, W, C, or also the rows a step and the threads of
``sfb_report`` when the library exports ``sfb_smem_bytes``. The tree's
kernel is built as the port builds it. A variant is a probe: it is timed
beside the others and its agreement is reported, not required. Then:
  check   both kernels on the same inputs (non-zero biases, C54 and C27, the
          main path's 32x32 patches and ragged shapes): the tree's output
          torch.equal to the base's, and within rtol 1e-4 / atol 1e-5 of the
          plain ``sfb_ref``;
  time    (--time) N = 1024 32x32 patches at C54 and C27, in turns base,
          new, variants, then the same in reverse; CUDA events, median of 25
          launches (chip_smoke's ``median_ms``);
  frames  (--frames) chip_smoke's three 1920x1080 -> 7680x4320 frames under
          the default plan on backend "cuda", served in turns with the base
          kernel, the tree's, the tree's and the base's (the SFB wrapper of
          the layer chain is swapped); latency per frame, images torch.equal
          between the two kernels, and one profiled frame each.
Every line names the card as nvidia-smi prints it. Exits non-zero on any
mismatch, and without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
AB_DIR = ROOT / "build" / "ab"
SHAPES = ((7, 32, 32, 54), (7, 32, 32, 27), (1024, 32, 32, 54), (1024, 32, 32, 27),
          (2, 40, 72, 54), (3, 13, 21, 27), (1, 33, 32, 54), (2, 17, 9, 54))


def build_source(src: Path):
    """``src`` as build/ab/<stem>.so, built and loaded: (its sfb_forward, whether
    it takes rows and threads, nvcc's report)."""
    from repro_torch.kernels import _build
    AB_DIR.mkdir(parents=True, exist_ok=True)
    lib = AB_DIR / f"{src.stem}.so"
    cmd = [_build.nvcc_path(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(src)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"FAIL: build of {src}\n{out.stdout}{out.stderr}")
    dll = ctypes.CDLL(str(lib))
    sized = hasattr(dll, "sfb_smem_bytes")
    raw = dll.sfb_forward
    raw.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * (6 if sized else 4) \
        + [ctypes.c_void_p]
    raw.restype = ctypes.c_int
    return raw, sized, out.stdout + out.stderr


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=Path, help="an earlier csrc/sfb.cu")
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="a probe source, timed and compared, not required to agree")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--frames", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("FAIL: no CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.ref import sfb_ref
    from repro_torch.kernels.sfb import SFB_KEYS, sfb_fused, sfb_report
    from repro_torch.kernels._launch import stream_of

    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    built = {"base": build_source(args.base)}
    built.update({f"v{i}:{src.stem}": build_source(src) for i, src in enumerate(args.variant)})
    logs = {tag: b[2] for tag, b in built.items()}
    logs["new"] = _build.build(["sfb"])["sfb"]
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for tag, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {tag}: {line.strip()}")

    def launcher(tag, raw, sized):
        def run(x, p):
            out = torch.empty_like(x)
            n, h, w, c = x.shape
            extra = ()
            if sized:
                rep = sfb_report(c, h, w)
                extra = (rep["rows_per_step"], rep["threads"])
            err = raw(x.data_ptr(), *(p[k].data_ptr() for k in SFB_KEYS), out.data_ptr(),
                      n, h, w, c, *extra, stream_of(x))
            if err:
                sys.exit(f"FAIL: {tag} launch error {err}")
            return out
        return run

    kernels = {tag: launcher(tag, raw, sized) for tag, (raw, sized, _) in built.items()}
    kernels["new"] = sfb_fused
    base = kernels["base"]
    probes = [t for t in kernels if t.startswith("v")]

    g = torch.Generator().manual_seed(0)

    def operands(n, h, w, c):
        x, p = cs.operands("sfb", n, c, g, torch)
        return torch.rand((n, h, w, c), generator=g).cuda() if (h, w) != (32, 32) else x, p

    for n, h, w, c in SHAPES:
        x, p = operands(n, h, w, c)
        a, b = base(x, p), sfb_fused(x, p)
        torch.cuda.synchronize()
        want = sfb_ref(x, p)
        same = torch.equal(a, b)
        close = torch.allclose(b, want, **cs.TOL)
        print(f"check N={n} {h}x{w} C{c}: new torch.equal base {same}; new vs plain max_abs "
              f"{(b - want).abs().max().item():.3e} {'ok' if close else 'MISMATCH'}; "
              f"sfb_report {sfb_report(c, h, w)}", flush=True)
        if not (same and close):
            sys.exit("FAIL: the kernels disagree")
        for tag in probes:
            v = kernels[tag](x, p)
            torch.cuda.synchronize()
            print(f"  probe {tag}: torch.equal base {torch.equal(v, a)}, max_abs vs plain "
                  f"{(v - want).abs().max().item():.3e} (within rtol 1e-4 / atol 1e-5: "
                  f"{torch.allclose(v, want, **cs.TOL)})")

    if args.time:
        for c in (54, 27):
            x, p = operands(1024, 32, 32, c)
            order = ["base", "new", *probes]
            t = {tag: [] for tag in order}
            for tag in order + order[::-1]:
                fn = kernels[tag]
                t[tag].append(cs.median_ms(lambda: fn(x, p), torch))
            print(f"time N=1024 32x32 C{c} ({', '.join(order)}, then reversed): "
                  + ", ".join(f"{tag} {v[0]:.4f} / {v[1]:.4f} ms" for tag, v in t.items())
                  + f"; new/base {statistics.mean(t['new']) / statistics.mean(t['base']):.3f} "
                  f"[{card}]", flush=True)

    if args.frames:
        from repro_torch.api import SREngine
        from repro_torch.models.essr import ESSRConfig
        engine = SREngine.from_config(ESSRConfig(scale=4), seed=cs.SEED, device="cuda")
        frames = [cs.mixed_frame(cs.SEED + i) for i in range(3)]
        images = {}
        for turn, tag in enumerate(("base", "new", "new", "base")):
            ops.sfb_fused = kernels[tag]
            engine.warmup((1080, 1920))
            lats = []
            for i, f in enumerate(frames):
                r = engine.upscale(f)
                lats.append(r.latency_s)
                if i not in images:
                    images[i] = r.image
                elif not torch.equal(images[i], r.image):
                    sys.exit(f"FAIL: frame {i} differs between the kernels")
            print(f"frames turn {turn} ({tag}): latency "
                  + " / ".join(f"{v * 1e3:.2f}" for v in lats) + f" ms [{card}]", flush=True)
            if turn < 2:
                cs.profile_frame(engine, frames[1], statistics.median(lats), torch)
        ops.sfb_fused = sfb_fused
        print("frames: every image torch.equal between the base and the new kernel")
    print(f"ok [{card}]")


if __name__ == "__main__":
    main()
