#!/usr/bin/env python3
"""A/B of the port's quantized SFB kernel (src/repro_torch/csrc/qsfb.cu)
against an earlier version, on one NVIDIA card, in one process.

    git show 64b6ae4:src/repro_torch/csrc/qconv.cu > build/ab/qconv_base.cu
    python3 scripts/torch_qsfb_ab.py build/ab/qconv_base.cu [--variant V.cu[@ROWS:THREADS] ...]
        [--shape ROWS:THREADS ...] [--time] [--frames]

The base source (and each variant) is built with nvcc into build/ab/ under
its own library name and bound with ctypes: its C entry ``qsfb_forward``
takes N, H, W, C, bits, or also the rows a step and the threads of
``qsfb_report`` when the library exports ``qsfb_smem_bytes``. The tree's
kernel is built as the port builds it and launched through the wrapper
``qsfb_fused``. A variant is a probe: it is timed beside the others and its
agreement is reported, not required; ``@ROWS:THREADS`` launches it at
another shape (ROWS 0: the report's rows). A ``--shape`` launches the tree's
kernel with other rows a step and threads than the report's. Then, for
"int8" and "fxp10":
  check   every kernel on the same codes: chip_smoke's calibrated x4 model
          (the first SFB's operands at C54 and C27, its input the chain's
          codes) at N = 7 and 1024 32x32 and at banded and ragged shapes,
          and synthetic extreme operands at C64 (every code and weight at
          +-qmax, some output channels all one sign, so the sums reach
          511^2 * 64 for fxp10); the tree's output torch.equal to the base's
          and to the plain ``qsfb_ref``;
  time    (--time) N = 1024 32x32 patches at C54 and C27, in turns base,
          new, shapes, variants, then the same in reverse; CUDA events,
          median of 25 launches (chip_smoke's ``median_ms``, which counts
          the wrapper's host time when the card waits for it), and beside it
          the mean of 20 launches queued back to back (the card's time);
  frames  (--frames) chip_smoke's three 1920x1080 -> 7680x4320 frames under
          ExecutionPlan(quant=mode) on backend "cuda", served in turns with
          the base kernel, the tree's, the tree's and the base's (the qSFB
          wrapper of the integer chain is swapped); latency per frame,
          images torch.equal between the two kernels, and one profiled frame
          each of the first two turns.
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
MODES = (("int8", 8), ("fxp10", 10))
#: (N, H, W, C) of the checks on the model's operands; C is a subnet width.
SHAPES = ((7, 32, 32, 54), (7, 32, 32, 27), (1024, 32, 32, 54), (1024, 32, 32, 27),
          (2, 40, 72, 54), (3, 13, 21, 27), (1, 33, 32, 54), (2, 17, 9, 54))
#: (N, H, W) of the checks on synthetic extreme operands at C64.
EXTREME = ((7, 32, 32), (2, 40, 72), (3, 13, 21))


def build_source(src: Path):
    """``src`` as build/ab/<stem>.so, built and loaded: (its qsfb_forward,
    whether it takes rows and threads, nvcc's report)."""
    from repro_torch.kernels import _build
    AB_DIR.mkdir(parents=True, exist_ok=True)
    lib = AB_DIR / f"{src.stem}.so"
    cmd = [_build.nvcc_path(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(src)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"FAIL: build of {src}\n{out.stdout}{out.stderr}")
    dll = ctypes.CDLL(str(lib))
    sized = hasattr(dll, "qsfb_smem_bytes")
    raw = dll.qsfb_forward
    raw.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * (7 if sized else 5) \
        + [ctypes.c_void_p]
    raw.restype = ctypes.c_int
    return raw, sized, out.stdout + out.stderr


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=Path, help="an earlier csrc/qconv.cu (or csrc/qsfb.cu)")
    ap.add_argument("--variant", action="append", default=[],
                    help="a probe source [@ROWS:THREADS], timed and compared, not required "
                         "to agree")
    ap.add_argument("--shape", action="append", default=[],
                    help="ROWS:THREADS, the tree's kernel launched at another shape")
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
    from repro_torch.kernels import _build
    from repro_torch.kernels import qconv as tq
    from repro_torch.kernels._launch import stream_of
    from repro_torch.kernels.ref import qsfb_ref

    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    built = {"base": build_source(args.base)}
    variant_shape = {}
    for i, spec in enumerate(args.variant):
        path, _, shape = str(spec).partition("@")
        tag = f"v{i}:{Path(path).stem}" + (f"@{shape}" if shape else "")
        built[tag] = build_source(Path(path))
        if shape:
            variant_shape[tag] = tuple(int(v) for v in shape.split(":"))
    logs = {tag: b[2] for tag, b in built.items()}
    logs["new"] = _build.build(["qsfb"])["qsfb"]
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for tag, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry function" in line and "qsfb" in line:
                print(f"  ptxas {tag}: {line.split(chr(39))[1][:90]}")
            if "registers" in line or "spill" in line:
                print(f"  ptxas {tag}: {line.strip()}")

    def launcher(tag, raw, sized, shape=None):
        """The kernel as f(xq, q, qc); a launch shape whose block does not
        fit gives None."""
        def run(xq, q, qc):
            out = torch.empty_like(xq)
            n, h, w, c = xq.shape
            bits = tq._code_bits(xq.dtype)
            extra = ()
            if sized:
                rep = tq.qsfb_report(c, h, w, bits)
                extra = ((shape[0] or rep["rows_per_step"], shape[1]) if shape
                         else (rep["rows_per_step"], rep["threads"]))
                if lib.qsfb_smem_bytes(w, c, bits, extra[0]) > rep["smem_limit"]:
                    return None
            err = raw(xq.data_ptr(), *(q[k].data_ptr() for k in tq.QSFB_KEYS), qc.data_ptr(),
                      out.data_ptr(), n, h, w, c, bits, *extra, stream_of(xq))
            if err:
                sys.exit(f"FAIL: {tag} launch error {err}")
            return out
        return run

    lib = _build.load("qsfb")
    lib.qsfb_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.qsfb_smem_bytes.restype = ctypes.c_longlong
    kernels = {tag: launcher(tag, raw, sized, variant_shape.get(tag))
               for tag, (raw, sized, _) in built.items()}
    kernels["new"] = tq.qsfb_fused
    new_raw = _build.entry("qsfb", "qsfb_forward", 17, 7)
    for spec in args.shape:
        rows, threads = (int(v) for v in spec.split(":"))
        kernels[f"s{rows}x{threads}"] = launcher(f"s{rows}x{threads}", new_raw, True,
                                                 (rows, threads))
    base = kernels["base"]
    probes = [t for t in kernels if t.startswith(("v", "s"))]

    def queued_ms(fn, runs=20):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(runs):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / runs

    g = torch.Generator().manual_seed(cs.SEED)
    for mode, bits in MODES:
        _, pack, qs, _ = cs.quant_setup(mode, g, torch)

        def model_operands(n, h, w, c):
            """The first SFB's operands at width c; its input: the chain's
            codes on random patches."""
            q = qs[c]
            x = torch.rand((n, h, w, 3), generator=g).cuda()
            return cs.quant_stages(q, x, bits, torch)[2][3], q["sfbs"][0], q["sfbs"][0]["qc"]

        cases = [(f"model N={n} {h}x{w} C{c}", *model_operands(n, h, w, c))
                 for n, h, w, c in SHAPES]
        cases += [(f"extreme N={n} {h}x{w} C64", *cs.qsfb_extreme_operands(n, h, w, 64, bits, g,
                                                                           torch))
                  for n, h, w in EXTREME]
        for label, xq, q, qc in cases:
            n, h, w, c = xq.shape
            a, b = base(xq, q, qc), tq.qsfb_fused(xq, q, qc)
            torch.cuda.synchronize()
            want = qsfb_ref(xq, q, qc)
            same, exact = torch.equal(a, b), torch.equal(b, want)
            rep = tq.qsfb_report(c, h, w, bits)
            smem = lib.qsfb_smem_bytes(w, c, bits, rep["rows_per_step"])
            print(f"check {mode} {label}: new torch.equal base {same}, torch.equal plain {exact} "
                  f"(max {(b.long() - want.long()).abs().max().item()} codes apart; nonzero "
                  f"share {(want != 0).float().mean().item():.3f}); qsfb_report {rep}; "
                  f"qsfb_smem_bytes {smem}", flush=True)
            if not (same and exact) or smem != rep["smem_bytes"]:
                sys.exit("FAIL: the kernels disagree")
            for tag in probes:
                v = kernels[tag](xq, q, qc)
                torch.cuda.synchronize()
                print(f"  probe {tag}: " + ("does not fit" if v is None else
                                            f"torch.equal plain {torch.equal(v, want)}"),
                      flush=True)

        if args.time:
            for c in (54, 27):
                xq, q, qc = model_operands(1024, 32, 32, c)
                order = ["base", "new", *(p for p in probes if kernels[p](xq, q, qc) is not None)]
                t = {tag: [] for tag in order}
                for tag in order + order[::-1]:
                    fn = kernels[tag]
                    t[tag].append(cs.median_ms(lambda: fn(xq, q, qc), torch))
                    t[tag].append(queued_ms(lambda: fn(xq, q, qc)))
                print(f"time {mode} N=1024 32x32 C{c} ({', '.join(order)}, then reversed; "
                      f"median (queued)): "
                      + ", ".join(f"{tag} {v[0]:.4f} ({v[1]:.4f}) / {v[2]:.4f} ({v[3]:.4f}) ms"
                                  for tag, v in t.items())
                      + f"; new/base {statistics.mean(t['new'][::2]) / statistics.mean(t['base'][::2]):.3f}"
                      f" [{card}]", flush=True)
        del qs, cases
        torch.cuda.empty_cache()

    if args.frames:
        from repro_torch.api import ExecutionPlan, SREngine
        from repro_torch.models.essr import ESSRConfig
        engine = SREngine.from_config(ESSRConfig(scale=4), seed=cs.SEED, device="cuda")
        frames = [cs.mixed_frame(cs.SEED + i) for i in range(3)]
        for mode, _ in MODES:
            qeng = SREngine(engine.model, plan=ExecutionPlan(quant=mode), device="cuda")
            images = {}
            for turn, tag in enumerate(("base", "new", "new", "base")):
                tq.qsfb_fused = kernels[tag]
                qeng.warmup((1080, 1920))
                lats = []
                for i, f in enumerate(frames):
                    r = qeng.upscale(f)
                    lats.append(r.latency_s)
                    if i not in images:
                        images[i] = r.image
                    elif not torch.equal(images[i], r.image):
                        sys.exit(f"FAIL: {mode} frame {i} differs between the kernels")
                print(f"frames {mode} turn {turn} ({tag}): latency "
                      + " / ".join(f"{v * 1e3:.2f}" for v in lats) + f" ms [{card}]", flush=True)
                if turn < 2:
                    cs.profile_frame(qeng, frames[1], statistics.median(lats), torch)
            tq.qsfb_fused = kernels["new"]
            print(f"frames {mode}: every image torch.equal between the base and the new kernel")
            del qeng
            torch.cuda.empty_cache()
    print(f"ok [{card}]")


if __name__ == "__main__":
    main()
