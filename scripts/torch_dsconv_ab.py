#!/usr/bin/env python3
"""A/B of the port's DSConv band walker (src/repro_torch/csrc/dsconv.cu: fp32
DSConv and the quantized qDSConv) against earlier versions, on one NVIDIA
card, in one process.

    mkdir -p build/base/ds20
    git show abc345d:src/repro_torch/csrc/dsconv.cu > build/base/ds20/dsconv_base.cu
    git show abc345d:src/repro_torch/csrc/qconv.cu > build/base/ds20/qconv_base.cu
    python3 scripts/torch_dsconv_ab.py build/base/ds20/dsconv_base.cu \\
        build/base/ds20/qconv_base.cu [--variant V.cu ...] [--shape ROWS:THREADS ...]
        [--time] [--frames]

The bases are built with nvcc into build/ab/ under their own library names
and bound with ctypes: the fp32 base's ``dsconv_forward`` and the quantized
base's ``qdsconv_forward`` (8x8-tile kernels that take no launch shape). The
tree's kernels are built as the port builds them and launched through the
wrappers ``dsconv_fused`` and ``qdsconv_fused``. A variant is a probe: a
copy of the tree's dsconv.cu with one stage cut, launched at
``dsconv_report``'s shape; it is timed beside the others and its agreement is
reported, not required. A ``--shape`` launches the tree's kernel with other
rows a step and threads than the report's.
  check   fp32 at C54 and C27 (chip_smoke's He-normal operands, non-zero
          biases) at SHAPES: the tree's output torch.equal to the base's and
          within rtol 1e-4 / atol 1e-5 of the plain ``dsconv_ref``; qDSConv
          for "int8" and "fxp10" on chip_smoke's calibrated x4 model (the
          recon's operands, its input the plain chain's codes at 32x32, codes
          spread over the lattice elsewhere): torch.equal to the base's and to
          the plain ``qdsconv_ref``;
  time    (--time) N = 1024 32x32 patches at C54 and C27, in turns base, new,
          variants, then the same in reverse; CUDA events, median of 25
          launches (chip_smoke's ``median_ms``) and beside it the mean of 20
          launches queued back to back (the card's time);
  frames  (--frames) chip_smoke's three 1920x1080 -> 7680x4320 frames under
          ExecutionPlan() (fp32) and ExecutionPlan(quant=mode) on backend
          "cuda", served in turns with the base kernel, the tree's, the
          tree's and the base's (the DSConv / qDSConv wrapper of the layer
          chain is swapped); latency per frame, images torch.equal between the
          two kernels, one profiled frame each of the first two turns.
Every timing line names the card as nvidia-smi prints it. Exits non-zero on
any mismatch, and without CUDA.
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
#: (N, H, W) of the checks: the main path's 32x32, ragged steps and odd
#: widths, Table I's 64 and an 80x80 patch cut into three column bands.
SHAPES = ((7, 32, 32), (1024, 32, 32), (3, 13, 21), (2, 17, 9), (2, 64, 64), (1, 80, 80))


def build_source(src: Path, tag: str):
    """``src`` as build/ab/<tag>.so, built and loaded: (the library, nvcc's
    report)."""
    from repro_torch.kernels import _build
    AB_DIR.mkdir(parents=True, exist_ok=True)
    lib = AB_DIR / f"{tag}.so"
    cmd = [_build.nvcc_path(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(src)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"FAIL: build of {src}\n{out.stdout}{out.stderr}")
    return ctypes.CDLL(str(lib)), out.stdout + out.stderr


def bind(dll, name: str, n_ptrs: int, n_ints: int):
    raw = getattr(dll, name)
    raw.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    raw.restype = ctypes.c_int
    return raw


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=Path, help="an earlier csrc/dsconv.cu (fp32 DSConv)")
    ap.add_argument("qbase", type=Path, help="an earlier csrc/qconv.cu (holding qDSConv)")
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="a probe copy of the tree's dsconv.cu, timed and compared, not "
                         "required to agree")
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
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import qconv as tq
    from repro_torch.kernels._launch import stream_of
    from repro_torch.kernels.dsconv import dsconv_fused, launch_shape
    from repro_torch.kernels.ref import dsconv_ref, qdsconv_ref

    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    base_dll, base_log = build_source(args.base, "dsconv_base")
    qbase_dll, qbase_log = build_source(args.qbase, "qconv_base")
    variants = {f"v{i}:{src.stem}": build_source(src, f"dsconv_v{i}")
                for i, src in enumerate(args.variant)}
    logs = {"base": base_log, "qbase": qbase_log, "new": _build.build(["dsconv"])["dsconv"],
            **{tag: v[1] for tag, v in variants.items()}}
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for tag, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry function" in line and "dsconv" in line:
                print(f"  ptxas {tag}: {line.split(chr(39))[1][:90]}")
            if ("registers" in line or "spill" in line) and (tag != "qbase" or "spill" in line):
                print(f"  ptxas {tag}: {line.strip()}")

    def fp_kernel(raw, sized, shape=None):
        """f(x, w) with w = (dw, dw_b, pw, pw_b), the signature of dsconv_fused."""
        def run(x, w):
            n, h, wd, cin = x.shape
            cout = w[2].shape[-1]
            out = torch.empty((n, h, wd, cout), device=x.device)
            extra = shape or (launch_shape(cin, cout, h, wd, None) if sized else ())
            err = raw(x.data_ptr(), *(t.data_ptr() for t in w), out.data_ptr(), n, h, wd, cin,
                      cout, 0, *extra, stream_of(x))
            if err:
                sys.exit(f"FAIL: launch error {err}")
            return out
        return run

    def q_kernel(raw, sized, shape=None):
        """f(xq, args) with args the six operands of qdsconv_fused after xq."""
        def run(xq, a):
            n, h, wd, cin = xq.shape
            cout = a[3].shape[-1]
            bits = 8 if xq.dtype == torch.int8 else 32
            out = torch.empty((n, h, wd, cout), dtype=xq.dtype, device=xq.device)
            extra = shape or (launch_shape(cin, cout, h, wd, bits) if sized else ())
            err = raw(xq.data_ptr(), *(t.data_ptr() for t in a), out.data_ptr(), n, h, wd, cin,
                      cout, bits, *extra, stream_of(xq))
            if err:
                sys.exit(f"FAIL: launch error {err}")
            return out
        return run

    fp = {"base": fp_kernel(bind(base_dll, "dsconv_forward", 6, 6), False), "new":
          lambda x, w: dsconv_fused(x, *w)}
    qdsconv_fused = tq.qdsconv_fused
    qk = {"base": q_kernel(bind(qbase_dll, "qdsconv_forward", 8, 6), False), "new":
          lambda xq, a: qdsconv_fused(xq, *a)}
    for tag, (dll, _) in variants.items():
        fp[tag] = fp_kernel(bind(dll, "dsconv_forward", 6, 8), True)
        qk[tag] = q_kernel(bind(dll, "qdsconv_forward", 8, 8), True)
    tree = _build.load("dsconv")
    for spec in args.shape:
        shape = tuple(int(v) for v in spec.split(":"))
        fp[f"s{spec}"] = fp_kernel(bind(tree, "dsconv_forward", 6, 8), True, shape)
        qk[f"s{spec}"] = q_kernel(bind(tree, "qdsconv_forward", 8, 8), True, shape)
    probes = [t for t in fp if t[0] in "vs"]

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

    def timed(kernels, fn_of, label):
        order = ["base", "new", *probes]
        t = {tag: [] for tag in order}
        for tag in order + order[::-1]:
            fn = fn_of(kernels[tag])
            t[tag].append(cs.median_ms(fn, torch))
            t[tag].append(queued_ms(fn))
        ratio = statistics.mean(t["new"][::2]) / statistics.mean(t["base"][::2])
        print(f"time {label} ({', '.join(order)}, then reversed; median (queued)): "
              + ", ".join(f"{tag} {v[0]:.4f} ({v[1]:.4f}) / {v[2]:.4f} ({v[3]:.4f}) ms"
                          for tag, v in t.items())
              + f"; new/base {ratio:.3f} [{card}]", flush=True)

    g = torch.Generator().manual_seed(cs.SEED)
    # fp32 DSConv
    for c in (54, 27):
        for n, h, w in SHAPES:
            x, wd = cs.operands("dsconv", n, c, g, torch, hw=(h, w))
            wt = (wd["dw"], wd["dw_b"], wd["pw"], wd["pw_b"])
            a, b = fp["base"](x, wt), fp["new"](x, wt)
            torch.cuda.synchronize()
            want = dsconv_ref(x, *wt)
            same, close = torch.equal(a, b), torch.allclose(b, want, **cs.TOL)
            print(f"check fp32 N={n} {h}x{w} C{c}: new torch.equal base {same}; new vs plain "
                  f"max_abs {(b - want).abs().max().item():.3e} {'ok' if close else 'MISMATCH'}",
                  flush=True)
            if not (same and close):
                sys.exit("FAIL: the fp32 kernels disagree")
            for tag in probes:
                v = fp[tag](x, wt)
                torch.cuda.synchronize()
                print(f"  probe {tag}: torch.equal base {torch.equal(v, a)}")
        if args.time:
            x, wd = cs.operands("dsconv", 1024, c, g, torch)
            wt = (wd["dw"], wd["dw_b"], wd["pw"], wd["pw_b"])
            timed(fp, lambda k: (lambda: k(x, wt)), f"fp32 N=1024 32x32 C{c}")
    # qDSConv, both modes
    for mode, bits in MODES:
        _, pack, qs, _ = cs.quant_setup(mode, g, torch)
        qmax = 127 if bits <= 8 else 511
        for c in (54, 27):
            r = qs[c]["recon"]
            qa = (r["dwq"], r["dw_scale"], r["dwb"], r["pw_fq"], r["pwb"], r["qc"])
            for n, h, w in SHAPES:
                if (h, w) == (32, 32):       # the plain chain's codes
                    x = torch.rand((n, h, w, 3), generator=g).cuda()
                    xq = cs.quant_stages(qs[c], x, bits, torch)[-2][3]
                else:
                    xq = torch.randint(-qmax, qmax + 1, (n, h, w, c), generator=g).to(
                        torch.int8 if bits <= 8 else torch.int32).cuda()
                a, b = qk["base"](xq, qa), qk["new"](xq, qa)
                torch.cuda.synchronize()
                want = qdsconv_ref(xq, *qa)
                same, exact = torch.equal(a, b), torch.equal(b, want)
                print(f"check {mode} N={n} {h}x{w} C{c}: new torch.equal base {same}, "
                      f"torch.equal plain {exact} (nonzero share "
                      f"{(want != 0).float().mean().item():.3f})", flush=True)
                if not (same and exact):
                    sys.exit("FAIL: the qDSConv kernels disagree")
                for tag in probes:
                    v = qk[tag](xq, qa)
                    torch.cuda.synchronize()
                    print(f"  probe {tag}: torch.equal plain {torch.equal(v, want)}")
            if args.time:
                x = torch.rand((1024, 32, 32, 3), generator=g).cuda()
                xq = cs.quant_stages(qs[c], x, bits, torch)[-2][3]
                timed(qk, lambda k: (lambda: k(xq, qa)), f"{mode} N=1024 32x32 C{c}")
        del qs
        torch.cuda.empty_cache()

    def swapped(kernel):
        """``kernel`` with the signature of the wrapper it stands in for."""
        def run(x, *operands, **_):
            return kernel(x, operands)
        run.launches = 0
        return run

    if args.frames:
        from repro_torch.api import ExecutionPlan, SREngine
        from repro_torch.models.essr import ESSRConfig
        engine = SREngine.from_config(ESSRConfig(scale=4), seed=cs.SEED, device="cuda")
        frames = [cs.mixed_frame(cs.SEED + i) for i in range(3)]
        for quant in (None, "int8", "fxp10"):
            eng = SREngine(engine.model, plan=ExecutionPlan(quant=quant), device="cuda")
            images = {}
            for turn, tag in enumerate(("base", "new", "new", "base")):
                if quant:     # the wrapper counts its launches under its module's name
                    tq.qdsconv_fused = swapped(qk[tag])
                else:
                    ops.dsconv_fused = swapped(fp[tag])
                eng.warmup((1080, 1920))
                lats = []
                for i, f in enumerate(frames):
                    res = eng.upscale(f)
                    lats.append(res.latency_s)
                    if i not in images:
                        images[i] = res.image
                    elif not torch.equal(images[i], res.image):
                        sys.exit(f"FAIL: {quant or 'fp32'} frame {i} differs between the kernels")
                print(f"frames {quant or 'fp32'} turn {turn} ({tag}): latency "
                      + " / ".join(f"{v * 1e3:.2f}" for v in lats) + f" ms [{card}]", flush=True)
                if turn < 2:
                    cs.profile_frame(eng, frames[1], statistics.median(lats), torch)
            tq.qdsconv_fused, ops.dsconv_fused = qdsconv_fused, dsconv_fused
            print(f"frames {quant or 'fp32'}: every image torch.equal between the base and the "
                  f"new kernel")
            del eng
            torch.cuda.empty_cache()
    print(f"ok [{card}]")


if __name__ == "__main__":
    main()
