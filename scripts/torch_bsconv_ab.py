#!/usr/bin/env python3
"""A/B of the port's BSConv band walker (src/repro_torch/csrc/bsconv.cu: fp32
BSConv and the quantized qBSConv) against earlier versions, on one NVIDIA
card, in one process.

    mkdir -p build/base/bs21
    git show 2c24998:src/repro_torch/csrc/bsconv.cu > build/base/bs21/bsconv_base.cu
    git show 2c24998:src/repro_torch/csrc/qconv.cu > build/base/bs21/qconv_base.cu
    python3 scripts/torch_bsconv_ab.py build/base/bs21/bsconv_base.cu \\
        build/base/bs21/qconv_base.cu [--variant V.cu ...] [--shape ROWS:THREADS ...]
        [--time] [--frames] [--sass]

A variant is given as V.cu or V.cu@ROWS:THREADS (its own launch shape).

The bases are built with nvcc into build/ab/ under their own library names
and bound with ctypes: the fp32 base's ``bsconv_forward`` and the quantized
base's ``qbsconv_forward`` (8x8-tile kernels that take no launch shape). The
tree's kernels are built as the port builds them and launched through the
wrappers ``bsconv_fused`` and ``qbsconv_fused``. A variant is a probe: a
copy of the tree's bsconv.cu with one stage cut (or its stores switched),
launched at ``bsconv_report``'s shape; it is timed beside the others and its
agreement is reported, not required. A ``--shape`` launches the tree's
kernel with other rows a step and threads than the report's.
  check   fp32 at C54 and C27 (chip_smoke's He-normal operands, non-zero
          biases), the first layer (Cin = 3) and Cin = C, with and without
          ReLU, at SHAPES: the tree's output torch.equal to the base's and
          within rtol 1e-4 / atol 1e-5 of the plain ``bsconv_ref``; qBSConv
          for "int8" and "fxp10" on chip_smoke's calibrated x4 model (the
          first layer's operands, its input the plain chain's codes at 32x32
          and codes spread over the lattice elsewhere; and the first SFB's b1
          group with ReLU at Cin = C): torch.equal to the base's and to the
          plain ``qbsconv_ref``;
  time    (--time) N = 1024 32x32 patches, the first layer at C54 and C27, in
          turns base, new, variants, then the same in reverse; CUDA events,
          median of 25 launches (chip_smoke's ``median_ms``) and beside it the
          mean of 20 launches queued back to back (the card's time);
  frames  (--frames) chip_smoke's three 1920x1080 -> 7680x4320 frames under
          ExecutionPlan() (fp32) and ExecutionPlan(quant=mode) on backend
          "cuda", served in turns with the base kernel, the tree's, the
          tree's and the base's (the BSConv / qBSConv wrapper of the layer
          chain is swapped); latency per frame, images torch.equal between the
          two kernels, one profiled frame each of the first two turns;
  sass    (--sass) the instructions of one __fdiv_rn on sm_90a: two probe
          kernels, o = a / b by __fdiv_rn and o = a * b by __fmul_rn, built
          with the port's flags and read with cuobjdump -sass; the count of
          each on its fast path (up to its first EXIT, without the
          instructions a forward branch skips: the call of the division's
          slow path), their difference plus one (the division in place of
          the multiply) and the division's opcodes.
Every timing line names the card as nvidia-smi prints it. Exits non-zero on
any mismatch, and without CUDA.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
AB_DIR = ROOT / "build" / "ab"
MODES = (("int8", 8), ("fxp10", 10))
#: (N, H, W) of the checks: the main path's 32x32, an 80x80 patch cut into
#: three column bands, 72 wide in three bands, ragged steps, odd widths.
SHAPES = ((7, 32, 32), (1024, 32, 32), (1, 80, 80), (2, 40, 72), (1, 33, 32), (3, 13, 21))
#: The two probe kernels of --sass.
SASS_PROBE = """
extern "C" __global__ void div_rn(const float* a, const float* b, float* o) {
  const int i = threadIdx.x;
  o[i] = __fdiv_rn(a[i], b[i]);
}
extern "C" __global__ void mul_rn(const float* a, const float* b, float* o) {
  const int i = threadIdx.x;
  o[i] = __fmul_rn(a[i], b[i]);
}
"""


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
    dll.essr_error_string.argtypes, dll.essr_error_string.restype = [ctypes.c_int], \
        ctypes.c_char_p
    raw.error = dll.essr_error_string
    return raw


def launch_error(raw, err: int, probe: bool) -> None:
    """A refused launch: fatal for a base, reported for a probe."""
    msg = f"launch error {err} ({raw.error(err).decode()})"
    if not probe:
        sys.exit(f"FAIL: {msg}")
    print(f"  probe: {msg}", flush=True)


def sass_counts() -> None:
    """The --sass probe: instructions of __fdiv_rn against __fmul_rn."""
    from repro_torch.kernels import _build
    AB_DIR.mkdir(parents=True, exist_ok=True)
    src, cubin = AB_DIR / "fdiv_probe.cu", AB_DIR / "fdiv_probe.cubin"
    src.write_text(SASS_PROBE)
    flags = [f for f in _build.FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out = subprocess.run([_build.nvcc_path(), *flags, "-cubin", "-o", str(cubin), str(src)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"FAIL: build of the probe\n{out.stdout}{out.stderr}")
    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc_path()).parent / "cuobjdump")
    dump = subprocess.run([tool, "-sass", str(cubin)], capture_output=True, text=True)
    if dump.returncode != 0:
        sys.exit(f"FAIL: cuobjdump\n{dump.stdout}{dump.stderr}")
    funcs, name = collections.defaultdict(list), None
    for line in dump.stdout.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    (AB_DIR / "fdiv_probe.sass").write_text(dump.stdout)

    def main_path(ins):
        """The instructions to the first EXIT, skipping what a forward
        predicated branch jumps over (the fast path)."""
        ops, skip_to = [], -1
        for addr, i in ins:
            if addr < skip_to or i.startswith("NOP"):
                continue
            ops.append(i)
            m = re.match(r"@\S+\s+BRA\s+(?:`\()?0x([0-9a-f]+)", i)
            if m and int(m.group(1), 16) > addr:
                skip_to = int(m.group(1), 16)
            if re.match(r"(@\S+\s+)?EXIT", i):
                break
        return ops

    div, mul = main_path(funcs["div_rn"]), main_path(funcs["mul_rn"])
    ops = collections.Counter(re.sub(r"^@\S+\s+", "", i).split()[0] for i in div)
    base = collections.Counter(re.sub(r"^@\S+\s+", "", i).split()[0] for i in mul)
    extra = ops - base
    print(f"sass div_rn: {len(div)} instructions on its fast path to its first EXIT, mul_rn "
          f"{len(mul)}: __fdiv_rn takes {len(div) - len(mul) + 1} where __fmul_rn takes 1; the "
          f"division's opcodes beyond the multiply's kernel: {dict(extra)}; the whole div_rn "
          f"function {len(funcs['div_rn'])} instructions (the slow path's call and body "
          f"besides); full dump build/ab/fdiv_probe.sass", flush=True)
    for i in div:
        print(f"  sass div_rn: {i}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=Path, help="an earlier csrc/bsconv.cu (fp32 BSConv)")
    ap.add_argument("qbase", type=Path, help="an earlier csrc/qconv.cu (holding qBSConv)")
    ap.add_argument("--variant", action="append", default=[],
                    help="V.cu[@ROWS:THREADS]: a probe copy of the tree's bsconv.cu, timed and "
                         "compared, not required to agree")
    ap.add_argument("--shape", action="append", default=[],
                    help="ROWS:THREADS, the tree's kernel launched at another shape")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--frames", action="store_true")
    ap.add_argument("--sass", action="store_true")
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
    from repro_torch.kernels.bsconv import bsconv_fused, launch_shape
    from repro_torch.kernels.ref import bsconv_ref, qbsconv_ref
    from repro_torch.quant.pams import code_dtype

    card = cs.card_line()
    print(card, flush=True)
    if args.sass:
        sass_counts()
    t0 = time.perf_counter()
    base_dll, base_log = build_source(args.base, "bsconv_base")
    qbase_dll, qbase_log = build_source(args.qbase, "qconv_base")
    specs = [(Path(v.split("@")[0]), tuple(int(k) for k in v.split("@")[1].split(":"))
              if "@" in v else None) for v in args.variant]
    variants = {f"v{i}:{src.stem}": (*build_source(src, f"bsconv_v{i}"), shape)
                for i, (src, shape) in enumerate(specs)}
    logs = {"base": base_log, "qbase": qbase_log, "new": _build.build(["bsconv"])["bsconv"],
            **{tag: v[1] for tag, v in variants.items()}}
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for tag, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry function" in line and "bsconv" in line:
                print(f"  ptxas {tag}: {line.split(chr(39))[1][:90]}")
            if ("registers" in line or "spill" in line) and (tag != "qbase" or "spill" in line):
                print(f"  ptxas {tag}: {line.strip()}")

    def fp_kernel(raw, sized, shape=None):
        """f(x, w, relu) with w = (pw, pw_b, dw, dw_b), the operands of bsconv_fused."""
        def run(x, w, relu=False):
            n, h, wd, cin = x.shape
            cout = w[0].shape[-1]
            out = torch.empty((n, h, wd, cout), device=x.device)
            extra = shape or (launch_shape(cin, cout, h, wd, None) if sized else ())
            err = raw(x.data_ptr(), *(t.data_ptr() for t in w), out.data_ptr(), n, h, wd, cin,
                      cout, int(relu), *extra, stream_of(x))
            if err:
                launch_error(raw, err, sized)
                return None
            return out
        return run

    def q_kernel(raw, sized, shape=None):
        """f(xq, a, relu) with a the six operands of qbsconv_fused after xq."""
        def run(xq, a, relu=False):
            n, h, wd, cin = xq.shape
            cout = a[0].shape[-1]
            bits = 8 if xq.dtype == torch.int8 else 32
            out = torch.empty((n, h, wd, cout), dtype=xq.dtype, device=xq.device)
            extra = shape or (launch_shape(cin, cout, h, wd, bits) if sized else ())
            err = raw(xq.data_ptr(), *(t.data_ptr() for t in a), out.data_ptr(), n, h, wd, cin,
                      cout, int(relu), bits, *extra, stream_of(xq))
            if err:
                launch_error(raw, err, sized)
                return None
            return out
        return run

    fp = {"base": fp_kernel(bind(base_dll, "bsconv_forward", 6, 6), False),
          "new": lambda x, w, relu=False: bsconv_fused(x, *w, relu=relu)}
    qbsconv_fused = tq.qbsconv_fused
    qk = {"base": q_kernel(bind(qbase_dll, "qbsconv_forward", 8, 7), False),
          "new": lambda xq, a, relu=False: qbsconv_fused(xq, *a, relu=relu)}
    for tag, (dll, _, shape) in variants.items():
        fp[tag] = fp_kernel(bind(dll, "bsconv_forward", 6, 8), True, shape)
        qk[tag] = q_kernel(bind(dll, "qbsconv_forward", 8, 9), True, shape)
    tree = _build.load("bsconv")
    for spec in args.shape:
        shape = tuple(int(v) for v in spec.split(":"))
        fp[f"s{spec}"] = fp_kernel(bind(tree, "bsconv_forward", 6, 8), True, shape)
        qk[f"s{spec}"] = q_kernel(bind(tree, "qbsconv_forward", 8, 9), True, shape)
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
        order = ["base", "new", *(t for t in probes if fn_of(kernels[t])() is not None)]
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
    # fp32 BSConv
    for c in (54, 27):
        for n, h, w in SHAPES:
            for cin in (3, c):
                x, wd = cs.operands("bsconv", n, c, g, torch, cin=cin, hw=(h, w))
                wt = (wd["pw"], wd["pw_b"], wd["dw"], wd["dw_b"])
                for relu in (False, True):
                    a, b = fp["base"](x, wt, relu), fp["new"](x, wt, relu)
                    torch.cuda.synchronize()
                    want = bsconv_ref(x, *wt, relu=relu)
                    same, close = torch.equal(a, b), torch.allclose(b, want, **cs.TOL)
                    print(f"check fp32 N={n} {h}x{w} {cin}->{c} relu {relu}: new torch.equal "
                          f"base {same}; new vs plain max_abs {(b - want).abs().max().item():.3e} "
                          f"{'ok' if close else 'MISMATCH'}", flush=True)
                    if not (same and close):
                        sys.exit("FAIL: the fp32 kernels disagree")
                    for tag in probes:
                        v = fp[tag](x, wt, relu)
                        torch.cuda.synchronize()
                        print(f"  probe {tag}: torch.equal base "
                              f"{v is not None and torch.equal(v, a)}", flush=True)
        if args.time:
            x, wd = cs.operands("bsconv", 1024, c, g, torch)
            wt = (wd["pw"], wd["pw_b"], wd["dw"], wd["dw_b"])
            timed(fp, lambda k: (lambda: k(x, wt)), f"fp32 N=1024 32x32 3->{c}")
    # qBSConv, both modes
    for mode, bits in MODES:
        _, pack, qs, _ = cs.quant_setup(mode, g, torch)
        qmax = 127 if bits <= 8 else 511
        for c in (54, 27):
            p, s0 = qs[c]["first"], qs[c]["sfbs"][0]
            first = (p["pwq"], p["pw_scale"], p["pwb"], p["dw_fq"], p["dwb"], p["qc"])
            b1 = (s0["b1_pwq"], s0["b1_pw_scale"], s0["b1_pwb"], s0["b1_dw_fq"], s0["b1_dwb"],
                  s0["qc"][0:2])
            for n, h, w in SHAPES:
                for cin, qa, relu in ((3, first, False), (c, b1, True)):
                    if (h, w) == (32, 32) and cin == 3:      # the plain chain's codes
                        x = torch.rand((n, h, w, 3), generator=g).cuda()
                        xq = cs.quant_stages(qs[c], x, bits, torch)[1][3]
                    else:
                        xq = torch.randint(-qmax, qmax + 1, (n, h, w, cin), generator=g).to(
                            code_dtype(bits)).cuda()
                    a, b = qk["base"](xq, qa, relu), qk["new"](xq, qa, relu)
                    torch.cuda.synchronize()
                    want = qbsconv_ref(xq, *qa, relu=relu)
                    same, exact = torch.equal(a, b), torch.equal(b, want)
                    print(f"check {mode} N={n} {h}x{w} {cin}->{c} relu {relu}: new torch.equal "
                          f"base {same}, torch.equal plain {exact} (nonzero share "
                          f"{(want != 0).float().mean().item():.3f})", flush=True)
                    if not (same and exact) or want.abs().max().item() == 0:
                        sys.exit("FAIL: the qBSConv kernels disagree, or every code is 0")
                    for tag in probes:
                        v = qk[tag](xq, qa, relu)
                        torch.cuda.synchronize()
                        print(f"  probe {tag}: torch.equal plain "
                              f"{v is not None and torch.equal(v, want)}", flush=True)
            if args.time:
                x = torch.rand((1024, 32, 32, 3), generator=g).cuda()
                xq = cs.quant_stages(qs[c], x, bits, torch)[1][3]
                timed(qk, lambda k: (lambda: k(xq, first)), f"{mode} N=1024 32x32 3->{c}")
        del qs
        torch.cuda.empty_cache()

    def swapped(kernel):
        """``kernel`` with the signature of the wrapper it stands in for."""
        def run(x, *operands, relu=False):
            return kernel(x, operands, relu)
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
                    tq.qbsconv_fused = swapped(qk[tag])
                else:
                    ops.bsconv_fused = swapped(fp[tag])
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
            tq.qbsconv_fused, ops.bsconv_fused = qbsconv_fused, bsconv_fused
            print(f"frames {quant or 'fp32'}: every image torch.equal between the base and the "
                  f"new kernel")
            del eng
            torch.cuda.empty_cache()
    print(f"ok [{card}]")


if __name__ == "__main__":
    main()
