#!/usr/bin/env python3
"""A/B of the port's quantized megakernel (src/repro_torch/csrc/qmega.cu)
against an earlier version, on one NVIDIA card, in one process.

    mkdir -p build/base/q20
    git show abc345d:src/repro_torch/csrc/qmega.cu > build/base/q20/qmega_base.cu
    git show abc345d:src/repro_torch/csrc/cluster.cuh > build/base/q20/cluster.cuh
    git show abc345d:src/repro_torch/csrc/qmma.cuh > build/base/q20/qmma.cuh
    python3 scripts/torch_qmega_ab.py build/base/q20/qmega_base.cu
        [--variant V.cu[@THREADS[:CLUSTER]] ...] [--time] [--frames]

The base source is built with nvcc into build/ab/ under its own library name
and bound with ctypes (a header beside it is taken before the tree's); its
weights are packed by ``base_pack``, a copy of the packer of its own tree
(abc345d: fxp10 code weights as fp32 B rows), and it launches at the sizing
of its own tree (``base_sizing``). The tree's kernel is built as the port builds it and
launched through the wrapper ``qmega_fused``. A variant is a probe: a copy of
the tree's source with one stage cut, packed and sized as the tree's kernel;
it is timed beside the others and its agreement is reported, not required;
``@THREADS`` launches it with that many threads a block, ``:CLUSTER`` with
clusters of that many blocks (the strip rows follow: H / CLUSTER rounded up).
Then, for "int8" and "fxp10":
  check   every kernel on the same patches: chip_smoke's calibrated x4 model
          at C54 and C27, N = 7 and 1024 32x32 and ragged patches (13x21, 17x9,
          25x32, 5x9), and chip_smoke's synthetic extreme operands at C54 (codes
          that saturate, sums up to qmax^2 * 54); the tree's recon codes
          torch.equal to the base's and to the plain ``qmega_ref``;
  time    (--time) N = 1024 32x32 patches at C54 and C27, in turns base, new,
          variants, then the same in reverse; CUDA events, median of 25
          launches (chip_smoke's ``median_ms``), and beside it the mean of 20
          launches queued back to back (the card's time);
  frames  (--frames) chip_smoke's three 1920x1080 -> 7680x4320 frames under
          ExecutionPlan(quant=mode, fusion="group") on backend "cuda", served
          in turns with the base kernel, the tree's, the tree's and the
          base's (the qmega wrapper is swapped; the base's weights are
          repacked once per buffer); latency per frame, images torch.equal
          between the two kernels, one profiled frame each of the first two
          turns.
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
#: (N, H, W, C) of the checks on the model's operands; C is a subnet width.
SHAPES = ((7, 32, 32, 54), (7, 32, 32, 27), (1024, 32, 32, 54), (1024, 32, 32, 27),
          (3, 13, 21, 54), (2, 17, 9, 54), (2, 17, 9, 27), (1, 25, 32, 54), (2, 5, 9, 27))
#: (N, H, W) of the checks on synthetic extreme operands at C54.
EXTREME = ((7, 32, 32), (3, 13, 21), (2, 17, 9), (1, 25, 32))
#: The base tree's launch: clusters of 4, 8 or 16 blocks, at most 512 threads a block.
BASE_CLUSTERS, BASE_MAX_THREADS = (4, 8, 16), 512


def build_source(src: Path):
    """``src`` as build/ab/<stem>.so, built and loaded: (its qmega_forward,
    the library, nvcc's report)."""
    from repro_torch.kernels import _build
    AB_DIR.mkdir(parents=True, exist_ok=True)
    lib = AB_DIR / f"{src.stem}.so"
    cmd = [_build.nvcc_path(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(src)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"FAIL: build of {src}\n{out.stdout}{out.stderr}")
    dll = ctypes.CDLL(str(lib))
    raw = dll.qmega_forward
    raw.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    raw.restype = ctypes.c_int
    dll.qmega_smem_bytes.argtypes = [ctypes.c_int] * 7
    dll.qmega_smem_bytes.restype = ctypes.c_longlong
    return raw, dll, out.stdout + out.stderr


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def base_layout(cin: int, c: int, cout: int, n_sfb: int, bits: int) -> dict:
    """The base tree's QWeightLayout and QShape (abc345d): code weights as B
    rows of int8 codes or fxp10 codes as fp32 (the depth to 32 or 8 codes),
    each row an odd multiple of 16 bytes."""
    from repro_torch.kernels.megakernel import _operand_stride
    cb = 1 if bits <= 8 else 4
    cp8, cpo = _up(c, 8), _up(cout, 4)
    kp, kp1 = _up(c, 32 if cb == 1 else 8), _up(cin, 32 if cb == 1 else 8)
    ast, ast1 = _operand_stride(kp * cb), _operand_stride(kp1 * cb)
    first, bs, fuse = cp8 * ast1 + 48 * cp8, cp8 * ast + 48 * cp8, cp8 * ast + 12 * cp8
    recon = 44 * cp8 + 4 * cp8 * cpo + 4 * cpo
    return dict(cb=cb, cp8=cp8, cpo=cpo, ast=ast, ast1=ast1,
                stage=first + recon + (2 * bs + fuse if n_sfb else 0))


def base_sizing(width: int, h: int, w: int, cin: int, cout: int, n_sfb: int, bits: int) -> tuple:
    """(rows a block, cluster, threads) of the base tree's _qsizing: the
    first of 4, 8 and 16 blocks whose strip (two fp32 maps with halo rows,
    F, Y and the weights of the first layer, the recon and one qSFB) fits."""
    lay = base_layout(cin, width, cout, n_sfb, bits)
    ost = max(lay["ast"], lay["ast1"])
    pst = lay["cp8"] + 8 if lay["cp8"] % 16 == 0 else lay["cp8"]
    for cluster in BASE_CLUSTERS:
        rows = -(-h // cluster)
        p = rows * w
        smem = 2 * max(4 * (rows + 2) * w * pst, p * ost) + 2 * p * ost + lay["stage"]
        if smem <= 232_448:
            break
    else:
        sys.exit(f"FAIL: the base's layout holds no strip of {width} channels at {h}x{w}")
    return rows, cluster, min(BASE_MAX_THREADS, max(64, 32 * -(-(lay["cp8"] // 4) * p // 32)))


def base_pack(q, bits: int, torch):
    """The base tree's pack_qweights: the same operand order and fp operands
    as the tree's, the code weights as B rows of int8 codes or fp32 floats."""
    first, recon = q["first"], q["recon"]
    cin, c = first["pwq"].shape
    cout = recon["pw_fq"].shape[-1]
    lay = base_layout(cin, c, cout, len(q["sfbs"]), bits)
    cp8, cpo = lay["cp8"], lay["cpo"]

    def rows(t, stride):
        dt = torch.int8 if bits <= 8 else torch.float32
        m = torch.zeros((cp8, stride // dt.itemsize), dtype=dt, device=t.device)
        m[: t.shape[1], : t.shape[0]] = t.t().to(dt)
        return m.view(torch.uint8).reshape(-1)

    def fp(t, r, k):
        m = torch.zeros((r, k), dtype=torch.float32, device=t.device)
        m[: t.shape[0], : t.shape[1]] = t
        return m.view(torch.uint8).reshape(-1)

    def vec(v, n=cp8):
        return fp(v.reshape(1, -1), 1, n)

    def bs(pwq, scale, pwb, dw, dwb, stride):
        return [rows(pwq, stride), vec(scale), vec(pwb), fp(dw.reshape(9, c), 9, cp8), vec(dwb)]

    parts = bs(first["pwq"], first["pw_scale"], first["pwb"], first["dw_fq"], first["dwb"],
               lay["ast1"])
    for s in q["sfbs"]:
        for b in ("b1", "b2"):
            parts += bs(s[f"{b}_pwq"], s[f"{b}_pw_scale"], s[f"{b}_pwb"], s[f"{b}_dw_fq"],
                        s[f"{b}_dwb"], lay["ast"])
        parts += [rows(s["fuseq"], lay["ast"]), vec(s["fuse_scale_y"]), vec(s["fuse_scale_x"]),
                  vec(s["fuseb"])]
    dwq = recon["dwq"].reshape(9, c)
    m = dwq.new_zeros((9, cp8))
    m[:, :c] = dwq
    parts += [m.view(torch.uint8).reshape(-1), vec(recon["dw_scale"]), vec(recon["dwb"]),
              fp(recon["pw_fq"], cp8, cpo), vec(recon["pwb"], cpo)]
    return torch.cat(parts).contiguous()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=Path, help="an earlier csrc/qmega.cu")
    ap.add_argument("--variant", action="append", default=[],
                    help="a probe copy of the tree's qmega.cu [@THREADS[:CLUSTER]], timed and "
                         "compared, "
                         "not required to agree")
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
    from repro_torch.kernels import megakernel as mk
    from repro_torch.kernels._launch import stream_of
    from repro_torch.kernels.ref import qmega_ref

    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    built = {"base": build_source(args.base)}
    variant_shape = {}
    for i, spec in enumerate(args.variant):
        path, _, shape = spec.partition("@")
        tag = f"v{i}:{Path(path).stem}" + (f"@{shape}" if shape else "")
        built[tag] = build_source(Path(path))
        if shape:
            threads, _, cluster = shape.partition(":")
            variant_shape[tag] = (int(threads), int(cluster) if cluster else None)
    logs = {tag: b[2] for tag, b in built.items()}
    logs["new"] = _build.build(["qmega"])["qmega"]
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for tag, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                print(f"  ptxas {tag}: {line.split(chr(39))[1][:90]}")
            if "registers" in line or "spill" in line:
                print(f"  ptxas {tag}: {line.strip()}")

    repacked = {}

    def launcher(tag, raw, dll, base):
        """The kernel as f(x, wbuf, qc, width, n_sfb, out_channels, bits), the
        signature of qmega_fused; the base repacks the tree's buffer once. A
        probe whose launch is refused (its block does not fit) gives None."""
        def run(x, wbuf, qc, *, width, n_sfb, out_channels, bits):
            n, h, w, cin = x.shape
            if base:
                hit = repacked.get(id(wbuf))
                if hit is None or hit[0] is not wbuf:
                    lay = mk.QWeightLayout(cin, width, out_channels, n_sfb, bits)
                    hit = repacked[id(wbuf)] = (wbuf, base_pack(mk.unpack_qweights(wbuf, lay),
                                                                bits, torch))
                wbuf = hit[1]
                rows, cluster, threads = base_sizing(width, h, w, cin, out_channels, n_sfb, bits)
            else:
                rep = mk._qsizing(width, h, w, cin, out_channels, n_sfb, bits)
                threads, cluster = variant_shape.get(tag, (None, None))
                threads, cluster = threads or rep["threads"], cluster or rep["cluster"]
                rows = -(-h // cluster)
            out = torch.empty((n, h, w, out_channels),
                              dtype=torch.int8 if bits <= 8 else torch.int32, device=x.device)
            err = raw(x.data_ptr(), wbuf.data_ptr(), qc.data_ptr(), out.data_ptr(), n, h, w, cin,
                      width, out_channels, n_sfb, rows, cluster, threads,
                      8 if bits <= 8 else 32, stream_of(x))
            if err and tag.startswith("v"):
                return None
            if err:
                sys.exit(f"FAIL: {tag} launch error {err}")
            return out
        return run

    kernels = {tag: launcher(tag, raw, dll, tag == "base") for tag, (raw, dll, _) in built.items()}
    kernels["new"] = mk.qmega_fused
    probes = [t for t in kernels if t.startswith("v")]

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
        cfg, pack, qs, _ = cs.quant_setup(mode, g, torch)
        kw = dict(n_sfb=cfg.n_sfb, out_channels=cfg.out_channels, bits=bits)
        operands = {c: (mk.pack_qweights(qs[c], bits), qs[c]["consts"]) for c in (54, 27)}
        ext = cs.qmega_extreme_operands(54, bits, g, torch)
        cases = [(f"model N={n} {h}x{w} C{c}", c, torch.rand((n, h, w, 3), generator=g).cuda(),
                  *operands[c]) for n, h, w, c in SHAPES]
        cases += [(f"extreme N={n} {h}x{w} C54", 54,
                   torch.rand((n, h, w, 3), generator=g).cuda(), mk.pack_qweights(ext, bits),
                   ext["consts"]) for n, h, w in EXTREME]
        for label, c, x, wbuf, qc in cases:
            lay = mk.QWeightLayout(3, c, cfg.out_channels, cfg.n_sfb, bits)
            a, b = kernels["base"](x, wbuf, qc, width=c, **kw), mk.qmega_fused(x, wbuf, qc,
                                                                               width=c, **kw)
            torch.cuda.synchronize()
            want = qmega_ref(x, mk.unpack_qweights(wbuf, lay), qc, b.dtype)
            same, exact = torch.equal(a, b), torch.equal(b, want)
            print(f"check {mode} {label}: new torch.equal base {same}, torch.equal plain {exact} "
                  f"(max {(b.long() - want.long()).abs().max().item()} codes apart; nonzero "
                  f"share {(want != 0).float().mean().item():.3f})", flush=True)
            if not (same and exact):
                sys.exit("FAIL: the kernels disagree")
            for tag in probes:
                v = kernels[tag](x, wbuf, qc, width=c, **kw)
                torch.cuda.synchronize()
                print(f"  probe {tag}: " + ("does not fit" if v is None else
                                            f"torch.equal plain {torch.equal(v, want)}"),
                      flush=True)
        del cases, ext

        if args.time:
            for c in (54, 27):
                wbuf, qc = operands[c]
                x = torch.rand((1024, 32, 32, 3), generator=g).cuda()
                order = ["base", "new", *(p for p in probes
                                          if kernels[p](x, wbuf, qc, width=c, **kw) is not None)]
                t = {tag: [] for tag in order}
                for tag in order + order[::-1]:
                    fn = kernels[tag]
                    t[tag].append(cs.median_ms(lambda: fn(x, wbuf, qc, width=c, **kw), torch))
                    t[tag].append(queued_ms(lambda: fn(x, wbuf, qc, width=c, **kw)))
                ratio = statistics.mean(t["new"][::2]) / statistics.mean(t["base"][::2])
                print(f"time {mode} N=1024 32x32 C{c} ({', '.join(order)}, then reversed; "
                      f"median (queued)): "
                      + ", ".join(f"{tag} {v[0]:.4f} ({v[1]:.4f}) / {v[2]:.4f} ({v[3]:.4f}) ms"
                                  for tag, v in t.items())
                      + f"; new/base {ratio:.3f} [{card}]", flush=True)
        del qs, operands
        torch.cuda.empty_cache()

    if args.frames:
        from repro_torch.api import ExecutionPlan, SREngine
        from repro_torch.models.essr import ESSRConfig
        engine = SREngine.from_config(ESSRConfig(scale=4), seed=cs.SEED, device="cuda")
        frames = [cs.mixed_frame(cs.SEED + i) for i in range(3)]
        for mode, _ in MODES:
            geng = SREngine(engine.model, plan=ExecutionPlan(quant=mode, fusion="group"),
                            device="cuda")
            images = {}
            for turn, tag in enumerate(("base", "new", "new", "base")):
                mk.qmega_fused = kernels[tag]
                geng.warmup((1080, 1920))
                lats = []
                for i, f in enumerate(frames):
                    r = geng.upscale(f)
                    lats.append(r.latency_s)
                    if i not in images:
                        images[i] = r.image
                    elif not torch.equal(images[i], r.image):
                        sys.exit(f"FAIL: {mode} group frame {i} differs between the kernels")
                print(f"frames {mode} group turn {turn} ({tag}): latency "
                      + " / ".join(f"{v * 1e3:.2f}" for v in lats) + f" ms [{card}]", flush=True)
                if turn < 2:
                    cs.profile_frame(geng, frames[1], statistics.median(lats), torch)
            mk.qmega_fused = kernels["new"]
            print(f"frames {mode}: every group image torch.equal between the base and the new "
                  f"kernel")
            del geng
            torch.cuda.empty_cache()
    print(f"ok [{card}]")


if __name__ == "__main__":
    main()
