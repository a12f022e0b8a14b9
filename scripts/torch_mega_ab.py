#!/usr/bin/env python3
"""A/B of the port's fp32 megakernel (src/repro_torch/csrc/mega.cu) against
an earlier version, on one NVIDIA card, in one process.

    mkdir -p build/base/mega
    git show cf0d9fd:src/repro_torch/csrc/mega.cu > build/base/mega/mega_base.cu
    git show cf0d9fd:src/repro_torch/csrc/cluster.cuh > build/base/mega/cluster.cuh
    python3 scripts/torch_mega_ab.py build/base/mega/mega_base.cu \\
        [--variant V.cu[@THREADS[:CLUSTER]] ...] [--time] [--frames]

The base source is built with nvcc into build/ab/ under its own library name
and bound with ctypes; a header beside it (the base's own cluster.cuh) takes
precedence over the tree's. Its weights are packed by ``base_pack``, a copy
of the packer of its own tree (every channel count padded to 4), and it
launches at the sizing of its own tree (``base_sizing``: 8-block clusters).
The tree's kernel is built as the port builds it and launched through the
wrapper ``mega_fused``. A variant is a probe: a copy of the tree's source
with one stage cut, packed and sized as the tree's kernel; it is timed beside
the others and its agreement is reported, not required; ``@THREADS``
launches it with that many threads a block, ``:CLUSTER`` with clusters of
that many blocks (the strip rows follow: H / CLUSTER rounded up).
  check   chip_smoke's x4 model with non-zero biases at C54 and C27: N = 7 and
          1024 32x32 and the shapes of SHAPES (Table I's 16, 48 and 64, ragged
          strips); the tree's output torch.equal to the layer chain of kernels
          (kernels/ops.py, pixel shuffle left out) and to the base where the
          base's layout holds the shape, and within rtol 1e-3 / atol 1e-3 of
          the plain ``mega_ref``;
  time    (--time) N = 1024 32x32 patches at C54 and C27, in turns base, new,
          variants, the layer chain, then the same in reverse; CUDA events,
          median of 25 launches (chip_smoke's ``median_ms``), and beside it
          the mean of 20 launches queued back to back (the card's time);
  frames  (--frames) chip_smoke's three 1920x1080 -> 7680x4320 frames under
          ExecutionPlan(fusion="group") on backend "cuda", served in turns
          with the base kernel, the tree's, the tree's and the base's (the
          mega wrapper is swapped); latency per frame, images torch.equal
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
#: (N, H, W) of the checks beyond 32x32: Table I's other patches, an odd
#: patch, ragged last strips, a patch shorter than its blocks, an idle block.
SHAPES = ((4, 16, 16), (4, 48, 48), (2, 64, 64), (3, 13, 21), (2, 17, 9), (1, 25, 32),
          (2, 5, 9), (1, 33, 32))
#: The base tree's launch: clusters of 8 blocks, at most 512 threads a block,
#: 232,448 B of shared memory a block.
BASE_CLUSTER, BASE_MAX_THREADS, SMEM_LIMIT = 8, 512, 232_448


def build_source(src: Path):
    """``src`` as build/ab/<stem>.so, built and loaded: (its mega_forward, the
    library, nvcc's report). Headers beside ``src`` come before the tree's."""
    from repro_torch.kernels import _build
    AB_DIR.mkdir(parents=True, exist_ok=True)
    lib = AB_DIR / f"{src.stem}.so"
    cmd = [_build.nvcc_path(), *_build.FLAGS, "-I", str(src.resolve().parent),
           "-I", str(_build.CSRC), "-o", str(lib), str(src)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(f"FAIL: build of {src}\n{out.stdout}{out.stderr}")
    dll = ctypes.CDLL(str(lib))
    return dll.mega_forward, dll, out.stdout + out.stderr


def _r4(c: int) -> int:
    return (c + 3) & ~3


def base_sizing(width: int, h: int, w: int, cin: int = 3):
    """(rows a block, threads) of the base tree's _sizing, or None where its
    strip does not fit a block."""
    rows = -(-h // BASE_CLUSTER)
    pp = _r4(rows * w)
    cpi, cp = _r4(cin), _r4(width)
    stage = max(cpi * cp + 11 * cp, 3 * cp * cp + 23 * cp, 10 * cp + cp * 48 + 48)
    if 4 * (pp * cp + 2 * (rows + 2) * w * cp + pp * max(cp, cpi) + stage) > SMEM_LIMIT:
        return None
    return rows, min(BASE_MAX_THREADS, max(64, 32 * -(-(cp // 4) * (pp // 4) // 32)))


def base_pack(wts, torch):
    """The base tree's pack_weights on unpacked views ``wts`` (mega_ref's
    form): the same operand order, every matrix and vector zero-padded to
    channel counts that are multiples of 4."""
    def mat(t, rows, cols):
        m = torch.zeros((rows, cols), dtype=torch.float32, device=t.device)
        m[: t.shape[0], : t.shape[1]] = t
        return m.reshape(-1)

    first, recon = wts["first"], wts["recon"]
    cin, c = first["pw"].shape
    cout = recon["pw"].shape[-1]
    cpi, cp, cpo = _r4(cin), _r4(c), _r4(cout)

    def bs(pw, pwb, dw, dwb, rows):
        return [mat(pw, rows, cp), mat(pwb[None], 1, cp), mat(dw.reshape(9, c), 9, cp),
                mat(dwb[None], 1, cp)]

    parts = bs(first["pw"], first["pw_b"], first["dw"], first["dw_b"], cpi)
    for s in wts["sfbs"]:
        for b in ("b1", "b2"):
            parts += bs(s[f"{b}_pw"], s[f"{b}_pwb"], s[f"{b}_dw"], s[f"{b}_dwb"], cp)
        parts += [mat(s["fuse"], cp, cp), mat(s["fuse_b"][None], 1, cp)]
    parts += [mat(recon["dw"].reshape(9, c), 9, cp), mat(recon["dw_b"][None], 1, cp),
              mat(recon["pw"], cp, cpo), mat(recon["pw_b"][None], 1, cpo)]
    return torch.cat(parts).contiguous()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=Path, help="an earlier csrc/mega.cu")
    ap.add_argument("--variant", action="append", default=[],
                    help="a probe copy of the tree's mega.cu [@THREADS[:CLUSTER]], timed and "
                         "compared, not required to agree")
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
    from repro_torch.kernels import ops
    from repro_torch.kernels._launch import stream_of
    from repro_torch.kernels.ref import mega_ref
    from repro_torch.models.essr import ESSRConfig

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
    logs["new"] = _build.build(["mega"])["mega"]
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for tag, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                print(f"  ptxas {tag}: {line.split(chr(39))[1][:90]}")
            if "registers" in line or "spill" in line:
                print(f"  ptxas {tag}: {line.strip()}")

    repacked = {}

    def launcher(tag, raw, base):
        """The kernel as f(x, wbuf, width, n_sfb, out_channels), the signature
        of mega_fused; the base repacks the tree's buffer once. A launch the
        kernel's layout cannot hold gives None."""
        raw.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * (10 if base else 11)
                        + [ctypes.c_void_p])
        raw.restype = ctypes.c_int

        def run(x, wbuf, *, width, n_sfb, out_channels):
            n, h, w, cin = x.shape
            lay = mk.WeightLayout(cin, width, out_channels, n_sfb)
            tail = ()
            if base:
                shape = base_sizing(width, h, w, cin)
                if shape is None:
                    return None
                hit = repacked.get(id(wbuf))
                if hit is None or hit[0] is not wbuf:
                    hit = repacked[id(wbuf)] = (wbuf, base_pack(mk.unpack_weights(wbuf, lay),
                                                                torch))
                wbuf = hit[1]
                (rows, threads), cluster = shape, BASE_CLUSTER
            else:
                rep = mk._sizing(width, h, w, cin, out_channels, n_sfb)
                threads, cluster = variant_shape.get(tag, (None, None))
                threads, cluster = threads or rep["threads"], cluster or rep["cluster"]
                rows, tail = -(-h // cluster), (rep["pixel_pad"],)
            out = torch.empty((n, h, w, out_channels), device=x.device)
            err = raw(x.data_ptr(), wbuf.data_ptr(), out.data_ptr(), n, h, w, cin, width,
                      out_channels, n_sfb, rows, cluster, threads, *tail, stream_of(x))
            if err and tag.startswith("v"):
                return None
            if err:
                sys.exit(f"FAIL: {tag} launch error {err}")
            return out
        return run

    kernels = {tag: launcher(tag, raw, tag == "base") for tag, (raw, _, _) in built.items()}
    kernels["new"] = mk.mega_fused
    probes = [t for t in kernels if t.startswith("v")]

    def chain(x, tree, width):
        """The layer chain of kernels (bsconv -> n x sfb -> dsconv), pre-shuffle."""
        params = tree if width == tree["first"]["pw"].shape[-1] else mk.slice_width(tree, width)
        first, recon = params["first"], params["recon"]
        cout = recon["pw"].shape[-1]
        f = ops.bsconv_fused(x, ops._flat(first["pw"][0, 0]),
                             ops._bias(first, "pw_b", width, first["pw"]),
                             ops._flat(first["dw"][:, :, 0, :]),
                             ops._bias(first, "dw_b", width, first["dw"]))
        for p in params["sfbs"]:
            f = ops.sfb_fused(f, ops.flat_sfb(p))
        return ops.dsconv_fused(f, ops._flat(recon["dw"][:, :, 0, :]),
                                ops._bias(recon, "dw_b", width, recon["dw"]),
                                ops._flat(recon["pw"][0, 0]),
                                ops._bias(recon, "pw_b", cout, recon["pw"]))

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
    cfg = ESSRConfig(scale=4)
    kw = dict(n_sfb=cfg.n_sfb, out_channels=cfg.out_channels)
    tree, _ = cs.mega_operands(54, g, torch)
    operands = {c: mk.pack_weights(tree, c) for c in (54, 27)}
    with torch.inference_mode():
        for c in (54, 27):
            wbuf = operands[c]
            lay = mk.WeightLayout(3, c, cfg.out_channels, cfg.n_sfb)
            for n, h, w in ((7, 32, 32), (1024, 32, 32)) + SHAPES:
                x = torch.rand((n, h, w, 3), generator=g).cuda()
                b = mk.mega_fused(x, wbuf, width=c, **kw)
                a = kernels["base"](x, wbuf, width=c, **kw)
                layer = chain(x, tree, c)
                torch.cuda.synchronize()
                want = mega_ref(x, mk.unpack_weights(wbuf, lay))
                same = True if a is None else torch.equal(a, b)
                exact, close = torch.equal(b, layer), torch.allclose(b, want, rtol=1e-3, atol=1e-3)
                rep = mk._sizing(c, h, w, 3, cfg.out_channels, cfg.n_sfb)
                print(f"check C{c} N={n} {h}x{w} ({rep['cluster']} x {rep['rows_per_cta']} rows, "
                      f"pad {rep['pixel_pad']}): new torch.equal base "
                      f"{'(base does not fit)' if a is None else same}, torch.equal layer chain "
                      f"{exact}, max_abs vs plain {(b - want).abs().max().item():.3e} "
                      f"{'ok' if close else 'MISMATCH'}", flush=True)
                if not (same and exact and close):
                    sys.exit("FAIL: the kernels disagree")
                for tag in probes:
                    v = kernels[tag](x, wbuf, width=c, **kw)
                    torch.cuda.synchronize()
                    print(f"  probe {tag}: " + ("does not launch" if v is None else
                                                f"torch.equal layer chain {torch.equal(v, layer)}"),
                          flush=True)
                del x, a, b, layer, want

        if args.time:
            for c in (54, 27):
                wbuf = operands[c]
                x = torch.rand((1024, 32, 32, 3), generator=g).cuda()
                runs = {tag: (lambda fn=kernels[tag]: fn(x, wbuf, width=c, **kw))
                        for tag in ["base", "new", *probes]}
                runs["chain"] = lambda: chain(x, tree, c)
                order = [t for t, fn in runs.items() if fn() is not None]
                t = {tag: [] for tag in order}
                for tag in order + order[::-1]:
                    t[tag].append(cs.median_ms(runs[tag], torch))
                    t[tag].append(queued_ms(runs[tag]))
                ratio = statistics.mean(t["new"][::2]) / statistics.mean(t["base"][::2])
                chain_ratio = statistics.mean(t["new"][::2]) / statistics.mean(t["chain"][::2])
                print(f"time N=1024 32x32 C{c} ({', '.join(order)}, then reversed; "
                      f"median (queued)): "
                      + ", ".join(f"{tag} {v[0]:.4f} ({v[1]:.4f}) / {v[2]:.4f} ({v[3]:.4f}) ms"
                                  for tag, v in t.items())
                      + f"; new/base {ratio:.3f}, new/chain {chain_ratio:.3f} [{card}]",
                      flush=True)
                del x
    del operands
    torch.cuda.empty_cache()

    if args.frames:
        from repro_torch.api import ExecutionPlan, SREngine
        engine = SREngine.from_config(cfg, seed=cs.SEED, device="cuda")
        frames = [cs.mixed_frame(cs.SEED + i) for i in range(3)]
        geng = SREngine(engine.model, plan=ExecutionPlan(fusion="group"), device="cuda")
        images = {}
        for turn, tag in enumerate(("base", "new", "new", "base")):
            mk.mega_fused = kernels[tag]
            geng.warmup((1080, 1920))
            lats = []
            for i, f in enumerate(frames):
                r = geng.upscale(f)
                lats.append(r.latency_s)
                if i not in images:
                    images[i] = r.image
                elif not torch.equal(images[i], r.image):
                    sys.exit(f"FAIL: group frame {i} differs between the kernels")
            print(f"frames group turn {turn} ({tag}): latency "
                  + " / ".join(f"{v * 1e3:.2f}" for v in lats) + f" ms [{card}]", flush=True)
            if turn < 2:
                cs.profile_frame(geng, frames[1], statistics.median(lats), torch)
        mk.mega_fused = kernels["new"]
        print("frames: every group image torch.equal between the base and the new kernel")
    print(f"ok [{card}]")


if __name__ == "__main__":
    main()
