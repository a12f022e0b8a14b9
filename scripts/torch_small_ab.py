#!/usr/bin/env python3
"""A/B of the port's two small kernels, quantize (src/repro_torch/csrc/qconv.cu)
and the edge score (src/repro_torch/csrc/edge.cu), against earlier versions,
on one NVIDIA card, in one process.

    mkdir -p build/base/small
    for f in qconv.cu edge.cu common.cuh qmath.cuh; do
        git show 439558b:src/repro_torch/csrc/$f > build/base/small/$f; done
    python3 scripts/torch_small_ab.py build/base/small [--variant qconv=V.cu ...]
        [--variant edge=V.cu ...]

The base directory holds an earlier qconv.cu and edge.cu beside the headers
they include (a header beside a source is taken first). They are built with
nvcc into build/ab/ and bound with ctypes; the tree's kernels are built as
the port builds them. Base and tree are called through the same Python
wrapper (the operand checks, the output's allocation, the ctypes launch), so
their host times differ only by what the C entry does; the tree's own
wrappers (``quantize_fused``, ``edge_score_fused``) are timed beside them. A
variant is a probe: a copy of the tree's qconv.cu or edge.cu (built against
the tree's headers), checked and timed beside base and tree, never shipped.
  check  quantize on N = 1024 C3 32x32 patches (the main path's input), on
         an all-zero input (a letterboxed frame), on n % 4 != 0 elements at
         storage offsets of 1 and 3 elements, int8 and fxp10: the tree's
         codes torch.equal to the base's and to the plain quantize_ref; edge
         on one 1080p frame's 2,304 32x32 patches (chip_smoke's mixed frame)
         and at 48x48, 64x64 and 70 wide: the tree's scores within rtol 1e-4
         / atol 1e-3 of the plain edge_score and of the base's, with equal
         routing ids;
  library  torch.quantize_per_tensor(x, s, 0, torch.qint8), the one PyTorch
         call nearest quantize's int8 codes, against the plain quantize_ref
         on the main input and on values past +-a and at half-step ties: the
         codes where they differ, and its time beside the kernel's (it is no
         yardstick where it differs; fxp10 has no 10-bit quantized dtype);
  time   in turns base, new, the variants, the variants again in reverse,
         new, base: the device time of one call from a CUDA graph of
         chip_smoke.GRAPH_LAUNCHES captured calls replayed
         (chip_smoke.graph_ms), rotating over copies of the input that
         together exceed the L2 cache (chip_smoke.cold_inputs) and again on
         one input, which stays in the L2; the evented median of 25 launches
         (chip_smoke.median_ms) and the host time of one wrapper call
         (chip_smoke.host_ms); quantize also on the all-zero input;
  entry  the host time of the C entry alone (the ctypes call into a
         preallocated output, no Python checks; one 32x32 patch for
         quantize, 8 for edge, 500 calls): what resident_grid's runtime
         queries cost on every call in the base, once a shape in the tree.
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


def build_source(src: Path, tag: str, include: Path = None):
    """``src`` as build/ab/<tag>.so (headers beside it first, then those of
    ``include``), built and loaded: (the library, nvcc's report)."""
    from repro_torch.kernels import _build
    AB_DIR.mkdir(parents=True, exist_ok=True)
    lib = AB_DIR / f"{tag}.so"
    inc = ["-I", str(include)] if include else []
    cmd = [_build.nvcc_path(), *_build.FLAGS, *inc, "-o", str(lib), str(src)]
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
    ap.add_argument("base", type=Path, help="a directory with an earlier qconv.cu and edge.cu "
                                            "and the headers they include")
    ap.add_argument("--variant", action="append", default=[],
                    help="qconv=V.cu or edge=V.cu: a probe copy of the tree's source")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("FAIL: no CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.core import subnet_policy as sp
    from repro_torch.core.edge_score import edge_score
    from repro_torch.core.patching import get_geometry
    from repro_torch.kernels import _build
    from repro_torch.kernels._launch import check_operands, stream_of
    from repro_torch.kernels.edge import edge_score_fused
    from repro_torch.kernels.qconv import quantize_fused
    from repro_torch.kernels.ref import quantize_ref
    from repro_torch.quant.pams import code_dtype

    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    qbase, qlog = build_source(args.base / "qconv.cu", "qconv_small_base")
    ebase, elog = build_source(args.base / "edge.cu", "edge_small_base")
    logs = {"qconv base": qlog, "edge base": elog, **{f"{k} new": v for k, v in
                                                      _build.build(["qconv", "edge"]).items()}}
    probes = {}
    for i, spec in enumerate(args.variant):
        kind, src = spec.split("=", 1)
        if kind not in ("qconv", "edge"):
            sys.exit(f"FAIL: --variant {spec}: the kind is qconv or edge")
        dll, log = build_source(Path(src), f"{kind}_small_v{i}", include=_build.CSRC)
        probes[f"v{i}:{Path(src).stem}"] = (kind, dll)
        logs[f"{kind} v{i}"] = log
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for tag, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {tag}: {line.strip()}")

    def quantizer(raw):
        def run(x, qc, bits):
            check_operands("quantize", x, {"qc": (qc, (2,))})
            out = torch.empty(x.shape, dtype=code_dtype(bits), device=x.device)
            err = raw(x.data_ptr(), qc.data_ptr(), out.data_ptr(), x.numel(),
                      8 if bits <= 8 else 32, stream_of(x))
            if err:
                sys.exit(f"FAIL: quantize launch error {err}")
            return out
        return run

    def scorer(raw):
        def run(x):
            check_operands("edge", x, {})
            n, h, w, _ = x.shape
            out = torch.empty((n,), dtype=torch.float32, device=x.device)
            err = raw(x.data_ptr(), out.data_ptr(), n, h, w, stream_of(x))
            if err:
                sys.exit(f"FAIL: edge launch error {err}")
            return out
        return run

    tree_q, tree_e = _build.load("qconv"), _build.load("edge")
    quant = {"base": quantizer(bind(qbase, "quantize_forward", 3, 2)),
             "new": quantizer(bind(tree_q, "quantize_forward", 3, 2))}
    edge = {"base": scorer(bind(ebase, "edge_forward", 2, 3)),
            "new": scorer(bind(tree_e, "edge_forward", 2, 3))}
    for tag, (kind, dll) in probes.items():
        if kind == "qconv":
            quant[tag] = quantizer(bind(dll, "quantize_forward", 3, 2))
        else:
            edge[tag] = scorer(bind(dll, "edge_forward", 2, 3))

    def timed(kernels, call, x, label, wrapper=None):
        """call(kernel, input) -> a call; timed on ``x`` alone (L2-resident in
        the graph) and rotating over cs.cold_inputs(x) (read from device
        memory)."""
        cold = cs.cold_inputs(x, torch)
        extra = [tag for tag in kernels if tag not in ("base", "new")]
        t = {tag: [] for tag in ("base", "new", *extra)}
        for tag in ("base", "new", *extra, *extra[::-1], "new", "base"):
            k = kernels[tag]
            fn = call(k, x)
            t[tag].append((cs.graph_ms([call(k, v) for v in cold], torch), cs.graph_ms(fn, torch),
                           cs.median_ms(fn, torch), cs.host_ms(fn, torch)))
        own = cs.host_ms(wrapper, torch) if wrapper else None
        mean = {tag: [statistics.mean(v[i] for v in t[tag]) for i in range(4)] for tag in t}
        print(f"time {label} (in turns; device ms a call from a CUDA graph of "
              f"{cs.GRAPH_LAUNCHES} over {len(cold)} inputs past the L2 / the same on one "
              f"L2-resident input / evented median ms / host ms a wrapper call): "
              + "; ".join(f"{tag} " + ", ".join(" / ".join(f"{m:.4f}" for m in r) for r in v)
                          for tag, v in t.items())
              + "".join(f"; {tag}/base device {mean[tag][0] / mean['base'][0]:.3f} (L2-resident "
                        f"{mean[tag][1] / mean['base'][1]:.3f}), host "
                        f"{mean[tag][3] / mean['base'][3]:.3f}" for tag in ("new", *extra))
              + (f"; the tree's own wrapper {own:.4f} ms host a call" if own else "")
              + f" [{card}]", flush=True)

    def entry_ms(raw, *args, calls=500):
        """Host time of one call, fewer calls than the launch queue holds,
        on inputs small enough that the card keeps up."""
        raw(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            raw(*args)
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t * 1e3 / calls

    g = torch.Generator().manual_seed(cs.SEED)
    # the C entries' own host time, in turns base, new, new, base
    xq = torch.rand((1, 32, 32, 3), generator=g).cuda()
    qcq = torch.tensor([1.0, 1.0 / 127]).cuda()
    oq = torch.empty(xq.shape, dtype=torch.int8, device="cuda")
    xe = torch.rand((8, 32, 32, 3), generator=g).cuda()
    oe = torch.empty((8,), device="cuda")
    raws = {"quantize": {"base": bind(qbase, "quantize_forward", 3, 2),
                         "new": bind(tree_q, "quantize_forward", 3, 2)},
            "edge": {"base": bind(ebase, "edge_forward", 2, 3),
                     "new": bind(tree_e, "edge_forward", 2, 3)}}
    args = {"quantize": (xq.data_ptr(), qcq.data_ptr(), oq.data_ptr(), xq.numel(), 8,
                         stream_of(xq)),
            "edge": (xe.data_ptr(), oe.data_ptr(), 8, 32, 32, stream_of(xe))}
    for kind in ("quantize", "edge"):
        t = {"base": [], "new": []}
        for tag in ("base", "new", "new", "base"):
            t[tag].append(entry_ms(raws[kind][tag], *args[kind]))
        print(f"entry {kind} host ms a C entry call (base, new, new, base): "
              + "; ".join(f"{tag} " + ", ".join(f"{v:.5f}" for v in vs) for tag, vs in t.items())
              + f"; new/base {statistics.mean(t['new']) / statistics.mean(t['base']):.3f} "
              f"[{card}]", flush=True)
    del xq, oq, xe, oe
    # quantize, both code types
    for mode, bits in MODES:
        _, pack, qs, _ = cs.quant_setup(mode, g, torch)
        qc = qs[54]["in_qc"]
        dtype = code_dtype(bits)
        x = torch.rand((1024, 32, 32, 3), generator=g).cuda()
        zeros = torch.zeros_like(x)
        odd = torch.rand(4099 + 3, generator=g).cuda()
        cases = [("N=1024 C3 32x32", x), ("all zero", zeros),
                 ("4099 at offset 1", odd[1:4100].view(1, 1, 4099, 1)),
                 ("4099 at offset 3", odd[3:].view(1, 1, 4099, 1))]
        for label, v in cases:
            a, b = quant["base"](v, qc, bits), quant["new"](v, qc, bits)
            torch.cuda.synchronize()
            want = quantize_ref(v, qc, dtype)
            ok = torch.equal(a, b) and torch.equal(b, want)
            probe = "".join(f"; {tag} torch.equal {torch.equal(k(v, qc, bits), want)}"
                            for tag, k in quant.items() if tag not in ("base", "new"))
            print(f"check quantize {mode} {label}: new torch.equal base and plain {ok}{probe}",
                  flush=True)
            if not ok:
                sys.exit("FAIL: the quantize kernels disagree")
        if bits <= 8:
            s_ = float(qc[1])
            a_ = float(qc[0])
            edges = torch.tensor([-3 * a_, -1.5 * a_, 1.5 * a_, 3 * a_]
                                 + [(k + 0.5) * s_ for k in range(-127, 127)]).cuda()
            for label, v in (("N=1024 C3 32x32", x), ("past +-a and at half-step ties", edges)):
                lib = torch.quantize_per_tensor(v, s_, 0, torch.qint8).int_repr()
                want = quantize_ref(v.view(1, 1, -1, 1), qc, dtype).view(v.shape)
                print(f"library quantize int8 {label}: torch.quantize_per_tensor differs from "
                      f"the plain quantize_ref on {int((lib != want).sum())} of {v.numel()} codes",
                      flush=True)
            print(f"library quantize int8 time: torch.quantize_per_tensor "
                  f"{cs.graph_ms(lambda: torch.quantize_per_tensor(x, s_, 0, torch.qint8), torch):.4f}"
                  f" ms a call from a CUDA graph on one L2-resident input [{card}]", flush=True)
        for label, v in cases[:2]:
            timed(quant, lambda k, u: (lambda: k(u, qc, bits)), v, f"quantize {mode} {label}",
                  wrapper=lambda v=v: quantize_fused(v, qc, bits=bits))
    # edge: one 1080p frame's patches, then other patch sizes
    frame = torch.from_numpy(cs.mixed_frame(cs.SEED)).cuda()
    t1, t2 = sp.DEFAULT_T1, sp.DEFAULT_T2
    for patch in (32, 48, 64, 70):
        p = get_geometry(1080, 1920, patch, 2, 4, "cuda").extract(frame)
        a, b, want = edge["base"](p), edge["new"](p), edge_score(p)
        torch.cuda.synchronize()
        ids = [sp.decide(v.cpu().numpy(), t1, t2) for v in (a, b, want)]
        ok = (torch.allclose(b, want, rtol=1e-4, atol=1e-3)
              and torch.allclose(b, a, rtol=1e-4, atol=1e-3)
              and np.array_equal(ids[1], ids[2]) and np.array_equal(ids[0], ids[1]))
        probe = "".join(f"; {tag} vs plain max_abs {(k(p) - want).abs().max().item():.3e}"
                        for tag, k in edge.items() if tag not in ("base", "new"))
        print(f"check edge {p.shape[0]} patches {patch}x{patch}: new vs plain max_abs "
              f"{(b - want).abs().max().item():.3e}, vs base {(b - a).abs().max().item():.3e}, "
              f"routing ids equal {ok}{probe}", flush=True)
        if not ok:
            sys.exit("FAIL: the edge kernels disagree")
        if patch == 32:
            timed(edge, lambda k, u: (lambda: k(u)), p, f"edge {p.shape[0]} patches 32x32",
                  wrapper=lambda p=p: edge_score_fused(p))
    print("ok", flush=True)


if __name__ == "__main__":
    main()
