#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one line or more each; any failure exits non-zero before the last
line:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the path from the sources in this checkout
     (one nvcc per source, all started together) and time it;
  3. hold each kernel against its plain PyTorch version on the card, at C54
     and C27 (bsconv also at Cin = 3) and N in {1, 7, 512}, rtol 1e-4 /
     atol 1e-5 (TF32 off for the plain versions); the subnet-group
     megakernel (the whole 12-layer chain) against its plain version and
     against the layer chain of kernels at C54 and C27, N in {1, 7, 512}
     and at an odd 13x21 patch, rtol 1e-3 / atol 1e-3;
  4. time each kernel at N = 1024 C54 32x32 patches (CUDA events, median of
     25 launches) beside its plain version, a cuDNN composition of the same
     function (a yardstick only: the port never calls it) and its bound;
     the megakernel also beside the layer chain (the sum of the per-op
     kernels' times);
  5. the main path: SREngine.from_config(ESSRConfig(scale=4)) on the card
     with the default plan and backend "cuda", warm-up, then three
     synthetic 1920x1080 LR frames to 7680x4320 with every routing bucket
     filled; the launch counts of that run must show bsconv, 5 x sfb and
     dsconv for each non-empty conv bucket and no megakernel; the three
     frames again through backend "ref" must route identically and agree
     (rtol 1e-3 / atol 1e-3); one more frame runs under torch.profiler for
     device time by kernel;
  6. group fusion: the same engine's weights under
     ExecutionPlan(fusion="group") serve the same three frames; the launch
     counts must show one megakernel launch per non-empty conv bucket and
     no per-op launch, the ids must equal the layer frames' and the images
     the "ref" frames' (rtol 1e-3 / atol 1e-3); one frame is profiled;
  7. the TPU kernel table with each row's port status, the per-kernel JSON
     line, and the result line.

It imports torch and the port (src/repro_torch), never JAX or the JAX
package. It exits non-zero without a result when no CUDA card is visible or
when the port's sources are not beside it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
TOL = dict(rtol=1e-4, atol=1e-5)          # kernel vs plain, fp32 both sides
CHAIN_TOL = dict(rtol=1e-3, atol=1e-3)    # whole frame, "cuda" vs "ref"
TIMING_N, TIMING_RUNS = 1024, 25

#: Published H100/H200 peaks (NVIDIA data sheets): fp32 outside the tensor
#: cores, and device-memory bandwidth, by a substring of the card's name.
PEAKS = (("H100 PCIe", 51e12, 2.0e12), ("H100 NVL", 60e12, 3.9e12),
         ("H200", 67e12, 4.8e12), ("H100", 67e12, 3.35e12))

#: Every TPU kernel of the JAX package (each function reaching pl.pallas_call).
TPU_KERNELS = (
    ("bsconv_fused", "src/repro/kernels/bsconv.py:57", "ported"),
    ("sfb_fused", "src/repro/kernels/sfb.py:42", "ported"),
    ("dsconv_fused", "src/repro/kernels/dsconv.py:34", "ported"),
    ("essr_forward_megakernel", "src/repro/kernels/megakernel.py:292", "ported"),
    ("essr_forward_qmegakernel", "src/repro/kernels/megakernel.py:360", "not yet"),
    ("quantize_fused", "src/repro/kernels/qconv.py:147", "not yet"),
    ("qbsconv_fused", "src/repro/kernels/qconv.py:175", "not yet"),
    ("qsfb_fused", "src/repro/kernels/qconv.py:224", "not yet"),
    ("qdsconv_fused", "src/repro/kernels/qconv.py:270", "not yet"),
    ("edge_score_fused", "src/repro/kernels/edge.py:33", "not yet"),
)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        fail("nvidia-smi printed nothing")
    return out[0]


def peaks_for(name: str):
    for key, flops, bw in PEAKS:
        if key in name:
            return flops, bw
    return PEAKS[-1][1:]


# ---------------------------------------------------------------------------
# operands, plain versions, cuDNN yardsticks, work counts
# ---------------------------------------------------------------------------

def operands(kind: str, n: int, c: int, g, torch, cin: int = 3, cout: int = 48):
    """Random activations and He-normal weights with non-zero biases (a halo
    pixel reading pw(0) + b instead of 0 would show)."""
    def he(shape, fan):
        return (torch.randn(shape, generator=g) * (2.0 / fan) ** 0.5).cuda()

    def bias(k):
        return (0.1 * torch.randn(k, generator=g)).cuda()

    if kind == "bsconv":
        x = torch.rand((n, 32, 32, cin), generator=g).cuda()
        return x, dict(pw=he((cin, c), cin), pw_b=bias(c), dw=he((3, 3, c), 9), dw_b=bias(c))
    x = torch.rand((n, 32, 32, c), generator=g).cuda()
    if kind == "dsconv":
        return x, dict(dw=he((3, 3, c), 9), dw_b=bias(c), pw=he((c, cout), c), pw_b=bias(cout))
    p = {}
    for b in ("b1", "b2"):
        p.update({f"{b}_pw": he((c, c), c), f"{b}_pwb": bias(c),
                  f"{b}_dw": he((3, 3, c), 9), f"{b}_dwb": bias(c)})
    p.update(fuse=he((c, c), c), fuse_b=bias(c))
    return x, p


def runners(kind: str, torch):
    """(kernel, plain, cuDNN composition) for one kernel, each f(x, w)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.bsconv import bsconv_fused
    from repro_torch.kernels.dsconv import dsconv_fused
    from repro_torch.kernels.sfb import sfb_fused

    def conv1x1(xc, w, b):            # xc: NCHW view of NHWC data; w: (Ci, Co)
        return F.conv2d(xc, w.t().reshape(w.shape[1], w.shape[0], 1, 1), b)

    def dw3(xc, w, b):                # w: (3, 3, C)
        return F.conv2d(xc, w.permute(2, 0, 1)[:, None], b, padding=1, groups=w.shape[-1])

    def nhwc(y):
        return y.permute(0, 2, 3, 1)

    if kind == "bsconv":
        def lib(x, w):
            return nhwc(dw3(conv1x1(x.permute(0, 3, 1, 2), w["pw"], w["pw_b"]),
                            w["dw"], w["dw_b"]))
        return (lambda x, w: bsconv_fused(x, w["pw"], w["pw_b"], w["dw"], w["dw_b"]),
                lambda x, w: ref.bsconv_ref(x, w["pw"], w["pw_b"], w["dw"], w["dw_b"]), lib)
    if kind == "dsconv":
        def lib(x, w):
            return nhwc(conv1x1(dw3(x.permute(0, 3, 1, 2), w["dw"], w["dw_b"]),
                                w["pw"], w["pw_b"]))
        return (lambda x, w: dsconv_fused(x, w["dw"], w["dw_b"], w["pw"], w["pw_b"]),
                lambda x, w: ref.dsconv_ref(x, w["dw"], w["dw_b"], w["pw"], w["pw_b"]), lib)

    def lib(x, p):
        xc = x.permute(0, 3, 1, 2)
        y = torch.relu(dw3(conv1x1(xc, p["b1_pw"], p["b1_pwb"]), p["b1_dw"], p["b1_dwb"]))
        y = torch.relu(dw3(conv1x1(y, p["b2_pw"], p["b2_pwb"]), p["b2_dw"], p["b2_dwb"]))
        return nhwc(torch.relu(conv1x1(y + xc, p["fuse"], p["fuse_b"])))
    return sfb_fused, ref.sfb_ref, lib


def work(kind: str, n: int, c: int, cin: int = 3, cout: int = 48):
    """(bytes each input read once and each output written once, flops)."""
    px = n * 32 * 32
    if kind == "bsconv":
        return 4 * (px * (cin + c) + cin * c + 11 * c), 2 * px * (cin * c + 9 * c)
    if kind == "dsconv":
        return 4 * (px * (c + cout) + 10 * c + c * cout + cout), 2 * px * (9 * c + c * cout)
    return 4 * (2 * px * c + 3 * c * c + 23 * c), 2 * px * (3 * c * c + 18 * c)


def mega_operands(width: int, g, torch):
    """An ESSR x4 param tree on the card (He-normal weights from ``g``, and
    non-zero biases: a halo reading pw(0) + b instead of 0 would show) and
    its packed megakernel buffer at ``width``."""
    from repro_torch.kernels import megakernel as mk
    from repro_torch.models.essr import ESSR, ESSRConfig
    tree = ESSR(ESSRConfig(scale=4), generator=g).cuda().requires_grad_(False).tree()
    for leaf in mk._leaves(tree):
        if leaf.ndim == 1:
            leaf.copy_(0.1 * torch.randn(leaf.shape, generator=g))
    return tree, mk.pack_weights(tree, width)


def mega_library(x, w, torch):
    """The whole chain as a cuDNN composition (NCHW 1x1 and depthwise
    conv2d), on the unpacked weights ``w``: a yardstick only."""
    import torch.nn.functional as F

    def conv1x1(xc, m, b):
        return F.conv2d(xc, m.t().reshape(m.shape[1], m.shape[0], 1, 1), b)

    def dw3(xc, k, b):
        return F.conv2d(xc, k.permute(2, 0, 1)[:, None], b, padding=1, groups=k.shape[-1])

    p = w["first"]
    f = dw3(conv1x1(x.permute(0, 3, 1, 2), p["pw"], p["pw_b"]), p["dw"], p["dw_b"])
    for s in w["sfbs"]:
        y = torch.relu(dw3(conv1x1(f, s["b1_pw"], s["b1_pwb"]), s["b1_dw"], s["b1_dwb"]))
        y = torch.relu(dw3(conv1x1(y, s["b2_pw"], s["b2_pwb"]), s["b2_dw"], s["b2_dwb"]))
        f = torch.relu(conv1x1(y + f, s["fuse"], s["fuse_b"]))
    r = w["recon"]
    return conv1x1(dw3(f, r["dw"], r["dw_b"]), r["pw"], r["pw_b"]).permute(0, 2, 3, 1)


def median_ms(fn, torch) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_RUNS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# the main path's synthetic frames
# ---------------------------------------------------------------------------

def mixed_frame(seed: int, h: int = 1080, w: int = 1920):
    """Left half a smooth gradient (bilinear), then a mildly textured
    quarter (C27) and a strongly textured quarter (C54), from a numpy seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                         np.linspace(0, 1, w, dtype=np.float32), indexing="ij")
    smooth = np.stack([yy, xx, (yy + xx) / 2], axis=-1)
    amp = np.where(xx < 0.5, 0.0, np.where(xx < 0.75, 0.12, 0.5)).astype(np.float32)
    noise = rng.random((h, w, 3), dtype=np.float32) - 0.5
    return np.clip(smooth + amp[..., None] * noise, 0.0, 1.0).astype(np.float32)


def profile_frame(engine, frame, wall_s: float, torch) -> None:
    """One more frame under torch.profiler: device time by kernel, and the
    device's busy share of the unprofiled frame's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.upscale(frame)
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or "Activity Buffer" in e.key:
            continue                    # host ops, and the profiler's own buffers
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    busy = sum(ms for ms, _, _ in rows)
    if not rows:
        say("phase profile: the profiler recorded no device time (not measured)")
        return
    say(f"phase profile: device busy {busy:.3f} ms of an unprofiled frame's "
        f"{wall_s * 1e3:.3f} ms wall (idle share "
        f"{max(0.0, 1 - busy / (wall_s * 1e3)):.3f})")
    for ms, count, key in sorted(rows, reverse=True)[:10]:
        say(f"  {ms:9.3f} ms  x{count:<4d} {key[:100]}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"the port's sources (src/repro_torch) are not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np
    from repro_torch.api import ExecutionPlan, SREngine
    from repro_torch.kernels import _build
    from repro_torch.kernels import megakernel as mk
    from repro_torch.kernels.ops import essr_forward_kernels, launch_counts, reset_launch_counts
    from repro_torch.kernels.ref import mega_ref
    from repro_torch.models.essr import ESSRConfig

    # 1. the card
    card = card_line()
    say(card)
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = peaks_for(name)
    say(f"phase card: {name}; fp32 peak {peak_flops / 1e12:g} TFLOP/s, "
        f"memory {peak_bw / 1e12:g} TB/s (data sheet); "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    reports = _build.build(["bsconv", "sfb", "dsconv", "mega"])
    say(f"phase build: {time.perf_counter() - t0:.1f} s")
    for lib, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {lib}: {line.strip()}")

    # 3. each kernel against its plain version
    g = torch.Generator().manual_seed(SEED)
    cases = [("bsconv", 54, 3), ("bsconv", 27, 3), ("bsconv", 54, 54), ("bsconv", 27, 27),
             ("sfb", 54, None), ("sfb", 27, None), ("dsconv", 54, None), ("dsconv", 27, None)]
    max_err = {"bsconv": 0.0, "sfb": 0.0, "dsconv": 0.0, "mega": 0.0}
    for kind, c, cin in cases:
        kern, plain, _ = runners(kind, torch)
        for n in (1, 7, 512):
            x, w = operands(kind, n, c, g, torch, cin=cin or 3)
            got = kern(x, w)
            torch.cuda.synchronize()
            want = plain(x, w)
            err = (got - want).abs().max().item()
            rel = ((got - want).abs() / want.abs().clamp_min(1e-6)).max().item()
            ok = torch.allclose(got, want, **TOL)
            say(f"phase check {kind} C={c}{'' if cin is None else f' Cin={cin}'} N={n}: "
                f"max_abs {err:.3e} max_rel {rel:.3e} "
                f"(rtol {TOL['rtol']:g} atol {TOL['atol']:g}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"{kind} disagrees with its plain version")
            max_err[kind] = max(max_err[kind], err)

    cfg = ESSRConfig(scale=4)
    for width in (54, 27):
        tree, wbuf = mega_operands(width, g, torch)
        lay = mk.WeightLayout(3, width, cfg.out_channels, cfg.n_sfb)
        for n, h, w in ((1, 32, 32), (7, 32, 32), (512, 32, 32), (3, 13, 21)):
            x = torch.rand((n, h, w, 3), generator=g).cuda()
            got = mk.mega_fused(x, wbuf, width=width, n_sfb=cfg.n_sfb,
                                out_channels=cfg.out_channels)
            torch.cuda.synchronize()
            want = mega_ref(x, mk.unpack_weights(wbuf, lay))
            err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, **CHAIN_TOL)
            layer = essr_forward_kernels(tree, x, cfg, width=width)
            mega = mk.essr_forward_megakernel(tree, x, cfg, width=width)
            torch.cuda.synchronize()
            err_layer = (mega - layer).abs().max().item()
            ok_layer = torch.allclose(mega, layer, **CHAIN_TOL)
            say(f"phase check mega C={width} N={n} {h}x{w}: max_abs vs plain {err:.3e}, "
                f"vs layer chain {err_layer:.3e} (rtol {CHAIN_TOL['rtol']:g} "
                f"atol {CHAIN_TOL['atol']:g}) {'ok' if ok and ok_layer else 'MISMATCH'}")
            if not (ok and ok_layer):
                fail("the megakernel disagrees with its plain version or the layer chain")
            max_err["mega"] = max(max_err["mega"], err)
        del tree, wbuf, x, got, want, layer, mega

    # 4. times at N = 1024 C54
    timing = {}
    for kind in ("bsconv", "sfb", "dsconv"):
        kern, plain, lib = runners(kind, torch)
        x, w = operands(kind, TIMING_N, 54, g, torch)
        got, want, yard = kern(x, w), plain(x, w), lib(x, w)
        torch.cuda.synchronize()
        if not torch.allclose(got, want, **TOL):
            fail(f"{kind} disagrees with its plain version at N={TIMING_N}")
        max_err[kind] = max(max_err[kind], (got - want).abs().max().item())
        lib_err = (yard - want).abs().max().item()
        ms = median_ms(lambda: kern(x, w), torch)
        plain_ms = median_ms(lambda: plain(x, w), torch)
        lib_ms = median_ms(lambda: lib(x, w), torch)
        nbytes, flops = work(kind, TIMING_N, 54)
        t_bytes, t_flops = nbytes / peak_bw * 1e3, flops / peak_flops * 1e3
        timing[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=max(t_bytes, t_flops),
                            bound_by="bytes" if t_bytes >= t_flops else "operations")
        say(f"phase time {kind} N={TIMING_N} C54: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"cuDNN {lib_ms:.4f} ms (max_abs vs plain {lib_err:.2e}), "
            f"bound {timing[kind]['bound_ms']:.4f} ms by {timing[kind]['bound_by']} "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        del x, w, got, want, yard
    tree, wbuf = mega_operands(54, g, torch)
    wts = mk.unpack_weights(wbuf, mk.WeightLayout(3, 54, cfg.out_channels, cfg.n_sfb))
    x = torch.rand((TIMING_N, 32, 32, 3), generator=g).cuda()

    def mega():
        return mk.mega_fused(x, wbuf, width=54, n_sfb=cfg.n_sfb, out_channels=cfg.out_channels)

    got, want, yard = mega(), mega_ref(x, wts), mega_library(x, wts, torch)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, **CHAIN_TOL):
        fail(f"mega disagrees with its plain version at N={TIMING_N}")
    max_err["mega"] = max(max_err["mega"], (got - want).abs().max().item())
    ms = median_ms(mega, torch)
    plain_ms = median_ms(lambda: mega_ref(x, wts), torch)
    lib_ms = median_ms(lambda: mega_library(x, wts, torch), torch)
    sum_ms = timing["bsconv"]["ms"] + cfg.n_sfb * timing["sfb"]["ms"] + timing["dsconv"]["ms"]
    sizing = mk.group_report(54, 32, cfg.scale, cfg.n_sfb)
    flops = TIMING_N * sizing["flops_per_patch"]
    nbytes = TIMING_N * sizing["bytes_per_patch"] + sizing["weight_bytes"]
    t_bytes, t_flops = nbytes / peak_bw * 1e3, flops / peak_flops * 1e3
    timing["mega"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=max(t_bytes, t_flops),
                          bound_by="bytes" if t_bytes >= t_flops else "operations")
    say(f"phase time mega N={TIMING_N} C54: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"layer chain {sum_ms:.4f} ms (the per-op kernels' times summed), "
        f"cuDNN {lib_ms:.4f} ms (max_abs vs plain "
        f"{(yard - want).abs().max().item():.2e}), bound {timing['mega']['bound_ms']:.4f} ms "
        f"by {timing['mega']['bound_by']} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
        f"sizing {json.dumps(sizing)}, resident clusters "
        f"{mk.resident_clusters(54, 32, cfg.scale, cfg.n_sfb)}")
    del tree, wbuf, wts, x, got, want, yard
    torch.cuda.empty_cache()

    # 5. the main path
    engine = SREngine.from_config(cfg, seed=SEED, device="cuda")
    t0 = time.perf_counter()
    engine.warmup((1080, 1920))
    say(f"phase warmup: 1920x1080 -> 7680x4320 in {time.perf_counter() - t0:.3f} s")
    frames = [mixed_frame(SEED + i) for i in range(3)]
    expect = {"bsconv": 0, "sfb": 0, "dsconv": 0, "mega": 0}
    reset_launch_counts()
    layer_ids, lats = [], []
    for i, f in enumerate(frames):
        r = engine.upscale(f)
        if r.backend != "cuda":
            fail(f"frame {i} served by {r.backend!r}, not the kernels")
        if tuple(r.image.shape) != (4320, 7680, 3) or not bool(torch.isfinite(r.image).all()):
            fail(f"frame {i}: image {tuple(r.image.shape)} not a finite 4320x7680x3")
        buckets = sum(1 for k in (1, 2) if r.counts[k] > 0)
        expect["bsconv"] += buckets
        expect["sfb"] += cfg.n_sfb * buckets
        expect["dsconv"] += buckets
        say(f"phase frame {i}: latency {r.latency_s * 1e3:.2f} ms, counts "
            f"(bilinear, C27, C54) {r.counts}, mac_saving {r.mac_saving:.4f}")
        layer_ids.append(r.ids)
        lats.append(r.latency_s)
        if i == 0:
            r0 = r
    launches = launch_counts()
    say(f"phase launches over 3 frames: {launches} (expected {expect})")
    if launches != expect or min(launches[k] for k in ("bsconv", "sfb", "dsconv")) == 0:
        fail("the main path did not launch every kernel as its routing requires")
    say(f"phase summary: {json.dumps(engine.summary())}")
    profile_frame(engine, frames[1], statistics.median(lats), torch)
    ref_engine = SREngine(engine.model, backend="ref", device="cuda")
    refs = [ref_engine.upscale(f) for f in frames]
    rr = refs[0]
    ids_equal = all(np.array_equal(a, b.ids) for a, b in zip(layer_ids, refs))
    diff = (r0.image - rr.image).abs().max().item()
    close = torch.allclose(r0.image, rr.image, **CHAIN_TOL)
    say(f"phase ref: ids equal {ids_equal}, image max_abs {diff:.3e} "
        f"(rtol {CHAIN_TOL['rtol']:g} atol {CHAIN_TOL['atol']:g}) {'ok' if close else 'MISMATCH'}, "
        f"ref latency {rr.latency_s * 1e3:.2f} ms")
    if not (ids_equal and close):
        fail("the kernel frame disagrees with the plain-model frame")
    del r0

    # 6. group fusion
    group = SREngine(engine.model, plan=ExecutionPlan(fusion="group"), device="cuda")
    t0 = time.perf_counter()
    group.warmup((1080, 1920))
    say(f"phase group warmup: 1920x1080 -> 7680x4320 in {time.perf_counter() - t0:.3f} s")
    expect = {"bsconv": 0, "sfb": 0, "dsconv": 0, "mega": 0}
    reset_launch_counts()
    glats = []
    for i, f in enumerate(frames):
        r = group.upscale(f)
        if r.backend != "cuda":
            fail(f"group frame {i} served by {r.backend!r}, not the kernels")
        if tuple(r.image.shape) != (4320, 7680, 3) or not bool(torch.isfinite(r.image).all()):
            fail(f"group frame {i}: image {tuple(r.image.shape)} not a finite 4320x7680x3")
        expect["mega"] += sum(1 for k in (1, 2) if r.counts[k] > 0)
        ids_equal = bool(np.array_equal(r.ids, layer_ids[i]))
        diff = (r.image - refs[i].image).abs().max().item()
        close = torch.allclose(r.image, refs[i].image, **CHAIN_TOL)
        say(f"phase group frame {i}: latency {r.latency_s * 1e3:.2f} ms (layer frame "
            f"{lats[i] * 1e3:.2f} ms), counts {r.counts}, ids equal to the layer frame's "
            f"{ids_equal}, image vs ref max_abs {diff:.3e} {'ok' if close else 'MISMATCH'}")
        if not (ids_equal and close):
            fail(f"group frame {i} disagrees with the layer frame's routing or the ref image")
        glats.append(r.latency_s)
    launches_group = launch_counts()
    say(f"phase group launches over 3 frames: {launches_group} (expected {expect})")
    if launches_group != expect or launches_group["mega"] == 0:
        fail("group fusion did not launch the megakernel once per non-empty conv bucket")
    say(f"phase group summary: {json.dumps(group.summary())}")
    profile_frame(group, frames[1], statistics.median(glats), torch)
    del refs

    # 7. tables and the result
    say("tpu_kernels: " + json.dumps([dict(name=n, tpu=loc, status=s)
                                      for n, loc, s in TPU_KERNELS]))
    replaces = {n: loc for n, loc, _ in TPU_KERNELS}
    rows = [dict(name=k, route="cuda", source=f"src/repro_torch/csrc/{k}.cu",
                 replaces=replaces[f"{k}_fused"], launches=launches[k],
                 max_abs_err=max_err[k], **timing[k]) for k in ("bsconv", "sfb", "dsconv")]
    rows.append(dict(name="essr_forward_megakernel", route="cuda",
                     source="src/repro_torch/csrc/mega.cu",
                     replaces=replaces["essr_forward_megakernel"],
                     launches=launches_group["mega"], max_abs_err=max_err["mega"],
                     **timing["mega"]))
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
