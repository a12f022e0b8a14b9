"""Integer-domain quantized ESSR kernels (PAMS serving path, Sec. IV-H):
the host side of ``repro.kernels.qconv`` and the wrappers of the four CUDA
kernels: quantize in ``csrc/qconv.cu``, qBSConv in ``csrc/bsconv.cu`` (the
BSConv band walker's codes datapath, sized by
`kernels.bsconv.bsconv_report`), qSFB in ``csrc/qsfb.cu`` (a band walker
with its 1x1 dots on the tensor cores, sized by :func:`qsfb_report`) and
qDSConv in ``csrc/dsconv.cu`` (the DSConv band walker's codes datapath,
sized by `kernels.dsconv.dsconv_report`).

Activations travel between the fused groups as integer codes (int8 under
``"int8"``, int32 under ``"fxp10"``). A 1x1 whose input is a lattice is an
integer dot with an int32 sum, dequantized by one folded per-channel scale
(input step x weight step) plus bias; a conv that reads a wide intermediate
(the depthwise inside BSConv, the trailing 1x1 of DSConv) runs in fp with
fake-quant weights; each group requantizes its output once. The chain:

    quantize -> qBSConv -> n_sfb x qSFB -> qDSConv -> one dequant -> pixel shuffle

Every wrapper checks its operands, takes its plain version
(`kernels.ref.quantize_ref` / ``qbsconv_ref`` / ``qsfb_ref`` /
``qdsconv_ref``) on CPU tensors, and launches its kernel on CUDA tensors
(codes equal to the plain version bit for bit), counting launches in
``<wrapper>.launches``. The scalar site constants (clip a, step s) travel
as ``qc``, a slice of one small fp32 buffer on the codes' device.

The CUDA kernels take any batch size, so the reference's bucket padding and
its pad-row mask (``essr_forward_qkernels``, qconv.py:417-426) have no
counterpart: the mask zeroed only rows that are sliced off, as every op is
per patch.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.caching import BoundedCache
from repro_torch.kernels import _build
from repro_torch.kernels._launch import (CODE_DTYPES, MAX_CHANNELS, check_channels,
                                        check_operands, stream_of)
from repro_torch.kernels.bsconv import launch_shape as bsconv_launch_shape
from repro_torch.kernels.dsconv import launch_shape as dsconv_launch_shape
from repro_torch.kernels.megakernel import SMEM_LIMIT, _TreeKey
from repro_torch.kernels.ref import qbsconv_ref, qdsconv_ref, qsfb_ref, quantize_ref
from repro_torch.kernels.sfb import _busy, _up
from repro_torch.models.essr import ESSRConfig, slice_width
from repro_torch.models.layers import pixel_shuffle
from repro_torch.quant.pams import (EPS, QuantPack, _act_points, _clip, code_dtype, step_size,
                                    weight_alpha)

#: Operand order of the C entry ``qsfb_forward`` (after the input codes).
QSFB_KEYS = ("b1_pwq", "b1_pw_scale", "b1_pwb", "b1_dw_fq", "b1_dwb",
             "b2_pwq", "b2_pw_scale", "b2_pwb", "b2_dw_fq", "b2_dwb",
             "fuseq", "fuse_scale_y", "fuse_scale_x", "fuseb")
#: Widest output band of a qSFB work item, pixels (csrc/qsfb.cu ``BAND``).
QSFB_BAND = 32
#: Most output rows a qSFB step, and most threads a block (``MAX_THREADS``).
QSFB_MAX_ROWS, QSFB_MAX_THREADS = 8, 512
#: Shared memory of one H100 SM, of which each resident block also holds 1 KB.
SM_SMEM = 233_472


# ---------------------------------------------------------------------------
# scalar quant constants, in float32 numpy (verbatim from the reference)
# ---------------------------------------------------------------------------

def act_qconsts(alpha_raw: float, qmax: int) -> Tuple[float, float]:
    """(clip, step) of an activation site: ``|alpha| + 1e-8`` and the
    EPS-floored step, evaluated in float32."""
    a = np.float32(np.abs(np.float32(alpha_raw)) + np.float32(1e-8))
    s = np.maximum(a / np.float32(qmax), np.float32(EPS))
    return float(a), float(s)


# ---------------------------------------------------------------------------
# operand preparation: weight codes + folded scales, per subnet width
# ---------------------------------------------------------------------------

def _qweight(w: torch.Tensor, per_channel: bool, qmax: int):
    """Weight -> (integer codes, fp-valued; step). The step always comes
    back (1,1,1,Cout)-shaped: a per-tensor step is broadcast up."""
    a = weight_alpha(w, per_channel)
    s = step_size(a, qmax)
    codes = torch.round(_clip(w, a) / s)
    if s.ndim == 0:
        s = s.expand(1, 1, 1, w.shape[-1])
    return codes, s


def prepare_qparams(params, cfg: ESSRConfig, width: int, pack: QuantPack,
                    device=None) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """Width-sliced param tree -> kernel operands + scalar site constants.

    Computed on the CPU in float32 (the reference's arithmetic, free of the
    card's scalar-division shortcut), then moved to ``device`` (default: the
    params'). Returns ``(q, consts)``: ``q`` holds the reference's operands
    under its keys ("first", "sfbs", "recon") plus, per group, ``qc``: the
    (clip, step) pairs of its output site(s), views into ``q["consts"]``,
    one fp32 buffer of every site's pair in `_act_points` order;
    ``q["in_qc"]`` is the input site's. ``consts``: {"a_<site>", "s_<site>"}
    as Python floats."""
    device = torch.device(device) if device is not None else params["first"]["pw"].device
    params = _cpu_tree(params)
    if width != cfg.channels:
        params = slice_width(params, width)
    qmax, pc = pack.qmax, pack.per_channel_weights
    cdt = code_dtype(pack.bits)
    alphas = pack.act_scales(width)
    consts: Dict[str, float] = {}
    for site, raw in alphas.items():
        consts[f"a_{site}"], consts[f"s_{site}"] = act_qconsts(raw, qmax)

    def pw_ops(p, key, s_in: float):
        codes, s_w = _qweight(p[key], pc, qmax)
        b = p.get(f"{key}_b")
        return {f"{key}q": codes[0, 0].to(cdt), f"{key}_scale": (s_in * s_w)[0, 0, 0],
                f"{key}b": b if b is not None else torch.zeros(p[key].shape[-1])}

    def dw_fq(p):
        codes, s_w = _qweight(p["dw"], pc, qmax)
        return (codes * s_w)[:, :, 0, :], p["dw_b"]

    q: Dict[str, Any] = {}
    first = pw_ops(params["first"], "pw", consts["s_in"])
    first["dw_fq"], first["dwb"] = dw_fq(params["first"])
    q["first"] = first
    q["sfbs"] = []
    prev = "first"
    for i, p in enumerate(params["sfbs"]):
        sfb: Dict[str, Any] = {}
        b1 = pw_ops(p["b1"], "pw", consts[f"s_{prev}"])
        sfb.update({"b1_pwq": b1["pwq"], "b1_pw_scale": b1["pw_scale"], "b1_pwb": b1["pwb"]})
        sfb["b1_dw_fq"], sfb["b1_dwb"] = dw_fq(p["b1"])
        b2 = pw_ops(p["b2"], "pw", consts[f"s_sfb{i}_b1"])
        sfb.update({"b2_pwq": b2["pwq"], "b2_pw_scale": b2["pw_scale"], "b2_pwb": b2["pwb"]})
        sfb["b2_dw_fq"], sfb["b2_dwb"] = dw_fq(p["b2"])
        fcodes, fs = _qweight(p["fuse"], pc, qmax)
        sfb["fuseq"] = fcodes[0, 0].to(cdt)
        sfb["fuse_scale_y"] = (consts[f"s_sfb{i}_b2"] * fs)[0, 0, 0]
        sfb["fuse_scale_x"] = (consts[f"s_{prev}"] * fs)[0, 0, 0]
        fb = p.get("fuse_b")
        sfb["fuseb"] = fb if fb is not None else torch.zeros(width)
        q["sfbs"].append(sfb)
        prev = f"sfb{i}_out"
    rcodes, rs = _qweight(params["recon"]["dw"], pc, qmax)
    pw_codes, pw_s = _qweight(params["recon"]["pw"], pc, qmax)
    q["recon"] = {"dwq": rcodes[:, :, 0, :].to(torch.int32),
                  "dw_scale": (consts[f"s_{prev}"] * rs)[0, 0, 0],
                  "dwb": params["recon"]["dw_b"],
                  "pw_fq": (pw_codes * pw_s)[0, 0],
                  "pwb": params["recon"]["pw_b"]}

    q = _to_device(q, device)
    sites = _act_points(cfg)
    buf = torch.tensor([v for site in sites for v in (consts[f"a_{site}"], consts[f"s_{site}"])],
                       dtype=torch.float32, device=device)
    q["consts"] = buf
    q["in_qc"] = buf[0:2]
    q["first"]["qc"] = buf[2:4]
    for i, sfb in enumerate(q["sfbs"]):
        sfb["qc"] = buf[4 + 6 * i: 10 + 6 * i]
    q["recon"]["qc"] = buf[-2:]
    return q, consts


def _cpu_tree(tree):
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu_tree(v) for v in tree]
    return tree.detach().to("cpu", torch.float32)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device).contiguous()


def _sfb_consts(consts: Dict[str, float], i: int) -> Tuple[float, ...]:
    return (consts[f"a_sfb{i}_b1"], consts[f"s_sfb{i}_b1"],
            consts[f"a_sfb{i}_b2"], consts[f"s_sfb{i}_b2"],
            consts[f"a_sfb{i}_out"], consts[f"s_sfb{i}_out"])


#: Prepared operands by (param tree, cfg, width, pack, device).
prepared_qparams = BoundedCache(
    lambda key, cfg, width, pack, device: prepare_qparams(key.tree, cfg, width, pack, device),
    maxsize=16)


# ---------------------------------------------------------------------------
# the qSFB kernel's sizing
# ---------------------------------------------------------------------------

def _qsfb_layout(c: int, w: int, code_bytes: int) -> Dict[str, int]:
    """csrc/qsfb.cu ``Shape``: channel paddings, operand and ring strides,
    column bands and ring row widths."""
    cp8 = _up(c, 8)
    kp = _up(c, 32 if code_bytes == 1 else 8)
    ast = kp * code_bytes
    if (ast // 16) % 2 == 0:            # an odd multiple of 16 B: ldmatrix rows on distinct banks
        ast += 16
    bw = -(-w // -(-w // QSFB_BAND))
    rw1 = min(w, bw + 4)
    return {"cp8": cp8, "kp": kp, "ast": ast, "pst": cp8 + 8 if cp8 % 16 == 0 else cp8,
            "bw": bw, "bands": -(-w // bw), "rw1": rw1, "rw2": min(w, bw + 2),
            "srow": _up(rw1 * c * code_bytes, 16)}


def _qsfb_smem(lay: Dict[str, int], rows: int, code_bytes: int) -> int:
    """Dynamic shared memory of one block, as ``Shape::smem_bytes``: the x
    ring (S + 2 rows; fxp10 also the S rows in flight), int8's staging ring
    (S + 2 rows), the pw1 and pw2 rings (S + 2 rows each), Y, three transposed
    weight matrices, two depthwise kernels and nine vectors."""
    m, rw1, rw2, ast, pst, cp8 = (rows + 2, lay["rw1"], lay["rw2"], lay["ast"], lay["pst"],
                                  lay["cp8"])
    xr, staged = (m, m * lay["srow"]) if code_bytes == 1 else (2 * rows + 2, 0)
    return (xr * rw1 * ast + staged + 4 * m * (rw1 + rw2) * pst
            + (rows + 1) * rw2 * ast + 3 * cp8 * ast + 4 * 27 * cp8)


def _dot_tasks(pixels: int, cp8: int, warps: int) -> int:
    """Warp tasks of one dot stage, as ``dot_stage`` forms them: M-tiles of
    16 pixels times groups of an even number of 8-channel n-tiles."""
    mt, nt = -(-pixels // 16), cp8 // 8
    groups = max(1, min(-(-warps // max(mt, 1)), (nt + 1) // 2))
    ntg = _up(-(-nt // groups), 2)
    return mt * -(-nt // ntg)


def qsfb_report(c: int, h: int, w: int, bits: int) -> Dict[str, Any]:
    """Static sizing of the qSFB kernel on the H100 for (h, w) patches of
    ``c`` channels and ``bits``-bit codes (8: int8, wider: int32): column
    bands and their width, output rows a step, threads, dynamic shared-memory
    bytes a block (the launch uses exactly these), blocks an SM holds by
    shared memory and threads (registers may allow fewer: ``qsfb_blocks_per_sm``
    on the card says), 1x1 pixel-dots per output pixel (4.0 when one band
    spans the patch), and the share of warps that work in a full step's dot
    stages and of threads in its depthwise stages. Raises ValueError when no
    step fits a block's 232,448 B."""
    if not (1 <= c <= MAX_CHANNELS and h >= 1 and w >= 1):
        raise ValueError(f"qsfb_report: C={c}, patch {h}x{w}: C must be in 1..{MAX_CHANNELS} "
                         f"and the patch at least 1x1")
    code_bytes = 1 if bits <= 8 else 4
    lay = _qsfb_layout(c, w, code_bytes)
    rows = next((s for s in range(min(QSFB_MAX_ROWS, h), 0, -1)
                 if _qsfb_smem(lay, s, code_bytes) <= SMEM_LIMIT), 0)
    if rows == 0:
        raise ValueError(f"qsfb_report: C={c}, patch {h}x{w}, {bits}-bit codes: one row a step "
                         f"needs {_qsfb_smem(lay, 1, code_bytes)} B of shared memory, over the "
                         f"H100's {SMEM_LIMIT} B per block")
    threads = QSFB_MAX_THREADS
    smem = _qsfb_smem(lay, rows, code_bytes)
    bw, cp8 = lay["bw"], lay["cp8"]
    # columns each band computes: x / pw1, dw1 / pw2, and its output
    cols = [(min(w, b + bw + 2) - max(0, b - 2), min(w, b + bw + 1) - max(0, b - 1),
             min(w, b + bw) - b) for b in range(0, w, bw)]
    w1, w2, w3 = cols[0]
    warps = threads // 32
    dot_tasks = [_dot_tasks(rows * width, cp8, warps) for width in (w1, w2, w3)]
    dw_items = []
    for width in (w2, w3):
        per_row = cp8 // 4 * -(-width // 2)
        dw_items.append(per_row * max(1, min(rows, threads // per_row)))
    return {"bands": lay["bands"], "band_width": bw, "rows_per_step": rows, "threads": threads,
            "smem_bytes": smem, "smem_limit": SMEM_LIMIT,
            "blocks_per_sm": min(SM_SMEM // (smem + 1024), 2048 // threads),
            "pixel_dots_per_output_px": sum(a + b + 2 * o for a, b, o in cols) / w,
            "dot_busy": min(_busy(n, warps) for n in dot_tasks),
            "depthwise_busy": min(_busy(n, threads) for n in dw_items)}


@functools.lru_cache(maxsize=64)
def _qsfb_launch_shape(c: int, h: int, w: int, bits: int) -> Tuple[int, int]:
    """(rows a step, threads) of `qsfb_report`, kept per shape: the wrapper
    runs once per qSFB launch."""
    rep = qsfb_report(c, h, w, bits)
    return rep["rows_per_step"], rep["threads"]


# ---------------------------------------------------------------------------
# the four kernels' wrappers
# ---------------------------------------------------------------------------

def _code_bits(dtype: torch.dtype) -> int:
    """The C entries' ``bits``: 8 picks int8_t codes, anything wider int32_t."""
    return 8 if dtype == torch.int8 else 32


def _device_or_raise(what: str, x: torch.Tensor) -> bool:
    """True for a CPU tensor (take the plain version); raises for a device
    with no kernel."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    return False


def quantize_fused(x: torch.Tensor, qc: torch.Tensor, *, bits: int) -> torch.Tensor:
    """fp (N,H,W,C) -> lattice codes round(clip(x, -a, a) / s), int8 for
    ``bits`` <= 8 else int32; ``qc`` = (a, s)."""
    check_operands("quantize_fused", x, {"qc": (qc, (2,))})
    dtype = code_dtype(bits)
    if _device_or_raise("quantize_fused", x):
        return quantize_ref(x, qc, dtype)
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    if x.numel() == 0:
        return out
    if x.numel() >= 2 ** 31:
        raise ValueError(f"quantize_fused: {x.numel()} elements, over the kernel's 2^31 - 1")
    launch = _build.entry("qconv", "quantize_forward", 3, 2)
    launch(x.data_ptr(), qc.data_ptr(), out.data_ptr(), x.numel(), _code_bits(dtype),
           stream_of(x))
    quantize_fused.launches += 1
    return out


def qbsconv_fused(xq: torch.Tensor, pwq: torch.Tensor, pw_scale: torch.Tensor,
                  pw_b: torch.Tensor, dw_fq: torch.Tensor, dw_b: torch.Tensor,
                  qc: torch.Tensor, *, relu: bool) -> torch.Tensor:
    """xq: (N,H,W,Cin) codes; pwq: (Cin,Cout) codes of the same dtype;
    pw_scale: (Cout,) folded step; dw_fq: (3,3,Cout) fake-quant fp; ``qc``:
    the output site's (a, s). Returns (N,H,W,Cout) codes. The kernel is the
    BSConv band walker's codes datapath (``csrc/bsconv.cu``), launched with
    `kernels.bsconv.bsconv_report`'s rows and threads."""
    cin = int(xq.shape[-1]) if xq.ndim == 4 else -1
    cout = int(pwq.shape[-1]) if pwq.ndim == 2 else -1
    check_operands("qbsconv_fused", xq, {
        "pwq": (pwq, (cin, cout), xq.dtype), "pw_scale": (pw_scale, (cout,)),
        "pw_b": (pw_b, (cout,)), "dw_fq": (dw_fq, (3, 3, cout)), "dw_b": (dw_b, (cout,)),
        "qc": (qc, (2,))}, dtype=CODE_DTYPES)
    check_channels("qbsconv_fused", Cin=cin, Cout=cout)
    if _device_or_raise("qbsconv_fused", xq):
        return qbsconv_ref(xq, pwq, pw_scale, pw_b, dw_fq, dw_b, qc, relu=relu)
    n, h, w, _ = xq.shape
    out = torch.empty((n, h, w, cout), dtype=xq.dtype, device=xq.device)
    if out.numel() == 0:
        return out
    bits = _code_bits(xq.dtype)
    launch = _build.entry("bsconv", "qbsconv_forward", 8, 9)
    launch(xq.data_ptr(), pwq.data_ptr(), pw_scale.data_ptr(), pw_b.data_ptr(),
           dw_fq.data_ptr(), dw_b.data_ptr(), qc.data_ptr(), out.data_ptr(),
           n, h, w, cin, cout, int(relu), bits, *bsconv_launch_shape(cin, cout, h, w, bits),
           stream_of(xq))
    qbsconv_fused.launches += 1
    return out


def qsfb_fused(xq: torch.Tensor, q: Dict[str, torch.Tensor], qc: torch.Tensor) -> torch.Tensor:
    """Whole SFB on the lattice in one launch. xq: (N,H,W,C) codes; ``q``:
    the `QSFB_KEYS` operands of `prepare_qparams` (code weights (C,C) of
    xq's dtype, depthwise (3,3,C) fp, the rest (C,)); ``qc``: the six
    (a, s) of sites b1, b2 and out. Returns (N,H,W,C) codes. The kernel
    (``csrc/qsfb.cu``) launches with `qsfb_report`'s rows and threads; its
    fxp10 dots are exact for codes and weight codes in [-511, 511], the
    lattice's range."""
    c = int(xq.shape[-1]) if xq.ndim == 4 else -1
    spec = {}
    for k in QSFB_KEYS:
        if k.endswith("pwq") or k == "fuseq":
            spec[k] = (q[k], (c, c), xq.dtype)
        else:
            spec[k] = (q[k], (3, 3, c) if k.endswith("dw_fq") else (c,))
    spec["qc"] = (qc, (6,))
    check_operands("qsfb_fused", xq, spec, dtype=CODE_DTYPES)
    check_channels("qsfb_fused", C=c)
    if _device_or_raise("qsfb_fused", xq):
        return qsfb_ref(xq, q, qc)
    n, h, w, _ = xq.shape
    out = torch.empty_like(xq)
    if n == 0:
        return out
    bits = _code_bits(xq.dtype)
    launch = _build.entry("qsfb", "qsfb_forward", 17, 7)
    launch(xq.data_ptr(), *(q[k].data_ptr() for k in QSFB_KEYS), qc.data_ptr(),
           out.data_ptr(), n, h, w, c, bits, *_qsfb_launch_shape(c, h, w, bits), stream_of(xq))
    qsfb_fused.launches += 1
    return out


def qdsconv_fused(xq: torch.Tensor, dwq: torch.Tensor, dw_scale: torch.Tensor,
                  dw_b: torch.Tensor, pw_fq: torch.Tensor, pw_b: torch.Tensor,
                  qc: torch.Tensor) -> torch.Tensor:
    """xq: (N,H,W,Cin) codes; dwq: (3,3,Cin) int32 codes; dw_scale, dw_b:
    (Cin,); pw_fq: (Cin,Cout) fake-quant fp; ``qc``: the recon site's
    (a, s). Returns (N,H,W,Cout) codes. The kernel is the DSConv band
    walker's codes datapath (``csrc/dsconv.cu``), launched with
    `kernels.dsconv.dsconv_report`'s rows and threads."""
    cin = int(xq.shape[-1]) if xq.ndim == 4 else -1
    cout = int(pw_fq.shape[-1]) if pw_fq.ndim == 2 else -1
    check_operands("qdsconv_fused", xq, {
        "dwq": (dwq, (3, 3, cin), torch.int32), "dw_scale": (dw_scale, (cin,)),
        "dw_b": (dw_b, (cin,)), "pw_fq": (pw_fq, (cin, cout)), "pw_b": (pw_b, (cout,)),
        "qc": (qc, (2,))}, dtype=CODE_DTYPES)
    check_channels("qdsconv_fused", Cin=cin, Cout=cout)
    if _device_or_raise("qdsconv_fused", xq):
        return qdsconv_ref(xq, dwq, dw_scale, dw_b, pw_fq, pw_b, qc)
    n, h, w, _ = xq.shape
    out = torch.empty((n, h, w, cout), dtype=xq.dtype, device=xq.device)
    if n == 0:
        return out
    bits = _code_bits(xq.dtype)
    launch = _build.entry("dsconv", "qdsconv_forward", 8, 8)
    launch(xq.data_ptr(), dwq.data_ptr(), dw_scale.data_ptr(), dw_b.data_ptr(),
           pw_fq.data_ptr(), pw_b.data_ptr(), qc.data_ptr(), out.data_ptr(),
           n, h, w, cin, cout, bits, *dsconv_launch_shape(cin, cout, h, w, bits), stream_of(xq))
    qdsconv_fused.launches += 1
    return out


for _fn in (quantize_fused, qbsconv_fused, qsfb_fused, qdsconv_fused):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# whole-model chains: the kernels, and the port's integer reference
# ---------------------------------------------------------------------------

def _prepared(params, cfg: ESSRConfig, width: Optional[int], pack: QuantPack,
              x: torch.Tensor):
    w = width if width is not None else cfg.channels
    if w <= 0:
        raise ValueError("the bilinear subnet does not use the conv kernels")
    if not w <= cfg.channels:
        raise ValueError(f"width {w} outside 1..{cfg.channels}")
    return prepared_qparams(_TreeKey(params), cfg, w, pack, str(x.device))


def essr_forward_qkernels(params: Dict[str, Any], x: torch.Tensor, cfg: ESSRConfig,
                          width: Optional[int] = None, *, pack: QuantPack) -> torch.Tensor:
    """x: (N,p,p,3) fp in [0,1] -> (N,p*s,p*s,3) through the four integer
    kernels: quantize once at the input site, every group on the lattice,
    one dequant after the recon site. Bilinear patches (width 0) never
    reach the kernels. Prepared operands are cached by the tree's tensors,
    the width, the pack and the device."""
    q, _ = _prepared(params, cfg, width, pack, x)
    if x.shape[0] == 0:
        s = cfg.scale
        return x.new_zeros((0, x.shape[1] * s, x.shape[2] * s, cfg.in_channels))
    first, recon = q["first"], q["recon"]
    f = quantize_fused(x, q["in_qc"], bits=pack.bits)
    f = qbsconv_fused(f, first["pwq"], first["pw_scale"], first["pwb"], first["dw_fq"],
                      first["dwb"], first["qc"], relu=False)
    for sfb in q["sfbs"]:
        f = qsfb_fused(f, sfb, sfb["qc"])
    r = qdsconv_fused(f, recon["dwq"], recon["dw_scale"], recon["dwb"], recon["pw_fq"],
                      recon["pwb"], recon["qc"])
    return pixel_shuffle(r.to(torch.float32) * recon["qc"][1], cfg.scale)


def essr_forward_qref(params: Dict[str, Any], x: torch.Tensor, cfg: ESSRConfig,
                      width: Optional[int] = None, *, pack: QuantPack,
                      return_codes: bool = False):
    """The port's integer reference: the chain of `essr_forward_qkernels`
    through the plain versions alone, on ``x``'s device. ``return_codes``:
    also return {site: codes} at "in", "first", "sfb<i>_out" and "recon"."""
    q, _ = _prepared(params, cfg, width, pack, x)
    first, recon = q["first"], q["recon"]
    codes: Dict[str, torch.Tensor] = {}
    f = codes["in"] = quantize_ref(x, q["in_qc"], code_dtype(pack.bits))
    f = codes["first"] = qbsconv_ref(f, first["pwq"], first["pw_scale"], first["pwb"],
                                     first["dw_fq"], first["dwb"], first["qc"], relu=False)
    for i, sfb in enumerate(q["sfbs"]):
        f = codes[f"sfb{i}_out"] = qsfb_ref(f, sfb, sfb["qc"])
    r = codes["recon"] = qdsconv_ref(f, recon["dwq"], recon["dw_scale"], recon["dwb"],
                                     recon["pw_fq"], recon["pwb"], recon["qc"])
    img = pixel_shuffle(r.to(torch.float32) * recon["qc"][1], cfg.scale)
    return (img, codes) if return_codes else img
