"""Subnet-group megakernel wrapper (CUDA source: ``csrc/mega.cu``).

Twin of ``repro.kernels.megakernel``'s fp32 path
(``essr_forward_megakernel``): one launch per routed bucket runs a subnet's
whole layer chain, BSConv -> n_sfb x SFB -> DSConv, with each patch's running
feature in shared memory from entry to exit; pixel shuffle follows outside.
``ExecutionPlan(fusion="group")`` serves through it.

The TPU kernel's sizing (a VMEM budget and MXU rows, ``autotune_report``)
does not carry over: on the H100 a patch is spread over a thread-block
cluster of 1 to 16 blocks, one strip of full-width rows per block, sized by
:func:`group_report` from the shared-memory limit of a block. It serves
every patch of the paper's Table I (16, 32, 48 and 64) at C27 and C54. The
weights of one (param tree, width) are packed once into a single zero-padded
buffer of per-layer pieces (:func:`pack_weights`, cached), which the kernel
stages one layer ahead. ``mega_fused.launches`` counts launches. Outside
inference mode the fp32 forward is differentiable in both modes, as the
reference's ``custom_jvp`` makes it: the kernel computes the value, the
plain forward (recomputed) its gradient and tangent (`_MegaForward`).

The quantized twin (``essr_forward_qmegakernel``, ``csrc/qmega.cu``) serves
``ExecutionPlan(quant=..., fusion="group")``: quantize once, the whole
integer chain with the codes in shared memory, the recon codes out; one
launch per routed bucket, ``qmega_fused.launches``. It keeps the cluster
layout (4, 8 or 16 blocks a cluster, sized by :func:`qgroup_report`, every
Table I patch at C27 and C54) and runs its 1x1 dots on the tensor cores, with
the prepared integer operands packed once into one byte buffer in the dots'
operand layout (:func:`pack_qweights`, cached), which the kernel stages one
layer at a time.

Past 64x64 a patch is served in recompute-halo windows (:func:`window_plan`):
the chain's receptive radius is r = 2 + 2 n_sfb LR pixels (one 3x3
depthwise in the first layer, two in each SFB, one in the recon), so a
pixel at least r pixels inside every window edge that is not the patch's
own edge gets exactly its whole-patch value. The windows of all N patches
go through one launch of the unchanged kernel and each window's core is
stitched back, every output pixel exactly once (:func:`run_windowed`).

Both wrappers take their plain versions for CPU tensors at any patch size;
the launch shape and the windows are sized, and a shape that no window
holds refused, only for a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core.caching import BoundedCache
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_channels, check_operands, stream_of
from repro_torch.kernels.ref import mega_ref, qmega_ref
from repro_torch.models.essr import ESSRConfig, essr_forward, slice_width
from repro_torch.models.layers import pixel_shuffle
from repro_torch.quant.pams import QuantPack, code_dtype

#: Cluster sizes of the fp32 megakernel, in the order tried; more than 8
#: blocks is a non-portable cluster size, which the H100 takes.
MEGA_CLUSTERS = (1, 2, 4, 8, 16)
#: Floats a pixel of the fp32 megakernel's maps takes past its channels
#: (padded to 8), in the order tried: 4 puts the 16-byte loads of
#: consecutive pixels on distinct banks; 0 where nothing else fits.
MEGA_PIXEL_PADS = (4, 0)
#: Threads of an fp32 megakernel block at most (csrc/mega.cu ``MAX_THREADS``).
MEGA_MAX_THREADS = 448
#: Largest window edge the megakernels take in one launch (Table I's
#: largest patch); a larger patch is cut into windows (`window_plan`).
MAX_PATCH = 64
#: Shared memory one block may use on an H100 (227 KB).
SMEM_LIMIT = 232_448
#: H100 SM: shared memory (228 KB, of which the runtime reserves 1 KB a
#: block), threads and 32-bit registers; the megakernel's threads hold at
#: most 128 registers (csrc/mega.cu's launch bounds).
SM_SMEM, SMEM_RESERVED, SM_THREADS, SM_REGISTERS, MEGA_REGISTERS = \
    233_472, 1_024, 2_048, 65_536, 128
#: Threads of a quantized megakernel block at most (csrc/qmega.cu ``MAX_THREADS``).
QMEGA_MAX_THREADS = 512
#: H100 SXM data sheet: fp32 outside the tensor cores, and device memory.
H100_FP32_FLOPS, H100_HBM_BYTES = 67e12, 3.35e12
#: H100 SXM data sheet: dense int8 and fp16 on the tensor cores.
H100_INT8_OPS, H100_FP16_FLOPS = 1979e12, 989e12
#: Rounded fp32 operations a second outside the tensor cores: each
#: ``__fmul_rn``/``__fadd_rn`` is one instruction, and the fp32 peak counts an
#: FFMA as two operations.
H100_FP32_INSTRUCTIONS = H100_FP32_FLOPS / 2
#: Widest subnet (and input) of the quantized megakernel: its dots hold 8
#: n-tiles of 8 channels, and fxp10's fp16 dots are exact up to K = 64.
QMEGA_MAX_WIDTH = 64
#: Cluster sizes of the quantized megakernel, in the order tried: the first
#: whose strip fits a block. Taller strips pay fewer halo barriers a row, and
#: the card holds more 4-block clusters than 8-block ones.
QMEGA_CLUSTERS = (4, 8, 16)


def _round4(c: int) -> int:
    return (c + 3) & ~3


def _round8(c: int) -> int:
    return (c + 7) & ~7


@dataclasses.dataclass(frozen=True)
class WeightLayout:
    """Float sizes of the packed weight buffer (the same sums as ``Shape`` in
    csrc/mega.cu). It is a sequence of pieces in the TPU kernel's operand
    order: a 1x1 (its depth padded to 4, its outputs to 8) with its bias, or
    a 3x3 (9 taps, channels padded to 8) with its bias."""
    cin: int
    width: int
    cout: int
    n_sfb: int

    @property
    def padded(self) -> Tuple[int, int, int, int]:
        """(Cin to 4, C to 4: the dot depth, C to 8, Cout to 8)."""
        return (_round4(self.cin), _round4(self.width), _round8(self.width),
                _round8(self.cout))

    @property
    def first_pw(self) -> int:       # pw (cpi, cp8), pw_b
        cpi, _, cp8, _ = self.padded
        return cpi * cp8 + cp8

    @property
    def dw(self) -> int:             # dw (9, cp8), dw_b
        return 10 * self.padded[2]

    @property
    def pw(self) -> int:             # pw (cp4, cp8), pw_b
        _, cp4, cp8, _ = self.padded
        return cp4 * cp8 + cp8

    @property
    def recon_pw(self) -> int:       # pw (cp4, cpo8), pw_b
        _, cp4, _, cpo8 = self.padded
        return cp4 * cpo8 + cpo8

    @property
    def first(self) -> int:
        return self.first_pw + self.dw

    @property
    def sfb(self) -> int:            # b1 (pw, dw), b2 (pw, dw), fuse (pw)
        return 3 * self.pw + 2 * self.dw

    @property
    def recon(self) -> int:          # dw, then pw
        return self.dw + self.recon_pw

    @property
    def size(self) -> int:
        return self.first + self.n_sfb * self.sfb + self.recon

    @property
    def stage(self) -> int:
        """Floats of the largest piece: one slot of the kernel's two-slot ring."""
        return max(self.first_pw, self.dw, self.recon_pw, self.pw if self.n_sfb else 0)


def _mega_smem(lay: WeightLayout, rows: int, w: int, pad: int) -> int:
    """Shared-memory bytes of one block: F and A (the output stage too), B,
    the two halo rows, the two ring slots and the halo rows' mbarrier (16
    bytes) (csrc/mega.cu ``Shape``)."""
    st = lay.padded[2] + pad
    m = rows * w * st
    fa = max(2 * m, _round4(rows * w * lay.cout))
    return 4 * (fa + m + 2 * w * st + 2 * lay.stage + 4)


# ---------------------------------------------------------------------------
# recompute-halo windows: patches past MAX_PATCH
# ---------------------------------------------------------------------------

def receptive_radius(n_sfb: int) -> int:
    """LR pixels an output of the chain reads on each side: one 3x3
    depthwise in the first layer, two in each SFB, one in the recon."""
    return 2 + 2 * n_sfb


@dataclasses.dataclass(frozen=True)
class AxisWindows:
    """One axis of a patch cut into ``k`` windows of ``edge`` pixels at
    ``starts``; window i keeps its core ``cores[i]`` = [lo, hi) in patch
    coordinates. The cores tile [0, size); a core is the window less
    ``radius`` pixels on each side that is not the patch's own edge."""
    size: int
    radius: int
    k: int
    edge: int
    starts: Tuple[int, ...]
    cores: Tuple[Tuple[int, int], ...]


def axis_windows(size: int, radius: int, limit: int, k: Optional[int] = None) -> AxisWindows:
    """Cut one patch axis of ``size`` pixels into ``k`` windows of edge
    W = ceil((size + 2 radius (k - 1)) / k), the fewest with W <= ``limit``
    when ``k`` is None. Starts spread evenly from 0 to size - W, so
    neighbouring windows overlap by at least 2 radius; the boundary between
    cores i and i + 1 lies radius pixels into window i + 1."""
    if min(size, limit) < 1 or radius < 0:
        raise ValueError(f"axis_windows: size {size}, radius {radius}, limit {limit}")
    if k is None:
        k = next((c for c in range(1, size + 1)
                  if -(-(size + 2 * radius * (c - 1)) // c) <= limit), None)
        if k is None:
            raise ValueError(f"axis_windows: no window of at most {limit} px keeps a core "
                             f"past a radius of {radius} px")
    edge = -(-(size + 2 * radius * (k - 1)) // k)
    if k == 1:
        return AxisWindows(size, radius, 1, size, (0,), ((0, size),))
    if edge - 2 * radius < 1:
        raise ValueError(f"axis_windows: {k} windows of {edge} px keep no core past a "
                         f"radius of {radius} px")
    span = size - edge
    starts = tuple((2 * i * span + k - 1) // (2 * (k - 1)) for i in range(k))
    bounds = (0,) + tuple(s + radius for s in starts[1:]) + (size,)
    return AxisWindows(size, radius, k, edge, starts,
                       tuple(zip(bounds[:-1], bounds[1:])))


def window_plan(h: int, w: int, radius: int, limit: int,
                fits: Callable[[int, int], bool]) -> Tuple[AxisWindows, AxisWindows]:
    """The windows of an h x w patch: the fewest in all (then the fewest
    pixels computed, then rows split before columns) whose edges are at most
    ``limit`` and whose (rows, columns) window ``fits`` a launch; one window,
    the patch itself, wherever the patch fits. Raises ValueError when not
    even the smallest windows fit."""
    def ks(size):
        first = axis_windows(size, radius, limit)
        out = [first]
        for k in range(first.k + 1, size + 1):
            try:
                ax = axis_windows(size, radius, limit, k)
            except ValueError:
                break
            if ax.edge < out[-1].edge:
                out.append(ax)
        return out

    rows, cols = ks(h), ks(w)
    if not fits(rows[-1].edge, cols[-1].edge):
        raise ValueError(f"window_plan: patch {h}x{w}: not even a {rows[-1].edge}x"
                         f"{cols[-1].edge} window fits a launch")
    return min(((ah, aw) for ah in rows for aw in cols if fits(ah.edge, aw.edge)),
               key=lambda p: (p[0].k * p[1].k, p[0].k * p[0].edge * p[1].k * p[1].edge,
                              p[1].k))


@functools.lru_cache(maxsize=64)
def _window_index(ah: AxisWindows, aw: AxisWindows, device: str):
    """Index tensors on ``device``: the windows' rows (kh, 1, Wh, 1) and
    columns (1, kw, 1, Ww) for the gather; for each patch pixel its window
    and its place in that window, (h, 1) rows and (1, w) columns."""
    def axis(a):
        win = torch.empty(a.size, dtype=torch.long)
        at = torch.empty(a.size, dtype=torch.long)
        for i, ((lo, hi), s) in enumerate(zip(a.cores, a.starts)):
            win[lo:hi] = i
            at[lo:hi] = torch.arange(lo, hi) - s
        take = torch.tensor(a.starts)[:, None] + torch.arange(a.edge)[None]
        return take, win, at

    (th, wh, lh), (tw, ww, lw) = axis(ah), axis(aw)
    return tuple(t.to(device) for t in (th[:, None, :, None], tw[None, :, None, :],
                                         wh[:, None], ww[None], lh[:, None], lw[None]))


def run_windowed(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                 plan: Tuple[AxisWindows, AxisWindows]) -> torch.Tensor:
    """fn over the windows of (N,H,W,C) ``x``: the windows of all N patches
    gathered into one (N kh kw, Wh, Ww, C) batch, one call of ``fn``, and
    each window's core written into the (N,H,W,C') result, every pixel
    exactly once."""
    ah, aw = plan
    n = x.shape[0]
    rows, cols, win_r, win_c, at_r, at_c = _window_index(ah, aw, str(x.device))
    xw = x[:, rows, cols].reshape(n * ah.k * aw.k, ah.edge, aw.edge, x.shape[-1])
    yw = fn(xw)
    yw = yw.view(n, ah.k, aw.k, ah.edge, aw.edge, yw.shape[-1])
    return yw[:, win_r, win_c, at_r, at_c]


def _plan_report(plan: Tuple[AxisWindows, AxisWindows]) -> Dict[str, Any]:
    ah, aw = plan
    return {"windows": [ah.k, aw.k], "window": [ah.edge, aw.edge],
            "work_factor": ah.k * ah.edge * aw.k * aw.edge / (ah.size * aw.size)}


def _mega_shape(lay: WeightLayout, cluster: int, h: int, w: int, pad: int) -> Dict[str, int]:
    """A launch shape: rows a block, its shared memory, threads (one per 8
    output channels of 4 pixels of a C -> C pointwise layer) and the blocks
    an SM holds at once."""
    rows = -(-h // cluster)
    smem = _mega_smem(lay, rows, w, pad)
    items = lay.padded[2] // 8 * -(-rows * w // 4)
    threads = min(MEGA_MAX_THREADS, max(64, 32 * -(-items // 32)))
    per_sm = min(SM_SMEM // (smem + SMEM_RESERVED), SM_THREADS // threads,
                 SM_REGISTERS // (threads * MEGA_REGISTERS))
    return {"cluster": cluster, "rows": rows, "smem": smem, "threads": threads,
            "pad": pad, "per_sm": per_sm}


def _mega_fits(lay: WeightLayout, h: int, w: int) -> bool:
    c = MEGA_CLUSTERS[-1]
    return _mega_smem(lay, -(-h // c), w, MEGA_PIXEL_PADS[-1]) <= SMEM_LIMIT


@functools.lru_cache(maxsize=256)
def _mega_plan(width: int, h: int, w: int, cin: int, cout: int,
               n_sfb: int) -> Tuple[AxisWindows, AxisWindows]:
    lay = WeightLayout(cin, width, cout, n_sfb)
    return window_plan(h, w, receptive_radius(n_sfb), MAX_PATCH,
                       lambda wh, ww: _mega_fits(lay, wh, ww))


def _sizing(width: int, h: int, w: int, cin: int, cout: int, n_sfb: int) -> Dict[str, Any]:
    """The launch shape and work of one patch: its windows
    (:func:`window_plan`, one wherever the patch fits) and the launch shape
    of one window. Of the cluster sizes whose strip fits a block (padded
    pixels where any does, else unpadded), the one that keeps the most strip
    rows resident on an SM (blocks an SM x rows a block), the fewer blocks a
    cluster on a tie: taller strips pay fewer cluster barriers a row, more
    blocks an SM hide one block's barriers and latencies behind another's
    work. Raises ValueError when no window's strip fits."""
    if min(width, h, w, cin, cout) < 1 or n_sfb < 0:
        raise ValueError(f"group_report: width {width}, patch {h}x{w}, cin {cin}, "
                         f"cout {cout}, n_sfb {n_sfb}: every size must be positive")
    lay = WeightLayout(cin, width, cout, n_sfb)
    try:
        plan = _mega_plan(width, h, w, cin, cout, n_sfb)
    except ValueError as e:
        c = MEGA_CLUSTERS[-1]
        raise ValueError(
            f"group_report: width {width}, patch {h}x{w}: {e}; a block of the {c}-block "
            f"cluster needs more than the H100's {SMEM_LIMIT} B of shared memory per "
            f"block") from None
    wh, ww = plan[0].edge, plan[1].edge
    for pad in MEGA_PIXEL_PADS:
        fits = [sh for sh in (_mega_shape(lay, c, wh, ww, pad) for c in MEGA_CLUSTERS)
                if sh["smem"] <= SMEM_LIMIT]
        if fits:
            break
    best = max(fits, key=lambda f: (f["per_sm"] * f["rows"], -f["cluster"]))
    cluster, rows, smem, threads = best["cluster"], best["rows"], best["smem"], best["threads"]
    macs = cin * width + 9 * width + n_sfb * (3 * width * width + 18 * width) \
        + 9 * width + width * cout
    flops = 2 * macs * h * w
    nbytes = 4 * h * w * (cin + cout)
    weight_bytes = 4 * (cin * width + 11 * width + n_sfb * (3 * width * width + 23 * width)
                        + 10 * width + width * cout + cout)
    return {"cluster": cluster, "rows_per_cta": rows, "threads": threads,
            "pixel_pad": best["pad"], "blocks_per_sm": best["per_sm"], "smem_bytes": smem,
            "smem_limit": SMEM_LIMIT, **_plan_report(plan),
            "weight_floats": lay.size, "flops_per_patch": flops, "bytes_per_patch": nbytes,
            "weight_bytes": weight_bytes,
            "bound": "operations" if flops / H100_FP32_FLOPS >= nbytes / H100_HBM_BYTES
            else "bytes"}


def group_report(width: int, patch: Union[int, Tuple[int, int]], scale: int,
                 n_sfb: int = 5, *, in_channels: int = 3) -> Dict[str, Any]:
    """Static sizing of the megakernel on the H100 at one (width, patch)
    point: the windows the patch is served in (``windows`` (rows, columns),
    ``window`` their (h, w) edge, ``work_factor`` the pixels computed over
    the patch's; one window of the patch itself wherever it fits), and for
    one window the cluster size (of 1, 2, 4, 8, 16 blocks, the one that
    keeps the most strip rows resident on an SM), rows per block (CTA),
    threads, the floats a pixel takes past its channels (``pixel_pad``), the
    blocks an SM holds at once (``blocks_per_sm``), shared-memory bytes per
    block against the 232,448 B limit; fp32 FLOP and device-memory bytes per
    patch (each input read once, each pre-shuffle output written once; the
    weights once per launch, in ``weight_bytes``), and which of the two
    bounds the launch on the data sheet's 67 TFLOP/s and 3.35 TB/s
    ("operations" / "bytes"). ``patch``: an edge or (h, w). Raises
    ValueError for a shape no window's strip fits."""
    h, w = (patch, patch) if isinstance(patch, int) else (int(patch[0]), int(patch[1]))
    return _sizing(width, h, w, in_channels, in_channels * scale * scale, n_sfb)


# ---------------------------------------------------------------------------
# packed weights
# ---------------------------------------------------------------------------

def _bias(p: Dict[str, Any], key: str, n: int, like: torch.Tensor) -> torch.Tensor:
    b = p.get(key)
    return b if b is not None else like.new_zeros(n)


def _operands(params: Dict[str, Any]) -> List[Tuple[torch.Tensor, Tuple[int, int]]]:
    """A width-sliced param tree -> its 4 + 10 * n_sfb + 4 operands in the
    TPU kernel's order (``_flat_fp_operands``), each as a 2-D matrix with
    its padded shape."""
    first, recon = params["first"], params["recon"]
    cin, c = first["pw"].shape[2], first["pw"].shape[3]
    cout = recon["pw"].shape[-1]
    cpi, cp4, cp8, cpo8 = WeightLayout(cin, c, cout, len(params["sfbs"])).padded

    def bs(p, rows):
        return [(p["pw"][0, 0], (rows, cp8)), (_bias(p, "pw_b", c, p["pw"])[None], (1, cp8)),
                (p["dw"][:, :, 0, :].reshape(9, c), (9, cp8)),
                (_bias(p, "dw_b", c, p["dw"])[None], (1, cp8))]

    ops = bs(first, cpi)
    for s in params["sfbs"]:
        ops += bs(s["b1"], cp4) + bs(s["b2"], cp4)
        ops += [(s["fuse"][0, 0], (cp4, cp8)),
                (_bias(s, "fuse_b", c, s["fuse"])[None], (1, cp8))]
    ops += [(recon["dw"][:, :, 0, :].reshape(9, c), (9, cp8)),
            (_bias(recon, "dw_b", c, recon["dw"])[None], (1, cp8)),
            (recon["pw"][0, 0], (cp4, cpo8)),
            (_bias(recon, "pw_b", cout, recon["pw"])[None], (1, cpo8))]
    return ops


def pack_weights(params: Dict[str, Any], width: int) -> torch.Tensor:
    """The param tree at ``width`` -> one contiguous fp32 buffer on the
    weights' device: the 58 operands (at 5 SFBs) in the TPU kernel's order,
    each zero-padded: a 1x1's depth to a multiple of 4, every output channel
    count to a multiple of 8 (:class:`WeightLayout`)."""
    if width != params["first"]["pw"].shape[-1]:
        params = slice_width(params, width)
    parts = []
    for t, (r, c) in _operands(params):
        m = t.detach().new_zeros((r, c))
        m[: t.shape[0], : t.shape[1]] = t.detach()
        parts.append(m.reshape(-1))
    return torch.cat(parts).to(torch.float32).contiguous()


def unpack_weights(wbuf: torch.Tensor, lay: WeightLayout) -> Dict[str, Any]:
    """Views of a packed buffer at the real channel counts, in the form
    `kernels.ref.mega_ref` takes."""
    cpi, cp4, cp8, cpo8 = lay.padded
    c, off = lay.width, 0

    def take(rows, cols, r, k):
        nonlocal off
        v = wbuf[off: off + rows * cols].view(rows, cols)[:r, :k]
        off += rows * cols
        return v

    first = {"pw": take(cpi, cp8, lay.cin, c), "pw_b": take(1, cp8, 1, c)[0],
             "dw": take(9, cp8, 9, c).reshape(3, 3, c), "dw_b": take(1, cp8, 1, c)[0]}
    sfbs = []
    for _ in range(lay.n_sfb):
        p = {}
        for b in ("b1", "b2"):
            p.update({f"{b}_pw": take(cp4, cp8, c, c), f"{b}_pwb": take(1, cp8, 1, c)[0],
                      f"{b}_dw": take(9, cp8, 9, c).reshape(3, 3, c),
                      f"{b}_dwb": take(1, cp8, 1, c)[0]})
        p["fuse"], p["fuse_b"] = take(cp4, cp8, c, c), take(1, cp8, 1, c)[0]
        sfbs.append(p)
    recon = {"dw": take(9, cp8, 9, c).reshape(3, 3, c), "dw_b": take(1, cp8, 1, c)[0],
             "pw": take(cp4, cpo8, c, lay.cout), "pw_b": take(1, cpo8, 1, lay.cout)[0]}
    return {"first": first, "sfbs": sfbs, "recon": recon}


def _leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    out = list(params["first"].values()) + list(params["recon"].values())
    for s in params["sfbs"]:
        out += list(s["b1"].values()) + list(s["b2"].values())
        out += [v for k, v in s.items() if k not in ("b1", "b2")]
    return out


class _TreeKey:
    """Hashable identity of a param tree: its leaves' ids and in-place
    versions. It holds the tree, so no id is reused while its entry lives."""
    __slots__ = ("tree", "_key")

    def __init__(self, tree: Dict[str, Any]):
        self.tree = tree
        self._key = tuple((id(t), 0 if t.is_inference() else t._version)
                          for t in _leaves(tree))

    def __hash__(self) -> int:
        return hash(self._key)

    def __eq__(self, other) -> bool:
        return isinstance(other, _TreeKey) and self._key == other._key


#: Packed buffers by (param tree, width).
packed_weights = BoundedCache(lambda key, width: pack_weights(key.tree, width), maxsize=16)


# ---------------------------------------------------------------------------
# the kernel's wrapper and the batch forward
# ---------------------------------------------------------------------------

def mega_fused(x: torch.Tensor, wbuf: torch.Tensor, *, width: int, n_sfb: int,
               out_channels: int) -> torch.Tensor:
    """x: (N,H,W,Cin) fp32; ``wbuf``: the `pack_weights` buffer of that
    (Cin, width, out_channels, n_sfb) -> the pre-shuffle (N,H,W,out_channels).

    CPU tensors take the plain version (`kernels.ref.mega_ref` on the
    unpacked views) at any patch size; CUDA tensors launch the kernel or
    raise. N = 0 returns an empty output, no launch. On the card a patch that
    does not fit one launch is served in windows (:func:`window_plan`), all
    of them in one launch; a shape that no window's strip fits raises
    ValueError before any launch."""
    check_operands("mega_fused", x, {})
    n, h, w, cin = x.shape
    check_channels("mega_fused", Cin=cin, C=width, Cout=out_channels)
    lay = WeightLayout(cin, width, out_channels, n_sfb)
    check_operands("mega_fused", x, {"wbuf": (wbuf, (lay.size,))})
    if x.device.type == "cpu":
        return mega_ref(x, unpack_weights(wbuf, lay))
    if x.device.type != "cuda":
        raise ValueError(f"mega_fused: no kernel for device {x.device}")
    rep = _sizing(width, h, w, cin, out_channels, n_sfb)
    if wbuf.data_ptr() % 16:
        raise ValueError("mega_fused: wbuf must be 16-byte aligned (the kernel copies 16 B)")
    if n == 0:
        return torch.empty((n, h, w, out_channels), dtype=x.dtype, device=x.device)

    def launch(xs: torch.Tensor) -> torch.Tensor:
        nw, wh, ww, _ = xs.shape
        out = torch.empty((nw, wh, ww, out_channels), dtype=x.dtype, device=x.device)
        _build.entry("mega", "mega_forward", 3, 11)(
            xs.data_ptr(), wbuf.data_ptr(), out.data_ptr(), nw, wh, ww, cin, width,
            out_channels, n_sfb, rep["rows_per_cta"], rep["cluster"], rep["threads"],
            rep["pixel_pad"], stream_of(x))
        mega_fused.launches += 1
        return out

    if rep["windows"] == [1, 1]:
        return launch(x)
    return run_windowed(launch, x, _mega_plan(width, h, w, cin, out_channels, n_sfb))


mega_fused.launches = 0


def resident_clusters(width: int, patch: Union[int, Tuple[int, int]], scale: int,
                      n_sfb: int = 5, *, in_channels: int = 3) -> int:
    """Clusters the card keeps resident at once for this shape's window (the
    card's occupancy query; builds the kernel). 0 when none fits."""
    rep = group_report(width, patch, scale, n_sfb, in_channels=in_channels)
    w = rep["window"][1]
    fn = _build.load("mega").mega_resident_clusters
    fn.argtypes, fn.restype = [ctypes.c_int] * 9, ctypes.c_int
    return int(fn(w, in_channels, width, in_channels * scale * scale, n_sfb,
                  rep["rows_per_cta"], rep["cluster"], rep["threads"], rep["pixel_pad"]))


class _MegaForward(torch.autograd.Function):
    """The megakernel made differentiable (twin of the reference's
    ``jax.custom_jvp`` on ``_mega_forward``): the primal launches the
    kernel; the gradient (backward) and the tangent (jvp) come from the
    plain `essr_forward` of the same tree at the same width, recomputed,
    the same math in another order. Inputs: (x, the packed weights, (cfg,
    width, the tree's structure), *the full tree's leaves in flatten
    order); the gradients reach the full leaves, zero past the width."""

    @staticmethod
    def forward(x, wbuf, spec, *leaves):
        cfg, width, _ = spec
        up = mega_fused(x, wbuf, width=width, n_sfb=cfg.n_sfb, out_channels=cfg.out_channels)
        return pixel_shuffle(up, cfg.scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, _, spec, *leaves = inputs
        ctx.spec = spec
        ctx.save_for_backward(x, *leaves)
        ctx.save_for_forward(x, *leaves)

    @staticmethod
    def _plain(ctx, need):
        """The plain forward on detached copies of (x, *leaves), each
        taking gradients where ``need`` says; returns (output, inputs)."""
        cfg, width, structure = ctx.spec
        ins = [t.detach().requires_grad_(bool(n)) for t, n in zip(ctx.saved_tensors, need)]
        tree = tree_unflatten(structure, ins[1:])
        return essr_forward(tree, ins[0], cfg, width=width), ins

    @staticmethod
    def backward(ctx, grad):
        need = (ctx.needs_input_grad[0],) + tuple(ctx.needs_input_grad[3:])
        with torch.enable_grad():
            out, ins = _MegaForward._plain(ctx, need)
            wanted = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True))
        grads = [next(got) if t.requires_grad else None for t in ins]
        grads = [torch.zeros_like(t) if n and g is None else g
                 for t, n, g in zip(ins, need, grads)]
        return (grads[0], None, None, *grads[1:])

    @staticmethod
    def jvp(ctx, x_t, wbuf_t, spec_t, *leaf_t):
        # J t through the plain forward's reverse mode, twice: with
        # v(u) = J^T u, the gradient of <v(u), t> in u is J t
        tangents = (x_t,) + leaf_t
        with torch.enable_grad():
            out, ins = _MegaForward._plain(ctx, [t is not None for t in tangents])
            if not any(t.requires_grad for t in ins):
                return torch.zeros_like(out)
            u = torch.zeros_like(out, requires_grad=True)
            wanted = [(i, t) for i, t in zip(ins, tangents) if t is not None]
            vjp = torch.autograd.grad(out, [i for i, _ in wanted], u, create_graph=True,
                                      allow_unused=True)
            dot = sum((v * t).sum() for v, (_, t) in zip(vjp, wanted) if v is not None)
            return torch.autograd.grad(dot, u)[0].detach()


def essr_forward_megakernel(params: Dict[str, Any], x: torch.Tensor, cfg: ESSRConfig,
                            width: Optional[int] = None) -> torch.Tensor:
    """x: (N,p,p,3) -> (N,p*s,p*s,3) through one megakernel launch (same
    contract as `kernels.ops.essr_forward_kernels`). ``width`` in {C/2, C}
    (None = C); bilinear patches never reach the kernel. The packed weights
    are cached by the tree's tensors and their in-place versions, and the
    width, so an optimizer's in-place update repacks them.

    Differentiable in both modes (`_MegaForward`) outside inference mode;
    the serving path runs under ``torch.inference_mode`` and builds no
    graph."""
    w = width if width is not None else cfg.channels
    if w == 0:
        raise ValueError("the bilinear subnet does not use the conv kernels")
    if not 0 < w <= cfg.channels:
        raise ValueError(f"width {w} outside 1..{cfg.channels}")
    if x.shape[0] == 0:
        s = cfg.scale
        return x.new_zeros((0, x.shape[1] * s, x.shape[2] * s, cfg.in_channels))
    with torch.no_grad():
        wbuf = packed_weights(_TreeKey(params), w)
    if torch.is_inference_mode_enabled():
        up = mega_fused(x, wbuf, width=w, n_sfb=cfg.n_sfb, out_channels=cfg.out_channels)
        return pixel_shuffle(up, cfg.scale)
    return _MegaForward.apply(x, wbuf, (cfg, w, params), *tree_leaves(params))


# ---------------------------------------------------------------------------
# the quantized megakernel (quant x group fusion): csrc/qmega.cu
# ---------------------------------------------------------------------------

def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _operand_stride(nbytes: int) -> int:
    """Bytes of one dot operand pixel or weight row holding ``nbytes`` of
    codes: the next multiple of 16, made odd in units of 16 (csrc/qmma.cuh
    ``operand_stride``), so the rows of one ldmatrix fall on distinct banks."""
    s = _up(nbytes, 16)
    return s + 16 if (s // 16) % 2 == 0 else s


@dataclasses.dataclass(frozen=True)
class QWeightLayout:
    """Byte sizes of the packed integer weight buffer's groups (the same sums
    as ``QShape`` in csrc/qmega.cu) for ``bits``-bit codes (8: int8, wider:
    fxp10). Each 1x1's code weights are the tensor-core dots' B operand: a
    row of ``ast`` bytes per output channel (``ast1`` for the first layer's
    Cin-deep input), the depth zero-padded to ``kp`` codes (a multiple of one
    32-byte k-step: 32 int8 codes, 16 fxp10 codes as fp16); channels pad to
    multiples of 8 (``cp8``), the recon's outputs to 4; every operand is a
    multiple of 16 bytes."""
    cin: int
    width: int
    cout: int
    n_sfb: int
    bits: int

    @property
    def code_bytes(self) -> int:
        """Bytes of a code in the dots' operands: int8 1, fxp10 2 (fp16)."""
        return 1 if self.bits <= 8 else 2

    @property
    def cp8(self) -> int:
        return _up(self.width, 8)

    @property
    def cpo(self) -> int:
        return _round4(self.cout)

    def _depth(self, k: int) -> int:
        return _up(k, 32 // self.code_bytes)

    @property
    def kp(self) -> int:
        return self._depth(self.width)

    @property
    def kp1(self) -> int:
        return self._depth(self.cin)

    @property
    def ast(self) -> int:
        return _operand_stride(self.kp * self.code_bytes)

    @property
    def ast1(self) -> int:
        return _operand_stride(self.kp1 * self.code_bytes)

    @property
    def first(self) -> int:          # pw (cp8 rows of ast1), pw_scale, pwb, dw_fq (9, cp8), dwb
        return self.cp8 * self.ast1 + 48 * self.cp8

    @property
    def bs(self) -> int:             # one qBSConv of a qSFB: as first, rows of ast
        return self.cp8 * self.ast + 48 * self.cp8

    @property
    def fuse(self) -> int:           # fuseq (cp8 rows of ast), fsy, fsx, fb
        return self.cp8 * self.ast + 12 * self.cp8

    @property
    def sfb(self) -> int:            # b1, b2, fuse
        return 2 * self.bs + self.fuse

    @property
    def recon(self) -> int:          # dwq (9, cp8) int32, dw_scale, dwb, pw_fq (cp8, cpo), pwb
        return 44 * self.cp8 + 4 * self.cp8 * self.cpo + 4 * self.cpo

    @property
    def size(self) -> int:
        return self.first + self.n_sfb * self.sfb + self.recon

    @property
    def slot(self) -> int:
        """Bytes of one slot of the kernel's two-slot weight ring: the largest
        layer (the first qBSConv, a qSFB's b1, b2 or fuse, the recon)."""
        return max(self.first, self.recon, *((self.bs, self.fuse) if self.n_sfb else ()))


def _qmega_smem(lay: QWeightLayout, rows: int, w: int) -> int:
    """Shared-memory bytes of one block (csrc/qmega.cu ``QShape``): the fp32
    map A (pst floats a pixel; also the fuse's staged codes), the two halo
    rows (an fp32 row or a code row of F), the operand buffers F and Y (ost
    bytes a pixel), the two weight-ring slots and the halo rows' mbarrier
    (16 bytes)."""
    pst = lay.cp8 + 8 if lay.cp8 % 16 == 0 else lay.cp8
    ost = max(lay.ast, lay.ast1)
    p = rows * w
    return (max(4 * p * pst, p * ost) + 2 * w * max(4 * pst, ost) + 2 * p * ost
            + 2 * lay.slot + 16)


def _qmega_fits(lay: QWeightLayout, h: int, w: int) -> bool:
    return _qmega_smem(lay, -(-h // QMEGA_CLUSTERS[-1]), w) <= SMEM_LIMIT


@functools.lru_cache(maxsize=256)
def _qmega_plan(width: int, h: int, w: int, cin: int, cout: int, n_sfb: int,
                bits: int) -> Tuple[AxisWindows, AxisWindows]:
    lay = QWeightLayout(cin, width, cout, n_sfb, bits)
    return window_plan(h, w, receptive_radius(n_sfb), MAX_PATCH,
                       lambda wh, ww: _qmega_fits(lay, wh, ww))


def _qsizing(width: int, h: int, w: int, cin: int, cout: int, n_sfb: int,
             bits: int) -> Dict[str, Any]:
    """The quantized megakernel's windows, the launch shape of one window
    and the work of one patch; raises ValueError for a width past the dots'
    64 channels, or where no window's strip fits a block."""
    if min(width, h, w, cin, cout) < 1 or n_sfb < 0:
        raise ValueError(f"qgroup_report: width {width}, patch {h}x{w}, cin {cin}, "
                         f"cout {cout}, n_sfb {n_sfb}: every size must be positive")
    if max(width, cin) > QMEGA_MAX_WIDTH:
        # the dots hold 8 n-tiles of 8 channels; fxp10's fp16 dots are exact
        # only while 511^2 * K < 2^24, K <= 64
        raise ValueError(f"qgroup_report: width {width}, cin {cin}: the quantized megakernel's "
                         f"tensor-core dots take 1..{QMEGA_MAX_WIDTH} channels")
    lay = QWeightLayout(cin, width, cout, n_sfb, bits)
    try:
        plan = _qmega_plan(width, h, w, cin, cout, n_sfb, bits)
    except ValueError as e:
        raise ValueError(
            f"qgroup_report: width {width}, patch {h}x{w}, {bits}-bit codes: {e}; a block of "
            f"the {QMEGA_CLUSTERS[-1]}-block cluster needs more than the H100's {SMEM_LIMIT} B "
            f"of shared memory per block") from None
    wh, ww = plan[0].edge, plan[1].edge
    for cluster in QMEGA_CLUSTERS:
        rows = -(-wh // cluster)
        smem = _qmega_smem(lay, rows, ww)
        if smem <= SMEM_LIMIT:
            break
    p = rows * ww
    # one thread per (pixel, 4 channels) of a depthwise layer
    threads = min(QMEGA_MAX_THREADS, max(64, 32 * -(-(lay.cp8 // 4) * p // 32)))
    int_ops = 2 * (cin * width + n_sfb * 4 * width * width + 9 * width) * h * w
    fp_ops = (3 * cin + 24 * width + n_sfb * 58 * width + 2 * width + 2 * width * cout
              + 4 * cout) * h * w
    cb = 1 if bits <= 8 else 4
    nbytes = h * w * (4 * cin + cb * cout)
    # int8 dots on the int8 tensor cores; fxp10 dots on the fp16 tensor cores,
    # exact there (codes up to 2^11, sums below 2^24); every rounded fp32
    # operation (__fmul_rn, __fadd_rn, ...) is one instruction at half the
    # FFMA-counted fp32 peak
    int_rate = H100_INT8_OPS if bits <= 8 else H100_FP16_FLOPS
    t_ops = int_ops / int_rate + fp_ops / H100_FP32_INSTRUCTIONS
    return {"cluster": cluster, "rows_per_cta": rows, "threads": threads,
            "smem_bytes": smem, "smem_limit": SMEM_LIMIT, **_plan_report(plan),
            "code_bytes": cb,
            "weight_bytes": lay.size + 4 * (6 + 6 * n_sfb),
            "int_ops_per_patch": int_ops, "fp_ops_per_patch": fp_ops,
            "bytes_per_patch": nbytes,
            "bound": "operations" if t_ops >= nbytes / H100_HBM_BYTES else "bytes"}


def qgroup_report(width: int, patch: Union[int, Tuple[int, int]], scale: int,
                  n_sfb: int = 5, bits: int = 8, *, in_channels: int = 3) -> Dict[str, Any]:
    """Static sizing of the quantized megakernel on the H100 at one (width,
    patch, code width) point, the twin of :func:`group_report`: the windows
    the patch is served in (``windows``, ``window``, ``work_factor``), and
    for one window the cluster size (the fewest of 4, 8 and 16 blocks whose
    strip fits), rows per block (CTA), threads, shared-memory bytes per block
    against the 232,448 B limit (one fp32 map, two halo rows, two code
    buffers in the dots' operand layout, two weight-ring slots:
    :func:`_qmega_smem`), the packed weights' bytes, and per patch the
    integer and rounded fp32 operations and the device-memory bytes (fp32
    input read once, recon codes written once), with which of the two bounds
    the launch at the data sheet's rates (int8 dots at 1,979 TOPS, fxp10
    dots at the fp16 rate of 989 TFLOP/s, each rounded fp32 operation one
    instruction at 33.5 T a second; 3.35 TB/s). ``bits``: 8 for int8 codes,
    anything wider int32. Every patch of Table I (16 to 64) is one window at
    widths up to 64 in both modes. Raises ValueError for a width past 64
    channels (fxp10's fp16 dots are exact only up to K = 64) and for a shape
    no window's strip fits."""
    h, w = (patch, patch) if isinstance(patch, int) else (int(patch[0]), int(patch[1]))
    return _qsizing(width, h, w, in_channels, in_channels * scale * scale, n_sfb, bits)


def _b_rows(t: torch.Tensor, rows: int, stride: int, bits: int) -> torch.Tensor:
    """Code weights (K, Co) -> bytes of the dots' B operand: ``rows`` rows (one
    per output channel, zero past Co) of ``stride`` bytes, each holding the
    channel's K codes, zero past K; int8 as bytes, fxp10 as fp16 (exact for
    its +-511 codes)."""
    dt = torch.int8 if bits <= 8 else torch.float16
    m = torch.zeros((rows, stride // dt.itemsize), dtype=dt, device=t.device)
    m[: t.shape[1], : t.shape[0]] = t.t().to(dt)
    return m.view(torch.uint8).reshape(-1)


def _padded_fp(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    m = torch.zeros((rows, cols), dtype=torch.float32, device=t.device)
    m[: t.shape[0], : t.shape[1]] = t
    return m.view(torch.uint8).reshape(-1)


def pack_qweights(q: Dict[str, Any], bits: int) -> torch.Tensor:
    """Prepared integer operands (`kernels.qconv.prepare_qparams`) -> one
    contiguous uint8 buffer on their device, in the TPU kernel's operand
    order (``_flat_q_operands``): per qBSConv group the code weights as the
    dots' B operand, the folded scale, the bias, the fake-quant depthwise
    (9, C) and its bias; per qSFB two such groups, the fuse's code weights,
    its two scales and bias; the recon's int32 depthwise codes, scale, bias,
    fp 1x1 and bias. Sizes and strides: :class:`QWeightLayout`."""
    first, recon = q["first"], q["recon"]
    cin, c = first["pwq"].shape
    cout = recon["pw_fq"].shape[-1]
    lay = QWeightLayout(cin, c, cout, len(q["sfbs"]), bits)
    cp8, cpo = lay.cp8, lay.cpo

    def vec(v, n=cp8):
        return _padded_fp(v.reshape(1, -1), 1, n)

    def bs(pwq, scale, pwb, dw, dwb, stride):
        return [_b_rows(pwq, cp8, stride, bits), vec(scale), vec(pwb),
                _padded_fp(dw.reshape(9, c), 9, cp8), vec(dwb)]

    parts = bs(first["pwq"], first["pw_scale"], first["pwb"], first["dw_fq"], first["dwb"],
               lay.ast1)
    for s in q["sfbs"]:
        for b in ("b1", "b2"):
            parts += bs(s[f"{b}_pwq"], s[f"{b}_pw_scale"], s[f"{b}_pwb"], s[f"{b}_dw_fq"],
                        s[f"{b}_dwb"], lay.ast)
        parts += [_b_rows(s["fuseq"], cp8, lay.ast, bits), vec(s["fuse_scale_y"]),
                  vec(s["fuse_scale_x"]), vec(s["fuseb"])]
    dwq = recon["dwq"].reshape(9, c)
    m = dwq.new_zeros((9, cp8))
    m[:, :c] = dwq
    parts += [m.view(torch.uint8).reshape(-1), vec(recon["dw_scale"]), vec(recon["dwb"]),
              _padded_fp(recon["pw_fq"], cp8, cpo), vec(recon["pwb"], cpo)]
    return torch.cat(parts).contiguous()


def unpack_qweights(wbuf: torch.Tensor, lay: QWeightLayout) -> Dict[str, Any]:
    """A packed buffer -> the operands at the real channel counts, in the
    form `prepare_qparams` gives them (what `kernels.ref.qmega_ref` takes)."""
    cp8, cpo = lay.cp8, lay.cpo
    c, off = lay.width, 0
    cdt = code_dtype(lay.bits)

    def take(rows, cols, dtype, r, k):
        nonlocal off
        n = rows * cols * dtype.itemsize
        v = wbuf[off: off + n].view(dtype)
        off += n
        return v.reshape(rows, cols)[:r, :k]

    def codes(k, stride):            # B rows back to (K, C) codes
        op = torch.int8 if lay.code_bytes == 1 else torch.float16
        return take(cp8, stride // op.itemsize, op, c, k).t().to(cdt)

    def vec(n=cp8, k=c):
        return take(1, n, torch.float32, 1, k)[0]

    def bs(k, stride, prefix=""):
        return {f"{prefix}pwq": codes(k, stride), f"{prefix}pw_scale": vec(),
                f"{prefix}pwb": vec(), f"{prefix}dw_fq": take(9, cp8, torch.float32, 9, c)
                .reshape(3, 3, c), f"{prefix}dwb": vec()}

    first = bs(lay.cin, lay.ast1)
    sfbs = []
    for _ in range(lay.n_sfb):
        s = {**bs(c, lay.ast, "b1_"), **bs(c, lay.ast, "b2_")}
        s.update(fuseq=codes(c, lay.ast), fuse_scale_y=vec(), fuse_scale_x=vec(), fuseb=vec())
        sfbs.append(s)
    recon = {"dwq": take(9, cp8, torch.int32, 9, c).reshape(3, 3, c), "dw_scale": vec(),
             "dwb": vec(), "pw_fq": take(cp8, cpo, torch.float32, c, lay.cout),
             "pwb": vec(cpo, lay.cout)}
    return {"first": first, "sfbs": sfbs, "recon": recon}


def _packed_q(key: _TreeKey, cfg: ESSRConfig, width: int, pack: QuantPack, device: str):
    from repro_torch.kernels.qconv import prepared_qparams
    q, _ = prepared_qparams(key, cfg, width, pack, device)
    return pack_qweights(q, pack.bits)


#: Packed integer buffers by (param tree, cfg, width, pack, device).
packed_qweights = BoundedCache(_packed_q, maxsize=16)


def qmega_fused(x: torch.Tensor, wbuf: torch.Tensor, qc: torch.Tensor, *, width: int,
                n_sfb: int, out_channels: int, bits: int) -> torch.Tensor:
    """x: (N,H,W,Cin) fp32 in [0,1]; ``wbuf``: the `pack_qweights` buffer of
    that (Cin, width, out_channels, n_sfb, bits); ``qc``: the (clip, step)
    pairs of every site (`prepare_qparams`' ``consts``) -> the recon site's
    (N,H,W,out_channels) codes, int8 for ``bits`` <= 8 else int32.

    CPU tensors take the plain version (`kernels.ref.qmega_ref` on the
    unpacked operands) at any patch size; CUDA tensors launch the kernel or
    raise. N = 0 returns an empty output, no launch. On the card a patch that
    does not fit one launch is served in windows (:func:`window_plan`), all
    of them in one launch; a shape that no window's strip fits raises
    ValueError before any launch."""
    check_operands("qmega_fused", x, {})
    n, h, w, cin = x.shape
    check_channels("qmega_fused", Cin=cin, C=width, Cout=out_channels)
    lay = QWeightLayout(cin, width, out_channels, n_sfb, bits)
    check_operands("qmega_fused", x, {"wbuf": (wbuf, (lay.size,), torch.uint8),
                                      "qc": (qc, (6 + 6 * n_sfb,))})
    dtype = code_dtype(bits)
    if x.device.type == "cpu":
        return qmega_ref(x, unpack_qweights(wbuf, lay), qc, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"qmega_fused: no kernel for device {x.device}")
    rep = _qsizing(width, h, w, cin, out_channels, n_sfb, bits)
    if wbuf.data_ptr() % 16:
        raise ValueError("qmega_fused: wbuf must be 16-byte aligned (the kernel copies 16 B)")
    if n == 0:
        return torch.empty((n, h, w, out_channels), dtype=dtype, device=x.device)

    def launch(xs: torch.Tensor) -> torch.Tensor:
        nw, wh, ww, _ = xs.shape
        out = torch.empty((nw, wh, ww, out_channels), dtype=dtype, device=x.device)
        _build.entry("qmega", "qmega_forward", 4, 11)(
            xs.data_ptr(), wbuf.data_ptr(), qc.data_ptr(), out.data_ptr(), nw, wh, ww, cin,
            width, out_channels, n_sfb, rep["rows_per_cta"], rep["cluster"], rep["threads"],
            8 if bits <= 8 else 32, stream_of(x))
        qmega_fused.launches += 1
        return out

    if rep["windows"] == [1, 1]:
        return launch(x)
    return run_windowed(launch, x, _qmega_plan(width, h, w, cin, out_channels, n_sfb, bits))


qmega_fused.launches = 0


def qresident_clusters(width: int, patch: Union[int, Tuple[int, int]], scale: int,
                       n_sfb: int = 5, bits: int = 8, *, in_channels: int = 3) -> int:
    """Clusters the card keeps resident at once for this shape's window (the
    card's occupancy query; builds the kernel). 0 when none fits."""
    rep = qgroup_report(width, patch, scale, n_sfb, bits, in_channels=in_channels)
    w = rep["window"][1]
    fn = _build.load("qmega").qmega_resident_clusters
    fn.argtypes, fn.restype = [ctypes.c_int] * 9, ctypes.c_int
    return int(fn(w, in_channels, width, in_channels * scale * scale, n_sfb,
                  rep["rows_per_cta"], rep["cluster"], rep["threads"], 8 if bits <= 8 else 32))


def essr_forward_qmegakernel(params: Dict[str, Any], x: torch.Tensor, cfg: ESSRConfig,
                             width: Optional[int] = None, *, pack: QuantPack) -> torch.Tensor:
    """x: (N,p,p,3) fp in [0,1] -> (N,p*s,p*s,3) through one quantized
    megakernel launch: the contract of `kernels.qconv.essr_forward_qkernels`
    (quantize once, the integer chain, one dequant ``codes * s_recon``, then
    pixel shuffle), equal to it bit for bit. Bilinear patches (width 0) never
    reach the kernel. The packed operands are cached by the tree's tensors,
    the width, the pack and the device."""
    from repro_torch.kernels.qconv import _prepared
    q, _ = _prepared(params, cfg, width, pack, x)
    w = width if width is not None else cfg.channels
    if x.shape[0] == 0:
        s = cfg.scale
        return x.new_zeros((0, x.shape[1] * s, x.shape[2] * s, cfg.in_channels))
    wbuf = packed_qweights(_TreeKey(params), cfg, w, pack, str(x.device))
    r = qmega_fused(x, wbuf, q["consts"], width=w, n_sfb=cfg.n_sfb,
                    out_channels=cfg.out_channels, bits=pack.bits)
    return pixel_shuffle(r.to(torch.float32) * q["recon"]["qc"][1], cfg.scale)
