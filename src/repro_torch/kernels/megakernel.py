"""Subnet-group megakernel wrapper (CUDA source: ``csrc/mega.cu``).

Twin of ``repro.kernels.megakernel``'s fp32 path
(``essr_forward_megakernel``): one launch per routed bucket runs a subnet's
whole layer chain, BSConv -> n_sfb x SFB -> DSConv, with each patch's running
feature in shared memory from entry to exit; pixel shuffle follows outside.
``ExecutionPlan(fusion="group")`` serves through it.

The TPU kernel's sizing (a VMEM budget and MXU rows, ``autotune_report``)
does not carry over: on the H100 a patch is spread over a thread-block
cluster, one strip of rows per block, sized by :func:`group_report` from the
shared-memory limit of a block. The weights of one (param tree, width) are
packed once into a single zero-padded buffer (:func:`pack_weights`, cached).
``mega_fused.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core.caching import BoundedCache
from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_channels, check_operands, stream_of
from repro_torch.kernels.ref import mega_ref
from repro_torch.models.essr import ESSRConfig, slice_width
from repro_torch.models.layers import pixel_shuffle

#: Blocks of one cluster, each owning a strip of a patch's rows (the portable
#: maximum cluster size).
CLUSTER = 8
#: Shared memory one block may use on an H100 (227 KB).
SMEM_LIMIT = 232_448
#: Threads of a block at most (csrc/mega.cu ``MAX_THREADS``).
MAX_THREADS = 512
#: H100 SXM data sheet: fp32 outside the tensor cores, and device memory.
H100_FP32_FLOPS, H100_HBM_BYTES = 67e12, 3.35e12


def _round4(c: int) -> int:
    return (c + 3) & ~3


@dataclasses.dataclass(frozen=True)
class WeightLayout:
    """Float sizes of the packed weight buffer's three parts (the same sums
    as ``Layout`` in csrc/mega.cu). Channels pad to multiples of 4."""
    cin: int
    width: int
    cout: int
    n_sfb: int

    @property
    def padded(self) -> Tuple[int, int, int]:
        return _round4(self.cin), _round4(self.width), _round4(self.cout)

    @property
    def first(self) -> int:          # pw (cpi, cp), pw_b, dw (9, cp), dw_b
        cpi, cp, _ = self.padded
        return cpi * cp + 11 * cp

    @property
    def sfb(self) -> int:            # 2 x (pw (cp, cp), pw_b, dw, dw_b), fuse, fuse_b
        _, cp, _ = self.padded
        return 3 * cp * cp + 23 * cp

    @property
    def recon(self) -> int:          # dw (9, cp), dw_b, pw (cp, cpo), pw_b
        _, cp, cpo = self.padded
        return 10 * cp + cp * cpo + cpo

    @property
    def size(self) -> int:
        return self.first + self.n_sfb * self.sfb + self.recon

    @property
    def stage(self) -> int:
        """Floats of the largest layer group a block stages at once."""
        return max(self.first, self.recon, self.sfb if self.n_sfb else 0)


def _sizing(width: int, h: int, w: int, cin: int, cout: int, n_sfb: int) -> Dict[str, Any]:
    """The launch shape and work of one patch; raises ValueError when a block's
    share of the patch does not fit in shared memory."""
    if min(width, h, w, cin, cout) < 1 or n_sfb < 0:
        raise ValueError(f"group_report: width {width}, patch {h}x{w}, cin {cin}, "
                         f"cout {cout}, n_sfb {n_sfb}: every size must be positive")
    lay = WeightLayout(cin, width, cout, n_sfb)
    cpi, cp, _ = lay.padded
    rows = -(-h // CLUSTER)
    pp = _round4(rows * w)
    smem = 4 * (pp * cp + 2 * (rows + 2) * w * cp + pp * max(cp, cpi) + lay.stage)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"group_report: width {width}, patch {h}x{w}: a block of the {CLUSTER}-block "
            f"cluster ({rows} rows) needs {smem} B of shared memory, over the H100's "
            f"{SMEM_LIMIT} B per block")
    # one thread per (4 output channels, 4 pixels) of a C -> C pointwise layer
    threads = min(MAX_THREADS, max(64, 32 * -(-(cp // 4) * (pp // 4) // 32)))
    macs = cin * width + 9 * width + n_sfb * (3 * width * width + 18 * width) \
        + 9 * width + width * cout
    flops = 2 * macs * h * w
    nbytes = 4 * h * w * (cin + cout)
    weight_bytes = 4 * (cin * width + 11 * width + n_sfb * (3 * width * width + 23 * width)
                        + 10 * width + width * cout + cout)
    return {"cluster": CLUSTER, "rows_per_cta": rows, "threads": threads,
            "smem_bytes": smem, "smem_limit": SMEM_LIMIT, "weight_floats": lay.size,
            "flops_per_patch": flops, "bytes_per_patch": nbytes,
            "weight_bytes": weight_bytes,
            "bound": "operations" if flops / H100_FP32_FLOPS >= nbytes / H100_HBM_BYTES
            else "bytes"}


def group_report(width: int, patch: Union[int, Tuple[int, int]], scale: int,
                 n_sfb: int = 5, *, in_channels: int = 3) -> Dict[str, Any]:
    """Static sizing of the megakernel on the H100 at one (width, patch)
    point: cluster size, rows per block (CTA), threads, shared-memory bytes
    per block against the 232,448 B limit, fp32 FLOP and device-memory bytes
    per patch (each input read once, each pre-shuffle output written once;
    the weights once per launch, in ``weight_bytes``), and which of the two
    bounds the launch on the data sheet's 67 TFLOP/s and 3.35 TB/s
    ("operations" / "bytes"). ``patch``: an edge or (h, w). Raises
    ValueError for a shape whose strip does not fit a block."""
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
    cpi, cp, cpo = _round4(cin), _round4(c), _round4(cout)

    def bs(p, rows):
        return [(p["pw"][0, 0], (rows, cp)), (_bias(p, "pw_b", c, p["pw"])[None], (1, cp)),
                (p["dw"][:, :, 0, :].reshape(9, c), (9, cp)),
                (_bias(p, "dw_b", c, p["dw"])[None], (1, cp))]

    ops = bs(first, cpi)
    for s in params["sfbs"]:
        ops += bs(s["b1"], cp) + bs(s["b2"], cp)
        ops += [(s["fuse"][0, 0], (cp, cp)), (_bias(s, "fuse_b", c, s["fuse"])[None], (1, cp))]
    ops += [(recon["dw"][:, :, 0, :].reshape(9, c), (9, cp)),
            (_bias(recon, "dw_b", c, recon["dw"])[None], (1, cp)),
            (recon["pw"][0, 0], (cp, cpo)),
            (_bias(recon, "pw_b", cout, recon["pw"])[None], (1, cpo))]
    return ops


def pack_weights(params: Dict[str, Any], width: int) -> torch.Tensor:
    """The param tree at ``width`` -> one contiguous fp32 buffer on the
    weights' device: the 58 operands (at 5 SFBs) in the TPU kernel's order,
    each zero-padded to channel counts that are multiples of 4."""
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
    cpi, cp, cpo = lay.padded
    c, off = lay.width, 0

    def take(rows, cols, r, k):
        nonlocal off
        v = wbuf[off: off + rows * cols].view(rows, cols)[:r, :k]
        off += rows * cols
        return v

    first = {"pw": take(cpi, cp, lay.cin, c), "pw_b": take(1, cp, 1, c)[0],
             "dw": take(9, cp, 9, c).reshape(3, 3, c), "dw_b": take(1, cp, 1, c)[0]}
    sfbs = []
    for _ in range(lay.n_sfb):
        p = {}
        for b in ("b1", "b2"):
            p.update({f"{b}_pw": take(cp, cp, c, c), f"{b}_pwb": take(1, cp, 1, c)[0],
                      f"{b}_dw": take(9, cp, 9, c).reshape(3, 3, c),
                      f"{b}_dwb": take(1, cp, 1, c)[0]})
        p["fuse"], p["fuse_b"] = take(cp, cp, c, c), take(1, cp, 1, c)[0]
        sfbs.append(p)
    recon = {"dw": take(9, cp, 9, c).reshape(3, 3, c), "dw_b": take(1, cp, 1, c)[0],
             "pw": take(cp, cpo, c, lay.cout), "pw_b": take(1, cpo, 1, lay.cout)[0]}
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
    unpacked views); CUDA tensors launch the kernel or raise. N = 0 returns
    an empty output, no launch. A patch whose strip does not fit a block's
    shared memory raises ValueError on either device."""
    check_operands("mega_fused", x, {})
    n, h, w, cin = x.shape
    check_channels("mega_fused", Cin=cin, C=width, Cout=out_channels)
    rep = _sizing(width, h, w, cin, out_channels, n_sfb)
    lay = WeightLayout(cin, width, out_channels, n_sfb)
    check_operands("mega_fused", x, {"wbuf": (wbuf, (lay.size,))})
    if x.device.type == "cpu":
        return mega_ref(x, unpack_weights(wbuf, lay))
    if x.device.type != "cuda":
        raise ValueError(f"mega_fused: no kernel for device {x.device}")
    if wbuf.data_ptr() % 16:
        raise ValueError("mega_fused: wbuf must be 16-byte aligned (the kernel copies float4s)")
    out = torch.empty((n, h, w, out_channels), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    launch = _build.entry("mega", "mega_forward", 3, 10)
    launch(x.data_ptr(), wbuf.data_ptr(), out.data_ptr(), n, h, w, cin, width, out_channels,
           n_sfb, rep["rows_per_cta"], rep["cluster"], rep["threads"], stream_of(x))
    mega_fused.launches += 1
    return out


mega_fused.launches = 0


def resident_clusters(width: int, patch: Union[int, Tuple[int, int]], scale: int,
                      n_sfb: int = 5, *, in_channels: int = 3) -> int:
    """Clusters the card keeps resident at once for this shape (the card's
    occupancy query; builds the kernel). 0 when none fits."""
    rep = group_report(width, patch, scale, n_sfb, in_channels=in_channels)
    w = patch if isinstance(patch, int) else int(patch[1])
    fn = _build.load("mega").mega_resident_clusters
    fn.argtypes, fn.restype = [ctypes.c_int] * 8, ctypes.c_int
    return int(fn(w, in_channels, width, in_channels * scale * scale, n_sfb,
                  rep["rows_per_cta"], rep["cluster"], rep["threads"]))


def essr_forward_megakernel(params: Dict[str, Any], x: torch.Tensor, cfg: ESSRConfig,
                            width: Optional[int] = None) -> torch.Tensor:
    """x: (N,p,p,3) -> (N,p*s,p*s,3) through one megakernel launch (same
    contract as `kernels.ops.essr_forward_kernels`). ``width`` in {C/2, C}
    (None = C); bilinear patches never reach the kernel. The packed weights
    are cached by the tree's tensors and the width."""
    w = width if width is not None else cfg.channels
    if w == 0:
        raise ValueError("the bilinear subnet does not use the conv kernels")
    if not 0 < w <= cfg.channels:
        raise ValueError(f"width {w} outside 1..{cfg.channels}")
    if x.shape[0] == 0:
        s = cfg.scale
        return x.new_zeros((0, x.shape[1] * s, x.shape[2] * s, cfg.in_channels))
    wbuf = packed_weights(_TreeKey(params), w)
    up = mega_fused(x, wbuf, width=w, n_sfb=cfg.n_sfb, out_channels=cfg.out_channels)
    return pixel_shuffle(up, cfg.scale)
