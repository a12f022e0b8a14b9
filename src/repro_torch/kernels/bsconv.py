"""Fused BSConv kernel wrapper (CUDA source: ``csrc/bsconv.cu``).

Replaces ``repro/kernels/bsconv.py::bsconv_fused``: 1x1 pointwise + bias ->
3x3 SAME depthwise + bias -> optional ReLU in one launch, the intermediate
kept in shared memory. The kernel walks each patch's column bands top to
bottom, computing the 1x1 once per input pixel into a ring of rows, sized by
:func:`bsconv_report`; the same walker serves the quantized qBSConv
(`kernels.qconv.qbsconv_fused`). ``bsconv_fused.launches`` counts launches.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import MAX_CHANNELS, check_channels, check_operands, stream_of
from repro_torch.kernels.megakernel import SM_REGISTERS, SM_SMEM, SM_THREADS, SMEM_LIMIT, \
    SMEM_RESERVED
from repro_torch.kernels.ref import bsconv_ref
from repro_torch.kernels.sfb import _busy, _up

#: Widest output band of a work item, pixels (csrc/bsconv.cu ``BAND``).
BAND = 32
#: Most output rows a step, most threads a block (``MAX_THREADS``) and the
#: registers a thread holds at most (its launch bounds: two blocks an SM).
MAX_ROWS, MAX_THREADS, REGISTERS = 8, 256, 128


def _pixel_stride(ng: int) -> int:
    """Floats of one pixel of the 1x1's ring (csrc/bsconv.cu ``Shape::pst``):
    4q for the least q >= ng with 2q = ng (mod 8), ng + 1 for odd ng."""
    q = ng
    while q % 4 != (_up(ng, 2) // 2) % 4:
        q += 1
    return 4 * q


def bsconv_report(cin: int, cout: int, h: int, w: int,
                  bits: Optional[int] = None) -> Dict[str, Any]:
    """Static sizing of the BSConv band walker on the H100 for (h, w) patches,
    ``cin`` -> ``cout`` channels: fp32 (``bits`` None) or the quantized
    qBSConv on int8 (``bits`` <= 8) or int32 codes. Returns the column bands
    and their width, output rows a step, threads, dynamic shared-memory bytes
    a block (the launch uses exactly these), the blocks an SM holds by shared
    memory, threads and registers, and the share of thread slots that work
    in a full step's pointwise and depthwise. Of the step heights whose
    block fits, it takes the one that keeps the most output rows resident on
    an SM (blocks an SM x rows a step), the fewer rows on a tie. Raises
    ValueError when no step fits a block's 232,448 B."""
    if not (1 <= cin <= MAX_CHANNELS and 1 <= cout <= MAX_CHANNELS and h >= 1 and w >= 1):
        raise ValueError(f"bsconv_report: Cin={cin}, Cout={cout}, patch {h}x{w}: channels must "
                         f"be in 1..{MAX_CHANNELS} and the patch at least 1x1")
    sz = 1 if bits is not None and bits <= 8 else 4     # bytes of an element in and out
    cp4, cpo4 = _up(cin, 4), _up(cout, 4)
    ng = cpo4 // 4
    pst = _pixel_stride(ng)
    bw = -(-w // -(-w // BAND))
    bands = -(-w // bw)
    rw1 = min(w, bw + 2)
    srow, orow = _up(rw1 * cin * sz, 16), _up(bw * cout * sz, 16)
    weights = 48 * cpo4 + cp4 * cpo4 * sz

    def smem(s: int) -> int:
        return (s + 1) * srow + (s + 2) * rw1 * pst * 4 + 2 * s * orow + weights

    def per_sm(s: int) -> int:
        return min(SM_SMEM // (smem(s) + SMEM_RESERVED), SM_THREADS // MAX_THREADS,
                   SM_REGISTERS // (MAX_THREADS * REGISTERS))

    fits = [s for s in range(1, min(MAX_ROWS, h) + 1) if smem(s) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"bsconv_report: Cin={cin}, Cout={cout}, patch {h}x{w}: one row a step "
                         f"needs {smem(1)} B of shared memory, over the H100's {SMEM_LIMIT} B "
                         f"per block")
    rows = max(fits, key=lambda s: (per_sm(s) * s, -s))
    t = MAX_THREADS
    lanes = t // ng                                   # the 1x1's pixel lanes
    px = rows * min(w, bw + 2)                        # 1x1 pixels of a full step
    pairs = -(-bw // 2)
    dw_items = ng * pairs * max(1, min(rows, t // (ng * pairs)))
    return {"bands": bands, "band_width": bw, "rows_per_step": rows, "threads": t,
            "smem_bytes": smem(rows), "smem_limit": SMEM_LIMIT, "blocks_per_sm": per_sm(rows),
            "pointwise_busy": px * ng / (t * -(-px // lanes)),
            "depthwise_busy": _busy(dw_items, t)}


@functools.lru_cache(maxsize=64)
def launch_shape(cin: int, cout: int, h: int, w: int, bits: Optional[int]) -> Tuple[int, int]:
    """(rows a step, threads) of `bsconv_report`, kept per shape: the
    wrappers run once per launch."""
    rep = bsconv_report(cin, cout, h, w, bits)
    return rep["rows_per_step"], rep["threads"]


def bsconv_fused(x: torch.Tensor, pw: torch.Tensor, pw_b: torch.Tensor,
                 dw: torch.Tensor, dw_b: torch.Tensor, *, relu: bool = False) -> torch.Tensor:
    """x: (N,H,W,Cin) fp32; pw: (Cin,Cout); dw: (3,3,Cout); biases (Cout,).

    CPU tensors take the plain version (`kernels.ref.bsconv_ref`); CUDA
    tensors launch the kernel with `bsconv_report`'s rows and threads. N = 0
    returns an empty output, no launch."""
    cin, cout = int(pw.shape[0]), int(pw.shape[-1])
    check_operands("bsconv_fused", x, {
        "pw": (pw, (x.shape[-1], cout)), "pw_b": (pw_b, (cout,)),
        "dw": (dw, (3, 3, cout)), "dw_b": (dw_b, (cout,))})
    check_channels("bsconv_fused", Cin=cin, Cout=cout)
    if x.device.type == "cpu":
        return bsconv_ref(x, pw, pw_b, dw, dw_b, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"bsconv_fused: no kernel for device {x.device}")
    n, h, w, _ = x.shape
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    launch = _build.entry("bsconv", "bsconv_forward", 6, 8)
    launch(x.data_ptr(), pw.data_ptr(), pw_b.data_ptr(), dw.data_ptr(), dw_b.data_ptr(),
           out.data_ptr(), n, h, w, cin, cout, int(relu), *launch_shape(cin, cout, h, w, None),
           stream_of(x))
    bsconv_fused.launches += 1
    return out


bsconv_fused.launches = 0
