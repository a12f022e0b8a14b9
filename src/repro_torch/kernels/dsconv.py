"""Fused DSConv kernel wrapper (CUDA source: ``csrc/dsconv.cu``).

Replaces ``repro/kernels/dsconv.py::dsconv_fused``: 3x3 SAME depthwise +
bias -> 1x1 pointwise + bias -> optional ReLU in one launch. The kernel walks
each patch's column bands top to bottom over a ring of input rows, sized by
:func:`dsconv_report`; the same walker serves the quantized qDSConv
(`kernels.qconv.qdsconv_fused`). ``dsconv_fused.launches`` counts launches.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import MAX_CHANNELS, check_channels, check_operands, stream_of
from repro_torch.kernels.megakernel import SM_REGISTERS, SM_SMEM, SM_THREADS, SMEM_LIMIT, \
    SMEM_RESERVED
from repro_torch.kernels.ref import dsconv_ref
from repro_torch.kernels.sfb import _busy, _up

#: Widest output band of a work item, pixels (csrc/dsconv.cu ``BAND``).
BAND = 32
#: Most output rows a step, most threads a block (``MAX_THREADS``) and the
#: registers a thread holds at most (its launch bounds: two blocks an SM).
MAX_ROWS, MAX_THREADS, REGISTERS = 8, 256, 128


def dsconv_report(cin: int, cout: int, h: int, w: int,
                  bits: Optional[int] = None) -> Dict[str, Any]:
    """Static sizing of the DSConv band walker on the H100 for (h, w) patches,
    ``cin`` -> ``cout`` channels: fp32 (``bits`` None) or the quantized
    qDSConv on int8 (``bits`` <= 8) or int32 codes. Returns the column bands
    and their width, output rows a step, threads, dynamic shared-memory bytes
    a block (the launch uses exactly these), the blocks an SM holds by shared
    memory, threads and registers, and the share of thread slots that work
    in a full step's depthwise and pointwise. Of the step heights whose
    block fits, it takes the one that keeps the most output rows resident on
    an SM (blocks an SM x rows a step), the fewer rows on a tie. Raises
    ValueError when no step fits a block's 232,448 B."""
    if not (1 <= cin <= MAX_CHANNELS and 1 <= cout <= MAX_CHANNELS and h >= 1 and w >= 1):
        raise ValueError(f"dsconv_report: Cin={cin}, Cout={cout}, patch {h}x{w}: channels must "
                         f"be in 1..{MAX_CHANNELS} and the patch at least 1x1")
    sz = 1 if bits is not None and bits <= 8 else 4     # bytes of an element in and out
    cp4, cp8, cpo8 = _up(cin, 4), _up(cin, 8), _up(cout, 8)
    bw = -(-w // -(-w // BAND))
    bands = -(-w // bw)
    rw1 = min(w, bw + 2)
    srow, orow = _up(rw1 * cin * sz, 16), _up(bw * cout * sz, 16)
    weights = 4 * (11 * cp8 + cp4 * cpo8 + cpo8)

    def smem(s: int) -> int:
        return (s + 2) * srow + s * bw * (cp8 + 4) * 4 + s * orow + weights

    def per_sm(s: int) -> int:
        return min(SM_SMEM // (smem(s) + SMEM_RESERVED), SM_THREADS // MAX_THREADS,
                   SM_REGISTERS // (MAX_THREADS * REGISTERS))

    fits = [s for s in range(1, min(MAX_ROWS, h) + 1) if smem(s) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"dsconv_report: Cin={cin}, Cout={cout}, patch {h}x{w}: one row a step "
                         f"needs {smem(1)} B of shared memory, over the H100's {SMEM_LIMIT} B "
                         f"per block")
    rows = max(fits, key=lambda s: (per_sm(s) * s, -s))
    t = MAX_THREADS
    pairs = -(-bw // 2)
    dw_items = cp4 // 4 * pairs * max(1, min(rows, t // (cp4 // 4 * pairs)))
    pw_items = cpo8 // 8 * -(-rows * bw // 4)
    return {"bands": bands, "band_width": bw, "rows_per_step": rows, "threads": t,
            "smem_bytes": smem(rows), "smem_limit": SMEM_LIMIT, "blocks_per_sm": per_sm(rows),
            "depthwise_busy": _busy(dw_items, t), "pointwise_busy": _busy(pw_items, t)}


@functools.lru_cache(maxsize=64)
def launch_shape(cin: int, cout: int, h: int, w: int, bits: Optional[int]) -> Tuple[int, int]:
    """(rows a step, threads) of `dsconv_report`, kept per shape: the
    wrappers run once per launch."""
    rep = dsconv_report(cin, cout, h, w, bits)
    return rep["rows_per_step"], rep["threads"]


def dsconv_fused(x: torch.Tensor, dw: torch.Tensor, dw_b: torch.Tensor,
                 pw: torch.Tensor, pw_b: torch.Tensor, *, relu: bool = False) -> torch.Tensor:
    """x: (N,H,W,Cin) fp32; dw: (3,3,Cin); pw: (Cin,Cout); biases.

    CPU tensors take the plain version (`kernels.ref.dsconv_ref`); CUDA
    tensors launch the kernel with `dsconv_report`'s rows and threads. An
    empty batch returns an empty output, no launch."""
    cin, cout = int(pw.shape[0]), int(pw.shape[-1])
    check_operands("dsconv_fused", x, {
        "dw": (dw, (3, 3, x.shape[-1])), "dw_b": (dw_b, (x.shape[-1],)),
        "pw": (pw, (x.shape[-1], cout)), "pw_b": (pw_b, (cout,))})
    check_channels("dsconv_fused", Cin=cin, Cout=cout)
    if x.device.type == "cpu":
        return dsconv_ref(x, dw, dw_b, pw, pw_b, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"dsconv_fused: no kernel for device {x.device}")
    n, h, w, _ = x.shape
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    launch = _build.entry("dsconv", "dsconv_forward", 6, 8)
    launch(x.data_ptr(), dw.data_ptr(), dw_b.data_ptr(), pw.data_ptr(), pw_b.data_ptr(),
           out.data_ptr(), n, h, w, cin, cout, int(relu), *launch_shape(cin, cout, h, w, None),
           stream_of(x))
    dsconv_fused.launches += 1
    return out


dsconv_fused.launches = 0
