"""Fused whole-SFB kernel wrapper (CUDA source: ``csrc/sfb.cu``).

Replaces ``repro/kernels/sfb.py::sfb_fused``: BSConv, ReLU, BSConv, ReLU,
shortcut add, 1x1 fuse, ReLU in one launch; the five intermediates stay in
shared memory. The kernel walks each patch's column bands top to bottom,
keeping the rows its depthwise layers read again in shared-memory rings;
:func:`sfb_report` sizes it. ``sfb_fused.launches`` counts launches.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import MAX_CHANNELS, check_channels, check_operands, stream_of
from repro_torch.kernels.megakernel import SMEM_LIMIT
from repro_torch.kernels.ref import sfb_ref

#: Operand order of the C entry ``sfb_forward``.
SFB_KEYS = ("b1_pw", "b1_pwb", "b1_dw", "b1_dwb", "b2_pw", "b2_pwb", "b2_dw", "b2_dwb",
            "fuse", "fuse_b")
#: Widest output band of a work item, pixels (csrc/sfb.cu ``BAND``).
BAND = 32
#: Most output rows a step, and most threads a block (``MAX_THREADS``).
MAX_ROWS, MAX_THREADS = 8, 256


def _up(c: int, m: int) -> int:
    return -(-c // m) * m


def _busy(items: int, threads: int) -> float:
    """Share of thread slots that work when ``threads`` walk ``items``."""
    return items / (threads * -(-items // threads)) if items else 1.0


def sfb_report(c: int, h: int, w: int) -> Dict[str, Any]:
    """Static sizing of the SFB kernel on the H100 for (h, w) patches of
    ``c`` channels: column bands and their width, output rows a step (the
    most of ``MAX_ROWS`` whose rings fit), threads, dynamic shared-memory
    bytes a block (the launch uses exactly these), pointwise pixels computed
    per output pixel (3.0 when one band spans the patch), and the share of
    thread slots that work in a full step's pointwise and depthwise stages.
    Raises ValueError when no step fits a block's 232,448 B."""
    if not (1 <= c <= MAX_CHANNELS and h >= 1 and w >= 1):
        raise ValueError(f"sfb_report: C={c}, patch {h}x{w}: C must be in 1..{MAX_CHANNELS} "
                         f"and the patch at least 1x1")
    cp8 = _up(c, 8)
    stride = cp8 + 4
    bw = -(-w // -(-w // BAND))
    bands = -(-w // bw)
    rw1, rw2 = min(w, bw + 4), min(w, bw + 2)

    def smem(s: int) -> int:
        return 4 * (stride * (2 * (s + 2) * rw1 + (s + 2) * rw2 + (s + 1) * rw2)
                    + 3 * cp8 * cp8 + 23 * cp8)

    rows = next((s for s in range(min(MAX_ROWS, h), 0, -1) if smem(s) <= SMEM_LIMIT), 0)
    if rows == 0:
        raise ValueError(f"sfb_report: C={c}, patch {h}x{w}: one row a step needs {smem(1)} B "
                         f"of shared memory, over the H100's {SMEM_LIMIT} B per block")
    ng8 = cp8 // 8
    threads = min(MAX_THREADS, _up(-(-rows * bw // 4) * ng8, 32))
    # columns each band computes: x / pw1, dw1 / pw2, and its output
    cols = [(min(w, b + bw + 2) - max(0, b - 2), min(w, b + bw + 1) - max(0, b - 1),
             min(w, b + bw) - b) for b in range(0, w, bw)]
    w1, w2, w3 = cols[0]
    pw_items = [-(-rows * width // 4) * ng8 for width in (w1, w2, w3)]
    dw_items = [cp8 // 4 * width for width in (w2, w3)]
    return {"bands": bands, "band_width": bw, "rows_per_step": rows, "threads": threads,
            "smem_bytes": smem(rows), "smem_limit": SMEM_LIMIT,
            "pointwise_px_per_output_px": sum(a + b + o for a, b, o in cols) / w,
            "pointwise_busy": min(_busy(n, threads) for n in pw_items),
            "depthwise_busy": min(_busy(n, threads) for n in dw_items)}


def sfb_fused(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x: (N,H,W,C) fp32; ``p``: the flat SFB weights of `SFB_KEYS`
    (pointwise (C,C), depthwise (3,3,C), biases (C,)).

    CPU tensors take the plain version (`kernels.ref.sfb_ref`); CUDA tensors
    launch the kernel. An empty batch or map returns an empty output, no
    launch."""
    c = int(x.shape[-1]) if x.ndim == 4 else -1
    shapes = {"pw": (c, c), "dw": (3, 3, c), "b": (c,)}
    check_operands("sfb_fused", x, {
        k: (p[k], shapes["dw" if k.endswith("_dw") else
                         "pw" if k in ("b1_pw", "b2_pw", "fuse") else "b"])
        for k in SFB_KEYS})
    check_channels("sfb_fused", C=c)
    if x.device.type == "cpu":
        return sfb_ref(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"sfb_fused: no kernel for device {x.device}")
    n, h, w, _ = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rep = sfb_report(c, h, w)
    launch = _build.entry("sfb", "sfb_forward", 12, 6)
    launch(x.data_ptr(), *(p[k].data_ptr() for k in SFB_KEYS), out.data_ptr(),
           n, h, w, c, rep["rows_per_step"], rep["threads"], stream_of(x))
    sfb_fused.launches += 1
    return out


sfb_fused.launches = 0
