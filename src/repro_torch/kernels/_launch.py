"""Operand checks shared by the kernel wrappers.

A wrapper validates device, dtype, shape and contiguity of every operand
before it decides anything, so the CPU tests exercise the same checks the
card's launches rely on. Then a CPU activation takes the plain version; a
CUDA activation launches the kernel or raises.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

#: Widest channel count the kernels' shared-memory layout is sized for.
MAX_CHANNELS = 64
#: Dtypes of the integer lattice codes the quantized kernels take.
CODE_DTYPES = (torch.int8, torch.int32)

_Dtypes = Union[torch.dtype, Tuple[torch.dtype, ...]]


def _names(dtypes: Tuple[torch.dtype, ...]) -> str:
    return " or ".join(str(d).replace("torch.", "") for d in dtypes)


def check_operands(what: str, x: torch.Tensor, operands: Dict[str, tuple],
                   dtype: _Dtypes = torch.float32) -> None:
    """``x``: the (N,H,W,C) activation, of ``dtype`` (one or a tuple of
    allowed dtypes); ``operands``: name -> (tensor, expected shape) for a
    float32 operand, or (tensor, expected shape, dtype). Raises
    ValueError/TypeError on any mismatch."""
    if x.ndim != 4:
        raise ValueError(f"{what}: x must be (N,H,W,C), got shape {tuple(x.shape)}")
    spec = {"x": (x, tuple(x.shape), dtype)}
    spec.update({k: v if len(v) == 3 else (*v, torch.float32) for k, v in operands.items()})
    for name, (t, shape, want) in spec.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {name} must be a tensor, got {type(t).__name__}")
        want = want if isinstance(want, tuple) else (want,)
        if t.dtype not in want:
            raise TypeError(f"{what}: {name} must be {_names(want)}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def check_channels(what: str, **channels: int) -> None:
    for name, c in channels.items():
        if not 1 <= c <= MAX_CHANNELS:
            raise ValueError(f"{what}: {name}={c} outside the kernel's 1..{MAX_CHANNELS}")


def stream_of(x: torch.Tensor) -> int:
    """The current CUDA stream of ``x``'s device, as the int ctypes passes."""
    return torch.cuda.current_stream(x.device).cuda_stream
