"""The devices of the sharded patch stream (twin of ``repro.launch.mesh``'s
``make_patch_mesh``; the LM meshes belong to the LM side).

A function, so importing this module touches no CUDA state.
"""
from __future__ import annotations

from typing import Tuple

import torch


def make_patch_devices(shards: int) -> Tuple[torch.device, ...]:
    """The first ``shards`` CUDA devices: the sharded patch stream's
    data-parallel axis (each device runs a contiguous slice of every routed
    patch bucket; see `core.pipeline._sharded_forward`)."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    avail = torch.cuda.device_count()
    if shards > avail:
        raise ValueError(f"requested {shards} shards but only {avail} devices are visible")
    return tuple(torch.device("cuda", i) for i in range(shards))
