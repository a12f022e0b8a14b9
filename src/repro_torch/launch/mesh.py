"""Meshes (twin of ``repro.launch.mesh``): the LM side's production and test
meshes, and the devices of the sharded patch stream.

The reference fakes 512 host devices for its dry run; the port fakes the
process group instead. `fake_world` initializes a ``fake`` group of ``n``
ranks with this process as rank 0 (collectives return at once, and move no
data), and `make_production_mesh` / `make_test_mesh` lay a ``DeviceMesh``
over it. A process holds one default group, so the group lives only inside
the ``with``: on its exit the group is destroyed and ``torch.distributed``
is as it was.

The same meshes lay over a real group that the caller initialized, one
process a rank: a ``gloo`` group gives a mesh of CPU tensors, an ``nccl``
group one of CUDA tensors, each rank on card ``rank % device_count``.
The device type follows the group's backend; an ``nccl`` group on a host
without a card raises, nothing falls back to the CPU.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Tuple

import torch


@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """A ``fake`` process group of ``n`` ranks, this process rank 0, for the
    ``with`` block only. Refuses to stack on a group already initialized."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _group_device_type() -> str:
    """The device type of the initialized default group's tensors: "cuda"
    for ``nccl`` (this rank's card made current), "cpu" for ``gloo`` and
    ``fake``."""
    import torch.distributed as dist
    backend = str(dist.get_backend()).lower()
    if "nccl" not in backend:
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("an nccl process group needs a CUDA card, and none is visible")
    torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return "cuda"


def _device_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a mesh of {shape} needs a process group of {n} ranks: "
                           f"build it inside `with fake_world({n}):` or over an initialized "
                           f"gloo or nccl group of {n} processes")
    return init_device_mesh(_group_device_type(), tuple(shape), mesh_dim_names=tuple(axes))


def production_mesh_shape(*, multi_pod: bool = False):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod:  (pod=2, data=16, model=16) = 512 ranks (pod = DP).
    Call it inside ``fake_world(256)`` (``fake_world(512)``)."""
    return _device_mesh(*production_mesh_shape(multi_pod=multi_pod))


def make_test_mesh(shape=(2, 2), axes=("data", "model")):
    """Small mesh for distributed tests: inside ``fake_world(prod(shape))``,
    or over a gloo (CPU) or nccl (one card a rank) group of that size."""
    return _device_mesh(tuple(shape), tuple(axes))


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
