"""Sharding context: lets model code place activation sharding constraints
without depending on a concrete mesh (twin of ``repro.distributed.ctx``; a
no-op when unset, on a plain tensor, and so in every single-card run).

Model code says ``constrain(x, "dp", "mp", None)`` — symbolic axes:
  'dp' -> the data-parallel axes (('pod','data') multi-pod, ('data',) single)
  'mp' -> the model axis.
Dims that don't divide the named axis size drop the constraint, as the
reference's do (qwen2's 14 heads, batch-1 decode): DTensor would shard such a
dim unevenly, and that is a different program.

A spec is a `PartitionSpec`: one entry a tensor dim, each a mesh-axis name,
a tuple of names or ``None`` (the reference's language). On a DTensor,
`ShardCtx.constrain` redistributes to the placements of the spec
(`repro_torch.distributed.sharding.to_placements`), which is where the
reference's ``with_sharding_constraint`` lets XLA insert its collectives.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple, Union

import torch

Axis = Union[str, None, Tuple[str, ...]]


class PartitionSpec:
    """The reference's ``jax.sharding.PartitionSpec``: an entry a tensor
    dim (a mesh-axis name, a tuple of names, or ``None``). Not a tuple, so
    the port's tree helpers take a spec as one leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries: Axis):
        self.entries = tuple(entries)

    def __iter__(self) -> Iterator[Axis]:
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


P = PartitionSpec


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or of any object with the
    reference's ``mesh.shape`` dict (its tests' ``_FakeMesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: Any                         # a DeviceMesh (or the tests' fake mesh)
    dp: Tuple[str, ...]               # data-parallel mesh axes
    mp: str                           # model axis

    def axis_size(self, sym: Axis) -> int:
        if sym is None:
            return 1
        names = self.dp if sym == "dp" else (self.mp,) if sym == "mp" else sym
        names = (names,) if isinstance(names, str) else names
        sizes = mesh_sizes(self.mesh)
        return math.prod(sizes[n] for n in names)

    def resolve(self, sym: Axis):
        if sym is None:
            return None
        if sym == "dp":
            return self.dp if len(self.dp) > 1 else self.dp[0]
        if sym == "mp":
            return self.mp
        return sym

    def spec(self, x_shape, axes: Sequence[Axis]) -> PartitionSpec:
        entries = []
        for dim, sym in zip(x_shape, axes):
            if sym is not None and dim % self.axis_size(sym) == 0 and dim > 0:
                entries.append(self.resolve(sym))
            else:
                entries.append(None)
        return PartitionSpec(*entries)

    def constrain(self, x: torch.Tensor, *axes: Axis) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        from repro_torch.distributed.sharding import to_placements
        if not isinstance(x, DTensor):
            return x
        placements = to_placements(self.spec(x.shape, axes), self.mesh)
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(self.mesh, placements)


_CURRENT: Optional[ShardCtx] = None


@contextlib.contextmanager
def use_ctx(ctx: Optional[ShardCtx]):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = ctx
    try:
        yield
    finally:
        _CURRENT = prev


def current() -> Optional[ShardCtx]:
    return _CURRENT


def is_sharded(x: torch.Tensor, dim: int) -> bool:
    """Is ``x`` a DTensor split along ``dim`` (the dry run), over a mesh
    axis of more than one rank?"""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return False
    dim = dim % x.ndim
    return any(isinstance(pl, Shard) and pl.dim == dim and x.device_mesh.size(i) > 1
               for i, pl in enumerate(x.placements))


def split_dim(x: torch.Tensor, dim: int, sizes: Sequence[int]) -> torch.Tensor:
    """``x`` with dim ``dim`` split into ``sizes`` (heads out of a hidden
    dim). On a DTensor sharded along ``dim`` over an axis that does not
    divide ``sizes[0]`` (8 KV heads on a 16-way axis), that axis is
    replicated first: DTensor cannot split an uneven shard."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dim = dim % x.ndim
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        pl = list(x.placements)
        n = 1
        for i, p in enumerate(pl):
            if isinstance(p, Shard) and p.dim == dim:
                if sizes[0] % (n * mesh.size(i)):
                    pl[i] = Replicate()
                else:
                    n *= mesh.size(i)
        if tuple(pl) != tuple(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def gather_dp(w: torch.Tensor) -> torch.Tensor:
    """A DTensor weight with its data-parallel shards gathered (ZeRO-3's
    all-gather before use; its gradient leaves by the reduce-scatter that is
    this redistribution's backward); other tensors as they are."""
    from torch.distributed.tensor import DTensor, Replicate
    ctx = _CURRENT
    if ctx is None or not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if names[i] in ctx.dp else p for i, p in enumerate(w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(w.device_mesh, pl)


class Gathered(Mapping):
    """A read-only view of a parameter tree (nested dicts and lists) whose
    DTensor leaves read through `gather_dp`: model code uses each weight
    whole over the data axes, as ZeRO-3 does, where DTensor left alone
    would often gather the activations instead and repeat the matmul on
    every data rank. Each read gathers again (a rematted layer gathers in
    its recompute too)."""

    def __init__(self, tree):
        self._tree = tree

    def __getitem__(self, key):
        return _gathered(self._tree[key])

    def __iter__(self):
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)


def _gathered(v):
    if isinstance(v, (dict, Mapping)):
        return Gathered(v)
    if isinstance(v, (list, tuple)):
        return [_gathered(x) for x in v]
    return gather_dp(v)


def ungathered(tree):
    """The tree under a `Gathered` view, its leaves as they are stored (for
    code that gathers its weights itself: the explicit MoE's ZeRO-3
    all-gathers); any other tree as it is."""
    return tree._tree if isinstance(tree, Gathered) else tree


def params_view(params):
    """``params`` as model code should read them: through `Gathered` under
    a sharding context (the dry run), as they are otherwise."""
    return params if _CURRENT is None else Gathered(params)


def replicate(w: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank; other tensors as they are."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor) or all(p == Replicate() for p in w.placements):
        return w
    return w.redistribute(w.device_mesh, (Replicate(),) * w.device_mesh.ndim)


class _Merge(torch.autograd.Function):
    """Merge dims [dim, dim + len(sizes)) of a DTensor; the gradient is split
    back with `split_dim`, which replicates an axis that cannot split."""

    @staticmethod
    def forward(ctx, x, dim, sizes):
        ctx.dim, ctx.sizes = dim, sizes
        return x.reshape(*x.shape[:dim], -1, *x.shape[dim + len(sizes):])

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, ctx.sizes), None, None


def merge_dims(x: torch.Tensor, dim: int, n: int = 2) -> torch.Tensor:
    """``x`` with dims [dim, dim + n) merged into one (heads into a hidden
    dim). On a DTensor its gradient is split with `split_dim`: DTensor
    may shard the merged gradient over an axis that the heads do not divide,
    and could not split it."""
    dim = dim % x.ndim
    if is_dtensor(x) and x.requires_grad:
        return _Merge.apply(x, dim, tuple(x.shape[dim:dim + n]))
    return x.reshape(*x.shape[:dim], -1, *x.shape[dim + n:])


class _GradTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, placements):
        ctx.mesh, ctx.placements = x.device_mesh, placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g, None


def grad_like(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient (on a DTensor) is laid out like ``x`` before it
    flows back: the backward twin of a constraint. Autograd would hand a
    block's backward its output gradient in whatever layout the next op's
    backward chose (the sequence-sharded residual stream), and DTensor would
    then move whole score tensors to meet the block's own layout."""
    if is_dtensor(x) and x.requires_grad:
        return _GradTo.apply(x, tuple(x.placements))
    return x


def grad_to(x: torch.Tensor, *axes: Axis) -> torch.Tensor:
    """``x``, whose gradient (on a DTensor, under a context) is laid out by
    the spec of ``axes`` before it flows back: a projection that feeds the
    sequence-sharded residual stream takes its gradient with the sequence
    gathered (Megatron-SP's all-gather, the backward of the forward's
    reduce-scatter), which its matmul's backward can fold."""
    if _CURRENT is None or not (is_dtensor(x) and x.requires_grad):
        return x
    from repro_torch.distributed.sharding import to_placements
    return _GradTo.apply(x, to_placements(_CURRENT.spec(x.shape, axes), x.device_mesh))


def on_shards(fn, *xs):
    """``fn`` over each DTensor's local shard (other arguments as they are),
    its result a DTensor laid out like the first argument; ``fn(*xs)`` when
    the first argument is no DTensor. For work that is independent per
    shard, such as attention
    over each rank's batch and heads: the caller lays every input out so
    that each holds whole the dims ``fn`` mixes. DTensor would otherwise
    flatten a batch dim with a sharded heads dim in every batched matmul,
    which some versions of it refuse, and pay its dispatch on each op of
    the loop."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    like = xs[0]
    if not isinstance(like, DTensor):
        return fn(*xs)

    def local(x):
        # an input whole on an axis that splits the result takes a partial
        # gradient there (each rank's share of the sum)
        grad = tuple(Partial() if isinstance(px, Replicate) and isinstance(pl, Shard) else px
                     for px, pl in zip(x.placements, like.placements))
        return _ContiguousGrad.apply(x).to_local(grad_placements=grad)
    out = fn(*[local(x) if isinstance(x, DTensor) else x for x in xs])
    return DTensor.from_local(out, like.device_mesh, like.placements, run_check=False)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient leaves contiguous: a local backward hands
    back permuted gradients, and DTensor views its local shards (it would
    fail to fold one for the next matmul's backward)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def pad(x: torch.Tensor, widths, value=0.0) -> torch.Tensor:
    """``F.pad(x, widths, value=value)``; on a DTensor, on each rank's
    shard, the padded dims first made whole on every rank (DTensor's own pad
    is mis-planned by some of its versions)."""
    import torch.nn.functional as F
    if not is_dtensor(x):
        return F.pad(x, widths, value=value)
    from torch.distributed.tensor import Replicate, Shard
    dims = {x.ndim - 1 - i for i in range(len(widths) // 2) if widths[2 * i] or widths[2 * i + 1]}
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim % x.ndim in dims else p
               for p in x.placements)
    if pl != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return on_shards(lambda u: F.pad(u, widths, value=value), x)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *axes: Axis) -> torch.Tensor:
    """Module-level hook used inside model code. No-op without a context."""
    if _CURRENT is None:
        return x
    return _CURRENT.constrain(x, *axes)
