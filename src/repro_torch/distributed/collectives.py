"""Explicit collectives over one mesh axis (twin of
``repro.distributed.collectives``), and the differentiable collectives the
explicit MoE (``distributed/moe.py``) is built from.

The reference writes each pattern as a ``shard_map`` body that calls
``lax.pmax``/``lax.psum`` on its mesh axis. The port runs one process a
rank: each function does its local work on this rank's shard and calls
``torch.distributed``'s functional collectives on ``mesh.get_group(axis)``
(the ``_c10d_functional`` ops, so the dry run's `launch/counters.py`
counts them by kind and axis; over a ``fake`` group they move no data).

* ``flash_decode_attention`` — decode attention over a SEQUENCE-sharded KV
  cache with the flash-decoding (m, l, o) partial-softmax combine: each
  rank attends to its cache slice, then one MAX all-reduce of m and two SUM
  all-reduces merge the partials.
* ``compressed_psum`` — int8-quantized gradient all-reduce with error
  feedback (the reference's arithmetic: what is all-reduced is the fp32
  ``q * scale``, as its ``lax.psum`` does).

Differentiable collectives (a ``torch.autograd.Function`` each; the
gradient conventions of a ``shard_map`` body whose outputs are used whole
on every rank):

* `psum`: SUM all-reduce of per-rank partials into a value every rank
  holds whole; its gradient is the output's, unchanged, on every rank.
* `all_gather`: a dim gathered from its shards (ZeRO-3's weight read);
  each rank's use of the gathered tensor is its own share of the loss, so
  the gradient is reduce-scattered back.
* `all_gather_whole`: the same gather of a result that every rank then
  holds whole as one value; the gradient is each rank's own slice.
* `all_to_all`: dim 0 (one block a rank) exchanged; the gradient goes back
  by the same exchange.

An axis of one rank moves nothing: each returns its input.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.distributed.ctx import PartitionSpec as P
from repro_torch.distributed.ctx import is_dtensor

NEG_INF = -1e30

Axes = Union[str, Sequence[str]]


def _c10d():
    return torch.ops._c10d_functional


def _all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    c = _c10d()
    return c.wait_tensor(c.all_reduce(x.contiguous(), op, group.group_name))


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of every rank of ``group`` concatenated along ``dim``."""
    c, n = _c10d(), group.size()
    y = c.wait_tensor(c.all_gather_into_tensor(x.contiguous(), n, group.group_name))
    return y if dim == 0 else torch.cat(y.chunk(n, 0), dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The SUM over ``group`` of ``x``, each rank keeping its block of ``dim``."""
    c, n = _c10d(), group.size()
    if dim != 0:
        x = torch.cat(x.chunk(n, dim), dim=0)
    return c.wait_tensor(c.reduce_scatter_tensor(x.contiguous(), "sum", n, group.group_name))


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    c, n = _c10d(), group.size()
    splits = [x.shape[0] // n] * n
    return c.wait_tensor(c.all_to_all_single(x.contiguous(), splits, splits, group.group_name))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axes: Axes) -> int:
    """This rank's coordinate along ``axes`` (several axes: major to minor,
    as a dim split over them is laid out)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _AllGatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, idx):
        ctx.dim, ctx.n, ctx.idx = dim, n, idx
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.idx].contiguous(), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _minor_first(axes: Axes) -> Tuple[str, ...]:
    return tuple(reversed((axes,) if isinstance(axes, str) else tuple(axes)))


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """SUM over ``axes`` (``lax.psum``); see the module docstring."""
    for a in _minor_first(axes):
        if axis_size(mesh, a) > 1:
            x = _Psum.apply(x, mesh.get_group(a))
    return x


def pmax(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """MAX over ``axes`` (``lax.pmax``), with no gradient."""
    for a in _minor_first(axes):
        if axis_size(mesh, a) > 1:
            x = _all_reduce(x, "max", mesh.get_group(a))
    return x


def pmean(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Mean over ``axes`` (``lax.pmean``)."""
    n = math.prod(axis_size(mesh, a) for a in _minor_first(axes))
    return psum(x, mesh, axes) / n


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)`` of a dim split over ``axes``
    (several: major to minor, gathered from the minor one out); the
    gradient is reduce-scattered."""
    for a in _minor_first(axes):
        if axis_size(mesh, a) > 1:
            x = _AllGather.apply(x, dim, mesh.get_group(a))
    return x


def all_gather_whole(x: torch.Tensor, mesh, axes: Axes, dim: int) -> torch.Tensor:
    """`all_gather` of a result that every rank holds whole afterwards;
    the gradient is each rank's own slice."""
    for a in _minor_first(axes):
        n = axis_size(mesh, a)
        if n > 1:
            x = _AllGatherWhole.apply(x, dim, mesh.get_group(a), n, mesh.get_local_rank(a))
    return x


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0, tiled=False)``: ``x`` is (n, ...),
    block j goes to rank j; block i of the result came from rank i."""
    if axis_size(mesh, axis) == 1:
        return x
    return _AllToAll.apply(x, mesh.get_group(axis))


def _local(x: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    """This rank's shard of a DTensor laid out by ``spec``."""
    from repro_torch.distributed.sharding import to_placements
    pl = to_placements(spec, mesh)
    if tuple(x.placements) != pl:
        x = x.redistribute(mesh, pl)
    return x.to_local()


# ---------------------------------------------------------------------------
# flash-decoding over a sequence-sharded cache
# ---------------------------------------------------------------------------

def flash_decode_attention(mesh, axis: str, q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, length) -> torch.Tensor:
    """q: (B,1,H,D); caches: (B,S,G,D) sharded on S over ``axis``; length:
    the global fill (an int or a 0-d tensor). Returns (B,1,H,D) in q's dtype.

    DTensors on ``mesh`` are laid out as the reference's ``in_specs`` (q
    whole, the caches split on S over ``axis``) and the result is a DTensor
    whole on every rank. Plain tensors are this rank's own: q whole, the
    caches its slice of S (rank ``i`` of ``axis`` holds positions
    ``i * s_local ...``), and the result is a plain tensor."""
    if not is_dtensor(q):
        return flash_decode_local(mesh, axis, q, k_cache, v_cache, length)
    from torch.distributed.tensor import DTensor, Replicate
    out = flash_decode_local(mesh, axis, _local(q, mesh, P(None, None, None, None)),
                             _local(k_cache, mesh, P(None, axis, None, None)),
                             _local(v_cache, mesh, P(None, axis, None, None)), length)
    return DTensor.from_local(out, mesh, (Replicate(),) * mesh.ndim, run_check=False)


def flash_decode_local(mesh, axes: Axes, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       length) -> torch.Tensor:
    """The reference's shard_map body: q (B,1,H,D), this rank's slice
    (B,S_local,G,D) of caches split on S over ``axes`` (several: major to
    minor); each rank's partial softmax (m, l, o), then one MAX all-reduce
    of m and two SUM all-reduces of l·corr and o·corr."""
    b, _, h, d = q.shape
    s_local, g = k.shape[1], k.shape[2]
    qh = q.reshape(b, g, h // g, d).float()
    scores = torch.einsum("bgrd,bsgd->bgrs", qh, k.float()) * d ** -0.5
    pos = axis_index(mesh, axes) * s_local + torch.arange(s_local, device=q.device)
    scores = torch.where(pos < length, scores, NEG_INF)
    m = scores.amax(dim=-1)                                       # (b,g,rep)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bgrs,bsgd->bgrd", p, v.float())
    # --- combine partials across shards: one MAX, then two SUMs ---------------
    m_max = pmax(m, mesh, axes)
    corr = torch.exp(m - m_max)
    l_sum = psum(l * corr, mesh, axes)
    o_sum = psum(o * corr[..., None], mesh, axes)
    return (o_sum / torch.clamp_min(l_sum[..., None], 1e-30)).reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ---------------------------------------------------------------------------

def int8_codes(g: torch.Tensor):
    """(codes, scale) of one tensor: the reference's per-tensor symmetric
    int8 quantization (``scale = max|g| / 127 + 1e-12``, round half to
    even, clipped to +-127)."""
    scale = g.abs().max() / 127.0 + 1e-12
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8), scale


def compressed_psum(mesh, axis: str, grads, error_state):
    """All-reduce ``grads`` (a tree) over ``axis`` in int8 with per-tensor
    scales and error feedback: residual = g - dequant(quant(g)) carries to
    the next step, so compression error doesn't bias the trajectory.

    Returns (reduced_grads, new_error_state): the mean over the axis of each
    rank's dequantized ``g + err``, and each rank's residual. Plain tensors
    are this rank's own gradients; a DTensor is taken whole on every rank
    (the reference's ``in_specs=P()``) and comes back so."""
    group, n = mesh.get_group(axis), axis_size(mesh, axis)

    def one(g, err):
        dt = is_dtensor(g)
        if dt:
            g, err = (_local(t, mesh, P()) for t in (g, err))
        g = g + err                                      # error feedback
        q, scale = int8_codes(g)
        deq = q.float() * scale
        new_err = g - deq
        total = deq if n == 1 else _all_reduce(deq, "sum", group)
        red = total / float(n)
        if dt:
            from torch.distributed.tensor import DTensor, Replicate
            rep = (Replicate(),) * mesh.ndim
            red, new_err = (DTensor.from_local(t, mesh, rep, run_check=False)
                            for t in (red, new_err))
        return red, new_err

    leaves = tree_leaves(grads)
    outs = [one(g, e) for g, e in zip(leaves, tree_leaves(error_state))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
