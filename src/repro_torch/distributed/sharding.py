"""Partition specs for every parameter / cache / input of the LM side (twin
of ``repro.distributed.sharding``), and their DTensor placements.

Strategy, the reference's:
  * FSDP  — weights' d_model-like dims sharded over the data axes (ZeRO-3);
  * TP    — head / hidden / vocab / expert dims over 'model';
  * EP    — MoE expert dim over 'model' when n_experts >= mesh model size;
  * SP    — activations' sequence dim over 'model' (ctx.constrain in model);
  * caches— kv-heads over 'model' when divisible, else SEQUENCE over 'model';
            batch over data axes when divisible (batch-1 long-context shards
            seq over data too).

Every rule is divisibility-guarded so reduced smoke configs and small test
meshes never produce invalid specs.

The port keeps an LM's layers as a list (``layers/<i>/...``), not stacked
on a leading axis: a per-layer leaf gets the reference's spec for
``layers/...`` without the leading ``None``. `to_placements` turns a spec
into DTensor placements: a tensor dim sharded over several mesh axes is
``Shard(dim)`` on each of them, in the mesh's axis order. A data tuple
nested in ``(dp, mp)`` (a batch that does not divide the data axes) is
flattened into one entry of three axes.

The patch stream's ``patch_batch_spec``/``patch_batch_sharding`` are not
ported: the port splits a patch batch by hand (``core.pipeline``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

from repro_torch.configs.base import LMConfig
from repro_torch.distributed.ctx import PartitionSpec as P
from repro_torch.distributed.ctx import ShardCtx, mesh_sizes

STACKED = ("layers", "enc_layers", "dec_layers")


# ---------------------------------------------------------------------------
# mesh info
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshInfo:
    mesh: Any                         # a DeviceMesh (or the tests' fake mesh)
    dp: Tuple[str, ...]
    mp: str

    @property
    def sizes(self) -> Dict[str, int]:
        return mesh_sizes(self.mesh)

    @property
    def dp_size(self) -> int:
        return math.prod(self.sizes[a] for a in self.dp)

    @property
    def mp_size(self) -> int:
        return self.sizes[self.mp]

    @property
    def n_devices(self) -> int:
        return math.prod(self.sizes.values())

    @property
    def dp_resolved(self):
        return self.dp if len(self.dp) > 1 else self.dp[0]

    def ctx(self) -> ShardCtx:
        return ShardCtx(self.mesh, self.dp, self.mp)

    def placements(self, spec: P):
        return to_placements(spec, self.mesh)


def mesh_info(mesh) -> MeshInfo:
    names = tuple(mesh_sizes(mesh))
    dp = tuple(a for a in names if a in ("pod", "data"))
    return MeshInfo(mesh, dp, "model")


def _flat(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(n for e in entry for n in _flat(e))


def _entry(names: Tuple[str, ...]):
    """A flat tuple of names as one spec entry (one name stays a string)."""
    return names[0] if len(names) == 1 else names


def to_placements(spec: P, mesh) -> tuple:
    """DTensor placements (one a mesh dim) of ``spec``: each tensor dim's
    mesh axes become ``Shard(dim)``, the rest ``Replicate()``. A dim over
    several axes must name them in the mesh's order (DTensor splits a dim
    over mesh dims major to minor, as JAX over a tuple). An axis of one rank
    splits nothing and stays ``Replicate()``: DTensor would refuse to merge
    such a "sharded" dim (a batch of 1) into another."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_sizes(mesh)
    names = tuple(sizes)
    out = [Replicate()] * len(names)
    used = set()
    for dim, entry in enumerate(spec):
        axes = _flat(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {dim} names {axes} out of the mesh's order {names}")
        for i in idx:
            if i in used:
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} shards two dims")
            used.add(i)
            if sizes[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def local_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """One rank's shard shape of a tensor of ``shape`` under ``spec``
    (every rule divides, so every rank holds the same)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _flat(entry))
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide {entry} ({n})")
        out[dim] //= n
    return tuple(out)


# ---------------------------------------------------------------------------
# tree walking (paths as the reference spells them)
# ---------------------------------------------------------------------------

def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _tree_of(params):
    return params.tree() if hasattr(params, "tree") else params


# ---------------------------------------------------------------------------
# parameter specs (path-pattern rules)
# ---------------------------------------------------------------------------

def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _base_spec(path: str, shape: Tuple[int, ...], cfg: LMConfig, mi: MeshInfo) -> P:
    """Spec for the UNSTACKED parameter (no leading layer dim)."""
    dp, mp = mi.dp_resolved, mi.mp
    dpn, mpn = mi.dp_size, mi.mp_size
    fs = lambda n: dp if _div(n, dpn) else None          # fsdp if divisible  # noqa: E731
    tp = lambda n: mp if _div(n, mpn) else None          # noqa: E731

    leaf = path.split("/")[-1]

    # --- embeddings / heads -------------------------------------------------
    if leaf == "embed":
        return P(tp(shape[0]), fs(shape[1]))
    if leaf == "lm_head" or leaf == "vision_proj" or leaf == "proj":
        return P(fs(shape[0]), tp(shape[1]))

    # --- norms / scalars / small vectors ------------------------------------
    if len(shape) <= 1:
        return P(*([None] * len(shape)))

    # --- MoE ----------------------------------------------------------------
    if "/moe/" in path or path.endswith("router"):
        if leaf == "router":
            return P(fs(shape[0]), None)
        if leaf in ("w_in", "w_gate") and len(shape) == 3:
            if cfg.moe_mode == "ep_alltoall" and _div(shape[0], mpn):
                return P(mp, fs(shape[1]), None)
            return P(None, fs(shape[1]), tp(shape[2]))
        if leaf == "w_out" and len(shape) == 3:
            if cfg.moe_mode == "ep_alltoall" and _div(shape[0], mpn):
                return P(mp, None, fs(shape[2]))
            return P(None, tp(shape[1]), fs(shape[2]))
        # shared expert falls through to the mlp rules below

    # --- attention (GQA + MLA + cross) ---------------------------------------
    heads_ok = _div(cfg.n_heads * cfg.resolved_head_dim, mpn) and _div(cfg.n_heads, mpn)
    kv_ok = _div(cfg.n_kv_heads, mpn)
    if leaf in ("wq",):
        return P(fs(shape[0]), mp if heads_ok else None)
    if leaf in ("wk", "wv"):
        return P(fs(shape[0]), mp if kv_ok else None)
    if leaf == "wo":
        return P(mp if heads_ok else None, fs(shape[1]))
    if leaf in ("bq",):
        return P(mp if heads_ok else None)
    if leaf in ("bk", "bv"):
        return P(mp if kv_ok else None)
    if leaf in ("wdq", "wdkv", "wkr"):
        return P(fs(shape[0]), None)
    if leaf in ("wuq", "wukv"):
        return P(None, mp if _div(cfg.n_heads, mpn) else None)

    # --- dense MLP -----------------------------------------------------------
    if leaf in ("w_in", "w_gate"):
        return P(fs(shape[0]), tp(shape[1]))
    if leaf == "w_out":
        return P(tp(shape[0]), fs(shape[1]))

    # --- mamba ---------------------------------------------------------------
    if "/mamba/" in path:
        di = cfg.d_inner
        if leaf == "in_proj":
            # mamba1 (D, 2*di): aligned x/z halves -> TP ok.
            if shape[1] == 2 * di and _div(di, mpn):
                return P(fs(shape[0]), mp)
            return P(fs(shape[0]), None)
        if leaf in ("w_z", "w_x"):          # mamba2 split projections
            return P(fs(shape[0]), tp(shape[1]))
        if leaf in ("w_bc",):               # (D, 2n): B/C are head-shared
            return P(fs(shape[0]), None)
        if leaf == "w_dt":                  # (D, H): dt heads follow x heads
            return P(fs(shape[0]), tp(shape[1]))
        if leaf == "conv_w":
            return P(None, mp if shape[1] == di and _div(di, mpn) else None)
        if leaf == "x_proj":
            return P(mp if _div(shape[0], mpn) else None, None)
        if leaf == "dt_proj":
            return P(None, tp(shape[1]))
        if leaf == "A_log" and len(shape) == 2:
            return P(tp(shape[0]), None)
        if leaf == "out_proj":
            return P(tp(shape[0]), fs(shape[1]))
        return P(*([None] * len(shape)))

    # --- fallback: FSDP the largest dim --------------------------------------
    big = max(range(len(shape)), key=lambda i: (shape[i], -i))
    spec = [None] * len(shape)
    if _div(shape[big], dpn):
        spec[big] = dp
    return P(*spec)


def param_specs(params: Any, cfg: LMConfig, mi: MeshInfo) -> Any:
    """Tree of `PartitionSpec`s matching ``params`` (a `ParamTree` or its
    ``tree()``): a per-layer leaf ``layers/<i>/a/b`` takes the reference's
    rule for ``layers/a/b`` on its own (unstacked) shape."""

    def visit(path, leaf):
        stacked = bool(path) and path[0] in STACKED
        ref_path = "/".join(str(n) for j, n in enumerate(path) if not (stacked and j == 1))
        return _base_spec(ref_path, tuple(leaf.shape), cfg, mi)

    return _map_with_path(visit, _tree_of(params))


# ---------------------------------------------------------------------------
# cache / input specs
# ---------------------------------------------------------------------------

def cache_specs(caches: Any, cfg: LMConfig, mi: MeshInfo, batch: int) -> Any:
    """KV/state cache specs. Heads over 'model' when divisible, else
    sequence over 'model'; batch over dp when divisible, else sequence also
    takes the data axes (512K batch-1 long-context)."""
    dp, mp = mi.dp_resolved, mi.mp
    batch_ok = _div(batch, mi.dp_size)
    dp_mp = _entry(_flat((dp, mp)))

    def visit(path, leaf):
        names = "/".join(str(n) for n in path)
        shape = tuple(leaf.shape)
        bdim = dp if batch_ok else None
        if names.endswith("ckv") or names.endswith("kr"):       # (L,B,S,r)
            seq_axes = mp if batch_ok else (dp_mp if _div(shape[2], mi.dp_size * mi.mp_size) else mp)
            return P(None, bdim, seq_axes if _div(shape[2], mi.mp_size) else None, None)
        if names.split("/")[-1] in ("k", "v"):                  # (L,B,S,G,hd)
            if _div(shape[3], mi.mp_size):
                seq = None if batch_ok else (dp if _div(shape[2], mi.dp_size) else None)
                return P(None, bdim, seq, mp, None)
            seq_axes = mp if batch_ok else (dp_mp if _div(shape[2], mi.dp_size * mi.mp_size) else mp)
            return P(None, bdim, seq_axes if _div(shape[2], mi.mp_size) else None, None, None)
        if "ssm/h" in names:                                    # (L,B,di,n) | (L,B,H,P,n)
            spec = [None, bdim] + [None] * (len(shape) - 2)
            if _div(shape[2], mi.mp_size):
                spec[2] = mp
            return P(*spec)
        if "ssm/conv" in names:                                 # (L,B,k-1,C)
            return P(None, bdim, None, mp if _div(shape[3], mi.mp_size) else None)
        spec = [None, bdim] + [None] * (len(shape) - 2)
        return P(*spec)

    return _map_with_path(visit, caches)


def batch_specs(batch_leaves: Any, mi: MeshInfo) -> Any:
    """Inputs: batch dim over dp when divisible; everything else replicated."""
    dp = mi.dp_resolved

    def visit(path, leaf):
        if leaf.ndim == 0:
            return P()
        b = leaf.shape[0]
        return P(dp if _div(b, mi.dp_size) else None, *([None] * (leaf.ndim - 1)))

    return _map_with_path(visit, batch_leaves)


def like(t, ref):
    """``t`` on ``ref``'s placements when both are DTensors and differ (a
    gradient onto its parameter's layout), else ``t``."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor) and isinstance(ref, DTensor) and t.placements != ref.placements:
        return t.redistribute(ref.device_mesh, ref.placements)
    return t
