"""One rank's counts of a step on DTensors: FLOPs, collective bytes and
memory (the port's twin of ``repro.launch.roofline``'s HLO parsers,
``_type_bytes`` through ``top_collectives``).

The reference reads a compiled per-device program: dot FLOPs and the
operand bytes of every collective, multiplied by loop trip counts. The port
compiles nothing: `lower_cell` (``launch/steps.py``) runs one rank's step on
DTensors over a ``fake`` process group, and `RankCounter`, a dispatch mode,
watches the ops that rank runs on its local shards.

* FLOPs: DTensor turns each op into local ops on the shards; the mode
  returns ``NotImplemented`` for an op on DTensors (so DTensor runs first)
  and counts the local ops with ``torch.utils.flop_counter``'s formulas.
  ``FlopCounterMode`` around DTensor ops counts the global op instead, the
  unsharded product. Ops DTensor runs to propagate shardings (under its own
  fake mode) are not counted.
* Collective bytes: the operand bytes of every ``_c10d_functional``
  collective, by kind (the reference's names) and by the mesh axes of its
  group, with the group's ranks so that `roofline.axis_link_bw` can price
  each axis at its own link.
* Bytes accessed: what each local op that is not a view reads and
  writes (XLA's ``bytes accessed`` counts the same for each HLO op, fused
  ones once).
* Memory: every storage a local op makes is tracked until it is freed; the
  peak of their live bytes is the step's temporary memory (the outputs made
  during the step included), what is still alive at the end its output.
  Argument bytes (the local shards of the state and the batch) are exact and
  counted by the caller.

On a mesh of CPU tensors (the dry run's, and gloo's) DTensor carries a
change of layout from one shard dim to another as an all-gather and a chunk,
by its own rule for CPU meshes ("CPU process group does not support
alltoall yet, falling back with allgather + chunk"), not for want of an
all-to-all in the backend (gloo runs ``all_to_all_single``): it is counted
as an all-gather of the same operand. On a CUDA mesh the same change is one
all-to-all. The explicit MoE (``distributed/moe.py``) calls
``all_to_all_single`` itself, so its exchanges count as ``all-to-all`` on
their axis on every mesh.
"""
from __future__ import annotations

import collections
import math
import traceback
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

try:
    from torch._guards import active_fake_mode
except ImportError:                                   # pragma: no cover
    def active_fake_mode():
        return None

#: the reference's collective kinds (HLO op names)
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

_C10D = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
}


def _tensor_bytes(x) -> int:
    leaves, _ = tree_flatten(x)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


def _group_of(args, kwargs) -> Optional[str]:
    name = kwargs.get("group_name")
    if name is None:
        name = next((a for a in reversed(args) if isinstance(a, str)), None)
    return name


def _group_ranks(group_name: str) -> Tuple[int, ...]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return tuple(dist.get_process_group_ranks(_resolve_process_group(group_name)))


def _axes_of(ranks: Tuple[int, ...], names: Tuple[str, ...], sizes: Tuple[int, ...]) -> str:
    """The mesh axes along which ``ranks`` (global, row-major) vary."""
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    coords = [tuple((r // st) % n for st, n in zip(strides, sizes)) for r in ranks]
    varying = [nm for i, nm in enumerate(names) if len({c[i] for c in coords}) > 1]
    return "+".join(varying) or "self"


def _site() -> str:
    """The innermost frame of the port's model or step code (the twin of an
    HLO op's ``op_name``)."""
    for fr in reversed(traceback.extract_stack(limit=40)):
        f = fr.filename.replace("\\", "/")
        if "repro_torch" in f and "/launch/counters.py" not in f and "/distributed/" not in f:
            return f"{f.split('repro_torch/')[-1]}:{fr.lineno} {fr.name}"
    return "?"


class RankCounter(TorchDispatchMode):
    """Counts one rank's local ops while it is entered (see the module
    docstring). ``mesh`` (a DeviceMesh) names the axes of each collective;
    ``args`` are the step's inputs, whose storages are arguments, not
    temporaries."""

    def __init__(self, mesh=None, args=()):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.flops_by_op: Dict[str, int] = collections.Counter()
        self.coll: Dict[str, int] = {k: 0 for k in KINDS}
        self.coll["count"] = 0
        self.coll_by_axis: Dict[str, int] = collections.Counter()
        self.axis_ranks: Dict[str, Tuple[int, ...]] = {}
        self._rows: Dict[tuple, List[int]] = {}
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakSet()              # storages already counted or given
        self._refs = set()
        if mesh is not None:
            self._names = tuple(mesh.mesh_dim_names)
            self._sizes = tuple(mesh.shape)
        else:
            self._names, self._sizes = (), ()
        for t in tree_flatten(args)[0]:
            if isinstance(t, torch.Tensor):
                loc = getattr(t, "_local_tensor", t)
                self._seen.add(loc.untyped_storage())

    # -- dispatch --------------------------------------------------------------
    def __enter__(self):
        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if active_fake_mode() is not self._fake_on_entry:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if not func.is_view:
            self.bytes_accessed += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[packet.__name__] += n
        ns = getattr(func, "namespace", "")
        if ns == "_c10d_functional" and packet.__name__ in _C10D:
            self._collective(_C10D[packet.__name__], args, kwargs)
        self._track(out)
        return out

    # -- collectives -----------------------------------------------------------
    def _collective(self, kind: str, args, kwargs) -> None:
        nbytes = _tensor_bytes(args[0])
        group = _group_of(args, kwargs)
        ranks = _group_ranks(group) if group is not None else ()
        axis = _axes_of(ranks, self._names, self._sizes) if self._names and ranks else "?"
        self.coll[kind] += nbytes
        self.coll["count"] += 1
        self.coll_by_axis[axis] += nbytes
        self.axis_ranks.setdefault(axis, ranks)
        shape = tuple(args[0].shape) if isinstance(args[0], torch.Tensor) else ()
        row = self._rows.setdefault((kind, axis, shape, _site()), [0, 0])
        row[0] += nbytes
        row[1] += 1

    def top_collectives(self, k: int = 12) -> List[dict]:
        """The k biggest collectives by bytes x trips, with the model code
        that made them (the reference's ``top_collectives``)."""
        rows = [{"op": kind, "axis": axis, "bytes": b, "trips": n, "shape": str(shape),
                 "op_name": site}
                for (kind, axis, shape, site), (b, n) in self._rows.items()]
        rows.sort(key=lambda r: -r["bytes"])
        return rows[:k]

    # -- memory ----------------------------------------------------------------
    def _track(self, out) -> None:
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(st)
            self.live += n
            self.peak = max(self.peak, self.live)
            self._refs.add(weakref.ref(st, self._freed(n)))

    def _freed(self, n: int):
        def cb(ref):
            self.live -= n
            self._refs.discard(ref)
        return cb
