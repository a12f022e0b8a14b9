"""Step builders, abstract input specs and the dry run's lowering for every
(arch x shape) cell (twin of ``repro.launch.steps``).

Where the reference reckons shapes with ``jax.eval_shape``, the port builds
on the meta device: `abstract_params`, `abstract_train_state`, the batches
and the caches are meta tensors of the reference's shapes (tokens int64,
the port's index dtype, where the reference's are int32). They allocate
nothing, so they size a full config's state without a card. The same
builders, fed real tensors, are the train and serve steps
(`launch/train.py`, `examples/torch_dynamic_width_lm.py`).

`lower_cell` is the dry run's entry point: it lays the abstract state and
batch out as DTensors under the sharding rules on a mesh over a ``fake``
process group (``launch/mesh.py``), runs one rank's step once under
`launch.counters.RankCounter`, and returns that rank's counts, where the
reference compiles and returns the lowered program.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import LMConfig, ShapeSpec
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.ctx import PartitionSpec as P
from repro_torch.distributed.ctx import params_view, use_ctx
from repro_torch.models.lm import encdec as E
from repro_torch.models.lm import transformer as T
from repro_torch.models.lm.params import ParamTree
from repro_torch.train import optimizer as O
from repro_torch.train.trainer import value_and_grad

SRC_LEN_CAP = 4096        # enc-dec source length for decode cells


# ---------------------------------------------------------------------------
# abstract params / state
# ---------------------------------------------------------------------------

def abstract_params(cfg: LMConfig) -> ParamTree:
    init = E.init_encdec if cfg.is_encoder_decoder else T.init_lm
    return init(cfg, generator=None, device="meta")


def make_optimizer(moment_dtype=torch.float32) -> O.Optimizer:
    return O.chain_clip(O.adam(O.cosine_decay(3e-4, 100_000, warmup=2000),
                               moment_dtype=moment_dtype), 1.0)


def abstract_train_state(cfg: LMConfig, opt: O.Optimizer) -> Dict:
    """``{"params", "opt"}`` as nested dicts of meta tensors."""
    p = abstract_params(cfg).tree()
    return {"params": p, "opt": opt.init(p)}


def train_state_specs(state, cfg: LMConfig, mi: SH.MeshInfo):
    pspec = SH.param_specs(state["params"], cfg, mi)
    # moments shard exactly like their parameters (ZeRO)
    return {"params": pspec, "opt": {"step": P(), "m": pspec, "v": pspec}}


# ---------------------------------------------------------------------------
# batches (abstract)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_abstract(cfg: LMConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    i64, bf16 = torch.int64, torch.bfloat16
    if cfg.is_encoder_decoder:
        return {"src_embeds": _meta((b, s, cfg.d_model), bf16),
                "tokens": _meta((b, s), i64), "labels": _meta((b, s), i64)}
    if cfg.frontend == "vision":
        st = s - cfg.n_frontend_tokens
        return {"embeds": _meta((b, cfg.n_frontend_tokens, cfg.d_model), bf16),
                "tokens": _meta((b, st), i64), "labels": _meta((b, st), i64)}
    return {"tokens": _meta((b, s), i64), "labels": _meta((b, s), i64)}


def prefill_batch_abstract(cfg: LMConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    return train_batch_abstract(cfg, shape)  # same inputs minus labels (kept: unused)


def decode_batch_abstract(cfg: LMConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    return {"token": _meta((shape.global_batch, 1), torch.int64),
            "pos": _meta((), torch.int64)}


def abstract_caches(cfg: LMConfig, shape: ShapeSpec) -> Dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        return E.init_encdec_caches(cfg, b, s, min(s, SRC_LEN_CAP), device="meta")
    return T.init_caches(cfg, b, s, device="meta")


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def make_loss_fn(cfg: LMConfig, remat: bool = True) -> Callable:
    """``loss_fn(params, batch)``; under a sharding context (the dry run) the
    model reads its weights gathered over the data axes (ZeRO-3)."""
    def loss_fn(params, batch):
        params = params_view(params)
        if cfg.is_encoder_decoder:
            return E.encdec_loss(params, cfg, batch["src_embeds"], batch["tokens"],
                                 batch["labels"], remat=remat)
        return T.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                         prefix_embeds=batch.get("embeds"), remat=remat)
    return loss_fn


def make_train_step(cfg: LMConfig, opt: O.Optimizer, remat: bool = True) -> Callable:
    """``step(state, batch) -> ({"params", "opt"}, {"loss"})`` with
    ``state = {"params": a ParamTree or its tree, "opt": opt.init(tree)}``:
    the loss and its gradient for every leaf, then ``opt.update`` and
    ``apply_updates``. The reference donates its state to the step; the
    port updates the parameters in place (``apply_updates``) and returns
    the same ``params`` object beside the new optimizer state. On DTensors
    each gradient is put back on its parameter's placements before the
    optimizer reads it (`sharding.like`): autograd can leave it a partial
    sum, which would be reduced wherever it is first read, as an all-reduce
    where ZeRO means a reduce-scatter."""
    loss_fn = make_loss_fn(cfg, remat)

    def step(state, batch):
        params = state["params"]
        tree = params.tree() if isinstance(params, ParamTree) else params
        loss, grads = value_and_grad(loss_fn, tree, batch)
        grads = tree_map(SH.like, grads, tree)
        updates, opt_state = opt.update(grads, state["opt"], tree)
        O.apply_updates(tree, updates)
        return {"params": params, "opt": opt_state}, {"loss": loss}

    return step


def make_prefill_step(cfg: LMConfig, shape: ShapeSpec) -> Callable:
    """``step(params, batch) -> (logits, caches)``, recording no graph (a
    trained tree's leaves take gradients)."""
    max_len = shape.seq_len

    @torch.no_grad()
    def step(params, batch):
        params = params_view(params)
        if cfg.is_encoder_decoder:
            return E.encdec_prefill(params, cfg, batch["src_embeds"], batch["tokens"], max_len)
        return T.lm_prefill(params, cfg, batch["tokens"], max_len,
                            prefix_embeds=batch.get("embeds"))
    return step


def make_decode_step(cfg: LMConfig) -> Callable:
    """``step(params, caches, token, pos) -> (logits, caches)``, the caches
    written in place, recording no graph."""
    decode = E.encdec_decode_step if cfg.is_encoder_decoder else T.lm_decode_step

    @torch.no_grad()
    def step(params, caches, token, pos):
        return decode(params_view(params), cfg, token, caches, pos)
    return step


# ---------------------------------------------------------------------------
# lowering (the dry run's entry point)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LoweredCell:
    """One rank's counts of one step of a cell (the reference's holds the
    lowered program; XLA's analyses of it are these counts' twins)."""
    kind: str
    flops: int                               # the rank's local matmul/conv FLOPs
    bytes_accessed: int                      # read + written by its local ops
    flops_by_op: Dict[str, int]
    collectives: Dict[str, int]              # kind -> operand bytes, and "count"
    collectives_by_axis: Dict[str, int]      # mesh axes ("model", "data+model") -> bytes
    axis_ranks: Dict[str, Any]               # a group's global ranks per axis label
    top_collectives: list
    argument_bytes: int                      # the rank's shards of the step's inputs
    temp_bytes: int                          # the peak of live storage made in the step
    output_bytes: int                        # what of it outlives the step


def _shardings(tree_specs, mi: SH.MeshInfo):
    """Placements for every spec of ``tree_specs`` (``None`` replicated)."""
    return tree_map(lambda s: mi.placements(s if isinstance(s, P) else P()), tree_specs)


def _distribute(tree, specs, mi: SH.MeshInfo):
    """Each meta tensor of ``tree`` as the DTensor of its spec: this rank's
    shard, made on the meta device (no data moves)."""
    from torch.distributed.tensor import DTensor

    def one(t, spec, placements):
        loc = torch.empty(SH.local_shape(t.shape, spec, mi.mesh), dtype=t.dtype, device="meta")
        return DTensor.from_local(loc, mi.mesh, placements, run_check=False)
    return tree_map(one, tree, specs, _shardings(specs, mi))


def _local_bytes(*trees) -> int:
    return sum(t.to_local().untyped_storage().nbytes() for tr in trees for t in tree_leaves(tr))


def run_counted(mesh, args, fn) -> LoweredCell:
    """``fn()`` -> (kind, outputs), run once under a `RankCounter` with the
    mesh's sharding context; ``args`` are its DTensor inputs."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.counters import RankCounter
    counter = RankCounter(mesh, args)
    arg_bytes = _local_bytes(*args)
    with use_ctx(SH.mesh_info(mesh).ctx()), implicit_replication(), counter:
        kind, out = fn()
        output_bytes = counter.live
    del out
    return LoweredCell(kind, counter.flops, counter.bytes_accessed, dict(counter.flops_by_op),
                       dict(counter.coll), dict(counter.coll_by_axis), dict(counter.axis_ranks),
                       counter.top_collectives(), arg_bytes, counter.peak, output_bytes)


def lower_cell(cfg: LMConfig, shape: ShapeSpec, mi: SH.MeshInfo, *,
               remat: bool = True, moment_dtype=torch.float32) -> LoweredCell:
    """Run one rank's step of this (arch x shape) on this mesh (a DeviceMesh
    over a ``fake`` group) and count it. Device-free: every tensor is a
    meta tensor, so nothing is allocated and no card is touched."""
    if shape.kind == "train":
        opt = make_optimizer(moment_dtype)
        state = abstract_train_state(cfg, opt)
        state = _distribute(state, train_state_specs(state, cfg, mi), mi)
        batch = train_batch_abstract(cfg, shape)
        batch = _distribute(batch, SH.batch_specs(batch, mi), mi)
        step = make_train_step(cfg, opt, remat=remat)
        return run_counted(mi.mesh, (state, batch), lambda: ("train", step(state, batch)))

    params = abstract_params(cfg).tree()
    params = _distribute(params, SH.param_specs(params, cfg, mi), mi)
    if shape.kind == "prefill":
        # the labels ride in the batch unread; the reference's jit prunes them
        batch = {k: v for k, v in prefill_batch_abstract(cfg, shape).items() if k != "labels"}
        batch = _distribute(batch, SH.batch_specs(batch, mi), mi)
        fn = make_prefill_step(cfg, shape)

        def run():                      # the caches leave in their cache layout
            logits, caches = fn(params, batch)
            cspec = SH.cache_specs(caches, cfg, mi, shape.global_batch)
            return "prefill", (logits, tree_map(
                lambda c, s: c.redistribute(mi.mesh, mi.placements(s)), caches, cspec))
        return run_counted(mi.mesh, (params, batch), run)

    caches = abstract_caches(cfg, shape)
    caches = _distribute(caches, SH.cache_specs(caches, cfg, mi, shape.global_batch), mi)
    db = decode_batch_abstract(cfg, shape)
    token = _distribute(db["token"], SH.batch_specs(db["token"], mi), mi)
    fn = make_decode_step(cfg)
    pos = shape.seq_len - 1             # the reference's pos is an int32 argument
    return run_counted(mi.mesh, (params, caches, token),
                       lambda: ("decode", fn(params, caches, token, pos)))
