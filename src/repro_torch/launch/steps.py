"""Step builders and abstract input specs for every (arch x shape) cell (twin
of ``repro.launch.steps``, its single-card half).

Where the reference reckons shapes with ``jax.eval_shape``, the port builds
on the meta device: `abstract_params`, `abstract_train_state`, the batches
and the caches are meta tensors of the reference's shapes (tokens int64,
the port's index dtype, where the reference's are int32). They allocate
nothing, so they size a full config's state without a card. The same
builders, fed real tensors, are the train and serve steps
(`launch/train.py`, `examples/torch_dynamic_width_lm.py`).

The sharding specs and the lowering (``train_state_specs``, ``lower_cell``)
belong with the dry run (ROADMAP item 16c).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import LMConfig, ShapeSpec
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
    if cfg.is_encoder_decoder:
        def loss_fn(params, batch):
            return E.encdec_loss(params, cfg, batch["src_embeds"], batch["tokens"],
                                 batch["labels"], remat=remat)
    elif cfg.frontend == "vision":
        def loss_fn(params, batch):
            return T.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                             prefix_embeds=batch["embeds"], remat=remat)
    else:
        def loss_fn(params, batch):
            return T.lm_loss(params, cfg, batch["tokens"], batch["labels"], remat=remat)
    return loss_fn


def make_train_step(cfg: LMConfig, opt: O.Optimizer, remat: bool = True) -> Callable:
    """``step(state, batch) -> ({"params", "opt"}, {"loss"})`` with
    ``state = {"params": a ParamTree or its tree, "opt": opt.init(tree)}``:
    the loss and its gradient for every leaf, then ``opt.update`` and
    ``apply_updates``. The reference donates its state to the step; the
    port updates the parameters in place (``apply_updates``) and returns
    the same ``params`` object beside the new optimizer state."""
    loss_fn = make_loss_fn(cfg, remat)

    def step(state, batch):
        params = state["params"]
        tree = params.tree() if isinstance(params, ParamTree) else params
        loss, grads = value_and_grad(loss_fn, tree, batch)
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
        return decode(params, cfg, token, caches, pos)
    return step
