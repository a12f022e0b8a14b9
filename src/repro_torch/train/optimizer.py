"""Hand-written optimizers over param trees of tensors (twin of
``repro.train.optimizer``).

The reference's functional surface: ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (updates, state)``; ``apply_updates``.
The state is a tree of tensors in the reference's layout (``step`` an int32
scalar, ``m``/``v`` trees like the params), so `ckpt.CheckpointManager`
writes it as the reference does. Schedules take the step as a tensor and
compute in float32 on its device, so a step on the card never waits on the
host. Provided: sgd, adam (fp32 or bf16 moments), adamw, lamb (the paper's
PSNR phase), adafactor, the schedules constant / cosine (with warmup) /
multistep, global-norm clipping.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map, tree_map_up_to

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def constant(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def cosine_decay(lr: float, total_steps: int, final_scale: float = 0.0,
                 warmup: int = 0) -> Schedule:
    def fn(step):
        step = _f32(step)
        warm = torch.clamp(step / max(1.0, warmup), max=1.0) if warmup else 1.0
        t = torch.clamp((step - warmup) / max(1.0, total_steps - warmup), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * warm * (final_scale + (1 - final_scale) * cos)
    return fn


def multistep(lr: float, milestones: Sequence[int], gamma: float = 0.5) -> Schedule:
    def fn(step):
        step = _f32(step)
        ms = torch.tensor(list(milestones), dtype=torch.float32, device=step.device)
        k = (step[None] >= ms).sum().to(torch.float32)
        return lr * torch.pow(torch.tensor(gamma, dtype=torch.float32, device=step.device), k)
    return fn


# ---------------------------------------------------------------------------
# optimizer core
# ---------------------------------------------------------------------------

class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def apply_updates(params, updates):
    """Adds each update to its parameter in place, under ``no_grad`` (so
    the tensors a module and a grad graph hold stay the live ones, and
    their versions move), and returns ``params``."""
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u.to(p.dtype))
    return params


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def clip_by_global_norm(grads, max_norm: float):
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    return tree_map(lambda x: x * scale, grads), g


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    sched = lr if callable(lr) else constant(lr)

    def init(params):
        mom = tree_map(lambda p: torch.zeros_like(p.detach()), params) if momentum else None
        return {"step": _step0(params), "mom": mom}

    def update(grads, state, params=None):
        with torch.no_grad():
            step = state["step"] + 1
            lr_t = sched(step)
            if momentum:
                mom = tree_map(lambda m, g: momentum * m + g, state["mom"], grads)
                return tree_map(lambda m: -lr_t * m, mom), {"step": step, "mom": mom}
            return tree_map(lambda g: -lr_t * g, grads), {"step": step, "mom": None}

    return Optimizer(init, update)


def _adam_core(lr, b1: float, b2: float, eps: float, weight_decay: float, lamb_trust: bool,
               moment_dtype=torch.float32) -> Optimizer:
    sched = lr if callable(lr) else constant(lr)

    def init(params):
        # zeros_like: a DTensor parameter's moments are DTensors of its layout
        zeros = lambda p: torch.zeros_like(p, dtype=moment_dtype,  # noqa: E731
                                           memory_format=torch.contiguous_format)
        return {"step": _step0(params), "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params):
        with torch.no_grad():
            step = state["step"] + 1
            lr_t = sched(step)
            t = step.to(torch.float32)
            bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            f32 = torch.float32
            m = tree_map(lambda m_, g: (b1 * m_.to(f32) + (1 - b1) * g.to(f32)).to(m_.dtype),
                         state["m"], grads)
            v = tree_map(lambda v_, g: (b2 * v_.to(f32)
                                        + (1 - b2) * torch.square(g.to(f32))).to(v_.dtype),
                         state["v"], grads)

            def upd_leaf(m_, v_, p):
                m_, v_ = m_.to(f32), v_.to(f32)
                u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
                if weight_decay:
                    u = u + weight_decay * p.detach().to(f32)
                if lamb_trust:
                    pn = torch.linalg.vector_norm(p.detach().to(f32).reshape(-1))
                    un = torch.linalg.vector_norm(u.reshape(-1))
                    trust = torch.where((pn > 0) & (un > 0), pn / un, 1.0)
                    u = trust * u
                return (-lr_t * u).to(p.dtype)

            return tree_map(upd_leaf, m, v, params), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8, moment_dtype=torch.float32) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay=0.0, lamb_trust=False,
                      moment_dtype=moment_dtype)


def adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay, lamb_trust=False)


def lamb(lr, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0) -> Optimizer:
    """LAMB, the paper's PSNR-phase optimizer (batch 256, lr 3e-3 cosine):
    Adam's step scaled per leaf by ||p|| / ||u||."""
    return _adam_core(lr, b1, b2, eps, weight_decay, lamb_trust=True)


def adafactor(lr, decay: float = 0.8, eps: float = 1e-30) -> Optimizer:
    """Factored second moment (rank 1 over the last two axes of a matrix),
    with update clipping to RMS <= 1."""
    sched = lr if callable(lr) else constant(lr)

    def init(params):
        def leaf(p):
            if p.ndim >= 2:
                return {"r": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                         device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}
        return {"step": _step0(params), "f": tree_map(leaf, params)}

    def update(grads, state, params):
        with torch.no_grad():
            step = state["step"] + 1
            lr_t = sched(step)
            beta = 1.0 - (step.to(torch.float32) + 1.0) ** (-decay)

            def leaf(g, f, p):
                g32 = g.to(torch.float32)
                g2 = torch.square(g32) + eps
                if g.ndim >= 2:
                    r = beta * f["r"] + (1 - beta) * g2.mean(dim=-1)
                    c = beta * f["c"] + (1 - beta) * g2.mean(dim=-2)
                    vhat = r[..., None] * c[..., None, :] / torch.clamp(
                        r.mean(dim=-1)[..., None, None], min=eps)
                    nf = {"r": r, "c": c}
                else:
                    vhat = beta * f["v"] + (1 - beta) * g2
                    nf = {"v": vhat}
                u = g32 * torch.rsqrt(torch.clamp(vhat, min=eps))
                rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
                u = u / torch.clamp(rms, min=1.0)
                return (-lr_t * u).to(p.dtype), nf

            out = tree_map_up_to(leaf, grads, state["f"], params)
            return (tree_map_up_to(lambda _, o: o[0], grads, out),
                    {"step": step, "f": tree_map_up_to(lambda _, o: o[1], grads, out)})

    return Optimizer(init, update)


def chain_clip(opt: Optimizer, max_norm: float) -> Optimizer:
    def update(grads, state, params):
        grads, _ = clip_by_global_norm(grads, max_norm)
        return opt.update(grads, state, params)
    return Optimizer(opt.init, update)
