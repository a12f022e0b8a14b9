"""The training loop: supernet-sampled ESSR training (paper Sec. V-A
recipe; twin of ``repro.train.trainer``).

PSNR phase: L1, Lamb, lr 3e-3 cosine, batch 256, EMA 0.999. The forward is
the plain `essr_forward` (autograd through PyTorch's ops), as the
reference's is; each step runs in true fp32 (TF32 off for matmuls and
cuDNN while it runs, then put back), which the parity contract asks for.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import supernet
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.essr import ESSRConfig, essr_forward
from repro_torch.train import losses as Ls
from repro_torch.train import optimizer as O


@contextlib.contextmanager
def true_fp32():
    """TF32 off for CUDA matmuls and cuDNN convolutions inside the block,
    the previous settings back after it."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    ema: Any
    step: int = 0

    def tree(self):
        return {"params": self.params, "opt_state": self.opt_state,
                "ema": self.ema, "step": self.step}


def _as_tree(params):
    """A module's param tree, or the tree itself."""
    return params.tree() if isinstance(params, torch.nn.Module) else params


def value_and_grad(loss_fn: Callable, params, *args, **kwargs):
    """(loss, grads): ``loss_fn(params, *args)`` and its gradient for every
    leaf of ``params`` (zeros for a leaf the loss does not reach), as a
    tree like ``params``. A leaf that takes no gradient is switched to take
    one."""
    leaves = tree_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    with torch.enable_grad():
        val = loss_fn(params, *args, **kwargs)
        grads = torch.autograd.grad(val, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return val.detach(), tree_unflatten(params, grads)


def make_supernet_step(cfg: ESSRConfig, opt: O.Optimizer, loss=Ls.l1_loss,
                       ema_decay: float = 0.999):
    """``step(params, opt_state, ema, lr, hr, *, width) -> (params,
    opt_state, ema, loss)``: one sampled-subnet step. ``params`` is updated
    in place (the tree's tensors stay the live ones) and returned."""

    def loss_fn(params, lr_img, hr_img, width: int):
        return loss(essr_forward(params, lr_img, cfg, width=width), hr_img)

    def step(params, opt_state, ema, lr_img, hr_img, *, width: int):
        with true_fp32():
            val, grads = value_and_grad(loss_fn, params, lr_img, hr_img, width)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = O.apply_updates(params, updates)
            ema = supernet.ema_update(ema, params, ema_decay)
        return params, opt_state, ema, val

    return step


def supernet_draws(data: Iterator, cfg: ESSRConfig, seed: int = 0) -> Iterator:
    """``(lr, hr, width)`` in `train_essr_supernet`'s order: a batch from
    ``data``, then its subnet width from ``np.random.default_rng(seed)``
    with `supernet.subnet_sampling_probs`. A list of the first n draws,
    indexed by the step, is a ``make_batch`` that a replay can repeat."""
    rng = np.random.default_rng(seed)
    widths = [w for w in cfg.subnet_widths() if w > 0]
    probs = supernet.subnet_sampling_probs(cfg)
    for lr_img, hr_img in data:
        yield lr_img, hr_img, int(rng.choice(widths, p=probs))


def make_supervised_step(cfg: ESSRConfig, opt: O.Optimizer):
    """`make_supernet_step` as `runtime.fault_tolerance.TrainSupervisor`
    calls a step: ``step_fn(state, batch) -> (state, loss)``, with the state
    ``{"params", "opt_state", "ema"}`` and the batch ``(lr, hr, width)``."""
    step = make_supernet_step(cfg, opt)

    def step_fn(state, batch):
        lr_img, hr_img, width = batch
        params, opt_state, ema, val = step(state["params"], state["opt_state"], state["ema"],
                                           lr_img, hr_img, width=width)
        return {"params": params, "opt_state": opt_state, "ema": ema}, val

    return step_fn


def train_essr_supernet(params, cfg: ESSRConfig, data: Iterator, steps: int,
                        opt: Optional[O.Optimizer] = None, seed: int = 0, log_every: int = 50,
                        log_fn: Callable[[str], None] = print) -> Tuple[Any, Any, list]:
    """ARM-style sampled-subnet training. ``params``: an `ESSR` module or
    its param tree, trained in place. Widths are drawn with
    ``np.random.default_rng(seed)`` exactly as the reference draws them.
    Returns (params, ema, loss history)."""
    tree = _as_tree(params)
    opt = opt or O.lamb(O.cosine_decay(3e-3, steps))
    opt_state = opt.init(tree)
    ema = supernet.ema_init(tree)
    step_fn = make_supernet_step(cfg, opt)
    draws = supernet_draws(data, cfg, seed)
    history = []
    for i in range(steps):
        lr_img, hr_img, width = next(draws)
        tree, opt_state, ema, val = step_fn(tree, opt_state, ema, lr_img, hr_img, width=width)
        history.append(float(val))
        if log_every and (i + 1) % log_every == 0:
            log_fn(f"step {i+1:6d}  width C{width}  loss {np.mean(history[-log_every:]):.5f}")
    return params, ema, history


def make_grad_accum_step(loss_fn, opt: O.Optimizer, n_micro: int):
    """One optimizer step from ``n_micro`` microbatches: ``batch`` is a
    tuple of tensors whose leading axis is the microbatch (n_micro, micro,
    ...); the gradients are summed as g / n_micro in order."""

    def step(params, opt_state, batch):
        grads, vals = None, []
        for i in range(n_micro):
            val, g = value_and_grad(loss_fn, params, *(b[i] for b in batch))
            vals.append(val)
            g = tree_map(lambda x: x.to(torch.float32) / n_micro, g)
            grads = g if grads is None else tree_map(torch.add, grads, g)
        updates, opt_state = opt.update(grads, opt_state, params)
        return O.apply_updates(params, updates), opt_state, torch.stack(vals).mean()

    return step
