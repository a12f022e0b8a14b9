"""The LM side's parameter container and init helpers.

The reference keeps an LM's weights as a nested dict whose per-layer leaves
are stacked on a leading L axis (for ``lax.scan``). The port keeps the same
keys in a `ParamTree`: a module whose tensors are parameters and whose
sub-dicts are sub-trees, with ``layers`` (``enc_layers``/``dec_layers``) an
``nn.ModuleList`` of per-layer trees that the forward loops over. The model
functions index a tree as they index a dict (``p["w_in"]``, ``"bq" in p``,
``p.get(...)``), so they take either.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn


def _resolve_device(device, what: str) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on the CUDA card by default and none is available; "
                           f"pass device='cpu' to run on the CPU")
    return dev


def normal(generator: Optional[torch.Generator], shape, std: float, dtype,
           device: torch.device) -> torch.Tensor:
    """``std * N(0, 1)`` drawn in float32 from ``generator`` (on its own
    device), then cast: the reference's ``(std * normal(key, shape)).astype``.
    On the meta device it only makes the shape."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (t * std).to(device=device, dtype=dtype)


def uniform(generator: Optional[torch.Generator], shape, lo: float, hi: float,
            device: torch.device) -> torch.Tensor:
    """U(lo, hi) in float32 from ``generator``."""
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    t = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (t * (hi - lo) + lo).to(device)


class ParamTree(nn.Module):
    """A nested dict of tensors as a module (see the module docstring).
    Parameters are made without gradients: the serving path needs none, and
    a trainer turns them on with ``requires_grad_()``."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._names = tuple(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(ParamTree(x) for x in v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        if key not in self._names:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._names

    def get(self, key: str, default=None):
        return getattr(self, key) if key in self._names else default

    def keys(self):
        return self._names

    def tree(self) -> Dict[str, Any]:
        """The nested dict of this tree's tensors (per-layer lists unstacked)."""
        out: Dict[str, Any] = {}
        for k in self._names:
            v = getattr(self, k)
            if isinstance(v, ParamTree):
                out[k] = v.tree()
            elif isinstance(v, nn.ModuleList):
                out[k] = [m.tree() for m in v]
            else:
                out[k] = v.data
        return out
