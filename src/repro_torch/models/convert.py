"""Weight bridge between the reference's param trees and the port's
modules (`ESSR`, the baselines `FSRCNN` and `RLFN`, and the LM side's
`ParamTree`s).

The reference keeps weights as nested dicts and lists (ESSR: ``{"first",
"sfbs": [...], "recon"}``) in HWIO layouts: pointwise ``(1,1,Cin,Cout)``,
depthwise ``(3,3,1,C)``, convolutions ``(k,k,Cin,Cout)``, biases ``(C,)``.
The port's modules keep the very same layouts, so the bridge is a
shape-checked copy in both directions.

An LM tree stacks every per-layer leaf on a leading L axis (``layers``, or
``enc_layers``/``dec_layers`` of an enc-dec); the port keeps a list of
per-layer trees, so the LM bridge unstacks (and restacks) that axis. It
keeps each leaf's dtype (bfloat16 included: numpy holds it as ml_dtypes'
``bfloat16``, which the bridge reads bit for bit).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models.essr import ESSR, ESSRConfig
from repro_torch.models.fsrcnn import FSRCNN, FSRCNNConfig
from repro_torch.models.lm.params import ParamTree
from repro_torch.models.rlfn import RLFN, RLFNConfig


def _copy_into(module_tree: Dict[str, Any], src: Dict[str, Any], where: str) -> None:
    if set(module_tree) != set(src):
        raise ValueError(f"{where}: keys {sorted(src)} != expected {sorted(module_tree)}")
    for k, dst in module_tree.items():
        if isinstance(dst, dict):
            _copy_into(dst, src[k], f"{where}.{k}")
            continue
        if isinstance(dst, list):
            if len(src[k]) != len(dst):
                raise ValueError(f"{where}.{k}: {len(src[k])} entries != expected {len(dst)}")
            for i, (d, v) in enumerate(zip(dst, src[k])):
                _copy_into(d, v, f"{where}.{k}[{i}]")
            continue
        a = src[k].detach().cpu().numpy() if isinstance(src[k], torch.Tensor) \
            else np.asarray(src[k])
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"{where}.{k}: shape {a.shape} != expected {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(torch.tensor(np.asarray(a, dtype=np.float32)))


def params_from_numpy(tree: Dict[str, Any], cfg: ESSRConfig) -> ESSR:
    """Reference param tree (numpy leaves) -> a CPU `ESSR` holding those
    weights. Raises on any missing key or shape mismatch."""
    model = ESSR(cfg)
    mine = model.tree()
    if len(tree["sfbs"]) != len(mine["sfbs"]):
        raise ValueError(f"tree has {len(tree['sfbs'])} SFBs, cfg.n_sfb={cfg.n_sfb}")
    _copy_into({"first": mine["first"], "recon": mine["recon"]},
               {"first": tree["first"], "recon": tree["recon"]}, "params")
    for i, (d, s) in enumerate(zip(mine["sfbs"], tree["sfbs"])):
        _copy_into(d, s, f"params.sfbs[{i}]")
    return model


def fsrcnn_from_numpy(tree: Dict[str, Any], cfg: FSRCNNConfig) -> FSRCNN:
    """The reference's FSRCNN tree (numpy leaves) -> a CPU `FSRCNN`."""
    model = FSRCNN(cfg)
    _copy_into(model.tree(), tree, "fsrcnn")
    return model


def rlfn_from_numpy(tree: Dict[str, Any], cfg: RLFNConfig) -> RLFN:
    """The reference's RLFN tree (numpy leaves) -> a CPU `RLFN`."""
    model = RLFN(cfg)
    _copy_into(model.tree(), tree, "rlfn")
    return model


def params_to_numpy(model: ESSR) -> Dict[str, Any]:
    """`ESSR` -> the reference's param tree with float32 numpy leaves."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return [conv(v) for v in t]
        return t.detach().cpu().numpy().astype(np.float32)
    return conv(model.tree())


# ---------------------------------------------------------------------------
# the LM side
# ---------------------------------------------------------------------------

def _leaf_to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes: the same 16 bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:                  # no numpy bfloat16 here: widen exactly
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _unstack(tree: Dict[str, Any], expected: Dict[str, Any], where: str) -> Dict[str, Any]:
    """The reference's tree -> the port's nested dict, per-layer lists where
    ``expected`` (a meta-device tree of the config) has them."""
    if set(tree) != set(expected):
        raise ValueError(f"{where}: keys {sorted(tree)} != expected {sorted(expected)}")
    out: Dict[str, Any] = {}
    for k, e in expected.items():
        v = tree[k]
        if isinstance(e, list):
            out[k] = [_unstack(_index(v, i, len(e), f"{where}.{k}"), e[i], f"{where}.{k}[{i}]")
                      for i in range(len(e))]
        elif isinstance(e, dict):
            out[k] = _unstack(v, e, f"{where}.{k}")
        else:
            t = _leaf_to_torch(v)
            if tuple(t.shape) != tuple(e.shape):
                raise ValueError(f"{where}.{k}: shape {tuple(t.shape)} != expected "
                                 f"{tuple(e.shape)}")
            out[k] = t
    return out


def _index(tree, i: int, n: int, where: str):
    if isinstance(tree, dict):
        return {k: _index(v, i, n, f"{where}.{k}") for k, v in tree.items()}
    a = np.asarray(tree)
    if a.shape[:1] != (n,):
        raise ValueError(f"{where}: leading axis {a.shape[:1]} != the config's {n} layers")
    return a[i]


def _restack(tree: Dict[str, Any]) -> Dict[str, Any]:
    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([t[k] for t in items]) for k in items[0]}
        return np.stack([_leaf_to_numpy(t) for t in items])

    return {k: stack(v) if isinstance(v, list) else
            _restack(v) if isinstance(v, dict) else _leaf_to_numpy(v) for k, v in tree.items()}


def lm_params_from_numpy(tree: Dict[str, Any], cfg: LMConfig) -> ParamTree:
    """The reference's `init_lm` tree (numpy leaves, layers stacked) -> a CPU
    `ParamTree` of the same weights and dtypes. Raises on any missing key,
    shape or layer count that ``cfg`` does not give."""
    from repro_torch.models.lm.transformer import init_lm
    expected = init_lm(cfg, generator=None, device="meta").tree()
    return ParamTree(_unstack(tree, expected, "lm"))


def encdec_params_from_numpy(tree: Dict[str, Any], cfg: LMConfig) -> ParamTree:
    """The reference's `init_encdec` tree (numpy leaves) -> a CPU `ParamTree`."""
    from repro_torch.models.lm.encdec import init_encdec
    expected = init_encdec(cfg, generator=None, device="meta").tree()
    return ParamTree(_unstack(tree, expected, "encdec"))


def lm_params_to_numpy(params) -> Dict[str, Any]:
    """A `ParamTree` (or a tree like its ``tree()``: gradients, moments) ->
    the reference's tree (layers stacked on a leading L axis), numpy leaves
    of the same dtypes. The inverse of `lm_params_from_numpy` and
    `encdec_params_from_numpy`."""
    return _restack(params.tree() if isinstance(params, ParamTree) else params)


encdec_params_to_numpy = lm_params_to_numpy


def lm_opt_state_from_numpy(state: Dict[str, Any], cfg: LMConfig) -> Dict[str, Any]:
    """The reference's Adam state of an LM or enc-dec (``{"step", "m",
    "v"}``, the moments layer-stacked like its params) -> the port's: the
    moments unstacked like the params' ``tree()``, each leaf's dtype kept."""
    from repro_torch.models.lm.encdec import init_encdec
    from repro_torch.models.lm.transformer import init_lm
    init = init_encdec if cfg.is_encoder_decoder else init_lm
    expected = init(cfg, generator=None, device="meta").tree()
    return {"step": _leaf_to_torch(state["step"]),
            **{k: _unstack(state[k], expected, f"opt.{k}") for k in ("m", "v")}}


def lm_opt_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of `lm_opt_state_from_numpy`."""
    return {"step": _leaf_to_numpy(state["step"]),
            **{k: _restack(state[k]) for k in ("m", "v")}}
