"""Weight bridge between the reference's param trees and the port's
modules (`ESSR`, and the baselines `FSRCNN` and `RLFN`).

The reference keeps weights as nested dicts and lists (ESSR: ``{"first",
"sfbs": [...], "recon"}``) in HWIO layouts: pointwise ``(1,1,Cin,Cout)``,
depthwise ``(3,3,1,C)``, convolutions ``(k,k,Cin,Cout)``, biases ``(C,)``.
The port's modules keep the very same layouts, so the bridge is a
shape-checked copy in both directions.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.essr import ESSR, ESSRConfig
from repro_torch.models.fsrcnn import FSRCNN, FSRCNNConfig
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
