"""PAMS quantization (paper Sec. IV-H), in PyTorch (twin of
``repro.quant.pams``).

Symmetric uniform quantization with a max scale alpha per tensor and a
straight-through estimator. The paper quantizes the whole model at FXP10
W/A; ``"int8"`` is the 8-bit datapath.

Provides the fake-quant ops, PTQ calibration (linear-interpolated
percentile), the fake-quant ESSR forward (the "ref" quant backend), and the
frozen `QuantPack` of per-subnet activation alphas that serving carries,
with a checksummed JSON cache in the reference's format: a pack or alpha
cache written by either package loads in the other, and
`params_fingerprint` of the same weights is equal in both.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.essr import ESSRConfig, slice_width

#: Serving quant modes (`ExecutionPlan.quant`) -> bit width.
QUANT_MODES: Dict[str, int] = {"fxp10": 10, "int8": 8}

#: Quantization-step floor: alphas below ``qmax * EPS`` collapse every code
#: to 0 (see `step_size`).
EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    bits: int = 10          # FXP10 (paper) | 8
    per_channel_weights: bool = True
    act_percentile: float = 99.9

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1


def step_size(alpha: torch.Tensor, qmax: int) -> torch.Tensor:
    """The step ``quantize``/``int_codes`` use on both the divide and the
    dequant side, floored at ``EPS``."""
    return torch.clamp_min(alpha / qmax, EPS)


def _clip(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, -a, a)``: max with -a, then min with a."""
    return torch.minimum(torch.maximum(x, -a), a)


def quantize(x: torch.Tensor, alpha: torch.Tensor, qmax: int) -> torch.Tensor:
    """Fake-quant with STE: forward = dequant(round(clip(x)/s)), gradient =
    identity inside the clip range."""
    s = step_size(alpha, qmax)
    xc = _clip(x, alpha)
    q = torch.round(xc / s) * s
    return xc + (q - xc).detach()


def int_codes(x: torch.Tensor, alpha: torch.Tensor, qmax: int) -> torch.Tensor:
    """The integer lattice codes, int32."""
    return torch.round(_clip(x, alpha) / step_size(alpha, qmax)).to(torch.int32)


def weight_alpha(w: torch.Tensor, per_channel: bool) -> torch.Tensor:
    if per_channel and w.ndim == 4:
        return w.abs().amax(dim=(0, 1, 2), keepdim=True) + 1e-8
    return w.abs().max() + 1e-8


def _map_tree(fn, tree, name: str = ""):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, name) for v in tree)
    return fn(name, tree)


def quantize_weight_tree(params, qcfg: QuantConfig):
    """Fake-quantize every conv weight of an ESSR param tree; leaves whose
    name ends in ``_b`` or with fewer than 2 dims (biases) stay wide."""
    def q(name, x):
        if name.endswith("_b") or x.ndim < 2:
            return x
        return quantize(x, weight_alpha(x, qcfg.per_channel_weights), qcfg.qmax)
    return _map_tree(q, params)


# ---------------------------------------------------------------------------
# activation scales: PTQ calibration
# ---------------------------------------------------------------------------

def _act_points(cfg: ESSRConfig) -> List[str]:
    """Names of the activation-quant sites: after every conv group."""
    pts = ["in", "first"]
    for i in range(cfg.n_sfb):
        pts += [f"sfb{i}_b1", f"sfb{i}_b2", f"sfb{i}_out"]
    pts += ["recon"]
    return pts


def init_act_scales(cfg: ESSRConfig, init: float = 2.0,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """One 0-d float32 scale ``init`` per activation-quant site, on ``device``."""
    return {k: torch.tensor(init, dtype=torch.float32, device=device)
            for k in _act_points(cfg)}


def effective_alpha(alpha):
    """Stored alpha -> the clip range the forward uses (shared by the
    fake-quant forward and the integer kernels)."""
    return alpha.abs() + 1e-8


def quantized_essr_forward(params, act_scales: Dict[str, torch.Tensor], x: torch.Tensor,
                           cfg: ESSRConfig, qcfg: QuantConfig = QuantConfig(),
                           width: Optional[int] = None) -> torch.Tensor:
    """ESSR forward with W/A fake-quant at every conv boundary (the whole
    model, no fp first/last layer). ``act_scales``: site -> 0-d alpha."""
    if width == 0:
        return L.bilinear_resize(x, cfg.scale)
    if width is not None and width != cfg.channels:
        params = slice_width(params, width)
    params = quantize_weight_tree(params, qcfg)

    def qa(name, t):
        return quantize(t, effective_alpha(act_scales[name]), qcfg.qmax)

    f = qa("in", x)
    f = qa("first", L.bsconv(params["first"], f))
    for i, p in enumerate(params["sfbs"]):
        y = qa(f"sfb{i}_b1", torch.relu(L.bsconv(p["b1"], f)))
        y = qa(f"sfb{i}_b2", torch.relu(L.bsconv(p["b2"], y)))
        y = L.pointwise(y + f, p["fuse"], p.get("fuse_b"))
        f = qa(f"sfb{i}_out", torch.relu(y))
    up = qa("recon", L.dsconv(params["recon"], f))
    return L.pixel_shuffle(up, cfg.scale)


def _percentile(t: torch.Tensor, pct: float) -> torch.Tensor:
    """``jnp.percentile(t, pct)`` (method "linear") in float32: the two
    order statistics around position pct / 100 * (n - 1), weighted 1 - frac
    and frac. The position is computed as XLA compiles the reference, which
    folds the two constant factors first: pct * (0.01 * (n - 1)); near the
    tail one ulp of it moves the alpha by ~1e-5. Order statistics by
    ``kthvalue``: ``torch.quantile`` refuses inputs over 2^24 elements,
    which a calibration batch at C54 exceeds."""
    flat = t.reshape(-1)
    n = flat.numel()
    f32 = torch.float32
    pos = torch.tensor(pct, dtype=f32) * (torch.tensor(0.01, dtype=f32)
                                          * torch.tensor(n - 1, dtype=f32))
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1.0 - w_hi
    k_lo = int(min(max(lo.item(), 0), n - 1))
    k_hi = int(min(max(hi.item(), 0), n - 1))
    v_lo = flat.kthvalue(k_lo + 1).values.cpu()
    v_hi = v_lo if k_hi == k_lo else flat.kthvalue(k_hi + 1).values.cpu()
    return v_lo * w_lo + v_hi * w_hi


def calibrate_act_scales(params, cfg: ESSRConfig, sample: torch.Tensor,
                         qcfg: QuantConfig = QuantConfig(),
                         n_valid: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """PTQ: an fp forward over a calibration batch, alpha = percentile(|act|)
    + 1e-8 at every site. ``n_valid``: the number of real patches at the
    front of ``sample`` (bucket padding repeats the last patch and must not
    weigh in); None = all."""
    pct = qcfg.act_percentile
    nv = sample.shape[0] if n_valid is None else int(n_valid)
    if not 0 < nv <= sample.shape[0]:
        raise ValueError(f"n_valid {n_valid} must be in 1..{sample.shape[0]}")
    scales: Dict[str, torch.Tensor] = {}

    def rec(name, t):
        scales[name] = _percentile(t[:nv].abs(), pct) + 1e-8
        return t

    with torch.no_grad():
        f = rec("in", sample)
        f = rec("first", L.bsconv(params["first"], f))
        for i, p in enumerate(params["sfbs"]):
            y = rec(f"sfb{i}_b1", torch.relu(L.bsconv(p["b1"], f)))
            y = rec(f"sfb{i}_b2", torch.relu(L.bsconv(p["b2"], y)))
            y = L.pointwise(y + f, p["fuse"], p.get("fuse_b"))
            f = rec(f"sfb{i}_out", torch.relu(y))
        rec("recon", L.dsconv(params["recon"], f))
    return scales


# ---------------------------------------------------------------------------
# serving-path quantization state: per-subnet alphas, frozen + hashable
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantPack:
    """Everything serving needs to run one quant mode, frozen and hashable
    (it keys the cache of prepared kernel operands).

    ``scales``: ``((width, ((site, alpha), ...)), ...)`` for every conv width
    of the supernet (the bilinear width 0 needs none). Alphas are plain
    floats: hashable, and exact through the JSON cache."""
    mode: str                   # "fxp10" | "int8"
    bits: int
    per_channel_weights: bool
    act_percentile: float
    scales: Tuple[Tuple[int, Tuple[Tuple[str, float], ...]], ...]

    def __post_init__(self):
        if self.mode not in QUANT_MODES:
            raise ValueError(f"quant mode {self.mode!r} not in {sorted(QUANT_MODES)}")

    @property
    def qcfg(self) -> QuantConfig:
        return QuantConfig(bits=self.bits, per_channel_weights=self.per_channel_weights,
                           act_percentile=self.act_percentile)

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1

    def widths(self) -> Tuple[int, ...]:
        return tuple(w for w, _ in self.scales)

    def act_scales(self, width: int) -> Dict[str, float]:
        for w, sites in self.scales:
            if w == width:
                return dict(sites)
        raise KeyError(f"no calibrated alphas for width {width} (have {self.widths()})")


def code_dtype(bits: int) -> torch.dtype:
    """Storage dtype of the lattice codes: int8, or int32 for FXP10 (±511)."""
    return torch.int8 if bits <= 8 else torch.int32


def calibrate_subnet_scales(params, cfg: ESSRConfig, sample: torch.Tensor,
                            qcfg: QuantConfig = QuantConfig(),
                            n_valid: Optional[int] = None) -> Dict[int, Dict[str, float]]:
    """PTQ alphas for every conv subnet of the supernet (C54 and C27 see
    different activation ranges through the shared weights)."""
    out: Dict[int, Dict[str, float]] = {}
    for w in cfg.subnet_widths():
        if w == 0:
            continue
        p = params if w == cfg.channels else slice_width(params, w)
        scales = calibrate_act_scales(p, cfg, sample, qcfg, n_valid=n_valid)
        out[w] = {k: float(v) for k, v in scales.items()}
    return out


def build_quant_pack(params, cfg: ESSRConfig, mode: str, sample: torch.Tensor, *,
                     per_channel_weights: bool = True, act_percentile: float = 99.9,
                     n_valid: Optional[int] = None) -> QuantPack:
    """Calibrate a serving `QuantPack` from a calibration batch (PTQ)."""
    if mode not in QUANT_MODES:
        raise ValueError(f"quant mode {mode!r} not in {sorted(QUANT_MODES)}")
    qcfg = QuantConfig(bits=QUANT_MODES[mode], per_channel_weights=per_channel_weights,
                       act_percentile=act_percentile)
    by_width = calibrate_subnet_scales(params, cfg, sample, qcfg, n_valid=n_valid)
    scales = tuple((w, tuple(sorted(by_width[w].items()))) for w in sorted(by_width))
    return QuantPack(mode=mode, bits=qcfg.bits, per_channel_weights=per_channel_weights,
                     act_percentile=act_percentile, scales=scales)


# ---------------------------------------------------------------------------
# alpha cache: the reference's JSON format and checksum
# ---------------------------------------------------------------------------

def _tree_leaves(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_leaves`` order: dict keys sorted,
    lists and tuples in order, None skipped."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _tree_leaves(v)]
    return [] if tree is None else [tree]


def params_fingerprint(params) -> str:
    """Content hash of a param tree's leaf bytes; equal to the reference's
    for the same weights. Keys the alpha cache."""
    h = hashlib.sha256()
    for leaf in _tree_leaves(params):
        a = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _payload_checksum(payload: dict) -> str:
    """sha256 of the canonical (sorted-key, checksum-free) JSON encoding."""
    body = {k: v for k, v in payload.items() if k != "checksum"}
    return hashlib.sha256(json.dumps(body, sort_keys=True).encode()).hexdigest()[:16]


def save_quant_pack(path: str, pack: QuantPack, fingerprint: str) -> None:
    payload = {
        "mode": pack.mode, "bits": pack.bits,
        "per_channel_weights": pack.per_channel_weights,
        "act_percentile": pack.act_percentile,
        "fingerprint": fingerprint,
        "scales": {str(w): dict(sites) for w, sites in pack.scales},
    }
    payload["checksum"] = _payload_checksum(payload)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")


def load_quant_pack(path: str, fingerprint: str) -> Optional[QuantPack]:
    """A cached pack; None when missing, stale (another fingerprint, or no
    checksum recorded) or damaged. A damaged file (unparseable, failed
    checksum, broken schema) warns before returning None."""
    try:
        with open(path) as f:
            raw = f.read()
    except OSError:
        return None
    try:
        d = json.loads(raw)
        if "checksum" not in d:
            return None
        if d["checksum"] != _payload_checksum(d):
            raise ValueError("integrity checksum mismatch")
        if d.get("fingerprint") != fingerprint:
            return None
        scales = tuple((int(w), tuple(sorted((str(k), float(v)) for k, v in sites.items())))
                       for w, sites in sorted(d["scales"].items(), key=lambda kv: int(kv[0])))
        return QuantPack(mode=d["mode"], bits=int(d["bits"]),
                         per_channel_weights=bool(d["per_channel_weights"]),
                         act_percentile=float(d["act_percentile"]), scales=scales)
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        warnings.warn(f"quant-pack cache {path} is corrupted ({e!r}); "
                      f"ignoring it and recalibrating", stacklevel=2)
        return None
